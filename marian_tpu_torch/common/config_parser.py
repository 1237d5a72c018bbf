"""Marian-compatible configuration surface for the port's decoder: YAML
config files + CLI overrides.

The translation-mode flags of ``marian_tpu/common/config_parser.py`` and
the model flags a checkpoint's ``special:model.yml`` carries, with the
same names and defaults; flags of the JAX package's serving, mesh and
training machinery are left out. Precedence as in Marian: defaults <
config file(s) < CLI flags. ``--cpu-threads N`` (N > 0) runs on the CPU.

A flag that parses but whose feature this slice does not carry yet is
refused at startup by ``translator.translator`` rather than ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence

import yaml

from .options import Options

F = dataclasses.make_dataclass(
    "F", ["name", "type", "default", "help", "nargs"])


def _f(name, type_, default, help_, nargs=None):
    return F(name, type_, default, help_, nargs)


_COMMON = [
    _f("config", str, None, "Paths to YAML config file(s); later files override earlier", "+"),
    _f("workspace", int, -1, "Device workspace hint in MB (kept for CLI compat)"),
    _f("log", str, None, "Log to file in addition to stderr"),
    _f("log-level", str, "info", "trace/debug/info/warn/error/critical/off"),
    _f("quiet", bool, False, "Suppress all logging to stderr"),
    _f("quiet-translation", bool, False, "Suppress logging for translation"),
    _f("seed", int, 0, "RNG seed; 0 means use wall-clock"),
    _f("dump-config", str, None, "Dump effective config and exit: full/minimal"),
    _f("version", bool, False, "Print version and exit"),
]

_MODEL = [
    _f("model", str, "model.npz", "Path prefix for model to be saved/resumed"),
    _f("ignore-model-config", bool, False, "Ignore the config embedded in the model file"),
    _f("type", str, "amun", "Model type (this slice decodes: transformer)"),
    _f("dim-vocabs", int, [0, 0], "Maximum vocabulary sizes (0 = from vocab file)", "+"),
    _f("dim-emb", int, 512, "Embedding vector size"),
    _f("enc-depth", int, 1, "Encoder layers"),
    _f("dec-depth", int, 1, "Decoder layers"),
    _f("right-left", bool, False, "Train right-to-left model"),
    _f("tied-embeddings", bool, False, "Tie target embeddings and output layer"),
    _f("tied-embeddings-src", bool, False, "Tie source and target embeddings"),
    _f("tied-embeddings-all", bool, False, "Tie all embeddings and output layer"),
    _f("output-omit-bias", bool, False, "Output (logits) projection without a bias term"),
    _f("transformer-heads", int, 8, "Number of attention heads"),
    _f("transformer-dim-ffn", int, 2048, "FFN hidden size"),
    _f("transformer-decoder-dim-ffn", int, 0, "Decoder FFN hidden size (0 = transformer-dim-ffn)"),
    _f("transformer-ffn-depth", int, 2, "FFN depth (number of linear layers)"),
    _f("transformer-decoder-ffn-depth", int, 0, "Decoder FFN depth (0 = transformer-ffn-depth)"),
    _f("transformer-ffn-activation", str, "swish", "relu, swish, gelu"),
    _f("transformer-no-projection", bool, False, "Omit output projection in MHA"),
    _f("transformer-decoder-autoreg", str, "self-attention", "self-attention (this slice)"),
    _f("transformer-flash-attention", str, "auto", "Long-sequence attention kernel: auto, on, off (not ported yet; auto raises at length >= 1024)"),
    _f("transformer-packed-attention", str, "auto", "Short-sequence attention kernel (CUDA): auto (on the card), on, off"),
    _f("transformer-fused-decode-attention", str, "auto", "Fused beam-gather + cache-update + attention decode step (CUDA): auto, on, off"),
    _f("transformer-tied-layers", int, [], "Tie decoder layers to these encoder layers", "*"),
    _f("transformer-preprocess", str, "", "Per-sublayer preprocess ops: d=dropout, a=add(residual), n=layernorm"),
    _f("transformer-postprocess", str, "dan", "Per-sublayer postprocess ops"),
    _f("transformer-postprocess-emb", str, "d", "Embedding postprocess ops"),
    _f("transformer-postprocess-top", str, "", "Final decoder-top postprocess ops"),
    _f("transformer-train-position-embeddings", bool, False, "Learned positional embeddings"),
    _f("transformer-depth-scaling", bool, False, "Depth-scaled parameter initialization"),
    _f("max-length", int, 50, "Maximum sentence length (decode cap)"),
    _f("precision", str, ["float32", "float32"], "Precisions: compute, accumulation (float16 maps to bfloat16)", "+"),
]

_TRANSLATION = [
    _f("vocabs", str, [], "Paths to vocabulary files", "*"),
    _f("mini-batch", int, 1, "Minibatch size (sentences)"),
    _f("mini-batch-words", int, 0, "Minibatch size in words"),
    _f("maxi-batch", int, 1, "Number of minibatches to preload and sort"),
    _f("maxi-batch-sort", str, "src", "Sorting within maxi-batch: src, none"),
    _f("data-threads", int, 8, "Host threads for data pipeline"),
    _f("input", str, ["stdin"], "Input file(s) or stdin", "+"),
    _f("output", str, "stdout", "Output file or stdout"),
    _f("models", str, [], "Model file(s) to ensemble", "*"),
    _f("weights", float, [], "Ensemble scorer weights", "*"),
    _f("beam-size", int, 12, "Beam size"),
    _f("normalize", float, 0.0, "Divide score by length^alpha", "?"),
    _f("word-penalty", float, 0.0, "Subtract penalty*length from score"),
    _f("allow-unk", bool, False, "Allow <unk> in output"),
    _f("allow-special", bool, False, "Allow special symbols in output"),
    _f("n-best", bool, False, "Produce n-best lists"),
    _f("word-scores", bool, False, "Print per-word scores in n-best lists"),
    _f("n-best-feature", str, "Score", "Feature name for the n-best score column"),
    _f("alignment", str, None, "Return word alignments: 0.x threshold, soft, hard", "?"),
    _f("force-decode", bool, False, "Force-decode given prefixes"),
    _f("output-sampling", str, [], "Sampling instead of argmax: full [temp] / topk k [temp]", "*"),
    _f("output-approx-knn", int, [], "LSH-approximated output layer: nodes, hashes", "*"),
    _f("max-length-factor-translate", float, 3.0, "(see max-length-factor)"),
    _f("shortlist", str, [], "Lexical shortlist: path [first] [best] [prune]", "*"),
    _f("devices", str, ["0"], "Device ids (GPU compat)", "+"),
    _f("num-devices", int, 0, "Number of devices (0 = all visible; this slice decodes on one)"),
    _f("cpu-threads", int, 0, "Use CPU with this many threads (inference)", "?"),
]

FLAGS = _COMMON + _MODEL + _TRANSLATION

# mode-suffixed duplicates → the canonical key runtime code reads
_CANONICAL = {"max-length-factor-translate": "max-length-factor"}


class ConfigParser:
    """parseOptions equivalent for the decoder. Returns a fully-populated
    Options."""

    def __init__(self):
        self.flags = {f.name: f for f in FLAGS}

    def _build_argparser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(prog="marian-tpu-torch (translation)",
                                    add_help=True, allow_abbrev=False)
        for f in self.flags.values():
            kwargs: Dict[str, Any] = {"dest": f.name.replace("-", "_"),
                                      "default": None}
            if f.type is bool:
                # CLI11-style: bare flag = true, or explicit --flag true/false
                kwargs.update(nargs="?", const=True, type=_parse_bool)
            else:
                kwargs["type"] = f.type
                if f.nargs:
                    kwargs["nargs"] = f.nargs
                    if f.nargs == "?":
                        kwargs["const"] = ""
            p.add_argument(f"--{f.name}", help=f.help, **kwargs)
        return p

    def defaults(self) -> Dict[str, Any]:
        return {f.name: f.default for f in self.flags.values()
                if f.default is not None}

    def parse(self, argv: Optional[Sequence[str]] = None) -> Options:
        argv = list(sys.argv[1:] if argv is None else argv)
        ns, unknown = self._build_argparser().parse_known_args(argv)
        if unknown:
            raise SystemExit(f"Unknown option(s): {' '.join(unknown)}")
        cli = {k.replace("_", "-"): v for k, v in vars(ns).items()
               if v is not None}
        merged = self.defaults()
        explicit = set(cli)
        for path in _as_list(cli.get("config")):
            with open(path, "r", encoding="utf-8") as fh:
                loaded = yaml.safe_load(fh) or {}
            for k, v in loaded.items():
                merged[str(k)] = v
                explicit.add(str(k))
        for k, v in cli.items():
            if k != "config":
                merged[k] = v
        if str((merged.get("precision") or ["float32"])[0]) in (
                "float16", "fp16", "half"):
            merged["precision"] = ["bfloat16"] + list(merged["precision"][1:])
        for alias, canon in _CANONICAL.items():
            if alias in explicit and canon not in explicit:
                merged[canon] = merged[alias]
        opts = Options(merged)
        if cli.get("version"):
            print("marian-tpu-torch v0.1.0")
            raise SystemExit(0)
        if cli.get("dump-config"):
            data = opts.as_dict()
            if cli["dump-config"] == "minimal":
                data = {k: v for k, v in data.items()
                        if self.defaults().get(k) != v}
            data.pop("dump-config", None)
            yaml.safe_dump(data, sys.stdout, default_flow_style=False,
                           sort_keys=True)
            raise SystemExit(0)
        return opts


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


def _as_list(v: Any) -> List[Any]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def parse_options(argv: Optional[Sequence[str]] = None) -> Options:
    """Module-level convenience mirroring ConfigParser::parseOptions, with
    the reference's translation-mode validation."""
    opts = ConfigParser().parse(argv)
    if opts.get("dim-emb", 512) <= 0:
        raise ValueError("--dim-emb must be positive")
    if not opts.get("models", []) and not opts.get("model", None):
        raise ValueError("No model given in --models")
    w, m = opts.get("weights", []), opts.get("models", [])
    if w and len(w) != len(m):
        raise ValueError("--weights count must match --models count")
    if opts.get("beam-size", 12) < 1:
        raise ValueError("--beam-size must be >= 1")
    threads = opts.get("cpu-threads", 0)
    if isinstance(threads, (str, bool)) or threads is None:
        raise ValueError("--cpu-threads needs a thread count N > 0")
    return opts
