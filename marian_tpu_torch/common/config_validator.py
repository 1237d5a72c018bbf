"""Config validation (reference: src/common/config_validator.cpp ::
ConfigValidator::validateOptions). Raises ValueError on inconsistent setups.

A copy of ``marian_tpu/common/config_validator.py``, so that the port
refuses the same argv with the same messages; the port imports nothing
of the JAX package. ``parse_options`` runs it for every mode."""

from __future__ import annotations

from .options import Options


def validate_options(opts: Options, mode: str) -> None:
    if mode == "training":
        _validate_training(opts)
    elif mode in ("translation", "server"):
        _validate_translation(opts)
    elif mode == "scoring":
        _validate_scoring(opts)


def _validate_common_model(opts: Options) -> None:
    if opts.get("dim-emb", 512) <= 0:
        raise ValueError("--dim-emb must be positive")
    t = opts.get("type", "transformer")
    known = {"transformer", "s2s", "nematus", "amun", "multi-s2s",
             "char-s2s", "multi-transformer", "bert", "bert-classifier",
             "transformer-lm", "lm", "lm-transformer"}
    if t not in known:
        raise ValueError(f"Unknown model --type '{t}' (known: {sorted(known)})")
    if t == "transformer" and opts.get("dim-emb", 512) % opts.get("transformer-heads", 8) != 0:
        raise ValueError("--dim-emb must be divisible by --transformer-heads")


def _validate_training(opts: Options) -> None:
    _validate_common_model(opts)
    ga_flag = opts.get("guided-alignment", "none")
    if opts.get("type", "") in ("transformer-lm", "lm-transformer", "lm") \
            and ga_flag and ga_flag != "none":
        raise ValueError("--guided-alignment requires cross-attention; a "
                         "decoder-only LM (--type transformer-lm) has none")
    if opts.get("right-left", False):
        # token-position side data is NOT remapped when the target is
        # reversed — refuse rather than silently corrupt the supervision
        ga = opts.get("guided-alignment", "none")
        if ga and ga != "none":
            raise ValueError("--right-left cannot be combined with "
                             "--guided-alignment (alignment target indices "
                             "are not remapped under target reversal)")
        if opts.get("data-weighting", None) \
                and str(opts.get("data-weighting-type", "sentence")) == "word":
            raise ValueError("--right-left cannot be combined with "
                             "word-level --data-weighting (per-token "
                             "weights are not remapped under reversal)")
    if not opts.get("train-sets", []):
        raise ValueError("No train sets given in --train-sets")
    vocabs = opts.get("vocabs", [])
    trains = opts.get("train-sets", [])
    if opts.get("tsv", False):
        if len(trains) != 1:
            raise ValueError(
                f"--tsv expects ONE tab-separated --train-sets file, "
                f"got {len(trains)}")
    elif vocabs and len(vocabs) != len(trains):
        raise ValueError(
            f"Number of --vocabs ({len(vocabs)}) must match --train-sets ({len(trains)})")
    if opts.get("label-smoothing", 0.0) < 0 or opts.get("label-smoothing", 0.0) >= 1:
        raise ValueError("--label-smoothing must be in [0, 1)")
    if opts.get("optimizer-delay", 1.0) <= 0:
        raise ValueError("--optimizer-delay must be positive")
    es = opts.get("early-stopping", 10)
    if es < 0:
        raise ValueError("--early-stopping must be >= 0")
    if opts.get("cost-type", "ce-sum") not in (
            "ce-sum", "ce-mean", "ce-mean-words", "ce-rescore", "perplexity"):
        raise ValueError(f"Unknown --cost-type {opts.get('cost-type')}")


def _validate_translation(opts: Options) -> None:
    _validate_common_model(opts)
    if not opts.get("models", []) and not opts.get("model", None):
        raise ValueError("No model given in --models")
    w = opts.get("weights", [])
    m = opts.get("models", [])
    if w and len(w) != len(m):
        raise ValueError("--weights count must match --models count")
    if opts.get("beam-size", 12) < 1:
        raise ValueError("--beam-size must be >= 1")


def _validate_scoring(opts: Options) -> None:
    _validate_common_model(opts)
