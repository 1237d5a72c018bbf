#!/usr/bin/env python3
"""Chip smoke test of marian_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA card. Run from the root of a checkout:

    python3 chip_smoke.py [--seed 17]

It builds the port's CUDA kernels from csrc/ on first use, holds each
kernel against its plain PyTorch version on the card, drives the port's
marian-decoder path (transformer-base at full width, beam 6) on random
weights made from --seed, and decodes the same sentences on the card and
on the CPU. Phases print their own lines; any failure ends the run with
a non-zero exit and no result. The last line is
{"ok": true, "device": {...}}; the line before it lists every kernel.

Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# transformer-base as the repo runs it (bench_decode.py 'base' preset)
BASE = {"type": "transformer", "dim-emb": 512, "transformer-heads": 8,
        "transformer-dim-ffn": 2048, "enc-depth": 6, "dec-depth": 6,
        "tied-embeddings-all": True, "transformer-ffn-activation": "relu",
        "precision": ["float32", "float32"], "max-length": 64}
VOCAB, BATCH, SRC_LEN, BEAM, N_BATCHES = 32000, 64, 32, 6, 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TOL = 2e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the launches queue up behind a device
    sleep, so host-side launch cost does not show between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")
    return line


def phase_build() -> None:
    from marian_tpu_torch.ops.kernels import _build
    t0 = time.time()
    built = _build.build_all()
    print(f"build: {', '.join(built) or 'nothing to build'} in "
          f"{time.time() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_decode_kernel(gen) -> dict:
    from marian_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    dev = torch.device("cuda")
    r, h, L, dh = BATCH * BEAM, 8, 64, 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    q, kn, vn = randn(r, h, 1, dh), randn(r, h, 1, dh), randn(r, h, 1, dh)
    ck, cv = randn(r, h, L, dh), randn(r, h, L, dh)
    beams = (torch.arange(BATCH)[:, None] * BEAM
             + torch.randint(0, BEAM, (BATCH, BEAM), generator=gen))
    beam_src = beams.reshape(-1).to(torch.int32).to(dev)
    repeats = torch.randint(0, r, (r,), generator=gen).to(torch.int32).to(dev)
    rows_pos = torch.randint(0, L, (r,), generator=gen)
    rows_pos[0], rows_pos[1] = 0, L - 1
    cases = [("repeats, pos 0", repeats, 0),
             ("repeats, pos L-1", repeats, L - 1),
             ("beam rows, per-row pos", beam_src, rows_pos.to(torch.int32).to(dev)),
             ("identity, pos 31", None, 31)]
    err = 0.0
    for name, src, pos in cases:
        out, nk, nv = decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
        ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, pos, src)
        torch.cuda.synchronize()
        e = (out - ro).abs().max().item()
        check(e <= TOL, f"decode_attention [{name}] max |err| {e} > {TOL}")
        check(torch.equal(nk, rk) and torch.equal(nv, rv),
              f"decode_attention [{name}] caches differ from the plain version")
        err = max(err, e)
        print(f"kernel decode_attention [{name}]: max |err| {e:.3g}, caches "
              f"exact")
    bk, bv = torch.empty_like(ck), torch.empty_like(cv)
    pos_t = torch.full((r,), L - 1, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: decode_attention(q, kn, vn, ck, cv, pos_t,
                                          src_rows=beam_src, out_k=bk,
                                          out_v=bv))
    plain_ms = time_ms(lambda: decode_attention_reference(
        q, kn, vn, ck, cv, pos_t, beam_src))
    gk = ck.index_select(0, beam_src.long())
    gv = cv.index_select(0, beam_src.long())
    live = torch.ones((r, 1, 1, L), dtype=torch.bool, device=dev)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, gk, gv, attn_mask=live))
    uniq = int(torch.unique(beam_src).numel())
    tile = h * L * dh * 4
    nbytes = 2 * uniq * tile + 2 * r * tile + 4 * r * h * dh * 4 + 2 * r * 4
    flops = 4 * r * h * L * dh
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel decode_attention R={r} H={h} L={L} Dh={dh} f32: kernel_ms "
          f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa, attention only) "
          f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({nbytes / 1e6:.1f} MB)")
    return {"name": "decode_attention", "route": "cuda",
            "source": "marian_tpu_torch/csrc/decode_attention.cu",
            "replaces": "marian_tpu/ops/pallas/decode_attention.py:117",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_packed_kernel(gen) -> dict:
    from marian_tpu_torch.ops.kernels.packed_attention import (
        packed_attention, packed_attention_reference)
    dev = torch.device("cuda")
    b, h, dh = BATCH, 8, 64
    err = 0.0
    for t, causal in ((SRC_LEN, False), (50, False), (50, True)):
        q, k, v = (torch.randn(b, h, t, dh, generator=gen).to(dev)
                   for _ in range(3))
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0] = t
        kvm = (torch.arange(t)[None, :] < lens[:, None]).float()
        kvm[1] = 0.0                                  # a fully-masked row
        kvm = kvm.to(dev)
        out = packed_attention(q, k, v, kvm, causal=causal)
        ref = packed_attention_reference(q, k, v, kvm, causal=causal)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        check(e <= TOL, f"packed_attention T={t} causal={causal} max |err| "
              f"{e} > {TOL}")
        err = max(err, e)
        print(f"kernel packed_attention B={b} H={h} T={t} Dh={dh} "
              f"causal={causal}: max |err| {e:.3g}")
    t = SRC_LEN
    q, k, v = (torch.randn(b, h, t, dh, generator=gen).to(dev)
               for _ in range(3))
    kvm = torch.ones(b, t, device=dev)
    ms = time_ms(lambda: packed_attention(q, k, v, kvm))
    plain_ms = time_ms(lambda: packed_attention_reference(q, k, v, kvm))
    live = kvm.bool()[:, None, None, :]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=live))
    nbytes = 4 * b * h * t * dh * 4 + b * t * 4
    bound_ms, bound_by = bound(nbytes, 4 * b * h * t * t * dh)
    print(f"kernel packed_attention B={b} H={h} T={t} Dh={dh} f32: kernel_ms "
          f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa) {library_ms:.4f} "
          f"bound_ms {bound_ms:.4f} ({nbytes / 1e6:.1f} MB)")
    return {"name": "packed_attention", "route": "cuda",
            "source": "marian_tpu_torch/csrc/packed_attention.cu",
            "replaces": "marian_tpu/ops/pallas/packed_attention.py:261",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def write_model(seed: int):
    """A 32,000-word vocab and transformer-base weights from ``seed``
    (plus a 2+2-layer cut of them), written through the port's own io.
    The output bias is drawn wide (std 2) so the random model's next-token
    ranking has gaps far above f32 rounding: card and CPU then pick the
    same beams."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.common.options import Options
    from marian_tpu_torch.data.vocab import DefaultVocab
    from marian_tpu_torch.models import transformer as T
    WORK.mkdir(parents=True, exist_ok=True)
    vocab = DefaultVocab({"</s>": 0, "<unk>": 1,
                          **{f"w{i}": i for i in range(2, VOCAB)}})
    vocab.save(str(WORK / "vocab.yml"))
    opts = Options(BASE)
    cfg = T.config_from_options(opts, VOCAB, VOCAB)
    params = T.init_params(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    params["decoder_ff_logit_out_b"] = 2.0 * torch.randn(1, VOCAB,
                                                         generator=gen)
    flat = {k: v.numpy() for k, v in params.items()}
    mio.save_model(str(WORK / "base.npz"), flat, opts.as_yaml())
    small = {k: v for k, v in flat.items()
             if not k.startswith(("encoder_l", "decoder_l"))
             or k.split("_")[1] in ("l1", "l2")}
    mio.save_model(str(WORK / "base_2x2.npz"), small,
                   opts.with_(**{"enc-depth": 2, "dec-depth": 2}).as_yaml())
    rng = np.random.RandomState(seed)
    lines = [" ".join(f"w{i}" for i in rng.randint(2, VOCAB, SRC_LEN - 1))
             for _ in range(BATCH * N_BATCHES)]
    return lines


def decoder_options(model: str, *extra: str):
    from marian_tpu_torch.common.config_parser import parse_options
    return parse_options(["--models", str(WORK / model), "--vocabs",
                          str(WORK / "vocab.yml"), str(WORK / "vocab.yml"),
                          "--beam-size", str(BEAM), "--max-length", "64",
                          "--mini-batch", str(BATCH), "--quiet", *extra])


def phase_main_path(lines) -> dict:
    from marian_tpu_torch.ops.kernels.decode_attention import decode_attention
    from marian_tpu_torch.ops.kernels.packed_attention import packed_attention
    from marian_tpu_torch.cli import marian_decoder
    from marian_tpu_torch.translator.translator import Translate
    # warm-up, not counted: the command-line decoder on two sentences,
    # file in, file out
    (WORK / "warm.in").write_text("\n".join(lines[:2]) + "\n")
    marian_decoder.main(["--models", str(WORK / "base.npz"), "--vocabs",
                         str(WORK / "vocab.yml"), str(WORK / "vocab.yml"),
                         "--beam-size", str(BEAM), "--quiet", "--input",
                         str(WORK / "warm.in"), "--output",
                         str(WORK / "warm.out")])
    check(len((WORK / "warm.out").read_text().splitlines()) == 2,
          "command-line warm-up output")
    # the counted run: the decoder object marian_decoder.main drives,
    # built from the same flags, so model loading stays out of the timing
    tr = Translate(decoder_options("base.npz", "--n-best"))
    check(tr.device.type == "cuda", f"decoder resolved {tr.device}")
    decode_attention.launches = 0
    packed_attention.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tr.run(lines, out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"decode_attention": decode_attention.launches,
              "packed_attention": packed_attention.launches}
    steps = list(tr.search.steps)
    layers = tr.model.cfg.dec_depth
    hyps = [l.split(" ||| ") for l in out.getvalue().splitlines()]
    check(len(got) == len(lines) and len(hyps) == BEAM * len(lines)
          and sorted({int(h[0]) for h in hyps}) == list(range(len(lines))),
          f"{len(hyps)} n-best lines for {len(lines)} inputs x beam {BEAM}")
    scores = np.array([float(h[2].split()[1]) for h in hyps])
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(len(steps) == N_BATCHES, f"{len(steps)} batches, expected "
          f"{N_BATCHES}")
    check(counts["decode_attention"] == layers * sum(steps),
          f"decode_attention launches {counts['decode_attention']} != "
          f"{layers} layers x {sum(steps)} steps")
    check(counts["packed_attention"] == tr.model.cfg.enc_depth * N_BATCHES,
          f"packed_attention launches {counts['packed_attention']} != "
          f"{tr.model.cfg.enc_depth} layers x {N_BATCHES} batches")
    check(all(tr.trg_vocab.encode(h[1], add_eos=False).count(1) == 0
              for h in hyps), "output words outside the vocabulary")
    print(f"main path: transformer-base 6+6, dim 512, ffn 2048, 8 heads, "
          f"vocab {VOCAB}, beam {BEAM}, {len(lines)} sentences x {SRC_LEN} "
          f"tokens in {N_BATCHES} batches of {BATCH}: steps {steps}, "
          f"{secs:.3f} s, {len(lines) / secs:.2f} sentences/s, "
          f"{1e3 * secs / sum(steps):.3f} ms per decode step (whole run / "
          f"steps); launches {counts}")
    return counts


def phase_card_vs_cpu(lines) -> None:
    from marian_tpu_torch.translator.translator import Translate
    sents = lines[:8]
    res = {}
    for name, extra in (("cuda", ()), ("cpu", ("--cpu-threads", "8"))):
        tr = Translate(decoder_options("base_2x2.npz", "--n-best", *extra))
        check(tr.device.type == name, f"{name} run resolved {tr.device}")
        t0 = time.perf_counter()
        res[name] = tr.run(sents, io.StringIO())
        print(f"card vs cpu: {name} decode of {len(sents)} sentences, 2+2 "
              f"layers, n-best {BEAM}: {time.perf_counter() - t0:.2f} s")
    def split(out):
        hyps = [l.split(" ||| ") for s in out for l in s.splitlines()]
        return [h[:2] for h in hyps], [float(h[2].split()[1]) for h in hyps]
    (gt, gs), (ct, cs) = split(res["cuda"]), split(res["cpu"])
    check(gt == ct, "n-best tokens differ between the card and the CPU")
    print(f"card vs cpu: {len(gt)} n-best hypotheses identical; max |score "
          f"diff| {np.max(np.abs(np.subtract(gs, cs))):.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.device import resolve_device
    resolve_device("cuda")                           # TF32 off, card present
    smi = phase_card()
    phase_build()
    gen = torch.Generator().manual_seed(args.seed)
    kernels = [phase_decode_kernel(gen), phase_packed_kernel(gen)]
    lines = write_model(args.seed)
    counts = phase_main_path(lines)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    phase_card_vs_cpu(lines)
    print("kernels: " + "; ".join(
        f"{k['name']} launches {k['launches']} pass" for k in kernels))
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
