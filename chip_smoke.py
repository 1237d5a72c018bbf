#!/usr/bin/env python3
"""Chip smoke test of marian_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA card. Run from the root of a checkout:

    python3 chip_smoke.py [--seed 17]

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
at once), holds each kernel against its plain PyTorch version on the
card, and drives the port's two main paths at transformer-base's full
width on data made from --seed:

- marian-decoder: beam 6 on random weights; the same sentences are
  decoded on the card and on the CPU;
- marian-train: a synthetic 32,000-word parallel corpus, 2 updates
  through ``marian_train.main`` (which write a checkpoint), then 20
  counted updates through the trainer object ``main`` drives, resuming
  from that checkpoint; the trained checkpoint is decoded on the card; a
  2+2-layer cut trains 3 updates on the card and on the CPU, which must
  agree leaf by leaf in gradients and parameter changes.

Each main path runs with every launch count set to 0 just before it and
read just after; a kernel's ``launches`` in the kernel line is the sum
over the paths that run it. Phases print their own lines; any failure
ends the run with a non-zero exit and no result. The last line is
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
# The packed backward and the fused CE sum hundreds to thousands of
# products in another order than their plain versions: held to this
# share of the output's largest magnitude.
REL_TOL = 1e-5
# training: bench.py's 'base' preset (f32, --transformer-dropout 0.1)
TRAIN_WORDS, TRAIN_LINES, WARM_UPDATES, COUNTED_UPDATES = 12288, 8000, 2, 20
TRAIN_FLAGS = [
    "--type", "transformer", "--dim-emb", "512", "--transformer-heads", "8",
    "--transformer-dim-ffn", "2048", "--enc-depth", "6", "--dec-depth", "6",
    "--tied-embeddings-all", "--transformer-ffn-activation", "relu",
    "--precision", "float32", "float32", "--label-smoothing", "0.1",
    "--cost-type", "ce-mean-words", "--learn-rate", "2e-4",
    "--lr-warmup", "8000", "--lr-decay-inv-sqrt", "8000",
    "--optimizer", "adam", "--optimizer-params", "0.9", "0.98", "1e-9",
    "--clip-norm", "0", "--exponential-smoothing", "1e-4",
    "--max-length", "63", "--max-length-crop", "--mini-batch", "512",
    "--maxi-batch", "100", "--maxi-batch-sort", "trg", "--shuffle", "data",
    "--seed", "1111", "--transformer-dropout", "0.1", "--disp-freq", "10",
    "--quiet"]
# card vs CPU training (parity_readings), relative: limits set between
# the sound port's readings and those of planted faults
# (scripts/torch_train_parity.py; PERF.md section 6)
PARITY_LIMITS = {"loss": 1e-3, "grad": 3e-3, "grad_norm": 3e-4,
                 "update": 1e-4}
# per update: 6 encoder self + 6 decoder causal self + 6 cross attentions
PER_UPDATE = {"packed_attention": 18, "packed_attention_bwd": 18,
              "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}


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


def close_to_scale(got, ref, what: str) -> float:
    """max |got - ref|, checked against REL_TOL * max(1, max |ref|)."""
    got, ref = got.detach().float(), ref.detach().float()
    err = float((got - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    check(err <= REL_TOL * scale, f"{what}: max |err| {err:.3g} > "
          f"{REL_TOL} x scale {scale:.3g}")
    return err


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


def phase_packed_bwd_kernel(gen):
    """The backward against its plain version at the training path's
    shapes; the forward that feeds it ``out`` is held against its own
    plain version there too. Returns (backward row, forward max |err|)."""
    from marian_tpu_torch.ops.kernels.packed_attention import (
        packed_attention, packed_attention_bwd,
        packed_attention_bwd_reference, packed_attention_reference)
    dev = torch.device("cuda")
    b, h, dh = 192, 8, 64       # the rows of a 12,288-token batch at T=64
    err = fwd_err = 0.0
    for tq, tk, causal in ((64, 64, False), (64, 64, True), (64, 48, False)):
        q, do = (torch.randn(b, h, tq, dh, generator=gen).to(dev)
                 for _ in range(2))
        k, v = (torch.randn(b, h, tk, dh, generator=gen).to(dev)
                for _ in range(2))
        lens = torch.randint(1, tk + 1, (b,), generator=gen)
        lens[0] = tk
        kvm = (torch.arange(tk)[None, :] < lens[:, None]).float()
        kvm[1] = 0.0                                  # a fully-masked row
        kvm = kvm.to(dev)
        out = packed_attention(q, k, v, kvm, causal=causal)
        got = packed_attention_bwd(q, k, v, kvm, do, out, causal)
        ref = packed_attention_bwd_reference(q, k, v, kvm, do, out, causal)
        plain_out = packed_attention_reference(q, k, v, kvm, causal=causal)
        torch.cuda.synchronize()
        e = (out - plain_out).abs().max().item()
        check(e <= TOL, f"packed_attention B={b} Tq={tq} Tk={tk} "
              f"causal={causal} max |err| {e} > {TOL}")
        fwd_err = max(fwd_err, e)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            err = max(err, close_to_scale(
                g, r, f"packed_attention_bwd Tq={tq} Tk={tk} causal={causal} "
                f"{name}"))
        print(f"kernel packed_attention_bwd B={b} H={h} Tq={tq} Tk={tk} "
              f"Dh={dh} causal={causal}: max |err| {err:.3g} (tolerance "
              f"{REL_TOL} x max |plain|); its forward: max |err| {e:.3g}")
    t = 64
    q, k, v, do = (torch.randn(b, h, t, dh, generator=gen).to(dev)
                   for _ in range(4))
    kvm = torch.ones(b, t, device=dev)
    out = packed_attention(q, k, v, kvm)
    ms = time_ms(lambda: packed_attention_bwd(q, k, v, kvm, do, out))
    plain_ms = time_ms(lambda: packed_attention_bwd_reference(
        q, k, v, kvm, do, out))
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=kvm.bool()[:, None, None, :])
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True))
    nbytes = 7 * b * h * t * dh * 4 + b * t * 4 + b * h * t * 4
    bound_ms, bound_by = bound(nbytes, 10 * b * h * t * t * dh)
    print(f"kernel packed_attention_bwd B={b} H={h} T={t} Dh={dh} f32: "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa "
          f"backward) {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB, {10 * b * h * t * t * dh / 1e9:.2f} GFLOP)")
    return {"name": "packed_attention_bwd", "route": "cuda",
            "source": "marian_tpu_torch/csrc/packed_attention.cu",
            "replaces": "marian_tpu/ops/pallas/packed_attention.py:214",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}, fwd_err


def phase_fused_ce_kernels(gen) -> list:
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    dev = torch.device("cuda")

    def inputs(n, v, e):
        x = torch.randn(n, e, generator=gen).to(dev)
        w = (torch.randn(v, e, generator=gen) * e ** -0.5).to(dev)
        b = torch.randn(v, generator=gen).to(dev)
        labels = torch.randint(0, v, (n,), generator=gen).to(dev)
        return x, w, b, labels

    errs = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    # ragged N and V; E = 1024 (transformer-big) splits the dx / dw
    # accumulators into two column ranges; the last case is the main
    # path's N, V and E, kept for the timings below
    for n, v, e in ((4096, VOCAB, 512), (4001, VOCAB + 3, 512),
                    (2048, VOCAB + 3, 1024), (TRAIN_WORDS, VOCAB, 512)):
        x, w, b, labels = inputs(n, v, e)
        got = fce.fused_ce_stats(x, w, b, labels)
        ref = fce.fused_ce_stats_reference(x, w, b, labels)
        g = [torch.randn(n, generator=gen).to(dev) for _ in range(3)]
        dx = fce.fused_ce_dx(x, w, b, labels, ref[0], *g)
        dw, db = fce.fused_ce_dw(x, w, b, labels, ref[0], *g)
        rdx, rdw, rdb = fce.fused_ce_bwd_reference(x, w, b, labels, ref[0],
                                                   *g)
        torch.cuda.synchronize()
        what = f"N={n} V={v} E={e}"
        for name, a, r in zip(("lse", "lab", "tot"), got, ref):
            errs["fwd"] = max(errs["fwd"], close_to_scale(
                a, r, f"fused_ce_fwd {what} {name}"))
        errs["dx"] = max(errs["dx"], close_to_scale(dx, rdx,
                                                   f"fused_ce_dx {what}"))
        errs["dw"] = max(errs["dw"], close_to_scale(dw, rdw,
                                                   f"fused_ce_dw {what}"),
                         close_to_scale(db, rdb, f"fused_ce_db {what}"))
        print(f"kernel fused_ce {what}: max |err| fwd {errs['fwd']:.3g} dx "
              f"{errs['dx']:.3g} dw/db {errs['dw']:.3g} (tolerance "
              f"{REL_TOL} x max |plain| of each output)")
        lse = ref[0]
        del got, ref, dx, dw, db, rdx, rdw, rdb
    torch.cuda.empty_cache()
    times = {
        "fwd": (lambda: fce.fused_ce_stats(x, w, b, labels),
                lambda: fce.fused_ce_stats_reference(x, w, b, labels)),
        "dx": (lambda: fce.fused_ce_dx(x, w, b, labels, lse, *g),
               lambda: torch.matmul(fce.dlogits_reference(
                   x, w, b, labels, lse, *g), w)),
        "dw": (lambda: fce.fused_ce_dw(x, w, b, labels, lse, *g),
               lambda: (lambda d: (torch.matmul(d.t(), x), d.sum(0)))(
                   fce.dlogits_reference(x, w, b, labels, lse, *g))),
    }
    xl, wl, bl = (t.clone().requires_grad_(True) for t in (x, w, b))

    def lib_fwd():
        return torch.nn.functional.cross_entropy(
            torch.nn.functional.linear(xl, wl, bl), labels,
            label_smoothing=0.1, reduction="sum")
    lib_loss = lib_fwd()
    lib_fwd_ms = time_ms(lib_fwd, iters=5)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_loss, (xl, wl, bl), retain_graph=True), iters=5)
    del lib_loss
    flops = {"fwd": 2 * n * v * e, "dx": 4 * n * v * e, "dw": 4 * n * v * e}
    io_in = (n * e + v * e + v) * 4 + n * 4
    nbytes = {"fwd": io_in + 3 * n * 4, "dx": io_in + 4 * n * 4 + n * e * 4,
              "dw": io_in + 4 * n * 4 + (v * e + v) * 4}
    rows = []
    for part, line in (("fwd", 205), ("dx", 233), ("dw", 233)):
        ms = time_ms(times[part][0], iters=5)
        plain_ms = time_ms(times[part][1], iters=5)
        library_ms = lib_fwd_ms if part == "fwd" else lib_bwd_ms
        bound_ms, bound_by = bound(nbytes[part], flops[part])
        print(f"kernel fused_ce_{part} N={n} V={v} E={e} f32: kernel_ms "
              f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{'(linear + cross_entropy, two calls)' if part == 'fwd' else '(backward of linear + cross_entropy, two calls)'} "
              f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
              f"{flops[part] / 1e9:.0f} GFLOP, "
              f"{flops[part] / ms / 1e9:.2f} TFLOP/s achieved)")
        rows.append({"name": f"fused_ce_{part}", "route": "cuda",
                     "source": "marian_tpu_torch/csrc/fused_ce.cu",
                     "replaces": f"marian_tpu/ops/pallas/fused_ce.py:{line}",
                     "max_abs_err": errs[part], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    return rows


def write_vocab() -> None:
    """The 32,000-word vocabulary w2 .. w31999 of the synthetic data."""
    from marian_tpu_torch.data.vocab import DefaultVocab
    WORK.mkdir(parents=True, exist_ok=True)
    vocab = DefaultVocab({"</s>": 0, "<unk>": 1,
                          **{f"w{i}": i for i in range(2, VOCAB)}})
    vocab.save(str(WORK / "vocab.yml"))


def write_model(seed: int):
    """A 32,000-word vocab and transformer-base weights from ``seed``
    (plus a 2+2-layer cut of them), written through the port's own io.
    The output bias is drawn wide (std 2) so the random model's next-token
    ranking has gaps far above f32 rounding: card and CPU then pick the
    same beams."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.common.options import Options
    from marian_tpu_torch.models import transformer as T
    write_vocab()
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


def kernel_counters():
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    return {"packed_attention": pa.packed_attention,
            "packed_attention_bwd": pa.packed_attention_bwd,
            "fused_ce_fwd": fce.fused_ce_stats,
            "fused_ce_dx": fce.fused_ce_dx, "fused_ce_dw": fce.fused_ce_dw}


def write_corpus(seed: int) -> None:
    """A synthetic parallel corpus from ``seed``: random words of the
    32,000-word vocabulary, 8-63 words a line on each side."""
    rng = np.random.RandomState(seed + 2)
    for side in ("src", "trg"):
        lens = rng.randint(8, 64, TRAIN_LINES)
        ids = rng.randint(2, VOCAB, int(lens.sum()))
        words = np.char.add("w", ids.astype(str))
        cuts = np.cumsum(lens)[:-1]
        (WORK / f"train.{side}").write_text(
            "\n".join(" ".join(l) for l in np.split(words, cuts)) + "\n")


def train_argv(model: str, updates: int, *extra: str):
    vocab = str(WORK / "vocab.yml")
    return [*TRAIN_FLAGS, "--train-sets", str(WORK / "train.src"),
            str(WORK / "train.trg"), "--vocabs", vocab, vocab, "--model",
            str(WORK / model), "--mini-batch-words", str(TRAIN_WORDS),
            "--after-batches", str(updates), *extra]


def phase_train_main_path(seed: int) -> dict:
    from marian_tpu_torch.cli import marian_train
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.training.graph_group import GraphGroup
    from marian_tpu_torch.training.train import Train
    from marian_tpu_torch.translator.translator import Translate
    write_corpus(seed)
    for f in WORK.glob("train.npz*"):
        f.unlink()
    # warm-up, not counted: the command-line trainer, which writes the
    # checkpoint the counted run resumes from
    t0 = time.perf_counter()
    marian_train.main(train_argv("train.npz", WARM_UPDATES))
    warm_s = time.perf_counter() - t0
    check((WORK / "train.npz.optimizer.npz").exists(), "warm-up checkpoint")
    # the counted run: the trainer object marian_train.main drives
    total = WARM_UPDATES + COUNTED_UPDATES
    tr = Train(parse_options(train_argv("train.npz", total),
                             mode="training"))
    check(tr.device.type == "cuda", f"trainer resolved {tr.device}")
    # each update's outputs, recorded as the trainer makes them (device
    # scalars, read after the run), and the host clock from the first
    # update's start to the last update's end
    outs, clock = [], {}
    update = GraphGroup.update

    def recorded(gg, batch, step, generator=None):
        if not outs:
            torch.cuda.synchronize()
            clock["start"] = time.perf_counter()
        out = update(gg, batch, step, generator)
        outs.append((out.loss_sum, out.labels, batch["src_mask"].sum()))
        if len(outs) == COUNTED_UPDATES:
            torch.cuda.synchronize()
            clock["end"] = time.perf_counter()
        return out

    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    GraphGroup.update = recorded
    try:
        tr.run()
    finally:
        GraphGroup.update = update
    counts = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    updates = len(outs)
    check(updates == COUNTED_UPDATES and tr.state.batches == total,
          f"counted run did {updates} updates, state at {tr.state.batches}")
    for name, per in PER_UPDATE.items():
        check(counts[name] == per * updates,
              f"{name} launches {counts[name]} != {per} x {updates} updates")
    loss_sum, trg_tokens, src_tokens = (
        np.array([float(o[i]) for o in outs]) for i in range(3))
    costs = loss_sum / trg_tokens
    check(bool(np.isfinite(costs).all()), f"training losses {costs}")
    params = tr.graph_group.export_params()
    check(all(bool(torch.isfinite(p).all()) for p in params.values()),
          "non-finite parameters after training")
    secs = clock["end"] - clock["start"]
    print(f"train main path: transformer-base 6+6, dim 512, ffn 2048, 8 "
          f"heads, vocab {VOCAB}, f32, dropout 0.1, {TRAIN_WORDS} target "
          f"words a batch: warm-up {WARM_UPDATES} updates through "
          f"marian_train.main in {warm_s:.2f} s; counted {updates} updates "
          f"in {secs:.3f} s, {1e3 * secs / updates:.2f} ms/update, "
          f"{src_tokens.sum() / secs:.1f} source tokens/s, "
          f"{trg_tokens.sum() / secs:.1f} target tokens/s; "
          f"peak memory {peak_gb:.2f} GB; mean CE first/last "
          f"{costs[0]:.4f}/{costs[-1]:.4f}; launches {counts}")
    # decode a few sentences on the card from the checkpoint just written
    src = (WORK / "train.src").read_text().splitlines()[:8]
    trn = Translate(decoder_options("train.npz", "--n-best"))
    hyps = [l.split(" ||| ") for s in trn.run(src, io.StringIO())
            for l in s.splitlines()]
    scores = np.array([float(h[2].split()[1]) for h in hyps])
    check(len(hyps) == BEAM * len(src) and bool(np.isfinite(scores).all()),
          f"decode of the trained checkpoint: {len(hyps)} hypotheses")
    print(f"train main path: decoded {len(src)} sentences from the trained "
          f"checkpoint on the card, {len(hyps)} hypotheses, best score "
          f"{scores.max():.3f}")
    return counts


def parity_setup():
    """The card-vs-CPU training cut: 2+2 layers of transformer-base
    without dropout, 3 batches of about 2,048 target words, initial
    parameters from seed 5, and a constant learning rate of 2e-4 (no
    warm-up), so that the 3 Adam updates move every parameter by about
    the rate; and 3 sets of random gradients (seed 6) for the update tail
    alone. Returns (options, vocab size, batches, initial params, step
    gradients)."""
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.data.batch_generator import BatchGenerator
    from marian_tpu_torch.data.corpus import Corpus
    from marian_tpu_torch.data.vocab import create_vocab
    from marian_tpu_torch.models import transformer as T
    from marian_tpu_torch.models.encoder_decoder import create_model
    opts = parse_options(train_argv("cut.npz", 3, "--enc-depth", "2",
                                    "--dec-depth", "2",
                                    "--transformer-dropout", "0",
                                    "--mini-batch-words", "2048",
                                    "--lr-warmup", "0"),
                         mode="training")
    vocab = create_vocab(str(WORK / "vocab.yml"))
    batches = []
    for batch in BatchGenerator(Corpus([str(WORK / "train.src"),
                                        str(WORK / "train.trg")],
                                       [vocab, vocab], opts), opts):
        batches.append(batch)
        if len(batches) == 3:
            break
    model = create_model(opts, len(vocab), len(vocab))
    init = T.init_params(model.cfg, 5)
    gen = torch.Generator().manual_seed(6)
    step_grads = [{k: torch.randn(torch.as_tensor(v).shape, generator=gen)
                   for k, v in init.items()} for _ in batches]
    return opts, len(vocab), batches, init, step_grads


def parity_run(opts, n_vocab: int, batches, init, step_grads,
               device: str) -> dict:
    """On ``device``, from the same initial parameters: the gradient of
    every leaf on the first batch; 3 updates through the GraphGroup (mean
    CE and global gradient norm of each); and the update tail alone
    (cost normalisation, clipping, Adam, EMA: ``finalize_update``) for 3
    steps on ``step_grads``, with each leaf's change over them. Tensors
    come back as float64 on the CPU."""
    from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                         create_model)
    from marian_tpu_torch.training.graph_group import (GraphGroup,
                                                       cost_denominator,
                                                       finalize_update)
    dev = torch.device(device)

    def graph_group():
        gg = GraphGroup(create_model(opts, n_vocab, n_vocab), opts, dev)
        gg.initialize(init)
        return gg
    gg = graph_group()
    arrays = [batch_to_arrays(b, dev) for b in batches]
    names = list(gg.params)
    total, _ = gg.model.loss(gg.params, arrays[0], None, train=True)
    grads = torch.autograd.grad(total, [gg.params[k] for k in names],
                                allow_unused=True)
    grads = {k: (torch.zeros_like(gg.params[k]) if g is None else g)
             .detach().cpu().double() for k, g in zip(names, grads)}
    outs = [gg.update(a, i + 1) for i, a in enumerate(arrays)]
    tail = graph_group()
    for i, (batch, g) in enumerate(zip(batches, step_grads)):
        labels = torch.tensor(float(batch.words), device=dev)
        finalize_update(tail.opt_cfg, tail.opt_state, tail.params,
                        {k: v.to(dev) for k, v in g.items()},
                        tail.schedule(i + 1), labels,
                        cost_denominator(tail.cost_type, labels, batch.size))
    return {"loss": [float(o.loss_sum) / float(o.labels) for o in outs],
            "norm": [float(o.grad_norm) for o in outs], "grad": grads,
            "update": {k: tail.params[k].detach().cpu().double()
                       - torch.as_tensor(init[k]).double() for k in names}}


def parity_readings(got: dict, ref: dict) -> dict:
    """Card (``got``) against CPU (``ref``): {reading: (value, where)},
    each a relative difference, the worst over its parts:

    - ``loss``: per-update mean CE and global gradient norm of the 3
      updates. Adam steps each element by about the rate times the sign
      of its gradient, so an element whose gradient is near 0 may step
      the other way on the other device, and the trajectories part: this
      reading catches only gross faults;
    - ``grad``: a leaf's gradient, |g_card - g_cpu| / |g_cpu| (Frobenius
      norms). One ReLU whose input rounds to the other side of 0 adds an
      outer product of about 1/sqrt(tokens x width) of the FFN gradient,
      so this reading has a floor of some 1e-4;
    - ``grad_norm``: |(|g_card| - |g_cpu|)| / |g_cpu| per leaf, which such
      orthogonal noise barely moves and a scaled gradient moves fully;
    - ``update``: a leaf's change over the 3 steps of the update tail on
      the same gradients, |d_card - d_cpu| / |d_cpu|.

    The attention key biases (``*_bk``) are left out of the gradient
    readings: a bias added to every key moves a row of scores by one
    constant, which softmax ignores, so their gradient is 0 in exact
    arithmetic and rounding noise in f32."""
    a = np.array(got["loss"] + got["norm"])
    b = np.array(ref["loss"] + ref["norm"])

    def worst(part, norms=False):
        x, y = got[part], ref[part]
        errs = {}
        for k in y:
            if part == "grad" and k.endswith("_bk"):
                continue
            ny = float(y[k].norm())
            diff = (abs(float(x[k].norm()) - ny) if norms
                    else float((x[k] - y[k]).norm()))
            errs[k] = diff / max(ny, 1e-30)
        k = max(errs, key=errs.get)
        return errs[k], k
    return {"loss": (float(np.max(np.abs(a - b) / np.abs(b))),
                     "mean CE and gradient norm"),
            "grad": worst("grad"), "grad_norm": worst("grad", norms=True),
            "update": worst("update")}


def parity_holds(readings: dict) -> bool:
    return all(readings[k][0] <= lim for k, lim in PARITY_LIMITS.items())


def phase_train_card_vs_cpu() -> None:
    """The 2+2-layer cut trained on the card (kernels) and on the CPU
    (dense attention and dense CE) from the same parameters on the same
    batches; held to PARITY_LIMITS."""
    setup = parity_setup()
    res = {}
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[name] = parity_run(*setup, name)
        print(f"train card vs cpu: {name} 3 updates, 2+2 layers, "
              f"{sum(b.words for b in setup[2])} target words, and 3 steps "
              f"of the update tail: "
              f"{time.perf_counter() - t0:.2f} s; mean CE {res[name]['loss']}"
              f"; gradient norm {res[name]['norm']}")
    check(bool(np.isfinite(res["cuda"]["loss"] + res["cuda"]["norm"]).all()),
          "non-finite card losses")
    readings = parity_readings(res["cuda"], res["cpu"])
    text = "; ".join(f"{k} {v:.3g} ({where}, limit {PARITY_LIMITS[k]})"
                     for k, (v, where) in readings.items())
    check(parity_holds(readings), f"card vs cpu training: {text}")
    print(f"train card vs cpu: {text}")


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
    packed = phase_packed_kernel(gen)
    packed_bwd, packed_fwd_err = phase_packed_bwd_kernel(gen)
    packed["max_abs_err"] = max(packed["max_abs_err"], packed_fwd_err)
    kernels = [phase_decode_kernel(gen), packed, packed_bwd,
               *phase_fused_ce_kernels(gen)]
    torch.cuda.empty_cache()
    lines = write_model(args.seed)
    counts = phase_main_path(lines)
    phase_card_vs_cpu(lines)
    train_counts = phase_train_main_path(args.seed)
    for k in kernels:
        k["launches"] = counts.get(k["name"], 0) + train_counts.get(
            k["name"], 0)
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel was not launched on its main path")
    phase_train_card_vs_cpu()
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
