#!/usr/bin/env python3
"""Readings of chip_smoke.py's card-vs-CPU training check, for the sound
port and for planted faults, on one NVIDIA card. Run from the root of a
checkout:

    python3 scripts/torch_train_parity.py [--seed 17 ...] [--cut base|doc|both]
        [--precision bfloat16]

The check trains a 2+2-layer cut on the card and on the CPU and compares
them leaf by leaf (``chip_smoke.parity_readings``): the ``base`` cut of
transformer-base for 3 updates (its attentions take the packed kernels),
and the ``doc`` cut (dim 256, 4 heads, a 500-word vocabulary, documents
past 1,024 tokens) for 2 updates (every attention takes the flash
kernels). This script runs the
CPU side of a cut once and the card side once per variant:

- ``sound``: the port as it is;
- ``tf32`` (base): TF32 GEMMs on the card (a lower-precision run);
- ``packed_dk`` (base): the packed-attention backward's dk scaled by
  1 + 1e-3 in the non-causal attentions (encoder self and cross);
- ``adam_lr`` (base): the optimizer step taken at 1 + 1e-3 times the rate;
- ``flash_dk`` (doc): the flash backward's dk (the dkv kernel's) scaled
  by 1 + 1e-3 in the non-causal attentions;
- ``dense`` (doc): the card with flash attention off (the dense path,
  cuBLAS products and a materialised softmax), read against the CPU's
  flash plain version: the same function in another f32 summation order,
  without the kernels;
- ``cpu_dense`` (doc): the same dense path on the CPU against the CPU's
  flash plain version: how far two f32 summation orders of one function
  part on one device.

With ``--precision bfloat16`` both cuts train at --precision bfloat16
float32 (chip_smoke.BF16_FLAGS) and are read against
chip_smoke.PARITY_LIMITS_BF16, with these variants:

- ``sound``;
- ``d_unrounded``: the card's fused CE backward without the rounding of
  d to bf16 before the dx and dw products (its f32 instantiation on the
  widened operands);
- ``bf16_reduction``: cuBLAS allowed to reduce split-K partial sums in
  bf16 (``allow_bf16_reduced_precision_reduction`` left on);
- ``dense_ce`` (a noise probe): the card with --fused-ce off, the dense
  logits through ``logits_matmul`` and its rounded cotangent;
- ``cot_unrounded``: that dense path with the logits cotangent not
  rounded to bf16 (f32 backward products);
- ``bf16_master``: the master weights kept in bf16 instead of f32, so
  every update rounds to bf16.

The base cut's ``sound`` and ``bf16_reduction`` variants also read the
bf16 decode of 8 sentences through the 2+2 base checkpoint, compared by
step logits on the card's own tokens (``chip_smoke.bf16_decode_reading``,
which writes the models first); the training-only faults cannot move it.

Each fault is planted here, by wrapping a function of the port for the
length of one variant; nothing in the port changes. One line per
variant gives its readings and whether the limits pass it; the last
line holds all of them as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FAULT = 1e-3


VARIANTS = {"base": ("sound", "tf32", "packed_dk", "adam_lr"),
            "doc": ("sound", "dense", "cpu_dense", "flash_dk")}
BF16_VARIANTS = ("sound", "d_unrounded", "bf16_reduction", "dense_ce",
                 "cot_unrounded", "bf16_master")
# the variants that run the card with --fused-ce off
DENSE_CE = ("dense_ce", "cot_unrounded")
DECODE_VARIANTS = ("sound", "bf16_reduction")


@contextlib.contextmanager
def planted(variant: str):
    from marian_tpu_torch.ops import attention as tatt
    from marian_tpu_torch.ops import ops
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    from marian_tpu_torch.training import graph_group as gg
    saved = [(tatt, "FLASH_MIN_LEN", tatt.FLASH_MIN_LEN),
             (pa, "packed_attention_bwd", pa.packed_attention_bwd),
             (fa, "flash_attention_bwd", fa.flash_attention_bwd),
             (gg, "apply_update", gg.apply_update),
             (fce, "fused_ce_bwd", fce.fused_ce_bwd),
             (ops._LogitsMatmul, "backward", ops._LogitsMatmul.backward),
             (gg.GraphGroup, "initialize", gg.GraphGroup.initialize)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    bf16_red = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    ce_bwd, init = fce.fused_ce_bwd, gg.GraphGroup.initialize

    def unrounded_d(x, w, b, labels, lse, g_lse, g_lab, g_tot, need_dx=True,
                    need_dw=True, chunk=None):
        dx, dw, db = ce_bwd(x.float(), w.float(), b, labels, lse, g_lse,
                            g_lab, g_tot, need_dx, need_dw, chunk)
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), db)

    def unrounded_cotangent(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g2 @ w.float().t()).to(x.dtype).reshape(x.shape)
        dw = (x.reshape(-1, x.shape[-1]).float().t() @ g2).to(w.dtype)
        return dx, dw

    def bf16_master(self, init_params):
        init(self, init_params)
        self.params = {k: p.detach().bfloat16().requires_grad_(True)
                       for k, p in self.params.items()}
    bwd, flash_bwd, step = (pa.packed_attention_bwd, fa.flash_attention_bwd,
                            gg.apply_update)

    def scaled_dk(q, k, v, kv_mask, do, out, causal=False, scale=None):
        dq, dk, dv = bwd(q, k, v, kv_mask, do, out, causal, scale)
        return dq, dk if causal else dk * (1.0 + FAULT), dv

    # the wrapped function counts here
    scaled_dk.launches = scaled_dk.launches_bf16_tc = 0

    def scaled_flash_dk(q, k, v, kv_mask, do, out, lse, causal=False,
                        scale=None):
        dq, dk, dv = flash_bwd(q, k, v, kv_mask, do, out, lse, causal, scale)
        return dq, dk if causal else dk * (1.0 + FAULT), dv

    def scaled_lr(cfg, state, params, grads, lr, labels):
        return step(cfg, state, params, grads, lr * (1.0 + FAULT), labels)
    try:
        if variant == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif variant == "packed_dk":
            pa.packed_attention_bwd = scaled_dk
        elif variant == "adam_lr":
            gg.apply_update = scaled_lr
        elif variant == "flash_dk":
            fa.flash_attention_bwd = scaled_flash_dk
        elif variant in ("dense", "cpu_dense"):
            tatt.FLASH_MIN_LEN = 1 << 30      # auto never takes flash
        elif variant == "d_unrounded":
            fce.fused_ce_bwd = unrounded_d
        elif variant == "bf16_reduction":
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = True
        elif variant == "cot_unrounded":
            ops._LogitsMatmul.backward = staticmethod(unrounded_cotangent)
        elif variant == "bf16_master":
            gg.GraphGroup.initialize = bf16_master
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            bf16_red
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=[17],
                    help="chip_smoke.py's --seed (the corpora); several "
                    "give one set of readings each")
    ap.add_argument("--cut", choices=("base", "doc", "both"), default="both")
    ap.add_argument("--precision", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args(argv)
    bf16 = args.precision == "bfloat16"
    if not torch.cuda.is_available():
        print("torch_train_parity: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    resolve_device("cuda")                           # TF32 off, card present
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    _build.build_all()
    cs.write_vocab()
    extra = cs.BF16_FLAGS if bf16 else ()
    lines = cs.write_model(args.seed[0]) if bf16 else None
    table = {}
    for seed, cut in ((seed, cut) for seed in args.seed
                      for cut in (("base", "doc") if args.cut == "both"
                                  else (args.cut,))):
        if cut == "base":
            cs.write_corpus(seed)
        setup = (cs.base_parity_setup(*extra) if cut == "base"
                 else cs.doc_parity_setup(seed, *extra))
        label = f"seed {seed}, {cut}"
        limits = cs.PARITY_LIMITS
        if bf16:
            limits = {**cs.PARITY_LIMITS_BF16[cut],
                      "decode": cs.PARITY_LIMITS_BF16["decode"]}
        t0 = time.perf_counter()
        ref = cs.parity_run(*setup, "cpu")
        print(f"{label} cut, cpu reference: {time.perf_counter() - t0:.2f} s")
        for variant in (BF16_VARIANTS if bf16 else VARIANTS[cut]):
            run = setup
            if variant in DENSE_CE:
                run = (setup[0].with_(**{"fused-ce": "off"}), *setup[1:])
            with planted(variant):
                got = cs.parity_run(*run, "cpu" if variant == "cpu_dense"
                                    else "cuda")
                readings = cs.parity_readings(got, ref)
                if bf16 and cut == "base" and variant in DECODE_VARIANTS:
                    readings["decode"] = cs.bf16_decode_reading(
                        "base_2x2.npz", lines[:8])["decode"]
            row = {k: {"value": v, "where": where}
                   for k, (v, where) in readings.items()}
            row["passes"] = cs.parity_holds(readings, limits)
            table[f"{label}/{variant}"] = row
            print(f"{label} cut, {variant}: " + "; ".join(
                f"{k} {v:.4g} ({where})"
                for k, (v, where) in readings.items())
                + f"; passes limits {limits}: {row['passes']}")
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
