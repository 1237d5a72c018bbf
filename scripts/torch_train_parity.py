#!/usr/bin/env python3
"""Readings of chip_smoke.py's card-vs-CPU training check, for the sound
port and for planted faults, on one NVIDIA card. Run from the root of a
checkout:

    python3 scripts/torch_train_parity.py [--seed 17 ...] [--cut base|doc|both]

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

Each fault is planted here, by wrapping a function of the port for the
length of one variant; nothing in the port changes. One line per
variant gives its readings and whether chip_smoke.PARITY_LIMITS pass
it; the last line holds all of them as JSON.
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


@contextlib.contextmanager
def planted(variant: str):
    from marian_tpu_torch.ops import attention as tatt
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    from marian_tpu_torch.training import graph_group as gg
    saved = [(tatt, "FLASH_MIN_LEN", tatt.FLASH_MIN_LEN),
             (pa, "packed_attention_bwd", pa.packed_attention_bwd),
             (fa, "flash_attention_bwd", fa.flash_attention_bwd),
             (gg, "apply_update", gg.apply_update)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    bwd, flash_bwd, step = (pa.packed_attention_bwd, fa.flash_attention_bwd,
                            gg.apply_update)

    def scaled_dk(q, k, v, kv_mask, do, out, causal=False, scale=None):
        dq, dk, dv = bwd(q, k, v, kv_mask, do, out, causal, scale)
        return dq, dk if causal else dk * (1.0 + FAULT), dv

    scaled_dk.launches = 0        # the wrapped function counts here

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
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=[17],
                    help="chip_smoke.py's --seed (the corpora); several "
                    "give one set of readings each")
    ap.add_argument("--cut", choices=("base", "doc", "both"), default="both")
    args = ap.parse_args(argv)
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
    table = {}
    for seed, cut in ((seed, cut) for seed in args.seed
                      for cut in (("base", "doc") if args.cut == "both"
                                  else (args.cut,))):
        if cut == "base":
            cs.write_corpus(seed)
        setup = (cs.base_parity_setup() if cut == "base"
                 else cs.doc_parity_setup(seed))
        label = f"seed {seed}, {cut}"
        t0 = time.perf_counter()
        ref = cs.parity_run(*setup, "cpu")
        print(f"{label} cut, cpu reference: {time.perf_counter() - t0:.2f} s")
        for variant in VARIANTS[cut]:
            with planted(variant):
                got = cs.parity_run(*setup, "cpu" if variant == "cpu_dense"
                                    else "cuda")
            readings = cs.parity_readings(got, ref)
            row = {k: {"value": v, "where": where}
                   for k, (v, where) in readings.items()}
            row["passes"] = cs.parity_holds(readings)
            table[f"{label}/{variant}"] = row
            print(f"{label} cut, {variant}: " + "; ".join(
                f"{k} {v:.4g} ({where})"
                for k, (v, where) in readings.items())
                + f"; passes limits {cs.PARITY_LIMITS}: {row['passes']}")
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
