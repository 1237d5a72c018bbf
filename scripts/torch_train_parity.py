#!/usr/bin/env python3
"""Readings of chip_smoke.py's card-vs-CPU training check, for the sound
port and for planted faults, on one NVIDIA card. Run from the root of a
checkout:

    python3 scripts/torch_train_parity.py [--seed 17]

The check trains a 2+2-layer cut of transformer-base for 3 updates on the
card and on the CPU and compares them leaf by leaf
(``chip_smoke.parity_readings``). This script runs the CPU side once and
the card side once per variant:

- ``sound``: the port as it is;
- ``tf32``: TF32 GEMMs on the card (a lower-precision run);
- ``packed_dk``: the packed-attention backward's dk scaled by 1 + 1e-3 in
  the non-causal attentions (encoder self and cross);
- ``adam_lr``: the optimizer step taken at 1 + 1e-3 times the rate.

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


@contextlib.contextmanager
def planted(variant: str):
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    from marian_tpu_torch.training import graph_group as gg
    saved = [(pa, "packed_attention_bwd", pa.packed_attention_bwd),
             (gg, "apply_update", gg.apply_update)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    bwd, step = pa.packed_attention_bwd, gg.apply_update

    def scaled_dk(q, k, v, kv_mask, do, out, causal=False, scale=None):
        dq, dk, dv = bwd(q, k, v, kv_mask, do, out, causal, scale)
        return dq, dk if causal else dk * (1.0 + FAULT), dv

    scaled_dk.launches = 0        # the wrapped function counts here

    def scaled_lr(cfg, state, params, grads, lr, labels):
        return step(cfg, state, params, grads, lr * (1.0 + FAULT), labels)
    try:
        if variant == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif variant == "packed_dk":
            pa.packed_attention_bwd = scaled_dk
        elif variant == "adam_lr":
            gg.apply_update = scaled_lr
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
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
    cs.write_corpus(args.seed)
    setup = cs.parity_setup()
    t0 = time.perf_counter()
    ref = cs.parity_run(*setup, "cpu")
    print(f"cpu reference: {time.perf_counter() - t0:.2f} s")
    table = {}
    for variant in ("sound", "tf32", "packed_dk", "adam_lr"):
        with planted(variant):
            got = cs.parity_run(*setup, "cuda")
        readings = cs.parity_readings(got, ref)
        table[variant] = {k: {"value": v, "where": where}
                          for k, (v, where) in readings.items()}
        table[variant]["passes"] = cs.parity_holds(readings)
        print(f"{variant}: " + "; ".join(
            f"{k} {v:.4g} ({where})" for k, (v, where) in readings.items())
            + f"; passes limits {cs.PARITY_LIMITS}: "
            f"{table[variant]['passes']}")
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
