#!/usr/bin/env python3
"""Where the time of one marian_tpu_torch decode batch goes, on the card.

Builds the same transformer-base model chip_smoke.py decodes (random
weights from --seed, vocab 32,000), decodes one warm-up batch, then
traces one batch of 64 sentences x 32 tokens at beam 6 with
torch.profiler and prints: the batch's wall time and decode steps, the
device's busy time (sum of kernel times) and idle share over the wall
time, and the kernels that took the most device time. Run from the root
of a checkout on the machine with the card:

    python3 scripts/torch_decode_profile.py [--seed 17] [--top 15]
"""

from __future__ import annotations

import argparse
import io
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.translator.translator import Translate
    from torch.profiler import ProfilerActivity, profile

    _build.build_all()
    lines = cs.write_model(args.seed)[:cs.BATCH]
    tr = Translate(cs.decoder_options("base.npz"))
    tr.run(lines, io.StringIO())                      # warm-up batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(lines, io.StringIO())                      # untraced batch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(lines, io.StringIO())
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    steps = tr.search.steps[-1]
    # device kernels only: operator rows carry their kernels' time too
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"batch: {len(lines)} sentences, beam {cs.BEAM}, {steps} steps; "
          f"wall {wall * 1e3:.1f} ms untraced ({wall * 1e3 / steps:.3f} "
          f"ms/step), {traced * 1e3:.1f} ms traced")
    print(f"device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e3 / steps:.3f} "
          f"ms/step; idle share {1 - busy_us / 1e6 / wall:.3f} of the "
          f"untraced wall")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
