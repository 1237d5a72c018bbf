#!/usr/bin/env python3
"""Where the time of one marian_tpu_torch decode batch goes, on the card.

By default: the transformer-base model chip_smoke.py decodes (random
weights from --seed, vocab 32,000), one warm-up batch, then one untraced
and one traced batch of 64 sentences x 32 tokens at beam 6. With --doc:
the doc-level decode of chip_smoke.phase_doc_decode_main_path, at its
shapes: transformer-big 6+6 (dim 1,024, 16 heads, ffn 4,096; random
weights from --seed) decodes the first 4 documents (1,023-2,047 words)
of chip_smoke's doc corpus in one batch at beam 6 with a cache of 0.5 x
the source width (1,024 at width 2,048), after a warm-up at a 20-step
cap. The traced batch runs under torch.profiler (the card's kernels
only with --doc, where a batch is some 200,000 launches). Prints: the
batch's wall time and decode steps, the device's busy time (sum of
kernel times) and idle share over the untraced wall time, and the
kernels that took the most device time. Run from the root of a checkout
on the machine with the card:

    python3 scripts/torch_decode_profile.py [--seed 17] [--top 15] [--doc]
"""

from __future__ import annotations

import argparse
import io
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
DOC_FACTOR = 0.5


def doc_model(cs, seed: int):
    """doc_profile.npz (doc-level transformer-big, random weights from
    ``seed``) and the first chip_smoke.DOC_DOCS documents of chip_smoke's
    doc corpus."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.common.options import Options
    from marian_tpu_torch.models import transformer as T
    cs.write_vocab()
    cs.write_doc_train_corpus(seed)
    opts = Options(cs.BASE).with_(**{
        "dim-emb": 1024, "transformer-heads": 16,
        "transformer-dim-ffn": 4096, "max-length": 2048})
    cfg = T.config_from_options(opts, cs.VOCAB, cs.VOCAB)
    flat = {k: v.numpy() for k, v in T.init_params(cfg, seed).items()}
    mio.save_model(str(cs.WORK / "doc_profile.npz"), flat, opts.as_yaml())
    return (cs.WORK / "doc.src").read_text().splitlines()[:cs.DOC_DOCS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--doc", action="store_true",
                    help="the doc-level decode (transformer-big, 4 "
                    "documents, cache 1,024)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.translator.translator import Translate
    from torch.profiler import ProfilerActivity, profile

    resolve_device("cuda")
    _build.build_all()
    if args.doc:
        lines = doc_model(cs, args.seed)
        tr = Translate(cs.decoder_options(
            "doc_profile.npz", "--max-length", "2048",
            "--max-length-factor-translate", str(DOC_FACTOR)))
        tr.search.max_length_factor = 0.01            # a 20-step warm-up
        tr.run(lines, io.StringIO())
        tr.search.max_length_factor = DOC_FACTOR
        activities = [ProfilerActivity.CUDA]
    else:
        lines = cs.write_model(args.seed)[:cs.BATCH]
        tr = Translate(cs.decoder_options("base.npz"))
        tr.run(lines, io.StringIO())                  # warm-up batch
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(lines, io.StringIO())                      # untraced batch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=activities) as prof:
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
    what = (f"doc-level transformer-big, {len(lines)} documents of "
            f"{[len(l.split()) for l in lines]} words, cache {DOC_FACTOR} x "
            f"width" if args.doc else
            f"transformer-base, {len(lines)} sentences")
    print(f"batch: {what}, beam {cs.BEAM}, {steps} steps; "
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
