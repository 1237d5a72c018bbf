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
kernels that took the most device time, and the kernel launches a
step; with --counts every kernel, by launches a step.
``--precision bfloat16`` decodes in bf16 (chip_smoke.py's bf16 decode
main path). ``--untraced N`` times N untraced batches and traces none.
``--ab DIR --pairs N`` times the base decode of another checkout (DIR,
for example the parent commit unpacked with ``git archive``) and of this
one in alternating processes, parent then change, change then parent,
N pairs, each process --untraced 3 with its own checkout's package, and
prints every process's ms a step and each side's median. Run from the
root of a checkout on the machine with the card:

    python3 scripts/torch_decode_profile.py [--seed 17] [--top 15] [--doc]
        [--precision bfloat16] [--counts] [--untraced N]
        [--ab DIR --pairs 10]
"""

from __future__ import annotations

import argparse
import io
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
DOC_FACTOR = 0.5
UNTRACED_RE = re.compile(r"untraced batch \d+: ([\d.]+) ms/step")


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
    ap.add_argument("--precision", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--counts", action="store_true",
                    help="list every kernel by launches a step")
    ap.add_argument("--untraced", type=int, default=0, metavar="N",
                    help="time N untraced batches, trace none")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose package decodes")
    ap.add_argument("--ab", type=Path, default=None, metavar="DIR",
                    help="another checkout to time against this one")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    extra = ("--precision", args.precision)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.ab is not None:
        return alternate(args)
    sys.path.insert(0, str(args.root.resolve()))
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
            "--max-length-factor-translate", str(DOC_FACTOR), *extra))
        tr.search.max_length_factor = 0.01            # a 20-step warm-up
        tr.run(lines, io.StringIO())
        tr.search.max_length_factor = DOC_FACTOR
        activities = [ProfilerActivity.CUDA]
    else:
        lines = cs.write_model(args.seed)[:cs.BATCH]
        tr = Translate(cs.decoder_options("base.npz", *extra))
        tr.run(lines, io.StringIO())                  # warm-up batch
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.untraced:
        for i in range(args.untraced):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run(lines, io.StringIO())
            torch.cuda.synchronize()
            steps = tr.search.steps[-1]
            print(f"untraced batch {i}: "
                  f"{(time.perf_counter() - t0) * 1e3 / steps:.3f} ms/step "
                  f"({args.precision}, {steps} steps)")
        return 0
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
    launches = sum(e.count for e in events)
    what = (f"doc-level transformer-big, {len(lines)} documents of "
            f"{[len(l.split()) for l in lines]} words, cache {DOC_FACTOR} x "
            f"width" if args.doc else
            f"transformer-base, {len(lines)} sentences")
    print(f"batch: {what}, {args.precision}, beam {cs.BEAM}, {steps} steps; "
          f"wall {wall * 1e3:.1f} ms untraced ({wall * 1e3 / steps:.3f} "
          f"ms/step), {traced * 1e3:.1f} ms traced")
    print(f"device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e3 / steps:.3f} "
          f"ms/step; idle share {1 - busy_us / 1e6 / wall:.3f} of the "
          f"untraced wall; {launches / steps:.1f} kernel launches a step")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}")
    if args.counts:
        events.sort(key=lambda e: (-e.count, e.key))
        for e in events:
            print(f"  count {e.count / steps:7.2f}/step "
                  f"{e.self_device_time_total / 1e3:9.2f} ms {e.key[:150]}")
    return 0


def alternate(args) -> int:
    """--ab: this script with --untraced 3 in DIR's package and in this
    checkout's, processes in the order parent, change, change, parent,
    ... (args.pairs pairs); prints each process's median ms a step, and
    each side's median over the processes."""
    sides = {"parent": args.ab.resolve(), "change": ROOT}
    order = [("parent", "change"), ("change", "parent")]
    got = {"parent": [], "change": []}
    for i in range(args.pairs):
        for tag in order[i % 2]:
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--root",
                 str(sides[tag]), "--untraced", "3", "--seed",
                 str(args.seed)], cwd=sides[tag], capture_output=True,
                text=True)
            ms = [float(m) for m in UNTRACED_RE.findall(run.stdout)]
            if run.returncode != 0 or len(ms) != 3:
                raise RuntimeError(f"[{tag}] failed:\n{run.stdout[-3000:]}"
                                   f"{run.stderr[-3000:]}")
            got[tag].append(statistics.median(ms))
            print(f"pair {i} [{tag}]: ms/step {' '.join(f'{m:.3f}' for m in ms)}"
                  f" (median {got[tag][-1]:.3f})")
    slower = sum(c > p for p, c in zip(got["parent"], got["change"]))
    print(f"ab: parent median {statistics.median(got['parent']):.3f} ms/step,"
          f" change {statistics.median(got['change']):.3f}; the change slower "
          f"in {slower} of {args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
