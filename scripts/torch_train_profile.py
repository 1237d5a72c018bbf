#!/usr/bin/env python3
"""Where the time of one marian_tpu_torch training update goes, on the
card.

Builds a training setup chip_smoke.py drives: by default transformer-base
6+6, vocab 32,000, f32, dropout 0.1, 12,288 target words a batch on the
synthetic corpus from --seed; with --doc the doc-level one
(transformer-big 6+6 on documents of 1,023-2,047 words, 8,192 target
words a batch, every attention through flash). Runs two warm-up updates,
times --updates untraced updates, then traces as many with
torch.profiler and prints, per update: the wall time, the device's busy
time (sum of kernel times) and idle share over the wall time, the device
time by kernel class, and the kernels that took the most device time.
``--precision bfloat16`` trains in bf16 from f32 master weights
(chip_smoke.py's bf16 training main path); ``--delay N`` makes each
update of N micro-batches of 1/N the words (--optimizer-delay N, as
chip_smoke.py's delay path at N = 2). Run from the root of a checkout on
the machine with the card:

    python3 scripts/torch_train_profile.py [--seed 17] [--updates 3] [--doc]
        [--precision bfloat16] [--delay 2]
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# kernel class ← first matching pattern over the kernel's name
CLASSES = (
    ("flash_attention dkv (this port)", r"flash_(tc_)?dkv_kernel"),
    ("flash_attention dq (this port)", r"flash_(tc_)?dq_kernel"),
    ("flash_attention forward (this port)", r"flash_(tc_)?fwd_kernel"),
    ("packed_attention backward (this port)",
     r"packed_attention_bwd|packed_tc_bwd"),
    ("packed_attention forward (this port)",
     r"packed_attention_(fwd_|generic_)?kernel|packed_tc_fwd"),
    ("fused_ce backward d recompute (this port)", r"fce_(bwd|tc)_dlogit"),
    ("fused_ce backward dx product (this port)", r"fce_(bwd|tc)_dx"),
    ("fused_ce backward dw/db product (this port)", r"fce_(bwd|tc)_dw"),
    ("fused_ce backward slice and db sums (this port)",
     r"fce_bwd_sum|fce_tc_db"),
    ("fused_ce forward (this port)", r"fce_(tc_)?fwd"),
    ("GEMM (cuBLAS/CUTLASS)", r"gemm|sgemm|cutlass|cublas|nvjet"),
    ("reductions", r"reduce|Reduce|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
)


def classify(name: str) -> str:
    for label, pattern in CLASSES:
        if re.search(pattern, name):
            return label
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--updates", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--doc", action="store_true",
                    help="the doc-level transformer-big setup")
    ap.add_argument("--precision", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--delay", type=int, default=1,
                    help="micro-batches an update (--optimizer-delay)")
    args = ap.parse_args(argv)
    extra = ("--precision", args.precision, "float32")
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.data.batch_generator import BatchGenerator
    from marian_tpu_torch.data.corpus import Corpus
    from marian_tpu_torch.data.vocab import create_vocab
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.models import transformer as T
    from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                         create_model)
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.training.graph_group import GraphGroup
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device("cuda")
    _build.build_all()
    cs.write_vocab()
    words = cs.DOC_WORDS if args.doc else cs.TRAIN_WORDS
    extra += ("--optimizer-delay", str(args.delay), "--mini-batch-words",
              str(words // args.delay))
    if args.doc:
        name = "doc"
        cs.write_doc_train_corpus(args.seed)
        opts = parse_options(cs.doc_argv("profile.npz", 0, *extra),
                             mode="training")
    else:
        name = "train"
        cs.write_corpus(args.seed)
        opts = parse_options(cs.train_argv("profile.npz", 0, *extra),
                             mode="training")
    vocab = create_vocab(str(cs.WORK / "vocab.yml"))
    corpus = Corpus([str(cs.WORK / f"{name}.src"),
                     str(cs.WORK / f"{name}.trg")], [vocab, vocab], opts)
    n = (2 + 2 * args.updates) * args.delay
    micro = []
    for b in BatchGenerator(corpus, opts):
        micro.append(b)
        if len(micro) == n:
            break
    # one update's micro-batches each
    batches = [micro[i:i + args.delay] for i in range(0, n, args.delay)]
    model = create_model(opts, len(vocab), len(vocab))
    gg = GraphGroup(model, opts, dev)
    gg.initialize(T.init_params(model.cfg, 1111))
    gen = torch.Generator(device=dev)
    step = [0]

    def update(group):
        step[0] += 1
        return gg.update([batch_to_arrays(b, dev) for b in group], step[0],
                         gen, 1111)

    for b in batches[:2]:                              # warm-up
        update(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:2 + args.updates]:
        update(b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.updates
    traced_batches = batches[2 + args.updates:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in traced_batches:
            update(b)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / len(traced_batches)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / len(
        traced_batches)
    words = sum(b.words for g in traced_batches for b in g) / len(
        traced_batches)
    model_name = ("doc-level transformer-big" if args.doc
                  else "transformer-base")
    print(f"update: {model_name} 6+6 {args.precision}, {words:.0f} "
          f"target words in {args.delay} micro-batch(es); "
          f"wall {wall * 1e3:.1f} ms untraced, {traced * 1e3:.1f} ms traced; "
          f"device busy {busy:.1f} ms; idle share {1 - busy / 1e3 / wall:.3f} "
          f"of the untraced wall")
    by_class = {}
    for e in events:
        c = classify(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total
    for c, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / len(traced_batches)
        print(f"  class {ms:9.2f} ms/update {100 * ms / busy:5.1f}%  {c}")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:args.top]:
        ms = e.self_device_time_total / 1e3 / len(traced_batches)
        print(f"  {ms:9.2f} ms/update {100 * ms / busy:5.1f}% "
              f"x{e.count // len(traced_batches):<5d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
