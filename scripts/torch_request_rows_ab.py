#!/usr/bin/env python3
"""Request-mode decode batches with their rows snapped to the multiple of
8 against rows pinned to one count per width, on the card.

The port's decoder pads a token-budget batch's rows to the multiple of 8
(``data/batching.batches``); the reference pins them to the rows a full
batch of that width holds (``budget_rows``), which saves XLA recompiles
and adds fully masked rows that the beam search still computes. This
script builds the request-mode translator chip_smoke.py serves
(transformer-base, the copying serve weights from --seed, beam 12, the
3,072-token budget of ``chip_smoke.request_options``) and times, in one
process, the same batches both ways in turns (snapped, pinned, pinned,
snapped):

- a lone request (one sentence of 10 words), then 8 sentences: what a
  quiet server sends;
- the batches the budget cuts from --sentences sentences of 8-40 words
  (sorted by length, as a burst of requests fills them).

For each it prints rows, decode steps, ms per batch (synchronized wall
time), ms per step, the pinned over snapped ratio, and how many real
rows got other tokens one way than the other.

Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_request_rows_ab.py [--seed 17]
        [--sentences 256] [--precision float32|bfloat16]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def pinned(ids: np.ndarray, mask: np.ndarray, rows: int):
    """``ids`` and ``mask`` with fully masked rows added up to ``rows``."""
    extra = max(0, rows - ids.shape[0])
    pad = ((0, extra), (0, 0))
    return np.pad(ids, pad), np.pad(mask, pad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--sentences", type=int, default=256)
    ap.add_argument("--precision", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_request_rows_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.data.batching import (batches, budget_rows,
                                                encode_lines)
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.server.server import ServingApp

    _build.build_all()
    cs.write_model(args.seed)
    extra = cs.BF16_FLAGS if args.precision == "bfloat16" else []
    app = ServingApp(cs.request_options(*extra))
    tr, budget = app.service.translator, app.scheduler.token_budget
    search = tr.search
    max_len = int(tr.options.get("max-length"))
    print(f"request-mode translator: {args.precision}, beam "
          f"{tr.options.get('beam-size')}, token budget {budget}")

    def cut(lines):
        sents = encode_lines(lines, tr.src_vocab, max_len)
        return list(batches(sents, len(sents), 1, "src", budget))

    lone = cs.serve_sentences(args.seed + 2, 8)
    lone = [" ".join(s.split()[:10]) for s in lone]
    cases = [("lone request (1 sentence of 10 words)", cut(lone[:1])),
             ("8 sentences of 10 words", cut(lone)),
             (f"{args.sentences} sentences of 8-40 words, budget batches",
              cut(cs.serve_sentences(args.seed, args.sentences)))]

    def timed(ids, mask):
        torch.cuda.synchronize()
        n = len(search.steps)
        t0 = time.perf_counter()
        out = search.search(ids, mask)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sum(search.steps[n:]), out

    def tokens(out, n):
        return [[h["tokens"] for h in out[r]] for r in range(n)]

    with torch.inference_mode():
        timed(*pinned(cases[0][1][0].ids, cases[0][1][0].mask, 8))
        for name, group in cases:
            snapped = [(b.ids, b.mask) for b in group]
            wide = [pinned(b.ids, b.mask, budget_rows(b.ids.shape[1],
                                                      budget))
                    for b in group]
            for b, (s, w) in enumerate(zip(snapped, wide)):
                timed(*s), timed(*w)                     # warm both shapes
                turns = {"snapped": [], "pinned": []}
                steps = {}
                outs = {}
                for way, batch in (("snapped", s), ("pinned", w),
                                   ("pinned", w), ("snapped", s)):
                    sec, st, out = timed(*batch)
                    turns[way].append(sec)
                    steps[way] = st
                    outs[way] = tokens(out, group[b].size)
                differ = sum(a != c for a, c in zip(outs["snapped"],
                                                    outs["pinned"]))
                ms = {k: 1e3 * min(v) for k, v in turns.items()}
                print(f"{name}, batch {b}: {group[b].size} sentences, "
                      f"width {s[0].shape[1]}; snapped {s[0].shape[0]} rows "
                      f"{ms['snapped']:.3f} ms ({steps['snapped']} steps, "
                      f"{ms['snapped'] / steps['snapped']:.3f} ms/step; "
                      f"turns {[round(1e3 * t, 3) for t in turns['snapped']]})"
                      f"; pinned {w[0].shape[0]} rows {ms['pinned']:.3f} ms "
                      f"({steps['pinned']} steps, "
                      f"{ms['pinned'] / steps['pinned']:.3f} ms/step; turns "
                      f"{[round(1e3 * t, 3) for t in turns['pinned']]}); "
                      f"pinned/snapped {ms['pinned'] / ms['snapped']:.3f}; "
                      f"{differ} sentences with other tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
