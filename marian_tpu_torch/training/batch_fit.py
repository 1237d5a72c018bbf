"""Automated batch fitting (--mini-batch-fit), a copy of
``marian_tpu/training/batch_fit.py``: find the largest
--mini-batch-words token budget whose worst-case bucketed batch trains
without exhausting the card's memory.

Reference: src/training/graph_group.h :: GraphGroup::collectStats, which
binary-searches the sentences a length bin may hold within --workspace.
As in the JAX package the search runs over one number, the token budget
(``data/batch_generator.py`` turns it into row counts a width), by
running a real update through ``GraphGroup.update`` on a worst-case
synthetic batch: grow by doubling until a probe runs out of memory, then
bisect, with the same probe sequence as the reference.

Only the allocator's ``torch.OutOfMemoryError`` counts as "does not
fit"; any other error (a kernel wrapper's ValueError, a launch failure)
propagates. After an out-of-memory probe the exception and its frames,
which hold the autograd graph, are dropped before the next probe, and
the cached blocks are returned to the card. The parameters and the
optimizer state are restored from a host snapshot before every probe but
the first and after the last: an update that runs out of memory inside
the in-place optimizer step leaves them half updated.
"""

from __future__ import annotations

import gc
from typing import Optional

import numpy as np
import torch

from ..common import logging as log

_WORDS_MIN = 256
_WORDS_CAP = 131072


def probe_rows(words: int, max_len: int) -> int:
    """Rows of the worst-case probe batch at a budget: every sentence at
    full --max-length, rounded down to a multiple of 8 (at least 8), as
    the batch generator rounds a budget's rows."""
    return max(8, (words // max_len) // 8 * 8)


def _try_budget(gg, words: int, max_len: int, vocab: int) -> bool:
    """One throwaway update through the real ``GraphGroup.update`` (the
    delay path too: its peak memory differs, and the fit must hold for
    the one training runs) on the worst-case batch. False when the card
    ran out of memory."""
    rows = probe_rows(words, max_len)
    r = np.random.RandomState(0)
    dev = gg.device

    def ids():
        return torch.from_numpy(
            r.randint(2, vocab, (rows, max_len)).astype(np.int64)).to(dev)
    batch = {"src_ids": ids(),
             "src_mask": torch.ones((rows, max_len), device=dev),
             "trg_ids": ids(),
             "trg_mask": torch.ones((rows, max_len), device=dev)}
    fits = True
    try:
        gg.update([dict(batch)] * gg.delay, 1,
                  torch.Generator(device=dev), 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    except torch.OutOfMemoryError:
        fits = False
    del batch
    if not fits:
        # the exception left with the except clause; its frames held the
        # graph of the update that did not fit
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return fits


def fit_mini_batch_words(gg, opts, vocab_size: int,
                         cap: Optional[int] = None) -> int:
    """Grow-then-bisect the token budget; called once at startup under
    --mini-batch-fit. The result feeds the batch generator as
    mini-batch-words."""
    max_len = int(opts.get("max-length", 50))
    start = int(opts.get("mini-batch-words", 0) or 0) or 2048
    cap = cap or _WORDS_CAP
    # copies: on the CPU a tensor's numpy view shares its memory, and
    # the probes update the live tensors in place
    saved_params = {k: p.detach().cpu().clone() for k, p in gg.params.items()}
    saved_opt = {k: np.array(v, copy=True)
                 for k, v in gg.optimizer_arrays().items()}

    def _restore():
        gg.params = None
        gg.load_optimizer_arrays({k: v.copy() for k, v in saved_opt.items()})
        gg.initialize(saved_params)

    lo, hi = 0, None
    words = max(_WORDS_MIN, min(start, cap))
    first = True
    while True:
        if not first:
            _restore()
        first = False
        ok = _try_budget(gg, words, max_len, vocab_size)
        log.info("mini-batch-fit probe: {} words → {}", words,
                 "fits" if ok else "OOM")
        if ok:
            lo = words
            if words >= cap:
                break
            if hi is None:
                words = min(words * 2, cap)
            else:
                if hi - lo <= max(256, lo // 8):
                    break
                words = (lo + hi) // 2
        else:
            hi = words
            if lo == 0:
                words = words // 2
                if words < _WORDS_MIN:
                    raise RuntimeError(
                        "mini-batch-fit: even the minimum batch does not "
                        "fit device memory — reduce --max-length or model "
                        "size")
            else:
                if hi - lo <= max(256, lo // 8):
                    break
                words = (lo + hi) // 2
    _restore()
    log.info("mini-batch-fit: using mini-batch-words={} (max-length {})",
             lo, max_len)
    return lo
