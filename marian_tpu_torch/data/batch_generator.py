"""Token-budget training batches, copied from
``marian_tpu/data/batch_generator.py`` (reference
src/data/batch_generator.h :: BatchGenerator::fetchBatches) and trimmed
to this slice:

- prefetch ``--maxi-batch`` x ``--mini-batch`` sentences, sort them by
  target (or source) length, fill minibatches by sentence count
  (``--mini-batch``) or padded token budget (``--mini-batch-words``), then
  shuffle the minibatch order with numpy's RandomState seeded from
  --seed, as the reference does, so both packages cut the same batches;
- pad every batch to the reference's bucket table: widths snap to a
  length bucket, rows to a multiple of 8, and under a token budget to
  one canonical row count per width. The port keeps the table so its
  batches are the reference's batches, and so the CUDA kernels see few
  distinct shapes;
- under --mini-batch-warmup, scale both budgets by ``budget_scale()``
  (in (0, 1]), read once a maxi window, as the reference does.

It runs without the reference's prefetch thread. Every batch crosses
the ``data.batch.next`` fault point before it is yielded, as in the
reference. Batch layout is batch-major [batch, time].
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..common import faultpoints as fp
from .batching import (DEFAULT_LENGTH_BUCKETS, bucket_batch_size,
                       bucket_length, budget_groups, budget_rows)
from .corpus import Corpus, SentenceTuple


@dataclasses.dataclass
class SubBatch:
    """One stream of a batch (reference: SubBatch: indices + mask)."""
    ids: np.ndarray    # [batch, time] int32, EOS-terminated, 0-padded
    mask: np.ndarray   # [batch, time] float32; 1 on real tokens (incl. EOS)

    @property
    def batch_words(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class CorpusBatch:
    """A training batch across streams (reference: CorpusBatch)."""
    sub: List[SubBatch]               # [src, trg]
    sentence_ids: np.ndarray          # [batch] corpus line numbers (-1 = pad)
    # --guided-alignment: [batch, trg_len, src_len], rows normalised
    guided_alignment: Optional[np.ndarray] = None
    data_weights: Optional[np.ndarray] = None   # [batch, trg_len] or [batch, 1]
    corpus_state: Optional[dict] = None   # resume point once this batch's
    # whole maxi window has been applied

    @property
    def src(self) -> SubBatch:
        return self.sub[0]

    @property
    def trg(self) -> SubBatch:
        return self.sub[-1]

    @property
    def size(self) -> int:
        return int((self.sentence_ids >= 0).sum())

    @property
    def words(self) -> int:
        """Real target labels."""
        return self.trg.batch_words

    @property
    def src_words(self) -> int:
        return self.src.batch_words


def make_batch(tuples: Sequence[SentenceTuple], n_streams: int,
               length_buckets=DEFAULT_LENGTH_BUCKETS,
               batch_multiple: int = 8,
               corpus_state: Optional[dict] = None,
               weighting_type: Optional[str] = None,
               fixed_rows: int = 0) -> CorpusBatch:
    """Pad SentenceTuples into one bucketed CorpusBatch; ``fixed_rows`` >
    0 pins the row count (extra rows fully masked)."""
    n = len(tuples)
    bsz = max(fixed_rows, bucket_batch_size(n, batch_multiple))
    subs: List[SubBatch] = []
    for s in range(n_streams):
        width = bucket_length(max(len(t.streams[s]) for t in tuples),
                              length_buckets)
        ids = np.zeros((bsz, width), dtype=np.int32)
        mask = np.zeros((bsz, width), dtype=np.float32)
        for b, t in enumerate(tuples):
            seq = t.streams[s]
            ids[b, : len(seq)] = seq
            mask[b, : len(seq)] = 1.0
        subs.append(SubBatch(ids, mask))
    sent_ids = np.full((bsz,), -1, dtype=np.int64)
    for b, t in enumerate(tuples):
        sent_ids[b] = t.idx

    guided = None
    if any(t.alignment is not None for t in tuples):
        tw, sw = subs[-1].ids.shape[1], subs[0].ids.shape[1]
        guided = np.zeros((bsz, tw, sw), dtype=np.float32)
        for b, t in enumerate(tuples):
            if t.alignment is not None:
                t.alignment.fill_dense(guided[b])

    weights = None
    if any(t.weights is not None for t in tuples):
        tw = subs[-1].ids.shape[1]
        if weighting_type in ("word", "sentence"):
            word_level = weighting_type == "word"
        else:
            word_level = any(t.weights is not None and len(t.weights) > 1
                             for t in tuples)
        if word_level:
            weights = np.ones((bsz, tw), dtype=np.float32)
            for b, t in enumerate(tuples):
                if t.weights is not None:
                    w = t.weights[:tw]
                    weights[b, : len(w)] = w
        else:
            weights = np.ones((bsz, 1), dtype=np.float32)
            for b, t in enumerate(tuples):
                if t.weights is not None:
                    weights[b, 0] = t.weights[0]
    return CorpusBatch(subs, sent_ids, guided, weights, corpus_state)


class BatchGenerator:
    """Iterator of one epoch's CorpusBatches with maxi-batch sorting."""

    def __init__(self, corpus: Corpus, options=None,
                 mini_batch: int = 64, mini_batch_words: int = 0,
                 maxi_batch: int = 100, maxi_batch_sort: str = "trg",
                 shuffle_batches: Optional[bool] = None,
                 batch_multiple: int = 8,
                 length_buckets=DEFAULT_LENGTH_BUCKETS, seed: int = 1,
                 budget_scale=None):
        self.corpus = corpus
        if options is not None:
            mini_batch = int(options.get("mini-batch", mini_batch)
                             or mini_batch)
            mini_batch_words = int(options.get("mini-batch-words",
                                               mini_batch_words) or 0)
            maxi_batch = int(options.get("maxi-batch", maxi_batch) or 1)
            maxi_batch_sort = options.get("maxi-batch-sort", maxi_batch_sort)
            seed = int(options.get("seed", seed)) or seed
            if shuffle_batches is None:
                shuffle_batches = options.get("shuffle", "data") in (
                    "data", "batches")
        self.weighting_type = (str(options.get("data-weighting-type",
                                               "sentence"))
                               if options is not None
                               and options.get("data-weighting", None)
                               else None)
        self.mini_batch = max(1, mini_batch)
        self.mini_batch_words = mini_batch_words
        self.maxi_batch = max(1, maxi_batch)
        self.sort_key = maxi_batch_sort
        self.shuffle_batches = bool(shuffle_batches)
        self.batch_multiple = batch_multiple
        self.length_buckets = length_buckets
        # --mini-batch-warmup: a callable returning a scale in (0, 1] that
        # shrinks the batch early in training (read once a maxi window)
        self.budget_scale = budget_scale
        self._rs = np.random.RandomState(seed % (2**31))
        self.n_streams = len(corpus.vocabs)

    def _split_maxi(self, buf: List[SentenceTuple],
                    state: dict) -> List[CorpusBatch]:
        if not buf:
            return []
        if self.sort_key == "trg":
            buf = sorted(buf, key=lambda t: (len(t.trg), len(t.src)))
        elif self.sort_key == "src":
            buf = sorted(buf, key=lambda t: (len(t.src), len(t.trg)))
        scale = 1.0
        if self.budget_scale is not None:
            scale = max(min(float(self.budget_scale()), 1.0), 1e-3)
        words_budget = max(int(self.mini_batch_words * scale), 1) \
            if self.mini_batch_words > 0 else 0
        rows_budget = max(int(self.mini_batch * scale), 1)
        batches: List[CorpusBatch] = []
        # the budget counts the padded target size (Marian counts labels);
        # one canonical row count per width under it
        for group in budget_groups(buf, lambda t: len(t.trg), rows_budget,
                                   words_budget, self.length_buckets):
            width = bucket_length(max(len(t.trg) for t in group),
                                  self.length_buckets)
            batches.append(make_batch(
                group, self.n_streams, self.length_buckets,
                self.batch_multiple, corpus_state=state,
                weighting_type=self.weighting_type,
                fixed_rows=budget_rows(width, words_budget,
                                       self.batch_multiple)))
        if self.shuffle_batches:
            self._rs.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[CorpusBatch]:
        buf: List[SentenceTuple] = []
        cap = self.maxi_batch * self.mini_batch
        for t in self.corpus:
            buf.append(t)
            if len(buf) >= cap:
                # the corpus position once this whole window is consumed:
                # a save after its batches are applied resumes here
                for b in self._split_maxi(buf, self.corpus.state.as_dict()):
                    # a pipeline failure (bad shard, file system hiccup)
                    # surfaces here, mid-epoch: crash-resume covers it
                    fp.fault_point("data.batch.next")
                    yield b
                buf = []
        for b in self._split_maxi(buf, self.corpus.state.as_dict()):
            fp.fault_point("data.batch.next")
            yield b
