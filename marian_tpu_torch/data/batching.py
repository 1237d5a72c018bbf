"""Translation input batching: the decode part of
``marian_tpu/data/corpus.py`` (TextInput) and
``marian_tpu/data/batch_generator.py`` (BatchGenerator), copied and
trimmed to one text stream.

Sentences are read ``--maxi-batch`` × ``--mini-batch`` at a time, sorted
by source length (``--maxi-batch-sort src``), and cut into batches of
``--mini-batch`` sentences or, under ``--mini-batch-words``, by the
reference's token budget (rows × bucketed width, ``over_budget``, the
rule the training batches and the serving scheduler share). Each batch
is padded to the reference's bucket table (rows to a multiple of 8,
width to a length bucket), so the port decodes the same real rows at
the same width, and hence the same decode cap, as the reference. Unlike
the reference, a decode batch under a budget keeps no canonical row
count: that count only saves XLA recompiles, and eager PyTorch would
spend it on fully masked rows. Output order is restored by the caller
from ``sentence_ids``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np

from .vocab import DefaultVocab

DEFAULT_LENGTH_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                          768, 1024, 1536, 2048, 3072, 4096)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


def bucket_batch_size(n: int, multiple: int = 8) -> int:
    """Snap sentence count up to a multiple (pad rows are fully masked)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def padded_batch_cost(n_rows: int, max_len: int) -> int:
    """Device cost (padded tokens) of a decode batch of ``n_rows``
    sentences whose longest has ``max_len`` tokens, under the bucket
    table."""
    return bucket_batch_size(n_rows) * bucket_length(max_len)


def over_budget(rows: int, longest: int, words_budget: int,
                length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS
                ) -> bool:
    """The reference's budget rule: ``rows`` unpadded rows x the bucketed
    width of the ``longest`` exceed ``words_budget`` padded tokens."""
    return rows * bucket_length(longest, length_buckets) > words_budget


T_ = TypeVar("T_")


def budget_groups(items: Sequence[T_], length: Callable[[T_], int],
                  rows_budget: int, words_budget: int,
                  length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS
                  ) -> List[List[T_]]:
    """The reference's batch cut (``_split_maxi``): consecutive ``items``
    fill a group while its rows x the bucketed width of its longest
    ``length`` stay within ``words_budget`` (under a budget), or while it
    holds at most ``rows_budget`` items (without one)."""
    groups: List[List[T_]] = []
    cur: List[T_] = []
    maxlen = 0
    for item in items:
        n_len = max(maxlen, length(item))
        n = len(cur) + 1
        if words_budget > 0:
            over = bool(cur) and over_budget(n, n_len, words_budget,
                                             length_buckets)
        else:
            over = n > rows_budget
        if over:
            groups.append(cur)
            cur = []
            n_len = length(item)
        cur.append(item)
        maxlen = n_len
    if cur:
        groups.append(cur)
    return groups


def budget_rows(width: int, words_budget: int,
                batch_multiple: int = 8) -> int:
    """The canonical row count of a training batch of bucketed ``width``
    under a budget: the rows a full batch of that width holds, rounded
    down to the batch multiple (0 without a budget: rows snap to the
    multiple alone)."""
    if words_budget <= 0:
        return 0
    return max(batch_multiple,
               (words_budget // width) // batch_multiple * batch_multiple)


@dataclasses.dataclass
class Batch:
    """One padded source batch (reference: CorpusBatch with one stream)."""
    ids: np.ndarray            # [rows, width] int32, EOS-terminated, 0-padded
    mask: np.ndarray           # [rows, width] float32; 1 on real tokens
    sentence_ids: np.ndarray   # [rows] input line numbers (-1 = pad row)

    @property
    def size(self) -> int:
        return int((self.sentence_ids >= 0).sum())


def encode_lines(lines: Sequence[str], vocab: DefaultVocab,
                 max_length: int) -> List[Tuple[int, List[int]]]:
    """(line number, EOS-terminated ids) per input line; over-long lines
    are cropped to ``max_length`` words + EOS, as the reference's
    TextInput does."""
    out = []
    for idx, line in enumerate(lines):
        ids = vocab.encode(line, add_eos=True)
        if len(ids) > max_length + 1:
            ids = ids[:max_length] + [vocab.eos_id]
        out.append((idx, ids))
    return out


def make_batch(sents: Sequence[Tuple[int, List[int]]],
               batch_multiple: int = 8) -> Batch:
    rows = bucket_batch_size(len(sents), batch_multiple)
    width = bucket_length(max(len(ids) for _, ids in sents))
    ids = np.zeros((rows, width), dtype=np.int32)
    mask = np.zeros((rows, width), dtype=np.float32)
    sent_ids = np.full((rows,), -1, dtype=np.int64)
    for r, (idx, seq) in enumerate(sents):
        ids[r, :len(seq)] = seq
        mask[r, :len(seq)] = 1.0
        sent_ids[r] = idx
    return Batch(ids, mask, sent_ids)


def batches(sents: Sequence[Tuple[int, List[int]]], mini_batch: int,
            maxi_batch: int, maxi_batch_sort: str = "src",
            mini_batch_words: int = 0) -> Iterator[Batch]:
    """Maxi-window sort + mini-batch split (reference:
    BatchGenerator::fetchBatches): ``mini_batch`` sentences a batch, or
    under ``mini_batch_words`` > 0 the token budget."""
    if maxi_batch_sort not in ("src", "none"):
        raise ValueError(f"--maxi-batch-sort {maxi_batch_sort}: "
                         f"src or none when translating")
    mini_batch, maxi_batch = max(1, mini_batch), max(1, maxi_batch)
    cap = mini_batch * maxi_batch
    for start in range(0, len(sents), cap):
        window = list(sents[start:start + cap])
        if maxi_batch_sort == "src":
            window.sort(key=lambda s: len(s[1]))
        for group in budget_groups(window, lambda s: len(s[1]), mini_batch,
                                   mini_batch_words):
            yield make_batch(group)
