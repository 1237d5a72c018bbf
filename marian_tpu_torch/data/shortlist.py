"""Lexical shortlists: restrict the output vocabulary per batch, copied
from ``marian_tpu/data/shortlist.py`` (reference src/data/shortlist.h ::
LexicalShortlistGenerator / Shortlist::indices).

Given a probability table lex.s2t (P(trg|src), text lines ``src trg
prob``, or the ``.npz`` layout ``save_binary`` writes: srcs/trgs/probs
arrays), the shortlist of a batch is the union of

- the ``first`` most frequent target words (EOS and UNK always in), and
- the ``best`` most probable translations of every source word present,
  optionally pruned by probability.

The union is sorted and padded with EOS to a multiple of ``k_multiple``
(128), so its width comes from a short closed set; decoding works in
shortlist coordinates and maps back through ``indices``. The padding
duplicates of EOS are live candidates, as in the reference: a top-k over
the coordinates can take them, and only the same index set gives the
same tokens.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common import logging as log
from .vocab import EOS_ID, UNK_ID


class Shortlist:
    """Per-batch target-vocab subset (reference: Shortlist)."""

    def __init__(self, indices: np.ndarray):
        # sorted unique target ids, EOS-padded to K (EOS_ID 0 is first)
        self.indices = indices.astype(np.int32)   # [K]

    def __len__(self) -> int:
        return len(self.indices)

    def reverse_map(self, shortlist_ids: np.ndarray) -> np.ndarray:
        """Map shortlist coordinates back to full-vocab ids."""
        return self.indices[shortlist_ids]


class LexicalShortlistGenerator:
    def __init__(self, path: str, src_vocab, trg_vocab, first: int = 100,
                 best: int = 100, prune: float = 0.0, k_multiple: int = 128,
                 max_k: int = 0):
        self.first = first
        self.best = best
        self.k_multiple = k_multiple
        self.max_k = max_k
        # src id -> [(prob, trg id)], cut to the `best` most probable
        table: Dict[int, List] = collections.defaultdict(list)
        if path.endswith(".npz"):
            self._load_binary(path, table, prune)
        else:
            self._load_text(path, src_vocab, trg_vocab, table, prune)
        self.table: Dict[int, np.ndarray] = {}
        # the probabilities too, so a text -> binary -> text round trip
        # prunes as the text did
        self.probs: Dict[int, np.ndarray] = {}
        for s, lst in table.items():
            lst.sort(reverse=True)
            top = lst[: self.best]
            self.table[s] = np.array([t for _, t in top], dtype=np.int32)
            self.probs[s] = np.array([p for p, _ in top], dtype=np.float32)
        log.info("Loaded lexical shortlist with {} source entries",
                 len(self.table))

    def _load_text(self, path, src_vocab, trg_vocab, table, prune):
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 3:
                    continue
                s_w, t_w, p = parts[0], parts[1], float(parts[2])
                if p < prune:
                    continue
                s, t = src_vocab[s_w], trg_vocab[t_w]
                if s != UNK_ID or s_w == "<unk>":
                    table[s].append((p, t))

    def _load_binary(self, path, table, prune):
        npz = np.load(path)
        for s, t, p in zip(npz["srcs"], npz["trgs"], npz["probs"]):
            if p >= prune:
                table[int(s)].append((float(p), int(t)))

    def save_binary(self, path: str) -> None:
        srcs, trgs, probs = [], [], []
        for s, arr in self.table.items():
            ps = self.probs[s]
            for rank, t in enumerate(arr):
                srcs.append(s)
                trgs.append(int(t))
                probs.append(float(ps[rank]))
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 srcs=np.array(srcs, np.int32), trgs=np.array(trgs, np.int32),
                 probs=np.array(probs, np.float32))

    def generate(self, src_ids: Sequence[int]) -> Shortlist:
        chosen = set(range(self.first))       # the `first` frequent ids
        chosen.add(EOS_ID)
        chosen.add(UNK_ID)
        for s in set(int(x) for x in src_ids):
            arr = self.table.get(s)
            if arr is not None:
                chosen.update(int(t) for t in arr)
        idx = np.array(sorted(chosen), dtype=np.int32)
        # EOS-pad to a multiple of k_multiple
        k = max(self.k_multiple,
                ((len(idx) + self.k_multiple - 1) // self.k_multiple)
                * self.k_multiple)
        if self.max_k:
            k = min(k, self.max_k)
            idx = idx[:k]
        out = np.full((k,), EOS_ID, dtype=np.int32)
        out[: len(idx)] = idx
        return Shortlist(out)


def parse_shortlist_options(vals: Sequence, src_vocab, trg_vocab
                            ) -> Optional[LexicalShortlistGenerator]:
    """--shortlist path [first] [best] [prune] (reference: translator.h)."""
    if not vals:
        return None
    path = str(vals[0])
    first = int(vals[1]) if len(vals) > 1 else 100
    best = int(vals[2]) if len(vals) > 2 else 100
    prune = float(vals[3]) if len(vals) > 3 else 0.0
    return LexicalShortlistGenerator(path, src_vocab, trg_vocab, first, best,
                                     prune)
