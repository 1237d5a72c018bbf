"""Line-parallel training corpora with epoch shuffling and exact-resume
positions, copied from ``marian_tpu/data/corpus.py`` (reference
src/data/corpus.cpp) and trimmed to this slice: parallel text files
(optionally gzipped), or one tab-separated file under --tsv
(--tsv-fields pins its column count); the target reversed under
--right-left (EOS stays last); and the side streams of
--guided-alignment (one Pharaoh line a sentence) and --data-weighting.

Resume design, as in the reference: the iterator state (epoch, position
in epoch, shuffle seed) is checkpointed and fast-forwarded on restore;
the shuffle permutation is a function of (seed, epoch) drawn with numpy's
RandomState, so the port's epochs visit the sentences in the same order
as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .alignment import WordAlignment
from .vocab import DefaultVocab


@dataclasses.dataclass
class SentenceTuple:
    """One example: token-id sequences per stream (reference:
    src/data/corpus_base.h :: SentenceTuple)."""
    idx: int                      # corpus line number
    streams: List[List[int]]      # token ids per stream, EOS-terminated
    alignment: Optional[WordAlignment] = None
    weights: Optional[List[float]] = None

    @property
    def src(self) -> List[int]:
        return self.streams[0]

    @property
    def trg(self) -> List[int]:
        return self.streams[-1]


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


@dataclasses.dataclass
class CorpusState:
    """Serialized into training progress for exact resume."""
    epoch: int = 0
    position: int = 0   # sentences already yielded in this epoch
    seed: int = 1

    def as_dict(self):
        return {**dataclasses.asdict(self), "backend": "python"}

    @classmethod
    def from_dict(cls, d):
        if not d:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Corpus:
    """Reads N parallel text files, encodes them with the vocabs, and
    yields SentenceTuples; --max-length skips over-long sentences, or
    crops them with --max-length-crop."""

    def __init__(self, paths: Sequence[str], vocabs: Sequence[DefaultVocab],
                 options=None, state: Optional[CorpusState] = None):
        # --tsv: ONE tab-separated file carries every stream, column i
        # stream i; --tsv-fields pins the column count (default: one a
        # vocab)
        self.tsv = bool(options.get("tsv", False)) if options else False
        if self.tsv:
            if len(paths) != 1:
                raise ValueError(
                    f"--tsv expects ONE tab-separated train file, got "
                    f"{len(paths)}")
            n_fields = int(options.get("tsv-fields", 0) or 0) or len(vocabs)
            if n_fields != len(vocabs):
                raise ValueError(
                    f"--tsv-fields {n_fields} must match the number of "
                    f"--vocabs ({len(vocabs)})")
            paths = list(paths) * len(vocabs)
        assert len(paths) == len(vocabs), (paths, len(vocabs))
        self.paths = list(paths)
        self.vocabs = list(vocabs)
        self.max_length = int(options.get("max-length", 50)) if options \
            else 10**9
        self.max_length_crop = bool(options.get("max-length-crop", False)) \
            if options else False
        self.shuffle_mode = options.get("shuffle", "data") if options \
            else "none"
        # --right-left: the target stream is trained right to left
        self.right_left = bool(options.get("right-left", False)) if options \
            else False
        self.state = state or CorpusState(
            seed=int(options.get("seed", 1)) or 1 if options else 1)
        ga = options.get("guided-alignment", "none") if options else None
        self.align_path = (str(ga) if ga and ga != "none"
                           and os.path.exists(str(ga)) else None)
        self.weight_path = (str(options.get("data-weighting"))
                            if options is not None
                            and options.get("data-weighting", None) else None)
        self._lines_cache: Optional[List[List[str]]] = None
        self._aligns: Optional[List[str]] = None
        self._weights: Optional[List[str]] = None

    def _read_all(self) -> List[List[str]]:
        """The whole corpus in RAM (the reference's --shuffle-in-ram)."""
        if self._lines_cache is None:
            if self.tsv:
                with _open_maybe_gz(self.paths[0]) as fh:
                    rows = [l.rstrip("\n").split("\t") for l in fh]
                k = len(self.vocabs)
                for i, row in enumerate(rows):
                    if len(row) != k:
                        raise ValueError(
                            f"--tsv: line {i + 1} of {self.paths[0]} has "
                            f"{len(row)} fields, expected {k}")
                streams = [[row[j] for row in rows] for j in range(k)]
            else:
                streams = []
                for p in self.paths:
                    with _open_maybe_gz(p) as fh:
                        streams.append([l.rstrip("\n") for l in fh])
            n = len(streams[0])
            for p, s in zip(self.paths[1:], streams[1:]):
                if len(s) != n:
                    raise ValueError(
                        f"Corpus streams differ in length: {self.paths[0]} "
                        f"has {n}, {p} has {len(s)}")
            if self.align_path:
                with _open_maybe_gz(self.align_path) as fh:
                    self._aligns = [l.rstrip("\n") for l in fh]
                if len(self._aligns) != n:
                    raise ValueError("Alignment file length mismatch")
            if self.weight_path:
                with _open_maybe_gz(self.weight_path) as fh:
                    self._weights = [l.rstrip("\n") for l in fh]
                if len(self._weights) != n:
                    raise ValueError("Weight file length mismatch")
            self._lines_cache = streams
        return self._lines_cache

    def __len__(self) -> int:
        return len(self._read_all()[0])

    def _permutation(self, epoch: int) -> np.ndarray:
        n = len(self)
        if self.shuffle_mode != "data":
            return np.arange(n)
        rs = np.random.RandomState(
            (self.state.seed + 0x9E37 * (epoch + 1)) % (2**31))
        return rs.permutation(n)

    def _make_tuple(self, idx: int) -> Optional[SentenceTuple]:
        encoded: List[List[int]] = []
        last = len(self.vocabs) - 1
        for si, (lines, vocab) in enumerate(zip(self._read_all(),
                                                self.vocabs)):
            ids = vocab.encode(lines[idx], add_eos=True)
            # length filter counts EOS, as Marian does; a crop keeps EOS
            if len(ids) > self.max_length + 1:
                if not self.max_length_crop:
                    return None
                ids = ids[: self.max_length] + [vocab.eos_id]
            if self.right_left and si == last:
                ids = ids[-2::-1] + [ids[-1]]      # EOS stays last
            encoded.append(ids)
        align = None
        if self._aligns is not None:
            align = WordAlignment.parse(self._aligns[idx])
        weights = None
        if self._weights is not None:
            weights = [float(x) for x in self._weights[idx].split()]
        return SentenceTuple(idx, encoded, alignment=align, weights=weights)

    def __iter__(self) -> Iterator[SentenceTuple]:
        """The remainder of the current epoch from state.position; the
        state then moves to the next epoch."""
        perm = self._permutation(self.state.epoch)
        while self.state.position < len(perm):
            pos = self.state.position
            self.state.position += 1
            st = self._make_tuple(int(perm[pos]))
            if st is not None:
                yield st
        self.state.epoch += 1
        self.state.position = 0

    def restore(self, state_dict) -> None:
        self.state = CorpusState.from_dict(state_dict)
