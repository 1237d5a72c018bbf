"""Word alignments for guided-alignment training, copied from
``marian_tpu/data/alignment.py`` (reference src/data/alignment.cpp ::
WordAlignment): Pharaoh '0-0 1-2 ...' lines (an optional third field is
the point's probability) and their dense [trg_len, src_len] matrix,
normalised per target word. The decoder's hard alignment from soft
attention comes with --alignment (ROADMAP A4b).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class WordAlignment:
    points: List[Tuple[int, int, float]]  # (src, trg, prob)

    @classmethod
    def parse(cls, line: str) -> "WordAlignment":
        pts = []
        for tok in line.split():
            parts = tok.split("-")
            if len(parts) < 2:
                continue
            s, t = int(parts[0]), int(parts[1])
            p = float(parts[2]) if len(parts) > 2 else 1.0
            pts.append((s, t, p))
        return cls(pts)

    def fill_dense(self, out: np.ndarray) -> None:
        """out: [trg_len, src_len]; normalised per target word like
        Marian's guided-alignment matrix."""
        for s, t, p in self.points:
            if t < out.shape[0] and s < out.shape[1]:
                out[t, s] = p
        sums = out.sum(axis=-1, keepdims=True)
        np.divide(out, sums, out=out, where=sums > 0)

    def __str__(self) -> str:
        return " ".join(f"{s}-{t}" for s, t, _ in self.points)
