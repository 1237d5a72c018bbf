"""Pretrained embedding import for --embedding-vectors, copied from
``marian_tpu/layers/embedding_io.py`` (reference src/layers/embedding.cpp
:: Embedding loading embFile): word2vec-format text vectors into a
vocabulary's table, and --embedding-normalization. The ULR tables'
vocabulary-free reader comes with ULR (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import logging as log


def load_word2vec(path: str, vocab, dim: int,
                  init: Optional[np.ndarray] = None) -> np.ndarray:
    """Read word2vec TEXT format ('n dim' header optional; then
    'word v1 v2 ...' lines) into a [len(vocab), dim] table. Words missing
    from the file keep their ``init`` rows (or zeros)."""
    table = (np.array(init, np.float32) if init is not None
             else np.zeros((len(vocab), dim), np.float32))
    found = 0
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        first = fh.readline().split()
        rows = []
        if len(first) == 2 and all(t.lstrip("-").isdigit() for t in first):
            pass                                       # header line
        elif first:
            rows.append(first)
        for line in fh:
            parts = line.rstrip("\n").split(" ")
            if len(parts) > 2:
                rows.append(parts)
        for parts in rows:
            word = parts[0]
            vec = parts[1:]
            if len(vec) != dim:
                raise ValueError(
                    f"{path}: vector for '{word}' has {len(vec)} dims, "
                    f"expected {dim}")
            wid = vocab[word]
            if wid == 1 and word != "<unk>":           # UNK = not in vocab
                continue
            table[wid] = np.asarray(vec, np.float32)
            found += 1
    log.info("Loaded {} pretrained vectors from {} ({} vocab rows)",
             found, path, len(table))
    return table


def normalize_rows(table: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """--embedding-normalization: unit-L2 rows."""
    norm = np.linalg.norm(table, axis=-1, keepdims=True)
    return table / np.maximum(norm, eps)
