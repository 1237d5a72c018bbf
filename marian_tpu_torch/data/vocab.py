"""Word-level vocabularies with Marian's conventions (reference
src/data/default_vocab.cpp :: DefaultVocab), copied from
``marian_tpu/data/vocab.py``:

- special tokens ``</s>`` = 0 (EOS) and ``<unk>`` = 1 (UNK);
- vocab files are YAML/JSON maps ``word: id`` (``.yml``/``.yaml``/``.json``)
  or plain text one-word-per-line (ids by line order after specials).

SentencePiece (``.spm``) and factored (``.fsv``) vocabularies are not
ported yet (ROADMAP); ``create_vocab`` refuses them.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, Iterable, List, Sequence

import yaml

DEFAULT_EOS_STR = "</s>"
DEFAULT_UNK_STR = "<unk>"
EOS_ID = 0
UNK_ID = 1

# the C loader when PyYAML has it: a 32k-word vocab loads in a fraction of
# the pure-Python time, with the same result
_SAFE_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
_SAFE_DUMPER = getattr(yaml, "CSafeDumper", yaml.SafeDumper)


class DefaultVocab:
    """Word-level vocab from YAML/JSON/text (reference: default_vocab.cpp)."""

    def __init__(self, word2id: Dict[str, int]):
        self._w2i = dict(word2id)
        self._i2w: Dict[int, str] = {i: w for w, i in self._w2i.items()}
        if self._w2i.get(DEFAULT_EOS_STR, EOS_ID) != EOS_ID or \
           self._w2i.get(DEFAULT_UNK_STR, UNK_ID) != UNK_ID:
            raise ValueError(f"Vocab must map {DEFAULT_EOS_STR}→{EOS_ID}, "
                             f"{DEFAULT_UNK_STR}→{UNK_ID}")
        self._w2i.setdefault(DEFAULT_EOS_STR, EOS_ID)
        self._w2i.setdefault(DEFAULT_UNK_STR, UNK_ID)
        self._i2w.setdefault(EOS_ID, DEFAULT_EOS_STR)
        self._i2w.setdefault(UNK_ID, DEFAULT_UNK_STR)
        self._size = max(self._i2w) + 1

    @classmethod
    def load(cls, path: str, max_size: int = 0) -> "DefaultVocab":
        if path.endswith((".yml", ".yaml")):
            with open(path, "r", encoding="utf-8") as fh:
                m = yaml.load(fh, Loader=_SAFE_LOADER)
        elif path.endswith(".json"):
            with open(path, "r", encoding="utf-8") as fh:
                m = json.load(fh)
        else:  # plain text, one word per line
            m = {}
            with open(path, "r", encoding="utf-8") as fh:
                next_id = 2
                for line in fh:
                    w = line.rstrip("\n")
                    if not w or w in (DEFAULT_EOS_STR, DEFAULT_UNK_STR):
                        continue
                    m[w] = next_id
                    next_id += 1
            m[DEFAULT_EOS_STR] = EOS_ID
            m[DEFAULT_UNK_STR] = UNK_ID
        if max_size:
            m = {w: i for w, i in m.items() if i < max_size}
        return cls(m)

    @classmethod
    def build(cls, lines: Iterable[str], max_size: int = 0) -> "DefaultVocab":
        """Frequency-sorted vocab from raw text (marian-vocab; ties by
        word), as the reference builds a missing training vocab."""
        counter: collections.Counter = collections.Counter()
        for line in lines:
            counter.update(line.split())
        words = [w for w, _ in sorted(counter.items(),
                                      key=lambda kv: (-kv[1], kv[0]))]
        if max_size:
            words = words[: max(0, max_size - 2)]
        m = {DEFAULT_EOS_STR: EOS_ID, DEFAULT_UNK_STR: UNK_ID}
        for j, w in enumerate(words):
            m[w] = j + 2
        return cls(m)

    def save(self, path: str) -> None:
        """A YAML map in id order, the file Marian writes."""
        with open(path, "w", encoding="utf-8") as fh:
            yaml.dump({w: i for i, w in sorted(self._i2w.items())}, fh,
                      Dumper=_SAFE_DUMPER, default_flow_style=False,
                      allow_unicode=True, sort_keys=False)

    def encode(self, line: str, add_eos: bool = True) -> List[int]:
        ids = [self._w2i.get(w, UNK_ID) for w in line.split()]
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: Sequence[int], ignore_eos: bool = True) -> str:
        return " ".join(self.surface(ids, ignore_eos))

    def surface(self, ids: Sequence[int], ignore_eos: bool = True) -> List[str]:
        return [self._i2w.get(int(i), DEFAULT_UNK_STR) for i in ids
                if not (ignore_eos and i == EOS_ID)]

    def __len__(self) -> int:
        return self._size

    def __getitem__(self, word: str) -> int:
        return self._w2i.get(word, UNK_ID)

    @property
    def eos_id(self) -> int:
        return EOS_ID


def create_vocab(path: str, max_size: int = 0) -> DefaultVocab:
    """Vocab factory (reference: Vocab::create), dispatching on extension."""
    if path.endswith((".spm", ".fsv")):
        raise NotImplementedError(
            f"{path}: SentencePiece and factored vocabularies are not ported "
            f"yet (ROADMAP, beam-search extras); use a .yml/.json/.txt vocab")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Vocabulary file {path} not found")
    return DefaultVocab.load(path, max_size=max_size)
