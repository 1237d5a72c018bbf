"""The port's Corpus + BatchGenerator yield the same batches, ids and
masks, in the same order, as the JAX package's on the golden corpus
(tests/golden/data/) under the golden options
(tests/golden/test_golden.py :: COMMON), over two epochs: the epoch
permutation and the batch shuffle draw from numpy's RandomState with the
same seeds on both sides. A token-budget variant (--mini-batch-words,
target sort) exercises the canonical row counts. Exact equality.
"""

import pathlib

import numpy as np
import pytest

from marian_tpu.common import Options
from marian_tpu.data import BatchGenerator as JBatchGenerator
from marian_tpu.data import Corpus as JCorpus
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.batch_generator import BatchGenerator
from marian_tpu_torch.data.corpus import Corpus
from marian_tpu_torch.data.vocab import DefaultVocab

DATA = pathlib.Path(__file__).resolve().parent / "golden" / "data"
PATHS = [str(DATA / "train.src"), str(DATA / "train.trg")]
GOLDEN = {"mini-batch": 16, "maxi-batch": 4, "maxi-batch-sort": "src",
          "shuffle": "data", "seed": 1234, "max-length": 24}
BUDGET = {**GOLDEN, "mini-batch": 64, "mini-batch-words": 160,
          "maxi-batch-sort": "trg", "max-length": 12, "max-length-crop": True}


def _lines():
    return [l for p in PATHS for l in pathlib.Path(p).read_text().splitlines()]


def test_vocab_build_matches_jax():
    j, t = JVocab.build(_lines()), DefaultVocab.build(_lines())
    assert len(j) == len(t)
    for line in _lines()[:20]:
        assert j.encode(line) == t.encode(line)


@pytest.mark.parametrize("opts", [GOLDEN, BUDGET], ids=["golden", "budget"])
def test_batches_match_jax_over_two_epochs(opts):
    jv, tv = JVocab.build(_lines()), DefaultVocab.build(_lines())
    jc = JCorpus(PATHS, [jv, jv], Options(opts))
    tc = Corpus(PATHS, [tv, tv], TOptions(opts))
    n = 0
    for _ in range(2):
        jb = list(JBatchGenerator(jc, Options(opts), prefetch=False))
        tb = list(BatchGenerator(tc, TOptions(opts)))
        assert len(jb) == len(tb) > 1
        for a, b in zip(jb, tb):
            for s in range(2):
                assert np.array_equal(a.sub[s].ids, b.sub[s].ids)
                assert np.array_equal(a.sub[s].mask, b.sub[s].mask)
            assert np.array_equal(a.sentence_ids, b.sentence_ids)
            assert a.corpus_state == b.corpus_state
            n += 1
    assert tc.state.epoch == jc.state.epoch == 2
    assert n > 4
