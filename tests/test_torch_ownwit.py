"""The port's ownership witness (``marian_tpu_torch/common/ownwit.py``)
and ``KVPool``'s hooks against the JAX package's on the CPU
(``tests/conftest.py`` arms ``MARIAN_OWNWIT=1`` for the process):

- one verb sequence (claim, claim_extra, share, retable, transfer,
  release, a retable to empty) on both packages' pools from this file
  gives the same pairings, live owners and ``check_balanced`` verdict;
  every site is ``<external>`` there;
- driven by the greedy engines instead, the acquire and release sites
  name the engines' own functions, the JAX package's path mapped onto
  the port's (``marian_tpu/`` → ``marian_tpu_torch/``);
- the ``pool.release_drop`` drill (the first release in a row exit does
  nothing) fails the engine's round audit with the leak in both, and
  the witness holds the leaked owner at the acquire site the JAX
  witness names; unarmed, a drained engine leaves nothing live;
- ``drop_container`` forgets a discarded pool's owners; tokens are
  unique.
"""

import pytest
import torch

from marian_tpu.common import faultpoints as jfp
from marian_tpu.common import ownwit as jow
from marian_tpu.ops.pallas.kv_pool import KVPool as JPool
from marian_tpu.ops.pallas.kv_pool import PoolCorruption as JCorruption
from marian_tpu.translator.iteration import PagedDecodeEngine as JEngine
from marian_tpu_torch.common import faultpoints as tfp
from marian_tpu_torch.common import ownwit as tow
from marian_tpu_torch.ops.kernels.kv_pool import KVPool, PoolCorruption
from marian_tpu_torch.translator.iteration import PagedDecodeEngine
from tests.test_torch_iteration import ENGINE, TEXTS, tiny  # noqa: F401

torch.set_num_threads(2)

CLS = "kv-pages"


@pytest.fixture(autouse=True)
def clean():
    assert tow.enabled() and jow.enabled()
    tow.reset()
    jow.reset()
    try:
        yield
    finally:
        tow.reset()
        jow.reset()
        tfp.reset_for_tests()
        jfp.reset_for_tests()


def verbs(pool):
    pool.claim("A", 2)
    pool.claim("B", 1)
    pool.claim_extra("A", 1)
    pool.share("C", pool.pages_of("A")[:2])
    pool.retable("C", pool.pages_of("A")[:1])
    pool.transfer("B", "D")
    pool.release("A")
    pool.retable("C", [])
    pool.claim("E", 1)
    return pool.audit()


def mapped(items):
    return [(o, [s.replace("marian_tpu/", "marian_tpu_torch/", 1)
                 for s in sites]) for o, sites in items]


def test_verb_sequence_gives_the_jax_witness_verdicts():
    assert verbs(KVPool(16, page_len=4)) == verbs(JPool(16, page_len=4)) \
        == []
    assert tow.live_owners(CLS) == jow.live_owners(CLS) == [
        ("'D'", ["<external>"]), ("'E'", ["<external>"])]
    assert tow.check_balanced(CLS) == jow.check_balanced(CLS)
    assert set(tow.observed_pairs(CLS)) == set(jow.observed_pairs(CLS)) \
        == {("<external>", "<external>")}
    assert tow.observed_sites(CLS) == jow.observed_sites(CLS)


def test_tokens_are_unique_and_drop_container_forgets_a_pool():
    a, b = KVPool(8, page_len=4), KVPool(8, page_len=4)
    assert a._ownwit_tok != b._ownwit_tok and a._ownwit_tok > 0
    a.claim("x", 1)
    b.claim("x", 1)
    assert len(tow.live_owners(CLS)) == 2
    tow.drop_container(CLS, a._ownwit_tok)
    assert tow.live_owners(CLS) == [("'x'", ["<external>"])]


def engines(tiny):
    jm, jp, tm, tp, jv, tv = tiny
    return (PagedDecodeEngine(tm, tp, tv, tv, max_rows=2, **ENGINE),
            JEngine(jm, jp, jv, jv, max_rows=2, **ENGINE))


def test_engine_sites_are_the_jax_sites_mapped(tiny):
    eng, jeng = engines(tiny)
    assert eng.decode_texts(TEXTS[:3]) == jeng.decode_texts(TEXTS[:3])
    acq, rel = tow.observed_sites(CLS)
    jacq, jrel = jow.observed_sites(CLS)
    assert acq == {s.replace("marian_tpu/", "marian_tpu_torch/", 1)
                   for s in jacq} \
        == {"marian_tpu_torch/translator/iteration.py::_claim_pages"}
    assert rel == {s.replace("marian_tpu/", "marian_tpu_torch/", 1)
                   for s in jrel} \
        == {"marian_tpu_torch/translator/iteration.py::_evict"}
    assert tow.check_balanced(CLS) == jow.check_balanced(CLS) == []


def test_release_drop_is_caught_by_the_witness_and_the_audit(tiny):
    eng, jeng = engines(tiny)
    with jfp.active("pool.release_drop=fail@1"):
        with pytest.raises(JCorruption, match="leaked") as je:
            jeng.decode_texts([TEXTS[0]])
    with tfp.active("pool.release_drop=fail@1"):
        with pytest.raises(PoolCorruption, match="leaked") as te:
            eng.decode_texts([TEXTS[0]])
    assert str(te.value) == str(je.value) == (
        "pool audit failed: pool claim for 0 has no active row (pages "
        "leaked at row exit)")
    assert mapped(tow.live_owners(CLS)) == mapped(jow.live_owners(CLS))
    leaks = tow.check_balanced(CLS)
    assert len(leaks) == 1 and "_claim_pages" in leaks[0]
    assert leaks[0].replace("marian_tpu_torch/", "marian_tpu/") == \
        jow.check_balanced(CLS)[0]
    # the pool is self-consistent (the claim is still held); the
    # engine's audit sees the claim without a row
    assert eng.pool.audit() == []
    assert any("has no active row" in v for v in eng.audit())


def test_unarmed_drill_point_leaves_nothing_live(tiny):
    eng, _ = engines(tiny)
    eng.decode_texts(TEXTS[:2])
    assert tow.check_balanced(CLS) == []
    assert tfp.hits("pool.release_drop") == 2
