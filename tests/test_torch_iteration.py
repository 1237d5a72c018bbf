"""marian_tpu_torch iteration-level decoding vs the JAX reference at the
reference's test size (``tests/test_iteration.py``: 2+2 layers, a 35-word
vocabulary, 4 slots, pages of 4 tokens, source cap 8, decode cap 12).

- The paged decode step (per-row positions, a page table, pools written
  in place) gives the JAX paged step's logits (rtol 1e-5, atol 2e-5: f32
  sums in another order) and pools;
- ``greedy_decode`` and ``greedy_decode_paged`` give the JAX tokens;
- ``PagedDecodeEngine.decode_texts`` gives the JAX engine's texts at 1,
  3 and 4 slots (joins mid-decode) and 1 or 3 steps a round;
- outputs do not depend on the join schedule, replays are identical,
  eviction frees pages, an idle engine holds no pages and audits clean,
  and unadmittable sentences get the JAX engine's reasons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.translator.greedy import greedy_decode as jgreedy
from marian_tpu.translator.greedy import greedy_decode_paged as jgreedy_paged
from marian_tpu.translator.iteration import PagedDecodeEngine as JEngine
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.translator.greedy import (greedy_decode,
                                                greedy_decode_paged)
from marian_tpu_torch.translator.iteration import (FATAL_REASONS,
                                                   PagedDecodeEngine)
from tests.test_torch_transformer import ATOL, RTOL, tiny_pair

torch.set_num_threads(2)

WORDS = [" ".join(f"w{i}" for i in range(35))]
TEXTS = ["w3 w4 w5", "w6 w7", "w8 w9 w10 w11", "w2 w3", "w4 w4 w4 w4 w4",
         "w12 w13", "w20 w21 w22 w23 w24 w25", "w30"]
ENGINE = dict(page_len=4, src_len_cap=8, max_length_cap=12)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model, port params, JAX vocab, port
    vocab); seed 4 decodes rows of 0 to 12 tokens, so rows leave at
    their own EOS and at the cap."""
    jm, jp, tm, tp, _ = tiny_pair(vocab=len(DefaultVocab.build(WORDS)),
                                  seed=4)
    return jm, jp, tm, tp, JVocab.build(WORDS), DefaultVocab.build(WORDS)


def engine(tiny, **kw):
    _, _, tm, tp, _, vocab = tiny
    return PagedDecodeEngine(tm, tp, vocab, vocab, **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def jax_texts(tiny):
    """The JAX engine's texts at 1, 3 and 4 slots."""
    jm, jp, _, _, jvocab, _ = tiny
    return {rows: JEngine(jm, jp, jvocab, jvocab, max_rows=rows,
                          **ENGINE).decode_texts(TEXTS)
            for rows in (1, 3, 4)}


def test_paged_decode_steps_match_jax(tiny):
    """Teacher-fed paged steps: three rows of different ages (one joins
    at the second step, one idles at the third), a permuted page table."""
    jm, jp, tm, tp, _, _ = tiny
    rng = np.random.RandomState(5)
    r, ts, page_len, mp = 3, 6, 4, 3
    n_pages = 1 + r * mp + 2
    ids = rng.randint(2, 35, size=(r, ts)).astype(np.int32)
    mask = np.ones((r, ts), np.float32)
    mask[1, 4:] = 0.0
    table = (rng.permutation(n_pages - 1)[:r * mp] + 1).reshape(
        r, mp).astype(np.int32)
    jenc = jm.encode_for_decode(jp, jnp.asarray(ids), jnp.asarray(mask))
    jst = jm.start_paged_state(jp, jenc, jnp.asarray(mask), n_pages,
                               page_len, mp)
    tids = torch.as_tensor(ids, dtype=torch.long)
    tmask = torch.as_tensor(mask)
    tst = tm.start_paged_state(tp, tm.encode_for_decode(tp, tids, tmask),
                               tmask, n_pages, page_len, mp)
    pos = np.array([0, -1, 5], np.int32)
    for step in range(6):
        prev = rng.randint(2, 35, size=(r, 1)).astype(np.int32)
        if step == 1:
            pos[1] = 0                    # row 1 joins
        if step == 3:
            pos[2] = -1                   # row 2 idles
        jst = dict(jst, pos=jnp.asarray(pos), page_table=jnp.asarray(table))
        jl, jst = jm.step(jp, jst, jnp.asarray(prev), jnp.asarray(mask))
        tst = dict(tst, pos=torch.from_numpy(pos),
                   page_table=torch.from_numpy(table))
        tl, tst = tm.step(tp, tst, torch.as_tensor(prev, dtype=torch.long),
                          tmask)
        live = pos >= 0
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)
        pos = np.where(live, pos + 1, -1).astype(np.int32)
    for k in ("l1_pool_k", "l2_pool_v"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=RTOL, atol=ATOL)


def test_greedy_decodes_match_jax(tiny):
    jm, jp, tm, tp, _, _ = tiny
    rng = np.random.RandomState(1234)
    b, ts = 5, 7
    ids = np.zeros((b, ts), np.int32)
    mask = np.zeros((b, ts), np.float32)
    for i, n in enumerate(rng.randint(3, ts + 1, size=b)):
        ids[i, :n] = rng.randint(3, 35, n)
        mask[i, :n] = 1.0
    want = np.asarray(jgreedy(jm, jp, jnp.asarray(ids), jnp.asarray(mask),
                              12))
    want_paged = jgreedy_paged(jm, jp, jnp.asarray(ids), jnp.asarray(mask),
                               12, page_len=4)
    tids = torch.as_tensor(ids, dtype=torch.long)
    tmask = torch.as_tensor(mask)
    got = greedy_decode(tm, tp, tids, tmask, 12)
    got_paged = greedy_decode_paged(tm, tp, tids, tmask, 12, page_len=4)
    assert np.array_equal(got, want)
    assert np.array_equal(got_paged, want_paged)
    n = got.shape[1]
    assert np.array_equal(got_paged[:, :n], got)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("rows", [1, 3, 4])
def test_engine_texts_match_jax(tiny, jax_texts, rows, steps):
    eng = engine(tiny, max_rows=rows, steps_per_round=steps)
    assert eng.decode_texts(TEXTS) == jax_texts[rows]
    if rows > 1:
        assert eng.counters["mid_decode_joins"] > 0
    assert eng.idle() and eng.pool.free_pages() == eng.pool.usable_pages
    assert eng.audit() == []


def test_outputs_independent_of_join_schedule(tiny, jax_texts):
    solo = [engine(tiny, max_rows=1).decode_texts([t])[0] for t in TEXTS]
    assert solo == jax_texts[4]
    lens = {len(t.split()) for t in solo}
    assert 0 in lens and ENGINE["max_length_cap"] in lens


def test_deterministic_replay(tiny):
    """The same join/evict schedule on a fresh engine gives the same
    outputs (idle rows write zeros to the trash page; pages recycle in a
    fixed order)."""
    def one_run():
        eng = engine(tiny, max_rows=2)
        sched = [[(0, TEXTS[0]), (1, TEXTS[1])], [], [(2, TEXTS[2])], [],
                 [(3, TEXTS[3])], [(4, TEXTS[4])]]
        outs, pending, i = {}, [], 0
        while i < len(sched) or pending or not eng.idle():
            joins = (sched[i] if i < len(sched) else []) + pending
            res = eng.admit_and_step(joins)
            pending = [(k, TEXTS[k]) for k, why in res.rejected]
            assert all(why not in FATAL_REASONS for _, why in res.rejected)
            outs.update(res.finished)
            i += 1
            assert i < 200
        return [outs[k] for k in sorted(outs)], eng.pool.stats()
    assert one_run() == one_run()


def test_eviction_frees_pages_and_idle_pool_is_empty(tiny):
    eng = engine(tiny, max_rows=2)
    eng.admit_and_step([(0, TEXTS[0]), (1, TEXTS[4])])
    used = eng.pool.used_pages()
    assert used > 0 and eng.active_rows() == 2
    eng.admit_and_step([], evicts=[0])
    assert eng.pool.used_pages() < used and eng.active_rows() == 1
    while not eng.idle():
        res = eng.admit_and_step([])
        assert all(k != 0 for k, _ in res.finished)
    assert eng.pool.free_pages() == eng.pool.usable_pages
    assert eng.pool.claims() == {} and eng.audit() == []


def test_pool_exhaustion_defers_the_join(tiny):
    """A pool of 3 pages holds one row of cap 12: the second sentence is
    deferred (no_pages) while the first decodes, then joins."""
    eng = engine(tiny, max_rows=2, pool_bytes=3 * eng_page_bytes(tiny))
    assert eng.pool.usable_pages == 3
    res = eng.admit_and_step([(0, TEXTS[0]), (1, TEXTS[2])])
    assert res.accepted == [0] and res.rejected == [(1, "no_pages")]
    joined = False
    for _ in range(40):
        res = eng.admit_and_step([] if joined else [(1, TEXTS[2])])
        joined = joined or 1 in res.accepted
        if joined and eng.idle():
            break
    assert joined and eng.idle()


def eng_page_bytes(tiny):
    return engine(tiny, max_rows=1).page_bytes


@pytest.mark.parametrize("case", ["src_too_long", "too_large"])
def test_fatal_reasons_match_jax(tiny, case):
    jm, jp, _, _, jvocab, _ = tiny
    kw = dict(ENGINE, max_rows=2)
    text = TEXTS[0]
    if case == "src_too_long":
        text = " ".join("w3" for _ in range(50))
    else:
        # one page in the whole pool; a cap of 12 needs 3
        kw["pool_bytes"] = eng_page_bytes(tiny)
    jres = JEngine(jm, jp, jvocab, jvocab, **kw).admit_and_step([(0, text)])
    tres = engine(tiny, **kw).admit_and_step([(0, text)])
    assert tres.rejected == jres.rejected == [(0, case)]
    assert tres.reject_detail[0] == jres.reject_detail[0]


@pytest.mark.parametrize("src_cap", [8, 24, 192])
def test_encode_widths_match_jax(tiny, src_cap):
    jm, jp, _, _, jvocab, _ = tiny
    kw = dict(ENGINE, max_rows=1, src_len_cap=src_cap)
    assert engine(tiny, **kw).encode_widths() == JEngine(
        jm, jp, jvocab, jvocab, **kw).encode_widths()
