"""marian_tpu_torch's fused on-device beam merge and multi-step beam
rounds (``translator/beam_iteration.py``, ``merge="fused"``) against the
JAX reference on the CPU, at ``tests/test_torch_beam_iteration.py``'s
size (2+2 layers, dim 32, a 35-word vocabulary, beam 3, pages of 4
tokens, decode caps 8-12, so sentences freeze mid-round).

- ``fused_merge`` equals the JAX ``fused_merge`` bit for bit (values,
  lanes, coordinates) on random grids with frozen rows, on an all-ties
  grid and on signed zeros, at eos_flat 0 (= EOS_ID) and 4;
  ``beam_table_reorder`` equals the JAX one;
- the fused engine at 1 and 3 steps a round gives the JAX fused
  engine's texts, tokens and lengths, raw scores within 1e-5, and the
  port's host-merge engine's; its unsized pool has the JAX engine's
  preclaim headroom;
- a pool too tight for the rounds' worst-case preclaim (but not for the
  real demand) sends rounds to the host-merge fallback with the same
  output; a truncated retable diff fails the round's audit;
- the option surface: a bad merge value, the host merge's single step,
  the server's refusal of the host merge with multi-step rounds, row
  buckets in whole sentences;
- every drive ends with an empty pool and a clean audit (the conftest
  audits every round, ``MARIAN_POOL_AUDIT=1``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.kv_pool import \
    beam_table_reorder as jbeam_table_reorder
from marian_tpu.translator.beam_iteration import PagedBeamEngine as JBeam
from marian_tpu.translator.beam_iteration import fused_merge as jfused_merge
from marian_tpu_torch.data.vocab import EOS_ID
from marian_tpu_torch.ops.kernels.kv_pool import (PoolCorruption,
                                                  beam_table_reorder)
from marian_tpu_torch.translator.beam_iteration import (NEG_INF,
                                                        PagedBeamEngine,
                                                        fused_merge)
from tests.test_torch_beam_iteration import (  # noqa: F401 (tiny: fixture)
    ENGINE, K, TEXTS, assert_clean, assert_same, drive, tiny)

torch.set_num_threads(2)


def grid(case: str, seed: int = 0):
    """(lp [nb*k, W], score [nb*k], fin [nb*k], k) of one merge case."""
    rng = np.random.RandomState(seed)
    if case == "ties":
        # NEG_INF saturates f32, repeated finite values tie across rows
        # and coordinates
        k, width, nb = 3, 7, 2
        lp = rng.choice([-1.0, -2.0, NEG_INF], size=(nb * k, width))
        score = rng.choice([0.0, -1.0], size=(nb * k,))
        fin = np.zeros((nb * k,), bool)
        fin[1] = True
    elif case == "zeros":
        k, width, nb = 3, 5, 2
        lp = rng.choice([0.0, -0.0, -1.0], size=(nb * k, width))
        score = rng.choice([0.0, -0.0], size=(nb * k,))
        fin = np.zeros((nb * k,), bool)
        fin[4] = True
    else:
        k, width, nb = 4, 35, 3
        logits = rng.randn(nb * k, width) * 3.0
        lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        score = rng.randn(nb * k) * 4.0
        score[1::k] = NEG_INF           # t = 0 rows of a fresh sentence
        fin = rng.rand(nb * k) < 0.3
    return (np.asarray(lp, np.float32), np.asarray(score, np.float32),
            fin, k)


@pytest.mark.parametrize("eos_flat", sorted({0, EOS_ID, 4}))
@pytest.mark.parametrize("case", ["random0", "random1", "random2", "ties",
                                  "zeros"])
def test_fused_merge_matches_jax_bitwise(case, eos_flat):
    lp, score, fin, k = grid(case, seed=int(case[-1]) if case[-1].isdigit()
                             else 5)
    want = jfused_merge(jnp.asarray(lp), jnp.asarray(score),
                        jnp.asarray(fin), k, eos_flat)
    got = fused_merge(torch.from_numpy(lp), torch.from_numpy(score),
                      torch.from_numpy(fin), k, eos_flat)
    vals, lanes, coords = (np.asarray(w) for w in want)
    assert np.array_equal(got[0].numpy().view(np.int32),
                          vals.view(np.int32))
    assert np.array_equal(got[1].numpy(), lanes)
    assert np.array_equal(got[2].numpy(), coords)


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_table_reorder_matches_jax(seed):
    rng = np.random.RandomState(seed)
    rows, mp = 9, 5
    table = rng.randint(0, 40, (rows, mp)).astype(np.int32)
    parent = rng.randint(0, rows, rows).astype(np.int32)
    # a write slot past the table repoints nothing, in both
    write = rng.randint(0, mp + 1, rows).astype(np.int32)
    fresh = rng.randint(40, 60, rows).astype(np.int32)
    needs = rng.rand(rows) < 0.5
    frozen = rng.rand(rows) < 0.3
    want = jbeam_table_reorder(*(jnp.asarray(a) for a in (
        table, parent, write, fresh, needs, frozen)))
    got = beam_table_reorder(*(torch.from_numpy(a) for a in (
        table, parent, write, fresh, needs, frozen)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def fused_engines(tiny, steps, **kw):
    """(the port's fused engine, the JAX fused engine) at ENGINE + kw."""
    jm, jp, tm, tp, jv, tv = tiny
    args = {**ENGINE, "max_rows": 2 * K, "steps_per_round": steps, **kw}
    return (PagedBeamEngine(tm, tp, tv, tv, **args),
            JBeam(jm, jp, jv, jv, merge="fused", **args))


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    ``ServingApp`` built from ``parse_options`` enables the port's perf
    plane (the parser defaults --perf-accounting on), which would change
    what later tests in the process see; disable it again after every
    test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()


@pytest.fixture(scope="module")
def host_run(tiny):
    """The port's host-merge engine over TEXTS: the baseline."""
    _, _, tm, tp, _, tv = tiny
    return drive(PagedBeamEngine(tm, tp, tv, tv, merge="host",
                                 **{**ENGINE, "max_rows": 2 * K}), TEXTS)


@pytest.mark.parametrize("steps", [1, 3])
def test_fused_engine_matches_jax_fused(tiny, steps):
    """Caps 8-12 and steps 3 (no divisor of them): sentences reach EOS
    and their cap inside a round and freeze there."""
    eng, jeng = fused_engines(tiny, steps)
    assert eng.merge == "fused" and eng.steps_per_round == steps
    assert eng.pool.usable_pages == jeng.pool.usable_pages
    got = drive(eng, TEXTS)
    assert_same(got, drive(jeng, TEXTS))
    caps = {eng.decode_cap(len(tiny[5].encode(t, add_eos=True)))
            for t in TEXTS}
    assert len(caps) > 1
    assert eng.counters["forks"] > 0 and eng.counters["mid_decode_joins"] > 0
    assert eng.counters["fused_fallback_rounds"] == 0
    assert eng.counters["steps"] == steps * eng.counters["rounds"]
    assert_clean(eng)


@pytest.mark.parametrize("steps", [1, 3])
def test_fused_engine_matches_the_host_merge(tiny, host_run, steps):
    eng, _ = fused_engines(tiny, steps)
    assert_same(drive(eng, TEXTS), host_run)
    assert_clean(eng)


def test_pool_pressure_falls_back_to_the_host_merge(tiny):
    """One sentence at a time (max_rows = K) over a pool of K full-cap
    rows plus 2 pages: the host merge's real demand always fits (at most
    K rows of 3 pages and a round's 2 forks), the fused rounds' worst-case
    preclaim (K-1 or K fresh pages a step, 2 steps) stops fitting as the
    hypotheses diverge. Those rounds run one host-merge step; the output
    is the unpressured fused engine's, and nothing is evicted."""
    _, _, tm, tp, _, tv = tiny
    args = {**ENGINE, "max_rows": K, "steps_per_round": 2}
    free = PagedBeamEngine(tm, tp, tv, tv, **args)
    tight = PagedBeamEngine(
        tm, tp, tv, tv, pool_bytes=free.page_bytes * (K * free.max_pages + 2),
        **args)
    assert tight.pool.usable_pages == K * tight.max_pages + 2 \
        < free.pool.usable_pages
    got = drive(tight, TEXTS)
    assert tight.counters["fused_fallback_rounds"] > 0, \
        "the squeeze never reached the fallback"
    assert tight.counters["pool_evictions"] == 0
    assert tight.counters["rounds"] > tight.counters["fused_fallback_rounds"]
    assert_same(got, drive(free, TEXTS))
    assert free.counters["fused_fallback_rounds"] == 0
    assert_clean(tight)
    assert_clean(free)


def test_truncated_retable_diff_fails_the_rounds_audit(tiny, monkeypatch):
    """One row's diff applied truncated (the pool drops its last page
    while the table mirror keeps the device's row): the round's audit
    (MARIAN_POOL_AUDIT=1) raises in that same round."""
    eng, _ = fused_engines(tiny, 2)
    applying, hit = [], []
    apply = PagedBeamEngine._apply_round_table

    def spy(self, sent, table):
        applying.append(True)
        try:
            return apply(self, sent, table)
        finally:
            applying.pop()
    monkeypatch.setattr(PagedBeamEngine, "_apply_round_table", spy)
    retable = eng.pool.retable

    def truncated(owner, pages):
        if applying and not hit and len(pages) > 1:
            hit.append(eng.counters["rounds"])
            pages = list(pages)[:-1]
        return retable(owner, pages)
    monkeypatch.setattr(eng.pool, "retable", truncated)
    with pytest.raises(PoolCorruption, match="pool audit"):
        eng.decode_texts(TEXTS[:2])
    # the round that applied the bad diff is the one that failed
    assert hit == [eng.counters["rounds"]]
    assert any("does not match its claim" in v for v in eng.audit())


def test_bad_merge_value_is_refused(tiny):
    with pytest.raises(ValueError, match="iteration-beam-merge"):
        fused_engines(tiny, 1, merge="gpu")


def test_host_merge_runs_one_step_a_round(tiny):
    _, _, tm, tp, _, tv = tiny
    eng = PagedBeamEngine(tm, tp, tv, tv, merge="host",
                          **{**ENGINE, "max_rows": 2 * K,
                             "steps_per_round": 4})
    assert eng.merge == "host" and eng.steps_per_round == 1
    unsized = {**ENGINE, "max_rows": 2 * K}
    # the host engine's pool has no preclaim headroom, the fused one's has
    assert eng.pool.usable_pages == 2 * K * eng.max_pages
    fused = PagedBeamEngine(tm, tp, tv, tv, steps_per_round=4, **unsized)
    assert fused.pool.usable_pages == 2 * K * (eng.max_pages + 4)


def test_server_refuses_the_host_merge_with_multistep_rounds():
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.server.server import ServingApp

    def opts(*flags):
        return parse_options(
            ["--models", "m.npz", "--vocabs", "v.yml", "v.yml",
             "--batching-mode", "iteration", "--beam-size", "2",
             "--cpu-threads", "1", *flags], mode="server")
    ServingApp._validate_options(opts())
    ServingApp._validate_options(opts("--iteration-steps", "4"))
    ServingApp._validate_options(opts("--iteration-beam-merge", "host"))
    with pytest.raises(ValueError, match="host merge needs"):
        ServingApp._validate_options(opts("--iteration-beam-merge", "host",
                                          "--iteration-steps", "4"))
    with pytest.raises(ValueError, match="iteration-beam-merge"):
        ServingApp._validate_options(opts("--iteration-beam-merge", "gpu"))
    with pytest.raises(ValueError, match="iteration-steps"):
        ServingApp._validate_options(opts("--iteration-steps", "-2"))


@pytest.mark.parametrize("rows", [2 * K, 2 * K + 1, 4 * K])
def test_row_buckets_are_whole_sentences(tiny, rows):
    eng, jeng = fused_engines(tiny, 1, max_rows=rows)
    assert all(rb % K == 0 for rb in eng.row_buckets)
    assert eng.row_buckets == jeng.row_buckets
    assert max(eng.row_buckets) == rows // K * K
