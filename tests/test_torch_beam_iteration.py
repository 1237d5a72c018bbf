"""marian_tpu_torch copy-on-write beam decoding at iteration level
(``translator/beam_iteration.py``, the host merge) against the JAX
reference on the CPU, at the reference's test size (2+2 layers, dim 32, a
35-word vocabulary, beam 3, pages of 4 tokens, source cap 8, decode cap
12).

- ``PagedBeamEngine`` (the host merge) gives the JAX host-merge engine's
  tokens, lengths and raw path scores (within 1e-5: f32 sums in another
  order) at 1, 2 and 2 blocks plus a spare slot, and with a mid-decode
  join beside a running beam;
- its tokens and lengths equal the JAX dense beam search's, one sentence
  at a time at the engine's decode cap (raw scores within 1e-5);
- after a cancel and after an eviction on a dry pool (the JAX engine
  evicts the same sentence in the same round) the refcounts, the audit
  and the free pages are clean; the audit catches a shared write page;
- ``pool_fork_partial`` and ``fork_paged_rows`` copy what the JAX ones
  copy; admission prices and fatal reasons are the JAX engine's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.models.transformer import fork_paged_rows as jfork_rows
from marian_tpu.ops.pallas.kv_pool import pool_fork_partial as jfork_pages
from marian_tpu.translator.beam_iteration import PagedBeamEngine as JBeam
from marian_tpu.translator.beam_search import BeamConfig, beam_search_jit
from marian_tpu_torch.data.vocab import EOS_ID, DefaultVocab
from marian_tpu_torch.models.transformer import fork_paged_rows
from marian_tpu_torch.ops.kernels.kv_pool import pool_fork_partial
from marian_tpu_torch.translator.beam_iteration import PagedBeamEngine
from marian_tpu_torch.translator.iteration import FATAL_REASONS
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(2)

WORDS = [" ".join(f"w{i}" for i in range(35))]
TEXTS = ["w3 w4 w5", "w6 w7", "w8 w9 w10 w11", "w2 w3", "w4 w4 w4 w4 w4",
         "w12 w13", "w20 w21 w22 w23 w24 w25", "w30"]
K = 3
ENGINE = dict(beam_size=K, normalize=0.6, page_len=4, src_len_cap=8,
              max_length_cap=12)
SCORE_TOL = 1e-5


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
def tiny():
    """(JAX model, JAX params, port model, port params, JAX vocab, port
    vocab) from one seeded JAX init; seed 4 decodes hypotheses that end
    at their own EOS and at the cap."""
    jm, jp, tm, tp, _ = tiny_pair(vocab=len(DefaultVocab.build(WORDS)),
                                  seed=4, **{"dim-emb": 32})
    return jm, jp, tm, tp, JVocab.build(WORDS), DefaultVocab.build(WORDS)


def engines(tiny, **kw):
    """(the port's host-merge engine, the JAX host-merge engine) at
    ENGINE + kw."""
    jm, jp, tm, tp, jv, tv = tiny
    args = {**ENGINE, "max_rows": 2 * K, **kw}
    return (PagedBeamEngine(tm, tp, tv, tv, merge="host", **args),
            JBeam(jm, jp, jv, jv, merge="host", **args))


def drive(eng, texts, schedule=None):
    """Decode ``texts`` through the slot machinery: joins as capacity
    frees up (or at the rounds ``schedule`` {round: [keys]} names),
    deferred and pool-evicted sentences retried. Returns (texts by key,
    finished info by key, pool-evicted keys by round)."""
    outs, infos, evicted = {}, {}, {}
    pending = [] if schedule else list(enumerate(texts))
    rnd = 0
    while pending or not eng.idle() or (schedule and rnd <= max(schedule)):
        if schedule and rnd in schedule:
            pending += [(k, texts[k]) for k in schedule[rnd]]
        joins, pending = pending[:eng.free_slots()], \
            pending[eng.free_slots():]
        res = eng.admit_and_step(joins)
        assert all(why not in FATAL_REASONS for _, why in res.rejected)
        pending = [(k, texts[k]) for k, _ in res.rejected] + pending
        if res.pool_evicted:
            evicted[rnd] = list(res.pool_evicted)
        pending = [(k, texts[k]) for k in res.pool_evicted] + pending
        outs.update(dict(res.finished))
        infos.update(res.finished_info)
        rnd += 1
        assert rnd < 500, "beam decode failed to converge"
    return outs, infos, evicted


def assert_same(got, want):
    """Texts, tokens and lengths equal, raw scores within SCORE_TOL."""
    assert got[0] == want[0]
    for key, info in want[1].items():
        mine = got[1][key]
        assert mine["tokens"][:mine["length"]] \
            == list(info["tokens"][:info["length"]]), key
        assert mine["length"] == info["length"], key
        assert abs(mine["score"] - info["score"]) <= SCORE_TOL, key


def assert_clean(eng):
    assert eng.idle()
    assert eng.pool.free_pages() == eng.pool.usable_pages
    assert eng.pool.claims() == {} and eng.pool.refcounts() == {}
    assert eng.audit() == []


@pytest.mark.parametrize("rows", [K, 2 * K, 2 * K + 1])
def test_engine_matches_jax_host_merge(tiny, rows):
    eng, jeng = engines(tiny, max_rows=rows)
    got = drive(eng, TEXTS)
    assert_same(got, drive(jeng, TEXTS))
    assert eng.counters["forks"] > 0
    if rows > K:
        assert eng.counters["mid_decode_joins"] > 0
    lens = {info["length"] for info in got[1].values()}
    assert ENGINE["max_length_cap"] in lens and min(lens) < 12
    assert_clean(eng)


def test_mid_decode_join_beside_a_running_beam(tiny):
    """Sentence 1 joins three steps into sentence 0's decode, sentence 2
    into both: the same texts, tokens and scores as the JAX engine on the
    same schedule."""
    schedule = {0: [0], 3: [1], 5: [2]}
    texts = [TEXTS[6], TEXTS[2], TEXTS[0]]
    eng, jeng = engines(tiny, max_rows=3 * K)
    got = drive(eng, texts, schedule)
    assert_same(got, drive(jeng, texts, schedule))
    assert eng.counters["mid_decode_joins"] == 2
    assert_clean(eng)


def dense_best(tiny, text):
    """The JAX dense beam search of ``text`` alone at the engine's
    decode cap: (tokens, length, raw score) of its best hypothesis."""
    jm, jp, _, _, jv, _ = tiny
    ids = jv.encode(text, add_eos=True)
    cap = int(min(12, max(8, round(3.0 * len(ids)))))
    toks, scores, lengths, norm, _, _ = beam_search_jit(
        jm, [jp], [1.0], BeamConfig(beam_size=K, normalize=0.6,
                                    max_length=cap),
        jnp.asarray(np.array([ids], np.int32)),
        jnp.ones((1, len(ids)), jnp.float32))
    toks, scores, lengths, norm = map(np.asarray,
                                      (toks, scores, lengths, norm))
    j = np.argsort(-norm[0], kind="stable")[0]
    ln = int(lengths[0, j])
    tl = toks[0, j, :ln].tolist()
    return (tl[:-1] if tl and tl[-1] == EOS_ID else tl), ln, \
        float(scores[0, j])


def test_tokens_match_jax_dense_beam_search(tiny):
    eng, _ = engines(tiny)
    _, infos, _ = drive(eng, TEXTS)
    for i, text in enumerate(TEXTS):
        toks, ln, score = dense_best(tiny, text)
        mine = infos[i]
        crop = mine["tokens"][:mine["length"]]
        crop = crop[:-1] if crop and crop[-1] == EOS_ID else crop
        assert (crop, mine["length"]) == (toks, ln), i
        assert abs(mine["score"] - score) <= SCORE_TOL, i


def test_cancel_mid_decode_frees_every_page(tiny):
    eng, _ = engines(tiny)
    eng.admit_and_step([(0, TEXTS[6]), (1, TEXTS[2])])
    for _ in range(5):
        eng.admit_and_step([])
    assert eng.pool.alias_stats()["max"] >= 2, "no page was shared"
    assert eng.audit() == []
    eng.admit_and_step([], evicts=[0])
    assert eng.active_rows() == K and eng.audit() == []
    eng.admit_and_step([], evicts=[1])
    assert_clean(eng)


def test_dry_pool_evicts_the_sentence_as_jax_does(tiny):
    """Five pages hold a sentence's trunk and its partial pages until the
    hypotheses diverge across a page boundary: the lazy claim finds the
    pool dry and the whole sentence leaves, in the JAX engine's round;
    the pool is clean after it."""
    page_bytes = engines(tiny, max_rows=K)[0].page_bytes
    eng, jeng = engines(tiny, max_rows=K, pool_bytes=5 * page_bytes)
    assert eng.pool.usable_pages == jeng.pool.usable_pages == 5
    rounds = {}
    for name, e in (("port", eng), ("jax", jeng)):
        res = e.admit_and_step([(0, TEXTS[6])])
        assert res.accepted == [0]
        for rnd in range(1, 13):
            res = e.admit_and_step([])
            if res.pool_evicted:
                rounds[name] = (rnd, list(res.pool_evicted))
                break
    assert rounds["port"] == rounds["jax"] and rounds["port"][1] == [0]
    assert_clean(eng)
    assert eng.counters["pool_evictions"] == 1


def test_audit_catches_a_shared_write_page(tiny):
    eng, _ = engines(tiny)
    eng.admit_and_step([(0, TEXTS[6])])
    eng.admit_and_step([])
    live = [s for s in range(K) if eng._slot_pos[s] >= 0]
    write = eng.pool.pages_of((0, live[0]))[-1]
    eng.pool.share(("planted", 0), [write])
    bad = eng.audit()
    assert any("write-target page" in v for v in bad)
    assert any("matches no sentence slot" in v for v in bad)
    eng.pool.release(("planted", 0))
    assert eng.audit() == []


@pytest.mark.parametrize("case", ["admit", "src_too_long", "too_large"])
def test_admission_matches_jax(tiny, case):
    kw, text = {}, TEXTS[2]
    if case == "src_too_long":
        text = " ".join(["w3"] * 20)
    if case == "too_large":
        # a cap of 12 needs 3 pages a hypothesis, 5 with the partials
        kw["pool_bytes"] = 4 * engines(tiny)[0].page_bytes
    eng, jeng = engines(tiny, **kw)
    assert eng.pages_for_text(text) == jeng.pages_for_text(text)
    assert eng.free_slots() == jeng.free_slots() == 2
    got, want = (e.admit_and_step([(0, text)]) for e in (eng, jeng))
    assert got.rejected == want.rejected
    assert got.reject_detail == want.reject_detail
    if case == "admit":
        assert got.accepted == [0] and eng.free_slots() == 1


@pytest.mark.parametrize("pairs", [[(3, 5), (3, 6), (0, 0)],
                                   [(1, 2), (2, 1), (0, 0), (0, 0)]])
def test_fork_copies_match_jax(pairs):
    rng = np.random.RandomState(3)
    src, dst = (np.array(x, np.int32) for x in zip(*pairs))
    pk, pv = (rng.randn(8, 2, 4, 16).astype(np.float32) for _ in range(2))
    jk, jv = jfork_pages(jnp.asarray(pk), jnp.asarray(pv), src, dst)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    pool_fork_partial(tk, tv, torch.from_numpy(src), torch.from_numpy(dst))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    state = {"l1_cross_k": rng.randn(4, 2, 6, 16).astype(np.float32),
             "l1_pool_k": pk, "pos": np.zeros(4, np.int32)}
    mask = rng.rand(4, 6).astype(np.float32)
    rows = (src % 4, dst % 4)
    jst, jmask = jfork_rows({k: jnp.asarray(v) for k, v in state.items()},
                            jnp.asarray(mask), *rows)
    tst = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tmask = torch.from_numpy(mask.copy())
    fork_paged_rows(tst, tmask, *(torch.from_numpy(r) for r in rows))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    for k in state:
        assert np.array_equal(tst[k].numpy(), np.asarray(jst[k])), k


def test_server_replies_equal_the_jax_beam_engine(tiny, tmp_path,
                                                  monkeypatch):
    """marian-server in iteration mode at beam 3 with the host merge: the
    real ``_serve`` (TCP framing, admission, scheduler, beam engine)
    answers concurrent clients with the JAX host-merge engine's texts."""
    import asyncio

    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.server import server as srv
    monkeypatch.setattr(srv, "HAVE_WS", False)    # the TCP transport
    jm, jp, _, _, jv, _ = tiny
    jv.save(str(tmp_path / "v.yml"))
    _, _, _, _, opts = tiny_pair(vocab=len(jv), seed=4, **{"dim-emb": 32})
    mio.save_model(str(tmp_path / "m.npz"),
                   {k: np.asarray(v) for k, v in jp.items()}, opts.as_yaml())
    vocab = str(tmp_path / "v.yml")
    options = parse_options(
        ["--models", str(tmp_path / "m.npz"), "--vocabs", vocab, vocab,
         "--batching-mode", "iteration", "--beam-size", str(K),
         "--iteration-beam-merge", "host", "--normalize", "0.6",
         "--iteration-rows", str(2 * K), "--kv-page-len", "4",
         "--max-length", "12", "--cpu-threads", "1", "--port", "0",
         "--quiet"], mode="server")
    requests = ["\n".join(TEXTS[:2]), TEXTS[2], "\n".join(TEXTS[3:6]),
                TEXTS[6], TEXTS[7]]

    async def one(port, text):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = text.encode("utf-8")
        writer.write(b"MTPU %d\n" % len(payload) + payload)
        await writer.drain()
        header = await reader.readline()
        reply = await reader.readexactly(int(header.split()[1]))
        writer.close()
        return reply.decode("utf-8")

    async def main():
        ready = asyncio.get_event_loop().create_future()
        task = asyncio.ensure_future(srv._serve(options, ready=ready))
        port = await asyncio.wait_for(ready, 60)
        try:
            return await asyncio.gather(*[one(port, r) for r in requests])
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    replies = asyncio.run(main())
    want = JBeam(jm, jp, jv, jv, merge="host",
                 **{**ENGINE, "max_rows": 2 * K,
                    "src_len_cap": srv.bucket_length(13)}).decode_texts(TEXTS)
    assert "\n".join(replies).split("\n") == want
