"""marian_tpu_torch's cross-request prefix cache
(``translator/prefix_cache.py``, ``--prefix-cache``) against the JAX
reference on the CPU, at the reference's test size (2+2 layers, a
35-word vocabulary, pages of 4 tokens, decode cap 12).

- ``PrefixCache`` keeps the JAX class's entries, LRU order, held pages,
  reclaimable pages and pool claims through one sequence of adopts,
  pageless memos, hits, trims, version misses, pressure evictions and
  drops;
- the greedy engine forks a repeat from a live leader (at 1 and 3 steps
  a round, inside and on a page boundary) and replays a finished one:
  its texts equal its own cold run's and the JAX engine's with a JAX
  cache, with the JAX engine's forks and hits;
- the fused beam engine replays finished sentences with the JAX beam
  engine's texts;
- a claim the free list cannot meet evicts the LRU entry, as the JAX
  engine does, and ``free_pages`` counts what the cache could give back;
- a TCP server at beam 2 with --prefix-cache gives a repeated request
  its cold reply, which is the port's dense beam search's;
- every drive ends, after ``drop_all``, with an empty pool and a clean
  audit.
"""

import asyncio

import numpy as np
import pytest
import torch

from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.ops.pallas.kv_pool import KVPool as JPool
from marian_tpu.translator.beam_iteration import PagedBeamEngine as JBeam
from marian_tpu.translator.iteration import PagedDecodeEngine as JEngine
from marian_tpu.translator.prefix_cache import PrefixCache as JCache
from marian_tpu_torch.common import io as mio
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.ops.kernels.kv_pool import KVPool
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.translator.beam_iteration import PagedBeamEngine
from marian_tpu_torch.translator.beam_search import (BeamConfig, BeamSearch,
                                                     beam_search)
from marian_tpu_torch.translator.iteration import PagedDecodeEngine
from marian_tpu_torch.translator.prefix_cache import PrefixCache
from tests.test_torch_beam_iteration import drive
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(2)

WORDS = [" ".join(f"w{i}" for i in range(35))]
ENGINE = dict(page_len=4, src_len_cap=8, max_length_cap=12)
# seed 4 (tests/test_torch_iteration.py): A and B decode to their cap of
# 12, C stops at its cap of 9
A, B, C = "w4 w4 w4 w4 w4", "w20 w21 w22 w23 w24 w25", "w6 w7"
# repeats of A join while A decodes (forks), then after it (replays)
TEXTS = [A, B, A, A, B, C, A, B, C]
SCHEDULE = {0: [0, 1], 2: [2], 4: [3, 4, 5], 16: [6, 7, 8]}


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
    jm, jp, tm, tp, _ = tiny_pair(vocab=len(DefaultVocab.build(WORDS)),
                                  seed=4)
    return jm, jp, tm, tp, JVocab.build(WORDS), DefaultVocab.build(WORDS)


def cache_state(cache, pool):
    return (list(cache._done), cache.held_pages(), cache.held_tokens(),
            cache.reclaimable_pages(pool), pool.claims(), pool.free_pages())


def test_prefix_cache_matches_jax_through_one_sequence():
    caches = (PrefixCache(max_entries=3, version="v1"),
              JCache(max_entries=3, version="v1"))
    pools = (KVPool(20, 4), JPool(20, 4))
    seen = []
    for cache, pool in zip(caches, pools):
        log = []
        for i, n in enumerate((2, 3, 1, 2, 2)):
            pool.claim(("row", i), n)
        # row 2 shares a page of row 1: that entry's pages are not all
        # freeable
        pool.share(("row", 9), pool.pages_of(("row", 1))[:1])
        log.append(cache.adopt(pool, ("a",), ("row", 0), [5, 6], "x y"))
        log.append(cache.adopt(pool, ("b",), ("row", 1), [7], "z"))
        log.append(cache.adopt(pool, ("a",), ("row", 2), [5], "x"))
        log.append(cache_state(cache, pool))
        log.append(cache.get(("a",), "v1").text)
        log.append(cache.get(("a",), "v2"))           # another version
        log.append(cache.remember(pool, ("m",), [3], "memo"))
        log.append(cache.adopt(pool, ("c",), ("row", 3), [4, 4], "q"))
        log.append(cache_state(cache, pool))          # trimmed to 3
        log.append(cache.leader(("a",)))
        cache.register_live(("a",), "k1")
        cache.register_live(("a",), "k2")
        log.append(cache.leader(("a",)))
        cache.unregister_live(("a",), "k2")
        log.append(cache.leader(("a",)))
        log.append(cache.evict_for_pages(pool, pool.free_pages() + 3))
        log.append(cache_state(cache, pool))
        log.append(cache.drop_all(pool))
        pool.release(("row", 2))
        pool.release(("row", 4))
        pool.release(("row", 9))
        log.append(cache_state(cache, pool))
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[0][-1][-1] == 19 and pools[0].audit() == []


def greedy_engines(tiny, steps, **kw):
    """(the port's greedy engine with a cache, the JAX one with a JAX
    cache) at ENGINE + kw."""
    jm, jp, tm, tp, jv, tv = tiny
    args = {**ENGINE, "max_rows": 4, "steps_per_round": steps, **kw}
    return (PagedDecodeEngine(tm, tp, tv, tv, prefix_cache=PrefixCache(),
                              **args),
            JEngine(jm, jp, jv, jv, prefix_cache=JCache(), **args))


def assert_drained(eng):
    eng.prefix.drop_all(eng.pool)
    assert eng.idle()
    assert eng.pool.free_pages() == eng.pool.usable_pages
    assert eng.pool.claims() == {} and eng.audit() == []


@pytest.mark.parametrize("steps", [1, 3])
def test_greedy_forks_and_replays_as_cold_and_as_jax(tiny, steps):
    eng, jeng = greedy_engines(tiny, steps)
    _, _, tm, tp, _, tv = tiny
    cold = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4,
                             steps_per_round=steps, **ENGINE)
    got = drive(eng, TEXTS, SCHEDULE)[0]
    assert got == drive(cold, TEXTS, SCHEDULE)[0]
    assert got == drive(jeng, TEXTS, SCHEDULE)[0]
    assert len(got[0].split()) == 12 and got[0] == got[3] == got[6]
    c = eng.counters
    assert c["forks"] > 0 and c["replays"] > 0
    assert (c["forks"], c["prefix_hits"]) \
        == (jeng._counters["forks"], jeng._counters["prefix_hits"])
    assert eng.prefix.counters["hits"] == c["prefix_hits"]
    assert cold.counters["encodes"] > c["encodes"]
    assert_drained(eng)


def test_greedy_fork_on_a_page_boundary_and_inside_one(tiny):
    """Repeats of A join when its leader sits at position 4 (a page
    boundary: nothing copied) and at 6 (its partial page copied)."""
    texts = [A, A, A]
    eng, jeng = greedy_engines(tiny, 1)
    got = drive(eng, texts, {0: [0], 4: [1], 6: [2]})[0]
    assert got == drive(jeng, texts, {0: [0], 4: [1], 6: [2]})[0]
    assert got[0] == got[1] == got[2] and eng.counters["forks"] == 2
    assert_drained(eng)


def test_beam_replays_as_jax(tiny):
    jm, jp, tm, tp, jv, tv = tiny
    args = {**ENGINE, "beam_size": 3, "normalize": 0.6, "max_rows": 6,
            "steps_per_round": 2}
    eng = PagedBeamEngine(tm, tp, tv, tv, prefix_cache=PrefixCache(),
                          **args)
    jeng = JBeam(jm, jp, jv, jv, merge="fused", prefix_cache=JCache(),
                 **args)
    got = drive(eng, TEXTS, SCHEDULE)[0]
    assert got == drive(jeng, TEXTS, SCHEDULE)[0]
    assert eng.counters["replays"] == jeng._counters["prefix_hits"] > 0
    cold = eng.counters["encodes"]
    again = drive(eng, TEXTS[:3])[0]
    assert again == {i: got[i] for i in range(3)}
    assert eng.counters["encodes"] == cold
    # beam entries are pageless: nothing to give back
    assert eng.prefix.held_pages() == 0 and eng.free_pages() \
        == eng.pool.free_pages()
    assert_drained(eng)


def test_pool_pressure_evicts_the_lru_entry_as_jax(tiny):
    """Two rows' pages: A and B finish into the cache, then C needs
    pages and the claim evicts A's entry (least recently used), as the
    JAX engine's does; a repeat of B still replays."""
    texts = [A, B, C, B]
    sched = {0: [0, 1], 14: [2], 30: [3]}
    eng, jeng = greedy_engines(tiny, 1, max_rows=2)
    page_bytes = eng.page_bytes
    eng, jeng = greedy_engines(tiny, 1, max_rows=2,
                               pool_bytes=6 * page_bytes)
    assert eng.pool.usable_pages == jeng.pool.usable_pages == 6
    seen = {}
    step = eng.admit_and_step

    def watched(joins, evicts=()):
        if joins and joins[0][0] == 2:
            seen["free"] = (eng.pool.free_pages(), eng.free_pages())
        return step(joins, evicts)
    eng.admit_and_step = watched
    got = drive(eng, texts, sched)[0]
    assert got == drive(jeng, texts, sched)[0]
    assert seen["free"] == (0, 6)
    assert eng.prefix.counters["evictions"] >= 1
    assert list(eng.prefix._done) == list(jeng.prefix._done)
    assert eng.counters["replays"] == 1
    assert_drained(eng)


def test_server_prefix_cache_at_beam_2(tiny, tmp_path):
    """The port's own decode holds the replies: a repeat's reply is the
    cold one, and both are the port's dense beam search at the decode
    caps (the reference's own server test of this fails)."""
    jm, jp, tm, tp, jv, tv = tiny
    jv.save(str(tmp_path / "v.yml"))
    _, _, _, _, opts = tiny_pair(vocab=len(jv), seed=4)
    mio.save_model(str(tmp_path / "m.npz"),
                   {k: np.asarray(v) for k, v in jp.items()}, opts.as_yaml())
    vocab = str(tmp_path / "v.yml")
    options = parse_options(
        ["--models", str(tmp_path / "m.npz"), "--vocabs", vocab, vocab,
         "--batching-mode", "iteration", "--beam-size", "2",
         "--normalize", "0.6", "--iteration-steps", "2", "--prefix-cache",
         "--iteration-rows", "4", "--kv-page-len", "4", "--max-length",
         "12", "--cpu-threads", "1", "--port", "0", "--quiet"],
        mode="server")
    lines = [A, B, C]

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
        app = srv.ServingApp(options)
        app.start()
        server = await asyncio.start_server(srv._make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            cold = await one(port, "\n".join(lines))
            warm = await asyncio.gather(one(port, "\n".join(lines)),
                                        one(port, C))
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
        return app.scheduler.engine, cold, warm
    engine, cold, (warm, warm_c) = asyncio.run(main())
    assert warm == cold and warm_c == cold.split("\n")[2]
    assert engine.merge == "fused" and engine.counters["replays"] == 4
    dense = []
    for text in lines:
        ids = tv.encode(text, add_eos=True)
        cfg = BeamConfig(beam_size=2, normalize=0.6,
                         max_length=engine.decode_cap(len(ids)))
        res = beam_search(tm, tp, cfg, torch.tensor([ids]),
                          torch.ones((1, len(ids))))
        best = BeamSearch._collect(*(x.numpy() for x in res[:4]), cfg)
        dense.append(tv.decode(best[0][0]["tokens"], ignore_eos=True))
    assert cold.split("\n") == dense and all(dense)
    assert_drained(engine)
