"""The port's ``/poolz`` inspector (``obs/poolz.py``), the paged
engines' ``pool_state`` and their pool, round, fork, prefix-cache and
shortlist series against the JAX package's, on the CPU, at the
reference's test size (``tests/test_torch_decode_features``: 2+2 layers,
dim 32, a 35-word vocabulary, pages of 4 tokens).

- On the same pool history (joins, a copy-on-write fork from a live row,
  finishes into the prefix cache, a replay), ``poolz.snapshot`` of the
  greedy engines gives the same document after every round (the page
  map with refcounts and owners, the slot table, the pool's counts and
  traffic, the prefix cache's block), and both packages'
  ``check_consistency`` find it consistent; the same corrupted
  documents give the same problems;
- the beam engines (fused merge, a per-row shortlist) give the same
  beam view and the same shortlist, round and page-traffic series;
- the engines' series carry the reference's names, types, HELP and
  buckets, and count the same rounds, pages, forks and prefix hits;
- a failed pool audit records ``pool.audit_failed``, counts in
  ``marian_serving_pool_audit_failures_total`` and writes a
  ``pool-audit`` flight dump that embeds the page map;
- end to end over TCP, an iteration-mode server (``--trace``, metrics
  port bound to 0) answers a ``#trace:`` request with its metadata line
  and row breakdown, and serves ``/poolz?check=1`` (consistent, its page
  counts the engine pool's), ``/tracez`` (``serve.row`` and
  ``serve.round`` spans) and ``/sloz``.

Every server binds port 0 and every wait has a deadline.
"""

import asyncio
import copy
import json
import os
import time
import types
import urllib.request

import pytest
import torch

from marian_tpu import obs as jobs
from marian_tpu.obs import poolz as jpoolz
from marian_tpu.serving import metrics as jmsm
from marian_tpu.translator.beam_iteration import PagedBeamEngine as JBeam
from marian_tpu.translator.iteration import PagedDecodeEngine as JGreedy
from marian_tpu.translator.prefix_cache import PrefixCache as JCache
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.obs import poolz as tpoolz
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.translator.beam_iteration import PagedBeamEngine
from marian_tpu_torch.translator.iteration import PagedDecodeEngine
from marian_tpu_torch.translator.prefix_cache import PrefixCache
from tests.test_torch_decode_features import (ARGS, BEAM, lex,  # noqa
                                              planes, tiny)

torch.set_num_threads(2)
WAIT = 20.0


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    for o in (jobs, tobs):
        o.TRACER.reset()
        o.FLIGHT.disarm()
        o.PERF.reset()


def sched_of(engine):
    """The scheduler surface ``poolz.snapshot`` reads."""
    return types.SimpleNamespace(
        batching_mode="iteration", engine=engine, queued_units=lambda: 0,
        queued_pages=lambda: 0, _quiesce_depth=lambda: 0,
        _brownout_level=0)


def comparable(doc):
    """A /poolz document without what differs by design: the reference's
    per-slot source lengths, the engines' own counter sets, and the
    audit's timestamp (the fleet tenant sums and the brownout level are
    compared)."""
    doc = copy.deepcopy(doc)
    doc.pop("counters", None)
    for row in doc.get("rows", {}).get("slots", []):
        row.pop("src_tokens", None)
    if doc.get("last_audit"):
        doc["last_audit"].pop("ts", None)
    return doc


# a schedule of (joins, evicts) rounds: key 3 repeats key 0's source
# while key 0 decodes (a live fork), key 4 is evicted mid-decode, key 5
# repeats key 1's after every row finished (a replay)
SCHEDULE = [([(0, "w3 w4 w5"), (1, "w6 w7"), (2, "w8 w9 w10 w11")], []),
            ([(4, "w12 w13 w14")], []), ([], []), ([], [4]),
            ([(3, "w3 w4 w5")], []),
            ([], []), ([], []), ([], []), ([], []), ([], []), ([], []),
            ([], []), ([], []), ([], []), ([(5, "w6 w7")], []),
            ([], [])]


def run_greedy(eng, reg):
    eng._declare_metrics(reg)
    docs, finished = [], {}
    for joins, evicts in SCHEDULE:
        res = eng.admit_and_step(joins, evicts)
        finished.update(res.finished)
        docs.append(tpoolz.snapshot(sched_of(eng)))
    return docs, finished


ENGINE_SERIES = (
    "marian_serving_engine_rounds_total",
    "marian_serving_kv_pool_pages_claimed_total",
    "marian_serving_kv_pool_pages_freed_total",
    "marian_serving_kv_pool_pages_aliased_total",
    "marian_serving_kv_pool_pages_copied_total",
    "marian_serving_kv_pool_bytes_copied_total",
    "marian_serving_kv_pool_bytes_aliased_total",
    "marian_serving_cow_forks_total", "marian_serving_pool_audits_total",
    "marian_serving_pool_audit_failures_total",
    "marian_serving_kv_pool_pages", "marian_serving_kv_pool_pages_free",
    "marian_serving_kv_pool_occupancy_ratio",
    "marian_serving_kv_pool_pages_shared",
    "marian_serving_kv_pool_refcount_max",
    "marian_serving_kv_pool_cow_alias_ratio",
    "marian_serving_kv_pool_fragmentation_ratio",
    "marian_serving_active_rows", "marian_prefix_hits_total",
    "marian_prefix_misses_total", "marian_prefix_tokens_saved_total",
    "marian_prefix_pages_reused_total", "marian_prefix_evictions_total",
    "marian_prefix_entries", "marian_prefix_held_pages",
    "marian_prefix_reclaimable_pages", "marian_shortlist_rows_total",
    "marian_shortlist_width_tokens")


def series(reg):
    out = {}
    for name in ENGINE_SERIES:
        m = reg.get(name)
        if m is None:
            continue
        value = m.snapshot()[:3] if m.kind == "histogram" else m.value
        out[name] = (m.kind, m.help, tuple(getattr(m, "buckets", ())),
                     value)
    return out


def test_greedy_pool_history_matches_jax(tiny):
    jm, jp, tm, tp, jv, tv = tiny
    tr, jr = tmsm.Registry(), jmsm.Registry()
    teng = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4,
                             prefix_cache=PrefixCache(max_entries=4), **ARGS)
    jeng = JGreedy(jm, jp, jv, jv, max_rows=4, registry=jr,
                   prefix_cache=JCache(max_entries=4), **ARGS)
    got, tfin = run_greedy(teng, tr)
    want = []
    jfin = {}
    for joins, evicts in SCHEDULE:
        res = jeng.admit_and_step(joins, evicts)
        jfin.update(res.finished)
        want.append(jpoolz.snapshot(sched_of(jeng)))
    assert tfin == jfin and set(tfin) == {0, 1, 2, 3, 5}
    for i, (g, w) in enumerate(zip(got, want)):
        assert comparable(g) == comparable(w), f"round {i}"
        for doc in (g, w):
            assert tpoolz.check_consistency(doc) == []
            assert jpoolz.check_consistency(doc) == []
    # the history really holds a fork, shared pages and cache pages
    assert any(d["pool"]["shared_pages"] > 0 for d in got)
    assert any("prefix-cache" in o for d in got
               for p in d["pages"].values() for o in p["owners"])
    assert got[-1]["prefix_cache"]["entries"] >= 3
    assert series(tr) == series(jr)
    s = series(tr)
    assert s["marian_serving_cow_forks_total"][3] == 1
    assert s["marian_prefix_hits_total"][3] == 2
    assert s["marian_serving_engine_rounds_total"][3] == len(SCHEDULE)
    teng.audit()
    jeng.audit()
    assert comparable(tpoolz.snapshot(sched_of(teng)))["last_audit"] \
        == comparable(jpoolz.snapshot(sched_of(jeng)))["last_audit"] \
        == {"context": "quiesce", "clean": True, "violations": []}


BROKEN = [
    lambda d: d["pages"].__setitem__("1", {"refs": 2, "owners": ["x"]}),
    lambda d: d["pool"].__setitem__("free_pages", d["pool"]["free_pages"]
                                    + 1),
    lambda d: d["rows"]["slots"][0]["pages"].append(999),
    lambda d: d["rows"]["slots"][0].__setitem__("pos", 99),
]


@pytest.mark.parametrize("breakage", range(len(BROKEN)))
def test_check_consistency_flags_as_jax(tiny, breakage):
    _, _, tm, tp, _, tv = tiny
    eng = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4, **ARGS)
    eng.admit_and_step([(0, "w3 w4 w5"), (1, "w6 w7")])
    doc = tpoolz.snapshot(sched_of(eng))
    BROKEN[breakage](doc)
    got = tpoolz.check_consistency(doc)
    assert got and got == jpoolz.check_consistency(doc)
    assert tpoolz.check_consistency({"enabled": False}) == []


def test_beam_pool_state_and_shortlist_series_match_jax(tiny, lex):
    jm, jp, tm, tp, jv, tv = tiny
    jplane, tplane = planes(tiny, lex, "shortlist")
    tr, jr = tmsm.Registry(), jmsm.Registry()
    kw = dict(BEAM, merge="fused", steps_per_round=2)
    teng = PagedBeamEngine(tm, tp, tv, tv, features=tplane, **kw)
    jeng = JBeam(jm, jp, jv, jv, features=jplane, registry=jr, **kw)
    teng._declare_metrics(tr)
    texts = ["w3 w4 w5", "w6 w7"]
    for eng, mod in ((teng, tpoolz), (jeng, jpoolz)):
        eng.admit_and_step([(i, t) for i, t in enumerate(texts)])
    tdoc = tpoolz.snapshot(sched_of(teng))
    jdoc = jpoolz.snapshot(sched_of(jeng))
    assert comparable(tdoc) == comparable(jdoc)
    assert tdoc["beam"]["beam_size"] == 2 and len(tdoc["beam"]
                                                  ["sentences"]) == 2
    assert tpoolz.check_consistency(tdoc) == []
    finished = []
    for eng in (teng, jeng):
        out = {}
        for _ in range(20):
            out.update(eng.admit_and_step([]).finished)
        assert eng.idle() and len(out) == 2
        finished.append(out)
    assert finished[0] == finished[1]
    assert series(tr) == series(jr)
    assert series(tr)["marian_shortlist_rows_total"][3] == 2


def test_failed_audit_records_event_counter_and_dump(tiny, tmp_path):
    _, _, tm, tp, _, tv = tiny
    tobs.TRACER.enable()
    tobs.FLIGHT.arm(str(tmp_path))
    reg = tmsm.Registry()
    eng = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4, **ARGS)
    eng._declare_metrics(reg)
    tobs.FLIGHT.add_snapshot_provider(
        "pool", lambda: tpoolz.snapshot(sched_of(eng)))
    try:
        eng.admit_and_step([(0, "w3 w4 w5")])
        eng._table[0, 0] = 7                 # a corrupted table row
        bad = eng.audit()
        assert bad and "table corruption" in bad[0]
        deadline = time.time() + WAIT
        while time.time() < deadline and not os.listdir(tmp_path):
            time.sleep(0.01)
        time.sleep(0.2)
        (name,) = [f for f in os.listdir(tmp_path)
                   if f.startswith("flight-")]
        assert name.endswith("-pool-audit.json")
        with open(tmp_path / name, encoding="utf-8") as fh:
            payload = json.load(fh)
    finally:
        tobs.FLIGHT.remove_snapshot_provider("pool")
    assert payload["pool"]["last_audit"]["clean"] is False
    assert payload["pool"]["rows"]["slots"][0]["slot"] == 0
    _, events = tobs.TRACER.snapshot()
    assert [e["name"] for e in events] == ["pool.audit_failed"]
    assert reg.get("marian_serving_pool_audit_failures_total").value == 1
    # (the round's own audit too, where MARIAN_POOL_AUDIT=1)
    assert reg.get("marian_serving_pool_audits_total").value \
        == eng.counters["audits"] >= 1


def get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as fh:
        return fh.read().decode()


async def tcp_request(port, text):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        payload = text.encode("utf-8")
        writer.write(b"MTPU %d\n" % len(payload) + payload)
        await writer.drain()
        header = await asyncio.wait_for(reader.readline(), WAIT)
        return (await reader.readexactly(int(header.split()[1]))).decode()
    finally:
        writer.close()


def test_iteration_server_routes_over_tcp(tiny, monkeypatch):
    _, _, tm, tp, _, tv = tiny
    real = tmsm.MetricsServer
    monkeypatch.setattr(tmsm, "MetricsServer",
                        lambda port, **kw: real(0, host="127.0.0.1", **kw))
    eng = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4, **ARGS)
    want = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4, **ARGS
                             ).decode_texts(["w3 w4 w5", "w6 w7"])
    app = srv.ServingApp(Options({
        "batching-mode": "iteration", "metrics-port": 9, "trace": True,
        "perf-accounting": True, "slo-p99-ms": 5000.0}),
        engine=eng, registry=tmsm.Registry())

    async def scenario():
        loop = asyncio.get_event_loop()
        app.start()
        server = await asyncio.start_server(srv._make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{app.metrics_server.port}"
        try:
            traced = await tcp_request(port, "#trace:it-1\nw3 w4 w5\nw6 w7")
            poolz = await loop.run_in_executor(None, get,
                                               base + "/poolz?check=1")
            tz = await loop.run_in_executor(None, get, base + "/tracez")
            sloz = await loop.run_in_executor(None, get, base + "/sloz")
            metrics = await loop.run_in_executor(None, get,
                                                 base + "/metrics")
            return traced, json.loads(poolz), json.loads(tz), \
                json.loads(sloz), metrics
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown(drain_timeout=2.0)
    traced, poolz, tz, sloz, metrics = asyncio.run(scenario())
    head, body = traced.split("\n", 1)
    assert body.split("\n") == want
    fields = dict(kv.split("=") for kv in head.split()[1:])
    assert head.startswith("#trace:it-1 ") and fields["outcome"] == "ok"
    assert int(fields["rounds"]) >= 1 and fields["prefix_hit"] == "0" \
        and fields["evictions"] == "0" and float(fields["ttfj_ms"]) >= 0
    assert poolz["enabled"] and poolz["consistency"] == []
    assert poolz["pool"]["usable_pages"] == eng.pool.usable_pages
    assert poolz["pool"]["free_pages"] == eng.pool.free_pages()
    names = {e["name"] for e in tz["traceEvents"]
             if e["args"].get("trace_id") == "it-1"}
    assert {"request", "serve.queue", "serve.dispatch", "serve.row",
            "reply.write"} <= names
    assert any(e["name"] == "serve.round" and "it-1" in e["args"]["traces"]
               for e in tz["traceEvents"])
    assert set(sloz["slo"]["objectives"]) == {"latency_p99"}
    assert sloz["perf"]["enabled"] and sloz["perf"]["window"]["src_tokens"] \
        > 0
    assert "marian_serving_engine_rounds_total" in metrics
    assert "marian_perf_mfu" in metrics
