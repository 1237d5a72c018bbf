"""The serving side of the port's observability plane against the JAX
package's, on the CPU: the scheduler's span trees and series, the
admission series and events, the lifecycle's timeline events and flight
trips, and the overhead guard.

- Both packages' ``ContinuousScheduler``s, driven by the same stub
  translate function (request mode) or the same stub engine (iteration
  mode, ``tests/test_torch_quiesce.StubEngine``) with the same requests,
  give the same span trees (names, parent edges, attribute keys, the
  device-worker thread of ``serve.translate``), the same series (names,
  types, label names, HELP, buckets; the brownout evictions' too), the
  same request, outcome, batch, join,
  step and ttfb counts, the same reply metadata keys and the same
  latency exemplars.
- A watchdog trip and a poison isolation record the reference's events
  and flight dumps (``watchdog``, ``poison``) in both packages.
- Admission sheds count by reason and land on the timeline as in the
  reference; a drain records ``admission.drain_started`` once.
- The lifecycle (pinned and compat rejections, warmup failure, swap,
  canary, canary / live / manual rollback) records the same
  ``lifecycle.*`` events in the same order and the same flight dumps;
  the routed version lands on the device call's span.
- The request-mode translator's series count the same batches and
  sentences for the same lines, and they and the prefix cache's carry
  the reference's names, types, HELP and buckets.
- Overhead guard: with the tracer and the perf plane off, neither
  scheduler path (request or iteration mode) takes the tracer's or the
  perf meter's lock, records a span or allocates a ring.

Every wait has a deadline.
"""

import asyncio
import contextlib
import json
import os
import threading
import time
import types

import pytest

from marian_tpu import obs as jobs
from marian_tpu.serving import admission as jadm
from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving import lifecycle as jlc
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu.training import bundle as jbdl
from marian_tpu.translator.iteration import StepResult as JStepResult
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.serving import admission as tadm
from marian_tpu_torch.serving import lifecycle as tlc
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving.scheduler import ContinuousScheduler
from marian_tpu_torch.training import bundle as tbdl
from marian_tpu_torch.translator.iteration import StepResult
from tests.test_torch_quiesce import StubEngine
from tests.test_torch_serving_request import model  # noqa: F401

WAIT = 20.0
PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, msm=jmsm, Scheduler=JScheduler,
                                 Result=JStepResult, adm=jadm, lc=jlc,
                                 bdl=jbdl),
    "torch": types.SimpleNamespace(obs=tobs, msm=tmsm,
                                   Scheduler=ContinuousScheduler,
                                   Result=StepResult, adm=tadm, lc=tlc,
                                   bdl=tbdl),
}
# the reference's scheduler series the port does not carry yet: none
BY_DESIGN = set()
REQUESTS = [("r1", ["a b c", "d e"]), ("r2", ["f g h i"]),
            ("r3", ["j", "k l m", "n o"]), ("r4", ["p q r s t"])]


def _reset_planes():
    for p in PKGS.values():
        p.obs.TRACER.reset()
        p.obs.FLIGHT.disarm()
        p.obs.PERF.reset()


@contextlib.contextmanager
def planes_reset():
    """Both packages' planes off on entry as well as on exit: a test file
    that ran earlier in this worker may have left a plane on (a port
    ``ServingApp`` built from ``parse_options`` turns the perf plane on,
    since the parser defaults --perf-accounting on), and the request-mode
    span tree differs with it (``serve.batch`` gains ``device_s``)."""
    _reset_planes()
    try:
        yield
    finally:
        _reset_planes()


@pytest.fixture(autouse=True)
def _reset_obs():
    with planes_reset():
        yield


def translate(lines):
    return [ln.upper() for ln in lines]


def run_scheduler(p, mode, tracing=True, requests=REQUESTS, **kw):
    """``requests`` submitted in one event-loop step (one batch or one
    join pass) to package ``p``'s scheduler; returns (replies, metas,
    registry)."""
    if tracing:
        p.obs.TRACER.enable()
    reg = p.msm.Registry()
    if mode == "request":
        sched = p.Scheduler(translate, registry=reg, window_s=0.005,
                            version_fn=lambda: "bundle-7", **kw)
    else:
        sched = p.Scheduler(None if p.Scheduler is ContinuousScheduler
                            else translate, registry=reg, window_s=0.005,
                            batching_mode="iteration",
                            engine=StubEngine(p.Result, "E", round_s=0.0),
                            version_fn=lambda: "bundle-7", **kw)

    async def main():
        sched.start()
        metas = [{} for _ in requests]
        futs = [sched.submit(lines, meta=m, trace_id=tid)
                for (tid, lines), m in zip(requests, metas)]
        out = await asyncio.wait_for(asyncio.gather(*futs), WAIT)
        await sched.stop()
        return out, metas
    out, metas = asyncio.run(main())
    return out, metas, reg


def span_forest(tracer):
    """Per given trace id (and one bucket for the batch/round spans'
    own traces): the sorted (name, parent name, attribute keys, on the
    device worker) of its spans."""
    spans, _ = tracer.snapshot()
    names = {s.span_id: s.name for s in spans}
    given = {tid for tid, _ in REQUESTS}
    forest = {}
    for s in spans:
        key = s.trace_id if s.trace_id in given else "<own>"
        forest.setdefault(key, []).append((
            s.name, names.get(s.parent_id, ""), tuple(sorted(s.attrs)),
            s.thread.startswith("serve-device")))
    return {k: sorted(v) for k, v in forest.items()}


@pytest.mark.parametrize("mode", ["request", "iteration"])
def test_span_trees_match_jax(mode):
    got = run_scheduler(PKGS["torch"], mode)
    want = run_scheduler(PKGS["jax"], mode)
    assert got[0] == want[0]
    assert [sorted(m) for m in got[1]] == [sorted(m) for m in want[1]]
    tf, jf = span_forest(tobs.TRACER), span_forest(jobs.TRACER)
    assert tf == jf
    names = {n for spans in tf.values() for n, *_ in spans}
    if mode == "request":
        assert names == {"serve.request", "serve.queue", "serve.dispatch",
                         "serve.batch", "serve.translate"}
        assert ("serve.translate", "serve.batch", ("rows",), True) \
            in tf["<own>"]
    else:
        assert names == {"serve.request", "serve.queue", "serve.dispatch",
                         "serve.row", "serve.round"}
    # the batch / round spans name their requests' traces
    spans, _ = tobs.TRACER.snapshot()
    own = [s for s in spans if s.name in ("serve.batch", "serve.round")]
    assert {t for s in own for t in s.attrs["traces"]} \
        == {tid for tid, _ in REQUESTS}


def census(reg):
    """name -> (type, label names, HELP, histogram buckets)."""
    return {name: (m.kind, tuple(m.label_names), m.help,
                   tuple(getattr(m, "buckets", ())))
            for name, m in reg._metrics.items()}


def values(reg, names):
    out = {}
    for name in names:
        m = reg.get(name)
        if m is None:
            continue
        if m.label_names:
            out[name] = {k: c.value for k, c in m.children().items()}
        elif m.kind == "histogram":
            out[name] = m.snapshot()[2]            # the count
        else:
            out[name] = m.value
    return out


COUNTED = ("marian_serving_requests_total", "marian_serving_batches_total",
           "marian_serving_batch_rows", "marian_serving_batch_fill_ratio",
           "marian_serving_padding_waste_ratio",
           "marian_serving_time_to_first_batch_seconds",
           "marian_serving_request_latency_seconds",
           "marian_serving_request_outcomes_total",
           "marian_serving_joins_total",
           "marian_serving_mid_decode_joins_total",
           "marian_serving_decode_steps_total",
           "marian_serving_step_active_rows", "marian_serving_evictions_total",
           "marian_serving_timeouts_total", "marian_serving_cancelled_total",
           "marian_serving_failures_total",
           "marian_serving_retry_bisections_total",
           "marian_stream_partials_total", "marian_serving_queue_depth_pages",
           "marian_serving_queue_depth_sentences")


@pytest.mark.parametrize("mode", ["request", "iteration"])
@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_series_and_counts_match_jax(mode, tracing):
    _, tmeta, treg = run_scheduler(PKGS["torch"], mode, tracing)
    _, jmeta, jreg = run_scheduler(PKGS["jax"], mode, tracing)
    tc, jc = census(treg), census(jreg)
    assert set(jc) - set(tc) == BY_DESIGN and set(tc) <= set(jc)
    for name in tc:
        assert tc[name] == jc[name], name
    assert values(treg, COUNTED) == values(jreg, COUNTED)
    got = values(treg, COUNTED)
    assert got["marian_serving_requests_total"] == len(REQUESTS)
    assert got["marian_serving_request_outcomes_total"] == {
        ("ok", "bundle-7"): len(REQUESTS)}
    if mode == "iteration":
        assert got["marian_serving_joins_total"] == 7
        assert all(m["rounds"] >= 1 and m["prefix_hit"] == 0
                   for m in tmeta)
    # the latency exemplars: the request trace ids, with the tracer on
    # too only because the ids are given
    ex = [ln for ln in treg.render(exemplars=True).splitlines()
          if ln.startswith("marian_serving_request_latency_seconds_bucket")
          and "# {" in ln]
    assert {ln.split('trace_id="')[1].split('"')[0] for ln in ex} \
        <= {tid for tid, _ in REQUESTS} and ex


def test_empty_request_counts_as_jax():
    for p in PKGS.values():
        reg = p.msm.Registry()

        async def main():
            sched = p.Scheduler(translate, registry=reg)
            sched.start()
            out = await asyncio.wait_for(sched.submit([]), WAIT)
            await sched.stop()
            return out
        assert asyncio.run(main()) == []
        assert reg.get("marian_serving_requests_total").value == 1
        assert reg.get("marian_serving_request_outcomes_total").labels(
            "ok", "unversioned").value == 1


def poison_and_stall(p, tmp_path):
    """One poison line isolated by bisection, then one stalled batch;
    returns (events, dump reasons, bisections)."""
    p.obs.TRACER.enable()
    p.obs.FLIGHT.arm(str(tmp_path))
    release = threading.Event()

    def fn(lines):
        if "stall" in lines:
            release.wait(WAIT)
        if "poison" in lines:
            raise RuntimeError("poison line")
        return list(lines)
    reg = p.msm.Registry()
    sched = p.Scheduler(fn, registry=reg, window_s=0.005, stall_timeout=0.5)

    async def main():
        sched.start()
        futs = [sched.submit(["ok one"], trace_id="g1"),
                sched.submit(["poison"], trace_id="bad"),
                sched.submit(["ok two"], trace_id="g2")]
        res = await asyncio.wait_for(
            asyncio.gather(*futs, return_exceptions=True), WAIT)
        stalled = await asyncio.wait_for(asyncio.gather(
            sched.submit(["stall"], trace_id="st"), return_exceptions=True),
            WAIT)
        release.set()
        await sched.stop()
        return res, stalled
    try:
        res, stalled = asyncio.run(main())
    finally:
        release.set()
    assert res[0] == ["ok one"] and res[2] == ["ok two"]
    assert isinstance(res[1], RuntimeError)
    assert type(stalled[0]).__name__ == "DispatchStalled"
    deadline = time.time() + WAIT
    while time.time() < deadline and len(
            [f for f in os.listdir(tmp_path) if f.startswith("flight-")]) < 2:
        time.sleep(0.01)
    dumps = sorted(f.split("-")[-1] for f in os.listdir(tmp_path)
                   if f.startswith("flight-"))
    _, events = p.obs.TRACER.snapshot()
    evs = [(e["name"], sorted(e["attrs"])) for e in events]
    return evs, dumps, reg.get(
        "marian_serving_retry_bisections_total").value


def test_poison_and_watchdog_events_and_dumps_match_jax(tmp_path):
    got = poison_and_stall(PKGS["torch"], tmp_path / "t")
    want = poison_and_stall(PKGS["jax"], tmp_path / "j")
    assert got == want
    assert got[1] == ["poison.json", "watchdog.json"]
    assert [n for n, _ in got[0]] == ["serve.poison_isolated",
                                      "serve.watchdog_trip"]


def admission_run(p):
    p.obs.TRACER.enable()
    reg = p.msm.Registry()
    depth = {"n": 3, "pages": 0}
    adm = p.adm.AdmissionController(
        4, lambda: depth["n"], registry=reg, max_queue_pages=10,
        pages_fn=lambda: depth["pages"])
    outcomes = []
    for n, pages in ((1, 0), (2, 0), (1, 20), (1, 2)):
        try:
            adm.admit(n, n_pages=pages)
            outcomes.append("ok")
        except p.adm.Overloaded as e:
            outcomes.append(("shed", e.retriable))
    adm.begin_drain()
    adm.begin_drain()
    try:
        adm.admit(1)
    except p.adm.Overloaded as e:
        outcomes.append(("shed", e.retriable))
    _, events = p.obs.TRACER.snapshot()
    return (outcomes, [(e["name"], e["attrs"]) for e in events],
            values(reg, ("marian_serving_admitted_sentences_total",
                         "marian_serving_shed_total",
                         "marian_serving_queue_limit_sentences")),
            {k: v for k, v in census(reg).items()})


def test_admission_series_and_events_match_jax():
    got, want = admission_run(PKGS["torch"]), admission_run(PKGS["jax"])
    assert got == want
    assert got[2]["marian_serving_shed_total"] == {
        ("queue_full",): 1, ("pages_full",): 1, ("draining",): 1}
    assert [n for n, _ in got[1]].count("admission.drain_started") == 1


def lifecycle_run(p, tmp_path):
    """Pinned and compat rejections, a warmup failure, a swap and its
    manual rollback, a canary that fails and rolls back, a live version
    that fails and rolls back; returns (events, dump reasons, the
    version spans' attributes)."""
    p.obs.TRACER.enable()
    p.obs.FLIGHT.arm(str(tmp_path / "dumps"))
    mp = tmp_path / "m.npz"

    geo_a = p.bdl.compat_block({"type": "transformer", "dim-emb": 16})
    geo_b = p.bdl.compat_block({"type": "transformer", "dim-emb": 32})

    def commit(tag, compat=geo_a):
        def write(path):
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(tag)
        bdir = p.bdl.write_bundle(str(mp), {"m.npz": write}, compat=compat)
        return bdir, p.bdl.validate_bundle(bdir)[2]

    modes = {}

    def factory(bundle_dir, manifest):
        mode = modes.get(manifest["seq"], "ok")
        if mode == "warmup":
            raise RuntimeError("no model")
        calls = {"n": 0}

        def fn(lines):
            calls["n"] += 1
            if mode == "fail" and calls["n"] > 1:
                raise RuntimeError("decode explodes")
            return [f"b{manifest['seq']}:{ln}" for ln in lines]
        return fn
    ctrl = p.lc.SwapController(factory, metrics_registry=p.msm.Registry(),
                               rollback_min_batches=2)
    ctrl.seed_live(0, "boot", translate, compat=geo_a)
    ctrl.pin()
    ctrl.ingest(*commit("pinned"))
    ctrl.unpin()
    ctrl.ingest(*commit("compat", compat=geo_b))
    modes[3] = "warmup"
    ctrl.ingest(*commit("warm"))
    ctrl.ingest(*commit("good"))                     # seq 4: swap
    with p.obs.TRACER.span("serve.translate") as sp:
        ctrl.route(["x"])
    attrs = [dict(sp.attrs)]
    ctrl.rollback()                                  # manual, to boot
    ctrl.canary_fraction = 1.0
    modes[5] = "fail"
    ctrl.ingest(*commit("canary"))                   # seq 5: canary
    with p.obs.TRACER.span("serve.translate") as sp:
        for i in range(4):
            ctrl.route([f"c{i}"])
    attrs.append(dict(sp.attrs))
    ctrl.canary_fraction = 0.0
    modes[6] = "fail"
    ctrl.ingest(*commit("live"))                     # seq 6: swap
    for i in range(4):
        try:
            ctrl.route([f"l{i}"])
        except RuntimeError:
            pass
    _, events = p.obs.TRACER.snapshot()
    dumps = sorted(f.split("-", 4)[-1] for f in
                   os.listdir(tmp_path / "dumps") if f.startswith("flight-"))
    evs = [(e["name"], {k: v for k, v in e["attrs"].items()
                        if k not in ("reason", "error")})
           for e in events]
    return evs, dumps, attrs, ctrl.live_version_name()


def test_lifecycle_events_and_dumps_match_jax(tmp_path):
    got = lifecycle_run(PKGS["torch"], tmp_path / "t")
    want = lifecycle_run(PKGS["jax"], tmp_path / "j")
    assert got == want
    evs, dumps, attrs, live = got
    names = [n for n, _ in evs]
    for n in ("lifecycle.rejected", "lifecycle.warming",
              "lifecycle.warmup_failed", "lifecycle.swap",
              "lifecycle.canary", "lifecycle.rollback",
              "lifecycle.transition"):
        assert n in names, n
    assert [a["kind"] for n, a in evs if n == "lifecycle.rollback"] \
        == ["manual", "canary", "live"]
    assert dumps == ["canary-rollback.json", "live-rollback.json",
                     "manual-rollback.json"]
    assert attrs[0] == {"model_version": "bundle-00000004", "canary": False}
    assert attrs[1]["re_served_after"] == "bundle-00000005"
    assert live == "boot"


def test_prefix_series_census_matches_jax():
    from marian_tpu.translator.prefix_cache import PrefixCache as JCache
    from marian_tpu_torch.translator.prefix_cache import PrefixCache
    jr, tr = jmsm.Registry(), tmsm.Registry()
    JCache(registry=jr)
    PrefixCache()._declare_metrics(tr)
    assert census(tr) == census(jr)
    assert "marian_prefix_hits_total" in census(tr)


TRANSLATE = ("marian_translate_batches_total",
             "marian_translate_sentences_total",
             "marian_translate_batch_fill_ratio")


def test_translator_series_match_jax(model):
    """The request-mode decoder's series: the same census on the
    process-wide registries and the same batch and sentence counts for
    the same lines (the fill ratio's count: one observation a batch)."""
    from marian_tpu.common.config_parser import parse_options as jparse
    from marian_tpu.translator.translator import Translate as JTranslate
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.translator.translator import Translate
    path, vocab = model
    argv = ["--models", path, "--vocabs", vocab, vocab, "--beam-size", "2",
            "--mini-batch", "2", "--max-length", "16", "--quiet"]
    lines = ["w3 w4 w5", "w6 w7", "w8 w9 w10 w11", "w2 w3", "w12"]
    counts = []
    for msm, tr in ((jmsm, JTranslate(jparse(argv, mode="translation"))),
                    (tmsm, Translate(parse_options(
                        argv + ["--cpu-threads", "1"], mode="translation")))):
        before = values(msm.REGISTRY, TRANSLATE)
        tr.run(lines=lines, stream=open(os.devnull, "w"))
        after = values(msm.REGISTRY, TRANSLATE)
        counts.append({k: after[k] - before.get(k, 0) for k in after})
        counts.append({k: v for k, v in census(msm.REGISTRY).items()
                       if k in TRANSLATE})
    assert counts[2:] == counts[:2]
    assert counts[0] == dict(zip(TRANSLATE, (3, 5, 3)))


class RaisingLock:
    def __enter__(self):
        raise AssertionError("lock acquired on the disabled-plane path")

    def __exit__(self, *exc):
        pass

    def acquire(self, *a, **kw):
        raise AssertionError("lock acquired on the disabled-plane path")

    def release(self):
        pass


@pytest.mark.parametrize("mode", ["request", "iteration"])
def test_disabled_planes_take_no_lock_on_the_batch_path(mode):
    """The reference's overhead guard, ported: tracer off, perf plane
    off, no SLO engine: the per-batch (per-round) path acquires neither
    the tracer's nor the perf meter's lock, records nothing and
    allocates no ring."""
    assert not tobs.enabled() and not tobs.PERF.enabled
    saved = tobs.TRACER._lock, tobs.PERF._lock
    tobs.TRACER._lock = RaisingLock()
    tobs.PERF._lock = RaisingLock()
    try:
        out, metas, reg = run_scheduler(PKGS["torch"], mode, tracing=False)
    finally:
        tobs.TRACER._lock, tobs.PERF._lock = saved
    assert out[0] == ["A B C", "D E"] or out[0][0].startswith("E:")
    assert tobs.TRACER._ring is None and tobs.TRACER._events is None
    assert reg.get("marian_serving_requests_total").value == len(REQUESTS)
