"""The port's metrics registry and HTTP port (``serving/metrics.py``)
against the JAX package's ``marian_tpu/serving/metrics.py``, on the CPU:

- the same counters, gauges (``set_function`` too) and histograms
  (exemplars too) with the same values render the same Prometheus text,
  label escaping and number formatting included; the get-or-create
  semantics and their type check agree;
- ``MetricsServer`` (port 0) answers ``/metrics`` (with the process
  self-metrics), ``/healthz``, ``/readyz`` (503 while ``ready_fn`` says
  no), 404 elsewhere, and a raising route is a 500, not a dead thread;
- the server's ``--metrics-port`` wiring (``ServingApp.start`` through
  ``maybe_start_metrics_server``, bound to port 0 here) answers
  ``/metrics``, ``/healthz``, ``/readyz`` (503 before start, 200 while
  serving, 503 while draining), ``/lifecyclez`` and the three admin
  verbs over HTTP, and scrapes the app's registry;
- a dispatch-watchdog trip increments
  ``marian_serving_watchdog_trips_total`` in both packages alike.

Every server binds port 0 and every wait has a deadline.
"""

import asyncio
import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving.scheduler import (ContinuousScheduler,
                                                DispatchStalled)

WAIT = 20.0
EXEMPLAR_TS = re.compile(r"(# \{trace_id=\"[^\"]*\"\} \S+) \d+\.\d+")


def populate(msm):
    r = msm.Registry()
    c = r.counter("app_requests_total", "Requests, by outcome",
                  labels=("outcome", "model_version"))
    c.labels("ok", "bundle-00000001").inc()
    c.labels("ok", "bundle-00000001").inc(2.5)
    c.labels("failure", 'a "quoted"\\path\nline').inc()
    r.counter("app_plain_total", "No labels").inc(3)
    g = r.gauge("app_depth", "A gauge")
    g.set(7)
    g.dec(2)
    g.inc(0.25)
    r.gauge("app_fn", "Sampled").set_function(lambda: 42)
    r.gauge("app_nan", "Raising sampler").set_function(
        lambda: 1 / 0)
    h = r.histogram("app_latency_seconds", "Latency",
                    labels=("model_version",))
    for v, tid in ((0.0004, "t1"), (0.03, None), (0.3, "t3"), (99.0, "t4"),
                   (1e-9, None)):
        h.labels("b1").observe(v, trace_id=tid)
    hr = r.histogram("app_fill_ratio", "Ratio",
                     buckets=msm.RATIO_BUCKETS)
    hr.observe(0.5)
    hr.observe(1.0)
    hr.observe(1e16)
    return r


def test_same_exposition_text():
    j, t = populate(jmsm), populate(tmsm)
    assert t.render() == j.render()
    # exemplars carry the observation's wall time: equal up to it
    assert EXEMPLAR_TS.sub(r"\1", t.render(exemplars=True)) \
        == EXEMPLAR_TS.sub(r"\1", j.render(exemplars=True))
    text = t.render(exemplars=True)
    assert '# {trace_id="t3"} 0.3' in text
    assert 'app_fn 42' in text and "app_nan nan" in text


@pytest.mark.parametrize("msm", [jmsm, tmsm], ids=["jax", "torch"])
def test_get_or_create_and_type_check(msm):
    r = msm.Registry()
    a = r.counter("x_total", "first")
    assert r.counter("x_total", "second") is a
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("x_total")
    with pytest.raises(ValueError, match="counters only go up"):
        a.inc(-1)
    with pytest.raises(ValueError, match="expected labels"):
        r.counter("y_total", labels=("a",)).labels("1", "2")
    assert r.get("nope") is None
    assert a.children() == {}


def get(base, path, method="GET"):
    req = urllib.request.Request(base + path, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as fh:
            return fh.status, fh.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_endpoints():
    r = tmsm.Registry()
    r.counter("app_total", "A counter").inc()
    ready = {"ok": False}

    def boom(method, query):
        raise RuntimeError("handler bug")

    srv = tmsm.MetricsServer(0, registry=r, ready_fn=lambda: ready["ok"],
                             host="127.0.0.1",
                             routes={"/boom": boom}).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, body = get(base, "/metrics")
        assert code == 200 and "app_total 1" in body
        for name in ("process_start_time_seconds", "process_uptime_seconds",
                     "process_resident_memory_bytes", "process_open_fds"):
            assert f"# TYPE {name} gauge" in body, name
        assert get(base, "/healthz") == (200, "ok\n")
        assert get(base, "/readyz") == (503, "not ready\n")
        ready["ok"] = True
        assert get(base, "/readyz") == (200, "ready\n")
        assert get(base, "/nope")[0] == 404
        assert get(base, "/nope", "POST")[0] == 404
        assert get(base, "/boom") == (500, "error: handler bug\n")
        assert get(base, "/healthz")[0] == 200      # still serving
    finally:
        srv.close()


def test_maybe_start_is_off_at_port_zero():
    assert tmsm.maybe_start_metrics_server(Options({"metrics-port": 0})) \
        is None


def test_server_metrics_port_and_admin_verbs(tmp_path, monkeypatch):
    """--metrics-port through ServingApp.start, with --model-watch: the
    port is bound to 0 (the maybe_start path, with the port replaced)."""
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.training import bundle as tbdl
    real = tmsm.MetricsServer
    monkeypatch.setattr(tmsm, "MetricsServer",
                        lambda port, **kw: real(0, host="127.0.0.1", **kw))
    mp = tmp_path / "m.npz"

    def commit(tag):
        def write(p):
            with open(p, "w", encoding="utf-8") as fh:
                fh.write(tag)
        return tbdl.write_bundle(str(mp), {"m.npz": write})

    def factory(bundle_dir, manifest):
        return lambda lines: [f"b{manifest['seq']}:{ln}" for ln in lines]

    reg = tmsm.Registry()
    app = ServingApp(Options({
        "batch-token-budget": 256, "max-queue": 512, "metrics-port": 9,
        "models": [str(mp)], "model-watch": 3600.0}),
        translate_lines=lambda lines: [f"v1:{ln}" for ln in lines],
        registry=reg, executor_factory=factory)

    async def scenario():
        loop = asyncio.get_event_loop()
        assert not app.ready()
        app.start()
        app.watcher.stop()              # driven below with poll_now()
        base = f"http://127.0.0.1:{app.metrics_server.port}"

        async def call(path, method="GET"):
            return await loop.run_in_executor(None, get, base, path, method)
        try:
            assert await call("/readyz") == (200, "ready\n")
            assert (await call("/healthz"))[0] == 200
            assert await app.handle_frame("s") == "v1:s"
            code, body = await call("/metrics")
            assert code == 200
            assert ('marian_serving_request_outcomes_total{outcome="ok",'
                    'model_version="boot"} 1') in body
            assert 'marian_model_info{model_version="boot",' \
                'bundle_seq="0",compat_hash=' in body
            code, body = await call("/lifecyclez")
            assert code == 200 and json.loads(body)["live"] == "boot"
            commit("one")
            assert app.watcher.poll_now() is not None
            assert await app.handle_frame("s") == "b1:s"
            for verb, live in (("pin", "bundle-00000001"),
                               ("unpin", "bundle-00000001"),
                               ("rollback", "boot")):
                code, body = await call(f"/admin/{verb}", "POST")
                assert code == 200, (verb, body)
                assert json.loads(body) == {"ok": True, "verb": verb,
                                            "live": live}
            assert await app.handle_frame("s") == "v1:s"
            code, body = await call("/metrics")
            assert "marian_lifecycle_rollbacks_total 1" in body
            assert "marian_lifecycle_swaps_total 1" in body
            app.admission.begin_drain()
            assert (await call("/readyz"))[0] == 503
        finally:
            await app.shutdown(drain_timeout=2.0)
        assert app.metrics_server is None and app.watcher is None

    asyncio.run(scenario())


def _one_trip(sched_cls, msm, **kw):
    release = threading.Event()

    def translate(lines):
        if lines == ["stall"]:
            release.wait(WAIT)
        return list(lines)

    reg = msm.Registry()
    sched = sched_cls(translate, window_s=0, stall_timeout=0.1, registry=reg,
                      **kw)

    async def scenario():
        sched.start()
        try:
            with pytest.raises(Exception) as ei:
                await asyncio.wait_for(sched.submit(["stall"]), WAIT)
            after = await asyncio.wait_for(sched.submit(["after"]), WAIT)
            return type(ei.value).__name__, after
        finally:
            release.set()
            await sched.stop()
    try:
        got = asyncio.run(scenario())
    finally:
        release.set()
    text = reg.render()
    trips = reg.get("marian_serving_watchdog_trips_total").value
    stalled = reg.get("marian_serving_request_outcomes_total").labels(
        "stalled", "unversioned").value
    return got, trips, stalled, [l for l in text.splitlines()
                                 if "watchdog" in l]


def test_watchdog_trip_counts_in_both_packages():
    port = _one_trip(ContinuousScheduler, tmsm)
    ref = _one_trip(JScheduler, jmsm)
    assert port == ref
    (name, after), trips, stalled, lines = port
    assert name == DispatchStalled.__name__ and after == ["after"]
    assert trips == 1 and stalled == 1
    assert "marian_serving_watchdog_trips_total 1" in lines
