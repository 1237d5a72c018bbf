"""The port's span tracer and flight recorder (``obs/trace.py``,
``obs/flight.py``, ``obs/__init__.py``) and the server's ``#trace:``
protocol against the JAX package's, on the CPU:

- the same calls into both packages' ``Tracer`` give the same Chrome
  trace events (``/tracez`` too, with ``last=N``), up to span ids and
  timestamps: names, categories, phases, threads, trace ids, parent
  edges and attributes;
- off (the default) the tracer allocates no ring and takes no lock;
  the ring is bounded, ``end`` is idempotent, an exception lands as the
  ``error`` attribute;
- the same trip of both packages' ``FlightRecorder`` writes the same
  dump members (the ``faultpoints`` member too), the same file
  name shape and the same ``marian_flight_dumps_total`` count; a
  disarmed trip writes nothing;
- ``obs.configure`` reads the same flags and environment variables;
- the port's header split agrees with
  ``marian_tpu.server.server.split_trace_header`` on well-formed and
  malformed frames, and stacks ``#trace``, ``#model``, ``#priority``,
  ``#stream`` in the reference's order;
- end to end over TCP (request mode, a stub translate): a ``#trace:``
  request gets its metadata line before its body (a plain request the
  old protocol), its span tree lands in ``/tracez`` on the metrics port,
  ``/poolz`` answers ``enabled: false`` and ``/sloz`` both objectives.

Every server binds port 0 and every wait has a deadline.
"""

import asyncio
import json
import os
import urllib.request

import pytest

from marian_tpu import obs as jobs
from marian_tpu.common import faultpoints as jfp
from marian_tpu.obs import flight as jflight
from marian_tpu.obs.trace import Tracer as JTracer
from marian_tpu.obs.trace import trace_routes as jtrace_routes
from marian_tpu.server.server import split_trace_header as jsplit
from marian_tpu.serving import metrics as jmsm
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.common import faultpoints as tfp
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.obs import flight as tflight
from marian_tpu_torch.obs.trace import NOOP_SPAN, Tracer
from marian_tpu_torch.obs.trace import trace_routes as ttrace_routes
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.serving import metrics as tmsm

WAIT = 20.0


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    for o in (jobs, tobs):
        o.TRACER.reset()
        # a --trace-ring a test set outlives reset()
        o.TRACER.capacity = tobs.trace.DEFAULT_RING
        o.FLIGHT.disarm()
        o.PERF.reset()


class RaisingLock:
    """Acquiring it fails the test: a lock touch on a path that must be
    lock-free is loud."""

    def __enter__(self):
        raise AssertionError("lock acquired on the disabled-tracer path")

    def __exit__(self, *exc):
        pass

    def acquire(self, *a, **kw):
        raise AssertionError("lock acquired on the disabled-tracer path")

    def release(self):
        pass


def drive(t, boom=True):
    """One fixed sequence of tracer calls (given trace ids only, so the
    two packages' documents can be compared)."""
    t.enable()
    with t.span("serve.request", trace_id="t1", n_sentences=2) as root:
        with t.span("serve.queue", n_sentences=2):
            t.event("admission.shed", reason="queue_full", units=2)
            t.set_attrs(model_version="v1")
        sp = t.start_span("serve.dispatch", parent=root, rows=3)
        with t.use(sp):
            t.event("prefix.hit", kind="replay")
        t.end(sp, outcome="ok")
        t.end(sp, outcome="late")            # idempotent
    t.record("reply.write", 1.0, 1.5, trace_id="t2", nbytes=12)
    if boom:
        with pytest.raises(ValueError):
            with t.span("serve.batch", trace_id="t3"):
                raise ValueError("bad batch")
    t.event("quiesce.begin", rows=0)


def normalized(doc):
    """A Chrome trace document without ids, timestamps and pid: parent
    edges by parent name."""
    names = {e["args"]["span_id"]: e["name"] for e in doc["traceEvents"]
             if e["ph"] == "X"}
    out = []
    for e in doc["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
        args = dict(e.pop("args"))
        args.pop("span_id", None)
        if "parent_id" in args:
            args["parent"] = names[args.pop("parent_id")]
        out.append((json.dumps(e, sort_keys=True),
                    json.dumps(args, sort_keys=True)))
    return out, {k: v for k, v in doc.items() if k != "traceEvents"}


def test_chrome_trace_matches_jax():
    jt, tt = JTracer(), Tracer()
    drive(jt)
    drive(tt)
    assert normalized(tt.chrome_trace()) == normalized(jt.chrome_trace())
    doc = tt.chrome_trace()
    assert {e["name"] for e in doc["traceEvents"]} == {
        "serve.request", "serve.queue", "serve.dispatch", "reply.write",
        "serve.batch", "admission.shed", "prefix.hit", "quiesce.begin"}
    batch = next(e for e in doc["traceEvents"] if e["name"] == "serve.batch")
    assert "bad batch" in batch["args"]["error"]
    disp = next(e for e in doc["traceEvents"]
                if e["name"] == "serve.dispatch")
    assert disp["args"]["outcome"] == "ok"      # the second end was a no-op
    assert json.loads(json.dumps(doc)) == doc   # JSON-ready
    for last in (0, 1, 3, None):
        assert normalized(tt.chrome_trace(last)) \
            == normalized(jt.chrome_trace(last))


@pytest.mark.parametrize("query", ["", "last=2", "last=0", "last=abc",
                                   "last=-4"])
def test_tracez_route_matches_jax(query):
    for o, t in ((jobs, JTracer), (tobs, Tracer)):
        o.TRACER.reset()
    drive(jobs.TRACER, boom=False)
    drive(tobs.TRACER, boom=False)
    got = ttrace_routes()["/tracez"]("GET", query)
    want = jtrace_routes()["/tracez"]("GET", query)
    assert got[0] == want[0] == 200 and got[2] == want[2]
    assert normalized(json.loads(got[1])) == normalized(json.loads(want[1]))


def test_disabled_tracer_is_free():
    t = Tracer()
    assert t._ring is None and t._events is None
    t._lock = RaisingLock()
    sp = t.start_span("x", a=1)
    assert sp is NOOP_SPAN and not sp
    t.end(sp)
    t.event("e", k=1)
    t.record("r", 0.0, 1.0)
    with t.span("y") as sp2:
        assert sp2 is NOOP_SPAN
        t.set_attrs(z=1)
    assert t.current() is None
    assert t._ring is None and t._events is None


def test_ring_is_bounded_and_parent_crosses_threads():
    import threading
    t = Tracer(capacity=4)
    t.enable()
    for i in range(10):
        t.end(t.start_span(f"s{i}"))
    spans, _ = t.snapshot()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
    root = t.start_span("root", trace_id="tx")
    got = {}

    def worker():
        child = t.start_span("child", parent=root)
        got["child"] = (child.trace_id, child.parent_id, child.thread)
        t.end(child)
    th = threading.Thread(target=worker, name="serve-device_0")
    th.start()
    th.join(WAIT)
    assert got["child"] == ("tx", root.span_id, "serve-device_0")
    t.reset()
    assert t._ring is None and not t.enabled


def dump_of(d):
    files = sorted(f for f in os.listdir(d) if f.startswith("flight-"))
    assert len(files) == 1, files
    with open(os.path.join(d, files[0]), encoding="utf-8") as fh:
        return files[0], json.load(fh)


def test_flight_dump_matches_jax(tmp_path):
    # the fault points' hit counters are process-wide: earlier tests in
    # this process crossed the serving points of one package or the other
    jfp.reset_for_tests()
    tfp.reset_for_tests()
    out = {}
    for name, o, rec_cls, msm in (
            ("jax", jobs, jflight.FlightRecorder, jmsm),
            ("torch", tobs, tflight.FlightRecorder, tmsm)):
        drive(o.TRACER, boom=False)
        rec = rec_cls()
        assert rec.trip("early") is None           # disarmed: nothing
        rec.arm(str(tmp_path / name))
        assert rec.armed
        rec.add_snapshot_provider("slo", lambda: {"objectives": {"a": 1}})
        rec.add_snapshot_provider("broken", lambda: 1 / 0)
        rec.add_snapshot_provider("gone", lambda: 0)
        rec.remove_snapshot_provider("gone")
        before = msm.REGISTRY.counter(
            "marian_flight_dumps_total", "", labels=("reason",)
        ).labels("watchdog").value
        path = rec.trip("watchdog", trace_id="t1", detail="batch stalled",
                        extra={"traces": ["t1"]})
        assert path is not None and os.path.exists(path)
        after = msm.REGISTRY.get("marian_flight_dumps_total").labels(
            "watchdog").value
        fname, payload = dump_of(tmp_path / name)
        out[name] = (fname, payload, after - before)
        rec.disarm()
        assert rec.trip("late") is None
    (jname, jpay, jn), (tname, tpay, tn) = out["jax"], out["torch"]
    assert jn == tn == 1
    strip = lambda f: f.split("-", 3)[-1]          # noqa: E731
    assert strip(tname) == strip(jname) == "001-watchdog.json"
    assert set(tpay) == set(jpay)
    for key in ("reason", "detail", "trace_id", "seq", "thread", "extra",
                "slo", "faultpoints"):
        assert tpay[key] == jpay[key], key
    assert tpay["broken"].startswith("unavailable: ") \
        and jpay["broken"].startswith("unavailable: ")
    assert normalized(tpay["trace"]) == normalized(jpay["trace"])
    assert "marian_flight_dumps_total" in tpay["metrics"]


def test_trip_async_writes_from_a_thread(tmp_path):
    import time
    rec = tflight.FlightRecorder()
    rec.trip_async("disarmed")                    # a no-op
    rec.arm(str(tmp_path))
    rec.trip_async("pool-audit", detail="x")
    deadline = time.time() + WAIT
    while time.time() < deadline and not any(
            f.startswith("flight-") for f in os.listdir(tmp_path)):
        time.sleep(0.01)
    fname, payload = dump_of(tmp_path)
    assert fname.endswith("-pool-audit.json")
    assert payload["thread"] == "flight-dump"
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("opts,env", [
    ({}, {}),
    ({"trace": True, "trace-ring": 16}, {}),
    ({"trace-dump": "DUMP"}, {}),
    ({"perf-accounting": True}, {}),
    ({}, {"MARIAN_TRACE": "1"}),
    ({}, {"MARIAN_TRACE_DUMP": "DUMP"}),
    ({}, {"MARIAN_PERF": "1"}),
])
def test_configure_matches_jax(opts, env, tmp_path, monkeypatch):
    from marian_tpu.common import Options as JOptions
    for k in ("MARIAN_TRACE", "MARIAN_TRACE_DUMP", "MARIAN_PERF"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(tmp_path / v) if v == "DUMP" else v)
    opts = {k: (str(tmp_path / v) if v == "DUMP" else v)
            for k, v in opts.items()}
    states = []
    for o, options in ((jobs, JOptions(dict(opts))),
                       (tobs, Options(dict(opts)))):
        on = o.configure(options)
        states.append((on, o.TRACER.enabled, o.TRACER.capacity,
                       o.FLIGHT.armed, o.PERF.enabled))
        o.FLIGHT.remove_snapshot_provider("perf")
    assert states[1] == states[0]


FRAMES = [
    "#trace:abc\nhello", "#trace:abc", "#trace:\nx", "#trace:" + "a" * 64
    + "\nx", "#trace:" + "a" * 65 + "\nx", "#trace:a b\nx",
    "#trace:ab$c\nx", "#trace: abc \nx", "#trace:é1\nx", "hello",
    "#priority:3\n#trace:x\ny", "#trace:a_b-c\n#priority:2\nz",
    "#TRACE:x\ny", "#trace:x\n", "#trace:x\n\nb", "", "#trace:0f3a\nl1\nl2",
]


@pytest.mark.parametrize("frame", FRAMES)
def test_header_split_matches_jax(frame):
    assert srv.split_trace_header(frame) == jsplit(frame)


def test_headers_stack_in_the_reference_order():
    assert srv.split_headers("#trace:t1\n#model:m.1\n#priority:12\n"
                             "#stream:1\na\nb") \
        == ("t1", "m.1", 9, True, "a\nb")
    # out of order, a later header is payload
    assert srv.split_headers("#priority:1\n#trace:t1\nx") \
        == (None, None, 1, None, "#trace:t1\nx")


def get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as fh:
        return fh.status, fh.read().decode()


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


def test_trace_request_over_tcp(monkeypatch):
    real = tmsm.MetricsServer
    monkeypatch.setattr(tmsm, "MetricsServer",
                        lambda port, **kw: real(0, host="127.0.0.1", **kw))
    reg = tmsm.Registry()
    app = srv.ServingApp(Options({
        "batch-token-budget": 256, "max-queue": 512, "metrics-port": 9,
        "trace": True, "slo-availability": 0.999, "slo-p99-ms": 5000.0}),
        translate_lines=lambda lines: [ln.upper() for ln in lines],
        registry=reg)

    async def scenario():
        loop = asyncio.get_event_loop()
        app.start()
        server = await asyncio.start_server(srv._make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{app.metrics_server.port}"
        try:
            traced = await tcp_request(port, "#trace:req-1\nab c\nd")
            plain = await tcp_request(port, "ef")
            malformed = await tcp_request(port, "#trace:a$b\nx")
            pages = await loop.run_in_executor(None, get, base + "/poolz")
            slo = await loop.run_in_executor(None, get, base + "/sloz")
            tz = await loop.run_in_executor(None, get, base + "/tracez")
            return traced, plain, malformed, pages, slo, tz
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown(drain_timeout=2.0)
    traced, plain, malformed, pages, slo, tz = asyncio.run(scenario())
    head, body = traced.split("\n", 1)
    assert body == "AB C\nD" and plain == "EF"
    assert malformed == "#TRACE:A$B\nX"          # payload, not a header
    fields = dict(kv.split("=") for kv in head.split()[1:])
    assert head.startswith("#trace:req-1 ")
    assert fields["outcome"] == "ok" and fields["model_version"] \
        == "unversioned"
    assert float(fields["queue_ms"]) >= 0 and float(fields["service_ms"]) > 0
    assert pages[0] == 200 and json.loads(pages[1])["enabled"] is False
    sloz = json.loads(slo[1])
    assert set(sloz["slo"]["objectives"]) == {"availability", "latency_p99"}
    assert sloz["brownout"] == {"enabled": False}
    spans = [e for e in json.loads(tz[1])["traceEvents"]
             if e["ph"] == "X" and e["args"]["trace_id"] == "req-1"]
    names = {e["args"]["span_id"]: e["name"] for e in spans}
    edges = {(e["name"], names.get(e["args"].get("parent_id"), ""))
             for e in spans}
    assert edges == {("request", ""), ("serve.queue", "request"),
                     ("serve.dispatch", "request"),
                     ("reply.write", "request")}
    root = next(e for e in spans if e["name"] == "request")
    assert root["args"]["outcome"] == "ok"
    assert reg.get("marian_serving_requests_total").value == 3
