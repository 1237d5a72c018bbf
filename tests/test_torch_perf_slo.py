"""The port's perf plane (``obs/perf.py``, ``common/flops.py``) and SLO
engine (``obs/slo.py``) against the JAX package's, on the CPU:

- ``SloEngine``, fed the same outcomes and latencies under an injected
  clock, gives the same burn rates, budgets, alert edges, timeline
  events, ``marian_slo_*`` series and ``/sloz`` document, and the same
  ``slo-fast-burn`` flight dump; ``maybe_build_engine`` reads the same
  flags; the evaluator thread starts and stops;
- ``PerfMeter``, fed the same ``record_batch`` sequence with the same
  peak under an injected clock, gives the same counters and gauges
  (chip-seconds per token, tokens/s, busy ratio, MFU, headroom with and
  without a queue bound) and the same ``state()`` but for the
  reference's compile-telemetry members; its series carry the
  reference's names, types and labels (HELP too, but where the port
  names its device and dtype peak);
- ``flops``'s cost functions (a train step, a served batch) agree on a
  grid of geometries, and the peak
  tables give the H100's data-sheet numbers for its CUDA names, the
  compute dtype's peak, and None for other devices;
- both packages' schedulers report the same rows and tokens to the perf
  plane in request mode, and the server wires the plane's queue inputs
  (sentences or pages) and the geometry of its model, and unwires them
  at close.

Every wait has a deadline.
"""

import asyncio
import itertools
import json
import os
import time

import pytest

from marian_tpu import obs as jobs
from marian_tpu.common import Options as JOptions
from marian_tpu.common import flops as jflops
from marian_tpu.obs.perf import PerfMeter as JPerf
from marian_tpu.obs.slo import SloEngine as JSlo
from marian_tpu.obs.slo import maybe_build_engine as jbuild
from marian_tpu.obs.slo import slo_routes as jslo_routes
from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.common import flops
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.obs.perf import PerfMeter
from marian_tpu_torch.obs.slo import SloEngine, maybe_build_engine, slo_routes
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving.scheduler import ContinuousScheduler

WAIT = 20.0
H100 = "NVIDIA H100 80GB HBM3"
# perf series whose HELP names the port's device and dtype peak
HELP_BY_DESIGN = {"marian_perf_devices", "marian_perf_roofline_peak_flops",
                  "marian_perf_mfu", "marian_perf_chip_seconds_per_token",
                  "marian_capacity_headroom_ratio"}
# the reference's series the port has no counterpart for (jax.monitoring)
SERIES_BY_DESIGN = {"marian_compile_backend_seconds_total"}


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    for o in (jobs, tobs):
        o.TRACER.reset()
        o.FLIGHT.disarm()
        o.PERF.reset()


def slo_run(slo_cls, msm, routes, tracer, **kw):
    """One scripted history through an engine: baseline, a clean window,
    a burst of failures and slow requests, recovery. Returns the tick
    states, the /sloz document, the series text and the events."""
    r = msm.Registry()
    out = r.counter("marian_serving_request_outcomes_total", "",
                    labels=("outcome", "model_version"))
    lat = r.histogram("marian_serving_request_latency_seconds", "")
    clock = {"t": 0.0}
    eng = slo_cls(registry=r, availability=0.99, p99_ms=250, window_s=10,
                  clock=lambda: clock["t"], **kw)
    tracer.enable()
    states = [eng.tick(now=0.0)]
    script = [(1.0, {"ok": 99, "failure": 1}, [0.05] * 99 + [0.5]),
              (5.0, {"ok": 50, "cancelled": 5, "evicted": 3}, [0.01] * 50),
              (8.0, {"failure": 40, "timeout": 5, "stalled": 5},
               [2.0] * 20),
              (12.0, {"ok": 500}, [0.02] * 500),
              (30.0, {"ok": 1000}, [0.02] * 1000),
              (200.0, {"ok": 10}, [0.02] * 10)]
    for t, outcomes, lats in script:
        for k, n in outcomes.items():
            out.labels(k, "v").inc(n)
        for v in lats:
            lat.observe(v)
        clock["t"] = t
        states.append(eng.tick(now=t))
    clock["t"] = 201.0
    sloz = json.loads(routes(lambda: eng)["/sloz"]("GET", "")[1])
    _, events = tracer.snapshot()
    text = "\n".join(l for l in r.render().splitlines()
                     if l.startswith("marian_slo"))
    return (states, sloz, text,
            [(e["name"], e["attrs"]) for e in events], eng)


def test_slo_engine_matches_jax():
    got = slo_run(SloEngine, tmsm, slo_routes, tobs.TRACER)
    want = slo_run(JSlo, jmsm, jslo_routes, jobs.TRACER)
    assert got[:4] == want[:4]
    states, sloz, text, events, eng = got
    burst = states[3]["objectives"]
    assert burst["availability"]["fast_burn"]
    assert burst["latency_p99"]["burn"]["10s"] > 1
    assert [n for n, _ in events].count("slo.fast_burn") == 1
    assert "slo.recovered" in [n for n, _ in events]
    assert sloz["slo"]["alerting"] and sloz["perf"] == {"enabled": False}
    assert sloz["brownout"] == {"enabled": False}
    assert 'marian_slo_alerts_total{objective="availability",' \
        'severity="fast"} 1' in text


def test_fast_burn_flight_dump_matches_jax(tmp_path):
    dumps = []
    for slo_cls, msm, o, d in ((JSlo, jmsm, jobs, tmp_path / "j"),
                               (SloEngine, tmsm, tobs, tmp_path / "t")):
        o.FLIGHT.arm(str(d))
        r = msm.Registry()
        c = r.counter("marian_serving_request_outcomes_total", "",
                      labels=("outcome", "model_version"))
        eng = slo_cls(registry=r, availability=0.999, window_s=10,
                      clock=lambda: 0.0)
        o.FLIGHT.add_snapshot_provider("slo", eng.state)
        try:
            eng.tick(now=0.0)
            c.labels("failure", "v").inc(50)
            eng.tick(now=1.0)
            deadline = time.time() + WAIT
            while time.time() < deadline and not any(
                    f.startswith("flight-") for f in os.listdir(d)):
                time.sleep(0.01)
            time.sleep(0.1)
            (name,) = [f for f in os.listdir(d) if f.startswith("flight-")]
            with open(d / name, encoding="utf-8") as fh:
                dumps.append((name.split("-", 4)[-1], json.load(fh)))
        finally:
            o.FLIGHT.remove_snapshot_provider("slo")
    (jn, jp), (tn, tp) = dumps
    assert tn == jn == "slo-fast-burn.json"
    assert tp["extra"] == jp["extra"] and tp["detail"] == jp["detail"]
    for key in ("slo",):
        a, b = dict(tp[key]), dict(jp[key])
        assert a == b


@pytest.mark.parametrize("opts", [
    {}, {"slo-availability": 0.999}, {"slo-p99-ms": 100, "slo-window": 5},
    {"slo-availability": 0.99, "slo-p99-ms": 250, "slo-eval-interval": 0.5},
])
def test_maybe_build_engine_matches_jax(opts):
    got = maybe_build_engine(Options(dict(opts)), registry=tmsm.Registry())
    want = jbuild(JOptions(dict(opts)), registry=jmsm.Registry())
    assert (got is None) == (want is None)
    if got is not None:
        assert [(o.name, o.target, o.description) for o in got.objectives] \
            == [(o.name, o.target, o.description) for o in want.objectives]
        assert (got.window_s, got.eval_interval) \
            == (want.window_s, want.eval_interval)
    with pytest.raises(ValueError):
        SloEngine(registry=tmsm.Registry())


def test_evaluator_thread_starts_and_stops():
    eng = SloEngine(registry=tmsm.Registry(), availability=0.9,
                    eval_interval=0.05)
    eng.start()
    deadline = time.time() + WAIT
    while time.time() < deadline and eng.state()["uptime_s"] <= 0.1:
        time.sleep(0.02)
    assert eng._thread is not None and eng._thread.name == "slo-eval"
    eng.stop()
    assert eng._thread is None


def census(reg):
    return {name: (m.kind, tuple(m.label_names), m.help)
            for name, m in reg._metrics.items()}


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


BATCHES = [("v1", 8, 16, 60, 70, 0.25), ("v1", 4, 32, 90, 100, 0.5),
           ("v2", 16, 8, 40, 48, 0.125), ("v1", 2, 64, 100, 90, 1.0),
           ("v2", 8, 16, 64, 64, 0.75)]


def perf_run(cls, msm, clock, monkeypatch, peak, bounded):
    monkeypatch.setattr(time, "perf_counter", clock)
    r = msm.Registry()
    m = cls()
    if cls is JPerf:
        m.enable(registry=r, hook_jax=False)
    else:
        m.enable(registry=r)
    m.set_geometry(emb=512, ffn=2048, enc_depth=6, dec_depth=6, vocab=32000,
                   beam=6, n_devices=1, peak_flops=peak)
    depth = {"n": 12}
    m.set_capacity_inputs(lambda: depth["n"], 48 if bounded else 0)
    readings = []
    for ver, rows, width, src, trg, dev in BATCHES:
        clock.t += 2.0
        m.record_batch(ver, rows=rows, width=width, src_tokens=src,
                       trg_tokens=trg, device_s=dev)
        readings.append(sorted(
            (ln for ln in r.render().splitlines()
             if ln.startswith(("marian_perf", "marian_capacity"))
             and not ln.startswith("#")), key=str))
    clock.t += 100.0                       # the window ages out
    readings.append(sorted(ln for ln in r.render().splitlines()
                           if ln.startswith(("marian_perf_device_busy",
                                             "marian_capacity"))))
    state = m.state()
    for key in ("warmed_buckets", "steady_state_recompiles"):
        state.pop(key, None)
    return readings, state, census(r)


@pytest.mark.parametrize("peak", [None, 989e12])
@pytest.mark.parametrize("bounded", [False, True])
def test_perf_meter_matches_jax(monkeypatch, peak, bounded):
    got = perf_run(PerfMeter, tmsm, FakeClock(), monkeypatch, peak, bounded)
    want = perf_run(JPerf, jmsm, FakeClock(), monkeypatch, peak, bounded)
    assert got[0] == want[0]
    assert got[1] == want[1]
    tc, jc = got[2], want[2]
    assert set(jc) - set(tc) == SERIES_BY_DESIGN and set(tc) <= set(jc)
    for name in tc:
        assert tc[name][:2] == jc[name][:2], name
        if name not in HELP_BY_DESIGN:
            assert tc[name][2] == jc[name][2], name
    mfu = [ln for ln in got[0][-2] if ln.startswith("marian_perf_mfu")]
    if peak:
        assert all(0 < float(ln.split()[-1]) < 1 for ln in mfu)
    else:
        assert all(float(ln.split()[-1]) == 0 for ln in mfu)
    # idle: busy decays to 0, headroom back to 1 less queue pressure
    assert "marian_perf_device_busy_ratio 0" in got[0][-1]


def test_disabled_meter_records_nothing():
    m = PerfMeter()
    m.record_batch("v", rows=1, width=8, src_tokens=4, trg_tokens=4,
                   device_s=0.1)
    assert m.state() == {"enabled": False} and not m._window


GRID = list(itertools.product((256, 512, 1024), (1024, 4096), (1, 6),
                              (2, 6), (8000, 32000), (1, 6)))


@pytest.mark.parametrize("emb,ffn,enc,dec,vocab,beam", GRID[::3])
def test_flops_cost_functions_match_jax(emb, ffn, enc, dec, vocab, beam):
    for src, trg, sw, tw in ((100, 120, 32, 48), (7, 3, 8, 8)):
        assert flops.transformer_train_flops(emb, ffn, enc, dec, vocab,
                                             src, trg, sw, tw) \
            == jflops.transformer_train_flops(emb, ffn, enc, dec, vocab,
                                              src, trg, sw, tw)
        assert flops.transformer_serve_flops(emb, ffn, enc, dec, vocab,
                                             src, trg, sw, tw, beam) \
            == jflops.transformer_serve_flops(emb, ffn, enc, dec, vocab,
                                              src, trg, sw, tw, beam)


@pytest.mark.parametrize("name", [H100, "NVIDIA H100 PCIe", "nvidia h100",
                                  "", "cpu", "TPU v4", "NVIDIA A100-SXM4"])
def test_peak_tables(name):
    h100 = "h100" in name.lower()
    assert flops.peak_bf16_flops(name) == (989e12 if h100 else None)
    assert flops.peak_f32_flops(name) == (67e12 if h100 else None)
    assert flops.hbm_bandwidth(name) == (3.35e12 if h100 else None)
    assert flops.peak_flops(name, "torch.bfloat16") \
        == flops.peak_bf16_flops(name)
    assert flops.peak_flops(name, "float32") == flops.peak_f32_flops(name)


def test_geometry_peak_follows_the_compute_dtype():
    m = PerfMeter()
    m.enable(registry=tmsm.Registry())
    m.set_geometry(emb=512, ffn=2048, enc_depth=2, dec_depth=2, vocab=100,
                   n_devices=1, device_kind=H100,
                   compute_dtype="torch.bfloat16")
    assert m.state()["geometry"]["peak_flops_per_device"] == 989e12
    m.set_geometry(emb=512, ffn=2048, enc_depth=2, dec_depth=2, vocab=100,
                   n_devices=1, device_kind=H100)
    assert m.state()["geometry"]["peak_flops_per_device"] == 67e12
    m.set_geometry(emb=512, ffn=2048, enc_depth=2, dec_depth=2, vocab=100)
    assert m.state()["geometry"]["peak_flops_per_device"] is None


def sched_perf(cls, msm, o):
    r = msm.Registry()
    if o is jobs:
        o.PERF.enable(registry=r, hook_jax=False)
    else:
        o.PERF.enable(registry=r)

    async def main():
        sched = cls(lambda lines: [ln + " x" for ln in lines], registry=r,
                    window_s=0.005, version_fn=lambda: "v1")
        sched.start()
        await asyncio.wait_for(asyncio.gather(
            sched.submit(["a b c", "d"]), sched.submit(["e f"])), WAIT)
        await asyncio.wait_for(sched.submit(["g h i j"]), WAIT)
        await sched.stop()
    asyncio.run(main())
    return {k: v for k, v in o.PERF.state()["versions"]["v1"].items()
            if k in ("src_tokens", "batches")}, \
        r.get("marian_perf_trg_tokens_total").labels("v1").value


def test_scheduler_reports_batches_as_jax():
    got = sched_perf(ContinuousScheduler, tmsm, tobs)
    want = sched_perf(JScheduler, jmsm, jobs)
    assert got == want == ({"src_tokens": 14.0, "batches": 2}, 14.0)


def test_server_wires_and_unwires_the_perf_plane(monkeypatch):
    from marian_tpu_torch.server.server import ServingApp
    for opts, depth in (({"max-queue": 33}, "queued_units"),):
        app = ServingApp(Options({"batch-token-budget": 64,
                                  "perf-accounting": True, **opts}),
                         translate_lines=lambda lines: lines,
                         registry=tmsm.Registry())
        assert tobs.PERF.enabled and tobs.PERF._max_queue == 33
        assert tobs.PERF._depth_fn == getattr(app.scheduler, depth)
        assert "geometry" not in tobs.PERF.state()   # a stub: no model
        app.close_nowait()
        assert tobs.PERF._depth_fn is None and tobs.PERF._max_queue == 0
