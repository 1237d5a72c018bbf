"""The port's brownout ladder (``serving/brownout.py`` and its effects in
admission, the paged engines, the scheduler, ``/sloz`` and the server)
against the JAX package's, on the CPU:

- ``BrownoutController`` on an injected clock and one signal sequence a
  case (headroom pressure, fast burn, a flapping signal) moves through
  the same levels tick by tick, applies the same levels, counts the same
  transitions in ``marian_brownout_*`` and reports the same ``state()``;
  ``stop()`` resets both to level 0; every escalation writes one
  ``brownout`` flight dump in both packages;
- ``AdmissionController.set_brownout`` sheds the same lanes with the
  same message and counts and the same ``admission.shed`` events;
- at level 1 the greedy and the beam engines scale the same decode caps
  (clamped to [0.05, 1]) and decode the JAX engines' texts at that scale;
- at level 2 ``_brownout_victims`` picks the JAX scheduler's victim on the
  same queued and active set (the lowest priority, then the longest
  decode left; none without outranking queued work), fails it with the
  retriable ``RowEvicted`` and counts it; on the real tiny engine a
  low-priority row holding the pool is evicted for a queued high one;
- ``install_engine`` applies the scale again to a swapped-in engine, as
  the JAX scheduler does;
- ``/sloz`` carries the ladder's state (``enabled: false`` without one)
  as the JAX route does, and the ladder's series carry the reference's
  names, types, HELP and labels;
- ``ServingApp --brownout`` wires the ladder to the perf plane and the
  scheduler, sheds priority-0 requests at level 3 with the JAX server's
  reply while priority-2 requests are served, warns when both signals
  are off, and resets the ladder and its flight member at close.

Every wait has a deadline.
"""

import asyncio
import json
import os
import time
import types

import pytest

from marian_tpu import obs as jobs
from marian_tpu.common import Options as JOptions
from marian_tpu.obs import slo as jslo
from marian_tpu.serving import admission as jadm
from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving import scheduler as jsched
from marian_tpu.serving.brownout import BrownoutController as JBrownout
from marian_tpu.server.server import ServingApp as JApp
from marian_tpu.translator.beam_iteration import PagedBeamEngine as JBeam
from marian_tpu.translator.iteration import PagedDecodeEngine as JEngine
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.common import logging as tlog
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.obs import slo as tslo
from marian_tpu_torch.serving import admission as tadm
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving import scheduler as tsched
from marian_tpu_torch.serving.brownout import BrownoutController
from marian_tpu_torch.server.server import ServingApp
from marian_tpu_torch.translator.beam_iteration import PagedBeamEngine
from marian_tpu_torch.translator.iteration import PagedDecodeEngine
from tests.test_torch_iteration import TEXTS, tiny  # noqa: F401

WAIT = 20.0
PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, msm=jmsm, adm=jadm, slo=jslo,
                                 sched=jsched, Brownout=JBrownout,
                                 App=JApp, Options=JOptions),
    "torch": types.SimpleNamespace(obs=tobs, msm=tmsm, adm=tadm, slo=tslo,
                                   sched=tsched, Brownout=BrownoutController,
                                   App=ServingApp, Options=Options),
}


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    for p in PKGS.values():
        p.obs.TRACER.reset()
        p.obs.FLIGHT.disarm()
        p.obs.PERF.reset()


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# the controller on one signal sequence
# ---------------------------------------------------------------------------

# (time, headroom, fast burn) per tick; floor 0.2, burn threshold 14.4,
# hold 10 s, cool 20 s
SEQUENCES = {
    "headroom": [(0, 1.0, 0)] + [(t, 0.05, 0) for t in
                                 (1, 11, 12, 21, 31, 41)]
    + [(t, 0.9, 0) for t in (42, 62, 82, 102, 103)],
    "burn": [(0, 1.0, 0), (1, 1.0, 20.0), (6.5, 1.0, 20.0),
             (11.5, 1.0, 20.0), (12, 1.0, 3.0), (40, 1.0, 3.0),
             (60, 1.0, 3.0)],
    "flapping": [(0, 0.1, 0), (5, 0.5, 0), (9, 0.1, 0), (18, 0.1, 0),
                 (19, 0.1, 0), (20, 0.3, 0), (35, 0.3, 0), (41, 0.3, 0),
                 (45, 0.05, 16.0), (56, 0.05, 16.0)],
}


def ladder_run(p, seq):
    reg = p.msm.Registry()
    applied, sig = [], {"h": 1.0, "b": 0.0}
    bc = p.Brownout(apply_fn=applied.append, headroom_fn=lambda: sig["h"],
                    burn_fn=lambda: sig["b"], registry=reg,
                    headroom_floor=0.2, burn_threshold=14.4, hold_s=10.0,
                    cool_s=20.0, clock=lambda: 0.0)
    levels = []
    for t, h, b in seq:
        sig["h"], sig["b"] = h, b
        levels.append(bc.tick(float(t)))
    state = bc.state()
    text = [ln for ln in reg.render().splitlines() if "brownout" in ln]
    bc.stop()
    return levels, applied, state, text, bc.level()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ladder_matches_jax(name):
    got = ladder_run(PKGS["torch"], SEQUENCES[name])
    want = ladder_run(PKGS["jax"], SEQUENCES[name])
    assert got == want
    levels, applied, state, _, after_stop = got
    assert max(levels) >= 1 and after_stop == 0
    # one rung at a time, each move applied
    assert all(abs(a - b) <= 1 for a, b in zip(levels, levels[1:]))
    assert applied[-1] == 0 if levels[-1] else True


def test_stop_resets_the_level_as_jax():
    out = {}
    for name, p in PKGS.items():
        applied = []
        bc = p.Brownout(apply_fn=applied.append, headroom_fn=lambda: 0.0,
                        registry=p.msm.Registry(), hold_s=0.0)
        bc.tick(0.0)
        bc.tick(1.0)
        before = bc.level()
        bc.stop()
        out[name] = (before, bc.level(), applied, bc.m_level.value)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] >= 1 and out["torch"][1:] == (0, [1, 2, 0], 0)


def flight_files(d, timeout=WAIT):
    deadline = time.time() + timeout
    names = []
    while time.time() < deadline:
        names = sorted(n for n in os.listdir(d) if n.startswith("flight-"))
        if len(names) >= 3:
            break
        time.sleep(0.02)
    return names


def test_every_escalation_writes_a_flight_dump_as_jax(tmp_path):
    """The headroom sequence escalates 0 -> 3: three ``brownout`` dumps
    in each package, each with the controller's state as a member and
    the ``brownout.level`` events on the timeline."""
    got = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        p.obs.TRACER.enable()
        p.obs.FLIGHT.arm(str(d))
        reg = p.msm.Registry()
        sig = {"h": 0.05}
        bc = p.Brownout(apply_fn=lambda lvl: None,
                        headroom_fn=lambda: sig["h"], registry=reg,
                        headroom_floor=0.2, hold_s=1.0, cool_s=1.0)
        p.obs.FLIGHT.add_snapshot_provider("brownout", bc.state)
        for t in range(0, 5):
            bc.tick(float(t))
        names = flight_files(str(d))
        docs = []
        for n in names:
            with open(d / n, encoding="utf-8") as fh:
                docs.append(json.load(fh))
        p.obs.FLIGHT.remove_snapshot_provider("brownout")
        events = [e for e in docs[-1]["trace"]["traceEvents"]
                  if e.get("name") == "brownout.level"]
        got[name] = (len(names), sorted(d["reason"] for d in docs),
                     sorted(d["brownout"]["level"] >= 1 for d in docs),
                     sorted(e["args"]["level"] for e in events))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 3 and got["torch"][1] == ["brownout"] * 3


# ---------------------------------------------------------------------------
# admission's rung
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level,min_priority", [(0, 1), (2, 1), (3, 1),
                                                (3, 2), (3, -1)])
def test_admission_rung_matches_jax(level, min_priority):
    out = {}
    for name, p in PKGS.items():
        p.obs.TRACER.enable()
        reg = p.msm.Registry()
        adm = p.adm.AdmissionController(0, lambda: 0, registry=reg)
        adm.set_brownout(level, min_priority=min_priority)
        verdicts = []
        for prio in (-2, 0, 1, 2, 5):
            try:
                adm.admit(1, priority=prio)
                verdicts.append("ok")
            except p.adm.Overloaded as e:
                verdicts.append((str(e), e.retriable))
        _spans, events = p.obs.TRACER.snapshot()
        shed = reg.get("marian_serving_shed_total")
        out[name] = (verdicts,
                     {k: c.value for k, c in shed.children().items()},
                     reg.get("marian_serving_admitted_sentences_total").value,
                     [(e["name"], e["attrs"]) for e in events])
        adm.set_brownout(0)
        adm.admit(1, priority=-9)            # the ladder off admits again
    assert out["torch"] == out["jax"]
    sheds = [v for v in out["torch"][0] if v != "ok"]
    assert bool(sheds) == (level >= 3 and min_priority > -2)


# ---------------------------------------------------------------------------
# level 1: the engines' decode caps
# ---------------------------------------------------------------------------

CAP_ENGINE = dict(page_len=4, src_len_cap=8, max_length_cap=32,
                  max_length_factor=4.0, max_rows=4)


def cap_engines(tiny, beam):
    jm, jp, tm, tp, jv, tv = tiny
    if beam:
        kw = dict(CAP_ENGINE, max_rows=4, beam_size=2, merge="host")
        return (PagedBeamEngine(tm, tp, tv, tv, **kw),
                JBeam(jm, jp, jv, jv, **kw))
    return (PagedDecodeEngine(tm, tp, tv, tv, **CAP_ENGINE),
            JEngine(jm, jp, jv, jv, **CAP_ENGINE))


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
@pytest.mark.parametrize("scale", [0.5, 0.01, 2.0])
def test_level1_caps_match_jax(tiny, beam, scale):
    teng, jeng = cap_engines(tiny, beam)
    base = [teng.decode_cap(n) for n in range(1, 12)]
    for e in (teng, jeng):
        e.set_cap_scale(scale)
    assert teng._cap_scale == jeng._cap_scale == min(1.0, max(0.05, scale))
    caps = [teng.decode_cap(n) for n in range(1, 12)]
    assert caps == [jeng.decode_cap(n) for n in range(1, 12)]
    assert [teng.pages_for_text(t) for t in TEXTS] \
        == [jeng.pages_for_text(t) for t in TEXTS]
    if scale < 1:
        assert caps < base and min(caps) == 8
    assert teng.decode_texts(TEXTS) == jeng.decode_texts(TEXTS)
    for e in (teng, jeng):
        e.set_cap_scale(1.0)
    assert [teng.decode_cap(n) for n in range(1, 12)] == base


# ---------------------------------------------------------------------------
# level 2: the victim
# ---------------------------------------------------------------------------

class ProgressEngine:
    """The scheduler surface ``_brownout_victims`` reads: row progress
    by unit, one page a sentence."""

    def __init__(self):
        self.progress = {}
        self.pool = types.SimpleNamespace(usable_pages=64)

    def pages_for_text(self, text):
        return 1

    def row_progress(self, key):
        return self.progress.get(key)


# active rows (priority, position, cap), the queued request's priority
# (None: nothing queued), the expected victim's index
VICTIMS = [
    ([(0, 2, 10), (0, 1, 12), (1, 0, 5)], 2, 1),
    ([(1, 3, 9), (0, 5, 6), (0, 0, 6)], 1, 2),
    ([(0, 0, 8), (0, 0, 8), (-1, 7, 8)], 0, 2),
    ([(0, 4, 8), (0, 4, 8)], 1, 0),
    ([(2, 0, 9), (3, 0, 9)], 2, None),
    ([(0, 4, 8)], None, None),
]


def victim_run(p, rows, queued):
    reg = p.msm.Registry()
    eng = ProgressEngine()
    sched = p.sched.ContinuousScheduler(None, registry=reg,
                                        batching_mode="iteration",
                                        engine=eng, window_s=0.0)

    async def main():
        loop = asyncio.get_event_loop()
        units = []
        for i, (prio, pos, cap) in enumerate(rows):
            args = ([f"row {i}"], loop.create_future(), prio, loop.time())
            if p is PKGS["jax"]:
                args += (None,)
            req = p.sched._Request(*args)
            u = p.sched._Unit(req, 0, f"row {i}", 3, 1)
            sched._active_units[u] = None
            eng.progress[u] = (pos, cap)
            units.append(u)
        if queued is not None:
            sched.submit(["queued"], priority=queued)
        sched.set_brownout_level(2)
        got = sched._brownout_victims(loop, [])
        idx = [units.index(u) for u in got]
        errs = [type(u.req.future.exception()).__name__
                + ": " + str(u.req.future.exception()) for u in got]
        return idx, errs, [u.evict_reason for u in got]
    idx, errs, reasons = run(main())
    return idx, errs, reasons, sched.m_brownout_evictions.value


@pytest.mark.parametrize("case", range(len(VICTIMS)))
def test_level2_victim_matches_jax(case):
    rows, queued, want = VICTIMS[case]
    got = victim_run(PKGS["torch"], rows, queued)
    assert got == victim_run(PKGS["jax"], rows, queued)
    idx, errs, reasons, count = got
    assert idx == ([] if want is None else [want])
    assert count == len(idx) and reasons == ["brownout"] * len(idx)
    assert all(e.startswith("RowEvicted: row evicted under brownout")
               for e in errs)


def test_level2_evicts_low_priority_for_queued_high(tiny):
    """On the real tiny engine: a low-priority row holding the whole
    pool is evicted (retriably) for a queued high-priority request, which
    is then served its solo decode at the scaled cap."""
    _, _, tm, tp, _, tv = tiny
    probe = PagedDecodeEngine(tm, tp, tv, tv, page_len=4, src_len_cap=8,
                              max_length_cap=48, max_length_factor=8.0,
                              max_rows=1)
    eng = PagedDecodeEngine(tm, tp, tv, tv, page_len=4, src_len_cap=8,
                            max_length_cap=48, max_length_factor=8.0,
                            max_rows=4, pool_bytes=12 * probe.page_bytes)
    assert eng.pool.usable_pages == 12        # exactly one 48-cap row
    reg = tmsm.Registry()
    sched = tsched.ContinuousScheduler(None, registry=reg,
                                       batching_mode="iteration",
                                       engine=eng, window_s=0.0)
    holder = {}

    async def main():
        sched.start()
        f_low = sched.submit([TEXTS[4]], priority=0)
        dl = time.time() + WAIT
        while sched.m_joins.value < 1 and time.time() < dl:
            await asyncio.sleep(0.001)
        sched.set_brownout_level(2)
        f_high = sched.submit([TEXTS[1]], priority=5)
        with pytest.raises(tsched.RowEvicted, match="brownout"):
            await asyncio.wait_for(f_low, WAIT)
        holder["high"] = await asyncio.wait_for(f_high, WAIT)
        await sched.stop()

    run(main())
    # level 2 includes level 1: the high row joined at the scaled cap
    probe.set_cap_scale(sched._brownout_cap_factor)
    assert holder["high"] == probe.decode_texts([TEXTS[1]])
    assert sched.m_brownout_evictions.value >= 1
    assert eng.idle() and eng.pool.free_pages() == eng.pool.usable_pages
    assert eng.audit() == []


# ---------------------------------------------------------------------------
# install_engine keeps the scale
# ---------------------------------------------------------------------------

class ScaleEngine:
    def __init__(self):
        self.scales = []
        self.pool = types.SimpleNamespace(usable_pages=8)

    def set_cap_scale(self, s):
        self.scales.append(s)


def test_install_engine_applies_the_scale_again_as_jax():
    out = {}
    for name, p in PKGS.items():
        first, second, third = ScaleEngine(), ScaleEngine(), ScaleEngine()
        sched = p.sched.ContinuousScheduler(
            None, registry=p.msm.Registry(), batching_mode="iteration",
            engine=first, window_s=0.0)
        sched.set_brownout_level(1, cap_factor=0.25)
        sched.install_engine(second)
        sched.set_brownout_level(2)
        sched.set_brownout_level(0)
        sched.install_engine(third)
        out[name] = (first.scales, second.scales, third.scales)
    assert out["torch"] == out["jax"]
    assert out["torch"] == ([0.25], [0.25, 0.25, 1.0], [1.0])


# ---------------------------------------------------------------------------
# /sloz and the ladder's series
# ---------------------------------------------------------------------------

def census(reg, prefix):
    fams = {}
    for name, m in reg._metrics.items():
        if name.startswith(prefix):
            fams[name] = (m.kind, m.help, tuple(m.label_names))
    return fams


def test_sloz_and_series_match_jax():
    out = {}
    for name, p in PKGS.items():
        reg = p.msm.Registry()
        bc = p.Brownout(apply_fn=lambda lvl: None, headroom_fn=lambda: 0.0,
                        registry=reg, hold_s=0.0, clock=lambda: 0.0)
        bc.tick(0.0)
        bc.tick(1.0)
        code, body, ctype = p.slo.slo_routes(lambda: None,
                                             lambda: bc)["/sloz"]("GET", "")
        doc = json.loads(body)
        code0, body0, _ = p.slo.slo_routes(lambda: None)["/sloz"]("GET", "")
        out[name] = (code, ctype, doc["brownout"], doc["slo"], code0,
                     json.loads(body0)["brownout"],
                     census(reg, "marian_brownout"),
                     [ln for ln in reg.render().splitlines()
                      if ln.startswith("marian_brownout")])
    assert out["torch"] == out["jax"]
    assert out["torch"][2]["enabled"] and out["torch"][2]["level"] == 2
    assert out["torch"][5] == {"enabled": False}
    assert set(out["torch"][6]) == {"marian_brownout_level",
                                    "marian_brownout_transitions_total"}


def test_fast_burn_reads_the_newest_tick_as_jax():
    """The ladder's burn signal: the largest fast-window burn over the
    objectives as of the last tick."""
    out = {}
    for name, p in PKGS.items():
        reg = p.msm.Registry()
        eng = p.slo.SloEngine(registry=reg, availability=0.99,
                              window_s=10, clock=lambda: 0.0)
        out[name] = [eng.fast_burn()]
        eng.tick(0.0)
        m = reg.counter("marian_serving_request_outcomes_total", "o",
                        labels=("outcome", "model_version"))
        for _ in range(30):
            m.labels("ok", "v").inc()
        for _ in range(10):
            m.labels("failure", "v").inc()
        out[name].append(eng.fast_burn())
        eng.tick(1.0)
        out[name].append(eng.fast_burn())
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == [0.0, 0.0] and out["torch"][2] > 14.4


# ---------------------------------------------------------------------------
# the server's wiring
# ---------------------------------------------------------------------------

def stub_translate(lines):
    return [f"T:{ln}" for ln in lines]


def brownout_app(p, **extra):
    opts = {"batch-token-budget": 256, "max-queue": 64,
            "request-timeout": 0.0, "metrics-port": 0, "brownout": True,
            "perf-accounting": True}
    opts.update(extra)
    return p.App(p.Options(opts), translate_lines=stub_translate,
                 registry=p.msm.Registry())


async def _start(app):
    res = app.start()
    if asyncio.iscoroutine(res):            # the reference's is async
        await res


async def _frame(app, text):
    if hasattr(app, "handle_text"):
        return await app.handle_text(text)
    return await app.handle_frame(text)


def test_server_level3_sheds_the_low_lane_as_jax():
    out = {}
    for name, p in PKGS.items():
        async def scenario():
            app = brownout_app(p)
            await _start(app)
            try:
                assert app.brownout is not None \
                    and app.brownout.headroom_fn is not None
                before = await _frame(app, "#priority:0\na b")
                app._apply_brownout(3)
                low = await _frame(app, "#priority:0\nc d")
                high = await _frame(app, "#priority:2\ne f")
                flight = sorted(p.obs.FLIGHT._providers)
                levels = (app.scheduler._brownout_level,
                          app.admission._gate_state()[1:])
            finally:
                await app.shutdown(drain_timeout=5.0)
            return (before, low, high, levels, "brownout" in flight,
                    app.brownout, "brownout" in p.obs.FLIGHT._providers)
        out[name] = run(scenario())
    assert out["torch"] == out["jax"]
    before, low, high, levels, had_provider, after, has_provider = \
        out["torch"]
    assert before == "T:a b" and high == "T:e f"
    assert low.startswith("!!SERVER-OVERLOADED brownout level 3")
    assert levels == (3, (3, 1)) and had_provider
    assert after is None and not has_provider


def test_server_warns_when_both_signals_are_off(monkeypatch):
    warned = []
    monkeypatch.setattr(tlog, "warn",
                        lambda msg, *a: warned.append(msg.format(*a)))
    app = brownout_app(PKGS["torch"], **{"perf-accounting": False})
    try:
        assert app.brownout.headroom_fn is None \
            and app.brownout.burn_fn is None
        assert any("BOTH of its signals" in w for w in warned)
    finally:
        app.close_nowait()
    warned.clear()
    app = brownout_app(PKGS["torch"], **{"slo-availability": 0.999})
    try:
        assert app.brownout.burn_fn == app.slo.fast_burn
        assert app.brownout.burn_threshold == app.slo.fast_factor
        assert not any("BOTH" in w for w in warned)
    finally:
        app.close_nowait()


@pytest.fixture(scope="module", autouse=True)
def lock_witness():
    """At the module's end: the port's witnessed locks (MARIAN_LOCKDEP=1,
    tests/conftest.py) show no acquisition-order cycle, and every lock
    name observed is one a ``make_lock``/``make_rlock`` literal declares."""
    yield
    from marian_tpu_torch.common import lockdep
    if lockdep.enabled():
        assert lockdep.observed_cycles() == []
        assert lockdep.observed_nodes() <= lockdep.declared_names()
