"""The quiesce protocol of the port's iteration-mode scheduler and its
composition with the serving lifecycle, on the CPU: the counterparts of
tests/test_quiesce.py's TestQuiesce, TestLifecycleIteration and
TestServerSurface::test_iteration_composes_with_model_watch.

- On the same stub engines (rows that decode a fixed number of rounds,
  one page each, with a pool audit), the port's ContinuousScheduler and
  the JAX one give the same replies, the same retriable evictions, the
  same quiesce counts, the same ``op`` results and the same audits: a
  drain with a generous deadline (zero evictions), a deadline that
  evicts every decoding row (``RowEvicted``, pages freed, the resend
  served by the new engine), a withdrawn op that never installs, an
  install that raises (the old engine keeps serving), a waiter blocked
  in ``request_quiesce(wait=True)`` on another thread, and ``stop()``
  releasing a pending waiter.
- On the port's real tiny paged engines (``tests/test_torch_iteration``,
  whose texts are the JAX engine's): the drain-then-install and
  deadline cases, and the SwapController over ``EngineExecutor``s
  (``attach_iteration``): a swap under load with zero failures and an
  audit-clean old engine, an auto-rollback on failing rounds (retriable
  evictions, then the previous engine serves), and the temporal canary
  promoted in place with one quiesce.
- ``ServingApp`` accepts ``--model-watch`` with iteration mode.

Every wait has a deadline.
"""

import asyncio
import threading
import time
import types

import pytest

from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu.serving.scheduler import RowEvicted as JRowEvicted
from marian_tpu.translator.iteration import StepResult as JStepResult
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving.lifecycle import LIVE, SwapController
from marian_tpu_torch.serving.scheduler import (ContinuousScheduler,
                                                RowEvicted)
from marian_tpu_torch.training import bundle as tbdl
from marian_tpu_torch.translator.iteration import (EngineExecutor,
                                                   StepResult)
from tests.test_torch_iteration import TEXTS, engine, tiny  # noqa: F401

WAIT = 30.0


def run(coro):
    return asyncio.run(coro)


async def wait_for(pred, timeout=WAIT, interval=0.005):
    loop = asyncio.get_event_loop()
    dl = loop.time() + timeout
    while not pred():
        if loop.time() >= dl:
            return False
        await asyncio.sleep(interval)
    return True


# ---------------------------------------------------------------------------
# the two schedulers on the same stub engines
# ---------------------------------------------------------------------------

class _Pool:
    def __init__(self, pages):
        self.usable_pages = pages


class StubEngine:
    """A paged engine stand-in: a sentence of n words decodes for n
    rounds (``round_s`` each) holding one page, then finishes as
    ``<tag>:<its words reversed>``; evicted rows free their page. The
    audit checks that the pages held equal the decoding rows."""

    def __init__(self, result_cls, tag, pages=16, slots=8, round_s=0.002,
                 fail=False):
        self.result_cls = result_cls
        self.tag = tag
        self.pool = _Pool(pages)
        self.slots = slots
        self.round_s = round_s
        self.fail = fail
        self.rows = {}            # key -> [text, rounds left]
        self.held = 0
        self.audits = []

    def pages_for_text(self, text):
        return 1

    def free_pages(self):
        return self.pool.usable_pages - self.held

    def free_slots(self):
        return self.slots - len(self.rows)

    def active_rows(self):
        return len(self.rows)

    def audit(self, context="quiesce"):
        v = ([] if self.held == len(self.rows)
             else [f"{self.held} pages held by {len(self.rows)} rows"])
        self.audits.append((context, list(v)))
        return v

    def admit_and_step(self, joins, evicts):
        if self.fail:
            raise RuntimeError(f"{self.tag} round fails")
        res = self.result_cls()
        for key in evicts:
            if self.rows.pop(key, None) is not None:
                self.held -= 1
        for key, text, _meta in joins:
            if len(self.rows) >= self.slots:
                res.rejected.append((key, "no_slots"))
                continue
            self.rows[key] = [text, len(text.split())]
            self.held += 1
            res.accepted.append(key)
        time.sleep(self.round_s)
        res.rows = len(self.rows)
        res.steps = 1
        for key, row in list(self.rows.items()):
            row[1] -= 1
            if row[1] <= 0:
                del self.rows[key]
                self.held -= 1
                res.finished.append(
                    (key, f"{self.tag}:" + " ".join(row[0].split()[::-1])))
        return res


PKGS = {
    "jax": types.SimpleNamespace(Scheduler=JScheduler, Result=JStepResult,
                                 msm=jmsm, Evicted=JRowEvicted),
    "torch": types.SimpleNamespace(Scheduler=ContinuousScheduler,
                                   Result=StepResult, msm=tmsm,
                                   Evicted=RowEvicted),
}
LONG = " ".join(f"w{i}" for i in range(400))      # 400 rounds: ~1 s


def words(n, stem="x"):
    """A sentence of n words: n rounds of a stub engine."""
    return " ".join(f"{stem}{i}" for i in range(n))


def reply(tag, n, stem="x"):
    return f"{tag}:" + " ".join(f"{stem}{i}" for i in reversed(range(n)))


def make_stub_sched(p, **engine_kw):
    reg = p.msm.Registry()
    eng_a = StubEngine(p.Result, "A", **engine_kw)
    eng_b = StubEngine(p.Result, "B", **engine_kw)
    sched = p.Scheduler(None, registry=reg, batching_mode="iteration",
                        engine=eng_a, window_s=0.0)
    return sched, eng_a, eng_b, reg


def outcomes(reg):
    out = reg.get("marian_serving_request_outcomes_total")
    return sorted((k, c.value) for k, c in out.children().items())


def _drain_then_install(p):
    sched, eng_a, eng_b, reg = make_stub_sched(p)

    async def main():
        sched.start()
        f1 = sched.submit([words(60), words(30, "y")])
        assert await wait_for(lambda: eng_a.active_rows() == 2)
        op = sched.request_quiesce(lambda: sched.install_engine(eng_b),
                                   30.0, "test-swap", wait=False)
        r1 = await asyncio.wait_for(f1, WAIT)
        assert await wait_for(op.event.is_set)
        r2 = await asyncio.wait_for(sched.submit(["x y"]), WAIT)
        await sched.stop()
        return r1, r2, op
    r1, r2, op = run(main())
    return (r1, r2, op.ok, op.install_ok, op.evicted, sched.engine is eng_b,
            eng_a.held, eng_a.audits, eng_b.audits[:1],
            sched.m_quiesces.value, sched.m_quiesce_evictions.value,
            outcomes(reg))


def _deadline_evicts(p):
    sched, eng_a, eng_b, reg = make_stub_sched(p)

    async def main():
        sched.start()
        futs = [sched.submit([LONG]), sched.submit([LONG, "short one"])]
        # both long rows decoding, "short one" finished beside them
        assert await wait_for(lambda: eng_a.active_rows() == 2)
        op = sched.request_quiesce(lambda: sched.install_engine(eng_b),
                                   0.0, "test-evict", wait=False)
        errs = []
        for f in futs:
            try:
                await asyncio.wait_for(f, WAIT)
                errs.append(None)
            except p.Evicted as e:
                errs.append((type(e).__name__, str(e), e.retriable))
        assert await wait_for(op.event.is_set)
        resend = await asyncio.wait_for(sched.submit(["p q r"]), WAIT)
        await sched.stop()
        return errs, resend, op
    errs, resend, op = run(main())
    return (errs, resend, op.ok, op.install_ok, op.evicted,
            sched.engine is eng_b, eng_a.held, eng_a.audits,
            sched.m_quiesce_evictions.value, sched.m_quiesces.value,
            outcomes(reg))


def _withdrawn(p):
    sched, eng_a, eng_b, reg = make_stub_sched(p)

    async def main():
        sched.start()
        op = sched.request_quiesce(lambda: sched.install_engine(eng_b),
                                   30.0, "withdrawn", wait=False)
        sched.cancel_quiesce(op)
        r = await asyncio.wait_for(sched.submit(["u v"]), WAIT)
        assert await wait_for(op.event.is_set)
        await sched.stop()
        return r, op
    r, op = run(main())
    return (r, op.ok, op.install_ok, sched.engine is eng_a,
            sched.m_quiesces.value)


def _install_raises(p):
    sched, eng_a, eng_b, reg = make_stub_sched(p)

    def install():
        raise RuntimeError("candidate engine unusable")

    async def main():
        sched.start()
        op = sched.request_quiesce(install, 5.0, "bad-install", wait=False)
        assert await wait_for(op.event.is_set)
        r = await asyncio.wait_for(sched.submit(["m n"]), WAIT)
        await sched.stop()
        return r, op
    r, op = run(main())
    return r, op.ok, op.install_ok, sched.engine is eng_a, \
        sched.m_quiesces.value


def _waiter_on_another_thread(p):
    sched, eng_a, eng_b, reg = make_stub_sched(p)
    got = {}

    def watcher():
        op = sched.request_quiesce(lambda: sched.install_engine(eng_b),
                                   30.0, "watcher", wait=True)
        got["op"] = (op.event.is_set(), op.ok, op.evicted)

    async def main():
        sched.start()
        f = sched.submit([words(40)])
        assert await wait_for(lambda: eng_a.active_rows() == 1)
        t = threading.Thread(target=watcher, daemon=True)
        t.start()
        r = await asyncio.wait_for(f, WAIT)
        assert await wait_for(lambda: not t.is_alive())
        r2 = await asyncio.wait_for(sched.submit(["c d"]), WAIT)
        await sched.stop()
        return r, r2
    r, r2 = run(main())
    return r, r2, got["op"], sched.engine is eng_b


def _stop_releases(p):
    sched, eng_a, eng_b, reg = make_stub_sched(p)

    async def main():
        sched.start()
        await sched.stop()
        op = sched.request_quiesce(lambda: None, 0.1, "dangling",
                                   wait=False)
        await sched.stop()
        return op
    op = run(main())
    return op.event.is_set(), op.ok


@pytest.mark.parametrize("scenario", [
    _drain_then_install, _deadline_evicts, _withdrawn, _install_raises,
    _waiter_on_another_thread, _stop_releases])
def test_same_quiesce_as_jax(scenario):
    got = {name: scenario(p) for name, p in PKGS.items()}
    assert got["torch"] == got["jax"]


def test_stub_scenarios_say_what_the_reference_says():
    """The cases above hold the port to the JAX scheduler; these are the
    reference's own claims about them."""
    p = PKGS["torch"]
    (r1, r2, ok, install_ok, evicted, on_b, held, audits, b_audits,
     quiesces, evictions, outs) = _drain_then_install(p)
    assert r1 == [reply("A", 60), reply("A", 30, "y")] \
        and r2 == ["B:y x"]
    assert ok and install_ok and evicted == 0 and on_b and held == 0
    assert audits[-1] == ("quiesce-drain", [])
    assert b_audits == [("quiesce-install", [])]
    assert quiesces == 1 and evictions == 0
    assert outs == [(("ok", "unversioned"), 2.0)]
    (errs, resend, ok, install_ok, evicted, on_b, held, audits,
     q_evictions, quiesces, outs) = _deadline_evicts(p)
    assert errs[0] == ("RowEvicted", "row evicted at the quiesce deadline "
                       "(test-evict) — retry", True)
    assert errs[1][0] == "RowEvicted"
    assert evicted == q_evictions == 2 and held == 0 and on_b
    assert resend == ["B:r q p"] and ok and install_ok
    assert dict(outs)[("evicted", "unversioned")] == 2
    r, ok, install_ok, on_a, quiesces = _withdrawn(p)
    assert r == ["A:v u"] and on_a and not install_ok and quiesces == 0
    r, ok, install_ok, on_a, quiesces = _install_raises(p)
    assert r == ["A:n m"] and on_a and not ok and not install_ok
    r, r2, op, on_b = _waiter_on_another_thread(p)
    assert r == [reply("A", 40)] and r2 == ["B:d c"] and on_b
    assert op == (True, True, 0)
    assert _stop_releases(p) == (True, False)


def test_quiesce_gauge_and_metric_census():
    reg = tmsm.Registry()
    eng = StubEngine(StepResult, "A")
    sched = ContinuousScheduler(None, registry=reg,
                                batching_mode="iteration", engine=eng)
    op = sched.request_quiesce(lambda: None, 1.0, "pending", wait=False)
    text = reg.render()
    for name in ("marian_serving_quiesces_total",
                 "marian_serving_quiesce_evictions_total",
                 "marian_serving_watchdog_trips_total",
                 "marian_serving_request_outcomes_total"):
        assert f"# TYPE {name} counter" in text, name
    assert "marian_serving_quiescing 1" in text
    sched.cancel_quiesce(op)
    assert sched._peek_quiesce() is None
    assert "marian_serving_quiescing 0" in reg.render()


# ---------------------------------------------------------------------------
# the port's real paged engines
# ---------------------------------------------------------------------------

def make_sched(tiny, registry=None, **kw):
    reg = registry if registry is not None else tmsm.Registry()
    eng = engine(tiny, max_rows=4)
    sched = ContinuousScheduler(None, registry=reg, batching_mode="iteration",
                                engine=eng, window_s=0.0, **kw)
    return sched, eng, reg


def solo_outputs(tiny, texts):
    return [engine(tiny, max_rows=1).decode_texts([t])[0] for t in texts]


class TestQuiesce:
    def test_drain_then_install_swaps_engine(self, tiny):
        sched, eng_a, reg = make_sched(tiny)
        eng_b = engine(tiny, max_rows=4)
        holder = {}

        async def main():
            sched.start()
            f1 = sched.submit(TEXTS[:2])
            await asyncio.sleep(0.05)
            op = sched.request_quiesce(
                lambda: sched.install_engine(eng_b), 30.0, "test-swap",
                wait=False)
            holder["r1"] = await asyncio.wait_for(f1, WAIT)
            assert await wait_for(op.event.is_set)
            holder["op"] = op
            holder["r2"] = await asyncio.wait_for(sched.submit([TEXTS[2]]),
                                                  WAIT)
            await sched.stop()

        run(main())
        op = holder["op"]
        assert op.ok and op.install_ok and op.evicted == 0
        assert sched.engine is eng_b
        solo = solo_outputs(tiny, TEXTS[:3])
        assert holder["r1"] == solo[:2]
        assert holder["r2"] == [solo[2]]
        assert eng_a.pool.free_pages() == eng_a.pool.usable_pages
        assert eng_a.audit(context="test") == []
        assert sched.m_quiesces.value == 1
        assert sched.m_quiesce_evictions.value == 0

    def test_deadline_evicts_with_retry_and_frees_pages(self, tiny):
        sched, eng_a, reg = make_sched(tiny)
        eng_b = engine(tiny, max_rows=4)
        holder = {}

        async def main():
            sched.start()
            f1 = sched.submit([TEXTS[4]])
            assert await wait_for(lambda: eng_a.active_rows() >= 1)
            op = sched.request_quiesce(
                lambda: sched.install_engine(eng_b), 0.0, "test-evict",
                wait=False)
            with pytest.raises(RowEvicted, match="quiesce deadline"):
                await asyncio.wait_for(f1, WAIT)
            assert await wait_for(op.event.is_set)
            holder["op"] = op
            holder["r2"] = await asyncio.wait_for(sched.submit([TEXTS[4]]),
                                                  WAIT)
            await sched.stop()

        run(main())
        assert holder["op"].evicted >= 1 and holder["op"].install_ok
        assert sched.engine is eng_b
        assert eng_a.pool.free_pages() == eng_a.pool.usable_pages
        assert eng_a.audit(context="test") == []
        assert sched.m_quiesce_evictions.value >= 1
        assert holder["r2"] == solo_outputs(tiny, [TEXTS[4]])
        out = reg.get("marian_serving_request_outcomes_total")
        assert any(k[0] == "evicted" and c.value >= 1
                   for k, c in out.children().items())


def commit_bundle(model_path, tag="x", member="m.npz"):
    def write(p):
        with open(p, "w", encoding="utf-8") as fh:
            fh.write(tag)
    return tbdl.write_bundle(str(model_path), {member: write})


def make_iter_controller(tiny, sched, reg, built=None, **kw):
    def factory(bundle_dir, manifest):
        ex = EngineExecutor(engine(tiny, max_rows=4))
        if built is not None:
            built.append(ex)
        return ex

    ctrl = SwapController(factory, metrics_registry=reg, golden=["w1 w2"],
                          **kw)
    ctrl.seed_live(0, "boot", EngineExecutor(sched.engine))
    ctrl.attach_iteration(sched, quiesce_deadline=20.0)
    sched.version_fn = ctrl.live_version_name
    return ctrl


def ingest_in_thread(ctrl, bdir):
    manifest = tbdl.validate_bundle(bdir)[2]
    t = threading.Thread(target=ctrl.ingest, args=(bdir, manifest),
                         daemon=True)
    t.start()
    return t


class TestLifecycleIteration:
    def test_swap_under_load_zero_failures(self, tiny, tmp_path):
        reg = tmsm.Registry()
        sched, eng_a, _ = make_sched(tiny, registry=reg)
        ctrl = make_iter_controller(tiny, sched, reg)
        holder = {}

        async def main():
            sched.start()
            futs = [sched.submit([TEXTS[i]]) for i in range(3)]
            assert await wait_for(lambda: eng_a.active_rows() >= 1)
            t = ingest_in_thread(ctrl, commit_bundle(tmp_path / "m.npz"))
            holder["results"] = await asyncio.wait_for(asyncio.gather(
                *futs, return_exceptions=True), WAIT)
            assert await wait_for(lambda: not t.is_alive(), timeout=60)
            holder["r2"] = await asyncio.wait_for(sched.submit([TEXTS[0]]),
                                                  WAIT)
            await sched.stop()

        run(main())
        solo = solo_outputs(tiny, TEXTS[:3])
        assert holder["results"] == [[s] for s in solo]
        assert holder["r2"] == [solo[0]]
        assert ctrl.live_version_name() == "bundle-00000001"
        live = ctrl.live_version()
        assert live.state == LIVE
        assert sched.engine is live.executor.engine
        assert sched.engine is not eng_a
        assert eng_a.pool.free_pages() == eng_a.pool.usable_pages
        assert eng_a.audit(context="test") == []
        assert reg.get("marian_lifecycle_swaps_total").value == 1
        assert sched.m_quiesces.value == 1
        text = reg.render()
        assert ('marian_serving_request_outcomes_total{outcome="ok",'
                'model_version="bundle-00000001"} 1') in text

    def test_auto_rollback_on_round_failures(self, tiny, tmp_path):
        reg = tmsm.Registry()
        sched, eng_a, _ = make_sched(tiny, registry=reg)
        built = []
        ctrl = make_iter_controller(tiny, sched, reg, built=built,
                                    rollback_min_batches=2)
        holder = {}

        async def main():
            sched.start()
            t = ingest_in_thread(ctrl, commit_bundle(tmp_path / "m.npz"))
            assert await wait_for(lambda: not t.is_alive(), timeout=60)
            assert ctrl.live_version_name() == "bundle-00000001"
            bad = built[-1].engine

            def boom(*a, **k):
                raise RuntimeError("regressed weights")
            bad.admit_and_step = boom
            evicted = []
            for _ in range(3):
                try:
                    await asyncio.wait_for(sched.submit([TEXTS[1]]), WAIT)
                except RowEvicted as e:
                    evicted.append(e)
                if ctrl.live_version_name() == "boot":
                    break
            assert await wait_for(
                lambda: ctrl.live_version_name() == "boot"
                and sched.engine is eng_a)
            holder["evicted"] = evicted
            holder["r"] = await asyncio.wait_for(sched.submit([TEXTS[1]]),
                                                 WAIT)
            await sched.stop()

        run(main())
        assert holder["evicted"]
        assert holder["r"] == solo_outputs(tiny, [TEXTS[1]])
        assert reg.get("marian_lifecycle_rollbacks_total").value == 1

    def test_temporal_canary_promotes_in_place(self, tiny, tmp_path):
        reg = tmsm.Registry()
        sched, eng_a, _ = make_sched(tiny, registry=reg)
        built = []
        ctrl = make_iter_controller(tiny, sched, reg, built=built,
                                    canary_fraction=0.25,
                                    canary_min_batches=3)

        async def main():
            sched.start()
            t = ingest_in_thread(ctrl, commit_bundle(tmp_path / "m.npz"))
            assert await wait_for(lambda: not t.is_alive(), timeout=60)
            assert sched.engine is built[-1].engine
            r = await asyncio.wait_for(sched.submit([TEXTS[0]]), WAIT)
            assert r == solo_outputs(tiny, [TEXTS[0]])
            assert await wait_for(
                lambda: ctrl.live_version_name() == "bundle-00000001")
            await sched.stop()

        run(main())
        assert sched.engine is built[-1].engine
        assert sched.m_quiesces.value == 1
        assert reg.get("marian_lifecycle_swaps_total").value == 1


class TestServerSurface:
    def test_iteration_composes_with_model_watch(self):
        from marian_tpu_torch.server.server import ServingApp
        ServingApp._validate_options(Options({
            "batching-mode": "iteration", "beam-size": 1,
            "model-watch": 1.0}))
        ServingApp._validate_options(Options({
            "batching-mode": "iteration", "beam-size": 2,
            "model-watch": 1.0, "quiesce-deadline": 0.5}))
        with pytest.raises(ValueError, match="beam-size"):
            ServingApp._validate_options(Options({
                "batching-mode": "iteration", "beam-size": -1}))
        with pytest.raises(ValueError, match="iteration-rows"):
            ServingApp._validate_options(Options({
                "batching-mode": "iteration", "beam-size": 8,
                "iteration-rows": 4}))


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
