"""The dispatch watchdog (``--dispatch-stall-timeout``) of the port's
serving scheduler and server against the JAX package's, on the CPU, the
counterparts of tests/test_serving.py ::TestDispatchWatchdog:

- a wedged ``translate_lines`` call (request mode) fails its request
  with the retriable ``DispatchStalled``, in both packages with the same
  message and one trip; the next request is served on a fresh worker
  while the wedged thread is still stuck, and that thread is detached
  from ``concurrent.futures``' exit join;
- a stub hang (the reference's ``serving.translate=hang`` fault point)
  trips the watchdog the same way;
- the server replies ``!!SERVER-RETRY`` to a stalled request;
- iteration mode: a round wedged past the timeout fails every row of it
  with ``DispatchStalled``, rebuilds the engine through the factory (the
  scheduler holds no reference to the old one while it builds), and the
  rebuilt engine serves the next request;
- a round abandoned inside an engine's sync-debug guard hands the
  process-wide CUDA sync-debug mode back before the next round, and the
  abandoned guard's late exit leaves it alone (checked through a stub of
  ``torch.cuda``'s mode calls: the CPU path runs no guard).
"""

import asyncio
import threading

import pytest
import torch

from marian_tpu.serving import metrics as msm
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu.serving.scheduler import DispatchStalled as JStalled
from marian_tpu.translator.iteration import StepResult as JStepResult
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.serving.scheduler import (ContinuousScheduler,
                                                DispatchStalled)
from marian_tpu_torch.translator import iteration
from marian_tpu_torch.translator.iteration import StepResult

WAIT = 10.0


def _trips(sched):
    if isinstance(sched, ContinuousScheduler):
        return sched.counts["watchdog_trips"]
    return sched._registry.get("marian_serving_watchdog_trips_total").value


def _wedged_workers():
    """serve-device threads still registered for the interpreter's exit
    join and alive."""
    from concurrent.futures import thread as cf_thread
    return [t for t in cf_thread._threads_queues
            if t.name.startswith("serve-device") and t.is_alive()]


def _scheduler(name, translate, **kw):
    if name == "port":
        return ContinuousScheduler(translate, window_s=0, **kw)
    return JScheduler(translate, window_s=0, registry=msm.Registry(), **kw)


def _stalled_then_served(make_translate, stall_timeout):
    """Per package: (the stalled request's error type name, its message,
    retriable, the next request's reply, trips, wedged threads still
    registered for the exit join)."""
    out = {}
    for name in ("port", "jax"):
        release = threading.Event()
        sched = _scheduler(name, make_translate(release),
                           stall_timeout=stall_timeout)

        async def scenario():
            sched.start()
            try:
                try:
                    await asyncio.wait_for(sched.submit(["stall"]), WAIT)
                    err = None
                except (DispatchStalled, JStalled) as e:
                    err = e
                after = await asyncio.wait_for(sched.submit(["after"]), WAIT)
                wedged = _wedged_workers()
                return err, after, wedged
            finally:
                release.set()
                await sched.stop()
        try:
            err, after, wedged = asyncio.run(scenario())
        finally:
            release.set()
        out[name] = (type(err).__name__, str(err), err.retriable, after,
                     _trips(sched), len(wedged))
    return out


def test_stalled_batch_fails_retriable_and_scheduler_survives():
    def make(release):
        def translate(lines):
            if lines == ["stall"]:
                release.wait(WAIT)          # a wedged device call
            return [l.upper() for l in lines]
        return translate
    got = _stalled_then_served(make, 0.1)
    assert got["port"] == got["jax"]
    name, msg, retriable, after, trips, wedged = got["port"]
    assert name == "DispatchStalled" and retriable
    assert msg == "device batch stalled past 0.1s — retry"
    assert after == ["AFTER"] and trips == 1
    # only the replacement worker may remain registered for the exit join
    assert wedged <= 1


def test_stub_hang_trips_the_watchdog():
    """The stub stands where the reference's serving.translate=hang:0.4
    fault point sleeps: the call ends on its own after the trip."""
    def make(release):
        calls = []

        def translate(lines):
            calls.append(lines)
            if len(calls) == 1:
                release.wait(0.4)
            return list(lines)
        return translate
    got = _stalled_then_served(make, 0.05)
    assert got["port"] == got["jax"]
    assert got["port"][3] == ["after"] and got["port"][4] == 1


def test_server_replies_server_retry_on_stall():
    release = threading.Event()

    def blocking(lines):
        release.wait(WAIT)
        return list(lines)

    opts = TOptions({"batch-token-budget": 256, "max-queue": 64,
                     "request-timeout": 0.0, "dispatch-stall-timeout": 0.1,
                     "cpu-threads": 1})
    app = srv.ServingApp(opts, translate_lines=blocking)
    assert app.scheduler.stall_timeout == 0.1

    async def scenario():
        app.start()
        try:
            return await asyncio.wait_for(app.handle_frame("hold"), WAIT)
        finally:
            release.set()
            await app.shutdown(drain_timeout=2.0)
    try:
        reply = asyncio.run(scenario())
    finally:
        release.set()
    assert reply == "!!SERVER-RETRY device batch stalled past 0.1s — retry"
    assert app.scheduler.counts["watchdog_trips"] == 1


class _Pool:
    usable_pages = 64


class StubEngine:
    """A paged engine stand-in: every joined sentence finishes in the
    round it joins, upper-cased; a sentence "stall" wedges its round on
    ``release`` (inside ``guard`` when one is given)."""

    def __init__(self, result_cls, release, built, guard=None):
        self.result_cls = result_cls
        self.release = release
        self.guard = guard
        self.pool = _Pool()
        built.append(self)

    def pages_for_text(self, text):
        return 1

    def free_pages(self):
        return 64

    def free_slots(self):
        return 8

    def active_rows(self):
        return 0

    def admit_and_step(self, joins, evicts):
        res = self.result_cls()
        for key, text, _meta in joins:
            if text == "stall":
                if self.guard is not None:
                    with self.guard():
                        self.release.wait(WAIT)
                else:
                    self.release.wait(WAIT)
            res.accepted.append(key)
            res.finished.append((key, text.upper()))
        return res


def _iteration_stall(name, guard=None):
    """(the stalled rows' errors, the next reply, trips, engines built,
    whether the scheduler held the old engine during the rebuild)."""
    release = threading.Event()
    built = []
    result_cls = StepResult if name == "port" else JStepResult
    held = []

    def factory():
        held.append(sched.engine is built[0])
        return StubEngine(result_cls, release, built, guard)
    engine = StubEngine(result_cls, release, built, guard)
    if name == "port":
        sched = ContinuousScheduler(
            window_s=0, batching_mode="iteration", engine=engine,
            engine_factory=factory, stall_timeout=0.1)
    else:
        sched = JScheduler(None, window_s=0, registry=msm.Registry(),
                           batching_mode="iteration", engine=engine,
                           engine_factory=factory, stall_timeout=0.1)

    async def scenario():
        sched.start()
        try:
            futs = [sched.submit(["stall", "beside"])]
            errs = []
            for f in futs:
                try:
                    await asyncio.wait_for(f, WAIT)
                except (DispatchStalled, JStalled) as e:
                    errs.append((type(e).__name__, str(e), e.retriable))
            after = await asyncio.wait_for(sched.submit(["after"]), WAIT)
            return errs, after
        finally:
            release.set()
            await sched.stop()
    try:
        errs, after = asyncio.run(scenario())
    finally:
        release.set()
    return errs, after, _trips(sched), len(built), held, sched.engine


def test_iteration_round_stall_rebuilds_the_engine():
    port = _iteration_stall("port")
    jax_ = _iteration_stall("jax")
    assert port[:4] == jax_[:4]
    errs, after, trips, n_built, held, engine = port
    assert errs == [("DispatchStalled",
                     "decode step stalled past 0.1s — retry", True)]
    assert after == ["AFTER"] and trips == 1 and n_built == 2
    assert held == [False]              # dropped before the rebuild
    assert engine is not None


def test_sync_debug_mode_is_handed_back_after_a_trip(monkeypatch):
    modes = [0]                         # every mode set, in order
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    seen = []

    def guard():
        return iteration.sync_guard("error", torch.device("cuda"))

    class Watching(StubEngine):
        def admit_and_step(self, joins, evicts):
            # the mode each round starts under
            seen.append(modes[-1])
            return super().admit_and_step(joins, evicts)

    release = threading.Event()
    built = []
    engine = Watching(StepResult, release, built, guard)
    sched = ContinuousScheduler(
        window_s=0, batching_mode="iteration", engine=engine,
        engine_factory=lambda: Watching(StepResult, release, built, guard),
        stall_timeout=0.1)

    async def scenario():
        sched.start()
        try:
            with pytest.raises(DispatchStalled):
                await asyncio.wait_for(sched.submit(["stall"]), WAIT)
            mode_after_trip = modes[-1]
            after = await asyncio.wait_for(sched.submit(["after"]), WAIT)
            release.set()
            await asyncio.sleep(0.2)        # the abandoned guard exits
            return mode_after_trip, after
        finally:
            release.set()
            await sched.stop()
    try:
        mode_after_trip, after = asyncio.run(scenario())
    finally:
        release.set()
    assert after == ["AFTER"]
    # the guard set "error", the trip restored the previous mode (0)
    assert modes[:3] == [0, "error", 0]
    assert mode_after_trip == 0
    assert seen == [0, 0]               # the next round starts restored
    # the abandoned guard's late exit changed nothing
    assert modes[-1] == 0 and len(modes) == 3
    assert iteration.release_sync_guard() is False


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
