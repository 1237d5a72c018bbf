"""The serving fault points of the port against the JAX server's
behaviour under the same armed spec, on the CPU (each case runs on both
packages through ``pkg``):

- the lifecycle's (``tests/test_lifecycle.py``): ``lifecycle.watch=fail``
  re-delivers the bundle on the next poll; ``lifecycle.warmup=fail``
  fails the candidate and the live version serves; ``lifecycle.swap=fail``
  fails the install, a later bundle swaps; ``lifecycle.rollback=fail@1``
  aborts one canary rollback, the next batch lands it; a live rollback
  through the admin verb crosses the same point;
- the scheduler's (``tests/test_serving.py``, ``tests/test_quiesce.py``):
  ``serving.translate=hang`` trips the dispatch watchdog once in request
  mode and in iteration mode, and the next request is served;
  ``serving.dispatch=fail`` fails the batch's futures and the worker
  survives; ``serving.quiesce=fail@1`` aborts one quiesce completion and
  the next round finishes it;
- ``serving.quiesce=kill@1`` in a subprocess: the server process exits
  117 at the quiesce boundary, before the install.
"""

import asyncio
import os
import pathlib
import subprocess
import sys
import types

import pytest

from marian_tpu.common import faultpoints as jfp
from marian_tpu.serving.scheduler import DispatchStalled as JStalled
from marian_tpu_torch.common import faultpoints as tfp
from marian_tpu_torch.serving.scheduler import DispatchStalled
from tests.test_torch_lifecycle import PKGS as LC_PKGS
from tests.test_torch_lifecycle import (commit_bundle, failing_after,
                                        ingest, make_controller)
from tests.test_torch_quiesce import PKGS as Q_PKGS
from tests.test_torch_quiesce import (StubEngine, make_stub_sched, run,
                                      wait_for, words)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = {"jax": jfp, "torch": tfp}
STALLED = {"jax": JStalled, "torch": DispatchStalled}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    name = request.param
    p = types.SimpleNamespace(name=name, fp=FP[name],
                              Stalled=STALLED[name], **vars(LC_PKGS[name]),
                              **{k: v for k, v in vars(Q_PKGS[name]).items()
                                 if k not in ("msm", "Scheduler")})
    try:
        yield p
    finally:
        jfp.reset_for_tests()
        tfp.reset_for_tests()


# -- the lifecycle ----------------------------------------------------------------

def test_injected_watch_fault_redelivers(pkg, tmp_path):
    mp = tmp_path / "m.npz"
    got = []
    w = pkg.lc.BundleWatcher(str(pkg.bdl.bundle_root(str(mp))),
                             lambda b, m: got.append((b, m["seq"])),
                             interval=3600)
    bdir = commit_bundle(pkg.bdl, mp)
    with pkg.fp.active("lifecycle.watch=fail"):
        with pytest.raises(pkg.fp.InjectedFault):
            w.poll_now()
    assert got == []
    assert w.poll_now() == bdir                 # re-delivered, not lost
    assert got == [(bdir, 1)]


def test_injected_warmup_fault_fails_the_candidate(pkg, tmp_path):
    ctrl = make_controller(pkg)
    bdir = commit_bundle(pkg.bdl, tmp_path / "m.npz")
    with pkg.fp.active("lifecycle.warmup=fail"):
        v = ingest(pkg, ctrl, bdir)
    assert v.state == pkg.lc.FAILED and "injected fault" in v.error
    assert ctrl.route(["x"]) == ["v1:x"]


def test_injected_swap_fault_fails_the_install_live_survives(pkg, tmp_path):
    reg = pkg.msm.Registry()
    ctrl = make_controller(pkg, reg=reg)
    mp = tmp_path / "m.npz"
    with pkg.fp.active("lifecycle.swap=fail"):
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, mp, tag="one"))
    assert v.state == pkg.lc.FAILED
    assert ctrl.route(["x"]) == ["v1:x"]
    assert reg.get("marian_lifecycle_rejects_total") \
              .labels("install").value == 1
    v2 = ingest(pkg, ctrl, commit_bundle(pkg.bdl, mp, tag="two"))
    assert v2.state == pkg.lc.LIVE and ctrl.route(["x"]) == ["b2:x"]


def test_injected_rollback_fault_retries_next_batch(pkg, tmp_path):
    ctrl = make_controller(pkg, factory=failing_after(1),
                           canary_fraction=1.0, rollback_min_batches=1)
    v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
    with pkg.fp.active("lifecycle.rollback=fail@1"):
        assert ctrl.route(["a"]) == ["v1:a"]     # the rollback aborted...
        assert v.state == pkg.lc.CANARY          # ...routing stands
        assert ctrl.route(["b"]) == ["v1:b"]     # the retry lands it
        assert pkg.fp.hits("lifecycle.rollback") == 2
    assert v.state == pkg.lc.FAILED


def test_admin_rollback_crosses_the_rollback_point(pkg, tmp_path):
    ctrl = make_controller(pkg)
    v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
    assert v.state == pkg.lc.LIVE
    with pkg.fp.active("lifecycle.rollback=fail"):
        with pytest.raises(pkg.fp.InjectedFault):
            ctrl.rollback()
        assert ctrl.route(["x"]) == ["b1:x"]     # nothing moved
    assert ctrl.rollback()
    assert ctrl.route(["x"]) == ["v1:x"]


# -- the scheduler ------------------------------------------------------------------

def test_injected_hang_trips_the_watchdog_in_request_mode(pkg):
    async def scenario():
        reg = pkg.msm.Registry()
        s = pkg.Scheduler(lambda lines: list(lines), window_s=0,
                          registry=reg, stall_timeout=0.05)
        s.start()
        with pkg.fp.active("serving.translate=hang:0.4"):
            with pytest.raises(pkg.Stalled):
                await asyncio.wait_for(s.submit(["x"]), 5)
        out = await asyncio.wait_for(s.submit(["ok"]), 5)
        await s.stop()
        return out, reg.get("marian_serving_watchdog_trips_total").value

    assert run(scenario()) == (["ok"], 1)


def test_injected_hang_trips_the_watchdog_in_iteration_mode(pkg):
    made = []

    def factory():
        made.append(StubEngine(pkg.Result, f"E{len(made)}"))
        return made[-1]

    async def scenario():
        reg = pkg.msm.Registry()
        s = pkg.Scheduler(None, registry=reg, batching_mode="iteration",
                          engine=factory(), engine_factory=factory,
                          window_s=0.0, stall_timeout=0.1)
        s.start()
        with pkg.fp.active("serving.translate=hang:0.6@1"):
            with pytest.raises(Exception) as e:
                await asyncio.wait_for(s.submit([words(2)]), 10)
        out = await asyncio.wait_for(s.submit([words(2)]), 10)
        await s.stop()
        return e.value, out, reg.get(
            "marian_serving_watchdog_trips_total").value

    err, out, trips = run(scenario())
    assert "stall" in str(err).lower() or isinstance(err, pkg.Stalled)
    assert trips == 1 and out == ["E1:x1 x0"]


def test_injected_dispatch_failure_fails_loudly(pkg):
    async def scenario():
        s = pkg.Scheduler(lambda lines: list(lines), window_s=0,
                          registry=pkg.msm.Registry())
        s.start()
        with pkg.fp.active("serving.dispatch=fail"):
            with pytest.raises(RuntimeError, match="injected fault"):
                await asyncio.wait_for(s.submit(["x"]), 5)
        out = await asyncio.wait_for(s.submit(["ok"]), 5)
        await s.stop()
        return out

    assert run(scenario()) == ["ok"]


def test_quiesce_fault_aborts_one_attempt_and_recovers(pkg):
    sched, eng_a, eng_b, reg = make_stub_sched(pkg)

    async def main():
        sched.start()
        with pkg.fp.active("serving.quiesce=fail@1"):
            op = sched.request_quiesce(
                lambda: sched.install_engine(eng_b), 5.0, "test-kill",
                wait=False)
            assert await wait_for(op.event.is_set)
            assert pkg.fp.hits("serving.quiesce") >= 2
        await sched.stop()
        return op

    op = run(main())
    assert op.ok and sched.engine is eng_b


KILL_CHILD = """
import asyncio
from marian_tpu_torch.serving import metrics as msm
from marian_tpu_torch.serving.scheduler import ContinuousScheduler
from marian_tpu_torch.translator.iteration import StepResult
from tests.test_torch_quiesce import StubEngine, words

eng_a, eng_b = StubEngine(StepResult, "A"), StubEngine(StepResult, "B")
s = ContinuousScheduler(None, registry=msm.Registry(),
                        batching_mode="iteration", engine=eng_a,
                        window_s=0.0)

async def main():
    s.start()
    fut = s.submit([words(200)])
    while not eng_a.active_rows():
        await asyncio.sleep(0.005)
    s.request_quiesce(lambda: print("INSTALLED", flush=True)
                      or s.install_engine(eng_b), 0.05, "kill",
                      wait=False)
    try:
        await asyncio.wait_for(fut, 30)     # evicted at the deadline
    except Exception as e:
        print(type(e).__name__, flush=True)
    await asyncio.sleep(10)                 # the next round: the boundary
    print("SURVIVED", flush=True)

asyncio.run(main())
"""


def test_kill_mid_quiesce_exits_117_before_the_install():
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               **{tfp.ENV_SPEC: "serving.quiesce=kill@1"})
    proc = subprocess.run([sys.executable, "-c", KILL_CHILD], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT))
    assert proc.returncode == tfp.FAULT_EXIT_CODE, proc.stderr[-2000:]
    assert "FAULTPOINT serving.quiesce hit 1: killing process" \
        in proc.stderr
    assert proc.stdout.split() == ["RowEvicted"]     # no install, no exit
