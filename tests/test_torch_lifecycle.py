"""The port's zero-downtime model lifecycle (``serving/lifecycle/``)
against the JAX package's, on the CPU with stub executors (no model):
the counterparts of tests/test_lifecycle.py's TestModelRegistry,
TestBundleWatcher, TestWarmupAndSwap, TestCanary, TestAdminAndReadiness,
TestEndToEndHotSwap and TestOutcomeLabels.

- The registry, watcher, warmup and controller cases run the same body
  through both packages (``pkg``) and assert the reference's outcomes.
  Where the reference arms a fault point (``lifecycle.watch``,
  ``lifecycle.swap``, ``lifecycle.rollback``, ``ckpt.publish``), both
  packages get the same failure from a stub at the same place (the
  port has no fault-point plane yet).
- ``test_scripted_outcomes_same_decisions``: both packages'
  SwapControllers, fed the same scripted batch outcomes and latencies
  (a fake clock) through stub executors, take the same transitions,
  make the same rollbacks and promotions, return the same replies and
  give the same ``status()``, batch by batch, and their registries
  render the same exposition text.
- The server cases drive the port's ``ServingApp`` (request mode, stub
  translators) as the reference's tests drive the JAX one; the admin
  case drives the watcher with ``poll_now()`` (its thread stopped), so
  no background poll can re-ingest a rejected bundle mid-test.

Every server binds port 0 and every wait has a deadline.
"""

import asyncio
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from marian_tpu.serving import lifecycle as jlc
from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving.lifecycle import controller as jctl
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu.training import bundle as jbdl
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.serving import lifecycle as tlc
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving.lifecycle import controller as tctl
from marian_tpu_torch.serving.scheduler import ContinuousScheduler
from marian_tpu_torch.training import bundle as tbdl

WAIT = 20.0
PKGS = {
    "jax": types.SimpleNamespace(lc=jlc, ctl=jctl, msm=jmsm, bdl=jbdl,
                                 Scheduler=JScheduler),
    "torch": types.SimpleNamespace(lc=tlc, ctl=tctl, msm=tmsm, bdl=tbdl,
                                   Scheduler=ContinuousScheduler),
}
GEO_A = {"type": "transformer", "dim-emb": 16, "enc-depth": 1}
GEO_B = {"type": "transformer", "dim-emb": 32, "enc-depth": 1}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def run(coro):
    return asyncio.run(coro)


def commit_bundle(bdl, model_path, tag="x", compat=None, member="m.npz"):
    def write(p):
        with open(p, "w", encoding="utf-8") as fh:
            fh.write(tag)
    return bdl.write_bundle(str(model_path), {member: write}, compat=compat)


def damage(bundle_dir, member="m.npz"):
    victim = os.path.join(bundle_dir, member)
    os.chmod(victim, 0o644)
    with open(victim, "w") as fh:
        fh.write("corrupt")


def tag_stub(tag):
    def translate(lines):
        return [f"{tag}:{ln}" for ln in lines]
    return translate


def seq_factory(calls=None):
    def factory(bundle_dir, manifest):
        if calls is not None:
            calls.append(bundle_dir)
        return tag_stub(f"b{manifest['seq']}")
    return factory


def failing_after(n_ok, tag=None):
    """An executor factory whose executors answer ``n_ok`` calls (the
    golden smoke is the first), then raise."""
    def factory(bundle_dir, manifest):
        calls = {"n": 0}

        def translate(lines):
            if calls["n"] >= n_ok:
                raise RuntimeError("candidate decode explodes")
            calls["n"] += 1
            return [f"{tag or 'b' + str(manifest['seq'])}:{ln}"
                    for ln in lines]
        return translate
    return factory


def make_controller(p, factory=None, live_tag="v1", compat=None, reg=None,
                    **kw):
    ctrl = p.lc.SwapController(factory or seq_factory(),
                               metrics_registry=reg or p.msm.Registry(), **kw)
    ctrl.seed_live(0, "boot", tag_stub(live_tag), compat=compat)
    return ctrl


def ingest(p, ctrl, bdir):
    return ctrl.ingest(bdir, p.bdl.validate_bundle(bdir)[2])


# ---------------------------------------------------------------------------
# registry state machine
# ---------------------------------------------------------------------------

class TestModelRegistry:
    def test_full_lifecycle_path(self, pkg):
        lc = pkg.lc
        r = lc.ModelRegistry()
        r.register(1, "bundle-00000001")
        for state in (lc.WARMING, lc.CANARY, lc.LIVE, lc.RETIRED, lc.LIVE):
            r.transition(1, state)
        assert r.get(1).state == lc.LIVE

    @pytest.mark.parametrize("path,bad", [
        ((), "live"),
        (("warming",), "retired"),
        (("warming", "canary", "failed"), "live"),
        (("rejected",), "warming"),
        (("warming", "live", "retired"), "canary"),
    ])
    def test_illegal_transitions_raise(self, pkg, path, bad):
        r = pkg.lc.ModelRegistry()
        r.register(1, "b1")
        for state in path:
            r.transition(1, state)
        with pytest.raises(pkg.lc.LifecycleError, match="illegal transition"):
            r.transition(1, bad)

    def test_duplicate_register_raises_until_terminal(self, pkg):
        r = pkg.lc.ModelRegistry()
        r.register(1, "b1")
        with pytest.raises(pkg.lc.LifecycleError, match="already registered"):
            r.register(1, "b1")
        r.transition(1, pkg.lc.REJECTED)
        r.register(1, "b1-retry")

    def test_unknown_version_and_state(self, pkg):
        r = pkg.lc.ModelRegistry()
        with pytest.raises(pkg.lc.LifecycleError,
                           match="unknown model version"):
            r.transition(7, pkg.lc.WARMING)
        r.register(1, "b1")
        with pytest.raises(pkg.lc.LifecycleError, match="unknown lifecycle"):
            r.transition(1, "zombie")

    def test_snapshot_newest_first(self, pkg):
        r = pkg.lc.ModelRegistry()
        r.register(1, "b1")
        r.register(2, "b2", compat=pkg.bdl.compat_block(GEO_A))
        rows = r.snapshot()
        assert [row["seq"] for row in rows] == [2, 1]
        assert rows[0]["state"] == pkg.lc.STAGED
        assert rows[0]["compat_hash"] == jbdl.compat_hash(
            jbdl.compat_block(GEO_A))
        assert rows[1]["compat_hash"] == "none"

    def test_scan_bundles_flags_damage(self, pkg, tmp_path):
        mp = str(tmp_path / "m.npz")
        commit_bundle(pkg.bdl, mp, tag="one")
        b2 = commit_bundle(pkg.bdl, mp, tag="two")
        damage(b2)
        infos = pkg.lc.scan_bundles(mp)
        assert [i.seq for i in infos] == [1, 2]
        assert infos[0].ok and not infos[1].ok


def test_registries_snapshot_alike(tmp_path):
    """One scripted path through both registries: the same rows."""
    rows = {}
    for name, p in PKGS.items():
        r = p.lc.ModelRegistry()
        r.register(3, "bundle-00000003", str(tmp_path),
                   compat=p.bdl.compat_block(GEO_B))
        r.register(1, "boot")
        r.transition(1, "warming")
        r.transition(1, "live")
        r.transition(3, "warming")
        r.transition(3, "failed", "golden smoke failed")
        rows[name] = r.snapshot()
    assert rows["jax"] == rows["torch"]


# ---------------------------------------------------------------------------
# bundle watcher
# ---------------------------------------------------------------------------

class TestBundleWatcher:
    def _watch(self, p, mp, got, **kw):
        return p.lc.BundleWatcher(
            p.bdl.bundle_root(str(mp)),
            lambda bdir, man: got.append((bdir, man["seq"])), **kw)

    def test_picks_up_fresh_commit_once(self, pkg, tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        assert w.poll_now() is None
        bdir = commit_bundle(pkg.bdl, mp)
        assert w.poll_now() == bdir
        assert w.poll_now() is None
        assert got == [(bdir, 1)]

    def test_newest_wins_across_a_gap(self, pkg, tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        commit_bundle(pkg.bdl, mp, tag="one")
        commit_bundle(pkg.bdl, mp, tag="two")
        w.poll_now()
        assert [seq for _, seq in got] == [2]

    def test_damaged_newest_does_not_shadow_valid_older(self, pkg,
                                                        tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        b1 = commit_bundle(pkg.bdl, mp, tag="one")
        damage(commit_bundle(pkg.bdl, mp, tag="two"))
        assert w.poll_now() == b1
        b3 = commit_bundle(pkg.bdl, mp, tag="three")
        assert w.poll_now() == b3
        assert [seq for _, seq in got] == [1, 3]

    def test_invalid_newest_skipped_next_seq_delivered(self, pkg, tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        damage(commit_bundle(pkg.bdl, mp, tag="one"))
        assert w.poll_now() is None
        b2 = commit_bundle(pkg.bdl, mp, tag="two")
        assert w.poll_now() == b2
        assert got == [(b2, 2)]

    def test_thread_delivers_on_notify(self, pkg, tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got, interval=30.0)
        w.start()
        try:
            commit_bundle(pkg.bdl, mp)
            w.notify()
            deadline = time.monotonic() + WAIT
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            w.stop()
        assert [seq for _, seq in got] == [1]

    def test_transient_discovery_failure_redelivers(self, pkg, tmp_path,
                                                    monkeypatch):
        """The reference arms lifecycle.watch=fail; here the validation
        right after it raises once: the bundle is re-delivered by the
        next poll, not lost."""
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        bdir = commit_bundle(pkg.bdl, mp)
        real = pkg.bdl.validate_bundle

        def once(*a, **k):
            monkeypatch.setattr(pkg.bdl, "validate_bundle", real)
            raise OSError("transient discovery failure")
        monkeypatch.setattr(pkg.bdl, "validate_bundle", once)
        with pytest.raises(OSError):
            w.poll_now()
        assert got == []
        assert w.poll_now() == bdir
        assert got == [(bdir, 1)]

    def test_same_tick_commit_not_skipped(self, pkg, tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        commit_bundle(pkg.bdl, mp, tag="one")
        w.poll_now()
        b2 = commit_bundle(pkg.bdl, mp, tag="two")
        os.utime(pkg.bdl.bundle_root(str(mp)),
                 ns=(w._last_mtime_ns, w._last_mtime_ns))
        assert w.poll_now() == b2
        assert [seq for _, seq in got] == [1, 2]

    def test_notify_defeats_stale_mtime_short_circuit(self, pkg, tmp_path):
        mp = tmp_path / "m.npz"
        got = []
        w = self._watch(pkg, mp, got)
        root = pkg.bdl.bundle_root(str(mp))
        old_ns = time.time_ns() - 3_600 * 10**9
        commit_bundle(pkg.bdl, mp, tag="one")
        os.utime(root, ns=(old_ns, old_ns))
        w.poll_now()
        b2 = commit_bundle(pkg.bdl, mp, tag="two")
        os.utime(root, ns=(old_ns, old_ns))
        assert w.poll_now() is None
        w.notify()
        assert w.poll_now() == b2
        assert [seq for _, seq in got] == [1, 2]


# ---------------------------------------------------------------------------
# warmup + compat refusal + swap controller
# ---------------------------------------------------------------------------

class TestWarmupAndSwap:
    def test_immediate_swap_after_warmup(self, pkg, tmp_path):
        reg = pkg.msm.Registry()
        ctrl = make_controller(pkg, reg=reg)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.LIVE
        assert ctrl.registry.get(0).state == pkg.lc.RETIRED
        assert ctrl.route(["x"]) == ["b1:x"]
        assert reg.get("marian_lifecycle_swaps_total").value == 1
        assert 'marian_model_info{model_version="bundle-00000001"' \
            in reg.render()
        assert ctrl.live_version_name() == "bundle-00000001"

    def test_compat_mismatch_refused_without_loading(self, pkg, tmp_path):
        calls = []
        reg = pkg.msm.Registry()
        ctrl = make_controller(pkg, factory=seq_factory(calls), reg=reg,
                               compat=pkg.bdl.compat_block(GEO_A))
        bdir = commit_bundle(pkg.bdl, tmp_path / "m.npz",
                             compat=pkg.bdl.compat_block(GEO_B))
        v = ingest(pkg, ctrl, bdir)
        assert v.state == pkg.lc.REJECTED and "config hash" in v.error
        assert calls == []
        assert ctrl.route(["x"]) == ["v1:x"]
        assert reg.get("marian_lifecycle_rejects_total") \
                  .labels("compat").value == 1

    def test_v1_manifest_swaps_permissively(self, pkg, tmp_path):
        ctrl = make_controller(pkg, compat=pkg.bdl.compat_block(GEO_A))
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.LIVE

    def test_warmup_failure_keeps_live(self, pkg, tmp_path):
        reg = pkg.msm.Registry()

        def broken_factory(bundle_dir, manifest):
            raise RuntimeError("weights will not load")

        ctrl = make_controller(pkg, factory=broken_factory, reg=reg)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.FAILED and "will not load" in v.error
        assert ctrl.route(["x"]) == ["v1:x"]
        assert reg.get("marian_lifecycle_rejects_total") \
                  .labels("warmup").value == 1

    def test_golden_smoke_arity_failure_refuses(self, pkg, tmp_path):
        ctrl = make_controller(
            pkg, factory=lambda b, m: (lambda lines: ["one"]))
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.FAILED and "misalign" in v.error

    def test_failed_install_live_survives(self, pkg, tmp_path):
        """The reference arms lifecycle.swap=fail at the swap's commit
        point; here the swap raises once at the same place: the old
        live keeps serving, a later bundle swaps cleanly."""
        reg = pkg.msm.Registry()
        ctrl = make_controller(pkg, reg=reg)
        real = ctrl._swap_to_live

        def once(v):
            ctrl._swap_to_live = real
            raise RuntimeError("swap failed at its commit point")
        ctrl._swap_to_live = once
        mp = tmp_path / "m.npz"
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, mp, tag="one"))
        assert v.state == pkg.lc.FAILED and v.executor is None
        assert ctrl.route(["x"]) == ["v1:x"]
        assert reg.get("marian_lifecycle_rejects_total") \
                  .labels("install").value == 1
        v2 = ingest(pkg, ctrl, commit_bundle(pkg.bdl, mp, tag="two"))
        assert v2.state == pkg.lc.LIVE
        assert ctrl.route(["x"]) == ["b2:x"]

    def test_warmup_golden_file_loads_and_empty_refused(self, pkg,
                                                        tmp_path):
        g = tmp_path / "golden.txt"
        g.write_text("a b\n\nc d e\n")
        assert pkg.lc.load_golden(str(g)) == ["a b", "c d e"]
        (tmp_path / "empty.txt").write_text("\n\n")
        with pytest.raises(pkg.lc.WarmupError, match="no sentences"):
            pkg.lc.load_golden(str(tmp_path / "empty.txt"))
        assert pkg.lc.load_golden(None) == list(pkg.lc.DEFAULT_GOLDEN)
        assert jlc.DEFAULT_GOLDEN == tlc.DEFAULT_GOLDEN

    def test_reply_with_a_newline_refused(self, tmp_path):
        """The port checks the golden replies too: a reply that would
        split the server's newline-joined reply frame fails warmup."""
        ctrl = make_controller(
            PKGS["torch"],
            factory=lambda b, m: (lambda lines: ["a\nb"] * len(lines)))
        v = ingest(PKGS["torch"], ctrl,
                   commit_bundle(tbdl, tmp_path / "m.npz"))
        assert v.state == tlc.FAILED and "one-line string" in v.error


class TestCanary:
    def test_canary_promotes_after_healthy_batches(self, pkg, tmp_path):
        reg = pkg.msm.Registry()
        ctrl = make_controller(pkg, reg=reg, canary_fraction=0.5,
                               canary_min_batches=4)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.CANARY
        outs = [ctrl.route([f"s{i}"])[0] for i in range(16)]
        assert v.state == pkg.lc.LIVE
        assert any(o.startswith("b1:") for o in outs)
        assert any(o.startswith("v1:") for o in outs)
        assert ctrl.registry.get(0).state == pkg.lc.RETIRED
        assert reg.get("marian_model_requests_total") \
                  .labels("bundle-00000001").value >= 4

    def test_high_error_canary_rolls_back_with_zero_client_failures(
            self, pkg, tmp_path):
        reg = pkg.msm.Registry()
        ctrl = make_controller(pkg, factory=failing_after(1), reg=reg,
                               canary_fraction=1.0, rollback_error_rate=0.5,
                               rollback_min_batches=2)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.CANARY
        outs = [ctrl.route([f"s{i}"])[0] for i in range(8)]
        assert all(o.startswith("v1:") for o in outs)
        assert v.state == pkg.lc.FAILED and "failure rate" in v.error
        assert reg.get("marian_lifecycle_rollbacks_total").value == 1
        assert reg.get("marian_model_errors_total") \
                  .labels("bundle-00000001").value >= 2
        assert ctrl.route(["after"])[0] == "v1:after"
        assert ctrl.status()["canary"] is None

    def test_aborted_rollback_retries_next_batch(self, pkg, tmp_path):
        """The reference arms lifecycle.rollback=fail@1; here the first
        canary rollback raises at the same place: routing stands, the
        next canary batch retries and lands it."""
        ctrl = make_controller(pkg, factory=failing_after(1),
                               canary_fraction=1.0, rollback_min_batches=1)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        real, hits = ctrl._rollback_canary, []

        def once(canary, reason):
            hits.append(reason)
            if len(hits) == 1:
                raise RuntimeError("rollback failed")
            return real(canary, reason)
        ctrl._rollback_canary = once
        assert ctrl.route(["a"]) == ["v1:a"]
        assert v.state == pkg.lc.CANARY
        assert ctrl.route(["b"]) == ["v1:b"]
        assert len(hits) == 2
        assert v.state == pkg.lc.FAILED

    def test_p99_regression_rolls_back(self, pkg, tmp_path):
        def slow_factory(bundle_dir, manifest):
            calls = {"n": 0}

            def translate(lines):
                if calls["n"]:
                    time.sleep(0.03)
                calls["n"] += 1
                return [f"slow:{ln}" for ln in lines]
            return translate

        ctrl = make_controller(pkg, factory=slow_factory,
                               canary_fraction=0.5,
                               canary_min_batches=10_000,
                               rollback_p99_factor=3.0)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        for i in range(90):
            ctrl.route([f"s{i}"])
            if v.state == pkg.lc.FAILED:
                break
        assert v.state == pkg.lc.FAILED and "p99" in v.error

    def test_regressed_live_rolls_back_to_previous(self, pkg, tmp_path):
        ctrl = make_controller(pkg, factory=failing_after(3),
                               rollback_min_batches=2)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.LIVE
        for i in range(8):
            try:
                ctrl.route([f"s{i}"])
            except RuntimeError:
                pass
        assert v.state == pkg.lc.FAILED and "failure rate" in v.error
        assert ctrl.registry.get(0).state == pkg.lc.LIVE
        assert ctrl.route(["after"])[0] == "v1:after"

    def test_canary_error_on_promotion_eligible_batch_not_promoted(
            self, pkg, tmp_path):
        def once_bad_factory(bundle_dir, manifest):
            calls = {"n": 0}

            def translate(lines):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("transient canary failure")
                return [f"b{manifest['seq']}:{ln}" for ln in lines]
            return translate

        ctrl = make_controller(pkg, factory=once_bad_factory,
                               canary_fraction=1.0, canary_min_batches=1,
                               rollback_error_rate=1.0,
                               rollback_min_batches=2)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert v.state == pkg.lc.CANARY
        assert ctrl.route(["a"]) == ["v1:a"]
        assert v.state == pkg.lc.CANARY
        assert ctrl.route(["b"]) == ["b1:b"]
        assert v.state == pkg.lc.LIVE

    def test_superseded_canary_retired_and_released(self, pkg, tmp_path):
        ctrl = make_controller(pkg, canary_fraction=0.5,
                               canary_min_batches=10_000)
        mp = tmp_path / "m.npz"
        v1 = ingest(pkg, ctrl, commit_bundle(pkg.bdl, mp, tag="one"))
        assert v1.state == pkg.lc.CANARY
        v2 = ingest(pkg, ctrl, commit_bundle(pkg.bdl, mp, tag="two"))
        assert v2.state == pkg.lc.CANARY
        assert v1.state == pkg.lc.RETIRED and "superseded" in v1.error
        assert v1.executor is None
        st = ctrl.status()
        assert st["canary"] == "bundle-00000002"
        assert [r for r in st["versions"]
                if r["state"] == pkg.lc.CANARY] == [st["versions"][0]]
        outs = {ctrl.route([f"s{i}"])[0].split(":")[0] for i in range(8)}
        assert outs == {"v1", "b2"}

    def test_executors_released_when_leaving_rollback_set(self, pkg,
                                                          tmp_path):
        ctrl = make_controller(pkg)
        boot = ctrl.registry.get(0)
        for tag in ("one", "two", "three"):
            ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz",
                                            tag=tag))
        assert ctrl.registry.get(3).state == pkg.lc.LIVE
        assert ctrl.registry.get(2).state == pkg.lc.RETIRED
        assert ctrl.registry.get(2).executor is not None
        assert ctrl.registry.get(1).executor is None
        assert boot.executor is None
        assert ctrl.route(["x"]) == ["b3:x"]

    def test_failed_canary_executor_released(self, pkg, tmp_path):
        ctrl = make_controller(pkg, factory=failing_after(1),
                               canary_fraction=1.0, rollback_min_batches=1)
        v = ingest(pkg, ctrl, commit_bundle(pkg.bdl, tmp_path / "m.npz"))
        assert ctrl.route(["a"]) == ["v1:a"]
        assert v.state == pkg.lc.FAILED
        assert v.executor is None


# ---------------------------------------------------------------------------
# the two controllers on one script
# ---------------------------------------------------------------------------

class _Clock:
    """perf_counter for a controller module: advanced by the stubs."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


# per bundle seq: each call's (outcome, seconds); the first call is the
# golden smoke, 'x' raises. With 80 batches a bundle at --canary-fraction
# 0.5 and 24 canary batches to promote: 1 promotes; 2 fails its error
# rate as a canary; 3 is slow, rolled back on p99 once both sides have
# 20 latency samples; 4 promotes, then fails as live and rolls back to
# the retained previous version.
SCRIPTS = {
    1: [("ok", 0.01)] * 200,
    2: [("ok", 0.01)] + [("x", 0.01), ("ok", 0.01), ("x", 0.01)] * 70,
    3: [("ok", 0.01)] + [("ok", 0.2)] * 200,
    4: [("ok", 0.01)] * 25 + [("x", 0.01)] * 200,
}
BATCHES = 80


def _scripted(clock, live_s=0.01):
    def factory(bundle_dir, manifest):
        seq = int(manifest["seq"])
        script = list(SCRIPTS[seq])

        def translate(lines):
            outcome, dt = script.pop(0) if script else ("ok", 0.01)
            clock.t += dt
            if outcome == "x":
                raise RuntimeError(f"b{seq} scripted failure")
            return [f"b{seq}:{ln}" for ln in lines]
        return translate

    def live(lines):
        clock.t += live_s
        return [f"v1:{ln}" for ln in lines]
    return factory, live


def _run_script(p, tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(p.ctl, "time", clock)
    factory, live = _scripted(clock)
    reg = p.msm.Registry()
    ctrl = p.lc.SwapController(factory, metrics_registry=reg,
                               canary_fraction=0.5, canary_min_batches=24,
                               rollback_error_rate=0.5,
                               rollback_p99_factor=4.0)
    ctrl.seed_live(0, "boot", live)
    mp = tmp_path / "m.npz"
    trace = []

    def snap(tag, out):
        st = ctrl.status()
        for row in st["versions"]:
            row.pop("bundle_dir")
        trace.append((tag, out, st))

    for seq in sorted(SCRIPTS):
        bdir = commit_bundle(p.bdl, mp, tag=str(seq))
        v = ingest(p, ctrl, bdir)
        snap(f"ingest {seq}", v.state)
        for i in range(BATCHES):
            try:
                out = ctrl.route([f"{seq}.{i}"])
            except RuntimeError as e:
                out = f"error: {e}"
            snap(f"batch {seq}.{i}", out)
    ok, rolled = ctrl.rollback(), None
    snap("manual rollback", ok)
    rolled = [(k, c.value) for k, c in sorted(
        reg.get("marian_lifecycle_rollbacks_total").children().items())]
    swaps = reg.get("marian_lifecycle_swaps_total").value
    rollbacks = reg.get("marian_lifecycle_rollbacks_total").value
    return trace, (rolled, swaps, rollbacks), reg.render()


def test_scripted_outcomes_same_decisions(tmp_path, monkeypatch):
    got = {}
    for name, p in PKGS.items():
        (tmp_path / name).mkdir()
        got[name] = _run_script(p, tmp_path / name, monkeypatch)
    jt, jc, jtext = got["jax"]
    tt, tc, ttext = got["torch"]
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a == b, a[0]
    assert jc == tc
    # the lifecycle's 8 series, value by value, in the same text
    assert ttext == jtext
    assert ttext.count("# TYPE marian_") == 8
    # the script exercised every decision: promotions (1, 4), the
    # error-rate (2) and p99 (3) rollbacks of canaries, the live
    # regression's rollback (4), and a manual verb with no target left
    states = {r["version"]: (r["state"], r["error"])
              for r in tt[-1][2]["versions"]}
    assert states["bundle-00000001"] == ("live", "")
    assert states["bundle-00000002"][0] == "failed" \
        and "failure rate" in states["bundle-00000002"][1]
    assert states["bundle-00000003"][0] == "failed" \
        and "p99" in states["bundle-00000003"][1]
    assert states["bundle-00000004"][0] == "failed" \
        and "live failure rate" in states["bundle-00000004"][1]
    assert tt[-1][1] is False
    assert tc[1:] == (2.0, 3.0)


# ---------------------------------------------------------------------------
# the port's server: admin verbs, /lifecyclez, readiness, hot swap
# ---------------------------------------------------------------------------

def make_app(tmp_path, translate=None, factory=None, **opt):
    from marian_tpu_torch.server.server import ServingApp
    base = {"batch-token-budget": 256, "max-queue": 512,
            "request-timeout": 0.0, "metrics-port": 0,
            "models": [str(tmp_path / "m.npz")], "model-watch": 0.05}
    base.update(opt)
    return ServingApp(Options(base), translate_lines=translate
                      or tag_stub("v1"), registry=tmsm.Registry(),
                      executor_factory=factory or seq_factory())


def http(base, path, method="GET"):
    req = urllib.request.Request(base + path, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as fh:
            return fh.status, fh.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestAdminAndReadiness:
    def test_lifecyclez_and_admin_verbs_over_http(self, tmp_path):
        mp = str(tmp_path / "m.npz")

        async def scenario():
            # a watch interval no test waits out: the watcher is driven
            # with poll_now() after its thread is stopped
            app = make_app(tmp_path, **{"model-watch": 3600.0})
            app.start()
            app.watcher.stop()
            srv = tmsm.MetricsServer(0, registry=app.registry,
                                     ready_fn=app.ready,
                                     routes=app._admin_routes()).start()
            base = f"http://127.0.0.1:{srv.port}"
            loop = asyncio.get_event_loop()

            async def call(path, method="GET"):
                return await loop.run_in_executor(None, http, base, path,
                                                  method)
            try:
                code, body = await call("/lifecyclez")
                state = json.loads(body)
                assert code == 200 and state["live"] == "boot"
                assert state["versions"][0]["state"] == "live"
                assert (await call("/admin/pin"))[0] == 405
                assert (await call("/admin/rollback", "POST"))[0] == 409
                code, body = await call("/admin/pin", "POST")
                assert code == 200 and json.loads(body)["ok"]
                commit_bundle(tbdl, mp)
                assert app.watcher.poll_now() is not None
                assert app.lifecycle.registry.get(1).state == tlc.REJECTED
                assert json.loads((await call("/lifecyclez"))[1])["pinned"]
                assert (await call("/admin/unpin", "POST"))[0] == 200
                commit_bundle(tbdl, mp, tag="two")
                assert app.watcher.poll_now() is not None
                assert json.loads((await call("/lifecyclez"))[1])["live"] \
                    == "bundle-00000002"
                code, body = await call("/admin/rollback", "POST")
                assert code == 200 and json.loads(body)["live"] == "boot"
                code, body = await call("/admin/rollback", "POST")
                assert code == 200 \
                    and json.loads(body)["live"] == "bundle-00000002"
                # the served replies follow the verbs
                assert await app.handle_frame("x") == "b2:x"
            finally:
                srv.close()
                await app.shutdown(drain_timeout=2.0)

        run(scenario())

    def test_readyz_reflects_lifecycle_liveness(self, tmp_path):
        async def scenario():
            app = make_app(tmp_path)
            assert not app.ready()
            app.start()
            assert app.ready()
            app.admission.begin_drain()
            assert not app.ready()
            await app.shutdown(drain_timeout=2.0)

        run(scenario())

    def test_boot_adopts_newest_bundle_seq(self, tmp_path):
        mp = str(tmp_path / "m.npz")
        compat = tbdl.compat_block(GEO_A)
        commit_bundle(tbdl, mp, tag="one", compat=compat)

        async def scenario():
            app = make_app(tmp_path, **{"model-watch": 3600.0})
            app.start()
            app.watcher.stop()
            try:
                assert app.lifecycle.status()["live"] == "bundle-00000001"
                assert app.watcher.poll_now() is None
                assert app.lifecycle.registry.get(1).compat == compat
            finally:
                await app.shutdown(drain_timeout=2.0)

        run(scenario())

    def test_boot_with_stale_publish_swaps_to_newest(self, tmp_path,
                                                     monkeypatch):
        """A save killed between the bundle commit and the flat publish
        (the reference arms ckpt.publish=fail; here the publish raises):
        boot seeds the version the flat file IS, and the watcher swaps
        to the newest."""
        mp = str(tmp_path / "m.npz")
        compat = tbdl.compat_block(GEO_A)
        commit_bundle(tbdl, mp, tag="one", compat=compat)

        def killed(*a, **k):
            raise RuntimeError("killed before the publish")
        monkeypatch.setattr(tbdl, "_publish", killed)
        with pytest.raises(RuntimeError, match="publish"):
            commit_bundle(tbdl, mp, tag="two", compat=compat)
        monkeypatch.undo()
        app = make_app(tmp_path)
        try:
            assert app.lifecycle.status()["live"] == "bundle-00000001"
            assert app.watcher.poll_now() is not None
            assert app.lifecycle.status()["live"] == "bundle-00000002"
        finally:
            app.close_nowait()


class TestEndToEndHotSwap:
    def test_swap_under_load_zero_failures_version_flips(self, tmp_path):
        mp = str(tmp_path / "m.npz")
        compat = tbdl.compat_block(GEO_A)
        commit_bundle(tbdl, mp, tag="one", compat=compat)

        async def scenario():
            app = make_app(tmp_path)
            app.start()
            replies, flipped_at = [], None
            try:
                for i in range(600):
                    r = await app.handle_frame(f"s{i}")
                    replies.append(r)
                    if i == 20:
                        commit_bundle(tbdl, mp, tag="two", compat=compat)
                    if flipped_at is None and r.startswith("b2:"):
                        flipped_at = i
                    if flipped_at is not None and i >= flipped_at + 20:
                        break
                    await asyncio.sleep(0.002)
            finally:
                await app.shutdown(drain_timeout=5.0)
            return app, replies, flipped_at

        app, replies, flipped_at = run(scenario())
        assert [r for r in replies if r.startswith("!!") or not r] == []
        assert flipped_at is not None
        assert replies[0].startswith("bundle") is False
        assert all(r.startswith("b2:") for r in replies[flipped_at:])
        text = app.registry.render()
        assert 'marian_model_info{model_version="bundle-00000002"' in text
        assert ('marian_serving_request_outcomes_total{outcome="ok",'
                'model_version="bundle-00000002"}') in text
        ok_total = sum(
            c.value for key, c in app.registry.get(
                "marian_serving_request_outcomes_total").children().items()
            if key[0] == "ok")
        assert ok_total == len(replies)

    def test_canary_swap_under_load_with_injected_failures(self, tmp_path):
        mp = str(tmp_path / "m.npz")
        compat = tbdl.compat_block(GEO_A)
        commit_bundle(tbdl, mp, tag="one", compat=compat)
        app = make_app(tmp_path, factory=failing_after(1),
                       **{"canary-fraction": 1.0,
                          "rollback-error-rate": 0.5})

        async def scenario():
            app.start()
            replies = []
            try:
                for i in range(400):
                    replies.append(await app.handle_frame(f"s{i}"))
                    if i == 10:
                        commit_bundle(tbdl, mp, tag="two", compat=compat)
                    if app.registry.get(
                            "marian_lifecycle_rollbacks_total").value \
                            and i >= 30:
                        break
                    await asyncio.sleep(0.002)
            finally:
                await app.shutdown(drain_timeout=5.0)
            return replies

        replies = run(scenario())
        assert all(r.startswith("v1:") for r in replies)
        assert app.registry.get(
            "marian_lifecycle_rollbacks_total").value == 1
        assert app.lifecycle.registry.get(2).state == tlc.FAILED
        assert app.lifecycle.live_version_name() == "bundle-00000001"

    def test_in_process_commit_pushes_the_watcher(self, tmp_path):
        """A trainer in the server's process: the commit hook notifies
        the watcher, which swaps without waiting out its interval."""
        mp = str(tmp_path / "m.npz")
        commit_bundle(tbdl, mp, tag="one")

        async def scenario():
            app = make_app(tmp_path, **{"model-watch": 3600.0})
            app.start()
            try:
                await asyncio.sleep(0.1)      # the thread's first poll
                commit_bundle(tbdl, mp, tag="two")
                loop = asyncio.get_event_loop()
                dl = loop.time() + WAIT
                while app.lifecycle.live_version_name() \
                        != "bundle-00000002" and loop.time() < dl:
                    await asyncio.sleep(0.01)
                return await app.handle_frame("x")
            finally:
                await app.shutdown(drain_timeout=2.0)

        assert run(scenario()) == "b2:x"


# ---------------------------------------------------------------------------
# scheduler outcome labels
# ---------------------------------------------------------------------------

class TestOutcomeLabels:
    def test_outcomes_labeled_with_version(self, pkg):
        reg = pkg.msm.Registry()
        state = {"fail": False}

        def translate(lines):
            if state["fail"]:
                raise ValueError("boom")
            return list(lines)

        async def scenario():
            s = pkg.Scheduler(translate, window_s=0, registry=reg,
                              version_fn=lambda: "vX")
            s.start()
            await s.submit(["ok"])
            state["fail"] = True
            with pytest.raises(RuntimeError):
                await s.submit(["bad"])
            await s.stop()

        run(scenario())
        text = reg.render()
        assert ('marian_serving_request_outcomes_total{outcome="ok",'
                'model_version="vX"} 1') in text
        assert ('marian_serving_request_outcomes_total{outcome="failure",'
                'model_version="vX"} 1') in text

    def test_version_fn_failure_never_breaks_resolution(self, pkg):
        reg = pkg.msm.Registry()

        def broken_version():
            raise RuntimeError("label source gone")

        async def scenario():
            s = pkg.Scheduler(lambda lines: list(lines), window_s=0,
                              registry=reg, version_fn=broken_version)
            s.start()
            out = await s.submit(["x"])
            await s.stop()
            return out

        assert run(scenario()) == ["x"]
        assert ('marian_serving_request_outcomes_total{outcome="ok",'
                'model_version="unknown"} 1') in reg.render()

    def test_timeout_and_cancel_outcomes(self, pkg):
        reg = pkg.msm.Registry()
        release = threading.Event()

        def translate(lines):
            release.wait(WAIT)
            return list(lines)

        async def scenario():
            s = pkg.Scheduler(translate, window_s=0, registry=reg,
                              version_fn=lambda: "v")
            s.start()
            try:
                with pytest.raises(Exception):
                    await s.submit(["slow"], timeout=0.05)
                fut = s.submit(["queued"])
                await asyncio.sleep(0.05)
                fut.cancel()
                await asyncio.sleep(0.05)
            finally:
                release.set()
                await s.stop()

        run(scenario())
        out = reg.get("marian_serving_request_outcomes_total")
        got = {k: c.value for k, c in out.children().items()}
        assert got[("timeout", "v")] == 1 and got[("cancelled", "v")] == 1


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
