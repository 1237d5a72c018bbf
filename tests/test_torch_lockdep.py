"""The port's lock-order witness (``marian_tpu_torch/common/lockdep.py``)
against the JAX package's (``marian_tpu/common/lockdep.py``) on the CPU
(``tests/conftest.py`` arms ``MARIAN_LOCKDEP=1`` for the process):

- one scripted acquisition sequence over two threads (nested takes, a
  reentrant re-take, a failed timed take, two sibling instances of one
  name) records the same nodes, edges and cycles in both;
- the witness refuses what the reference refuses: a cross-thread release
  and an untimed re-take of a held plain lock;
- ``threading.Condition`` drives a witnessed lock through ``wait`` and
  ``notify`` (``translator/iteration.py``'s ``_SYNC_CHANGED``);
- without ``MARIAN_LOCKDEP=1`` the factories return plain locks;
- every lock of the port is made by ``make_lock``/``make_rlock`` under
  its declared name, the tenants' ``warm_lock`` alone excepted, and the
  names ``declared_names`` finds are the reference's and the port's own.

Every test that records resets both witnesses after it, so no scripted
cycle reaches the serving suites' teardown checks.
"""

import re
import threading
from pathlib import Path

import pytest

from marian_tpu.common import lockdep as jld
from marian_tpu_torch.common import lockdep as tld

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def clean():
    assert tld.enabled() and jld.enabled()
    tld.reset()
    jld.reset()
    try:
        yield
    finally:
        tld.reset()
        jld.reset()


def script(ld):
    """Threads one after the other (a real interleaving of the two
    orders could deadlock): A→B→C and a reentrant take on the first,
    C→A and a sibling take on the second, a failed timed take of B under
    C on the third."""
    a, b, c = ld.make_lock("A._lock"), ld.make_lock("B._lock"), \
        ld.make_lock("C._lock")
    r = ld.make_rlock("R._lock")
    a2 = ld.make_lock("A._lock")         # a sibling instance of A

    def first():
        with a:
            with b:
                with c:
                    pass
        with r:
            with r:                      # reentrant: no edge
                with a:
                    pass

    def second():
        with c:
            with a:
                with a2:                 # same name: no edge
                    pass

    def third():
        with c:
            assert b.acquire(timeout=0.05) is False   # failed: no edge

    for fn in (first, second):
        t = threading.Thread(target=fn, name=fn.__name__)
        t.start()
        t.join()
    with b:                              # held here while third fails
        t = threading.Thread(target=third, name="third")
        t.start()
        t.join()


def test_scripted_sequence_records_the_edges_and_cycles_jax_does(clean):
    script(jld)
    script(tld)
    assert tld.observed_nodes() == jld.observed_nodes() == \
        {"A._lock", "B._lock", "C._lock", "R._lock"}
    assert tld.observed_edges() == jld.observed_edges()
    assert set(tld.observed_edges()) == {
        ("A._lock", "B._lock"), ("A._lock", "C._lock"),
        ("B._lock", "C._lock"), ("R._lock", "A._lock"),
        ("C._lock", "A._lock")}
    assert tld.observed_cycles() == [["A._lock", "B._lock", "C._lock"],
                                     ["A._lock", "C._lock"]]
    from marian_tpu.analysis.callgraph import elementary_cycles
    adj = {}
    for x, y in jld.observed_edges():
        adj.setdefault(x, []).append(y)
    assert tld.observed_cycles() == elementary_cycles(adj)
    nodes = tld.observed_nodes()
    edges = set(tld.observed_edges())
    assert [v for v in tld.check(nodes, edges) if "CYCLE" not in v] == []
    assert len(tld.check(nodes, edges)) == 2
    missing = tld.check(nodes - {"R._lock"}, edges - {("A._lock",
                                                       "B._lock")})
    assert any("'R._lock' is unknown" in v for v in missing)
    assert any("A._lock -> B._lock" in v and "absent" in v
               for v in missing)


@pytest.mark.parametrize("ld", [jld, tld], ids=["jax", "torch"])
def test_cross_thread_release_and_self_deadlock_are_refused(clean, ld):
    """On threads of their own: a refused release leaves the taker's
    held stack as it was, which must not be this test's thread."""
    lk = ld.make_lock("X._lock")
    err = []

    def run(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    def release():
        try:
            lk.release()
        except RuntimeError as e:
            err.append(str(e))

    def take_and_hand_over():
        lk.acquire()
        run(release)

    def retake():
        with lk:
            with pytest.raises(RuntimeError, match="self-deadlock"):
                lk.acquire()
            assert lk.acquire(timeout=0.01) is False    # timed: passes
            err.append("retake done")

    run(take_and_hand_over)
    assert err and "cross-thread release" in err[0]
    assert not lk.locked()              # the inner lock was released
    run(retake)
    assert err[1:] == ["retake done"] and not lk.locked()


def test_condition_wait_and_notify_on_a_witnessed_lock(clean):
    lk = tld.make_lock("marian_tpu_torch.translator.iteration._SYNC_LOCK")
    other = tld.make_lock("Y._lock")
    cond = threading.Condition(lk)
    box = []

    def waiter():
        with other:
            with cond:
                assert cond.wait_for(lambda: box, timeout=10)
                box.append("woke")

    t = threading.Thread(target=waiter, name="waiter")
    t.start()
    with cond:
        box.append("go")
        cond.notify_all()
    t.join(10)
    assert not t.is_alive() and box == ["go", "woke"]
    with cond:
        assert cond.wait(timeout=0.01) is False       # times out, re-held
    assert not lk.locked()
    assert set(tld.observed_edges()) == {
        ("Y._lock", "marian_tpu_torch.translator.iteration._SYNC_LOCK")}
    assert tld.observed_cycles() == []


def test_plain_locks_without_the_variable(monkeypatch):
    monkeypatch.delenv(tld.ENV_VAR)
    assert type(tld.make_lock("Z._lock")) is type(threading.Lock())
    assert type(tld.make_rlock("Z._lock")) is type(threading.RLock())


# the reference's names for the locks the port shares with it, and the
# port's own by the same rule
REFERENCE_NAMES = {
    "KVPool._lock", "Tracer._lock", "PerfMeter._lock", "SloEngine._lock",
    "FlightRecorder._lock", "PrefixCache._lock", "_Metric._lock",
    "Registry._lock", "AdmissionController._lock",
    "BrownoutController._lock", "FleetManager._lock",
    "SwapController._lock", "ModelRegistry._lock",
    "ContinuousScheduler._state_lock", "_State.lock"}
PORT_NAMES = {"marian_tpu_torch.ops.kernels._build._lock",
              "marian_tpu_torch.translator.iteration._SYNC_LOCK"}


def test_declared_names_are_the_reference_names_and_the_ports_own():
    declared = tld.declared_names()
    assert declared == REFERENCE_NAMES | PORT_NAMES
    ref = tld.declared_names(ROOT / "marian_tpu")
    assert REFERENCE_NAMES <= ref


def test_every_port_lock_is_witnessed_but_warm_lock():
    plain = []
    for p in sorted((ROOT / "marian_tpu_torch").rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if re.search(r"threading\.R?Lock\(\)", line) \
                    and "common/lockdep.py" not in p.as_posix() \
                    and "common/ownwit.py" not in p.as_posix():
                plain.append((p.relative_to(ROOT).as_posix(), line.strip()))
    assert plain == [("marian_tpu_torch/serving/fleet/tenancy.py",
                      "self.warm_lock = threading.Lock()")]
    from marian_tpu.serving.fleet import tenancy as jten
    assert "self.warm_lock = threading.Lock()" in Path(
        jten.__file__).read_text()
