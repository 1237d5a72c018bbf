"""Runtime lock-order witness, ported from ``marian_tpu/common/lockdep.py``.

Every lock of the port's threaded layers is made through
:func:`make_lock` / :func:`make_rlock` with its static identity as the
name: ``<OwningClass>.<attr>`` for an attribute, ``<module>.<NAME>`` for
a module global. With ``MARIAN_LOCKDEP=1`` in the environment (read when
the lock is made) each returned lock is a thin wrapper that records, per
thread, the order in which named locks are taken: holding A while taking
B records the edge A→B. Re-taking a name already held records nothing:
identity is the class-level name, so two instances of one class's lock
may nest without inventing an edge.

The verdict: a cycle among the observed edges is a deadlock two threads
can really interleave into (:func:`observed_cycles`), and :func:`check`
holds what ran against a static model's nodes and edges. The reference
also builds that static model from the source (``check_against_static``,
its ``analysis/callgraph.py``); the port has no such analysis yet, so
:func:`declared_names` stands in for its node set: every
``make_lock("…")`` / ``make_rlock("…")`` literal in ``marian_tpu_torch/``.
At process exit a run that observed a cycle prints it on stderr.

Without ``MARIAN_LOCKDEP=1`` the factories return plain
``threading.Lock`` / ``RLock`` objects: nothing is recorded, nothing is
paid. Stdlib only, and imports nothing of the layers it watches.
"""

from __future__ import annotations

import atexit
import os
import re
import sys
import threading
from pathlib import Path
from typing import Dict, List, Set, Tuple

ENV_VAR = "MARIAN_LOCKDEP"


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


# -- the observed model ------------------------------------------------------
# Guarded by _WITNESS_LOCK, a plain lock and deliberately not witnessed:
# it is taken while witnessed locks are held and would otherwise show up
# as an edge into itself on every first acquisition. The per-thread held
# stacks live in thread-local storage and need no lock.

_WITNESS_LOCK = threading.Lock()
_EDGES: Dict[Tuple[str, str], str] = {}     # (held, acquired) -> thread
_NODES: Set[str] = set()
_TLS = threading.local()
_EXIT_HOOKED = False


def _stack() -> List[Tuple[str, int]]:
    """This thread's held stack of (name, id of the inner lock): the
    name feeds the edge graph, the instance id the self-deadlock check."""
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _record_acquire(name: str, inner_id: int) -> None:
    st = _stack()
    if any(n == name for n, _ in st):
        # the name is held already (a reentrant re-take, or a sibling
        # instance of the same class): no edge, or the legal RLock
        # re-entry would read as a cycle
        st.append((name, inner_id))
        return
    fresh = [(held, name) for held, _ in st
             if held != name and (held, name) not in _EDGES]
    if fresh or name not in _NODES:
        thread = threading.current_thread().name
        with _WITNESS_LOCK:
            _NODES.add(name)
            for e in fresh:
                _EDGES.setdefault(e, thread)
    st.append((name, inner_id))


def _record_release(name: str, inner_id: int) -> None:
    st = _stack()
    for i in range(len(st) - 1, -1, -1):    # the innermost hold first
        if st[i] == (name, inner_id):
            del st[i]
            return
    # a plain Lock may be released by a thread that never took it, but
    # then the taker's stack keeps it forever and every later take there
    # records phantom edges: refuse loudly instead
    raise RuntimeError(
        f"lockdep: {name!r} released on thread "
        f"{threading.current_thread().name!r}, which does not hold it — "
        f"cross-thread release breaks the per-thread acquisition-order "
        f"model; release on the acquiring thread (or don't use this lock "
        f"as a signal)")


class _WitnessedLock:
    """A ``threading.Lock``/``RLock`` that records acquisition order.

    Serves ``with``, ``acquire``/``release`` (an edge is recorded only
    on a successful take, timeouts included), ``locked()`` where the
    inner lock has it, and ``threading.Condition`` (which drives a lock
    without ``_release_save`` through ``acquire``/``release`` on the
    waiting thread). A release on a thread that does not hold the lock
    raises, after the inner lock is released."""

    __slots__ = ("_name", "_inner", "_reentrant")

    def __init__(self, name: str, inner, reentrant: bool = False):
        self._name = name
        self._inner = inner
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and timeout < 0 and not self._reentrant \
                and any(i == id(self._inner) for _, i in _stack()):
            # an untimed blocking re-take of this plain Lock by its own
            # holder can never succeed: fail instead of hanging (a timed
            # take returns False after its timeout and passes through)
            raise RuntimeError(
                f"lockdep: blocking re-acquire of non-reentrant lock "
                f"{self._name!r} on thread "
                f"{threading.current_thread().name!r}, which already "
                f"holds it — guaranteed self-deadlock")
        got = self._inner.acquire(blocking, timeout)
        if got:
            _record_acquire(self._name, id(self._inner))
        return got

    def release(self) -> None:
        self._inner.release()     # first: a refusal must not leave it held
        _record_release(self._name, id(self._inner))

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging nicety
        return f"<lockdep {self._name} wrapping {self._inner!r}>"


def make_lock(name: str):
    """A ``threading.Lock`` named with its static identity
    (``Class.attr`` / ``module.NAME``); witnessed under MARIAN_LOCKDEP=1."""
    if not enabled():
        return threading.Lock()
    _hook_exit_report()
    return _WitnessedLock(name, threading.Lock())


def make_rlock(name: str):
    """The reentrant :func:`make_lock` (re-taking the same name records
    no edge)."""
    if not enabled():
        return threading.RLock()
    _hook_exit_report()
    return _WitnessedLock(name, threading.RLock(), reentrant=True)


# -- inspection and verdict ----------------------------------------------------

def observed_edges() -> Dict[Tuple[str, str], str]:
    with _WITNESS_LOCK:
        return dict(_EDGES)


def observed_nodes() -> Set[str]:
    with _WITNESS_LOCK:
        return set(_NODES)


def reset() -> None:
    """Forget everything observed so far (tests)."""
    with _WITNESS_LOCK:
        _EDGES.clear()
        _NODES.clear()


def elementary_cycles(adj: Dict[str, List[str]]) -> List[List[str]]:
    """Elementary cycles of a directed graph, each once and rotated to
    start at its smallest node (the reference's
    ``analysis/callgraph.py::elementary_cycles``, copied)."""
    cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str],
            on_path: Set[str]) -> None:
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                i = path.index(min(path))
                cycles.add(tuple(path[i:] + path[:i]))
            elif nxt not in on_path and nxt > start:
                # only nodes above start: each cycle is found once,
                # from its smallest node
                path.append(nxt)
                on_path.add(nxt)
                dfs(start, nxt, path, on_path)
                on_path.discard(nxt)
                path.pop()

    for n in sorted(adj):
        dfs(n, n, [n], {n})
    return [list(c) for c in sorted(cycles)]


def observed_cycles() -> List[List[str]]:
    """Elementary cycles among the observed edges: normally none, and
    each one a deadlock two threads can interleave into."""
    adj: Dict[str, List[str]] = {}
    for a, b in observed_edges():
        adj.setdefault(a, []).append(b)
    return elementary_cycles(adj)


def check(static_nodes: Set[str],
          static_edges: Set[Tuple[str, str]]) -> List[str]:
    """What ran that the static model does not hold: unknown lock names,
    unknown edges and any cycle. Empty = the model covered it all."""
    violations: List[str] = []
    for name in sorted(observed_nodes()):
        if name not in static_nodes:
            violations.append(
                f"observed lock {name!r} is unknown to the static graph")
    for (a, b), thread in sorted(observed_edges().items()):
        if (a, b) not in static_edges:
            violations.append(
                f"observed acquisition edge {a} -> {b} (first seen on "
                f"thread {thread!r}) is absent from the static lock-order "
                f"graph")
    for cyc in observed_cycles():
        ring = " -> ".join(cyc + [cyc[0]])
        violations.append(
            f"observed lock-order CYCLE {ring}: two threads can deadlock "
            f"by interleaving these acquisition orders")
    return violations


_DECLARED_RE = re.compile(r"make_r?lock\(\s*[\"']([^\"']+)[\"']")


def declared_names(root=None) -> Set[str]:
    """Every lock name declared by a ``make_lock("…")`` or
    ``make_rlock("…")`` literal in the ``.py`` files under ``root``
    (default: this package): the port's stand-in for the static graph's
    node set."""
    root = Path(root) if root is not None \
        else Path(__file__).resolve().parents[1]
    names: Set[str] = set()
    for path in root.rglob("*.py"):
        if path.resolve() == Path(__file__).resolve():
            continue        # this module's docstrings name no real lock
        names.update(_DECLARED_RE.findall(
            path.read_text(encoding="utf-8")))
    return names


def _exit_report() -> None:  # pragma: no cover — runs in subprocesses
    """Print the observed cycles on stderr at exit. Too late to fail
    anything politely, so it leaves the exit code alone."""
    cycles = observed_cycles()
    if not cycles:
        return
    sys.stderr.write("MARIAN-LOCKDEP: the runtime witness observed "
                     "lock-order cycles:\n")
    for cyc in cycles:
        sys.stderr.write("MARIAN-LOCKDEP:   "
                         + " -> ".join(cyc + [cyc[0]]) + "\n")


def _hook_exit_report() -> None:
    global _EXIT_HOOKED
    if not _EXIT_HOOKED:
        _EXIT_HOOKED = True
        atexit.register(_exit_report)
