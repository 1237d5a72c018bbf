"""Deterministic fault injection for crash-safety tests, ported from
``marian_tpu/common/faultpoints.py``.

A fault point is a named site in the program where a test can inject a
failure on demand:

    from ..common import faultpoints as fp
    ...
    fp.fault_point("ckpt.commit")      # a no-op unless armed

Arming is by environment variable (it crosses process boundaries: the
crash-resume tests kill real trainer subprocesses) or from Python (the
in-process tests):

    MARIAN_FAULTS="ckpt.commit=kill@2" python -m marian_tpu_torch.cli.marian_train ...
    with fp.active("serving.translate=hang:0.5"): ...

Spec grammar (a comma-separated list):

    name=mode[:arg][@hit]

    mode  fail        raise InjectedFault           (a simulated IO error)
          kill        os._exit(FAULT_EXIT_CODE)     (a simulated SIGKILL or
                                                     preemption: no cleanup,
                                                     no finally)
          hang:SECS   time.sleep(SECS), then pass   (a stall: watchdog food)
          prob:P      raise with probability P, drawn from
                      (seed, name, hit index)
    @hit  @N   fire on the Nth hit only (1-based; default @1, except
               prob, which defaults to @* so P applies to every hit)
          @N+  fire on every hit from the Nth on
          @*   fire on every hit

Determinism: one (spec, MARIAN_FAULTS_SEED, call sequence) always fires
at the same sites, and ``prob`` draws exactly as the reference does, so
the same spec and seed fire at the same hits in both packages. Hit
counters are per name and process-wide (thread-safe: the serving worker,
the lifecycle's watcher and the training thread all cross fault points).

Every fault point is declared in CATALOG, and an undeclared name raises
``FaultSpecError`` when it is armed or crossed. The reference's
``jit.closure_vary``, ``train.hang`` and ``train.diverge_cost`` wait for
the code they sit in (ROADMAP). Stdlib
only, so any layer and any subprocess driver may import it.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, Optional, Tuple

from . import lockdep

ENV_SPEC = "MARIAN_FAULTS"
ENV_SEED = "MARIAN_FAULTS_SEED"
# a distinctive exit code, so tests tell an injected kill from a crash
FAULT_EXIT_CODE = 117

# The catalog: every fault_point() call site uses one of these names,
# and every name is armed by at least one test
# (tests/test_torch_faultpoints.py holds both). The descriptions are the
# reference's.
CATALOG: Dict[str, str] = {
    "ckpt.write.model":
        "before the model member is written into staging",
    "ckpt.write.optimizer":
        "before the optimizer member is written",
    "ckpt.write.progress":
        "before the progress member is written",
    "ckpt.write.manifest":
        "before the bundle manifest is written",
    "ckpt.commit":
        "after staging is complete, before the atomic staging->bundle "
        "rename (the commit point)",
    "ckpt.publish":
        "after commit, before the legacy top-level view (model.npz etc.) "
        "is republished",
    "ckpt.async.worker": "at the start of the AsyncSaver background job",
    "data.batch.next":
        "in the batch pipeline, before a batch is yielded",
    "serving.dispatch":
        "on the event loop, before a device batch is handed to the "
        "executor",
    "serving.translate":
        "on the device worker thread, before translate_lines runs (hang "
        "mode feeds the dispatch watchdog)",
    "serving.quiesce":
        "on the event loop, at the quiesce boundary — active rows "
        "drained/evicted, before the paged engine is re-pointed at the "
        "new executor (kill = the kill-mid-quiesce chaos schedule)",
    "lifecycle.watch":
        "on the bundle-watcher thread, after a new committed bundle is "
        "discovered, before it is handed to the lifecycle controller",
    "lifecycle.warmup":
        "before the candidate executor is built and golden-smoked (model "
        "load + jit compile happen past this point)",
    "lifecycle.swap":
        "after a successful warmup, before dispatch is re-pointed at the "
        "warmed executor (the hot-swap commit point)",
    "lifecycle.rollback":
        "before a canary/live rollback re-points dispatch at the previous "
        "live version",
    "pool.double_free":
        "detection drill: an armed 'fail' makes the KV pool re-free a "
        "still-claimed row's pages (the double-free bug class) so the "
        "pool auditor is proven against REAL corrupted state, not a "
        "mocked report",
    "pool.table_corrupt":
        "detection drill: an armed 'fail' scribbles a wrong physical page "
        "id into one active row's page table so the auditor's table/claim "
        "cross-check is proven against real corruption",
    "pool.refcount_corrupt":
        "detection drill: an armed 'fail' bumps one live page's refcount "
        "without a table reference (the lost-decref/phantom-incref bug "
        "class of the COW fork/reorder paths) so the auditor's "
        "references-vs-refcount cross-check is proven against real "
        "corruption",
    "pool.release_drop":
        "detection drill: an armed 'fail' makes KVPool.release silently "
        "do nothing — the suppressed-release leak bug class — so the "
        "runtime ownership witness (common/ownwit.py) and the pool "
        "auditors are proven to catch a REAL seeded leak, never a mocked "
        "report",
    "beam.diff_corrupt":
        "detection drill: an armed 'fail' truncates one live slot's "
        "device-computed retable diff before the host refcount plane "
        "applies it — the bad-device-diff bug class of the fused beam "
        "merge — so the pool auditor's table/claim cross-check is proven "
        "to catch a REAL divergence between the device page table and the "
        "host mirror, never a mocked report",
    "tenant.page_leak":
        "detection drill: an armed 'fail' moves one page reference "
        "between the claim lists of owners in DIFFERENT tenants — a page "
        "charged to the wrong tenant. Refcounts are unchanged, so "
        "KVPool.audit() stays green by construction; only the "
        "tenant-level auditor (serving/fleet/accounting.py::audit_tenants) "
        "catches it, proving per-tenant isolation is checked against REAL "
        "mischarged state, never a mocked report",
    "train.nan_grad":
        "divergence drill: an armed 'fail' poisons one training batch's "
        "target mask with NaN before dispatch — the transient bad-batch "
        "bug class — so --check-gradient-nan's skip/revert, the live skip "
        "counter, and the --on-divergence rollback ladder are proven "
        "against a REAL non-finite gradient, never a mocked loss",
}


class InjectedFault(RuntimeError):
    """Raised by an armed 'fail'/'prob' fault point."""


class FaultSpecError(ValueError):
    """Malformed MARIAN_FAULTS spec or undeclared fault-point name."""


class _Spec:
    __slots__ = ("name", "mode", "arg", "hit", "every_from")

    def __init__(self, name: str, mode: str, arg: Optional[float],
                 hit: Optional[int], every_from: Optional[int]):
        self.name = name
        self.mode = mode
        self.arg = arg
        self.hit = hit              # exact hit index (1-based) or None
        self.every_from = every_from  # fire on every hit >= this, or None

    def matches(self, n: int) -> bool:
        if self.every_from is not None:
            return n >= self.every_from
        return n == (self.hit if self.hit is not None else 1)


def _parse_one(piece: str) -> _Spec:
    if "=" not in piece:
        raise FaultSpecError(f"fault spec {piece!r}: expected name=mode")
    name, _, rhs = piece.partition("=")
    name = name.strip()
    if name not in CATALOG:
        raise FaultSpecError(
            f"unknown fault point {name!r} (catalog: "
            f"{', '.join(sorted(CATALOG))})")
    hit: Optional[int] = None
    every_from: Optional[int] = None
    if "@" in rhs:
        rhs, _, hs = rhs.partition("@")
        hs = hs.strip()
        try:
            if hs == "*":
                every_from = 1
            elif hs.endswith("+"):
                every_from = int(hs[:-1])
            else:
                hit = int(hs)
        except ValueError:
            raise FaultSpecError(
                f"fault point {name!r}: bad hit selector @{hs!r} "
                f"(expected @N, @N+, or @*)") from None
        # hit counters are 1-based: @0 would never match and the drill
        # would silently inject nothing
        if (hit is not None and hit < 1) \
                or (every_from is not None and every_from < 1):
            raise FaultSpecError(
                f"fault point {name!r}: hit selector @{hs} must be >= 1")
    mode, _, argtext = rhs.strip().partition(":")
    arg: Optional[float] = float(argtext) if argtext else None
    if mode not in ("fail", "kill", "hang", "prob"):
        raise FaultSpecError(f"fault point {name!r}: unknown mode {mode!r}")
    if mode == "prob" and arg is None:
        raise FaultSpecError(f"fault point {name!r}: prob needs :P")
    if mode == "prob" and hit is None and every_from is None:
        # per-hit probability is the whole point of prob — an implicit
        # @1 would roll the dice exactly once and report a clean drill
        every_from = 1
    return _Spec(name, mode, arg, hit, every_from)


def parse_spec(text: str) -> Dict[str, _Spec]:
    specs: Dict[str, _Spec] = {}
    for piece in text.split(","):
        piece = piece.strip()
        if not piece:
            continue
        s = _parse_one(piece)
        specs[s.name] = s
    return specs


class _State:
    """Process-wide arming state + per-name hit counters."""

    def __init__(self):
        self.lock = lockdep.make_lock("_State.lock")
        self.specs: Dict[str, _Spec] = {}
        self.seed = 0
        self.hits: Dict[str, int] = {}
        self.env_loaded = False


_STATE = _State()


def _load_env_locked() -> None:
    if _STATE.env_loaded:
        return
    text = os.environ.get(ENV_SPEC, "")
    if text:
        # parse BEFORE marking loaded: a malformed spec must raise at
        # EVERY crossing, not raise once and silently disarm the drill
        # (a chaos run with a typo'd spec reporting success would be
        # worse than no drill at all)
        try:
            specs = parse_spec(text)
        except FaultSpecError as e:
            _log(f"FAULTPOINT SPEC ERROR in {ENV_SPEC}: {e}")
            raise
        _STATE.specs.update(specs)
        _STATE.seed = int(os.environ.get(ENV_SEED, "0") or "0")
    _STATE.env_loaded = True


def activate(spec: str, seed: int = 0) -> None:
    """Arm fault points programmatically (replaces any previous arming,
    including the environment's); resets hit counters."""
    parsed = parse_spec(spec)
    with _STATE.lock:
        _STATE.env_loaded = True        # programmatic arming wins over env
        _STATE.specs = parsed
        _STATE.seed = int(seed)
        _STATE.hits = {}


def deactivate() -> None:
    """Disarm everything and reset hit counters (env spec stays ignored
    until reset_for_tests)."""
    with _STATE.lock:
        _STATE.env_loaded = True
        _STATE.specs = {}
        _STATE.hits = {}


def reset_for_tests() -> None:
    """Full reset: disarm AND re-read MARIAN_FAULTS on next hit."""
    with _STATE.lock:
        _STATE.specs = {}
        _STATE.hits = {}
        _STATE.env_loaded = False


class active:
    """Context manager: arm `spec` inside the block, disarm after."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed

    def __enter__(self) -> "active":
        activate(self.spec, seed=self.seed)
        return self

    def __exit__(self, *exc) -> None:
        deactivate()


def hits(name: str) -> int:
    """How many times `name` was crossed since the last (re)arming."""
    with _STATE.lock:
        return _STATE.hits.get(name, 0)


def hit_counts() -> Dict[str, int]:
    """Copy of every per-name hit counter (flight-recorder dumps)."""
    with _STATE.lock:
        return dict(_STATE.hits)


# Observer hooks: the obs layer records firings onto its event
# timeline and dumps the flight recorder before an injected kill. Plain
# lists mutated only at registration time (startup / arm time); firing
# iterates a snapshot, outside _STATE.lock, and swallows hook errors —
# instrumentation must never change whether the drill fires.
_FIRE_HOOKS: list = []     # fn(name, mode, hit) — any armed spec matched
_KILL_HOOKS: list = []     # fn(name, hit) — about to os._exit


def add_fire_hook(fn) -> None:
    if fn not in _FIRE_HOOKS:
        _FIRE_HOOKS.append(fn)


def add_kill_hook(fn) -> None:
    if fn not in _KILL_HOOKS:
        _KILL_HOOKS.append(fn)


def remove_fire_hook(fn) -> None:
    if fn in _FIRE_HOOKS:
        _FIRE_HOOKS.remove(fn)


def remove_kill_hook(fn) -> None:
    if fn in _KILL_HOOKS:
        _KILL_HOOKS.remove(fn)


def _run_hooks(hooks, *args) -> None:
    for fn in list(hooks):
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — observers must not alter drills
            pass


def _log(msg: str) -> None:
    # plain stderr, not the logger: fault points fire in subprocesses
    # before create_loggers, and the kill path must not depend on handler
    # state mid-teardown
    import sys
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def fault_point(name: str) -> None:
    """Cross the named fault point. No-op (one dict lookup under a lock)
    unless armed; raises InjectedFault / sleeps / kills the process when
    the armed spec matches this hit."""
    with _STATE.lock:
        _load_env_locked()
        if name not in CATALOG:
            raise FaultSpecError(f"fault_point({name!r}) is not in the "
                                 f"faultpoints.CATALOG")
        n = _STATE.hits.get(name, 0) + 1
        _STATE.hits[name] = n
        spec = _STATE.specs.get(name)
        if spec is None or not spec.matches(n):
            return
        seed = _STATE.seed
    # act OUTSIDE the lock: hang must not serialize every other fault
    # point behind a sleeping thread, and kill flushes stderr first
    if spec.mode == "prob":
        r = random.Random(f"{seed}:{name}:{n}").random()
        if r >= float(spec.arg or 0.0):
            return
        _run_hooks(_FIRE_HOOKS, name, "prob", n)
        _log(f"FAULTPOINT {name} hit {n}: injected failure (prob)")
        raise InjectedFault(f"injected fault at {name} (hit {n}, prob)")
    _run_hooks(_FIRE_HOOKS, name, spec.mode, n)
    if spec.mode == "fail":
        _log(f"FAULTPOINT {name} hit {n}: injected failure")
        raise InjectedFault(f"injected fault at {name} (hit {n})")
    if spec.mode == "hang":
        secs = float(spec.arg if spec.arg is not None else 3600.0)
        _log(f"FAULTPOINT {name} hit {n}: hanging {secs}s")
        time.sleep(secs)     # hang mode is the drilled stall (watchdog food)
        return
    if spec.mode == "kill":
        _log(f"FAULTPOINT {name} hit {n}: killing process "
             f"(exit {FAULT_EXIT_CODE})")
        # last words: let the flight recorder (obs/flight.py) snapshot
        # the span ring before the simulated SIGKILL erases it
        _run_hooks(_KILL_HOOKS, name, n)
        os._exit(FAULT_EXIT_CODE)


def describe() -> Tuple[Tuple[str, str], ...]:
    """(name, description) rows of the catalog, for docs and drivers."""
    return tuple(sorted(CATALOG.items()))
