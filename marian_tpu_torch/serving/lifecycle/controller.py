"""SwapController — atomic hot-swap, canary routing, auto-rollback; a
copy of ``marian_tpu/serving/lifecycle/controller.py`` (the dispatch
half of the zero-downtime control plane).

The controller installs itself as the scheduler's ``translate_lines``
(request mode): ``route()`` runs on the device worker thread, once per
device batch, and picks which version's executor serves it. Because the
scheduler reads its backend once per batch, re-pointing here is atomic
AT BATCH GRANULARITY — an in-flight batch finishes on the executor it
started with (the closure keeps the old model alive), the next batch
sees the new one, and no request is ever dropped or split across
versions. In iteration mode (``attach_iteration``) a swap re-points the
scheduler's paged engine through its quiesce protocol instead.

Canary routing (``--canary-fraction f``): while a warmed candidate is in
``canary`` state, a deterministic f-fraction of batches (counter-based,
not random — reproducible under test) routes to it; per-version
request/error/latency series (``marian_model_*``) record both sides.

Auto-rollback:

- **canary phase** — if the canary's windowed failure rate exceeds
  ``--rollback-error-rate``, or its p99 exceeds
  ``--rollback-p99-factor`` x the live p99 (0 = p99 check off), the
  canary is failed and dispatch stays on live. A canary batch that
  errors is transparently RE-SERVED by the live executor, so a bad
  canary costs latency, never client-visible failures.
- **post-swap** — after a full swap the previous live version is kept
  warm as the rollback target; if the new live's windowed failure rate
  crosses the threshold, dispatch rolls back to it (once — no
  ping-pong; the failed version is terminal).

Promotion: a canary that serves ``canary_min_batches`` batches without
tripping either condition is promoted to live (the old live retires into
the rollback slot).

Memory: every warmed executor holds a whole model on the card (and in
iteration mode its KV pool). ``_release`` drops the controller's
references once a version leaves {live, canary, rollback target}; the
executor a batch captured in ``_pick`` lives until that batch returns.

Threading: ``route`` (device worker), ``ingest`` (watcher thread),
``status``/admin verbs (metrics HTTP threads) and the scheduler's
``version_fn`` (event loop) all cross this object — every shared field
is guarded by ``_lock``; executors are only ever CALLED outside the
lock.

Observability: every registry transition and the rejected, warming,
warmup-failed, canary and swap steps land on the obs timeline
(``lifecycle.*`` events); ``route`` stamps the routed version onto the
device call's span (``obs.set_attrs``); a canary, live or manual
rollback fires the flight recorder. The reference's fault points sit
where it has them: ``lifecycle.swap`` before the swap,
``lifecycle.rollback`` before a canary or live rollback.
"""


from __future__ import annotations

import collections
import os
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ... import obs
from ...common import faultpoints as fp
from ...common import lockdep
from ...common import logging as log
from ...training import bundle as bdl
from .. import metrics as msm
from . import registry as reg
from .warmup import (DEFAULT_GOLDEN, CompatMismatch, WarmupError,
                     check_compat, warm_executor)

# Windowed health accounting: failure rate over the last OUTCOME_WINDOW
# batches (not all-time — a long-lived live version must stay
# roll-back-able on a FRESH error burst), p99 over the last
# LATENCY_WINDOW samples, compared only past P99_MIN_SAMPLES on each side.
OUTCOME_WINDOW = 64
LATENCY_WINDOW = 256
P99_MIN_SAMPLES = 20

ExecutorFactory = Callable[[str, Optional[Dict]],
                           Callable[[List[str]], List[str]]]


class _Stats:
    """Per-version health window (guarded by the controller lock)."""

    __slots__ = ("requests", "errors", "outcomes", "latencies")

    def __init__(self):
        self.requests = 0
        self.errors = 0
        self.outcomes: Deque[bool] = collections.deque(
            maxlen=OUTCOME_WINDOW)          # True = error
        self.latencies: Deque[float] = collections.deque(
            maxlen=LATENCY_WINDOW)

    def error_rate(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(self.outcomes) / len(self.outcomes)

    def p99(self) -> float:
        if not self.latencies:
            return 0.0
        vals = sorted(self.latencies)
        return vals[int(0.99 * (len(vals) - 1))]


class SwapController:
    def __init__(self,
                 executor_factory: ExecutorFactory,
                 metrics_registry: Optional[msm.Registry] = None,
                 model_registry: Optional[reg.ModelRegistry] = None,
                 canary_fraction: float = 0.0,
                 rollback_error_rate: float = 0.5,
                 rollback_p99_factor: float = 0.0,
                 canary_min_batches: int = 8,
                 rollback_min_batches: int = 2,
                 golden: Optional[List[str]] = None):
        self.executor_factory = executor_factory
        self.registry = model_registry if model_registry is not None \
            else reg.ModelRegistry()
        self.canary_fraction = max(0.0, min(1.0, float(canary_fraction)))
        self.rollback_error_rate = float(rollback_error_rate)
        self.rollback_p99_factor = float(rollback_p99_factor)
        self.canary_min_batches = max(1, int(canary_min_batches))
        self.rollback_min_batches = max(1, int(rollback_min_batches))
        self.golden = list(golden) if golden else None

        # RLock: every state MUTATION (swap, promote, supersede,
        # rollback) holds it end-to-end — decision AND registry
        # transition — so a promotion racing a supersede cannot
        # interleave; readers still take it only for snapshots.
        self._lock = lockdep.make_rlock("SwapController._lock")
        self._live: Optional[reg.ModelVersion] = None      # guarded-by: _lock
        self._canary: Optional[reg.ModelVersion] = None    # guarded-by: _lock
        # the newest retired version, kept warm as the rollback target
        self._previous: Optional[reg.ModelVersion] = None  # guarded-by: _lock
        self._pinned = False                               # guarded-by: _lock
        self._batch_n = 0                                  # guarded-by: _lock
        self._stats: Dict[int, _Stats] = {}                # guarded-by: _lock
        # iteration-mode composition: set by attach_iteration.
        # Swap/canary/rollback re-point the scheduler's paged engine
        # through its quiesce protocol instead of relying on route()'s
        # per-batch executor read (which iteration mode never calls).
        self._sched = None
        self._quiesce_deadline = 2.0

        r = metrics_registry if metrics_registry is not None \
            else msm.REGISTRY
        self.m_info = r.gauge(
            "marian_model_info",
            "1 for the version(s) currently routing traffic (live + "
            "canary), 0 once retired/failed — correlate latency/error "
            "shifts with the exact swap that caused them",
            labels=("model_version", "bundle_seq", "compat_hash"))
        self.m_requests = r.counter(
            "marian_model_requests_total",
            "Device batches served, by model version",
            labels=("model_version",))
        self.m_errors = r.counter(
            "marian_model_errors_total",
            "Device batches failed, by model version",
            labels=("model_version",))
        self.m_latency = r.histogram(
            "marian_model_latency_seconds",
            "Device batch latency, by model version",
            labels=("model_version",))
        self.m_swaps = r.counter(
            "marian_lifecycle_swaps_total",
            "Hot-swaps committed (dispatch re-pointed at a new version)")
        self.m_rollbacks = r.counter(
            "marian_lifecycle_rollbacks_total",
            "Auto + manual rollbacks to the previous live version")
        self.m_rejects = r.counter(
            "marian_lifecycle_rejects_total",
            "Candidate bundles refused before serving",
            labels=("reason",))
        self.m_warming = r.gauge(
            "marian_lifecycle_warming",
            "1 while a candidate is loading/compiling/golden-smoking")

    # -- seeding ------------------------------------------------------------
    def seed_live(self, seq: int, name: str,
                  executor: Callable[[List[str]], List[str]],
                  compat: Optional[Dict] = None,
                  bundle_dir: str = "") -> reg.ModelVersion:
        """Register the boot-time model as the live version (the model
        the process loaded at startup — before any watcher ingestion)."""
        v = self.registry.register(seq, name, bundle_dir, compat=compat)
        v.executor = executor
        self.registry.transition(seq, reg.WARMING)
        self.registry.transition(seq, reg.LIVE)
        with self._lock:
            self._live = v
        self._set_info(v)
        return v

    # -- iteration-mode composition -----------------------------------------
    def attach_iteration(self, scheduler, quiesce_deadline: float = 2.0
                         ) -> None:
        """Compose with ``--batching-mode iteration``: executors are
        EngineExecutor-shaped (callable for the golden smoke, ``.engine``
        for dispatch), swaps re-point the scheduler's paged engine via
        its quiesce protocol (stop joins → drain under
        ``quiesce_deadline`` → evict the overdue with retriable errors →
        install at a step boundary with an empty join set → resume), and
        per-round health flows back through ``round_observer`` so canary
        evaluation and live auto-rollback keep working.

        CANARY SEMANTICS DIFFER by necessity: the decode is ONE joint
        program, so a canary cannot take an f-fraction of batches — it
        takes ALL joins for its evaluation window (temporal canary)
        while the previous live engine stays warm for a cheap rollback.
        ``--canary-fraction > 0`` enables the canary phase; the fraction
        itself is ignored."""
        self._sched = scheduler
        self._quiesce_deadline = float(quiesce_deadline)
        scheduler.round_observer = self._note_round
        if self.canary_fraction > 0:
            log.info("model lifecycle: iteration mode — canary is "
                     "TEMPORAL (all joins route to the canary during "
                     "evaluation; --canary-fraction {} is ignored)",
                     self.canary_fraction)

    def _repoint(self, v: reg.ModelVersion, kind: str, wait: bool):
        """Re-point dispatch at ``v``'s engine through the scheduler's
        quiesce protocol (iteration mode; request mode is a no-op —
        route() reads ``_live`` per batch). MUST be called with the
        controller lock RELEASED: with ``wait=True`` this blocks on the
        event loop draining the engine, and the loop's rounds take the
        lock via version_fn/_note_round — holding it here would
        deadlock. ``wait=False`` is mandatory when the CALLER is the
        event-loop thread (the rollback paths driven by _note_round):
        the loop cannot wait on work only it can perform."""
        sched = self._sched
        if sched is None:
            return None
        engine = getattr(v.executor, "engine", None)
        if engine is None:
            log.error("model lifecycle: cannot re-point the paged "
                      "engine at {} — its executor has no .engine "
                      "(iteration mode needs EngineExecutor-shaped "
                      "executors)", v.name)
            return None
        return sched.request_quiesce(
            lambda: sched.install_engine(engine),
            self._quiesce_deadline, f"{kind} -> {v.name}", wait=wait)

    def _note_round(self, error: bool, dt: float) -> None:
        """Iteration-mode health hook (event-loop thread, once per
        engine round): attribute the round to the version whose engine
        actually served it — during a quiesce the registry may already
        name the incoming version while the outgoing engine drains, so
        attribution follows ENGINE IDENTITY, not registry state."""
        sched = self._sched
        if sched is None:
            return
        eng = getattr(sched, "engine", None)
        with self._lock:
            ver: Optional[reg.ModelVersion] = None
            is_canary = False
            for v, c in ((self._canary, True), (self._live, False),
                         (self._previous, False)):
                if v is not None \
                        and getattr(v.executor, "engine", None) is eng:
                    ver, is_canary = v, c
                    break
        if ver is None:
            return
        self._record(ver, dt, error=error)
        if is_canary:
            self._evaluate_canary(ver, allow_promote=not error)
        elif error:
            self._maybe_rollback_live(ver)

    def adopt_live_executor(self, executor) -> None:
        """The scheduler rebuilt the live engine after a watchdog trip
        (the wedged thread owns the old one): point the live version's
        executor at the replacement so round attribution and future
        rollbacks see the engine actually serving."""
        with self._lock:
            if self._live is not None:
                self._live.executor = executor

    def live_version(self) -> Optional[reg.ModelVersion]:
        with self._lock:
            return self._live

    # -- ingestion (watcher thread) -----------------------------------------
    def ingest(self, bundle_dir: str, manifest: Dict
               ) -> Optional[reg.ModelVersion]:
        """Take one freshly committed, validated bundle through
        staged → (compat check) → warming → canary|live. Runs fully on
        the calling (watcher) thread; dispatch is untouched until the
        final atomic install. Never raises — a bad candidate is recorded
        and the live version keeps serving."""
        seq = int(manifest.get("seq", 0) or 0)
        name = os.path.basename(bundle_dir)
        with self._lock:
            pinned = self._pinned
            live = self._live
        try:
            v = self.registry.register(seq, name, bundle_dir, manifest)
        except reg.LifecycleError as e:
            log.warn("model lifecycle: not ingesting {}: {}", name, e)
            return None
        if pinned:
            self.registry.transition(seq, reg.REJECTED,
                                     "registry pinned by operator")
            self.m_rejects.labels("pinned").inc()
            obs.event("lifecycle.rejected", version=name, reason="pinned")
            return v
        try:
            check_compat(v.compat, live.compat if live else None, name)
        except CompatMismatch as e:
            self.registry.transition(seq, reg.REJECTED, str(e))
            self.m_rejects.labels("compat").inc()
            obs.event("lifecycle.rejected", version=name, reason="compat")
            log.error("model lifecycle: REFUSED incompatible bundle: {}", e)
            return v
        self.registry.transition(seq, reg.WARMING)
        self.m_warming.set(1)
        obs.event("lifecycle.warming", version=name)
        try:
            executor = warm_executor(bundle_dir, manifest,
                                     self.executor_factory,
                                     self.golden or list(DEFAULT_GOLDEN))
        except Exception as e:  # noqa: BLE001
            # ANY warmup error fails the candidate, never the watcher loop
            self.registry.transition(seq, reg.FAILED, str(e))
            self.m_rejects.labels("warmup").inc()
            obs.event("lifecycle.warmup_failed", version=name,
                      error=str(e)[:200])
            log.error("model lifecycle: candidate {} failed warmup: {}",
                      name, e)
            return v
        finally:
            self.m_warming.set(0)
        v.executor = executor
        try:
            self._install(v)
        except Exception as e:  # noqa: BLE001 — a failed install (e.g. a
            # quiesce that did not complete) must leave the LIVE version
            # serving and the candidate in a terminal state, not wedge
            # the watcher with a half-installed executor
            log.error("model lifecycle: install of {} failed ({}); live "
                      "version keeps serving", name, e)
            try:
                self.registry.transition(seq, reg.FAILED,
                                         f"install failed: {e}")
            except reg.LifecycleError:
                pass
            self._release(v)
            self.m_rejects.labels("install").inc()
        return v

    def _release(self, v: Optional[reg.ModelVersion]) -> None:
        """Drop a version's executor AND health window once it can never
        be routed again (it left the {live, canary, rollback-target}
        set). Every warmed executor pins a whole model — its weights on
        the card and, in iteration mode, its KV pool — and every _Stats
        entry holds sample
        deques, so a server hot-swapping for weeks must not accumulate
        either; the registry keeps only the version's metadata row."""
        if v is not None:
            v.executor = None
            with self._lock:
                self._stats.pop(v.seq, None)

    def _install(self, v: reg.ModelVersion) -> None:
        """A warmed candidate enters service: as a canary when canary
        routing is on and a live version exists, else by immediate swap.
        In iteration mode the engine re-point happens FIRST, through the
        quiesce protocol (watcher thread, blocking until the drain
        completes): the registry only flips once the candidate's engine
        is verifiably serving — a failed install leaves the old engine
        and the old registry state untouched."""
        with self._lock:
            has_live = self._live is not None
        if self._sched is not None and has_live:
            op = self._repoint(
                v, "canary" if self.canary_fraction > 0 else "swap",
                wait=True)
            if op is not None \
                    and not (op.event.is_set() and op.install_ok):
                raise WarmupError(
                    f"quiesce install of {v.name} did not complete "
                    f"(the previous engine keeps serving)")
        if self.canary_fraction > 0 and has_live:
            with self._lock:
                self.registry.transition(v.seq, reg.CANARY)
                superseded = self._canary
                self._canary = v
                self._stats.pop(v.seq, None)     # fresh health window
                if superseded is not None \
                        and superseded.state == reg.CANARY:
                    # a newer candidate replaces a still-evaluating
                    # canary: it leaves routing NOW — terminal state +
                    # executor released, so /lifecyclez and
                    # marian_model_info never show two routable
                    # canaries. The state re-check under the controller
                    # lock is load-bearing: a concurrent promotion
                    # (route thread) may have just made it live, and
                    # live→retired is a legal edge that would otherwise
                    # retire + release the LIVE version.
                    self.registry.transition(superseded.seq, reg.RETIRED,
                                             f"superseded by {v.name}")
                    self._release(superseded)
                else:
                    superseded = None
            if superseded is not None:
                self._set_info(superseded)
            self._set_info(v)
            obs.event("lifecycle.canary", version=v.name,
                      fraction=self.canary_fraction)
            log.info("model lifecycle: {} serving as canary "
                     "({}% of batches; promotes after {} healthy ones)",
                     v.name, round(self.canary_fraction * 100, 1),
                     self.canary_min_batches)
        else:
            self._swap_to_live(v)
            obs.event("lifecycle.swap", version=v.name)

    def _swap_to_live(self, v: reg.ModelVersion) -> None:
        """THE swap: re-point dispatch at ``v`` between batches. The old
        live version retires into the rollback slot (kept warm)."""
        fp.fault_point("lifecycle.swap")
        with self._lock:
            self.registry.transition(v.seq, reg.LIVE)
            old = self._live
            dropped = self._previous
            self._live = v
            if self._canary is v:
                self._canary = None
            self._previous = old
            if old is not None:
                self.registry.transition(old.seq, reg.RETIRED)
            if dropped is not None and dropped is not v \
                    and dropped is not old:
                self._release(dropped)   # no longer the rollback target
        if old is not None:
            self._set_info(old)
        self._set_info(v)
        self.m_swaps.inc()
        log.info("model lifecycle: SWAP — {} is now live{}", v.name,
                 f" (rollback target: {old.name})" if old else "")

    # -- dispatch (device worker thread) ------------------------------------
    def route(self, lines: List[str]) -> List[str]:
        """The scheduler's translate_lines. Picks live or canary for THIS
        batch, records per-version health, and transparently re-serves a
        failed canary batch on the live executor."""
        ver, fn, is_canary = self._pick()
        if ver is None or fn is None:
            raise RuntimeError("no live model version to dispatch to")
        # the routing decision onto the device call's span (this thread's
        # current span, set by the scheduler before calling us)
        if obs.enabled():
            obs.set_attrs(model_version=ver.name, canary=is_canary)
        t0 = time.perf_counter()
        try:
            out = fn(lines)
        except Exception as e:  # noqa: BLE001 — health-accounted, re-served
            self._record(ver, time.perf_counter() - t0, error=True)
            if not is_canary:
                self._maybe_rollback_live(ver)
                raise
            log.warn("model lifecycle: canary {} batch failed ({}); "
                     "re-serving on live", ver.name, e)
            # rollback-only evaluation: promoting here could make the
            # just-failed canary live BEFORE the re-serve below, turning
            # the promised transparent retry into a client-visible error
            self._evaluate_canary(ver, allow_promote=False)
            return self._serve_on_live(lines, ver)
        self._record(ver, time.perf_counter() - t0)
        if is_canary:
            self._evaluate_canary(ver)
        return out

    def _pick(self) -> Tuple[Optional[reg.ModelVersion],
                             Optional[Callable[[List[str]], List[str]]],
                             bool]:
        """(version, executor, is_canary) for THIS batch. The executor is
        captured UNDER the lock: a concurrent supersede/swap may
        _release() the version right after, and the captured closure is
        what keeps its model alive until the batch finishes."""
        with self._lock:
            canary = self._canary
            if canary is not None and canary.executor is not None:
                # deterministic f-fraction of batches: fires on exactly
                # the batches where the running product crosses an
                # integer boundary
                self._batch_n += 1
                n, f = self._batch_n, self.canary_fraction
                if int(n * f) != int((n - 1) * f):
                    return canary, canary.executor, True
            live = self._live
            return live, live.executor if live is not None else None, False

    def _serve_on_live(self, lines: List[str],
                       failed_canary: reg.ModelVersion) -> List[str]:
        with self._lock:
            live = self._live
            fn = live.executor if live is not None else None
        if live is None or live is failed_canary or fn is None:
            raise RuntimeError("canary batch failed and no live version "
                               "can re-serve it")
        if obs.enabled():
            obs.set_attrs(model_version=live.name,
                          re_served_after=failed_canary.name)
        t0 = time.perf_counter()
        try:
            out = fn(lines)
        except Exception:
            self._record(live, time.perf_counter() - t0, error=True)
            self._maybe_rollback_live(live)
            raise
        self._record(live, time.perf_counter() - t0)
        return out

    def _record(self, v: reg.ModelVersion, dt: float,
                error: bool = False) -> None:
        with self._lock:
            st = self._stats.get(v.seq)
            if st is None:
                st = self._stats[v.seq] = _Stats()
            st.requests += 1
            st.outcomes.append(error)
            st.latencies.append(dt)
            if error:
                st.errors += 1
        self.m_requests.labels(v.name).inc()
        self.m_latency.labels(v.name).observe(dt)
        if error:
            self.m_errors.labels(v.name).inc()

    # -- health evaluation --------------------------------------------------
    def _health(self, v: Optional[reg.ModelVersion]
                ) -> Tuple[int, float, float, int]:
        """(requests, windowed error rate, p99, latency samples)."""
        with self._lock:
            st = self._stats.get(v.seq) if v is not None else None
            if st is None:
                return 0, 0.0, 0.0, 0
            return (st.requests, st.error_rate(), st.p99(),
                    len(st.latencies))

    def _evaluate_canary(self, canary: reg.ModelVersion,
                         allow_promote: bool = True) -> None:
        """After every canary batch: roll back on a tripped threshold,
        promote after enough healthy batches (``allow_promote=False`` on
        the batch-error path — the failed batch still has to be re-served
        on live). Transition races (an admin verb landing mid-evaluation)
        are logged, never propagated into the serving path."""
        n, err_rate, p99, lat_n = self._health(canary)
        with self._lock:
            live = self._live
        _, _, live_p99, live_lat_n = self._health(live)
        reason = ""
        if n >= self.rollback_min_batches \
                and err_rate > self.rollback_error_rate:
            reason = (f"failure rate {err_rate:.2f} > "
                      f"{self.rollback_error_rate:.2f} over the last "
                      f"{min(n, OUTCOME_WINDOW)} batches")
        elif self.rollback_p99_factor > 0 \
                and lat_n >= P99_MIN_SAMPLES \
                and live_lat_n >= P99_MIN_SAMPLES \
                and p99 > self.rollback_p99_factor * live_p99:
            reason = (f"p99 {p99 * 1e3:.1f}ms > "
                      f"{self.rollback_p99_factor:g}x live "
                      f"{live_p99 * 1e3:.1f}ms")
        try:
            if reason:
                self._rollback_canary(canary, reason)
            elif allow_promote and n >= self.canary_min_batches:
                with self._lock:
                    # a newer candidate may have superseded this canary
                    # (watcher thread) between the batch and this
                    # evaluation — promotion is only legal while it is
                    # still THE canary
                    if self._canary is not canary:
                        return
                    log.info("model lifecycle: canary {} healthy after "
                             "{} batches (failure rate {:.2f}) — "
                             "promoting", canary.name, n, err_rate)
                    self._swap_to_live(canary)
                obs.event("lifecycle.swap", version=canary.name,
                          promoted=True)
        except Exception as e:  # noqa: BLE001 — a raced transition or a
            # failed swap/rollback aborts THIS evaluation only;
            # routing stands and the next canary batch re-evaluates
            log.warn("model lifecycle: canary evaluation aborted ({}) — "
                     "keeping current routing", e)

    def _rollback_canary(self, canary: reg.ModelVersion,
                         reason: str) -> None:
        fp.fault_point("lifecycle.rollback")
        with self._lock:
            live = self._live
            self.registry.transition(canary.seq, reg.FAILED, reason)
            if self._canary is canary:
                self._canary = None
            self._release(canary)
        if live is not None:
            # iteration mode: the temporal canary's engine is the one
            # serving — re-point back at the live engine via quiesce.
            # wait=False: this runs on the event-loop thread
            # (_note_round), which is the thread that executes the
            # quiesce; waiting here would deadlock. no-op in request
            # mode (route() already routes to live).
            self._repoint(live, "rollback", wait=False)
        self._set_info(canary)
        self.m_rollbacks.inc()
        log.error("model lifecycle: ROLLBACK — canary {} failed ({}); "
                  "dispatch stays on the live version", canary.name, reason)
        # the span ring still holds the canary batches that tripped the
        # threshold: dump them before they rotate out (outside the lock)
        obs.event("lifecycle.rollback", version=canary.name,
                  reason=reason, kind="canary")
        obs.FLIGHT.trip("canary-rollback", detail=reason,
                        extra={"version": canary.name})

    def _maybe_rollback_live(self, live: reg.ModelVersion) -> None:
        """Post-swap safety net: a regressed NEW live rolls back to the
        retired-but-warm previous version. One-shot per swap (the failed
        version is terminal) so two bad versions cannot ping-pong."""
        n, err_rate, _, _ = self._health(live)
        if n < self.rollback_min_batches \
                or err_rate <= self.rollback_error_rate:
            return
        reason = (f"live failure rate {err_rate:.2f} > "
                  f"{self.rollback_error_rate:.2f}")
        rolled_to = None
        try:
            with self._lock:
                if self._live is not live:
                    return                   # already rolled back / swapped
                prev = self._previous
                if prev is None or prev.executor is None:
                    return                   # boot model: nothing to roll to
                self._rollback_to(prev, live, reason, auto=True)
                rolled_to = prev
        except Exception as e:  # noqa: BLE001 — the caller is already on
            # a batch-failure path; a raced/injected rollback error must
            # not mask the original batch exception
            log.warn("model lifecycle: live rollback aborted ({})", e)
        if rolled_to is not None:
            # iteration mode: enqueue the engine re-point (wait=False —
            # this path runs on the event-loop thread via _note_round;
            # the quiesce executes over the NEXT rounds). Request mode:
            # no-op, route() reads the flipped _live per batch.
            self._repoint(rolled_to, "rollback", wait=False)
            # the dump after the lock is released: no file IO under a
            # control-plane lock
            obs.event("lifecycle.rollback", version=live.name,
                      to=rolled_to.name, reason=reason, kind="live")
            obs.FLIGHT.trip("live-rollback", detail=reason,
                            extra={"from": live.name,
                                   "to": rolled_to.name})

    def _rollback_to(self, prev: reg.ModelVersion,
                     cur: reg.ModelVersion, reason: str,
                     auto: bool) -> None:
        fp.fault_point("lifecycle.rollback")
        with self._lock:
            self.registry.transition(cur.seq,
                                     reg.FAILED if auto else reg.RETIRED,
                                     reason)
            self.registry.transition(prev.seq, reg.LIVE)
            self._live = prev
            # the rolled-back-from version is no rollback target
            self._previous = cur if not auto else None
            if auto:
                self._release(cur)   # terminal (failed) — drop its model
        self._set_info(cur)
        self._set_info(prev)
        self.m_rollbacks.inc()
        log.error("model lifecycle: ROLLBACK — {} -> {} ({})",
                  cur.name, prev.name, reason)

    # -- admin verbs + introspection ----------------------------------------
    def pin(self) -> None:
        """Freeze the registry: new bundles are rejected (state
        ``rejected``) until unpin — the operator's 'stop all rollouts
        NOW' switch."""
        with self._lock:
            self._pinned = True
        log.info("model lifecycle: registry PINNED (new bundles rejected)")

    def unpin(self) -> None:
        with self._lock:
            self._pinned = False
        log.info("model lifecycle: registry unpinned")

    def rollback(self) -> bool:
        """Manual rollback to the previous live version (admin verb).
        Returns False when there is nothing to roll back to."""
        with self._lock:
            prev, cur = self._previous, self._live
            if prev is None or cur is None or prev.executor is None:
                log.warn("model lifecycle: manual rollback requested but "
                         "no previous live version is retained")
                return False
            self._rollback_to(prev, cur, "manual rollback (admin verb)",
                              auto=False)
        # iteration mode: blocking re-point is safe here — admin verbs
        # run on the metrics HTTP thread, not the event loop
        self._repoint(prev, "rollback", wait=True)
        obs.event("lifecycle.rollback", version=cur.name, to=prev.name,
                  kind="manual")
        obs.FLIGHT.trip("manual-rollback",
                        detail=f"{cur.name} -> {prev.name} (admin verb)")
        return True

    def release_all(self) -> None:
        """Drop every warmed executor the controller holds — live,
        canary and the rollback target — and their health windows (a
        fleet eviction: the tenant's models leave the card). The
        controller routes nothing afterwards."""
        with self._lock:
            held = [v for v in (self._live, self._canary, self._previous)
                    if v is not None]
            self._live = self._canary = self._previous = None
        for v in held:
            self._release(v)

    def has_live(self) -> bool:
        with self._lock:
            return self._live is not None

    def live_version_name(self) -> str:
        """Label value for the scheduler's outcome metrics."""
        with self._lock:
            return self._live.name if self._live is not None else "none"

    def warming(self) -> bool:
        return bool(self.m_warming.value)

    def status(self) -> Dict:
        """JSON-ready lifecycle state for /lifecyclez."""
        with self._lock:
            live, canary, prev = self._live, self._canary, self._previous
            pinned = self._pinned
            stats = {seq: (st.requests, st.errors, st.error_rate(),
                           st.p99())
                     for seq, st in self._stats.items()}
        rows = self.registry.snapshot()
        for row in rows:
            req, errs, rate, p99 = stats.get(row["seq"], (0, 0, 0.0, 0.0))
            row.update(requests=req, errors=errs,
                       windowed_error_rate=round(rate, 4),
                       p99_seconds=round(p99, 6))
        return {
            "live": live.name if live else None,
            "canary": canary.name if canary else None,
            "rollback_target": prev.name if prev else None,
            "pinned": pinned,
            "warming": self.warming(),
            "canary_fraction": self.canary_fraction,
            "versions": rows,
        }

    def _set_info(self, v: reg.ModelVersion) -> None:
        self.m_info.labels(
            v.name, str(v.seq), bdl.compat_hash(v.compat)
        ).set(1 if v.state in (reg.LIVE, reg.CANARY) else 0)
