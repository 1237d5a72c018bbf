"""The serving scheduler, ported from ``marian_tpu/serving/scheduler.py``
:: ``ContinuousScheduler``, in both batching modes, with the quiesce
protocol, the brownout ladder's effects, fleet mode's single-tenant
batches, the reference's serving series, its request span trees and
its perf-plane accounting.

Requests split into SENTENCE UNITS in priority lanes (highest first,
FIFO within a lane); units of requests already resolved are swept
before they cost device time. All device work runs on ONE worker thread.

- ``request`` (the reference's default): the worker packs one device
  batch at a time by PADDED-TOKEN BUDGET (rows x bucketed width, the
  training batches' rule, ``data/batching.py``), seeded by the oldest
  live unit and topped up with whatever else fits, and hands its lines
  to ``translate_lines``. A batch that raises is bisected until single
  units isolate the poison sentence: only its request fails.
- ``iteration``: scheduling runs INSIDE the decode loop. Every round, a
  join pass admits queued units against the paged engine's free slots
  and pages, then one ``admit_and_step`` advances every active row;
  finished rows resolve the round they finish, and a sentence joins the
  moment capacity exists. A round that raises fails its rows (retriably
  when the engine can be rebuilt, as after a pool audit failure) and
  rebuilds the engine; a beam sentence evicted on a dry pool fails
  retriably. Each join carries its sentence's index in the request (the
  n-best numbering) and whether the request streams: the round's
  partials (``StepResult.partials``) go to the request's ``on_partial``
  on the event-loop thread, before its final reply.

Per-request deadlines (``timeout``) fail the request on time even while
queued; a cancelled request (client gone) has its queued units dropped
and, in iteration mode, its decoding rows evicted at the next round.

The dispatch watchdog (``stall_timeout`` > 0, the server's
``--dispatch-stall-timeout``) bounds each device call, in both modes: a
batch or round still running past it fails its requests with the
retriable ``DispatchStalled`` (no bisection: a stall is a liveness
event, not a poison sentence), the wedged worker thread is abandoned
and a fresh one takes the next call (``_trip_watchdog``); iteration mode
also rebuilds its engine. A call that never returns cannot be
cancelled: the watchdog guards host-side stalls and overlong batches,
and later work on the same CUDA stream queues behind a hung kernel.

The quiesce protocol (iteration mode; ``request_quiesce``, the serving
lifecycle's engine re-point): joins pause, active rows drain until the
op's deadline, rows still decoding then are evicted with the retriable
``RowEvicted`` (their pages freed), the outgoing engine's pool audit
runs, and ``install()`` runs at a step boundary with an empty join set;
then the incoming engine's audit, and joins resume. Request mode needs
none: the lifecycle re-points ``translate_lines`` between batches.

The brownout ladder (serving/brownout.py) reaches the scheduler through
``set_brownout_level``, on its evaluator thread: at level >= 1 the
engine's decode cap of NEW joins is scaled by the cap factor (rows
decoding keep theirs; ``install_engine`` re-applies the scale, so a
swap or a rebuild does not reset a brownout); at level >= 2 each join
pass that leaves queued work above a decoding row's priority evicts one
row, the lowest priority and then the longest decode left, with the
retriable ``RowEvicted`` (counted in
``marian_serving_brownout_evictions_total``), before the round, so no
eviction runs inside a round. Level 3 is admission's.

Fleet mode (request mode; ``submit(tenant=...)``, the server's
``#model:`` header): batches are formed single-tenant, and a tenanted
batch resolves its executor through ``tenant_router(tag)`` on the device
worker thread (a warm-on-demand cold start blocks only that batch).

Every resolved request counts once in
``marian_serving_request_outcomes_total{outcome,model_version}``, the
version read from ``version_fn`` (the lifecycle's live version) at
resolution time, or in fleet mode from ``tenant_version_fn(tenant)``.

Observability (obs/): with the span tracer on, every request grows a
``serve.request`` (or the server's ``request``) -> ``serve.queue`` ->
``serve.dispatch`` tree, every request-mode device batch a
``serve.batch`` -> ``serve.translate`` span (the translate span on the
device worker thread, its parent handed over explicitly) and, in
iteration mode, every sentence a ``serve.row`` span and every engine
round a ``serve.round`` span; the batch and round spans cross-link their
requests' trace ids in ``traces``. Quiesces, watchdog trips and poison
isolation land on the event timeline, and the trips fire the flight
recorder. With the tracer off, the per-batch path takes no tracer lock,
builds no span and allocates no ring. The reply metadata
(``submit(meta=...)``, the ``#trace:`` reply line) is independent of
the tracer: plain timestamps. With the perf plane on
(``obs.PERF.enabled``), every batch and round reports its rows, tokens
and device seconds to it.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import threading
import time
import weakref
from typing import Callable, Deque, Dict, List, Optional

from .. import obs
from ..common import faultpoints as fp
from ..common import lockdep
from ..common import logging as log
from ..data.batching import bucket_length, over_budget, padded_batch_cost
from ..translator.iteration import FATAL_REASONS, release_sync_guard
from . import metrics as msm


class RequestTimeout(RuntimeError):
    """The request's deadline expired before it completed."""


# _guarded's answer for a call still running past the stall timeout
_STALLED = object()


class DispatchStalled(RuntimeError):
    """The dispatch watchdog fired: one device batch (or engine round)
    ran past the stall timeout. Its requests fail with this retriable
    error (the server replies ``!!SERVER-RETRY``) and the scheduler moves
    onto a fresh device worker instead of wedging behind the stuck
    call."""

    retriable = True


class RowEvicted(RuntimeError):
    """A decoding row was evicted with its pages freed: its round failed
    and the engine was rebuilt, the pool ran dry under a beam sentence's
    lazy page claims, or a quiesce deadline expired before it drained.
    Retriable: the server replies ``!!SERVER-RETRY``."""

    retriable = True


class _QuiesceOp:
    """One pending quiesce: stop admitting joins, drain active rows
    under ``deadline_s`` (evict the overdue with RowEvicted), run the
    pool audit, then ``install()`` re-points the engine at a step
    boundary with an empty join set. ``event`` releases the waiting
    caller (watcher / admin thread)."""

    __slots__ = ("install", "deadline_s", "reason", "deadline", "event",
                 "ok", "install_ok", "cancelled", "evicted", "t0")

    def __init__(self, install: Callable[[], None], deadline_s: float,
                 reason: str):
        self.install = install
        self.deadline_s = max(0.0, float(deadline_s))
        self.reason = reason
        self.deadline: Optional[float] = None   # set on first round seen
        self.event = threading.Event()
        self.ok = False            # install ran AND both audits clean
        self.install_ok = False    # install() returned without raising
        # a waiter that timed out CANCELS the op (cancel_quiesce): its
        # install must never run late — the caller has already treated
        # the re-point as failed (e.g. the lifecycle released the
        # candidate), so a late install would serve a dead executor
        self.cancelled = False
        self.evicted = 0
        self.t0 = 0.0


def default_length_fn(line: str) -> int:
    """Whitespace token estimate (+1 for EOS)."""
    return len(line.split()) + 1


class _Request:
    __slots__ = ("lines", "future", "priority", "arrival", "results",
                 "remaining", "queued", "queued_pages", "timeout_handle",
                 "dead_accounted", "on_partial", "first_dispatch",
                 "trace_id", "span", "own_root", "q_span", "d_span",
                 "meta", "rounds", "prefix_hits", "evictions_n", "ttft",
                 "tenant")

    def __init__(self, lines: List[str], future: "asyncio.Future",
                 priority: int, arrival: float):
        self.lines = lines
        self.future = future
        self.priority = priority
        self.arrival = arrival
        self.results: List[Optional[str]] = [None] * len(lines)
        self.remaining = len(lines)
        self.queued = len(lines)        # units currently sitting in lanes
        self.queued_pages = 0           # page debt of those units
        self.timeout_handle = None
        # True once _on_request_done counted this request's leftover
        # queued units as dead: the future is done at set_exception
        # time, but its done-callbacks run via call_soon, and a join pass
        # in that gap must only uncount what the callback counted
        self.dead_accounted = False
        # streaming: on_partial(sentence idx, text so far, tokens so far)
        self.on_partial: Optional[Callable[[int, str, int], None]] = None
        # loop time of the request's first device batch or join (the end
        # of its queue wait)
        self.first_dispatch: Optional[float] = None
        # observability: the trace id (client-given or generated), the
        # span tree's handles (root, queue, dispatch; None with the
        # tracer off) and the caller's reply-metadata dict, filled at
        # resolution
        self.trace_id = ""
        self.span = None
        self.own_root = False       # this scheduler opened the root span
        self.q_span = None
        self.d_span = None
        self.meta: Optional[dict] = None
        # iteration mode's row breakdown for the reply metadata: decode
        # rounds (the most of any of its rows), prefix-cache hits, rows
        # evicted retriably; and the time to the first streamed partial
        self.rounds = 0
        self.prefix_hits = 0
        self.evictions_n = 0
        self.ttft: Optional[float] = None
        # fleet mode: the #model: tag ("" in single-model serving);
        # fleet/accounting.py attributes page owners through it
        self.tenant = ""


class _Unit:
    """One sentence of one request: the scheduling granule and the
    engine's row key."""

    __slots__ = ("req", "idx", "text", "tokens", "pages", "row_span",
                 "rounds", "evict_reason", "partials_sent")

    def __init__(self, req: _Request, idx: int, text: str, tokens: int,
                 pages: int):
        self.req = req
        self.idx = idx
        self.text = text
        self.tokens = tokens
        self.pages = pages          # KV-pool pages this sentence will claim
        # iteration mode: the serve.row span opened at join (None with
        # the tracer off), the rounds the row rode, why it was evicted
        # (quiesce, brownout, pool_exhausted) and the partial frames it
        # streamed
        self.row_span = None
        self.rounds = 0
        self.evict_reason: Optional[str] = None
        self.partials_sent = 0


class ContinuousScheduler:
    def __init__(self,
                 translate_lines: Optional[
                     Callable[[List[str]], List[str]]] = None,
                 token_budget: int = 4096,
                 window_s: float = 0.002, scan_limit: int = 512,
                 length_fn: Callable[[str], int] = default_length_fn,
                 executor: Optional[concurrent.futures.Executor] = None,
                 batching_mode: str = "request", engine=None,
                 engine_factory: Optional[Callable[[], object]] = None,
                 stall_timeout: float = 0.0,
                 registry: Optional[msm.Registry] = None,
                 version_fn: Optional[Callable[[], str]] = None):
        if batching_mode not in ("request", "iteration"):
            raise ValueError(f"--batching-mode must be request or "
                             f"iteration, got {batching_mode!r}")
        if batching_mode == "iteration" and engine is None:
            raise ValueError("--batching-mode iteration needs a paged "
                             "engine (translate_lines alone cannot join "
                             "rows mid-decode)")
        if batching_mode == "request" and translate_lines is None:
            raise ValueError("--batching-mode request needs "
                             "translate_lines")
        self.batching_mode = batching_mode
        # request mode: List[str] -> List[str], one device batch a call
        self.translate_lines = translate_lines
        self.token_budget = max(1, int(token_budget))
        self.engine = engine
        # rebuilds the engine after a failed or stalled round
        self.engine_factory = engine_factory
        # model-version label of the outcome counter; the lifecycle's
        # SwapController installs its live_version_name here. Read on
        # the event-loop thread only.
        self.version_fn = version_fn or (lambda: "unversioned")
        # lifecycle health hook (iteration mode): called after every
        # engine round with (error, device seconds)
        self.round_observer: Optional[Callable[[bool, float], None]] = None
        # liveness watchdog over each device call, seconds (0 = off)
        self.stall_timeout = max(0.0, float(stall_timeout))
        # fleet mode, set by the server: tenant_router(tag) resolves
        # (warming on demand) a tenant's route for one batch, on the
        # device worker thread; tenant_version_fn(tag) labels outcomes
        self.tenant_router: Optional[
            Callable[[str], Callable[[List[str]], List[str]]]] = None
        self.tenant_version_fn: Optional[Callable[[str], str]] = None
        # the brownout ladder's effects: written by its evaluator thread,
        # read at join time; plain values coupled to nothing
        self._brownout_level = 0
        self._brownout_cap_factor = 0.5
        # coalescing pause at the edge of an idle period, so a burst of
        # concurrent clients lands in one round
        self.window_s = window_s
        # bound on units examined per join pass
        self.scan_limit = scan_limit
        self.length_fn = length_fn
        # ONE device worker thread: the engine is not re-entrant, and
        # concurrency comes from the rows of a round, not from threads
        self._executor = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-device")
        self._own_executor = executor is None
        # lanes are event-loop-only; the counters below are also read by
        # admission from other threads, hence the lock
        self._lanes: Dict[int, Deque[_Unit]] = collections.defaultdict(
            collections.deque)
        self._state_lock = lockdep.make_lock(
            "ContinuousScheduler._state_lock")
        self._queued = 0                  # guarded by _state_lock
        self._queued_pages = 0            # guarded by _state_lock
        # units in lanes whose request already resolved: still queued
        # until the next join pass sweeps them, but admission must not
        # shed live traffic against them
        self._dead = 0                    # guarded by _state_lock
        self._dead_pages = 0              # guarded by _state_lock
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        # captured at start(): request_quiesce wakes the worker from
        # other threads through it
        self._loop = None
        self._inflight = 0
        # pending quiesce operations, processed one at a time by the
        # iteration worker at round boundaries; appended from any thread
        # (the lifecycle watcher, admin verbs)
        self._quiesce_q: Deque[_QuiesceOp] = collections.deque()
        #                                   guarded by _state_lock
        # request mode: units of the device batch in flight, failed by
        # stop() (event-loop-only)
        self._inflight_units: List[_Unit] = []
        # units decoding in engine slots (event-loop-only)
        self._active_units: Dict[_Unit, None] = {}
        # outcomes and events over the scheduler's life (event-loop-only);
        # request mode adds batches, rows, real and padded tokens
        self.counts: collections.Counter = collections.Counter()
        # the reference's serving series
        r = registry if registry is not None else msm.REGISTRY
        self._registry = r       # engines declare their series here
        self.m_requests = r.counter(
            "marian_serving_requests_total", "Requests submitted")
        self.m_queue_depth = r.gauge(
            "marian_serving_queue_depth_sentences",
            "Sentences currently queued (not yet in a device batch)")
        self.m_queue_depth.set_function(self.queued_units)
        self.m_batches = r.counter(
            "marian_serving_batches_total", "Device batches dispatched")
        self.m_batch_rows = r.histogram(
            "marian_serving_batch_rows", "Real sentences per device batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
        self.m_fill = r.histogram(
            "marian_serving_batch_fill_ratio",
            "Real tokens / padded batch capacity per device batch",
            buckets=msm.RATIO_BUCKETS)
        self.m_waste = r.histogram(
            "marian_serving_padding_waste_ratio",
            "Padded tokens wasted per device batch (1 - fill ratio)",
            buckets=msm.RATIO_BUCKETS)
        self.m_ttfb = r.histogram(
            "marian_serving_time_to_first_batch_seconds",
            "Queue wait from request arrival to its first device batch")
        self.m_latency = r.histogram(
            "marian_serving_request_latency_seconds",
            "End-to-end request latency (submit to resolve)")
        self.m_timeouts = r.counter(
            "marian_serving_timeouts_total",
            "Requests failed by --request-timeout deadline expiry")
        self.m_cancelled = r.counter(
            "marian_serving_cancelled_total",
            "Requests cancelled by the client before completion")
        self.m_failures = r.counter(
            "marian_serving_failures_total",
            "Requests failed by translation errors")
        self.m_bisections = r.counter(
            "marian_serving_retry_bisections_total",
            "Failed-batch bisection retries (device calls re-issued)")
        self.m_watchdog = r.counter(
            "marian_serving_watchdog_trips_total",
            "Device batches failed by the dispatch stall watchdog "
            "(--dispatch-stall-timeout)")
        self.m_outcomes = r.counter(
            "marian_serving_request_outcomes_total",
            "Requests resolved, by outcome and the model version live at "
            "resolution time (ok|failure|timeout|cancelled|stalled|"
            "evicted — evicted is retriable row eviction: quiesce "
            "deadline, brownout, recoverable engine failure; excluded "
            "from the availability SLO like cancelled, because the "
            "client is told to retry and the retry's outcome counts)",
            labels=("outcome", "model_version"))
        self.m_quiesces = r.counter(
            "marian_serving_quiesces_total",
            "Quiesce operations completed (joins stopped, rows drained "
            "or evicted, engine re-pointed at a step boundary)")
        self.m_quiesce_evictions = r.counter(
            "marian_serving_quiesce_evictions_total",
            "Rows evicted with retriable !!SERVER-RETRY because the "
            "--quiesce-deadline expired before they drained")
        self.m_quiescing = r.gauge(
            "marian_serving_quiescing",
            "Quiesce operations pending/draining (joins are paused "
            "while this is > 0; back-to-back lifecycle verbs can queue "
            "more than one)")
        self.m_quiescing.set_function(self._quiesce_depth)
        self.m_brownout_evictions = r.counter(
            "marian_serving_brownout_evictions_total",
            "Rows evicted with retriable !!SERVER-RETRY by the brownout "
            "ladder (level >= 2) to free capacity for a higher-priority "
            "lane")
        # iteration mode: joins, evictions and steps happen per round
        self.m_joins = r.counter(
            "marian_serving_joins_total",
            "Sentences that joined a decode (iteration mode)")
        self.m_mid_joins = r.counter(
            "marian_serving_mid_decode_joins_total",
            "Sentences that joined a RUNNING decode step beside already-"
            "decoding rows (iteration mode)")
        self.m_evictions = r.counter(
            "marian_serving_evictions_total",
            "Mid-decode row evictions, all causes (request cancelled / "
            "timed out while decoding, quiesce deadline, brownout — the "
            "latter two also count in their dedicated series; iteration "
            "mode)")
        self.m_steps = r.counter(
            "marian_serving_decode_steps_total",
            "Decode steps run by the iteration-mode worker")
        self.m_step_rows = r.histogram(
            "marian_serving_step_active_rows",
            "Active decode rows per iteration-mode step (pre-bucket)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
        self.m_queued_pages = r.gauge(
            "marian_serving_queue_depth_pages",
            "KV-pool pages owed by queued sentences (iteration mode's "
            "admission currency)")
        self.m_queued_pages.set_function(self.queued_pages)
        self.m_stream_partials = r.counter(
            "marian_stream_partials_total",
            "Partial-token frames delivered to streaming clients "
            "(#stream: protocol header, iteration mode)")
        self.m_stream_ttft = r.histogram(
            "marian_stream_ttft_seconds",
            "Time from request arrival to its first streamed partial "
            "token (#stream: clients; the streaming twin of "
            "time_to_first_batch, which measures join, not delivery)")
        if engine is not None:
            self._declare_engine(engine)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the worker on the RUNNING loop (call from a coroutine)."""
        if self._task is None:
            self._loop = asyncio.get_event_loop()
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        """Hard stop: cancel the worker; queued and decoding requests
        fail explicitly (never a silent hang)."""
        pending = list(self._active_units) + self._inflight_units
        self._active_units.clear()
        self._inflight_units = []
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        for u in pending:
            if not u.req.future.done():
                u.req.future.set_exception(
                    RuntimeError("server shut down mid-decode"))
        for lane in self._lanes.values():
            for u in lane:
                # zero the request's queued count before its done-callback
                # runs, so it cannot re-inflate the counters zeroed below
                u.req.queued = 0
                u.req.queued_pages = 0
                if not u.req.future.done():
                    u.req.future.set_exception(
                        RuntimeError("server shut down"))
            lane.clear()
        with self._state_lock:
            self._queued = self._dead = 0
            self._queued_pages = self._dead_pages = 0
            dangling = list(self._quiesce_q)
            self._quiesce_q.clear()
        for op in dangling:
            # release any thread blocked in request_quiesce(wait=True):
            # the loop is gone, the install will never run
            op.ok = False
            op.event.set()
        if self._own_executor:
            self._executor.shutdown(wait=False)

    async def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: finish everything queued or decoding, then
        stop. Returns True when fully drained, False on timeout."""
        loop = asyncio.get_event_loop()
        dl = loop.time() + timeout if timeout is not None else None
        while self._queue_size() or self._inflight or self._active_units:
            if dl is not None and loop.time() >= dl:
                await self.stop()
                return False
            self._wake.set()
            await asyncio.sleep(0.005)
        await self.stop()
        return True

    # -- submission ---------------------------------------------------------
    def queued_units(self) -> int:
        """LIVE queued sentences (what admission sees)."""
        with self._state_lock:
            return max(0, self._queued - self._dead)

    def queued_pages(self) -> int:
        """LIVE queue debt in KV-pool pages (what page-priced admission
        sees)."""
        with self._state_lock:
            return max(0, self._queued_pages - self._dead_pages)

    def _queue_size(self) -> int:
        with self._state_lock:
            return self._queued

    # -- quiesce protocol (iteration mode) ----------------------------------
    def _quiesce_depth(self) -> int:
        with self._state_lock:
            return len(self._quiesce_q)

    def _peek_quiesce(self) -> Optional[_QuiesceOp]:
        with self._state_lock:
            while self._quiesce_q and self._quiesce_q[0].cancelled:
                self._quiesce_q.popleft().event.set()
            return self._quiesce_q[0] if self._quiesce_q else None

    def cancel_quiesce(self, op: _QuiesceOp) -> None:
        """Withdraw a pending quiesce whose waiter gave up (wait budget
        exceeded): its install must not run late — the caller has
        already declared the re-point failed and may have released the
        target executor. A cancelled head is dropped at the next peek;
        an op already past its install cannot be recalled (the caller's
        event was set then)."""
        with self._state_lock:
            op.cancelled = True

    def request_quiesce(self, install: Callable[[], None],
                        deadline_s: float, reason: str,
                        wait: bool = True,
                        timeout: Optional[float] = None) -> _QuiesceOp:
        """Enqueue a quiesce: the iteration worker stops admitting joins,
        drains active rows until ``deadline_s`` (rows past it are evicted
        with retriable ``!!SERVER-RETRY`` and their pages freed), runs
        the pool audit, then calls ``install()`` at a step boundary with
        an empty join set (the only legal moment to re-point the engine)
        and resumes joins. Callable from ANY thread except — with
        ``wait=True`` — the event-loop thread itself (the loop is what
        executes the quiesce; waiting on it there would deadlock, which
        is why the lifecycle's rollback paths pass ``wait=False``).
        Returns the op; ``op.event``/``op.ok`` report completion."""
        op = _QuiesceOp(install, deadline_s, reason)
        with self._state_lock:
            self._quiesce_q.append(op)
        loop = self._loop
        if loop is not None:
            try:
                loop.call_soon_threadsafe(self._wake.set)
            except RuntimeError:   # loop already closed: stop() cleans up
                pass
        if wait:
            # bounded: drain deadline + generous slack for the install's
            # own work; a dead loop must not wedge the watcher forever
            op.event.wait(timeout if timeout is not None
                          else op.deadline_s + 30.0)
            if not op.event.is_set():
                # withdraw it: the caller will treat the re-point as
                # failed, so a LATE install (serving loop catching up
                # after the caller released the target) must not run
                self.cancel_quiesce(op)
                log.error("quiesce ({}) did not complete within its "
                          "wait budget — withdrawn; the serving loop "
                          "may be down", reason)
        return op

    def install_engine(self, engine) -> None:
        """Re-point the paged engine (the quiesce install callback is
        the only legitimate caller — loop thread, empty join set, zero
        active rows); the pool gauges follow it, and the current brownout
        cap scale is applied again (a swap must not reset a brownout)."""
        self.engine = engine
        self._declare_engine(engine)
        self._apply_cap_scale(engine)

    def _apply_cap_scale(self, engine) -> None:
        scale_fn = getattr(engine, "set_cap_scale", None) \
            if engine is not None else None
        if scale_fn is not None:
            scale_fn(self._brownout_cap_factor
                     if self._brownout_level >= 1 else 1.0)

    def set_brownout_level(self, level: int,
                           cap_factor: Optional[float] = None) -> None:
        """Apply one brownout level (the ladder's evaluator thread): >= 1
        scales the decode cap of future joins, >= 2 arms the join pass's
        priority eviction, >= 3 is admission's
        (``AdmissionController.set_brownout``)."""
        if cap_factor is not None:
            self._brownout_cap_factor = float(cap_factor)
        self._brownout_level = max(0, int(level))
        self._apply_cap_scale(self.engine)

    def _declare_engine(self, engine) -> None:
        """The engine's pool and round series on this scheduler's
        registry (stub engines in tests may have none)."""
        decl = getattr(engine, "_declare_metrics", None)
        if decl is not None:
            decl(self._registry)

    def submit(self, lines: List[str], priority: int = 0,
               timeout: Optional[float] = None,
               on_partial: Optional[Callable[[int, str, int], None]] = None,
               meta: Optional[dict] = None,
               trace_id: Optional[str] = None,
               tenant: str = "") -> "asyncio.Future":
        """Enqueue one request (a list of sentences); returns a future of
        the translations in input order. Event-loop thread only; cancel
        the future to cancel the request. ``on_partial`` (iteration
        mode) is called as ``on_partial(sentence idx, text so far,
        tokens so far)`` every round a sentence of the request is still
        decoding, never after the future is done; the future stays the
        final reply.

        ``meta`` (a dict) is filled at resolution with the request's
        queue wait and service time, outcome, model version and trace id
        (the ``#trace:`` reply line); in iteration mode also its rounds,
        time to first join, prefix-cache hit and evictions.
        ``trace_id`` labels the request's span tree; with the tracer on
        and no id given, one is generated (or inherited from the
        context's span, the server's ``request`` root). ``tenant`` (fleet
        mode) is the request's #model: tag: its batches run on that
        tenant's executor."""
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        if not lines:
            # nothing to queue, so nothing would ever complete it
            self.m_requests.inc()
            fut.set_result([])
            self._outcome("ok")
            return fut
        req = _Request(lines, fut, priority, loop.time())
        req.on_partial = on_partial
        req.meta = meta
        req.trace_id = trace_id or ""
        req.tenant = tenant or ""
        if obs.enabled():
            # the span tree: under the transport's root span when it
            # opened one (the server's handle_frame), else our own root
            parent = obs.current()
            if parent is None:
                req.span = obs.start_span(
                    "serve.request", trace_id=trace_id or None,
                    n_sentences=len(lines), priority=priority)
                req.own_root = True
            else:
                req.span = parent
            req.trace_id = req.span.trace_id
            req.q_span = obs.start_span("serve.queue", parent=req.span,
                                        n_sentences=len(lines))
        self.m_requests.inc()
        with self._state_lock:
            for i, text in enumerate(lines):
                pages = (self.engine.pages_for_text(text)
                         if self.batching_mode == "iteration" else 0)
                u = _Unit(req, i, text, max(1, int(self.length_fn(text))),
                          pages)
                self._lanes[priority].append(u)
                self._queued += 1
                self._queued_pages += pages
                req.queued_pages += pages
        if timeout and timeout > 0:
            # fires even for a unit buried in the backlog: the client gets
            # its error on time, and the dead units cost no device work
            req.timeout_handle = loop.call_at(
                req.arrival + timeout, self._expire_request, req, loop)
        fut.add_done_callback(
            lambda f, _req=req: self._on_request_done(f, _req))
        self._wake.set()
        return fut

    def _expire_request(self, req: _Request, loop) -> None:
        if not req.future.done():
            self.counts["timeouts"] += 1
            self.m_timeouts.inc()
            self._outcome("timeout", req, loop.time())
            req.future.set_exception(RequestTimeout(
                f"request deadline expired after "
                f"{(loop.time() - req.arrival):.3f}s "
                f"({req.remaining}/{len(req.lines)} sentences unfinished)"))

    def _on_request_done(self, fut: "asyncio.Future", req: _Request) -> None:
        if fut.cancelled():
            self.counts["cancelled"] += 1
            self.m_cancelled.inc()
            self._outcome("cancelled", req)
        # the request's units still in lanes are dead from now on
        with self._state_lock:
            req.dead_accounted = True
            self._dead += req.queued
            self._dead_pages += req.queued_pages

    # -- worker -------------------------------------------------------------
    async def _run(self) -> None:
        loop = asyncio.get_event_loop()
        iteration = self.batching_mode == "iteration"
        while True:
            try:
                was_idle = False
                while self._queue_size() == 0 and not self._active_units \
                        and self._quiesce_depth() == 0:
                    self._wake.clear()
                    was_idle = True
                    await self._wake.wait()
                if was_idle and self.window_s > 0:
                    # idle-edge coalescing only; under load the previous
                    # batch's (or round's) device time is the window
                    await asyncio.sleep(self.window_s)
                if iteration:
                    await self._iteration_round(loop)
                    continue
                t_form = time.perf_counter() if obs.enabled() else 0.0
                batch = self._form_batch()
                if batch:
                    # the forming pass runs under the state lock: it is
                    # timed from out here, onto the batch span
                    await self._dispatch(
                        batch, loop,
                        (time.perf_counter() - t_form) if t_form else 0.0)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — supervision: never die
                log.error("serving scheduler error (recovered): {}", e)

    # -- request mode -------------------------------------------------------
    def _form_batch(self) -> List[_Unit]:
        """Pack one device batch: seeded by the oldest live unit of the
        highest non-empty lane, topped up (same lane order) with queued
        units that fit the padded-token budget. Units that do not fit go
        back to the front of their lanes in order (FIFO kept); units of
        resolved requests are swept here."""
        batch: List[_Unit] = []
        longest = 0
        scanned = 0
        tenant: Optional[str] = None
        skipped: List[_Unit] = []
        with self._state_lock:
            for prio in sorted(self._lanes.keys(), reverse=True):
                lane = self._lanes[prio]
                while lane and scanned < self.scan_limit:
                    u = lane.popleft()
                    scanned += 1
                    self._queued -= 1
                    self._queued_pages -= u.pages
                    u.req.queued -= 1
                    u.req.queued_pages -= u.pages
                    if u.req.future.done():
                        if u.req.dead_accounted:
                            self._dead -= 1
                            self._dead_pages -= u.pages
                        continue
                    # fleet mode: one device call serves one model, so
                    # the first live unit seeds the batch's tenant and
                    # other tenants' units wait for a later pass
                    if tenant is None:
                        tenant = u.req.tenant
                    elif u.req.tenant != tenant:
                        skipped.append(u)
                        continue
                    # the decoder's budget rule, so one batch here is
                    # one device batch; a shorter unit further back may
                    # still fit, so the scan goes on
                    if batch and over_budget(len(batch) + 1,
                                             max(longest, u.tokens),
                                             self.token_budget):
                        skipped.append(u)
                        continue
                    batch.append(u)
                    longest = max(longest, u.tokens)
                if scanned >= self.scan_limit:
                    break
            for u in reversed(skipped):
                self._lanes[u.req.priority].appendleft(u)
                self._queued += 1
                self._queued_pages += u.pages
                u.req.queued += 1
                u.req.queued_pages += u.pages
        return batch

    async def _dispatch(self, units: List[_Unit], loop,
                        form_s: float = 0.0) -> None:
        """One device batch: its counts and series, the end of its
        requests' queue wait (their serve.queue spans end, serve.dispatch
        spans begin), then ``_translate_units`` under a serve.batch span
        and the batch's perf-plane report."""
        self._inflight += 1
        self._inflight_units = list(units)
        bspan = None
        # [device seconds, target tokens, source tokens delivered] of the
        # batch, bisection retries included
        dev_acc = [0.0, 0.0, 0.0] if obs.PERF.enabled else None
        try:
            now = loop.time()
            rows = len(units)
            real_tokens = sum(u.tokens for u in units)
            width = max(bucket_length(u.tokens) for u in units)
            capacity = padded_batch_cost(rows, max(u.tokens for u in units))
            fill = min(1.0, real_tokens / max(capacity, 1))
            c = self.counts
            c["batches"] += 1
            c["batch_rows"] += rows
            c["batch_tokens"] += real_tokens
            c["batch_capacity"] += capacity
            self.m_batches.inc()
            self.m_batch_rows.observe(rows)
            self.m_fill.observe(fill)
            self.m_waste.observe(1.0 - fill)
            if obs.enabled():
                # the batch's own trace (a batch serves many requests):
                # its members' trace ids ride as an attribute, and each
                # member's serve.dispatch span names the batch span
                bspan = obs.start_span(
                    "serve.batch", rows=rows, width=width,
                    fill=round(fill, 4), form_ms=round(form_s * 1e3, 3),
                    traces=sorted({u.req.trace_id for u in units
                                   if u.req.trace_id}))
            seen: set = set()
            for u in units:
                if id(u.req) in seen:     # one request, many sentences
                    continue
                seen.add(id(u.req))
                if u.req.first_dispatch is None:
                    u.req.first_dispatch = now
                    self.m_ttfb.observe(now - u.req.arrival,
                                        trace_id=u.req.trace_id or None)
                    if u.req.q_span is not None:
                        obs.end(u.req.q_span)
                        u.req.q_span = None
                        u.req.d_span = obs.start_span(
                            "serve.dispatch", parent=u.req.span,
                            batch_span=bspan.span_id if bspan else "",
                            rows=rows)
                elif bspan is not None and u.req.d_span is not None:
                    # a later batch of a request split across batches
                    u.req.d_span.attrs["batches"] = \
                        u.req.d_span.attrs.get("batches", 1) + 1
            await self._translate_units(units, loop, bspan, dev_acc)
            if dev_acc is not None:
                # device seconds measured to the result fence on the
                # worker thread (translate_lines returns host strings),
                # retries included: isolating a poison costs real time
                obs.PERF.record_batch(
                    self._version_label(), rows=rows, width=width,
                    src_tokens=int(dev_acc[2]), trg_tokens=int(dev_acc[1]),
                    device_s=dev_acc[0])
        finally:
            if bspan is not None:
                if dev_acc is not None:
                    bspan.attrs["device_s"] = round(dev_acc[0], 6)
                obs.end(bspan)
            self._inflight -= 1
            self._inflight_units = []

    async def _translate_units(self, units: List[_Unit], loop,
                               bspan=None, dev_acc=None) -> None:
        """One device call for the batch; on failure, bisect: each half
        is retried, recursively, until single units isolate the poison
        sentence, whose request alone fails (O(log batch) extra calls
        for one poison unit). A call past the stall timeout fails the
        whole batch with ``DispatchStalled`` instead. ``bspan`` is the
        batch's span (None with the tracer off): the device call's
        serve.translate span hangs under it. ``dev_acc`` (perf plane on)
        sums the batch's device seconds, target tokens and delivered
        source tokens."""
        # requests may die (deadline, cancel, a sibling's failure) while
        # the batch waits, inside bisection retries too
        units = [u for u in units if not u.req.future.done()]
        if not units:
            return
        lines = [u.text for u in units]
        translate = self.translate_lines
        # fleet mode: a tenanted batch (single-tenant by _form_batch)
        # resolves its route through the tenant router on the worker
        # thread, so a warm-on-demand cold start blocks only this batch
        tenant = units[0].req.tenant
        router = self.tenant_router
        # the worker writes into its OWN accumulator, merged into dev_acc
        # only once the call has provably ended (a finished await): a
        # watchdog-abandoned worker must not bill its late finish
        local_acc = [0.0, 0.0] if dev_acc is not None else None

        def _merge_acc():
            if dev_acc is not None:
                dev_acc[0] += local_acc[0]
                dev_acc[1] += local_acc[1]
                local_acc[0] = local_acc[1] = 0.0

        def _call_translate():
            run = translate
            if router is not None and tenant:
                # resolved before the device-time fence: a cold start is
                # warmup, not this batch's service time
                run = router(tenant)
            # the device-time fence: translate_lines returns host
            # strings, so the clock read after it is an honest boundary
            t0 = time.perf_counter()
            try:
                out_ = run(lines)
            finally:
                if local_acc is not None:
                    local_acc[0] += time.perf_counter() - t0
            if local_acc is not None:
                local_acc[1] += sum(len(l.split()) for l in out_)
            return out_

        def _device_call():
            fp.fault_point("serving.translate")
            if bspan is None:
                return _call_translate()
            # this runs on the device worker thread, outside the event
            # loop's context: the parent is handed over explicitly (the
            # lifecycle stamps model_version onto this span from route())
            sp = obs.start_span("serve.translate", parent=bspan,
                                rows=len(lines))
            with obs.TRACER.use(sp):
                try:
                    return _call_translate()
                except BaseException as e:
                    sp.attrs.setdefault("error", repr(e))
                    raise
                finally:
                    obs.end(sp)

        try:
            # inside the try: an injected dispatch failure takes the
            # normal failure path (the futures fail, none hangs)
            fp.fault_point("serving.dispatch")
            call = loop.run_in_executor(self._executor, _device_call)
            out = await self._guarded(call)
            if out is _STALLED:
                if dev_acc is not None:
                    # the card was busy for at least the stall window
                    dev_acc[0] += self.stall_timeout
                self._trip_watchdog(call, len(units))
                victims = sorted({u.req.trace_id for u in units
                                  if u.req.trace_id})
                now = loop.time()
                for u in units:
                    if not u.req.future.done():
                        self.counts["stalled"] += 1
                        self._outcome("stalled", u.req, now)
                        u.req.future.set_exception(DispatchStalled(
                            f"device batch stalled past "
                            f"{self.stall_timeout}s — retry"))
                # the victims' spans ended above, so the dump holds each
                # one's whole tree; the dump runs off the event loop
                obs.event("serve.watchdog_trip", rows=len(units),
                          stall_timeout=self.stall_timeout,
                          traces=victims)
                obs.FLIGHT.trip_async(
                    "watchdog", trace_id=victims[0] if victims else None,
                    detail=f"device batch ({len(units)} sentences) "
                           f"stalled past {self.stall_timeout}s",
                    extra={"traces": victims})
                return
            _merge_acc()
            if len(out) != len(lines):
                raise RuntimeError(
                    f"translator returned {len(out)} lines for "
                    f"{len(lines)} inputs — reply routing would misalign")
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            # a raising await still ended the worker's call
            _merge_acc()
            if len(units) == 1:
                u = units[0]
                if not u.req.future.done():
                    self.counts["failures"] += 1
                    self.m_failures.inc()
                    self._outcome("failure", u.req, loop.time())
                    log.error("translation error: {}", e)
                    u.req.future.set_exception(RuntimeError(str(e)))
                    # the poison request is isolated: record the victim
                    # and snapshot while the ring still holds its tree
                    obs.event("serve.poison_isolated",
                              trace_id=u.req.trace_id, error=str(e)[:200])
                    obs.FLIGHT.trip_async(
                        "poison", trace_id=u.req.trace_id or None,
                        detail=f"request failed in isolation: {e}")
                return
            self.counts["bisections"] += 1
            self.m_bisections.inc()
            log.error("batch translation error ({} sentences — bisecting "
                      "to isolate): {}", len(units), e)
            mid = len(units) // 2
            await self._translate_units(units[:mid], loop, bspan, dev_acc)
            await self._translate_units(units[mid:], loop, bspan, dev_acc)
            return
        if dev_acc is not None:
            # delivered: these units' tokens were really processed
            dev_acc[2] += sum(u.tokens for u in units)
        for u, line in zip(units, out):
            self._complete_unit(u, line, loop)

    # -- iteration mode -----------------------------------------------------

    def _form_join_set(self) -> List[_Unit]:
        """The join pass: highest lane first, FIFO within a lane, packed
        against the engine's free slots and pages; units of resolved
        requests are swept here, before they cost device time."""
        joins: List[_Unit] = []
        budget_pages = self.engine.free_pages()
        budget_slots = self.engine.free_slots()
        usable = self.engine.pool.usable_pages
        scanned = 0
        skipped: List[_Unit] = []
        with self._state_lock:
            for prio in sorted(self._lanes.keys(), reverse=True):
                lane = self._lanes[prio]
                while lane and scanned < self.scan_limit:
                    u = lane.popleft()
                    scanned += 1
                    self._queued -= 1
                    self._queued_pages -= u.pages
                    u.req.queued -= 1
                    u.req.queued_pages -= u.pages
                    if u.req.future.done():
                        if u.req.dead_accounted:
                            self._dead -= 1
                            self._dead_pages -= u.pages
                        continue
                    if u.pages > usable:
                        # the estimate says it can NEVER fit: hand it to
                        # the engine, which re-measures and admits or
                        # rejects it fatally (parking it here would block
                        # the queue head forever)
                        joins.append(u)
                        continue
                    if len(joins) >= budget_slots \
                            or u.pages > budget_pages:
                        skipped.append(u)
                        continue
                    budget_pages -= u.pages
                    joins.append(u)
                if scanned >= self.scan_limit:
                    break
            # back to the FRONT of their lanes, in order (FIFO kept)
            for u in reversed(skipped):
                self._lanes[u.req.priority].appendleft(u)
                self._queued += 1
                self._queued_pages += u.pages
                u.req.queued += 1
                u.req.queued_pages += u.pages
        return joins

    def _requeue_front(self, u: _Unit) -> None:
        """Return a join-rejected unit to the FRONT of its lane (the
        engine's claim re-check lost a capacity race)."""
        with self._state_lock:
            self._lanes[u.req.priority].appendleft(u)
            self._queued += 1
            self._queued_pages += u.pages
            u.req.queued += 1
            u.req.queued_pages += u.pages
            if u.req.future.done() and u.req.dead_accounted:
                # died between pop and requeue: the done-callback could
                # no longer count it
                self._dead += 1
                self._dead_pages += u.pages

    def _fail_unit(self, u: _Unit, loop, message: str) -> None:
        if u.req.future.done():
            return
        self.counts["failures"] += 1
        self.m_failures.inc()
        self._outcome("failure", u.req, loop.time())
        log.error("iteration admission: {}", message)
        u.req.future.set_exception(RuntimeError(message))

    def _mark_joined(self, u: _Unit, now: float, rows_before: int,
                     bucket: int = 0) -> None:
        """A sentence entered the decode. Its request's queue wait stops
        HERE, at the round it joined, not at a later round's end."""
        self._active_units[u] = None
        self.m_joins.inc()
        if rows_before > 0:
            self.m_mid_joins.inc()
        req = u.req
        if req.first_dispatch is None:
            req.first_dispatch = now
            self.m_ttfb.observe(now - req.arrival,
                                trace_id=req.trace_id or None)
            if req.q_span is not None:
                obs.end(req.q_span)
                req.q_span = None
                req.d_span = obs.start_span(
                    "serve.dispatch", parent=req.span,
                    joined_mid_decode=rows_before > 0)
        if obs.enabled():
            # one serve.row span a sentence under the request's root,
            # from its join to its EOS, eviction or cancel (the rounds'
            # serve.round spans name it back through `traces`)
            u.row_span = obs.start_span(
                "serve.row", parent=req.span,
                trace_id=req.trace_id or None,
                sentence=u.idx, bucket=bucket,
                mid_decode=rows_before > 0,
                ttfj_ms=round((now - req.arrival) * 1e3, 2))

    def _end_row_span(self, u: _Unit, outcome: str, **attrs) -> None:
        """A row's end: its rounds fold into its request's (the reply's
        row breakdown), and its serve.row span ends."""
        req = u.req
        if u.rounds > req.rounds:
            req.rounds = u.rounds
        sp = u.row_span
        if sp is not None:
            u.row_span = None
            obs.end(sp, outcome=outcome, rounds=u.rounds, **attrs)

    async def _iteration_round(self, loop) -> None:
        """One join pass + one engine round on the device worker. With a
        quiesce pending the join set is EMPTY: active rows drain until
        the deadline, overdue rows are evicted with retriable errors,
        and once the engine is empty the op's install re-points it
        before joins resume."""
        if self.engine is None:
            # a rebuild after a stall failed with the old engine gone:
            # retry it, at most once a stall timeout
            await asyncio.sleep(self.stall_timeout)
            self.install_engine(self.engine_factory())
        engine = self.engine
        q = self._peek_quiesce()
        if q is not None and q.deadline is None:
            q.t0 = loop.time()
            q.deadline = q.t0 + q.deadline_s
            obs.event("quiesce.begin", reason=q.reason,
                      rows=len(self._active_units),
                      deadline_s=q.deadline_s)
            log.info("quiesce ({}): joins paused, draining {} active "
                     "row(s) under a {}s deadline", q.reason,
                     len(self._active_units), q.deadline_s)
        joins = [] if q is not None else self._form_join_set()
        evicts = [u for u in self._active_units if u.req.future.done()]
        if q is None and self._brownout_level >= 2:
            evicts.extend(self._brownout_victims(loop, evicts))
        if q is not None and loop.time() >= q.deadline:
            # the deadline expired: rows still decoding leave NOW with a
            # retriable error (the engine frees their pages this round),
            # so a swap is never held hostage by one long sentence
            for u in list(self._active_units):
                if u in evicts:
                    continue
                u.evict_reason = "quiesce"
                self._evict_with_retry(
                    u, loop,
                    f"row evicted at the quiesce deadline ({q.reason})")
                self.m_quiesce_evictions.inc()
                q.evicted += 1
                evicts.append(u)
        rows_before = engine.active_rows()
        if q is not None and not joins and not evicts \
                and not self._active_units:
            # drained (or never had rows): complete without a round
            self._finish_quiesce(q, loop)
            return
        # queue waits stop at the round's start, not after its step
        t_round = loop.time()
        # one serve.round span a round, its own trace (a round serves
        # many rows), cross-linked to its rows' traces at its end
        rspan = None
        if obs.enabled():
            rspan = obs.start_span(
                "serve.round", rows_before=rows_before,
                joins=len(joins), evicts=len(evicts),
                quiescing=q is not None)
        self._inflight += 1
        try:
            fp.fault_point("serving.dispatch")
            # per-row join meta: the sentence's index in its request
            # (n-best numbering) and whether the request streams
            payload = [(u, u.text, {"sid": u.idx,
                                    "stream": u.req.on_partial is not None})
                       for u in joins]

            def _round():
                fp.fault_point("serving.translate")
                return engine.admit_and_step(payload, evicts)

            call = loop.run_in_executor(self._executor, _round)
            res = await self._guarded(call)
            if res is _STALLED:
                del engine          # the rebuild must not find it held
                self._iteration_stalled(call, joins, loop)
                obs.end(rspan, outcome="stalled")
                return
        except asyncio.CancelledError:
            obs.end(rspan, outcome="cancelled")
            raise
        except Exception as e:  # noqa: BLE001
            # a round computes all rows jointly: no per-sentence retry
            self._iteration_failed(joins, loop, e)
            obs.end(rspan, outcome="failed", error=str(e)[:200])
            return
        finally:
            self._inflight -= 1
        for u in evicts:
            if u in self._active_units:
                del self._active_units[u]
                self.counts["evictions"] += 1
                self.m_evictions.inc()
                self._end_row_span(u, u.evict_reason or "cancelled",
                                   retriable=u.evict_reason is not None)
        for u in res.accepted:
            self._mark_joined(u, t_round, rows_before, res.bucket)
        if res.rows:
            # the round counts for every row that rode it (rows finishing
            # in it are still active here); the request's count moves now,
            # since an eviction fills the reply metadata before the row's
            # span ends
            for u in self._active_units:
                u.rounds += 1
                if u.rounds > u.req.rounds:
                    u.req.rounds = u.rounds
        # the engine's per-row instants (prefix-cache replays and forks):
        # the request's reply counters always, the timeline when tracing
        for u, name, attrs in res.row_events:
            if name.startswith("prefix."):
                u.req.prefix_hits += 1
            if name == "prefix.fork" and u.row_span is not None:
                u.row_span.set_attrs(prefix_fork=True, **attrs)
            if obs.enabled():
                obs.event(name, trace=u.req.trace_id, **attrs)
        requeue: List[_Unit] = []
        for u, why in res.rejected:
            if why in FATAL_REASONS:
                detail = res.reject_detail.get(
                    u, "exceeds the engine's source cap or the whole KV "
                       "pool")
                self._fail_unit(u, loop,
                                f"sentence cannot be admitted ({why}): "
                                f"{detail}")
            else:
                requeue.append(u)
        # reversed, so the lane keeps FIFO order across rejection rounds
        for u in reversed(requeue):
            self._requeue_front(u)
        # beam sentences evicted on a dry pool: retriable
        for u in res.pool_evicted:
            if u not in self._active_units:
                continue
            del self._active_units[u]
            self.counts["evictions"] += 1
            self.m_evictions.inc()
            u.evict_reason = "pool_exhausted"
            self._end_row_span(u, "pool_exhausted", retriable=True)
            self._evict_with_retry(
                u, loop, "row evicted: KV pool exhausted mid-decode "
                         "(copy-on-write beam divergence)")
        # streaming fan-out: a still-decoding row of a streaming request
        # delivers its text so far, once a round, before any final reply;
        # the first partial stamps the request's time to first token
        for u, text, ntok in res.partials:
            req = u.req
            if req.future.done() or req.on_partial is None:
                continue
            now_p = loop.time()
            if u.partials_sent == 0 and u.row_span is not None:
                u.row_span.set_attrs(
                    ttft_ms=round((now_p - req.arrival) * 1e3, 2))
            if req.ttft is None:
                req.ttft = now_p - req.arrival
                self.m_stream_ttft.observe(
                    req.ttft, trace_id=req.trace_id or None)
            u.partials_sent += 1
            self.counts["partials"] += 1
            self.m_stream_partials.inc()
            try:
                req.on_partial(u.idx, text, ntok)
            except Exception as e:  # noqa: BLE001
                log.warn("stream partial delivery failed: {}", e)
                req.on_partial = None     # a stream never kills rounds
        src_done = 0
        for u, text in res.finished:
            self._active_units.pop(u, None)
            src_done += u.tokens
            self._end_row_span(u, "eos")
            self._complete_unit(u, text, loop)
        if res.rows:
            self.m_steps.inc(max(1, res.steps))
            self.m_step_rows.observe(res.rows)
            self.m_batches.inc()     # a round IS the device batch here
            self.m_batch_rows.observe(res.rows)
            if obs.PERF.enabled:
                # the round's device seconds over the target tokens it
                # emitted; source tokens credit at a sentence's finish
                obs.PERF.record_batch(
                    self._version_label(), rows=res.rows,
                    width=res.bucket, src_tokens=src_done,
                    trg_tokens=res.tokens, device_s=res.device_s)
        if rspan is not None:
            # rows that finished this round already left _active_units;
            # their trace ids still belong on the round's cross-links
            traces = {u.req.trace_id for u in self._active_units
                      if u.req.trace_id}
            traces.update(u.req.trace_id for u, _ in res.finished
                          if u.req.trace_id)
            obs.end(
                rspan, outcome="ok", rows=res.rows, bucket=res.bucket,
                steps=res.steps, tokens=res.tokens,
                joined=len(res.accepted), left=len(res.finished),
                pool_evicted=len(res.pool_evicted),
                pages_claimed=res.pages_claimed,
                pages_freed=res.pages_freed,
                pages_aliased=res.pages_aliased,
                pages_copied=res.pages_copied,
                device_s=round(res.device_s, 6),
                traces=sorted(traces))
        self._notify_round(False, res.device_s)
        if q is not None and not self._active_units:
            self._finish_quiesce(q, loop)

    def _finish_quiesce(self, q: _QuiesceOp, loop) -> None:
        """The engine reached an empty join set with zero active rows:
        audit the outgoing engine (zero leaked pages is the contract),
        run the install (which may re-point self.engine), audit the
        incoming engine, resume joins. The serving.quiesce fault point
        sits before the install: its kill is the kill-mid-quiesce drill."""
        fp.fault_point("serving.quiesce")
        if q.cancelled:
            # the waiter gave up and withdrew the op mid-drain: do NOT
            # install (the target may already be released); just resume
            with self._state_lock:
                if self._quiesce_q and self._quiesce_q[0] is q:
                    self._quiesce_q.popleft()
            obs.event("quiesce.cancelled", reason=q.reason,
                      evicted=q.evicted)
            log.info("quiesce ({}): withdrawn by its waiter; joins resume "
                     "on the current engine", q.reason)
            q.event.set()
            self._wake.set()
            return
        old = self.engine
        pre = self._audit_engine(old, "quiesce-drain")
        install_ok = True
        try:
            q.install()
        except Exception as e:  # noqa: BLE001 — a failed install keeps
            # the drained (but healthy) old engine serving; the caller
            # learns via op.ok and decides (the lifecycle fails the
            # candidate)
            install_ok = False
            log.error("quiesce ({}): install failed ({}); the previous "
                      "engine keeps serving", q.reason, e)
        post = [] if self.engine is old \
            else self._audit_engine(self.engine, "quiesce-install")
        q.install_ok = install_ok
        q.ok = install_ok and not pre and not post
        with self._state_lock:
            if self._quiesce_q and self._quiesce_q[0] is q:
                self._quiesce_q.popleft()
        self.m_quiesces.inc()
        obs.event("quiesce.complete", reason=q.reason, ok=q.ok,
                  evicted=q.evicted, install_ok=install_ok,
                  audit_violations=len(pre) + len(post),
                  duration_ms=round((loop.time() - q.t0) * 1e3, 1))
        if not q.ok:
            # an unhealthy quiesce (a failed install or audit violations)
            # is a pool incident: the dump's `pool` member holds the page
            # map of this moment
            obs.FLIGHT.trip_async(
                "quiesce",
                detail=f"quiesce ({q.reason}) completed unhealthily: "
                       f"install_ok={install_ok}, "
                       f"{len(pre) + len(post)} audit violation(s)")
        log.info("quiesce ({}): complete in {:.0f}ms — {} row(s) "
                 "evicted with retry, audit {} ({} violation(s))",
                 q.reason, (loop.time() - q.t0) * 1e3, q.evicted,
                 "clean" if not (pre or post) else "FAILED",
                 len(pre) + len(post))
        q.event.set()
        self._wake.set()           # joins resume immediately

    @staticmethod
    def _audit_engine(engine, context: str) -> List[str]:
        """Run the engine's pool auditor if it has one (stub engines in
        tests may not); violations are already reported by the engine."""
        audit = getattr(engine, "audit", None)
        if audit is None:
            return []
        try:
            return list(audit(context=context))
        except TypeError:
            return list(audit())

    def _evict_with_retry(self, u: _Unit, loop, msg: str) -> None:
        """Fail one decoding row's request with the retriable RowEvicted
        (the server replies !!SERVER-RETRY); the row itself leaves the
        engine through the round's evict list, freeing its pages."""
        if u.req.future.done():
            return
        # counted before _outcome fills the reply's row breakdown
        u.req.evictions_n += 1
        self._outcome("evicted", u.req, loop.time())
        u.req.future.set_exception(RowEvicted(msg + " — retry"))

    def _notify_round(self, error: bool, device_s: float) -> None:
        """Report one engine round's health to the lifecycle observer
        (the SwapController windows these per version for canary
        promotion and live auto-rollback in iteration mode)."""
        fn = self.round_observer
        if fn is None:
            return
        try:
            fn(error, device_s)
        except Exception as e:  # noqa: BLE001 — health accounting must
            log.warn("round observer failed: {}", e)   # never kill rounds

    def _brownout_victims(self, loop, exclude: List[_Unit]) -> List[_Unit]:
        """Brownout level >= 2: when queued work outranks a decoding row
        and could not join this round, evict the lowest-priority active
        row (ties: the longest decode left) with a retriable error, one
        a round, so the ladder degrades gradually. Host state only: it
        runs in the join pass, before the round."""
        if self.queued_units() <= 0:
            return []
        with self._state_lock:
            top = max((p for p, lane in self._lanes.items() if lane),
                      default=None)
        if top is None:
            return []
        victims = [u for u in self._active_units
                   if u not in exclude and not u.req.future.done()
                   and u.req.priority < top]
        if not victims:
            return []
        progress = getattr(self.engine, "row_progress", None)

        def score(u: _Unit):
            prog = progress(u) if progress is not None else None
            remaining = (prog[1] - prog[0]) if prog else 0
            return (u.req.priority, -remaining)

        worst = min(victims, key=score)
        worst.evict_reason = "brownout"
        self._evict_with_retry(
            worst, loop,
            f"row evicted under brownout (level "
            f"{self._brownout_level}) to free capacity for priority "
            f"{top} traffic")
        self.m_brownout_evictions.inc()
        obs.event("brownout.evict", victim_priority=worst.req.priority,
                  queued_priority=top)
        return [worst]

    def _iteration_stalled(self, call, joins: List[_Unit], loop) -> None:
        """The engine round ran past the stall timeout: every row of it
        fails retriably, the wedged worker (with the old engine's device
        state) is abandoned, and the engine is rebuilt from the factory.
        The scheduler drops its reference first: the wedged round still
        holds the old engine and its KV pool until it returns, and the
        rebuilt one allocates a second pool beside it."""
        victims = list(self._active_units) + joins
        self._active_units.clear()
        self._trip_watchdog(call, len(victims))
        now = loop.time()
        for u in victims:
            self._end_row_span(u, "stalled", retriable=True)
            if not u.req.future.done():
                self.counts["stalled"] += 1
                self._outcome("stalled", u.req, now)
                u.req.future.set_exception(DispatchStalled(
                    f"decode step stalled past {self.stall_timeout}s — "
                    f"retry"))
        obs.event("serve.watchdog_trip", rows=len(victims),
                  stall_timeout=self.stall_timeout, mode="iteration")
        obs.FLIGHT.trip_async(
            "watchdog",
            detail=f"iteration decode step ({len(victims)} sentences) "
                   f"stalled past {self.stall_timeout}s")
        self._notify_round(True, self.stall_timeout)
        if self.engine_factory is not None:
            old = weakref.ref(self.engine)
            self.engine = None
            try:
                self.install_engine(self.engine_factory())
            except Exception as e:  # noqa: BLE001
                # back to the old engine, as the reference keeps it: its
                # next round trips again and retries the rebuild
                self.engine = old()
                log.error("engine rebuild after stall failed: {}", e)

    def _iteration_failed(self, joins: List[_Unit], loop, exc) -> None:
        """The round raised: its rows' requests fail (retriably when the
        engine can be rebuilt or the error says so) and the engine is
        rebuilt from the factory."""
        victims = list(self._active_units) + joins
        self._active_units.clear()
        log.error("iteration decode round failed ({} sentences): {}",
                  len(victims), exc)
        # with a recovery path armed (a rebuild, or the lifecycle
        # observer that can roll back to a warm engine) a resend lands
        # on a healthy engine: retriable by construction
        retriable = bool(getattr(exc, "retriable", False)) \
            or self.engine_factory is not None \
            or self.round_observer is not None
        now = loop.time()
        for u in victims:
            self._end_row_span(u, "round_failed", retriable=retriable)
            if u.req.future.done():
                continue
            if retriable:
                self.counts["evictions"] += 1
                self._evict_with_retry(
                    u, loop, f"row evicted: decode round failed ({exc})")
            else:
                self.counts["failures"] += 1
                self.m_failures.inc()
                self._outcome("failure", u.req, now)
                u.req.future.set_exception(RuntimeError(str(exc)))
        self._notify_round(True, 0.0)
        if self.engine_factory is not None and self._quiesce_depth() == 0:
            # the observer may have just started a recovery itself (a
            # lifecycle rollback enqueues a quiesce re-point to the warm
            # previous engine): a rebuild on top of it would load a
            # whole model only to be replaced a round later
            try:
                self.install_engine(self.engine_factory())
            except Exception as e:  # noqa: BLE001
                log.error("engine rebuild after failure failed: {}", e)

    # -- dispatch watchdog -----------------------------------------------
    async def _guarded(self, call: "asyncio.Future"):
        """The device call's result, or ``_STALLED`` when it is still
        running after the stall timeout (the call goes on; see
        _trip_watchdog)."""
        if self.stall_timeout <= 0:
            return await call
        try:
            return await asyncio.wait_for(asyncio.shield(call),
                                          self.stall_timeout)
        except asyncio.TimeoutError:
            return _STALLED

    def _trip_watchdog(self, pending: "asyncio.Future", n_rows: int) -> None:
        """The in-flight device call exceeded the stall timeout. A thread
        wedged inside a device call has no cancellation point; what can
        be saved is the scheduler: abandon the wedged worker, log if its
        call ever ends, hand the process-wide CUDA sync-debug mode back
        (a round abandoned inside an engine's ``sync_debug`` guard would
        otherwise leave it set for the fresh worker's rounds), and point
        the executor at a fresh single worker."""
        self.counts["watchdog_trips"] += 1
        self.m_watchdog.inc()
        log.error(
            "DISPATCH WATCHDOG: device batch ({} sentences) still running "
            "after {}s — failing its requests with a retriable error and "
            "replacing the device worker (the stuck thread is abandoned)",
            n_rows, self.stall_timeout)

        def _late(f) -> None:
            if f.cancelled():
                return
            exc = f.exception()
            log.warn("watchdog-abandoned device batch eventually {} — "
                     "its results were discarded",
                     f"failed: {exc}" if exc else "completed")
        pending.add_done_callback(_late)
        release_sync_guard()
        old, was_own = self._executor, self._own_executor
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-device")
        self._own_executor = True
        if was_own and old is not None:
            # injected executors stay the caller's to shut down
            old.shutdown(wait=False)
            # detach the wedged worker from concurrent.futures' atexit
            # join: its threads are non-daemon, so a call that never
            # returns would hang interpreter shutdown after a graceful
            # drain (private API: without it, the orchestrator's kill is
            # the backstop)
            try:
                from concurrent.futures import thread as _cf_thread
                for t in list(getattr(old, "_threads", ())):
                    _cf_thread._threads_queues.pop(t, None)
            except Exception:  # noqa: BLE001
                pass

    def _complete_unit(self, u: _Unit, line: str, loop) -> None:
        req = u.req
        if req.future.done():
            return                    # cancelled/timed out while decoding
        req.results[u.idx] = line
        req.remaining -= 1
        if req.remaining == 0:
            if req.timeout_handle is not None:
                req.timeout_handle.cancel()
            req.future.set_result([r if r is not None else ""
                                   for r in req.results])
            now = loop.time()
            # the trace-id exemplar links a latency outlier on
            # /metrics?exemplars=1 to this request's span tree
            self.m_latency.observe(now - req.arrival,
                                   trace_id=req.trace_id or None)
            self._outcome("ok", req, now)

    def _version_label(self, req: Optional[_Request] = None) -> str:
        try:
            # fleet mode: a tenanted request labels with ITS tenant's
            # live version ("<tag>:<bundle>"), not the global one
            if req is not None and req.tenant \
                    and self.tenant_version_fn is not None:
                return str(self.tenant_version_fn(req.tenant))
            return str(self.version_fn())
        except Exception:  # noqa: BLE001 — labeling must never fail a reply
            return "unknown"

    def _outcome(self, outcome: str, req: Optional[_Request] = None,
                 now: Optional[float] = None) -> None:
        """One request resolved: count it under the model version live
        now, so a swap-correlated outcome shift shows per version. With
        ``req``, also fill its reply metadata (queue wait against
        service time) and end its span tree."""
        version = self._version_label(req)
        self.m_outcomes.labels(outcome, version).inc()
        if req is None:
            return
        if now is None:
            try:
                now = asyncio.get_event_loop().time()
            except RuntimeError:  # pragma: no cover — loop gone at teardown
                now = req.arrival
        fd = req.first_dispatch
        queue_s = max(0.0, (fd if fd is not None else now) - req.arrival)
        service_s = max(0.0, now - fd) if fd is not None else 0.0
        if req.meta is not None:
            req.meta.update(trace_id=req.trace_id, outcome=outcome,
                            model_version=version,
                            queue_s=round(queue_s, 6),
                            service_s=round(service_s, 6))
            if self.batching_mode == "iteration":
                # the row breakdown: rounds ridden (the most of any of
                # its rows), time to first join (-1: never joined), a
                # prefix-cache hit, retriable evictions
                req.meta.update(
                    rounds=req.rounds,
                    ttfj_ms=round(queue_s * 1e3, 1) if fd is not None
                    else -1.0,
                    prefix_hit=int(req.prefix_hits > 0),
                    evictions=req.evictions_n)
        if req.d_span is not None:
            obs.end(req.d_span, outcome=outcome, model_version=version)
            req.d_span = None
        if req.q_span is not None:       # resolved while still queued
            obs.end(req.q_span, outcome=outcome)
            req.q_span = None
        if req.own_root and req.span is not None:
            obs.end(req.span, outcome=outcome, model_version=version)
            req.span = None
