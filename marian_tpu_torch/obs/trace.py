"""Request-scoped span tracer, ported from ``marian_tpu/obs/trace.py``
(the port imports nothing of the JAX package): named SPANS (start, end,
attributes) and instant EVENTS, linked by trace id into trees, recorded
into a bounded in-memory ring and exported as Chrome trace-event JSON
(``/tracez`` on the metrics port, loadable in Perfetto or
chrome://tracing) and through the flight recorder (obs/flight.py).

- **Stdlib only**, importable from any layer of the port.
- **Free when off** (the default): ``start_span`` returns the
  ``NOOP_SPAN`` singleton after one attribute check; no ring is
  allocated, no lock is taken, no dict is built. The overhead-guard test
  asserts this on the scheduler's per-batch path.
- **When on**, a span is recorded once, at its end, by one bounded-deque
  append under ``Tracer._lock`` (``lockdep.make_lock``); exports
  snapshot under the same lock.
- **Context** follows ``contextvars`` (asyncio tasks on the event loop);
  where the request path crosses threads (scheduler -> device worker)
  the parent is handed over explicitly (``parent=``, ``Tracer.use``).

Span identity: ``trace_id`` (one per request; a client may give it with
the ``#trace:<id>`` header, server/server.py), ``span_id`` (unique in the
process), ``parent_id`` (the tree edge). The scheduler's latency
histograms carry the trace id as an exemplar, so a p99 outlier on
``/metrics?exemplars=1`` links to its span tree here.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..common import lockdep

# wall-clock anchor: spans timestamp with the monotonic perf_counter;
# exports shift onto the epoch so dumps from different processes align
_EPOCH = time.time() - time.perf_counter()

# the current span for THIS task/thread (contextvars: each asyncio task
# and each thread sees its own value; worker threads get the parent
# passed explicitly instead)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "marian_current_span", default=None)

DEFAULT_RING = 4096
DEFAULT_EVENT_RING = 2048


def new_trace_id() -> str:
    """64-bit random hex trace id."""
    return f"{random.getrandbits(64):016x}"


class _NoopSpan:
    """The disabled-mode span: every operation is a no-op. A singleton,
    so the disabled hot path allocates nothing."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = ""

    def set_attrs(self, **kw) -> "_NoopSpan":
        return self

    def __bool__(self) -> bool:
        return False        # `if span:` guards read naturally

    def __repr__(self) -> str:
        return "<noop span>"


NOOP_SPAN = _NoopSpan()


class Span:
    """One named interval. Mutable until :meth:`Tracer.end` records it
    into the ring; attributes set after the end would rewrite history
    (the ring holds a reference)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end_t", "attrs", "thread")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, start: float,
                 attrs: Optional[Dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_t: Optional[float] = None
        self.attrs: Dict = attrs if attrs is not None else {}
        self.thread = threading.current_thread().name

    def set_attrs(self, **kw) -> "Span":
        self.attrs.update(kw)
        return self

    def duration(self) -> float:
        return (self.end_t - self.start) if self.end_t is not None else 0.0

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return (f"<span {self.name} trace={self.trace_id} "
                f"id={self.span_id} parent={self.parent_id or '-'}>")


class Tracer:
    """Bounded-ring span/event recorder. Disabled by default; see the
    module docstring for the overhead contract."""

    def __init__(self, capacity: int = DEFAULT_RING,
                 event_capacity: int = DEFAULT_EVENT_RING):
        self.capacity = int(capacity)
        self.event_capacity = int(event_capacity)
        self._enabled = False
        # rings are allocated on enable() ONLY — "tracer off" must mean
        # no ring allocation, not an empty ring (the overhead guard)
        self._ring: Optional[collections.deque] = None   # guarded-by: _lock
        self._events: Optional[collections.deque] = None  # guarded-by: _lock
        self._lock = lockdep.make_lock("Tracer._lock")
        self._seq = itertools.count(1)   # span ids; count() is GIL-atomic

    # -- lifecycle ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None,
               event_capacity: Optional[int] = None) -> None:
        if capacity:
            self.capacity = int(capacity)
        if event_capacity:
            self.event_capacity = int(event_capacity)
        with self._lock:
            if self._ring is None or self._ring.maxlen != self.capacity:
                self._ring = collections.deque(
                    self._ring or (), maxlen=self.capacity)
            if self._events is None \
                    or self._events.maxlen != self.event_capacity:
                self._events = collections.deque(
                    self._events or (), maxlen=self.event_capacity)
        self._enabled = True

    def disable(self) -> None:
        """Stop recording; the rings keep their contents (a flight dump
        after disable still has the history). reset() frees them."""
        self._enabled = False

    def reset(self) -> None:
        self._enabled = False
        with self._lock:
            self._ring = None
            self._events = None

    # -- recording ----------------------------------------------------------
    def start_span(self, name: str, parent: Optional[Span] = None,
                   trace_id: Optional[str] = None, **attrs):
        """Open a span. ``parent=None`` inherits the context's current
        span (same task/thread); pass the parent explicitly when
        crossing threads. Not recorded until :meth:`end`."""
        if not self._enabled:
            return NOOP_SPAN
        if parent is None:
            parent = _CURRENT.get(None)
        if parent is NOOP_SPAN:
            parent = None
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None \
                else new_trace_id()
        return Span(name, trace_id, f"{next(self._seq):x}",
                    parent.span_id if parent is not None else "",
                    time.perf_counter(), dict(attrs) if attrs else None)

    def end(self, span, **attrs) -> None:
        """Close ``span`` and record it into the ring. Idempotent; a
        NOOP_SPAN or None is ignored."""
        if span is None or span is NOOP_SPAN or not isinstance(span, Span):
            return
        if span.end_t is not None:
            return
        if attrs:
            span.attrs.update(attrs)
        span.end_t = time.perf_counter()
        with self._lock:
            if self._ring is not None:
                self._ring.append(span)

    def record(self, name: str, start: float, end: float,
               parent: Optional[Span] = None, trace_id: Optional[str] = None,
               **attrs) -> None:
        """Record a retroactive complete span from two perf_counter
        timestamps (phase timers, reply writes measured after the fact)."""
        if not self._enabled:
            return
        sp = self.start_span(name, parent=parent, trace_id=trace_id, **attrs)
        if sp is NOOP_SPAN:
            return
        sp.start = start
        sp.end_t = end
        with self._lock:
            if self._ring is not None:
                self._ring.append(sp)

    def event(self, name: str, **attrs) -> None:
        """Record an instant event onto the timeline (lifecycle
        transitions, admission sheds, watchdog trips, fault firings),
        tagged with the current context's trace id when one is set."""
        if not self._enabled:
            return
        cur = _CURRENT.get(None)
        ev = {
            "name": name,
            "ts": time.perf_counter(),
            "trace_id": cur.trace_id if cur is not None
            and cur is not NOOP_SPAN else "",
            "thread": threading.current_thread().name,
            "attrs": dict(attrs) if attrs else {},
        }
        with self._lock:
            if self._events is not None:
                self._events.append(ev)

    # -- context helpers ----------------------------------------------------
    def current(self) -> Optional[Span]:
        cur = _CURRENT.get(None)
        return None if cur is NOOP_SPAN else cur

    def set_attrs(self, **kw) -> None:
        """Attach attributes to the current context span (e.g. the
        lifecycle controller stamping model_version onto the device
        translate span it runs inside)."""
        cur = _CURRENT.get(None)
        if cur is not None and cur is not NOOP_SPAN:
            cur.attrs.update(kw)

    @contextlib.contextmanager
    def use(self, span) -> Iterator:
        """Make ``span`` the context's current span WITHOUT owning its
        lifetime (the caller ends it) — the cross-thread handoff tool."""
        if span is None or span is NOOP_SPAN:
            yield span
            return
        token = _CURRENT.set(span)
        try:
            yield span
        finally:
            _CURRENT.reset(token)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             trace_id: Optional[str] = None, **attrs) -> Iterator:
        """``with tracer.span("name"):`` — start, set context, always
        end. The safe default; manual start_span/end pairs are for spans
        whose lifetime crosses callbacks."""
        sp = self.start_span(name, parent=parent, trace_id=trace_id, **attrs)
        if sp is NOOP_SPAN:
            yield sp
            return
        token = _CURRENT.set(sp)
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", repr(e))
            raise
        finally:
            _CURRENT.reset(token)
            self.end(sp)

    # -- export -------------------------------------------------------------
    def snapshot(self, last: Optional[int] = None
                 ) -> Tuple[List[Span], List[Dict]]:
        """(spans, events) copies; ``last`` bounds the span count to the
        most recent N."""
        with self._lock:
            spans = list(self._ring) if self._ring is not None else []
            events = list(self._events) if self._events is not None else []
        if last is not None and last >= 0:
            spans = spans[-last:]
        return spans, events

    def chrome_trace(self, last: Optional[int] = None) -> Dict:
        """Chrome trace-event JSON (the ``/tracez`` document): complete
        ("X") events for spans, instant ("i") events for the timeline.
        Loadable in Perfetto (ui.perfetto.dev) or chrome://tracing."""
        spans, events = self.snapshot(last)
        pid = os.getpid()
        out: List[Dict] = []
        for s in spans:
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            args.update(s.attrs)
            out.append({
                "name": s.name, "cat": s.name.split(".")[0], "ph": "X",
                "ts": (s.start + _EPOCH) * 1e6,
                "dur": max(0.0, s.duration()) * 1e6,
                "pid": pid, "tid": s.thread, "args": args,
            })
        for e in events:
            args = {"trace_id": e["trace_id"]} if e["trace_id"] else {}
            args.update(e["attrs"])
            out.append({
                "name": e["name"], "cat": "event", "ph": "i", "s": "t",
                "ts": (e["ts"] + _EPOCH) * 1e6,
                "pid": pid, "tid": e["thread"], "args": args,
            })
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"tracer_enabled": self._enabled,
                          "ring_capacity": self.capacity},
        }


# The process-wide tracer: serving, training, and the CLI layers all
# record here, like metrics' REGISTRY — one /tracez for the process.
TRACER = Tracer()


def enabled() -> bool:
    return TRACER._enabled


def current() -> Optional[Span]:
    return TRACER.current()


def start_span(name: str, parent: Optional[Span] = None,
               trace_id: Optional[str] = None, **attrs):
    return TRACER.start_span(name, parent=parent, trace_id=trace_id, **attrs)


def end(span, **attrs) -> None:
    TRACER.end(span, **attrs)


def event(name: str, **attrs) -> None:
    TRACER.event(name, **attrs)


def set_attrs(**kw) -> None:
    TRACER.set_attrs(**kw)


def trace_routes() -> Dict:
    """Extra handlers for serving/metrics.py's MetricsServer ``routes``:
    ``GET /tracez?last=N`` returns the Chrome trace JSON of the last N
    spans (all, when unset) plus the event timeline — curl it to a file
    and open in Perfetto."""

    def _tracez(method: str, query: str):
        last: Optional[int] = None
        from urllib.parse import parse_qs
        try:
            vals = parse_qs(query or "").get("last")
            if vals:
                last = max(0, int(vals[0]))
        except (ValueError, TypeError):
            last = None
        body = json.dumps(TRACER.chrome_trace(last), indent=1).encode() \
            + b"\n"
        return 200, body, "application/json"

    return {"/tracez": _tracez}
