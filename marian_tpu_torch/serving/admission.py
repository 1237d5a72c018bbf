"""Admission control for the serving subsystem, ported from
``marian_tpu/serving/admission.py``.

A bounded queue with an EXPLICIT cheap rejection (``Overloaded``, which
the transports turn into ``!!SERVER-OVERLOADED``) instead of a queue that
grows until the host runs out of memory, and a drain mode that lets
in-flight work finish while new requests are refused. Units are
SENTENCES; in iteration mode the queue debt is also priced in KV-pool
PAGES, since a 500-token sentence owes far more pool than a 5-token one.
The brownout ladder's top rung (serving/brownout.py, level 3) sheds
requests whose priority lane is below ``--brownout-min-priority``.

Series: ``marian_serving_admitted_sentences_total``,
``marian_serving_shed_total{reason}`` (draining, brownout, queue_full,
pages_full) and ``marian_serving_queue_limit_sentences``. A shed and the
start of a drain land on the obs timeline (``admission.shed``,
``admission.drain_started``); the admitted path records nothing.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .. import obs
from ..common import lockdep
from . import metrics as msm


class Overloaded(RuntimeError):
    """Request shed by admission control (queue full or draining).
    ``retriable`` tells "try again shortly" (queue full) from "this
    replica is going away" (draining)."""

    def __init__(self, message: str, retriable: bool = True):
        super().__init__(message)
        self.retriable = retriable


class AdmissionController:
    """Bounded-queue gate in front of the scheduler.

    ``depth_fn`` reports the scheduler's live queued sentences and
    ``pages_fn`` its live queued page debt; ``max_queue_units <= 0`` or
    ``max_queue_pages <= 0`` disables that bound."""

    def __init__(self, max_queue_units: int, depth_fn: Callable[[], int],
                 max_queue_pages: int = 0,
                 pages_fn: Optional[Callable[[], int]] = None,
                 registry: Optional[msm.Registry] = None):
        self.max_queue_units = int(max_queue_units)
        self.depth_fn = depth_fn
        self.max_queue_pages = int(max_queue_pages)
        self.pages_fn = pages_fn
        # the transports admit on the event-loop thread; begin_drain may
        # come from another (a signal handler, an embedding program)
        self._lock = lockdep.make_lock("AdmissionController._lock")
        self._draining = False
        self._drain_started: Optional[float] = None
        # the brownout ladder's rung: written by its evaluator thread,
        # read at every admit
        self._brownout_level = 0
        self._brownout_min_priority = 1
        r = registry if registry is not None else msm.REGISTRY
        self.m_admitted = r.counter(
            "marian_serving_admitted_sentences_total",
            "Sentences admitted into the scheduler queue")
        self.m_shed = r.counter(
            "marian_serving_shed_total",
            "Requests rejected by admission control", labels=("reason",))
        self.m_queue_limit = r.gauge(
            "marian_serving_queue_limit_sentences",
            "Configured admission bound in sentences (0 = unbounded)")
        self.m_queue_limit.set(self.max_queue_units)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def set_brownout(self, level: int, min_priority: int = 1) -> None:
        """Arm or disarm the ladder's admission rung (the brownout
        evaluator thread): at ``level >= 3`` requests with priority below
        ``min_priority`` are shed with a retriable !!SERVER-OVERLOADED."""
        with self._lock:
            self._brownout_level = max(0, int(level))
            self._brownout_min_priority = int(min_priority)

    def _gate_state(self):
        with self._lock:
            return (self._draining, self._brownout_level,
                    self._brownout_min_priority)

    def admit(self, n_units: int, n_pages: int = 0,
              priority: int = 0) -> None:
        """Gate one request of ``n_units`` sentences owing ``n_pages``
        pages: raises Overloaded instead of queueing when a bound would
        be exceeded, the server is draining, or the brownout ladder sheds
        the request's priority lane. All-or-nothing per request, so one
        client's reply never splits across a shed."""
        draining, b_level, b_minp = self._gate_state()
        if draining:
            self.m_shed.labels("draining").inc()
            obs.event("admission.shed", reason="draining", units=n_units)
            raise Overloaded("server is draining (shutting down); retry "
                             "against another replica", retriable=False)
        if b_level >= 3 and priority < b_minp:
            self.m_shed.labels("brownout").inc()
            obs.event("admission.shed", reason="brownout", units=n_units,
                      priority=priority, level=b_level)
            raise Overloaded(
                f"brownout level {b_level}: priority-{priority} lane is "
                f"shed under sustained overload (lanes >= {b_minp} keep "
                f"serving); retry later or against another replica")
        if self.max_queue_units > 0:
            depth = int(self.depth_fn())
            if depth + n_units > self.max_queue_units:
                self.m_shed.labels("queue_full").inc()
                obs.event("admission.shed", reason="queue_full",
                          units=n_units, depth=depth)
                raise Overloaded(
                    f"queue full ({depth}/{self.max_queue_units} sentences "
                    f"queued, request adds {n_units}); retry later")
        if self.max_queue_pages > 0 and self.pages_fn is not None:
            pages = int(self.pages_fn())
            if pages + n_pages > self.max_queue_pages:
                self.m_shed.labels("pages_full").inc()
                obs.event("admission.shed", reason="pages_full",
                          units=n_units, pages=pages)
                raise Overloaded(
                    f"queue page debt full ({pages}/"
                    f"{self.max_queue_pages} KV-pool pages owed, request "
                    f"adds {n_pages}); retry later")
        self.m_admitted.inc(n_units)

    def begin_drain(self) -> None:
        """Stop admitting (idempotent); /readyz then answers 503."""
        fresh = False
        with self._lock:
            if not self._draining:
                self._draining = True
                self._drain_started = time.time()
                fresh = True
        if fresh:                       # the timeline event outside the lock
            obs.event("admission.drain_started")
