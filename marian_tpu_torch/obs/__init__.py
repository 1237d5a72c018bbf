"""marian_tpu_torch.obs — the observability plane of the server and the
trainer, ported from ``marian_tpu/obs/`` (the port imports nothing of
the JAX package): request-scoped span tracing with an event timeline
(trace.py), the crash flight recorder (flight.py), the live perf and
capacity gauges (perf.py), the SLO burn-rate engine (slo.py), the
KV-pool inspector (poolz.py) and the training loop's phase timer and
profiler window (profiling.py).

One process-wide :data:`TRACER` records named spans and instant events
into bounded in-memory rings; one :data:`FLIGHT` recorder snapshots them
(with /metrics and the registered state providers) to disk when a
watchdog trip, a rollback, an unhealthy quiesce, a failed pool audit or
a fast SLO burn fires, and before an armed fault point's ``kill``; every
fault-point firing lands on the timeline as a ``fault.fire`` event.
Exports are Chrome trace-event JSON — ``/tracez`` on the metrics port
and the flight dumps, both loadable in Perfetto.

Everything is stdlib only and off by default at no cost (no ring, no
lock on the serving hot path). ``--trace`` (or ``MARIAN_TRACE=1``)
enables the tracer, ``--trace-dump DIR`` (or ``MARIAN_TRACE_DUMP``) arms
the recorder, ``--perf-accounting`` (or ``MARIAN_PERF=1``) the perf
plane.
"""

from __future__ import annotations

import os

from .flight import FLIGHT, FlightRecorder               # noqa: F401
from .perf import PERF, PerfMeter                        # noqa: F401
from .poolz import pool_routes                           # noqa: F401
from .trace import (NOOP_SPAN, Span, Tracer, TRACER,     # noqa: F401
                    current, enabled, end, event, new_trace_id, set_attrs,
                    start_span, trace_routes)

ENV_TRACE = "MARIAN_TRACE"
ENV_DUMP = "MARIAN_TRACE_DUMP"
ENV_PERF = "MARIAN_PERF"

_FIRE_HOOKED = False


def _hook_faultpoints() -> None:
    """Record every armed fault-point firing on the event timeline, so a
    flight dump shows the injected failure next to its victims."""
    global _FIRE_HOOKED
    if _FIRE_HOOKED:
        return
    _FIRE_HOOKED = True
    from ..common import faultpoints as fp

    def _on_fire(name: str, mode: str, hit: int) -> None:
        TRACER.event("fault.fire", point=name, mode=mode, hit=hit)

    fp.add_fire_hook(_on_fire)


def configure(options=None) -> bool:
    """Read the tracing knobs and enable/arm accordingly; returns
    whether the tracer ended up enabled. Called by the server and the
    trainer; safe to call more than once.

    - ``--trace`` / ``MARIAN_TRACE=1``: enable span recording.
    - ``--trace-ring N``: span ring capacity (default 4096).
    - ``--trace-dump DIR`` / ``MARIAN_TRACE_DUMP``: arm the flight
      recorder (implies ``--trace`` — a dump without spans is useless).
    - ``--perf-accounting`` / ``MARIAN_PERF=1``: enable the perf and
      capacity plane (obs/perf.py). The server's parser defaults it on;
      hand-built Options without the key leave it off, so bare test
      fixtures keep the free batch path.
    """
    get = options.get if options is not None else (lambda *_a: None)
    ring = int(get("trace-ring", 0) or 0)
    dump = str(get("trace-dump", "") or "") \
        or os.environ.get(ENV_DUMP, "")
    on = bool(get("trace", False)) \
        or os.environ.get(ENV_TRACE, "") == "1" or bool(dump)
    if on:
        TRACER.enable(capacity=ring or None)
        _hook_faultpoints()
    if dump:
        FLIGHT.arm(dump)
    if bool(get("perf-accounting", False)) \
            or os.environ.get(ENV_PERF, "") == "1":
        PERF.enable()
        FLIGHT.add_snapshot_provider("perf", PERF.state)
    return TRACER.enabled
