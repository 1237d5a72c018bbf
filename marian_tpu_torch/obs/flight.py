"""Crash flight recorder, ported from ``marian_tpu/obs/flight.py``.

When something goes wrong in production (the dispatch watchdog trips, a
canary or live version is rolled back, a quiesce ends unhealthy, a pool
audit fails, an SLO burns fast, a fault point kills the process) the
span ring and the event timeline hold the evidence an operator needs,
and they live in process memory. The flight recorder snapshots them,
with the current ``/metrics`` text, the registered state providers
(pool, slo, perf) and the fault points' hit counters, to a timestamped
JSON file the moment the trigger fires.

Armed by ``--trace-dump DIR`` (or ``MARIAN_TRACE_DUMP=DIR``); disarmed,
every trip is a cheap no-op. Trigger sites:

- serving/scheduler.py: watchdog trip, poison-request isolation, an
  unhealthy quiesce;
- serving/lifecycle/controller.py: canary, live and manual rollback;
- translator/iteration.py: a failed pool audit;
- obs/slo.py: a fast burn;
- common/faultpoints.py's ``kill``: a hook registered when the recorder
  is armed dumps before the simulated SIGKILL (``os._exit``) lands;
- interpreter exit with anything recorded (``atexit``).

Dump shape::

    {"reason", "detail", "trace_id", "ts", "pid", "thread", "seq",
     "trace": <Chrome trace JSON — open in Perfetto>,
     "metrics": <prometheus text>, "faultpoints": {"spec", "hits"},
     <provider key>: <its state>, ...}

Locking: ``FlightRecorder._lock`` guards only the armed directory, the
sequence number and the provider table; the file write and every
snapshot call run with no lock held.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import re
import threading
from typing import Dict, Optional

from ..common import faultpoints as fp
from ..common import lockdep
from ..common import logging as log
from .trace import TRACER

_SLUG_RE = re.compile(r"[^a-z0-9-]+")


def _slug(reason: str) -> str:
    return _SLUG_RE.sub("-", reason.lower()).strip("-") or "trip"


class FlightRecorder:
    def __init__(self):
        self._lock = lockdep.make_lock("FlightRecorder._lock")
        self._dir: Optional[str] = None     # guarded-by: _lock
        self._seq = 0                       # guarded-by: _lock
        self._hooked = False                # guarded-by: _lock
        # extra state snapshotted into every dump (the SLO engine, the
        # perf meter and the KV pool register here, so a post-mortem
        # shows the burn rates, headroom and page map, not just the
        # latencies); key -> zero-arg JSON-ready callable
        self._providers: Dict[str, object] = {}   # guarded-by: _lock

    def add_snapshot_provider(self, key: str, fn) -> None:
        """Register ``fn()`` to be embedded as payload[key] in every
        future dump. Re-registering a key replaces it; a raising
        provider degrades to an error string, never a failed dump."""
        with self._lock:
            self._providers[key] = fn

    def remove_snapshot_provider(self, key: str) -> None:
        with self._lock:
            self._providers.pop(key, None)

    def arm(self, dump_dir: str) -> None:
        """Point dumps at ``dump_dir`` (created if missing); the first
        arm hooks the fault points' kill path, so an injected crash dumps
        before it dies, and a final snapshot at interpreter exit."""
        dump_dir = os.path.abspath(dump_dir)
        os.makedirs(dump_dir, exist_ok=True)
        hook = False
        with self._lock:
            self._dir = dump_dir
            if not self._hooked:
                self._hooked = True
                hook = True
        if hook:
            fp.add_kill_hook(self._on_kill)
            atexit.register(self._on_exit)
        log.info("Flight recorder armed: dumps to {}", dump_dir)

    def disarm(self) -> None:
        with self._lock:
            self._dir = None

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._dir is not None

    def trip_async(self, reason: str, trace_id: Optional[str] = None,
                   detail: str = "", extra: Optional[Dict] = None) -> None:
        """Fire-and-forget :meth:`trip` on a background thread, for
        callers on the asyncio event loop (the scheduler's watchdog,
        poison and quiesce paths) and on the device worker (a pool
        audit): a dump serializes the whole span ring and /metrics and
        writes a file, which must not freeze every connection at the
        moment of the incident. Callers end the victims' spans first, so
        the ring snapshot on the dump thread holds them."""
        with self._lock:
            armed = self._dir is not None
        if not armed:
            return
        threading.Thread(
            target=self.trip, args=(reason,),
            kwargs={"trace_id": trace_id, "detail": detail, "extra": extra,
                    # the counters at the incident: a drill may disarm
                    # before the dump thread runs
                    "fault_hits": fp.hit_counts()},
            name="flight-dump", daemon=True).start()

    def _on_kill(self, name: str, hit: int) -> None:
        self.trip("fault-kill", detail=f"fault point {name} (hit {hit}) "
                  f"is killing the process")

    def _on_exit(self) -> None:  # pragma: no cover — atexit timing
        spans, events = TRACER.snapshot()
        if spans or events:      # nothing recorded = nothing to keep
            self.trip("exit", detail="process exit — final span-ring "
                      "snapshot (atexit)")

    def trip(self, reason: str, trace_id: Optional[str] = None,
             detail: str = "", extra: Optional[Dict] = None,
             fault_hits: Optional[Dict] = None) -> Optional[str]:
        """Snapshot everything to a new dump file; returns its path, or
        None when disarmed (the cheap common case). Never raises — a
        failing dump must not worsen the incident being recorded."""
        with self._lock:
            d = self._dir
            if d is None:
                return None
            self._seq += 1
            seq = self._seq
        try:
            return self._write(d, seq, reason, trace_id, detail, extra,
                               fault_hits)
        except Exception as e:  # noqa: BLE001 — post-mortem best effort
            log.warn("flight recorder: dump for {!r} failed: {}", reason, e)
            return None

    def _write(self, d: str, seq: int, reason: str,
               trace_id: Optional[str], detail: str,
               extra: Optional[Dict],
               fault_hits: Optional[Dict] = None) -> str:
        now = datetime.datetime.now(datetime.timezone.utc)
        payload: Dict = {
            "reason": reason,
            "detail": detail,
            "trace_id": trace_id or "",
            "ts": now.isoformat(timespec="milliseconds"),
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
            "seq": seq,
            "trace": TRACER.chrome_trace(),
        }
        if extra:
            payload["extra"] = dict(extra)
        with self._lock:
            providers = dict(self._providers)
        for key, fn in sorted(providers.items()):
            try:
                payload[key] = fn()
            except Exception as e:  # noqa: BLE001 — best-effort snapshot
                payload[key] = f"unavailable: {e}"
        try:
            from ..serving import metrics as msm   # lazy: no import cycle
            payload["metrics"] = msm.REGISTRY.render()
        except Exception as e:  # noqa: BLE001 — metrics are best effort
            payload["metrics"] = f"unavailable: {e}"
        payload["faultpoints"] = {
            "spec": os.environ.get(fp.ENV_SPEC, ""),
            "hits": fault_hits if fault_hits is not None
            else fp.hit_counts(),
        }
        fname = (f"flight-{now.strftime('%Y%m%dT%H%M%S')}-"
                 f"{os.getpid()}-{seq:03d}-{_slug(reason)}.json")
        path = os.path.join(d, fname)
        # dot-prefixed, so a consumer polling the directory for
        # `flight-*` never picks up the half-written file the
        # os.replace below makes atomic
        tmp = os.path.join(d, "." + fname + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=1, default=repr)
        os.replace(tmp, path)
        try:
            from ..serving import metrics as msm
            m_dumps = msm.counter(
                "marian_flight_dumps_total",
                "Flight-recorder dumps written, by trigger reason",
                labels=("reason",))
            m_dumps.labels(reason).inc()
        except Exception:  # noqa: BLE001
            pass
        log.error("FLIGHT RECORDER: {} — dumped span ring + timeline + "
                  "metrics to {} (open the 'trace' member in Perfetto)",
                  reason, path)
        return path


# Process-wide instance, like TRACER and the metrics REGISTRY.
FLIGHT = FlightRecorder()
