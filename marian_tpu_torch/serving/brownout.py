"""Brownout ladder, ported from ``marian_tpu/serving/brownout.py``:
explicit, signal-driven degradation under sustained overload.

Without it, the only overload behaviors are the admission bound (a shed
at a hard edge) and fail-loud engine rounds: every priority lane's
latency diverges together until something sheds. The ladder turns
sustained overload into ORDERED, observable degradation levels, each an
explicit trade:

- **level 0 (normal)** — nothing.
- **level 1 (tighten)** — new decode rows claim a scaled-down decode
  cap (``--brownout-cap-factor``): each sentence costs fewer KV pages
  and fewer steps, at the price of truncating the longest outputs.
- **level 2 (evict)** — when queued work outranks a decoding row, the
  lowest-priority active row (ties: the longest decode left) is evicted
  with a retriable ``!!SERVER-RETRY``, one a round.
- **level 3 (shed)** — admission sheds requests below
  ``--brownout-min-priority`` with an explicit !!SERVER-OVERLOADED; the
  high lanes keep a bounded queue while the low lanes fail fast.

Signals, both kept by the observability plane (the ladder keeps no
accounting of its own):

- ``marian_capacity_headroom_ratio`` (obs/perf.py): headroom at or below
  ``--brownout-headroom`` means the replica is saturated;
- the SLO engine's fast-window burn rate (obs/slo.py): a burn at or
  above the fast-burn factor means the error budget goes at incident
  speed.

Either signal sustained for ``--brownout-hold`` seconds escalates one
level; both healthy for ``--brownout-cool`` seconds de-escalate one
level. Every transition is a timeline event (``brownout.level``), a
gauge move (``marian_brownout_level``), a counter
(``marian_brownout_transitions_total{direction}``) and, on escalation,
a flight-recorder dump, so the incident is captured while it unfolds.

The evaluator runs on its own daemon thread (like the SLO engine);
nothing here touches the batch path. Effects go through ``apply_fn``
(the server wires the scheduler's and admission's level setters), called
outside the controller's lock, ``BrownoutController._lock``
(``lockdep.make_lock``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from .. import obs
from ..common import lockdep
from ..common import logging as log

LEVEL_NAMES = ("normal", "tighten", "evict", "shed")

DEFAULT_HEADROOM_FLOOR = 0.1
DEFAULT_BURN_THRESHOLD = 14.4       # the SLO engine's fast-burn factor
DEFAULT_HOLD_S = 5.0
DEFAULT_COOL_S = 15.0
DEFAULT_INTERVAL_S = 1.0


class BrownoutController:
    def __init__(self,
                 apply_fn: Callable[[int], None],
                 headroom_fn: Optional[Callable[[], float]] = None,
                 burn_fn: Optional[Callable[[], float]] = None,
                 registry=None,
                 headroom_floor: float = DEFAULT_HEADROOM_FLOOR,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD,
                 hold_s: float = DEFAULT_HOLD_S,
                 cool_s: float = DEFAULT_COOL_S,
                 interval: float = DEFAULT_INTERVAL_S,
                 max_level: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        from . import metrics as msm      # lazy: no import cycle
        self.apply_fn = apply_fn
        self.headroom_fn = headroom_fn
        self.burn_fn = burn_fn
        self.headroom_floor = float(headroom_floor)
        self.burn_threshold = float(burn_threshold)
        self.hold_s = max(0.0, float(hold_s))
        self.cool_s = max(0.0, float(cool_s))
        self.interval = max(0.05, float(interval))
        self.max_level = max(1, min(3, int(max_level)))
        self.clock = clock
        self._lock = lockdep.make_lock("BrownoutController._lock")
        self._level = 0                                 # guarded by _lock
        self._pressure_since: Optional[float] = None    # guarded by _lock
        self._healthy_since: Optional[float] = None     # guarded by _lock
        self._last_signals: Dict = {}                   # guarded by _lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        r = registry if registry is not None else msm.REGISTRY
        self.m_level = r.gauge(
            "marian_brownout_level",
            "Current brownout degradation level (0 normal, 1 tighten "
            "decode caps, 2 evict low-priority rows, 3 shed low-"
            "priority admissions)")
        self.m_level.set(0)
        self.m_transitions = r.counter(
            "marian_brownout_transitions_total",
            "Brownout ladder level transitions", labels=("direction",))

    # -- signals ------------------------------------------------------------
    def _read_signals(self):
        headroom = 1.0
        burn = 0.0
        if self.headroom_fn is not None:
            try:
                headroom = float(self.headroom_fn())
            except Exception:  # noqa: BLE001 — a broken gauge must not
                headroom = 1.0                    # wedge the evaluator
        if self.burn_fn is not None:
            try:
                burn = float(self.burn_fn())
            except Exception:  # noqa: BLE001
                burn = 0.0
        return headroom, burn

    # -- evaluation ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> int:
        """One evaluation: read the signals, maybe move one level, apply
        and announce the transition. Returns the (possibly new) level.
        Called by the evaluator thread, and by tests with their own
        clock."""
        if now is None:
            now = self.clock()
        headroom, burn = self._read_signals()
        overloaded = headroom <= self.headroom_floor \
            or (self.burn_threshold > 0 and burn >= self.burn_threshold)
        new_level: Optional[int] = None
        with self._lock:
            level = self._level
            if overloaded:
                self._healthy_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                if level < self.max_level \
                        and now - self._pressure_since >= self.hold_s:
                    new_level = level + 1
                    # the next rung needs its own sustained hold
                    self._pressure_since = now
            else:
                self._pressure_since = None
                if self._healthy_since is None:
                    self._healthy_since = now
                if level > 0 \
                        and now - self._healthy_since >= self.cool_s:
                    new_level = level - 1
                    self._healthy_since = now
            if new_level is not None:
                self._level = new_level
            self._last_signals = {
                "headroom": round(headroom, 4), "burn": round(burn, 3),
                "overloaded": overloaded, "ts": now}
        if new_level is None:
            return level
        # effects and announcements outside the lock: apply_fn reaches
        # into the scheduler and admission, and a dump does file IO
        up = new_level > level
        try:
            self.apply_fn(new_level)
        except Exception as e:  # noqa: BLE001 — a failed effect keeps
            log.error("brownout apply({}) failed: {}", new_level, e)
        self.m_level.set(new_level)
        self.m_transitions.labels("up" if up else "down").inc()
        obs.event("brownout.level", level=new_level,
                  level_name=LEVEL_NAMES[new_level],
                  direction="up" if up else "down",
                  headroom=round(headroom, 4), burn=round(burn, 3))
        logf = log.error if up else log.info
        logf("BROWNOUT: level {} -> {} ({}) — headroom {:.3f} (floor "
             "{:.2f}), fast burn {:.1f} (threshold {:.1f})", level,
             new_level, LEVEL_NAMES[new_level], headroom,
             self.headroom_floor, burn, self.burn_threshold)
        if up:
            # an escalation is an incident: capture the span ring and the
            # state while the overload unfolds, not after
            obs.FLIGHT.trip_async(
                "brownout",
                detail=f"escalated to level {new_level} "
                       f"({LEVEL_NAMES[new_level]}): headroom "
                       f"{headroom:.3f}, burn {burn:.1f}")
        return new_level

    def level(self) -> int:
        with self._lock:
            return self._level

    def state(self) -> Dict:
        """JSON-ready state (flight dumps, /sloz)."""
        with self._lock:
            return {
                "enabled": True,
                "level": self._level,
                "name": LEVEL_NAMES[self._level],
                "headroom_floor": self.headroom_floor,
                "burn_threshold": self.burn_threshold,
                "hold_s": self.hold_s,
                "cool_s": self.cool_s,
                "signals": dict(self._last_signals),
            }

    # -- evaluator thread ---------------------------------------------------
    def start(self) -> "BrownoutController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="brownout-eval")
            self._thread.start()
            log.info("brownout ladder armed: headroom floor {:g}, burn "
                     "threshold {:g}, hold {:g}s, cool {:g}s",
                     self.headroom_floor, self.burn_threshold,
                     self.hold_s, self.cool_s)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the evaluator must
                log.warn("brownout tick failed: {}", e)      # never die

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        # a level left armed after the controller is gone would brown
        # the replica out forever
        reset = False
        with self._lock:
            if self._level != 0:
                self._level = 0
                reset = True
        if reset:
            try:
                self.apply_fn(0)
            except Exception:  # noqa: BLE001
                pass
            self.m_level.set(0)
