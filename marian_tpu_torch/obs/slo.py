"""In-process SLO burn-rate engine, ported from ``marian_tpu/obs/slo.py``:
an objective ("99.9% of requests succeed", "p99 under 250 ms") and its
error-budget burn rate over two windows (the SRE workbook's
multiwindow, multi-burn-rate method), evaluated in-process against the
metrics registry, with no Prometheus server.

Objectives come from the command line:

- ``--slo-availability 0.999`` — the fraction of resolved requests that
  must be ``ok``. Bad = ``failure`` + ``timeout`` + ``stalled`` (client
  cancels and retriable evictions are excluded). Source:
  ``marian_serving_request_outcomes_total``.
- ``--slo-p99-ms 250`` — 99% of requests must resolve under the
  threshold. Good = requests in latency-histogram buckets at or below
  the largest bucket edge <= the threshold (conservative). Source:
  ``marian_serving_request_latency_seconds``.

Evaluation: a sampler (a daemon thread every ``--slo-eval-interval``;
tests call :meth:`SloEngine.tick` with their own clock) snapshots the
cumulative (good, total) of each objective and computes, per window,

    burn = (bad fraction over the window) / (1 - target)

Alerts: **fast-burn** when the burn over the short window
(``--slo-window``, default 60 s) reaches 14.4 — a rising edge records an
``slo.fast_burn`` timeline event and fires the flight recorder
(``slo-fast-burn``); **slow-burn** when the burn over 10x the window
reaches 6 (an event only). Falling edges record ``slo.recovered``.
Everything is exported on /metrics (``marian_slo_*``) and at
``GET /sloz`` (JSON, with the perf plane's state), and the server
registers the engine as a flight-dump snapshot provider.

The engine touches nothing on the batch path: it reads counters the
scheduler already keeps, on its own thread. With no ``--slo-*`` flag it
is never constructed. :meth:`SloEngine.fast_burn` is the newest tick's
largest fast-window burn, the brownout ladder's signal. Fleet mode
builds one engine a tenant over the fleet's tenant-labeled series
(``outcomes_metric``, ``latency_metric``, ``label_filter``,
``latency_labels``, ``objective_prefix``; the defaults are the
single-model engine).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..common import lockdep
from ..common import logging as log
from .flight import FLIGHT
from .perf import PERF
from .trace import TRACER

OUTCOMES_METRIC = "marian_serving_request_outcomes_total"
LATENCY_METRIC = "marian_serving_request_latency_seconds"
BAD_OUTCOMES = ("failure", "timeout", "stalled")

DEFAULT_WINDOW_S = 60.0
SLOW_WINDOW_MULT = 10
DEFAULT_FAST_FACTOR = 14.4
DEFAULT_SLOW_FACTOR = 6.0
DEFAULT_EVAL_INTERVAL_S = 2.0


class _Objective:
    __slots__ = ("name", "target", "description", "source")

    def __init__(self, name: str, target: float, description: str,
                 source: Callable[[], Tuple[float, float]]):
        self.name = name
        self.target = float(target)
        self.description = description
        self.source = source        # () -> cumulative (good, total)

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


class SloEngine:
    def __init__(self, registry=None,
                 availability: Optional[float] = None,
                 p99_ms: Optional[float] = None,
                 window_s: float = DEFAULT_WINDOW_S,
                 fast_factor: float = DEFAULT_FAST_FACTOR,
                 slow_factor: float = DEFAULT_SLOW_FACTOR,
                 eval_interval: float = DEFAULT_EVAL_INTERVAL_S,
                 clock: Callable[[], float] = time.monotonic,
                 outcomes_metric: str = OUTCOMES_METRIC,
                 latency_metric: str = LATENCY_METRIC,
                 label_filter: Optional[Tuple[int, str]] = None,
                 latency_labels: Tuple[str, ...] = (),
                 objective_prefix: str = ""):
        from ..serving import metrics as msm    # lazy: no import cycle
        self.registry = registry if registry is not None else msm.REGISTRY
        self.window_s = float(window_s)
        self.slow_window_s = self.window_s * SLOW_WINDOW_MULT
        self.fast_factor = float(fast_factor)
        self.slow_factor = float(slow_factor)
        self.eval_interval = max(0.05, float(eval_interval))
        self.clock = clock
        # fleet mode: a tenant's engine reads the fleet's tenant-labeled
        # series — outcomes_metric / latency_metric re-point the sources,
        # label_filter (label index, value) keeps one tenant's outcome
        # children, latency_labels selects its latency child, and
        # objective_prefix ("A:") keeps the shared marian_slo_* objective
        # labels apart. The defaults are the single-model engine.
        self.outcomes_metric = outcomes_metric
        self.latency_metric = latency_metric
        self.label_filter = label_filter
        self.latency_labels = tuple(latency_labels)
        self.objective_prefix = objective_prefix
        self.objectives: List[_Objective] = []
        if availability:
            self.objectives.append(_Objective(
                objective_prefix + "availability", float(availability),
                f"{float(availability):.6g} of resolved requests ok "
                f"(bad = {'|'.join(BAD_OUTCOMES)})",
                self._availability_source))
        if p99_ms:
            self.p99_target_s = float(p99_ms) / 1e3
            self.objectives.append(_Objective(
                objective_prefix + "latency_p99", 0.99,
                f"99% of requests under {float(p99_ms):g} ms",
                self._latency_source))
        if not self.objectives:
            raise ValueError("SloEngine needs at least one objective "
                             "(--slo-availability / --slo-p99-ms)")
        self._lock = lockdep.make_lock("SloEngine._lock")
        # (ts, {objective: (good, total)}) samples, oldest left, pruned
        # past the slow window (+ one interval of slack)
        self._samples: Deque[Tuple[float, Dict[str, Tuple[float, float]]]] \
            = collections.deque()               # guarded-by: _lock
        self._t0: Optional[float] = None        # guarded-by: _lock
        self._base: Dict[str, Tuple[float, float]] = {}  # guarded-by: _lock
        self._alerting: Dict[Tuple[str, str], bool] = {}  # guarded-by: _lock
        # the newest tick's largest fast-window burn over the objectives
        self._last_fast_burn = 0.0              # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        r = self.registry
        self.m_target = r.gauge(
            "marian_slo_objective_target",
            "Declared objective target (fraction of good requests)",
            labels=("objective",))
        self.m_burn = r.gauge(
            "marian_slo_burn_rate",
            "Error-budget burn rate over the window (1.0 = consuming "
            "budget exactly at the sustainable rate)",
            labels=("objective", "window"))
        self.m_budget = r.gauge(
            "marian_slo_budget_remaining_ratio",
            "Fraction of the error budget remaining since the engine "
            "started (clamped at 0 — the raw value is on /sloz)",
            labels=("objective",))
        self.m_alerts = r.counter(
            "marian_slo_alerts_total",
            "Burn-rate threshold crossings (rising edges)",
            labels=("objective", "severity"))
        for o in self.objectives:
            self.m_target.labels(o.name).set(o.target)

    # -- SLI sources --------------------------------------------------------
    def _availability_source(self) -> Tuple[float, float]:
        m = self.registry.get(self.outcomes_metric)
        if m is None:
            return 0.0, 0.0
        good = bad = 0.0
        for key, child in m.children().items():
            if self.label_filter is not None:
                idx, want = self.label_filter
                if len(key) <= idx or key[idx] != want:
                    continue
            outcome = key[0] if key else ""
            if outcome == "ok":
                good += child.value
            elif outcome in BAD_OUTCOMES:
                bad += child.value
        return good, good + bad

    def _latency_source(self) -> Tuple[float, float]:
        h = self.registry.get(self.latency_metric)
        if h is None:
            return 0.0, 0.0
        if self.latency_labels:
            # the tenant's child (made on first read: a tenant that has
            # not served yet reads (0, 0))
            h = h.labels(*self.latency_labels)
        buckets, counts, total, _sum = h.snapshot()
        good = 0.0
        for edge, c in zip(buckets, counts):
            if edge <= self.p99_target_s:
                good += c
            else:
                break
        return good, float(total)

    # -- evaluation ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict:
        """Take one sample and evaluate every (objective, window) burn
        rate; returns the state dict. Called by the evaluator thread —
        and directly by tests, with a fake clock."""
        if now is None:
            now = self.clock()
        cum = {o.name: o.source() for o in self.objectives}
        events: List[Tuple[str, Dict]] = []
        trip: Optional[Dict] = None
        with self._lock:
            if self._t0 is None:
                self._t0 = now
                self._base = dict(cum)
            self._samples.append((now, cum))
            horizon = self.slow_window_s + self.eval_interval
            while self._samples and now - self._samples[0][0] > horizon:
                self._samples.popleft()
            state = self._evaluate(now, cum)
            self._last_fast_burn = max(
                (st["burn"][self._wl(False)]
                 for st in state["objectives"].values()), default=0.0)
            # rising/falling edges, recorded under the lock so two racing
            # ticks cannot double-fire; the events/dump emit OUTSIDE it
            for o in self.objectives:
                st = state["objectives"][o.name]
                for severity, alerting in (("fast", st["fast_burn"]),
                                           ("slow", st["slow_burn"])):
                    key = (o.name, severity)
                    was = self._alerting.get(key, False)
                    self._alerting[key] = alerting
                    if alerting and not was:
                        events.append((f"slo.{severity}_burn", {
                            "objective": o.name,
                            "burn_short": st["burn"][self._wl(False)],
                            "burn_long": st["burn"][self._wl(True)],
                            "target": o.target}))
                        if severity == "fast" and trip is None:
                            trip = {"objective": o.name, "state": state}
                    elif was and not alerting:
                        events.append(("slo.recovered", {
                            "objective": o.name, "severity": severity}))
        for o in self.objectives:
            st = state["objectives"][o.name]
            for wl, burn in st["burn"].items():
                self.m_burn.labels(o.name, wl).set(burn)
            self.m_budget.labels(o.name).set(
                max(0.0, st["budget_remaining"]))
        for name, attrs in events:
            if name.endswith("_burn"):
                sev = "fast" if name == "slo.fast_burn" else "slow"
                self.m_alerts.labels(attrs["objective"], sev).inc()
            TRACER.event(name, **attrs)
            log.warn("SLO: {} {}", name, attrs)
        if trip is not None:
            # fast burn = incident NOW: snapshot the span ring while the
            # promise-breaking requests are still in it (async — this
            # may be the evaluator thread, but dumps are IO)
            FLIGHT.trip_async(
                "slo-fast-burn",
                detail=f"fast-burn on objective "
                       f"{trip['objective']} (burn >= "
                       f"{self.fast_factor:g} over {self.window_s:g}s)",
                extra={"slo": trip["state"]})
        return state

    def _wl(self, slow: bool) -> str:
        return f"{self.slow_window_s:g}s" if slow else f"{self.window_s:g}s"

    def _window_delta(self, now: float, window: float, name: str,
                      cum: Tuple[float, float]) -> Tuple[float, float]:
        """(good, total) accumulated over the trailing window — delta
        against the newest sample at least ``window`` old (or the
        engine-start base when history is shorter). Caller holds the
        lock."""
        ref: Tuple[float, float] = self._base.get(name, (0.0, 0.0))
        for ts, sample in self._samples:
            if now - ts >= window:
                ref = sample.get(name, ref)
            else:
                break
        return cum[0] - ref[0], cum[1] - ref[1]

    def _evaluate(self, now: float, cum: Dict) -> Dict:
        objectives: Dict[str, Dict] = {}
        for o in self.objectives:
            burns: Dict[str, float] = {}
            for slow in (False, True):
                w = self.slow_window_s if slow else self.window_s
                good, total = self._window_delta(now, w, o.name,
                                                 cum[o.name])
                bad_frac = (total - good) / total if total > 0 else 0.0
                burns[self._wl(slow)] = bad_frac / o.budget
            tot_good, tot_total = cum[o.name]
            base = self._base.get(o.name, (0.0, 0.0))
            g, t = tot_good - base[0], tot_total - base[1]
            overall_bad = (t - g) / t if t > 0 else 0.0
            remaining = 1.0 - overall_bad / o.budget
            objectives[o.name] = {
                "target": o.target,
                "description": o.description,
                "burn": burns,
                "budget_remaining": round(remaining, 6),
                "good": g, "total": t,
                "fast_burn": burns[self._wl(False)] >= self.fast_factor,
                "slow_burn": burns[self._wl(True)] >= self.slow_factor,
            }
        return {
            "enabled": True,
            "window_s": self.window_s,
            "slow_window_s": self.slow_window_s,
            "fast_factor": self.fast_factor,
            "slow_factor": self.slow_factor,
            "uptime_s": round(now - (self._t0 or now), 3),
            "objectives": objectives,
        }

    # -- public state (flight dumps, /sloz) ---------------------------------
    def state(self) -> Dict:
        now = self.clock()
        cum = {o.name: o.source() for o in self.objectives}
        with self._lock:
            if self._t0 is None:
                # never ticked: evaluate against an empty history
                self._t0 = now
                self._base = dict(cum)
            st = self._evaluate(now, cum)
        st["alerting"] = {f"{o}:{s}": v
                          for (o, s), v in sorted(self._alerting.items())}
        return st

    def fast_burn(self) -> float:
        """The largest fast-window burn rate over the objectives as of
        the last tick: the brownout ladder's overload signal (any
        thread)."""
        with self._lock:
            return self._last_fast_burn

    # -- evaluator thread ---------------------------------------------------
    def start(self) -> "SloEngine":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="slo-eval")
            self._thread.start()
            log.info("SLO engine: {} objective(s), windows {:g}s/{:g}s, "
                     "eval every {:g}s — GET /sloz",
                     len(self.objectives), self.window_s,
                     self.slow_window_s, self.eval_interval)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.eval_interval):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the evaluator must
                log.warn("SLO engine tick failed: {}", e)   # never die

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


def maybe_build_engine(options, registry=None) -> Optional[SloEngine]:
    """Construct the engine iff an objective flag is set (`--slo-availability`
    / `--slo-p99-ms`); disabled mode costs nothing — not even an object."""
    avail = float(options.get("slo-availability", 0) or 0)
    p99 = float(options.get("slo-p99-ms", 0) or 0)
    if avail <= 0 and p99 <= 0:
        return None
    return SloEngine(
        registry=registry,
        availability=avail or None,
        p99_ms=p99 or None,
        window_s=float(options.get("slo-window", 0) or 0)
        or DEFAULT_WINDOW_S,
        eval_interval=float(options.get("slo-eval-interval", 0) or 0)
        or DEFAULT_EVAL_INTERVAL_S)


def slo_routes(engine_fn: Callable[[], Optional[SloEngine]],
               brownout_fn: Optional[Callable[[], object]] = None) -> Dict:
    """``GET /sloz`` for serving/metrics.py's MetricsServer: the SLO
    state, the perf plane's snapshot and, when the ladder is armed, the
    brownout level (an on-call reading /sloz during an incident sees
    which rung they are on). Like /tracez, the route always answers — a
    disabled engine or ladder reports ``enabled: false`` rather than
    404."""

    def _sloz(method: str, query: str):
        engine = engine_fn()
        brownout = brownout_fn() if brownout_fn is not None else None
        body = {
            "slo": engine.state() if engine is not None
            else {"enabled": False},
            "perf": PERF.state(),
            "brownout": brownout.state() if brownout is not None
            else {"enabled": False},
        }
        return (200, json.dumps(body, indent=1).encode() + b"\n",
                "application/json")

    return {"/sloz": _sloz}
