"""FleetManager — N model families in one serving process, ported from
``marian_tpu/serving/fleet/tenancy.py``.

The single-model lifecycle (serving/lifecycle/) tracks versions of one
model. A fleet serves many language pairs and domains a process; this
module scales the SAME building blocks out to N tenants:

- **Per-tenant lifecycle stacks.** Each tenant owns its own
  ``SwapController`` (and ``ModelRegistry``) and, under
  ``--fleet-watch``, a ``BundleWatcher`` over ``<model>.bundles/``:
  canary, auto-rollback, pin and manual rollback work per tenant,
  unchanged.
- **Shared memory budget.** A warmed executor holds a whole model on
  the card; under ``--fleet-hbm-budget-mb`` the fleet evicts the
  COLDEST idle tenant (LRU by last-routed batch; a tenant with batches
  in flight is never a victim) to make room for the one being warmed.
  Residency is estimated from the bundle manifest's member bytes times
  ``HBM_OVERHEAD``: a documented proxy, not a device query, so the
  budget works the same on the CPU. An eviction drops every reference
  the controller holds (live, canary and rollback slots), so the card's
  allocated bytes fall with it.
- **Warm-on-demand.** A request for a cold tenant warms it on the device
  worker thread (the requester pays the cold start); the newest valid
  bundle wins, and a tenant with no bundles warms from its flat model.
  The port compiles nothing per shape, so a cold start is a load and a
  golden decode (the reference's compile-cache member has no
  counterpart).
- **Per-tenant SLOs and admission.** One ``SloEngine`` a tenant over the
  fleet's tenant-labeled outcome and latency series (obs/slo.py's label
  filters), ticked by one fleet thread. A tenant in fast burn sheds its
  OWN low-priority traffic (:meth:`FleetManager.gate`): tenant A's
  incident never browns out tenant B.
- **Per-tenant KV-page accounting.** With a shared paged pool attached,
  claims group by tenant through the refcount plane's ``claims()``
  (fleet/accounting.py); an eviction releases ONLY the victim's
  references.

Requests pick their tenant with the ``#model:<tag>`` protocol header
(server/server.py); the scheduler forms single-tenant batches and
resolves the executor through :meth:`FleetManager.executor_for` a batch,
so a hot swap inside one tenant stays atomic at batch granularity.

The fleet's lock is ``FleetManager._lock`` (``lockdep.make_lock``); a
tenant's ``warm_lock`` stays a plain ``threading.Lock``, as the
reference's does.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ... import obs
from ...common import lockdep
from ...common import logging as log
from ...obs import slo as mslo
from ...training import bundle as bdl
from .. import metrics as msm
from ..admission import Overloaded
from ..lifecycle.controller import SwapController
from ..lifecycle.warmup import DEFAULT_GOLDEN, warm_executor
from ..lifecycle.watcher import BundleWatcher
from . import accounting

# Residency estimate = bundle member bytes x this factor: parameters
# dominate a warmed executor's memory, and the factor covers the rest
# riding along (the reference's jit executables, activation scratch).
# Deliberately a module constant, not a flag — operators size the
# BUDGET, not the estimator.
HBM_OVERHEAD = 2.0

# fleet tenant-labeled serving series (per-tenant SLO engines read these)
FLEET_OUTCOMES_METRIC = "marian_fleet_request_outcomes_total"
FLEET_LATENCY_METRIC = "marian_fleet_request_latency_seconds"

# tenant tags share the #trace id alphabet minus nothing extra — dots
# allowed for domain-style tags ("en-de.legal")
_TAG_CHARS = set("abcdefghijklmnopqrstuvwxyz"
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


class UnknownTenant(RuntimeError):
    """The #model: tag names no configured tenant — an explicit client
    error (!!SERVER-ERROR), never a silent default-model reply."""


def valid_tag(tag: str) -> bool:
    return bool(tag) and len(tag) <= 64 and all(c in _TAG_CHARS
                                                for c in tag)


class TenantSpec:
    __slots__ = ("tag", "model_path")

    def __init__(self, tag: str, model_path: str):
        self.tag = tag
        self.model_path = model_path


def parse_fleet_spec(spec: str) -> List[TenantSpec]:
    """``--fleet A=/models/a.npz,B=/models/b.npz`` → tenant specs.
    Malformed entries are hard errors — a fleet boot must never
    silently drop a tenant."""
    out: List[TenantSpec] = []
    seen = set()
    for entry in (e.strip() for e in spec.split(",") if e.strip()):
        tag, sep, path = entry.partition("=")
        tag = tag.strip()
        if not sep or not path.strip() or not valid_tag(tag):
            raise ValueError(
                f"--fleet entry {entry!r}: expected <tag>=<model-path> "
                f"with tag in [A-Za-z0-9_.-]{{1,64}}")
        if tag in seen:
            raise ValueError(f"--fleet: duplicate tenant tag {tag!r}")
        seen.add(tag)
        out.append(TenantSpec(tag, path.strip()))
    if not out:
        raise ValueError("--fleet: no tenants configured")
    return out


class _Tenant:
    """One tenant's slot in the fleet: spec + (when resident) its
    lifecycle stack. Residency fields are guarded by the FLEET lock;
    ``warm_lock`` serializes concurrent cold starts of the same tenant
    without holding up the fleet."""

    __slots__ = ("spec", "controller", "watcher", "resident_bytes",
                 "last_used", "inflight", "cold_starts", "warm_lock",
                 "last_cold_start_s")

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        # the residency fields below are guarded by the owning
        # FleetManager's _lock
        self.controller: Optional[SwapController] = None
        self.watcher: Optional[BundleWatcher] = None
        self.resident_bytes = 0
        self.last_used = 0.0
        self.inflight = 0
        self.cold_starts = 0
        self.last_cold_start_s = 0.0
        self.warm_lock = threading.Lock()


class FleetManager:
    def __init__(self, specs: List[TenantSpec],
                 executor_factory: Callable,
                 metrics_registry: Optional[msm.Registry] = None,
                 hbm_budget_bytes: int = 0,
                 watch_interval: float = 0.0,
                 golden: Optional[List[str]] = None,
                 canary_fraction: float = 0.0,
                 rollback_error_rate: float = 0.5,
                 rollback_p99_factor: float = 0.0,
                 canary_min_batches: int = 8,
                 brownout_min_priority: int = 1,
                 kv_pool=None,
                 clock: Callable[[], float] = time.monotonic):
        self.executor_factory = executor_factory
        self.registry = metrics_registry if metrics_registry is not None \
            else msm.REGISTRY
        self.hbm_budget_bytes = max(0, int(hbm_budget_bytes))
        self.watch_interval = float(watch_interval)
        self.golden = list(golden) if golden else list(DEFAULT_GOLDEN)
        self.canary_fraction = float(canary_fraction)
        self.rollback_error_rate = float(rollback_error_rate)
        self.rollback_p99_factor = float(rollback_p99_factor)
        self.canary_min_batches = int(canary_min_batches)
        self.brownout_min_priority = int(brownout_min_priority)
        # optional shared paged KV pool: eviction releases the victim
        # tenant's claims through the per-tenant grouping, nothing else
        self.kv_pool = kv_pool
        self.clock = clock
        self._lock = lockdep.make_lock("FleetManager._lock")
        self._tenants: Dict[str, _Tenant] = {
            s.tag: _Tenant(s) for s in specs}
        self._slos: Dict[str, mslo.SloEngine] = {}
        self._slo_thread: Optional[threading.Thread] = None
        self._slo_stop = threading.Event()
        self._slo_interval = mslo.DEFAULT_EVAL_INTERVAL_S

        r = self.registry
        self.m_tenants = r.gauge(
            "marian_fleet_tenants", "Configured tenants in this process")
        self.m_resident = r.gauge(
            "marian_fleet_resident",
            "1 while the tenant's executors are warm in HBM, 0 when cold",
            labels=("tenant",))
        self.m_hbm_budget = r.gauge(
            "marian_fleet_hbm_budget_bytes",
            "Shared executor HBM budget (--fleet-hbm-budget-mb; 0 = "
            "unbudgeted)")
        self.m_hbm_resident = r.gauge(
            "marian_fleet_hbm_resident_bytes",
            "Estimated bytes pinned by resident tenants' executors "
            "(manifest member bytes x overhead factor)")
        self.m_outcomes = r.counter(
            FLEET_OUTCOMES_METRIC,
            "Resolved fleet requests by outcome and tenant (per-tenant "
            "SLO engines read this)",
            labels=("outcome", "tenant"))
        self.m_latency = r.histogram(
            FLEET_LATENCY_METRIC,
            "End-to-end request latency by tenant",
            labels=("tenant",))
        self.m_shed = r.counter(
            "marian_fleet_shed_total",
            "Requests shed at the fleet layer, by tenant and reason "
            "(tenant_brownout = that tenant's own SLO fast-burn; "
            "unknown_tenant = unconfigured #model: tag)",
            labels=("tenant", "reason"))
        self.m_evictions = r.counter(
            "marian_fleet_evictions_total",
            "Tenant executor evictions (hbm_pressure = coldest idle "
            "tenant displaced under the shared budget)",
            labels=("reason",))
        self.m_cold_starts = r.counter(
            "marian_fleet_cold_starts_total",
            "Warm-on-demand cold starts, by tenant",
            labels=("tenant",))
        self.m_cold_start_s = r.gauge(
            "marian_fleet_cold_start_seconds",
            "Wall seconds of the tenant's most recent cold start",
            labels=("tenant",))
        self.m_tenants.set(len(self._tenants))
        self.m_hbm_budget.set(self.hbm_budget_bytes)
        for tag in self._tenants:
            self.m_resident.labels(tag).set(0)

    # -- tenant lookup / routing (device worker thread) ---------------------
    def tags(self) -> List[str]:
        return sorted(self._tenants)

    def has_tenant(self, tag: str) -> bool:
        return tag in self._tenants

    def executor_for(self, tag: str) -> Callable[[List[str]], List[str]]:
        """The scheduler's tenant router: resolve (warming on demand)
        the tenant's live route for THIS batch. Runs on the device
        worker thread, so a cold start blocks only the batch that
        needs it. The returned callable carries in-flight accounting —
        a tenant mid-batch is never an eviction victim."""
        t = self._tenants.get(tag)
        if t is None:
            raise UnknownTenant(f"unknown model tag '{tag}'")
        self._ensure_live(t)
        now = self.clock()
        with self._lock:
            t.last_used = now
            t.inflight += 1
            controller = t.controller
        if controller is None:           # evicted between ensure and here
            with self._lock:
                t.inflight -= 1
            raise RuntimeError(f"tenant '{tag}' lost residency mid-route")

        def run(lines: List[str]) -> List[str]:
            try:
                return controller.route(lines)
            finally:
                with self._lock:
                    t.inflight -= 1
                    t.last_used = self.clock()
        return run

    def live_version_name(self, tag: str) -> str:
        """Per-tenant model_version label for the scheduler's outcome
        metrics: ``<tag>:<bundle name>`` (``<tag>:cold`` while not
        resident)."""
        t = self._tenants.get(tag)
        if t is None:
            return f"{tag}:unknown"
        with self._lock:
            c = t.controller
        return f"{tag}:{c.live_version_name() if c is not None else 'cold'}"

    # -- warm-on-demand + HBM budget ----------------------------------------
    def _ensure_live(self, t: _Tenant) -> None:
        with self._lock:
            live = t.controller is not None and t.controller.has_live()
        if live:
            return
        with t.warm_lock:
            with self._lock:
                if t.controller is not None and t.controller.has_live():
                    return
            self._warm(t)

    def _warm(self, t: _Tenant) -> None:
        """Cold start one tenant (caller holds its warm_lock): newest
        valid bundle if any, else the flat model path; budget is made
        first, the wall time is the cold-start ledger entry."""
        tag = t.spec.tag
        root = bdl.bundle_root(t.spec.model_path)
        found = bdl.latest_valid_bundle(t.spec.model_path)
        bundle_dir, manifest = found if found else (None, None)
        est = self._estimate_bytes(bundle_dir, manifest, t.spec.model_path)
        self._make_room(est, exclude=tag)
        t0 = time.perf_counter()
        controller = SwapController(
            executor_factory=self.executor_factory,
            metrics_registry=self.registry,
            canary_fraction=self.canary_fraction,
            rollback_error_rate=self.rollback_error_rate,
            rollback_p99_factor=self.rollback_p99_factor,
            canary_min_batches=self.canary_min_batches,
            golden=self.golden)
        if bundle_dir is not None:
            v = controller.ingest(bundle_dir, manifest)
            if v is None or not controller.has_live():
                raise RuntimeError(
                    f"fleet: tenant '{tag}' cold start failed — bundle "
                    f"{bundle_dir} did not reach live "
                    f"({getattr(v, 'error', 'not ingested')})")
        else:
            # warm_lock makes a second requester of the SAME tenant wait
            # out this warmup; the fleet lock is not held here
            executor = warm_executor(
                t.spec.model_path, None, self.executor_factory,
                self.golden)
            controller.seed_live(0, f"{tag}:boot", executor,
                                 bundle_dir=t.spec.model_path)
        dt = time.perf_counter() - t0
        watcher = None
        if self.watch_interval > 0:
            watcher = BundleWatcher(
                root, controller.ingest, interval=self.watch_interval,
                last_seq=controller.live_version().seq
                if bundle_dir is not None else 0)
            watcher.start()
        with self._lock:
            t.controller = controller
            t.watcher = watcher
            t.resident_bytes = est
            t.last_used = self.clock()
            t.cold_starts += 1
            t.last_cold_start_s = dt
        self.m_resident.labels(tag).set(1)
        self.m_cold_starts.labels(tag).inc()
        self.m_cold_start_s.labels(tag).set(dt)
        self._update_hbm_gauge()
        obs.event("fleet.cold_start", tenant=tag,
                  bundle=os.path.basename(bundle_dir or
                                          t.spec.model_path),
                  seconds=round(dt, 3), est_bytes=est)
        log.info("fleet: tenant '{}' warm in {:.2f}s ({}; ~{} MB "
                 "resident)", tag, dt,
                 os.path.basename(bundle_dir or t.spec.model_path),
                 est // (1 << 20))

    @staticmethod
    def _estimate_bytes(bundle_dir: Optional[str], manifest: Optional[Dict],
                        model_path: str) -> int:
        """Manifest member bytes (or the flat file's size) x
        HBM_OVERHEAD — the documented residency proxy."""
        total = 0
        for info in ((manifest or {}).get("members", {}) or {}).values():
            total += int(info.get("bytes", 0) or 0)
        if total == 0:
            try:
                total = os.path.getsize(model_path)
            except OSError:
                total = 0
        return int(total * HBM_OVERHEAD)

    def _make_room(self, need: int, exclude: str) -> None:
        """Evict coldest idle tenants until ``need`` fits the budget.
        Victims: resident, zero in-flight batches, not the requester —
        picked by oldest last-routed time. When only busy tenants
        remain the fleet runs over budget LOUDLY rather than deadlock
        the cold start."""
        if self.hbm_budget_bytes <= 0:
            return
        while True:
            with self._lock:
                resident = sum(t.resident_bytes
                               for t in self._tenants.values()
                               if t.controller is not None)
                if resident + need <= self.hbm_budget_bytes:
                    return
                victims = [t for t in self._tenants.values()
                           if t.controller is not None and t.inflight == 0
                           and t.spec.tag != exclude]
                victim = min(victims, key=lambda t: t.last_used,
                             default=None)
            if victim is None:
                log.warn("fleet: HBM budget exceeded ({} + {} needed > "
                         "{}) but every resident tenant is busy — "
                         "running over budget", resident, need,
                         self.hbm_budget_bytes)
                return
            self.evict(victim.spec.tag, reason="hbm_pressure")

    def evict(self, tag: str, reason: str = "admin") -> bool:
        """Drop one tenant's executors (LRU victim, admin verb, or
        shutdown): every executor its controller holds is released, so
        the tenant's models leave the card. Releases ONLY that tenant's
        KV-page claims when a shared pool is attached — the per-tenant
        grouping of ``claims()`` is what makes this safe for every
        other tenant's live rows."""
        t = self._tenants.get(tag)
        if t is None:
            return False
        with self._lock:
            controller, watcher = t.controller, t.watcher
            if controller is None:
                return False
            freed = t.resident_bytes
            t.controller = None
            t.watcher = None
            t.resident_bytes = 0
        if watcher is not None:
            watcher.stop()
        controller.release_all()
        released = self._release_tenant_pages(tag)
        self.m_resident.labels(tag).set(0)
        self.m_evictions.labels(reason).inc()
        self._update_hbm_gauge()
        obs.event("fleet.evict", tenant=tag, reason=reason,
                  freed_bytes=freed, pages_released=released)
        log.info("fleet: evicted tenant '{}' ({}; ~{} MB freed, {} page "
                 "claim(s) released)", tag, reason, freed // (1 << 20),
                 released)
        return True

    def _release_tenant_pages(self, tag: str) -> int:
        """Release every pool claim owned by ``tag`` (per-tenant
        grouping over the refcount plane's one-lock snapshot); other
        tenants' claims are never touched."""
        pool = self.kv_pool
        if pool is None:
            return 0
        released = 0
        for owner, pages in pool.claims().items():
            if accounting.tenant_of_owner(owner) == tag:
                released += pool.release(owner)
        return released

    def _update_hbm_gauge(self) -> None:
        with self._lock:
            resident = sum(t.resident_bytes
                           for t in self._tenants.values())
        self.m_hbm_resident.set(resident)

    # -- per-tenant outcomes / SLO / admission ------------------------------
    def note_outcome(self, tag: str, outcome: str,
                     latency_s: float) -> None:
        """Server hook, once per resolved request: the tenant-labeled
        series the per-tenant SLO engines burn against."""
        self.m_outcomes.labels(outcome, tag).inc()
        self.m_latency.labels(tag).observe(latency_s)

    def note_shed(self, tag: str, reason: str) -> None:
        self.m_shed.labels(tag, reason).inc()

    def gate(self, tag: str, priority: int) -> None:
        """Per-tenant admission: while THIS tenant's SLO fast-burn is
        alerting, shed its below-threshold priority lanes — tenant A's
        burn never sheds tenant B's traffic. Raises the same retriable
        Overloaded the global admission controller uses."""
        engine = self._slos.get(tag)
        if engine is None:
            return
        if engine.fast_burn() >= engine.fast_factor \
                and priority < self.brownout_min_priority:
            self.note_shed(tag, "tenant_brownout")
            obs.event("fleet.shed", tenant=tag, reason="tenant_brownout",
                      priority=priority)
            raise Overloaded(
                f"tenant '{tag}' is burning its error budget "
                f"(fast-burn >= {engine.fast_factor:g}); priority "
                f"{priority} < {self.brownout_min_priority} shed — "
                f"retry later")

    def build_slos(self, availability: float = 0.0, p99_ms: float = 0.0,
                   window_s: float = mslo.DEFAULT_WINDOW_S,
                   eval_interval: float = mslo.DEFAULT_EVAL_INTERVAL_S
                   ) -> int:
        """One SloEngine per tenant over the fleet's tenant-labeled
        series (objective label values prefixed ``<tag>:`` so the
        shared marian_slo_* gauges stay distinguishable). Returns the
        engine count; 0 objectives = no engines, no thread."""
        if availability <= 0 and p99_ms <= 0:
            return 0
        self._slo_interval = max(0.05, float(eval_interval))
        for tag in self._tenants:
            self._slos[tag] = mslo.SloEngine(
                registry=self.registry,
                availability=availability or None,
                p99_ms=p99_ms or None,
                window_s=window_s,
                eval_interval=eval_interval,
                clock=self.clock,
                outcomes_metric=FLEET_OUTCOMES_METRIC,
                latency_metric=FLEET_LATENCY_METRIC,
                label_filter=(1, tag),
                latency_labels=(tag,),
                objective_prefix=f"{tag}:")
        return len(self._slos)

    def slo_engine(self, tag: str) -> Optional[mslo.SloEngine]:
        return self._slos.get(tag)

    def tick_slos(self, now: Optional[float] = None) -> None:
        """One evaluation pass over every tenant engine (the fleet SLO
        thread's body; tests call it directly with a fake clock)."""
        for engine in self._slos.values():
            engine.tick(now)

    # -- lifecycle ----------------------------------------------------------
    def start(self, warm_all: bool = True) -> "FleetManager":
        """Boot the fleet: optionally pre-warm every tenant in spec
        order (budget evictions apply — with a tight budget the
        earliest-warmed tenants are the LRU victims), start the SLO
        evaluator when engines exist."""
        if warm_all:
            for tag in self.tags():
                try:
                    self._ensure_live(self._tenants[tag])
                except Exception as e:  # noqa: BLE001 — a tenant that
                    # cannot warm at boot stays cold (warm-on-demand
                    # retries on first request); the fleet still serves
                    # the others
                    log.error("fleet: tenant '{}' failed boot warm ({}); "
                              "staying cold until first request", tag, e)
        if self._slos and self._slo_thread is None:
            self._slo_stop.clear()
            self._slo_thread = threading.Thread(
                target=self._slo_run, daemon=True, name="fleet-slo")
            self._slo_thread.start()
        return self

    def _slo_run(self) -> None:
        while not self._slo_stop.wait(self._slo_interval):
            try:
                self.tick_slos()
            except Exception as e:  # noqa: BLE001 — evaluator never dies
                log.warn("fleet SLO tick failed: {}", e)

    def stop(self) -> None:
        self._slo_stop.set()
        th, self._slo_thread = self._slo_thread, None
        if th is not None:
            th.join(timeout=2.0)
        for tag in self.tags():
            t = self._tenants[tag]
            with self._lock:
                watcher = t.watcher
                t.watcher = None
            if watcher is not None:
                watcher.stop()

    # -- introspection (/fleetz) --------------------------------------------
    def tenant_pages(self) -> Dict[str, Dict[str, int]]:
        if self.kv_pool is None:
            return {}
        return accounting.tenant_page_sums(self.kv_pool.claims())

    def status(self) -> Dict:
        now = self.clock()
        pages = self.tenant_pages()
        rows = []
        with self._lock:
            resident_total = sum(t.resident_bytes
                                 for t in self._tenants.values())
            for tag in sorted(self._tenants):
                t = self._tenants[tag]
                c = t.controller
                rows.append({
                    "tenant": tag,
                    "model_path": t.spec.model_path,
                    "resident": c is not None,
                    "live": c.live_version_name() if c is not None
                    else None,
                    "est_bytes": t.resident_bytes,
                    "inflight_batches": t.inflight,
                    "idle_s": round(now - t.last_used, 3)
                    if t.last_used else None,
                    "cold_starts": t.cold_starts,
                    "last_cold_start_s": round(t.last_cold_start_s, 3),
                })
        for row in rows:
            tag = row["tenant"]
            engine = self._slos.get(tag)
            row["slo"] = ({"fast_burn": engine.fast_burn()}
                          if engine is not None else None)
            row["pages"] = pages.get(tag)
        return {
            "tenants": rows,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "hbm_resident_bytes": resident_total,
            "hbm_overhead_factor": HBM_OVERHEAD,
            "watch_interval_s": self.watch_interval,
        }
