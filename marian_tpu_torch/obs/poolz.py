"""``/poolz`` — the paged-serving live inspector, ported from
``marian_tpu/obs/poolz.py``.

The KV pool's gauges say HOW FULL it is; when a pool audit fails, a
quiesce drags or a brownout starts evicting, the operator needs WHAT IS
IN IT: which page belongs to
which row or cache entry, at what refcount, which slots decode at what
position, and what the last audit said. This module exposes the paged
engines' :meth:`pool_state` page map two ways:

- ``GET /poolz`` on the metrics port — always routed, like ``/tracez``
  and ``/sloz``: a request-mode server (or no engine at all) answers
  ``{"enabled": false, ...}`` instead of 404;
- a flight-recorder snapshot provider (``FLIGHT.add_snapshot_provider
  ("pool", ...)``, wired by the server in iteration mode), so every
  flight dump embeds the page map at incident time.

:func:`check_consistency` recomputes the auditor's page-accounting
invariants from the exported document, so a flight dump of a dead
process can still be checked. The document records the per-tenant page
sums (``tenants``, serving/fleet/accounting.py) re-derived from its own
owner labels, and the check re-derives them again and proves tenant
isolation from the document alone.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional


def snapshot(scheduler) -> Dict:
    """JSON-ready pool state resolved THROUGH the scheduler at call time
    (a hot swap or a watchdog rebuild re-points scheduler.engine; a
    snapshot bound to a dead engine would dump the wrong pool). Reports
    a disabled or request-mode server cleanly instead of raising."""
    if scheduler is None:
        return {"enabled": False, "reason": "no scheduler"}
    mode = getattr(scheduler, "batching_mode", "request")
    if mode != "iteration":
        return {"enabled": False, "reason": "not in iteration mode",
                "batching_mode": mode}
    engine = getattr(scheduler, "engine", None)
    state_fn = getattr(engine, "pool_state", None)
    if engine is None or state_fn is None:
        return {"enabled": False,
                "reason": "engine exposes no pool state",
                "batching_mode": mode}
    state = state_fn()
    state["scheduler"] = {
        "queued_units": scheduler.queued_units(),
        "queued_pages": scheduler.queued_pages(),
        "quiescing": scheduler._quiesce_depth(),
        "brownout_level": scheduler._brownout_level,
    }
    # per-tenant page sums, recorded IN the document so a checker can
    # re-derive them from the page map and compare: a divergence is how
    # a corrupted claims plane looks from outside (lazy import: obs
    # loads before serving)
    from ..serving.fleet import accounting as _facc
    state["tenants"] = _facc.tenant_sums_from_state(state)
    return state


def check_consistency(state: Dict) -> List[str]:
    """Re-derive the auditor's page-accounting invariants from an
    exported /poolz document; returns discrepancies (empty = the page
    map agrees with itself):

    - every page's refcount equals the number of owner references
      naming it;
    - free + live pages account for every allocatable page;
    - every occupied slot's held pages appear in the page map;
    - no slot decodes past its cap;
    - tenant isolation (serving/fleet/accounting.py): the recorded
      ``tenants`` block equals the page map's sums, no page's owners
      span two tenants, and every slot's pages are its tenant's.
    """
    if not state.get("enabled"):
        return []
    v: List[str] = []
    pool = state.get("pool", {})
    pages = state.get("pages", {})
    for page, ent in pages.items():
        if ent["refs"] != len(ent["owners"]):
            v.append(f"page {page}: refcount {ent['refs']} != "
                     f"{len(ent['owners'])} owner reference(s)")
    free = pool.get("free_pages", 0)
    usable = pool.get("usable_pages", 0)
    live = len(pages)
    if free + live != usable:
        v.append(f"page accounting: {free} free + {live} live != "
                 f"{usable} allocatable")
    for row in state.get("rows", {}).get("slots", []):
        for p in row["pages"]:
            if str(p) not in pages:
                v.append(f"slot {row['slot']} holds page {p} absent "
                         f"from the page map")
        if row["pos"] > row["cap"]:
            v.append(f"slot {row['slot']} position {row['pos']} past "
                     f"its cap {row['cap']}")
    from ..serving.fleet import accounting as _facc
    v.extend(_facc.check_tenant_isolation(state))
    return v


def pool_routes(scheduler_fn: Callable[[], Optional[object]]) -> Dict:
    """``GET /poolz`` for serving/metrics.py's MetricsServer; a
    request-mode server answers a clean ``enabled: false`` document.
    ``?check=1`` appends the self-consistency verdict."""

    def _poolz(method: str, query: str):
        state = snapshot(scheduler_fn())
        if "check=1" in (query or ""):
            state["consistency"] = check_consistency(state)
        body = json.dumps(state, indent=1, default=repr).encode() + b"\n"
        return 200, body, "application/json"

    return {"/poolz": _poolz}
