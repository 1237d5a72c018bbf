"""Per-tenant KV-page accounting over the refcount plane, ported from
``marian_tpu/serving/fleet/accounting.py``.

The paged KV pool proves REFERENCE-level consistency: every page's
refcount equals the number of claim-list references to it
(``KVPool.audit()``). Multi-tenant serving needs one invariant more:
every page reference belongs to exactly ONE tenant, and the per-tenant
sums match what the tenants were granted. A page charged to the wrong
tenant is refcount-consistent (moving a reference between two owners'
claim lists changes no refcount), so the pool auditor cannot see it.
This module is the tenant-level auditor on top:

- :func:`tenant_of_owner` — THE owner-to-tenant convention. Scheduler
  units carry ``.req.tenant`` (set at submit from the ``#model:``
  header); tuple owners (beam rows, prefix triples) resolve through
  their first element; string owners use a ``"<tenant>/<rest>"`` prefix.
  Untenanted owners (single-model serving, the shared prefix cache) map
  to ``""`` and are exempt from cross-tenant checks.
- :func:`tenant_page_sums` — group ``KVPool.claims()`` (the refcount
  plane's one-lock snapshot) into per-tenant reference and owner sums.
- :func:`audit_tenants` — compare those sums with an expected grant
  table: a reference moved between tenants shows as one tenant short
  exactly what another gained.
- :func:`cross_tenant_pages` — the invariant that needs no
  expectations: no page holds references from two different (non-empty)
  tenants. Sharing a page is legal WITHIN a tenant (beam copy-on-write,
  prefix followers), never across.
- :func:`tenant_sums_from_state` / :func:`check_tenant_isolation` — the
  same derivations over a ``/poolz`` DOCUMENT (owner labels, not live
  objects), so a dead process's flight dump can prove or disprove
  isolation (the ``?check=1`` handler in obs/poolz.py calls these).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

# Owner labels in /poolz documents carry the tenant as a "<tag>/" prefix
# (translator/iteration.py :: _owner_label). Tags are validated at the
# protocol layer to [A-Za-z0-9_.-], so the first "/" is unambiguous.
LABEL_SEP = "/"


def tenant_of_owner(owner) -> str:
    """The owner→tenant convention (see module docstring). Returns ""
    for untenanted owners — single-model serving and the shared prefix
    cache stay exempt from tenant checks."""
    t = getattr(owner, "tenant", None)
    if t:
        return str(t)
    req = getattr(owner, "req", None)
    if req is not None:
        t = getattr(req, "tenant", None)
        if t:
            return str(t)
    if isinstance(owner, tuple) and owner:
        return tenant_of_owner(owner[0])
    if isinstance(owner, str) and LABEL_SEP in owner:
        return owner.split(LABEL_SEP, 1)[0]
    return ""


def tenant_of_label(label: str) -> str:
    """Tenant tag of one /poolz owner LABEL (document form)."""
    if LABEL_SEP in label:
        return label.split(LABEL_SEP, 1)[0]
    return ""


def tenant_page_sums(claims: Dict) -> Dict[str, Dict[str, int]]:
    """Group a ``KVPool.claims()`` snapshot into per-tenant sums:
    ``{tenant: {"refs": page references, "owners": claim lists}}``.
    Each (owner, page) reference counts once — a page shared by two
    same-tenant owners contributes two references, matching how the
    refcount plane bills it."""
    sums: Dict[str, Dict[str, int]] = {}
    for owner, pages in claims.items():
        tenant = tenant_of_owner(owner)
        row = sums.setdefault(tenant, {"refs": 0, "owners": 0})
        row["owners"] += 1
        row["refs"] += len(pages)
    return sums


def cross_tenant_pages(claims: Dict) -> List[str]:
    """The intrinsic isolation invariant: violations for every page
    holding references from two different non-empty tenants. Needs no
    expectations — derivable from any claims snapshot."""
    page_tenants: Dict[int, set] = {}
    for owner, pages in claims.items():
        tenant = tenant_of_owner(owner)
        if not tenant:
            continue
        for p in pages:
            page_tenants.setdefault(int(p), set()).add(tenant)
    return [
        f"cross-tenant page: page {p} is referenced by tenants "
        f"{sorted(ts)} — refcount sharing is legal only within a tenant"
        for p, ts in sorted(page_tenants.items()) if len(ts) > 1
    ]


def audit_tenants(pool, expected: Dict[str, int]) -> List[str]:
    """Tenant-level audit of a live pool: per-tenant page-reference
    sums derived from ``pool.claims()`` must equal ``expected``
    (tenant → granted references), and no page may be cross-tenant.
    Returns violation strings ([] = clean). A leak that moves one
    reference between tenants keeps ``pool.audit()`` green; this is
    the auditor that catches it."""
    claims = pool.claims()
    violations = cross_tenant_pages(claims)
    sums = tenant_page_sums(claims)
    tenants = set(expected) | {t for t in sums if t}
    for t in sorted(tenants):
        want = int(expected.get(t, 0))
        got = sums.get(t, {}).get("refs", 0)
        if got != want:
            violations.append(
                f"tenant page accounting: tenant '{t}' holds {got} page "
                f"reference(s) but was granted {want} — "
                f"{'over' if got > want else 'under'} by "
                f"{abs(got - want)}")
    return violations


def tenant_sums_from_state(state: Dict) -> Dict[str, Dict[str, int]]:
    """Per-tenant sums re-derived from a /poolz DOCUMENT's page map
    (owner labels): ``{tenant: {"refs": n, "pages": n}}``. Runs on the
    dict, not the process, so flight dumps of a dead server remain
    checkable (the poolz discipline)."""
    sums: Dict[str, Dict[str, int]] = {}
    for _p, info in (state.get("pages", {}) or {}).items():
        for label in info.get("owners", []) or []:
            tenant = tenant_of_label(str(label))
            row = sums.setdefault(tenant, {"refs": 0, "pages": 0})
            row["refs"] += 1
        tenants_here = {tenant_of_label(str(l))
                        for l in info.get("owners", []) or []}
        for t in tenants_here:
            sums.setdefault(t, {"refs": 0, "pages": 0})["pages"] += 1
    return sums


def check_tenant_isolation(state: Dict) -> List[str]:
    """Document-level isolation checks for ``/poolz?check=1`` and dead
    flight dumps: (a) re-derive the per-tenant sums and compare them to
    the snapshot's recorded ``tenants`` block (a divergence means the
    dump is internally inconsistent — exactly what a corrupted claims
    plane looks like from outside); (b) no page's owner labels may span
    two non-empty tenants; (c) every decoding slot's pages must be
    owned by that slot's own tenant."""
    problems: List[str] = []
    pages = state.get("pages", {}) or {}
    recorded = state.get("tenants", None)
    derived = tenant_sums_from_state(state)
    if recorded is not None:
        for t in sorted(set(recorded) | set(derived)):
            want = (recorded.get(t) or {}).get("refs", 0)
            got = (derived.get(t) or {}).get("refs", 0)
            if want != got:
                problems.append(
                    f"tenants block disagrees with the page map: tenant "
                    f"'{t}' records {want} reference(s), page map "
                    f"re-derives {got}")
    for p, info in sorted(pages.items()):
        tenants_here = {tenant_of_label(str(l))
                        for l in info.get("owners", []) or []}
        tenants_here.discard("")
        if len(tenants_here) > 1:
            problems.append(
                f"cross-tenant page: page {p} owner labels span tenants "
                f"{sorted(tenants_here)}")
    for slot in (state.get("rows", {}) or {}).get("slots", []) or []:
        st = tenant_of_label(str(slot.get("owner", "")))
        if not st:
            continue
        for p in slot.get("pages", []) or []:
            info = pages.get(str(p)) or {}
            owner_tenants = {tenant_of_label(str(l))
                             for l in info.get("owners", []) or []}
            owner_tenants.discard("")
            if owner_tenants and st not in owner_tenants:
                problems.append(
                    f"slot {slot.get('slot')} (tenant '{st}') references "
                    f"page {p} owned by tenant(s) "
                    f"{sorted(owner_tenants)}")
    return problems


def merge_expected(grants: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Fold (tenant, refs) grant events into an expected table for
    :func:`audit_tenants` — the fleet plane records one entry per claim
    grant and one negative entry per release."""
    out: Dict[str, int] = {}
    for tenant, refs in grants:
        out[tenant] = out.get(tenant, 0) + int(refs)
    return {t: n for t, n in out.items() if n != 0 or t in out}
