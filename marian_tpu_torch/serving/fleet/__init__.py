"""marian_tpu_torch.serving.fleet — multi-tenant fleet serving, ported
from ``marian_tpu/serving/fleet/``.

N model families in one process: per-tenant lifecycle stacks
(SwapController, and BundleWatcher under ``--fleet-watch``) under a
shared memory budget with evict-coldest and warm-on-demand
(tenancy.py), and per-tenant KV-page accounting and isolation auditing
over the refcount plane (accounting.py). Requests select their tenant
with the ``#model:<tag>`` protocol header.
"""

from .accounting import (audit_tenants, check_tenant_isolation,  # noqa: F401
                         cross_tenant_pages, merge_expected,
                         tenant_of_label, tenant_of_owner,
                         tenant_page_sums, tenant_sums_from_state)
from .tenancy import (FLEET_LATENCY_METRIC, FLEET_OUTCOMES_METRIC,  # noqa: F401
                      HBM_OVERHEAD, FleetManager, TenantSpec,
                      UnknownTenant, parse_fleet_spec, valid_tag)
