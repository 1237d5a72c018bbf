"""The port's corruption drills against the JAX package's on the same
engine inputs, on the CPU (``MARIAN_POOL_AUDIT=1`` from
``tests/conftest.py``: every round ends with an audit that raises):

- ``pool.double_free`` and ``pool.table_corrupt`` on the greedy engines
  and ``pool.refcount_corrupt`` and ``beam.diff_corrupt`` on the fused
  beam engines: armed at the same hit of the same decode, the round
  fails its audit with the same violations in both, and the engine's
  audit names the same corruption afterwards;
- ``tenant.page_leak`` on a two-tenant pool: ``audit()`` stays clean in
  both, ``audit_tenants`` names the same over and under charge;
- an unarmed drill is a no-op (state and audit unchanged), and a
  single-tenant pool cannot leak (``tests/test_fleet.py``'s
  ``TestTenantLeakDrill``).
"""

import pytest
import torch

from marian_tpu.common import faultpoints as jfp
from marian_tpu.ops.pallas.kv_pool import KVPool as JPool
from marian_tpu.ops.pallas.kv_pool import PoolCorruption as JCorruption
from marian_tpu.serving.fleet import accounting as jacc
from marian_tpu.translator.iteration import PagedDecodeEngine as JEngine
from marian_tpu_torch.common import faultpoints as tfp
from marian_tpu_torch.ops.kernels.kv_pool import KVPool, PoolCorruption
from marian_tpu_torch.serving.fleet import accounting as tacc
from marian_tpu_torch.translator.iteration import PagedDecodeEngine
from tests.test_torch_beam_fused import fused_engines
from tests.test_torch_beam_iteration import TEXTS as BEAM_TEXTS
from tests.test_torch_beam_iteration import tiny as beam_tiny  # noqa: F401
from tests.test_torch_iteration import ENGINE, TEXTS, tiny  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def disarmed():
    try:
        yield
    finally:
        tfp.reset_for_tests()
        jfp.reset_for_tests()


def run_drill(eng, jeng, spec, texts):
    """Decode ``texts`` on both engines with ``spec`` armed in each
    package; returns (the port's failure, the JAX failure) messages."""
    with jfp.active(spec):
        with pytest.raises(JCorruption, match="pool audit failed") as je:
            jeng.decode_texts(texts)
    with tfp.active(spec):
        with pytest.raises(PoolCorruption, match="pool audit failed") as te:
            eng.decode_texts(texts)
    return str(te.value), str(je.value)


def greedy(tiny):
    jm, jp, tm, tp, jv, tv = tiny
    return (PagedDecodeEngine(tm, tp, tv, tv, max_rows=3, **ENGINE),
            JEngine(jm, jp, jv, jv, max_rows=3, **ENGINE))


@pytest.mark.parametrize("spec,needle", [
    # the re-freed pages go straight back out to the round's joins: the
    # audit sees them twice referenced at refcount 1
    ("pool.double_free=fail@2", "refcount drift"),
    ("pool.table_corrupt=fail@2", "does not match its claim"),
])
def test_greedy_drill_fails_the_audit_as_jax(tiny, spec, needle):
    eng, jeng = greedy(tiny)
    got, want = run_drill(eng, jeng, spec, TEXTS[:4])
    assert got == want and needle in got
    assert eng.audit() == jeng.audit()
    assert any(needle in v for v in eng.audit())


@pytest.mark.parametrize("spec,needle", [
    ("pool.refcount_corrupt=fail@2", "refcount"),
    ("beam.diff_corrupt=fail@1", "does not match its claim"),
])
def test_fused_beam_drill_fails_the_audit_as_jax(beam_tiny, spec, needle):
    eng, jeng = fused_engines(beam_tiny, 2)
    got, want = run_drill(eng, jeng, spec, BEAM_TEXTS[:2])
    assert got == want and needle in got
    assert eng.audit() == jeng.audit()


@pytest.mark.parametrize("drill", ["chaos_double_free",
                                   "chaos_refcount_corrupt",
                                   "chaos_tenant_leak"])
def test_unarmed_drill_is_a_noop(drill):
    pool = KVPool(16, page_len=4)
    pool.claim("A/r1", 2)
    pool.claim("B/r1", 1)
    pool.share("A/r2", pool.pages_of("A/r1")[:1])
    before = (pool.claims(), pool.refcounts(), pool.free_pages())
    getattr(pool, drill)()
    assert (pool.claims(), pool.refcounts(), pool.free_pages()) == before
    assert pool.audit() == []
    assert tacc.audit_tenants(pool, {"A": 3, "B": 1}) == []
    assert tfp.hits({"chaos_double_free": "pool.double_free",
                     "chaos_refcount_corrupt": "pool.refcount_corrupt",
                     "chaos_tenant_leak": "tenant.page_leak"}[drill]) == 1


def tenant_pools():
    out = []
    for cls in (KVPool, JPool):
        pool = cls(16, page_len=4)
        pool.claim("A/r1", 2)
        pool.claim("B/r1", 1)
        out.append(pool)
    return out


def test_tenant_leak_is_caught_by_the_tenant_auditor_only_as_jax():
    pool, jpool = tenant_pools()
    expected = {"A": 2, "B": 1}
    with tfp.active("tenant.page_leak=fail@*"):
        pool.chaos_tenant_leak()
    with jfp.active("tenant.page_leak=fail@*"):
        jpool.chaos_tenant_leak()
    assert pool.claims() == jpool.claims()
    assert pool.audit() == jpool.audit() == []
    bad = tacc.audit_tenants(pool, expected)
    assert bad == jacc.audit_tenants(jpool, expected)
    assert any("under by 1" in b for b in bad)
    assert any("over by 1" in b for b in bad)


def test_single_tenant_pool_cannot_leak():
    pool = KVPool(16, page_len=4)
    pool.claim("A/r1", 2)
    pool.claim("shared", 1)              # untenanted: exempt
    with tfp.active("tenant.page_leak=fail@*"):
        pool.chaos_tenant_leak()
    assert tacc.audit_tenants(pool, {"A": 2}) == []
    assert pool.claims() == {"A/r1": [1, 2], "shared": [3]}
