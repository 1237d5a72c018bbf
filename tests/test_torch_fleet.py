"""The port's multi-tenant fleet serving (``serving/fleet/`` and its wiring
in the scheduler, the SLO engine and the server) against the JAX
package's, on the CPU:

- the ``#model:`` header splits as the reference's
  ``split_model_header``, and ``parse_fleet_spec`` and ``valid_tag``
  accept and refuse the same specs and tags with the same messages;
- the accounting functions (``tenant_of_owner``, ``tenant_page_sums``,
  ``cross_tenant_pages``, ``audit_tenants`` on a live pool,
  ``tenant_sums_from_state``, ``check_tenant_isolation``,
  ``merge_expected``) give the JAX results on the same claims and
  documents;
- ``FleetManager`` with stub executor factories warms on demand and
  routes, evicts the coldest idle tenant under the budget (releasing only
  its pages), never evicts a tenant with a batch in flight, and reports
  the JAX ``status()`` document; an evicted tenant's controller holds no
  executor any more;
- one tenant's fast burn sheds only its own low-priority lanes;
- the SLO engine's fleet label filters read one tenant's children, and
  their defaults are the single-model engine;
- a fleet server over TCP (``_serve``, ``HAVE_WS`` pinned off) on two
  tiny models answers each tenant's requests with its ``Translate.run``
  and with the JAX fleet server's replies, sends untagged requests to
  the default tenant, answers an unknown tag with the JAX
  ``!!SERVER-ERROR``, evicts and warms under the budget with counters
  equal to ``/fleetz``, and its ``marian_fleet_*`` series carry the
  reference's names, types, labels and HELP (but the cold-start gauge's,
  which names the reference's compile cache) and pass the port's
  promlint;
- ``--fleet`` with iteration mode, with ``--model-watch`` and with a
  default tenant that names no tenant is refused with the reference's
  messages.

Every wait has a deadline.
"""

import asyncio
import json
import os
import types
import urllib.request

import numpy as np
import pytest
import torch

from marian_tpu import obs as jobs
from marian_tpu.common.config_parser import parse_options as jparse
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.obs import slo as jslo
from marian_tpu.ops.pallas.kv_pool import KVPool as JPool
from marian_tpu.serving import metrics as jmsm
from marian_tpu.serving.admission import Overloaded as JOverloaded
from marian_tpu.serving.fleet import accounting as jacc
from marian_tpu.serving.fleet import tenancy as jten
from marian_tpu.server import server as jsrv
from marian_tpu.training import bundle as jbdl
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.common import io as mio
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.obs import slo as tslo
from marian_tpu_torch.ops.kernels.kv_pool import KVPool
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving import promlint
from marian_tpu_torch.serving.admission import Overloaded
from marian_tpu_torch.serving.fleet import accounting as tacc
from marian_tpu_torch.serving.fleet import tenancy as tten
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.training import bundle as tbdl
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(1)

WAIT = 60.0
PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, msm=jmsm, acc=jacc, ten=jten,
                                 slo=jslo, Pool=JPool, bdl=jbdl,
                                 Overloaded=JOverloaded, srv=jsrv),
    "torch": types.SimpleNamespace(obs=tobs, msm=tmsm, acc=tacc, ten=tten,
                                   slo=tslo, Pool=KVPool, bdl=tbdl,
                                   Overloaded=Overloaded, srv=srv),
}


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    for p in PKGS.values():
        p.obs.TRACER.reset()
        p.obs.FLIGHT.disarm()
        p.obs.PERF.reset()


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# the #model: header, the spec, the tags
# ---------------------------------------------------------------------------

FRAMES = ["#model:en-de\nhello", "hello world", "#model:en-de.legal\nx",
          "#model:\nx", "#model:has space\nx", "#model:" + "a" * 64 + "\nx",
          "#model:" + "a" * 65 + "\nx", "#model:bad/slash\nx", "#model:A",
          "#model:A\n#priority:2\nhi", "#MODEL:A\nx", "#model: A \nx",
          "#model:é\nx", ""]


@pytest.mark.parametrize("frame", FRAMES)
def test_model_header_matches_jax(frame):
    assert srv.split_model_header(frame) == jsrv.split_model_header(frame)


@pytest.mark.parametrize("frame", [
    "#trace:t1\n#model:A\n#priority:3\n#stream:1\nx",
    "#model:A\n#trace:t1\nx", "#priority:1\n#model:A\nx",
    "#trace:t1\n#model:bad tag\nx"])
def test_headers_stack_as_jax(frame):
    """#trace, then #model, then #priority, then #stream, as the
    reference's handle_frame peels them."""
    tid, body = jsrv.split_trace_header(frame)
    tag, body = jsrv.split_model_header(body)
    prio, body = jsrv.split_priority_header(body)
    stream, body = jsrv.split_stream_header(body)
    assert srv.split_headers(frame) == (tid, tag, prio, stream, body)


SPECS = ["A=/m/a.npz, B=/m/b.npz", "en-de.v2=/m/x.npz", "A=/m/a.npz,",
         "A=/m/a.npz,A=/m/b.npz", "A", "A=", "=x", "bad tag=/m/a.npz",
         " , ", "", "a/b=/m/a.npz", "A=/m/a.npz,B"]


def spec_result(ten, spec):
    try:
        return [(s.tag, s.model_path) for s in ten.parse_fleet_spec(spec)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fleet_spec_matches_jax(spec):
    assert spec_result(tten, spec) == spec_result(jten, spec)


@pytest.mark.parametrize("tag", ["en-de.legal_v2", "", "a" * 64, "a" * 65,
                                 "a/b", "A", "x y", "é"])
def test_valid_tag_matches_jax(tag):
    assert tten.valid_tag(tag) == jten.valid_tag(tag)


# ---------------------------------------------------------------------------
# the accounting functions
# ---------------------------------------------------------------------------

class _Owner:
    def __init__(self, tenant):
        self.tenant = tenant


class _Row:
    def __init__(self, tenant):
        self.req = _Owner(tenant)


OWNERS = [_Owner("A"), _Row("B"), (_Owner("C"), 3, "k"), "D/slot-7",
          "untenanted", ("plain", 1), _Row(""), ("prefix", "x", 1)]
CLAIMS = [
    {"A/r1": [1, 2], "A/r2": [2], "B/r1": [3], "shared": [4]},
    {"A/r1": [1], "A/r2": [1], "shared": [1]},
    {"A/r1": [1], "B/r1": [1]},
    {},
    {"A/r1": [5, 6, 7], "B/r9": [7, 8], "C/x": [9], "prefix": [5]},
]
DOCS = [
    {"pages": {"1": {"refs": 1, "owners": ["A/r1"]},
               "2": {"refs": 1, "owners": ["B/r1"]}},
     "tenants": {"A": {"refs": 1, "owners": 1},
                 "B": {"refs": 1, "owners": 1}},
     "rows": {"slots": [{"slot": 0, "owner": "A/r1", "pages": [1]}]}},
    {"pages": {"1": {"refs": 1, "owners": ["A/r1"]}},
     "tenants": {"A": {"refs": 9, "owners": 1}}},
    {"pages": {"1": {"refs": 2, "owners": ["A/r1", "B/r9"]}}},
    {"pages": {"1": {"refs": 1, "owners": ["A/r1"]},
               "2": {"refs": 1, "owners": ["B/r1"]}},
     "rows": {"slots": [{"slot": 0, "owner": "A/r1", "pages": [2]}]}},
    {"pages": {"3": {"refs": 2, "owners": ["trace:x", "prefix-cache"]}}},
]


@pytest.mark.parametrize("i", range(len(OWNERS)))
def test_tenant_of_owner_matches_jax(i):
    assert tacc.tenant_of_owner(OWNERS[i]) == jacc.tenant_of_owner(OWNERS[i])


@pytest.mark.parametrize("i", range(len(CLAIMS)))
def test_claims_sums_match_jax(i):
    c = CLAIMS[i]
    assert tacc.tenant_page_sums(c) == jacc.tenant_page_sums(c)
    assert tacc.cross_tenant_pages(c) == jacc.cross_tenant_pages(c)
    assert [tacc.tenant_of_label(k) for k in c] \
        == [jacc.tenant_of_label(k) for k in c]


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_document_checks_match_jax(i):
    d = DOCS[i]
    assert tacc.tenant_sums_from_state(d) == jacc.tenant_sums_from_state(d)
    got = tacc.check_tenant_isolation(d)
    assert got == jacc.check_tenant_isolation(d)
    assert bool(got) == (i in (1, 2, 3))


@pytest.mark.parametrize("expected", [{"A": 2, "B": 1}, {"A": 3, "B": 1},
                                      {"A": 2}, {}, {"A": 2, "B": 1,
                                                     "C": 4}])
def test_audit_tenants_on_a_live_pool_matches_jax(expected):
    out = {}
    for name, p in PKGS.items():
        pool = p.Pool(16, page_len=4)
        pool.claim("A/r1", 2)
        pool.claim("B/r1", 1)
        pool.claim("shared", 1)
        out[name] = p.acc.audit_tenants(pool, expected)
    assert out["torch"] == out["jax"]
    assert (out["torch"] == []) == (expected == {"A": 2, "B": 1})


@pytest.mark.parametrize("grants", [
    [("A", 2), ("A", 3), ("B", 1), ("B", -1)], [], [("A", -1)],
    [("A", 1), ("B", 2), ("A", -1)]])
def test_merge_expected_matches_jax(grants):
    assert tacc.merge_expected(grants) == jacc.merge_expected(grants)


# ---------------------------------------------------------------------------
# FleetManager on stub executors
# ---------------------------------------------------------------------------

def commit_bundle(p, model_path, tag="x", member="m.npz"):
    """One tiny committed bundle through the package's commit protocol;
    the member's length is what the residency estimate reads."""
    def write(path):
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(tag)
    return p.bdl.write_bundle(str(model_path), {member: write})


def name_factory():
    """Replies ``<model stem>-b<seq>:<line>``: which tenant's which
    bundle answered."""
    def factory(bundle_dir, manifest):
        root = os.path.basename(os.path.dirname(os.path.abspath(
            bundle_dir)))
        name = root.split(".")[0]
        seq = int(manifest["seq"]) if manifest else 0

        def translate(lines):
            return [f"{name}-b{seq}:{ln}" for ln in lines]
        return translate
    return factory


def make_fleet(p, tmp_path, tags="ABC", tag_bytes=4, **kw):
    tmp_path.mkdir(parents=True, exist_ok=True)
    specs = []
    for t in tags:
        mp = str(tmp_path / f"m_{t}.npz")
        commit_bundle(p, mp, tag="x" * tag_bytes)
        specs.append(p.ten.TenantSpec(t, mp))
    kw.setdefault("golden", ["hello"])
    return p.ten.FleetManager(specs, name_factory(),
                              metrics_registry=p.msm.Registry(), **kw)


def status_view(fleet):
    """status() without wall-clock readings."""
    doc = fleet.status()
    for row in doc["tenants"]:
        row.pop("idle_s")
        row.pop("last_cold_start_s")
        row["model_path"] = os.path.basename(row["model_path"])
    return doc


def test_warm_on_demand_and_routing_match_jax(tmp_path):
    out = {}
    for name, p in PKGS.items():
        fleet = make_fleet(p, tmp_path / name)
        try:
            cold = status_view(fleet)
            a = fleet.executor_for("A")(["hi"])
            b = fleet.executor_for("B")(["yo"])
            again = fleet.executor_for("A")(["x"])
            with pytest.raises(p.ten.UnknownTenant):
                fleet.executor_for("Z")
            out[name] = (cold, a, b, again, status_view(fleet),
                         fleet.live_version_name("A"),
                         fleet.live_version_name("C"),
                         fleet.live_version_name("Z"),
                         fleet.m_cold_starts.labels("A").value,
                         fleet.m_cold_start_s.labels("A").value > 0)
        finally:
            fleet.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][1:4] == (["m_A-b1:hi"], ["m_B-b1:yo"], ["m_A-b1:x"])
    assert out["torch"][5:] == ("A:bundle-00000001", "C:cold", "Z:unknown",
                                1, True)


def test_evict_coldest_under_the_budget_matches_jax(tmp_path):
    """Room for two tenants: warming the third evicts the least recently
    routed one, releases only its page claims, and its controller keeps
    no executor (its model leaves the card)."""
    out = {}
    for name, p in PKGS.items():
        clk = {"t": 0.0}
        pool = p.Pool(16, page_len=4)
        fleet = make_fleet(p, tmp_path / name, tag_bytes=4,
                           hbm_budget_bytes=20, kv_pool=pool,
                           clock=lambda: clk["t"])
        try:
            clk["t"] = 1.0
            fleet.executor_for("A")(["a"])
            clk["t"] = 2.0
            fleet.executor_for("B")(["b"])
            pool.claim("A/row-1", 2)
            pool.claim("B/row-1", 1)
            ctrl_b = fleet._tenants["B"].controller
            live_b = ctrl_b.live_version()
            clk["t"] = 3.0
            fleet.executor_for("A")(["a"])
            clk["t"] = 4.0
            fleet.executor_for("C")(["c"])
            out[name] = (status_view(fleet),
                         fleet.m_evictions.labels("hbm_pressure").value,
                         fleet.m_resident.labels("B").value,
                         sorted(pool.claims()),
                         p.acc.audit_tenants(pool, {"A": 2}),
                         fleet.tenant_pages())
            if name == "torch":
                # every reference to B's executors is gone
                assert live_b.executor is None and not ctrl_b.has_live()
        finally:
            fleet.stop()
    assert out["torch"] == out["jax"]
    st = {r["tenant"]: r for r in out["torch"][0]["tenants"]}
    assert st["A"]["resident"] and st["C"]["resident"]
    assert not st["B"]["resident"]
    assert out["torch"][1:5] == (1, 0, ["A/row-1"], [])


def test_busy_tenant_never_evicted_matches_jax(tmp_path):
    out = {}
    for name, p in PKGS.items():
        fleet = make_fleet(p, tmp_path / name, tags="AB", tag_bytes=4,
                           hbm_budget_bytes=10)
        try:
            run_a = fleet.executor_for("A")      # in flight until called
            fleet.executor_for("B")(["b"])
            mid = status_view(fleet)
            done = run_a(["a"])
            out[name] = (mid, done, status_view(fleet),
                         fleet.m_evictions.labels("hbm_pressure").value)
        finally:
            fleet.stop()
    assert out["torch"] == out["jax"]
    st = {r["tenant"]: r for r in out["torch"][0]["tenants"]}
    assert st["A"]["resident"] and st["B"]["resident"]
    assert st["A"]["inflight_batches"] == 1
    assert out["torch"][1:] == (["m_A-b1:a"], out["torch"][2], 0)


def test_status_keys_match_jax(tmp_path):
    docs = {}
    for name, p in PKGS.items():
        fleet = make_fleet(p, tmp_path / name, tags="A",
                           hbm_budget_bytes=1 << 20)
        try:
            fleet.executor_for("A")(["x"])
            docs[name] = fleet.status()
        finally:
            fleet.stop()
    t, j = docs["torch"], docs["jax"]
    assert set(t) == set(j)
    assert [set(r) for r in t["tenants"]] == [set(r) for r in j["tenants"]]
    assert t["hbm_overhead_factor"] == j["hbm_overhead_factor"] == 2.0


def test_tenant_burn_sheds_only_its_own_low_lanes_as_jax(tmp_path):
    out = {}
    for name, p in PKGS.items():
        clk = {"t": 0.0}
        fleet = make_fleet(p, tmp_path / name, tags="AB",
                           clock=lambda: clk["t"], brownout_min_priority=1)
        try:
            n = fleet.build_slos(availability=0.999, window_s=10)
            fleet.tick_slos(now=0.0)
            for _ in range(50):
                fleet.note_outcome("A", "ok", 0.01)
                fleet.note_outcome("A", "failure", 0.01)
                fleet.note_outcome("B", "ok", 0.01)
            clk["t"] = 1.0
            fleet.tick_slos(now=1.0)
            verdicts = []
            for tag, prio in (("A", 0), ("A", 1), ("B", 0), ("B", -3)):
                try:
                    fleet.gate(tag, priority=prio)
                    verdicts.append("ok")
                except p.Overloaded as e:
                    verdicts.append(str(e))
            out[name] = (n, verdicts,
                         fleet.slo_engine("A").fast_burn(),
                         fleet.slo_engine("B").fast_burn(),
                         fleet.m_shed.labels("A", "tenant_brownout").value,
                         fleet.m_shed.labels("B", "tenant_brownout").value,
                         [r["slo"] for r in fleet.status()["tenants"]])
        finally:
            fleet.stop()
    assert out["torch"] == out["jax"]
    n, verdicts, burn_a, burn_b, shed_a, shed_b, _ = out["torch"]
    assert n == 2 and verdicts[0].startswith("tenant 'A' is burning")
    assert verdicts[1:] == ["ok", "ok", "ok"]
    assert burn_a >= 14.4 > burn_b and (shed_a, shed_b) == (1, 0)


def test_no_engines_no_gate(tmp_path):
    fleet = make_fleet(PKGS["torch"], tmp_path, tags="A")
    try:
        assert fleet.build_slos() == 0
        fleet.gate("A", priority=-9)
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# the SLO engine's fleet label filters
# ---------------------------------------------------------------------------

def slo_states(p, **kw):
    clk = {"t": 0.0}
    reg = p.msm.Registry()
    eng = p.slo.SloEngine(registry=reg, availability=0.99, p99_ms=50.0,
                          window_s=10, clock=lambda: clk["t"], **kw)
    out = [p.slo.SloEngine.state(eng)]
    eng.tick(0.0)
    m = reg.counter("marian_serving_request_outcomes_total", "o",
                    labels=("outcome", "model_version"))
    f = reg.counter("marian_fleet_request_outcomes_total", "o",
                    labels=("outcome", "tenant"))
    h = reg.histogram("marian_serving_request_latency_seconds", "l")
    fh = reg.histogram("marian_fleet_request_latency_seconds", "l",
                       labels=("tenant",))
    for i in range(40):
        m.labels("ok" if i % 4 else "failure", "v").inc()
        f.labels("ok" if i % 5 else "timeout", "A").inc()
        f.labels("ok", "B").inc()
        h.observe(0.01 * (i % 9))
        fh.labels("A").observe(0.02 * (i % 7))
        fh.labels("B").observe(0.001)
    clk["t"] = 1.0
    eng.tick(1.0)
    st = eng.state()
    st.pop("uptime_s", None)
    out.append(st)
    out.append(eng.fast_burn())
    out.append(sorted(ln for ln in reg.render().splitlines()
                      if ln.startswith("marian_slo_")))
    return out


FILTERS = [
    {},
    dict(outcomes_metric="marian_serving_request_outcomes_total",
         latency_metric="marian_serving_request_latency_seconds",
         label_filter=None, latency_labels=(), objective_prefix=""),
    dict(outcomes_metric="marian_fleet_request_outcomes_total",
         latency_metric="marian_fleet_request_latency_seconds",
         label_filter=(1, "A"), latency_labels=("A",),
         objective_prefix="A:"),
    dict(outcomes_metric="marian_fleet_request_outcomes_total",
         latency_metric="marian_fleet_request_latency_seconds",
         label_filter=(1, "B"), latency_labels=("B",),
         objective_prefix="B:"),
]


@pytest.mark.parametrize("i", range(len(FILTERS)))
def test_slo_label_filters_match_jax(i):
    got = slo_states(PKGS["torch"], **FILTERS[i])
    assert got[1:] == slo_states(PKGS["jax"], **FILTERS[i])[1:]
    if i == 1:
        # the defaults spelled out are today's engine
        assert got[1:] == slo_states(PKGS["torch"])[1:]
    if i >= 2:
        tag = FILTERS[i]["objective_prefix"]
        assert set(got[1]["objectives"]) == {f"{tag}availability",
                                             f"{tag}latency_p99"}


# ---------------------------------------------------------------------------
# the fleet server on two tiny models
# ---------------------------------------------------------------------------

WORDS = [" ".join(f"w{i}" for i in range(35))]
LINES = ["w3 w4 w5", "w6 w7", "w8 w9 w10 w11", "w2 w3", "w12 w13 w14",
         "w20 w21 w22"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two tenants, a and b: tiny models of two seeds saved with the
    port's io (both packages read them), one vocabulary."""
    d = tmp_path_factory.mktemp("fleet")
    vocab = JVocab.build(WORDS)
    vocab.save(str(d / "v.yml"))
    paths = {}
    for tag, seed in (("a", 4), ("b", 7)):
        _, jp, _, _, opts = tiny_pair(vocab=len(vocab), seed=seed)
        paths[tag] = str(d / f"{tag}.npz")
        mio.save_model(paths[tag], {k: np.asarray(v) for k, v in jp.items()},
                       opts.as_yaml())
    return paths, str(d / "v.yml")


def fleet_argv(models, *extra):
    paths, vocab = models
    est = 2 * max(os.path.getsize(p) for p in paths.values())
    # room for one tenant, not two: alternating tenants evict
    budget = 1.5 * est / (1 << 20)
    return ["--vocabs", vocab, vocab,
            "--fleet", ",".join(f"{t}={p}" for t, p in paths.items()),
            "--fleet-default-tenant", "a", "--fleet-hbm-budget-mb",
            repr(budget), "--beam-size", "2", "--max-length", "16",
            "--port", "0", "--quiet", *extra]


async def tcp_request(port, text):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = text.encode("utf-8")
    writer.write(b"MTPU %d\n" % len(payload) + payload)
    await writer.drain()
    header = await reader.readline()
    reply = await reader.readexactly(int(header.split()[1]))
    writer.close()
    return reply.decode("utf-8")


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as fh:
        return fh.read().decode()


FLEET_REQUESTS = ([f"#model:a\n{ln}" for ln in LINES[:3]]
                  + [f"#model:b\n{ln}" for ln in LINES[:3]]
                  + ["\n".join(LINES[3:])]
                  + [f"#model:b\n{LINES[5]}", f"#model:a\n{LINES[4]}",
                     "#model:zz\nw3 w4", "#model:b\n#priority:2\nw5",
                     "#priority:2\n#model:b\nw5"])


def test_fleet_server_replies_equal_each_tenant_and_jax(models, monkeypatch):
    monkeypatch.setattr(srv, "HAVE_WS", False)
    paths, vocab = models
    mport = free_port()
    options = parse_options(fleet_argv(models, "--cpu-threads", "1",
                                       "--metrics-port", str(mport)),
                            mode="server")
    want = {}
    for tag, path in paths.items():
        svc = srv.TranslationService(
            parse_options(["--models", path, "--vocabs", vocab, vocab,
                           "--beam-size", "2", "--max-length", "16",
                           "--cpu-threads", "1", "--quiet"],
                          mode="server"), "cpu")
        want[tag] = dict(zip(LINES + ["w5"],
                             svc.translate_lines(LINES + ["w5"])))

    async def main():
        ready = asyncio.get_event_loop().create_future()
        task = asyncio.ensure_future(srv._serve(options, ready=ready))
        port = await asyncio.wait_for(ready, WAIT)
        try:
            replies = []
            for text in FLEET_REQUESTS:      # one at a time: alternating
                replies.append(await tcp_request(port, text))
            loop = asyncio.get_event_loop()
            fleetz = json.loads(await loop.run_in_executor(
                None, get, mport, "/fleetz"))
            metrics = await loop.run_in_executor(None, get, mport,
                                                 "/metrics")
            return replies, fleetz, metrics
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    replies, fleetz, metrics = run(main())
    expect = ([want["a"][ln] for ln in LINES[:3]]
              + [want["b"][ln] for ln in LINES[:3]]
              + ["\n".join(want["a"][ln] for ln in LINES[3:])]
              + [want["b"][LINES[5]], want["a"][LINES[4]]])
    assert replies[:9] == expect
    assert replies[9].startswith("!!SERVER-ERROR unknown model tag 'zz'")
    assert replies[10] == want["b"]["w5"]
    # out of order, #model: is payload: two lines on the default tenant
    assert replies[11].count("\n") == 1
    # the JAX fleet server's replies on the same models and requests
    jopts = jparse(fleet_argv(models), mode="server")

    async def jmain():
        app = jsrv.ServingApp(jopts, registry=jmsm.Registry())
        await app.start()
        try:
            return [await app.handle_text(t) for t in FLEET_REQUESTS]
        finally:
            await app.shutdown(drain_timeout=5.0)
    assert replies == run(jmain())
    rows = {r["tenant"]: r for r in fleetz["tenants"]}
    cold = {t: r["cold_starts"] for t, r in rows.items()}
    # boot warms a then b (evicting a), then the traffic alternates
    assert cold["a"] >= 2 and cold["b"] >= 2
    ev = [ln for ln in metrics.splitlines()
          if ln.startswith('marian_fleet_evictions_total{reason='
                           '"hbm_pressure"}')]
    assert ev and float(ev[0].split()[1]) == sum(cold.values()) - 1
    for t, n in cold.items():
        line = f'marian_fleet_cold_starts_total{{tenant="{t}"}} {n}'
        assert any(ln.startswith(line) for ln in metrics.splitlines())
    assert fleetz["hbm_resident_bytes"] <= fleetz["hbm_budget_bytes"]
    assert sum(r["resident"] for r in rows.values()) == 1
    fleet_text = "\n".join(ln for ln in metrics.splitlines()
                           if "marian_fleet_" in ln) + "\n"
    assert promlint.lint_metrics_text(fleet_text) == []


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# HELP that names the reference's compile cache, which the port has no
# counterpart for
HELP_BY_DESIGN = {"marian_fleet_cold_start_seconds"}


def fleet_census(reg):
    return {name: (m.kind, tuple(m.label_names),
                   None if name in HELP_BY_DESIGN else m.help,
                   tuple(getattr(m, "buckets", ())))
            for name, m in reg._metrics.items()
            if name.startswith("marian_fleet_")}


def test_fleet_metric_census_matches_jax(tmp_path):
    out = {}
    for name, p in PKGS.items():
        fleet = make_fleet(p, tmp_path / name, tags="AB")
        try:
            fleet.executor_for("B")(["hi"])
            fleet.note_outcome("B", "ok", 0.01)
            fleet.note_shed("?", "unknown_tenant")
            out[name] = fleet_census(fleet.registry)
        finally:
            fleet.stop()
    assert out["torch"] == out["jax"]
    assert set(out["torch"]) == {
        "marian_fleet_tenants", "marian_fleet_resident",
        "marian_fleet_hbm_budget_bytes", "marian_fleet_hbm_resident_bytes",
        "marian_fleet_request_outcomes_total",
        "marian_fleet_request_latency_seconds", "marian_fleet_shed_total",
        "marian_fleet_evictions_total", "marian_fleet_cold_starts_total",
        "marian_fleet_cold_start_seconds"}


# ---------------------------------------------------------------------------
# the option checks
# ---------------------------------------------------------------------------

BAD = [("--batching-mode", "iteration"), ("--model-watch", "0.5"),
       ("--fleet-default-tenant", "c")]


@pytest.mark.parametrize("extra", BAD, ids=["iteration", "model-watch",
                                            "default-tenant"])
def test_refusals_match_jax(models, extra):
    argv = fleet_argv(models)
    i = argv.index("--fleet-default-tenant")
    if extra[0] == "--fleet-default-tenant":
        argv[i + 1] = extra[1]
    else:
        argv += list(extra)
    with pytest.raises(ValueError) as got:
        srv.ServingApp(parse_options(argv + ["--cpu-threads", "1"],
                                     mode="server"),
                       registry=tmsm.Registry())
    with pytest.raises(ValueError) as want:
        jsrv.ServingApp(jparse(argv, mode="server"),
                        registry=jmsm.Registry())
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module", autouse=True)
def lock_witness():
    """At the module's end: the port's witnessed locks (MARIAN_LOCKDEP=1,
    tests/conftest.py) show no acquisition-order cycle, and every lock
    name observed is one a ``make_lock``/``make_rlock`` literal declares."""
    yield
    from marian_tpu_torch.common import lockdep
    if lockdep.enabled():
        assert lockdep.observed_cycles() == []
        assert lockdep.observed_nodes() <= lockdep.declared_names()
