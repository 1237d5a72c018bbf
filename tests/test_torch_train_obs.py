"""The trainer's side of the port's observability plane against the JAX
package's, on the CPU:

- ``StepTimer`` (``obs/profiling.py``): phases aggregate and emit
  ``train.<phase>`` spans, ``sync_fn`` runs before every boundary, a
  disabled timer records nothing, and the report mirrors the totals into
  ``marian_step_phase_seconds`` (``tests/test_obs.py::TestStepTimer``);
- ``TraceWindow`` on the CPU writes one Chrome trace covering exactly
  its updates and stamps ``profile.window_start``/``_stop``;
- ``PerfMeter.record_train_window`` gives JAX's gauges on the same
  numbers and geometry with the peak pinned, and MFU 0 on the CPU
  (``tests/test_perf_slo.py``);
- the six trainer series and the two train gauges carry JAX's names,
  types and HELP;
- ``marian-train --metrics-port --trace --profile`` on the CPU: a scrape
  passes promlint and holds the series, ``/tracez`` the train spans, the
  profiler window its trace; ``--profile-server`` is refused by name;
- the ``train.nan_grad`` drill: one poisoned batch, which
  ``--check-gradient-nan`` skips with the parameters and the optimizer
  state unchanged, counted once in ``marian_train_updates_skipped_total``,
  as the JAX trainer skips the same update of the same run;
- the flight dump's ``faultpoints`` member, and an armed ``kill``
  dumping before ``os._exit`` in a subprocess.
"""

import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import pytest
import torch

from marian_tpu import obs as jobs
from marian_tpu.cli import marian_train as jax_train
from marian_tpu.common import faultpoints as jfp
from marian_tpu.common.options import Options as JOptions
from marian_tpu.serving import metrics as jmsm
from marian_tpu.training import graph_group as jgg
from marian_tpu.training.scheduler import Scheduler as JScheduler
from marian_tpu.training.training_state import TrainingState as JState
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.cli import marian_train
from marian_tpu_torch.common import faultpoints as tfp
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.obs.perf import PerfMeter
from marian_tpu_torch.obs.profiling import StepTimer, TraceWindow
from marian_tpu_torch.serving import metrics as tmsm
from marian_tpu_torch.serving.promlint import lint_metrics_text
from marian_tpu_torch.training import graph_group as tgg
from marian_tpu_torch.training.scheduler import Scheduler
from marian_tpu_torch.training.train import Train
from marian_tpu_torch.training.training_state import TrainingState

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"
TRAIN_SERIES = {
    "marian_train_cost": "gauge", "marian_train_words_per_second": "gauge",
    "marian_train_learn_rate": "gauge", "marian_train_updates_total":
    "counter", "marian_train_labels_total": "counter",
    "marian_train_updates_skipped_total": "counter"}
TRAIN_GAUGES = ("marian_train_chip_seconds_per_token", "marian_train_mfu")


@pytest.fixture(autouse=True)
def _reset():
    yield
    for o in (jobs, tobs):
        o.TRACER.reset()
        o.FLIGHT.disarm()
    tobs.PERF.reset()
    tfp.reset_for_tests()
    jfp.reset_for_tests()


# -- StepTimer ---------------------------------------------------------------

def test_phases_aggregate_and_emit_spans():
    tobs.TRACER.enable()
    st = StepTimer()
    for name in ("data", "dispatch", "host", "data"):
        st.phase(name)
    st.stop()
    rep = st.report()
    assert set(rep) == {"data", "dispatch", "host"}
    assert st.counts == {"data": 2, "dispatch": 1, "host": 1}
    spans, _ = tobs.TRACER.snapshot()
    names = [s.name for s in spans]
    assert names.count("train.data") == 2
    assert names.count("train.dispatch") == names.count("train.host") == 1
    g = tmsm.REGISTRY.get("marian_step_phase_seconds")
    assert g.labels("dispatch").value == rep["dispatch"]


def test_sync_fn_runs_before_each_boundary():
    calls, stamps = [], []
    import time as _time
    st = StepTimer(sync_fn=lambda: calls.append(_time.perf_counter()))
    st.phase("a")
    stamps.append(st._t)
    st.phase("b")
    stamps.append(st._t)
    st.stop()
    assert len(calls) == 3                  # every boundary, stop too
    assert calls[0] <= stamps[0] and calls[1] <= stamps[1]


def test_disabled_timer_records_nothing():
    st = StepTimer(enabled=False, sync_fn=lambda: 1 / 0)
    st.phase("a")
    st.stop()
    assert st.report() == {}


# -- TraceWindow ---------------------------------------------------------------

def test_trace_window_covers_exactly_its_updates(tmp_path):
    tobs.TRACER.enable()
    win = TraceWindow(Options({"profile": str(tmp_path / "prof"),
                               "profile-start": 3, "profile-updates": 2}),
                      torch.device("cpu"))
    x = torch.ones(4, 4)
    for update in range(1, 8):
        win.tick(update)
        with torch.profiler.record_function(f"update{update}"):
            x = x @ x / 4.0
    win.close()
    files = os.listdir(tmp_path / "prof")
    assert files == [os.path.basename(win.path)]
    with open(win.path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"update3", "update4"} <= names
    assert not names & {"update1", "update2", "update5", "update6"}
    _, events = tobs.TRACER.snapshot()
    got = [(e["name"], e["attrs"].get("update")) for e in events
           if e["name"].startswith("profile.")]
    assert got == [("profile.window_start", 3), ("profile.window_stop", 5)]


def test_bare_profile_flag_and_no_window_without_it(tmp_path):
    assert TraceWindow(Options({"profile": ""})).dir == "profile"
    off = TraceWindow(Options({}))
    off.tick(100)
    off.close()
    assert off.dir is None and off.path is None


# -- the perf window and the series ----------------------------------------------

@pytest.mark.parametrize("peak", [1e9, None])
def test_record_train_window_matches_jax(peak):
    got = {}
    for name, meter_cls, msm in (("torch", PerfMeter, tmsm),
                                 ("jax", jobs.PerfMeter, jmsm)):
        r = msm.Registry()
        p = meter_cls()
        p.enable(registry=r)
        p.set_geometry(emb=32, ffn=64, enc_depth=1, dec_depth=1,
                       vocab=200, n_devices=2, peak_flops=peak,
                       device_kind="cpu")
        p.record_train_window(labels=100, src_words=120, sentences=10,
                              dt=2.0)
        got[name] = (r.get("marian_train_chip_seconds_per_token").value,
                     r.get("marian_train_mfu").value)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == pytest.approx(2.0 * 2 / 100)
    assert (got["torch"][1] > 0) == (peak is not None)


def test_cpu_geometry_reads_mfu_zero():
    r = tmsm.Registry()
    p = PerfMeter()
    p.enable(registry=r)
    p.set_geometry(emb=32, ffn=64, enc_depth=1, dec_depth=1, vocab=200)
    p.record_train_window(labels=100, src_words=120, sentences=10, dt=2.0)
    assert r.get("marian_train_mfu").value == 0.0
    assert r.get("marian_train_chip_seconds_per_token").value > 0


def family_lines(text, names):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(("# HELP ", "# TYPE "))
                  and ln.split()[2] in names)


def test_trainer_series_render_as_jax():
    Scheduler(Options({"disp-freq": "1u"}), TrainingState())
    JScheduler(JOptions({"disp-freq": "1u"}), JState())
    tobs.PERF.enable()
    jobs.PERF.enable()
    names = set(TRAIN_SERIES) | set(TRAIN_GAUGES)
    mine = family_lines(tmsm.REGISTRY.render(), names)
    theirs = family_lines(jmsm.REGISTRY.render(), names)
    assert mine == theirs and len(mine) == 2 * len(names)
    for n, kind in TRAIN_SERIES.items():
        assert f"# TYPE {n} {kind}" in mine


# -- marian-train on the CPU --------------------------------------------------------

@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_obs")
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    DefaultVocab.build(lines).save(str(d / "v.yml"))
    return d / "v.yml"


def args(vocab, model, *extra):
    return ["--type", "transformer", "--train-sets", str(DATA / "train.src"),
            str(DATA / "train.trg"), "--vocabs", str(vocab), str(vocab),
            "--model", str(model), "--dim-emb", "32",
            "--transformer-heads", "4", "--transformer-dim-ffn", "64",
            "--enc-depth", "2", "--dec-depth", "2", "--tied-embeddings-all",
            "--transformer-ffn-activation", "relu", "--learn-rate", "0.05",
            "--optimizer-params", "0.9", "0.98", "1e-9", "--clip-norm", "1",
            "--cost-type", "ce-mean-words", "--label-smoothing", "0.1",
            "--mini-batch", "16", "--maxi-batch", "4", "--maxi-batch-sort",
            "src", "--max-length", "24", "--seed", "1234", "--quiet",
            *extra]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_marian_train_serves_linted_series_and_train_spans(vocab, tmp_path):
    port = free_port()
    opts = parse_options(args(
        vocab, tmp_path / "m.npz", "--after-batches", "6", "--disp-freq",
        "2", "--metrics-port", str(port), "--trace", "--profile",
        str(tmp_path / "prof"), "--profile-start", "3", "--profile-updates",
        "2", "--cpu-threads", "2"), mode="training")
    # the registry is process-wide: earlier trainers in this process
    # counted their updates there too
    updates = tmsm.REGISTRY.counter("marian_train_updates_total", "")
    before = updates.value
    tr = Train(opts)
    try:
        tr.run()
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        tracez = json.loads(urllib.request.urlopen(
            base + "/tracez").read().decode())
    finally:
        if tr.metrics_server is not None:
            tr.metrics_server.close()
    assert lint_metrics_text(text) == []
    samples = {ln.split()[0]: float(ln.split()[1])
               for ln in text.splitlines() if ln and ln[0] != "#"}
    for n in list(TRAIN_SERIES) + list(TRAIN_GAUGES):
        assert n in samples, n
    assert samples["marian_train_updates_total"] - before == 6
    assert samples["marian_train_mfu"] == 0.0           # the CPU
    assert samples["marian_train_chip_seconds_per_token"] > 0
    for phase in ("data", "dispatch", "host"):
        assert f'marian_step_phase_seconds{{phase="{phase}"}}' in samples
    assert set(tr.step_phases) == {"data", "dispatch", "host"}
    names = {e["name"] for e in tracez["traceEvents"]}
    assert {"train.data", "train.dispatch", "train.host",
            "profile.window_start", "profile.window_stop"} <= names
    assert len(os.listdir(tmp_path / "prof")) == 1


def test_profile_server_is_refused_by_name(vocab, tmp_path):
    with pytest.raises(NotImplementedError, match="--profile-server"):
        marian_train.main(args(vocab, tmp_path / "m.npz",
                               "--profile-server", "6006",
                               "--cpu-threads", "2"))


def test_nan_grad_drill_skips_one_update_as_jax(vocab, tmp_path):
    """``train.nan_grad=fail@3`` with --check-gradient-nan: update 3 sees
    a NaN target mask, its gradient norm is not finite, and the update is
    skipped. The parameters and Adam's state after it are those after
    update 2, bit for bit; the skip counter moves once; the JAX trainer
    skips the same update of the same run."""
    seen = []
    orig = tgg.GraphGroup.update

    def spy(self, batches, step, *a, **k):
        out = orig(self, batches, step, *a, **k)
        seen.append((step, {n: p.detach().clone()
                            for n, p in self.params.items()},
                     self.opt_state["t"].item(), float(out.skipped)))
        return out

    extra = ("--after-batches", "4", "--disp-freq", "1",
             "--check-gradient-nan", "--overwrite")
    skipped = tmsm.REGISTRY.counter("marian_train_updates_skipped_total",
                                    "")
    before = skipped.value
    tgg.GraphGroup.update = spy
    try:
        with tfp.active("train.nan_grad=fail@3"):
            marian_train.main(args(vocab, tmp_path / "t.npz", *extra,
                                   "--cpu-threads", "2"))
    finally:
        tgg.GraphGroup.update = orig
    assert skipped.value - before == 1
    assert [s[3] for s in seen] == [0.0, 0.0, 1.0, 0.0]
    assert [s[2] for s in seen] == [1.0, 2.0, 2.0, 3.0]
    for n, p in seen[1][1].items():
        assert torch.equal(seen[2][1][n], p), n
    jskipped = jmsm.REGISTRY.counter("marian_train_updates_skipped_total",
                                     "")
    jbefore = jskipped.value
    jseen = []
    jorig = jgg.GraphGroup.update

    def jspy(self, *a, **k):
        out = jorig(self, *a, **k)
        jseen.append(float(out.skipped))
        return out

    jgg.GraphGroup.update = jspy
    try:
        with jfp.active("train.nan_grad=fail@3"):
            jax_train.main(args(vocab, tmp_path / "j.npz", *extra))
    finally:
        jgg.GraphGroup.update = jorig
    assert jskipped.value - jbefore == 1
    assert jseen == [s[3] for s in seen]


# -- the flight recorder and the fault plane ----------------------------------------

def test_fire_event_and_faultpoints_member_in_a_dump(tmp_path):
    tobs.configure(Options({"trace-dump": str(tmp_path)}))
    with tfp.active("serving.dispatch=fail@1"):
        with pytest.raises(tfp.InjectedFault):
            tfp.fault_point("serving.dispatch")
        path = tobs.FLIGHT.trip("watchdog", detail="drill")
    with open(path) as fh:
        payload = json.load(fh)
    assert payload["faultpoints"] == {"spec": "",
                                      "hits": {"serving.dispatch": 1}}
    fires = [e for e in payload["trace"]["traceEvents"]
             if e["name"] == "fault.fire"]
    assert [e["args"] for e in fires] == [
        {"point": "serving.dispatch", "mode": "fail", "hit": 1}]


KILL_CHILD = """
from marian_tpu_torch import obs
from marian_tpu_torch.common import faultpoints as fp
assert obs.configure(None)
with obs.TRACER.span("last-request", trace_id="dying01"):
    pass
fp.fault_point("serving.dispatch")
print("survived", flush=True)
"""


def test_kill_dumps_the_ring_before_exit_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               **{tfp.ENV_SPEC: "serving.dispatch=kill@1",
                  tobs.ENV_DUMP: str(tmp_path)})
    proc = subprocess.run([sys.executable, "-c", KILL_CHILD], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == tfp.FAULT_EXIT_CODE, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    dumps = sorted(f for f in os.listdir(tmp_path)
                   if f.startswith("flight-"))
    assert len(dumps) == 1 and dumps[0].endswith("fault-kill.json")
    with open(tmp_path / dumps[0]) as fh:
        payload = json.load(fh)
    assert payload["reason"] == "fault-kill"
    assert payload["faultpoints"] == {"spec": "serving.dispatch=kill@1",
                                      "hits": {"serving.dispatch": 1}}
    spans = [e for e in payload["trace"]["traceEvents"]
             if e["name"] == "last-request"]
    assert spans and spans[0]["args"]["trace_id"] == "dying01"
