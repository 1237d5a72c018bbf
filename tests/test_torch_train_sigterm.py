"""SIGTERM during the port's training, on the CPU with a tiny model on
the golden corpus (the flags of tests/test_torch_checkpoint_files.py):

- the reference test's form (``tests/test_training.py::
  test_sigterm_like_save``): with the signal flag set, a run of 1,000
  updates stops after its first update, saves, and returns normally;
  ``.progress.yml`` says it stopped early;
- under ``--sigterm exit-immediately`` it returns without writing a
  model;
- both packages' ``marian_train`` in subprocesses get SIGTERM once each
  log shows 5 updates: both exit 0 and leave the same file names (the
  ``.iter<N>`` number is where each was stopped), the same committed
  bundles under ``m.npz.bundles`` with the same members, and the port's
  run resumes from its saved state for two more updates.

Every subprocess wait has its own timeout, so no run can hang the suite.
"""

import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import pytest
import torch
import yaml

from marian_tpu_torch.cli import marian_train as torch_train
from marian_tpu_torch.common import signal_handling
from marian_tpu_torch.data.vocab import DefaultVocab

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"
UPDATE = re.compile(r"Up\. (\d+) :")
WAIT_S = 300


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("sigterm")
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    DefaultVocab.build(lines).save(str(d / "v.yml"))
    return d


@pytest.fixture
def handlers_restored():
    """The trainer installs SIGTERM/SIGINT handlers in this process: put
    the former ones back and clear the flags afterwards."""
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    yield
    signal_handling.clear_signal_flags()
    for s, h in before.items():
        signal.signal(s, h)


def train_args(d, model, *extra):
    return ["--type", "transformer", "--train-sets", str(DATA / "train.src"),
            str(DATA / "train.trg"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--model", str(d / model), "--dim-emb", "32",
            "--transformer-heads", "4", "--transformer-dim-ffn", "64",
            "--enc-depth", "1", "--dec-depth", "1", "--tied-embeddings-all",
            "--learn-rate", "0.01", "--mini-batch", "16", "--maxi-batch",
            "4", "--max-length", "24", "--seed", "1234", "--disp-freq", "1",
            "--quiet", *extra]


def batches(progress):
    return yaml.safe_load(pathlib.Path(progress).read_text())["batches"]


def test_signal_flag_saves_and_stops(work, handlers_restored):
    (work / "flag").mkdir()
    signal_handling._flags[signal.SIGTERM] = True
    torch_train.main(train_args(work, "flag/m.npz", "--after-batches",
                                "1000", "--cpu-threads", "1"))
    done = batches(work / "flag" / "m.npz.progress.yml")
    assert 1 <= done < 1000      # stopped early but saved
    assert sorted(os.listdir(work / "flag")) == [
        f"m.iter{done}.npz", "m.npz", "m.npz.bundles", "m.npz.optimizer.npz",
        "m.npz.progress.yml"]


def test_exit_immediately_writes_no_model(work, handlers_restored):
    (work / "now").mkdir()
    signal_handling._flags[signal.SIGTERM] = True
    torch_train.main(train_args(work, "now/m.npz", "--after-batches",
                                "1000", "--sigterm", "exit-immediately",
                                "--cpu-threads", "1"))
    assert os.listdir(work / "now") == []


def _updates(log):
    text = log.read_text() if log.exists() else ""
    return max((int(u) for u in UPDATE.findall(text)), default=0)


def test_sigterm_saves_like_the_reference_and_resumes(work):
    runs, logs = {}, []
    for pkg, module, extra in (
            ("jax", "marian_tpu.cli.marian_train", []),
            ("torch", "marian_tpu_torch.cli.marian_train",
             ["--cpu-threads", "1"])):
        (work / pkg).mkdir()
        log = work / f"{pkg}.log"
        logs.append((work / f"{pkg}.err").open("w"))
        proc = subprocess.Popen(
            [sys.executable, "-m", module,
             *train_args(work, f"{pkg}/m.npz", "--after-batches", "100000",
                         "--save-freq", "100000", "--log", str(log),
                         *extra)],
            cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=logs[-1], env={**os.environ, "JAX_PLATFORMS": "cpu"})
        runs[pkg] = (proc, log)
    try:
        pending = dict(runs)
        deadline = time.monotonic() + WAIT_S
        while pending and time.monotonic() < deadline:
            for pkg, (proc, log) in list(pending.items()):
                assert proc.poll() is None, f"{pkg} trainer ended early: " \
                    f"{(work / f'{pkg}.err').read_text()[-2000:]}"
                if _updates(log) >= 5:
                    proc.send_signal(signal.SIGTERM)
                    del pending[pkg]
            time.sleep(0.05)
        assert not pending, f"no 5 updates within {WAIT_S} s: {list(pending)}"
        for pkg, (proc, _) in runs.items():
            proc.wait(timeout=WAIT_S)
            assert proc.returncode == 0, f"{pkg}: rc {proc.returncode}\n" \
                f"{(work / f'{pkg}.err').read_text()[-2000:]}"
    finally:
        for proc, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in logs:
            fh.close()
    names, bundles = {}, {}
    for pkg in runs:
        done = batches(work / pkg / "m.npz.progress.yml")
        assert done >= 5
        names[pkg] = sorted(n.replace(f".iter{done}.", ".iter<N>.")
                            for n in os.listdir(work / pkg))
        root = work / pkg / "m.npz.bundles"
        bundles[pkg] = {b: sorted(os.listdir(root / b))
                        for b in sorted(os.listdir(root))}
    assert names["torch"] == ["m.iter<N>.npz", "m.npz", "m.npz.bundles",
                              "m.npz.optimizer.npz", "m.npz.progress.yml"]
    assert names["jax"] == names["torch"]
    # the SIGTERM save and the save at the end of training: two bundles
    assert bundles["jax"] == bundles["torch"] == {
        f"bundle-0000000{i}": ["MANIFEST.json", "m.npz",
                               "m.npz.optimizer.npz", "m.npz.progress.yml"]
        for i in (1, 2)}
    # the port resumes from what it saved
    done = batches(work / "torch" / "m.npz.progress.yml")
    resume = subprocess.run(
        [sys.executable, "-m", "marian_tpu_torch.cli.marian_train",
         *train_args(work, "torch/m.npz", "--after-batches", str(done + 2),
                     "--log", str(work / "resume.log"),
                     "--cpu-threads", "1")],
        cwd=str(ROOT), capture_output=True, text=True, timeout=WAIT_S)
    assert resume.returncode == 0, resume.stderr[-2000:]
    assert batches(work / "torch" / "m.npz.progress.yml") == done + 2
    ups = [int(u) for u in UPDATE.findall(
        (work / "resume.log").read_text())]
    assert ups == [done + 1, done + 2]


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    trainer run in this process enables the port's perf plane (the
    parser defaults --perf-accounting on), which would change what later
    tests in the process see; disable it again after every test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()
