"""Crash safety of the port's trainer under real kills, on the CPU
(the counterpart of ``tests/test_trainer_robustness.py::TestCrashResume``):

``python -m marian_tpu_torch.cli.marian_train --cpu-threads 1`` runs as a
subprocess with ``MARIAN_FAULTS=<point>=kill@<hit>``, for each of the
checkpoint bundle's points (``ckpt.write.model``, ``.optimizer``,
``.progress``, ``.manifest``, ``ckpt.commit``, ``ckpt.publish``: the
second save, at update 4) and the batch pipeline's
(``data.batch.next``: before the fourth batch). Each case holds that

- the process exits with 117 (``FAULT_EXIT_CODE``), before its last
  update;
- every committed bundle under ``<model>.bundles/`` validates, and no
  staging directory is listed as a bundle;
- a restart with the same flags resumes from the newest valid bundle and
  ends with the uninterrupted run's parameters, optimizer state and
  progress (batches, corpus position, Adam step) bit for bit: one thread
  on both sides, and every save at a corpus window boundary
  (``--maxi-batch 1``), where the resume point is exact.

The ``ckpt.commit`` case also runs with ``--trace-dump``: the kill
leaves a flight dump carrying the ``faultpoints`` member and the
``fault.fire`` event of ``ckpt.commit``.
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from marian_tpu_torch.cli import marian_train
from marian_tpu_torch.common import faultpoints as fp
from marian_tpu_torch.common.io import load_model
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.training import bundle as bdl

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"
UPDATES = 5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("crash_vocab")
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    DefaultVocab.build(lines).save(str(d / "v.yml"))
    return d / "v.yml"


def args(vocab, model, *extra):
    return ["--type", "transformer", "--train-sets", str(DATA / "train.src"),
            str(DATA / "train.trg"), "--vocabs", str(vocab), str(vocab),
            "--model", str(model), "--dim-emb", "16",
            "--transformer-heads", "2", "--transformer-dim-ffn", "32",
            "--enc-depth", "1", "--dec-depth", "1", "--tied-embeddings-all",
            "--learn-rate", "0.01", "--mini-batch", "16", "--maxi-batch",
            "1", "--max-length", "24", "--seed", "1234", "--disp-freq", "1",
            "--save-freq", "2", "--after-batches", str(UPDATES),
            "--overwrite", "--quiet", "--cpu-threads", "1", *extra]


def final_state(model):
    params, _ = load_model(str(model))
    opt = dict(np.load(str(model) + ".optimizer.npz"))
    with open(str(model) + ".progress.yml") as fh:
        prog = yaml.safe_load(fh)
    return params, opt, prog


@pytest.fixture(scope="module")
def uninterrupted(vocab, tmp_path_factory):
    model = tmp_path_factory.mktemp("crash_ref") / "m.npz"
    marian_train.main(args(vocab, model))
    return final_state(model)


CASES = [("ckpt.write.model", 2), ("ckpt.write.optimizer", 2),
         ("ckpt.write.progress", 2), ("ckpt.write.manifest", 2),
         ("ckpt.commit", 2), ("ckpt.publish", 2), ("data.batch.next", 4)]


@pytest.mark.parametrize("point,hit", CASES, ids=[c[0] for c in CASES])
def test_kill_leaves_no_torn_bundle_and_resumes_bit_exact(
        point, hit, vocab, uninterrupted, tmp_path):
    model = tmp_path / "m.npz"
    dump = tmp_path / "dumps"
    extra = ["--trace-dump", str(dump)] if point == "ckpt.commit" else []
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               **{fp.ENV_SPEC: f"{point}=kill@{hit}"})
    proc = subprocess.run(
        [sys.executable, "-m", "marian_tpu_torch.cli.marian_train",
         *args(vocab, model, *extra)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == fp.FAULT_EXIT_CODE, proc.stderr[-2000:]
    assert f"FAULTPOINT {point} hit {hit}: killing process" in proc.stderr
    root = bdl.bundle_root(str(model))
    names = bdl.list_bundles(root)
    committed = {"ckpt.write.model": 1, "ckpt.write.optimizer": 1,
                 "ckpt.write.progress": 1, "ckpt.write.manifest": 1,
                 "ckpt.commit": 1, "ckpt.publish": 2,
                 "data.batch.next": 1}[point]
    assert len(names) == committed
    for n in names:
        ok, why, _ = bdl.validate_bundle(os.path.join(root, n))
        assert ok, (n, why)
    stray = [n for n in os.listdir(root) if n not in names]
    assert all(n.startswith(".staging-") for n in stray)
    if point == "ckpt.commit":
        dumps = sorted(glob.glob(str(dump / "flight-*fault-kill.json")))
        assert len(dumps) == 1
        with open(dumps[0]) as fh:
            payload = json.load(fh)
        assert payload["faultpoints"]["spec"] == "ckpt.commit=kill@2"
        assert payload["faultpoints"]["hits"]["ckpt.commit"] == 2
        fires = [e for e in payload["trace"]["traceEvents"]
                 if e.get("name") == "fault.fire"]
        assert [e["args"]["point"] for e in fires] == ["ckpt.commit"]
    assert fp.ENV_SPEC not in os.environ
    marian_train.main(args(vocab, model))
    params, opt, prog = final_state(model)
    want_params, want_opt, want_prog = uninterrupted
    assert prog["batches"] == want_prog["batches"] == UPDATES
    assert prog == want_prog
    assert sorted(params) == sorted(want_params)
    for k in want_params:
        assert np.array_equal(params[k], want_params[k]), k
    assert sorted(opt) == sorted(want_opt)
    for k in want_opt:
        assert np.array_equal(opt[k], want_opt[k]), k


def test_global_norm_sums_in_the_jax_leaf_order():
    """The repair behind the bit-exact resume: a checkpoint's parameters
    come back name-sorted, a fresh init's in creation order, and the
    gradient norm (and so the clip) summed them in dict order."""
    import jax.numpy as jnp

    from marian_tpu.ops.ops import global_norm as jnorm
    from marian_tpu_torch.ops.ops import global_norm
    rng = np.random.RandomState(0)
    names = [f"p{i:02d}" for i in range(40)]
    arrs = {n: (rng.randn(7, 5) * 10.0 ** rng.randint(-4, 4)).astype(
        np.float32) for n in names}
    fwd = {n: torch.from_numpy(arrs[n]) for n in reversed(names)}
    srt = {n: torch.from_numpy(arrs[n]) for n in names}
    assert global_norm(fwd).item() == global_norm(srt).item()
    want = np.float32(jnorm({n: jnp.asarray(a) for n, a in arrs.items()}))
    np.testing.assert_allclose(global_norm(srt).numpy(), want, rtol=1e-6)


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
