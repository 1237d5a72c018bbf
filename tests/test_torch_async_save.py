"""``--async-save`` in the port (``training/checkpoint.py::AsyncSaver``)
against the JAX package's, on the CPU, after
``tests/test_async_save.py::TestAsyncSave`` and
``TestInjectedSaveFailures``:

- an async save writes the same tensors and the same progress file as a
  sync save of the same moment (the npz files differ only in their zip
  entries' times, so tensors are compared, exactly);
- the snapshot is the moment of the save, although the next updates
  write the same parameters and optimizer state in place;
- a save that fails on the worker raises at ``wait()``, and the saver
  takes the next save;
- ``ckpt.async.worker=fail`` raises at ``wait()`` and leaves no bundle;
  ``ckpt.async.worker=kill@2`` in a trainer subprocess exits 117 with
  the first save's bundle valid, and an unarmed restart resumes from it;
- a port async bundle loads in the JAX loader with equal parameters and
  optimizer state, and a JAX async bundle in the port's;
- the trainer under --async-save: the SIGTERM save and the exit-
  immediately path return only once the save in flight is on disk.
"""

import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from marian_tpu.common import Options as JOptions
from marian_tpu.common import prng
from marian_tpu.common import faultpoints as jfp
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.training import checkpoint as jckpt
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu.training.training_state import TrainingState as JState
from marian_tpu_torch.cli import marian_train as torch_train
from marian_tpu_torch.common import faultpoints as tfp
from marian_tpu_torch.common import signal_handling
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.training import bundle as tbdl
from marian_tpu_torch.training import checkpoint as tckpt
from marian_tpu_torch.training import train as train_mod
from marian_tpu_torch.training.checkpoint import (AsyncSaver,
                                                  load_checkpoint,
                                                  save_checkpoint)
from marian_tpu_torch.training.graph_group import GraphGroup
from marian_tpu_torch.training.training_state import TrainingState
from tests.test_torch_train_sigterm import DATA, batches, train_args

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = {"type": "transformer", "dim-emb": 16, "transformer-heads": 2,
        "transformer-dim-ffn": 32, "enc-depth": 1, "dec-depth": 1,
        "tied-embeddings-all": True, "label-smoothing": 0.0,
        "precision": ["float32", "float32"], "max-length": 16,
        "learn-rate": 0.05, "optimizer": "adam", "clip-norm": 0.0,
        "exponential-smoothing": 1e-3}
WAIT_S = 300


@pytest.fixture(autouse=True)
def _disarmed():
    tfp.reset_for_tests()
    jfp.reset_for_tests()
    try:
        yield
    finally:
        tfp.reset_for_tests()
        jfp.reset_for_tests()


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    trainer run in this process enables the port's perf plane (the
    parser defaults --perf-accounting on); disable it again after every
    test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()


def _gg(**over):
    opts = Options({**TINY, **over})
    gg = GraphGroup(create_model(opts, 64, 64), opts, torch.device("cpu"))
    from marian_tpu_torch.models import transformer as T
    gg.initialize(T.init_params(gg.model.cfg, 7))
    return gg


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {"src_ids": torch.from_numpy(rs.randint(2, 64, (8, 6))),
            "src_mask": torch.ones(8, 6),
            "trg_ids": torch.from_numpy(rs.randint(2, 64, (8, 7))),
            "trg_mask": torch.ones(8, 7)}


def _tensors(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_tensors(a, b):
    a, b = _tensors(a), _tensors(b)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_async_bundle_equals_the_sync_one(tmp_path, state_dtype):
    gg = _gg(**{"optimizer-state-dtype": state_dtype})
    for i in range(3):
        gg.update(_batch(i), i + 1)
    state = TrainingState(batches=3)
    sp, ap = str(tmp_path / "sync.npz"), str(tmp_path / "async.npz")
    save_checkpoint(sp, gg.export_params(), "x: 1\n", gg, state,
                    smooth_params=gg.smoothed(),
                    extra_model_suffixes=(".iter3",))
    saver = AsyncSaver()
    save_checkpoint(ap, gg.export_params(), "x: 1\n", gg, state,
                    smooth_params=gg.smoothed(),
                    extra_model_suffixes=(".iter3",), async_saver=saver)
    saver.close()
    for suffix in ("", ".optimizer.npz"):
        _assert_same_tensors(ap + suffix, sp + suffix)
    for name in ("async.ema.npz", "async.iter3.npz"):
        _assert_same_tensors(tmp_path / name,
                             tmp_path / name.replace("async", "sync"))
    assert (tmp_path / "async.npz.progress.yml").read_text() == \
        (tmp_path / "sync.npz.progress.yml").read_text()
    ok, why, _ = tbdl.validate_bundle(
        str(tmp_path / "async.npz.bundles" / "bundle-00000001"))
    assert ok, why


def test_snapshot_survives_the_next_in_place_updates(tmp_path):
    gg = _gg()
    gg.update(_batch(0), 1)
    ref = {k: v.detach().clone() for k, v in gg.export_params().items()}
    ref_opt = {k: v.copy() for k, v in gg.optimizer_arrays().items()}
    saver = AsyncSaver()
    ap = str(tmp_path / "m.npz")
    save_checkpoint(ap, gg.export_params(), "x: 1\n", gg, None,
                    async_saver=saver)
    # the optimizer writes the same tensors before the worker reads them
    for i in range(1, 4):
        gg.update(_batch(i), i + 1)
    saver.wait()
    got = _tensors(ap)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    got_opt = _tensors(ap + ".optimizer.npz")
    for k, v in ref_opt.items():
        np.testing.assert_array_equal(got_opt[k], v, err_msg=k)
    assert float(got_opt["t"]) == 1.0 and float(gg.opt_state["t"]) == 4.0
    assert any(not torch.equal(v, ref[k])
               for k, v in gg.export_params().items())


def test_failed_save_raises_at_wait_and_the_saver_goes_on(tmp_path):
    gg = _gg()
    saver = AsyncSaver()
    save_checkpoint(str(tmp_path / "no_such_dir" / "m.npz"),
                    gg.export_params(), "x: 1\n", None, None,
                    async_saver=saver)
    with pytest.raises(OSError):
        saver.wait()
    ok = str(tmp_path / "ok.npz")
    save_checkpoint(ok, gg.export_params(), "x: 1\n", None, None,
                    async_saver=saver)
    saver.close()
    params, cfg, _ = load_checkpoint(ok)
    assert cfg == "x: 1\n" and sorted(params) == sorted(gg.params)


def test_async_worker_fail_raises_at_wait(tmp_path):
    gg = _gg()
    mp = str(tmp_path / "m.npz")
    saver = AsyncSaver()
    with tfp.active("ckpt.async.worker=fail"):
        save_checkpoint(mp, gg.export_params(), "x: 1\n", gg,
                        TrainingState(batches=1), async_saver=saver)
        with pytest.raises(tfp.InjectedFault):
            saver.wait()
    assert tbdl.list_bundles(tbdl.bundle_root(mp)) == []
    save_checkpoint(mp, gg.export_params(), "x: 1\n", gg,
                    TrainingState(batches=1), async_saver=saver)
    saver.close()
    assert len(tbdl.list_bundles(tbdl.bundle_root(mp))) == 1


def test_async_worker_kill_exits_117_with_the_previous_bundle(tmp_path):
    """The kill fires on the worker thread and ends the process with the
    fault exit code; the first save's bundle stays valid, and the
    restart resumes from it to the end."""
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    from marian_tpu_torch.data.vocab import DefaultVocab
    DefaultVocab.build(lines).save(str(tmp_path / "v.yml"))
    argv = [sys.executable, "-m", "marian_tpu_torch.cli.marian_train",
            *train_args(tmp_path, "m.npz", "--after-batches", "4",
                        "--save-freq", "2", "--async-save", "--overwrite",
                        "--maxi-batch", "1", "--cpu-threads", "1")]
    env = {**os.environ, tfp.ENV_SPEC: "ckpt.async.worker=kill@2"}
    proc = subprocess.run(argv, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=WAIT_S)
    assert proc.returncode == tfp.FAULT_EXIT_CODE, proc.stderr[-2000:]
    assert "FAULTPOINT ckpt.async.worker hit 2: killing process" \
        in proc.stderr
    root = tbdl.bundle_root(str(tmp_path / "m.npz"))
    names = tbdl.list_bundles(root)
    assert names == ["bundle-00000001"]
    ok, why, manifest = tbdl.validate_bundle(os.path.join(root, names[0]))
    assert ok, why
    assert manifest["meta"]["batches"] == 2
    env.pop(tfp.ENV_SPEC)
    proc = subprocess.run(argv, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert batches(tmp_path / "m.npz.progress.yml") == 4


def _jax_gg():
    opts = JOptions({**TINY, "seed": 7})
    gg = JGraphGroup(jax_model(opts, 64, 64), opts)
    gg.initialize(prng.root_key(7))
    return gg


def test_a_port_async_bundle_loads_in_the_jax_loader(tmp_path):
    gg = _gg()
    for i in range(2):
        gg.update(_batch(i), i + 1)
    mp = str(tmp_path / "m.npz")
    saver = AsyncSaver()
    save_checkpoint(mp, gg.export_params(), "x: 1\n", gg,
                    TrainingState(batches=2), async_saver=saver)
    saver.close()
    jgg = _jax_gg()
    params, _, state = jckpt.load_checkpoint(mp, jgg)
    assert state.batches == 2
    for k, v in gg.export_params().items():
        np.testing.assert_array_equal(params[k], v.numpy(), err_msg=k)
    want = gg.optimizer_arrays()
    got = jgg.optimizer_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_jax_async_bundle_loads_in_the_port_loader(tmp_path):
    jgg = _jax_gg()
    mp = str(tmp_path / "m.npz")
    saver = jckpt.AsyncSaver()
    st = JState()
    st.batches = 3
    jckpt.save_checkpoint(mp, jgg.export_params(), "x: 1\n", jgg, st,
                          async_saver=saver)
    saver.wait()
    gg = _gg()
    params, _, state = load_checkpoint(mp, gg)
    assert state.batches == 3
    for k, v in jgg.export_params().items():
        np.testing.assert_array_equal(params[k], np.asarray(v), err_msg=k)
    want = jgg.optimizer_arrays()
    got = gg.optimizer_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.fixture
def handlers_restored():
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    yield
    signal_handling.clear_signal_flags()
    for s, h in before.items():
        signal.signal(s, h)


@pytest.fixture
def slow_writes(monkeypatch):
    """Every checkpoint write starts 0.3 s late, so a save is still in
    flight when the trainer reaches its exit; records when each ended."""
    ended = []
    write = tckpt._write_checkpoint

    def slow(*args, **kw):
        time.sleep(0.3)
        write(*args, **kw)
        ended.append(time.monotonic())
    monkeypatch.setattr(tckpt, "_write_checkpoint", slow)
    return ended


def _validated(model):
    root = tbdl.bundle_root(str(model))
    names = tbdl.list_bundles(root)
    for n in names:
        ok, why, _ = tbdl.validate_bundle(os.path.join(root, n))
        assert ok, why
    return names


@pytest.mark.parametrize("sigterm", ["save-and-exit", "exit-immediately"])
def test_the_trainer_exits_after_the_save_in_flight(
        tmp_path, handlers_restored, slow_writes, sigterm):
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    from marian_tpu_torch.data.vocab import DefaultVocab
    DefaultVocab.build(lines).save(str(tmp_path / "v.yml"))
    signal_handling._flags[signal.SIGTERM] = True
    torch_train.main(train_args(tmp_path, "m.npz", "--after-batches",
                                "1000", "--save-freq", "1", "--async-save",
                                "--sigterm", sigterm, "--cpu-threads", "1"))
    returned = time.monotonic()
    assert slow_writes and max(slow_writes) < returned
    names = _validated(tmp_path / "m.npz")
    # save-and-exit: the save of update 1, the SIGTERM save and the one
    # at the end; exit-immediately: the save of update 1 only
    assert len(names) == (3 if sigterm == "save-and-exit" else 1)
    assert batches(tmp_path / "m.npz.progress.yml") == 1


def test_async_save_is_no_longer_refused():
    assert "async-save" not in train_mod._UNPORTED
