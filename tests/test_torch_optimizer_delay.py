"""--optimizer-delay in the port against the JAX package on the CPU, on
the golden tiny config of tests/test_torch_train.py (2+2 layers, dim
32, tied embeddings, label smoothing 0.1, ce-mean-words, Adam, clip-norm
1) without dropout, from identical parameters on identical batches.

- ``GraphGroup.update`` on a list of 2 or 4 micro-batches against the
  JAX ``GraphGroup.update``'s split path (per-micro-batch gradients
  summed in f32, one update tail), for 2 updates: the mean CE of the
  first update to 2e-5 (only f32 summation order separates the two),
  of the second and the gradient norms to 1e-4, and each update's
  change of the parameters, over all leaves as one vector, to 2e-4 of
  its norm (``_bk`` excluded: its gradient is zero in exact arithmetic,
  and Adam's sign-like first step turns its noise into full steps).
- Delay 2 equals one update on the two micro-batches concatenated
  (tests/test_training.py::test_optimizer_delay_equivalent_to_big_batch,
  at its tolerances), in the port alone.
- At ``--precision bfloat16 float32 --gradient-dtype bfloat16`` (SGD,
  so the update is the clipped gradient) the delay-2 update agrees with
  the reference's to 2^-7 of its norm and the loss to 1e-5, the
  tolerances of tests/test_torch_bf16_train.py (the reference runs in a
  subprocess with XLA's excess precision off); the gradients reach the
  update tail summed in f32 although each micro-batch's are bf16.
- ``marian_train`` on an epoch of 5 micro-batches at delay 2 makes 2
  updates and drops the fifth batch, as the JAX trainer does.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from marian_tpu.common import Options, prng
from marian_tpu.data import BatchGenerator, Corpus
from marian_tpu.models.encoder_decoder import (batch_to_arrays as
                                               jax_batch_to_arrays)
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.parallel import mesh as M
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                     create_model)
from marian_tpu_torch.training import graph_group as tgg_mod
from marian_tpu_torch.training.graph_group import GraphGroup
from tests.test_torch_bf16_train import BF16, GRAD_REL, LOSS_RTOL, _vocab
from tests.test_torch_train import GOLDEN, PATHS, SEED

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
UPDATES = 2


def _setup(cfg, delay: int, n_batches: int):
    """(JAX GraphGroup on its split delay path, port GraphGroup from the
    JAX init, ``n_batches`` batches of the golden corpus)."""
    cfg = {**cfg, "optimizer-delay": delay, "transformer-dropout": 0.0}
    opts = Options(cfg)
    vocab = _vocab()
    jgg = JGraphGroup(jax_model(opts, vocab, vocab), opts,
                      mesh=M.make_mesh(opts, jax.devices()[:1]))
    jgg.initialize(prng.stream(prng.root_key(SEED), prng.STREAM_INIT))
    jgg._fused_delay = None          # the host loop over micro-batches
    tgg = GraphGroup(create_model(TOptions(cfg), len(vocab), len(vocab)),
                     TOptions(cfg), torch.device("cpu"))
    tgg.initialize({k: np.asarray(v) for k, v in
                    jgg.export_params().items()})
    assert tgg.delay == delay
    batches = []
    corpus = Corpus(PATHS, [vocab, vocab], opts)
    while len(batches) < n_batches:
        batches += list(BatchGenerator(corpus, opts, prefetch=False))
    return jgg, tgg, batches[:n_batches]


def _rel(got, ref):
    num = sum(float(np.sum((np.float64(got[k]) - np.float64(ref[k])) ** 2))
              for k in ref)
    den = sum(float(np.sum(np.float64(ref[k]) ** 2)) for k in ref)
    return (num / den) ** 0.5


def _params(gg):
    """Copies: the port updates its parameters in place."""
    return {k: np.array(v, np.float32) for k, v in
            gg.export_params().items()}


@pytest.mark.parametrize("delay", [2, 4])
def test_delay_update_matches_jax_split_path(delay):
    jgg, tgg, batches = _setup(GOLDEN, delay, delay * UPDATES)
    key = prng.stream(prng.root_key(SEED), prng.STREAM_DROPOUT)
    for u in range(UPDATES):
        group = batches[u * delay:(u + 1) * delay]
        jp0, tp0 = _params(jgg), _params(tgg)
        jo = jgg.update([jax_batch_to_arrays(b) for b in group], u + 1, key)
        to = tgg.update([batch_to_arrays(b, "cpu") for b in group], u + 1)
        assert float(to.labels) == float(jo.labels) \
            == sum(b.words for b in group)
        np.testing.assert_allclose(
            float(to.loss_sum) / float(to.labels),
            float(jo.loss_sum) / float(jo.labels),
            rtol=2e-5 if u == 0 else 1e-4)
        np.testing.assert_allclose(float(to.grad_norm), float(jo.grad_norm),
                                   rtol=1e-4)
        jp, tp = _params(jgg), _params(tgg)
        keys = [k for k in jp if not k.endswith("_bk")]
        rel = _rel({k: tp[k] - tp0[k] for k in keys},
                   {k: jp[k] - jp0[k] for k in keys})
        assert rel <= 2e-4, (u, rel)


def test_delay_equals_one_big_batch():
    """The port's counterpart of tests/test_training.py ::
    test_optimizer_delay_equivalent_to_big_batch (ce-mean-words)."""
    _, _, batches = _setup(GOLDEN, 2, 2)
    arrays = [batch_to_arrays(b, "cpu") for b in batches]
    jinit = _params(_setup(GOLDEN, 1, 1)[0])

    def run(delay, feed):
        cfg = {**GOLDEN, "optimizer-delay": delay,
               "transformer-dropout": 0.0}
        n = len(_vocab())
        gg = GraphGroup(create_model(TOptions(cfg), n, n), TOptions(cfg),
                        torch.device("cpu"))
        gg.initialize(jinit)
        gg.update(feed, 1)
        return _params(gg)

    def cat(k):
        a, b = arrays[0][k], arrays[1][k]
        w = max(a.shape[1], b.shape[1])
        return torch.cat([torch.nn.functional.pad(a, (0, w - a.shape[1])),
                          torch.nn.functional.pad(b, (0, w - b.shape[1]))])

    p_delay = run(2, arrays)
    p_cat = run(1, {k: cat(k) for k in arrays[0]})
    for k in p_delay:
        if k.endswith("_bk"):
            continue
        np.testing.assert_allclose(p_delay[k], p_cat[k], rtol=5e-3,
                                   atol=5e-5, err_msg=k)


# the reference's delay-2 update in a process of its own, rounding each
# bf16 op as written (tests/test_torch_bf16_train.py)
_JAX_DELAY_UPDATE = """
import json, sys
import numpy as np
from marian_tpu.common import prng
from marian_tpu.models.encoder_decoder import batch_to_arrays
from tests.test_torch_optimizer_delay import _setup, _params, SEED
cfg, out = json.loads(sys.argv[1]), sys.argv[2]
jgg, _, batches = _setup(cfg, 2, 2)
p0 = _params(jgg)
key = prng.stream(prng.root_key(SEED), prng.STREAM_DROPOUT)
jo = jgg.update([batch_to_arrays(b) for b in batches], 1, key)
p1 = _params(jgg)
np.savez(out, loss_sum=np.float32(jo.loss_sum),
         **{"p0:" + k: v for k, v in p0.items()},
         **{"p1:" + k: v for k, v in p1.items()})
"""


def test_bf16_delay_update_matches_jax(monkeypatch, tmp_path):
    cfg = {**BF16, "optimizer": "sgd", "gradient-dtype": "bfloat16"}
    out = tmp_path / "j.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", _JAX_DELAY_UPDATE,
                    json.dumps(cfg), str(out)], env=env, cwd=ROOT,
                   check=True, timeout=600)
    with np.load(out) as z:
        jloss = float(z["loss_sum"])
        p0 = {k[3:]: z[k] for k in z.files if k.startswith("p0:")}
        jp = {k[3:]: z[k] for k in z.files if k.startswith("p1:")}
    _, tgg, batches = _setup(cfg, 2, 2)
    assert tgg.grad_dtype == torch.bfloat16
    micro, tail = [], []
    loss = tgg.model.loss

    def loss_spy(params, *args, **kw):
        micro.extend({p.dtype for p in params.values()})
        return loss(params, *args, **kw)

    finalize = tgg_mod.finalize_update

    def finalize_spy(opt_cfg, opt_state, params, grads, *args):
        tail.extend(g.dtype for g in grads.values())
        return finalize(opt_cfg, opt_state, params, grads, *args)
    monkeypatch.setattr(tgg.model, "loss", loss_spy)
    monkeypatch.setattr(tgg_mod, "finalize_update", finalize_spy)
    for k, p in _params(tgg).items():
        assert np.array_equal(p, p0[k]), k
    to = tgg.update([batch_to_arrays(b, "cpu") for b in batches], 1)
    np.testing.assert_allclose(float(to.loss_sum), jloss, rtol=LOSS_RTOL)
    assert set(micro) == {torch.bfloat16}       # bf16 micro-batch grads
    assert set(tail) == {torch.float32}         # summed in f32
    tp = _params(tgg)
    rel = _rel({k: tp[k] - p0[k] for k in p0}, {k: jp[k] - p0[k] for k in p0})
    assert rel <= GRAD_REL, rel


def test_short_group_at_epoch_end_is_dropped(tmp_path):
    """10 lines at --mini-batch 2 without shuffling: 5 batches an epoch,
    so one epoch at delay 2 is 2 updates in both trainers."""
    from marian_tpu.training.train import Train as JTrain
    from marian_tpu.common.config_parser import parse_options as jparse
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.training.train import Train
    lines = pathlib.Path(PATHS[0]).read_text().splitlines()[:10]
    for side in ("src", "trg"):
        (tmp_path / f"t.{side}").write_text("\n".join(lines) + "\n")
    _vocab().save(str(tmp_path / "v.yml"))

    def argv(name):
        return ["--type", "transformer", "--train-sets",
                str(tmp_path / "t.src"), str(tmp_path / "t.trg"),
                "--vocabs", str(tmp_path / "v.yml"), str(tmp_path / "v.yml"),
                "--model", str(tmp_path / name), "--dim-emb", "16",
                "--transformer-heads", "2", "--transformer-dim-ffn", "16",
                "--enc-depth", "1", "--dec-depth", "1", "--mini-batch", "2",
                "--maxi-batch", "1", "--shuffle", "none",
                "--optimizer-delay", "2", "--after-epochs", "1",
                "--disp-freq", "1"]
    tr = Train(parse_options(argv("t.npz") + ["--cpu-threads", "1"],
                             mode="training"))
    tr.run()
    jtr = JTrain(jparse(argv("j.npz"), mode="training"))
    jtr.run()
    jstate = json.loads(json.dumps(
        __import__("yaml").safe_load((tmp_path / "j.npz.progress.yml")
                                     .read_text())))
    assert tr.state.epochs == jstate["epochs"] == 1
    assert tr.state.batches == jstate["batches"] == 2
    assert tr.state.labels_total == jstate["labels_total"]


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
