"""The port's mixed-precision training against the JAX package on the CPU,
on the golden tiny config of tests/test_torch_train.py (2+2 layers, dim
32, tied embeddings, label smoothing 0.1, ce-mean-words) at
``--precision bfloat16 float32``, from identical f32 master weights on
identical batches.

- The loss of a batch agrees to rtol 1e-5: the bf16 forward rounds at
  the same places in both packages (its encoder output is bit-identical).
- Gradients are held as one vector, to 2^-7 of its norm (two bf16
  roundings): the reference's CPU backend accumulates the transpose of a
  broadcast (the bias gradients) in bf16, where the port accumulates in
  f32 (measured: 3.5e-3 of the norm). The gradients reach the f32 master
  weights as f32.
- An SGD update from those gradients agrees to the same 2^-7 of its
  norm (SGD's step is the clipped gradient; Adam's first step is its
  sign, which rounding noise flips on gradients that are zero in exact
  arithmetic). The reference's update is one jitted program, and XLA's
  CPU backend keeps f32 between the bf16 ops it fuses where PyTorch
  rounds each op; so it runs in a subprocess with
  ``XLA_FLAGS=--xla_allow_excess_precision=false``, which rounds as the
  ops say (the loss then agrees to the last bit; without the flag, to
  2.6e-4).
- Adam's update from identical gradients, f32 math with m stored in f32
  or bf16 (--optimizer-state-dtype), agrees to 1e-6 of each value, and a
  bf16 m equals the reference's bit for bit.
- --gradient-dtype bfloat16 differentiates the bf16 copy of the weights,
  so the gradients come out bf16; at f32 compute the flag is ignored
  with the reference's warning.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common import Options, prng
from marian_tpu.data import BatchGenerator, Corpus
from marian_tpu.data.vocab import DefaultVocab
from marian_tpu.models.encoder_decoder import (batch_to_arrays as
                                               jax_batch_to_arrays)
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.optimizers.optimizers import OptimizerConfig as JOptConfig
from marian_tpu.optimizers.optimizers import init_state as jinit_state
from marian_tpu.parallel import mesh as M
from marian_tpu.parallel.zero import finalize_update as jfinalize_update
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                     create_model)
from marian_tpu_torch.optimizers import optimizers as topt
from marian_tpu_torch.training import graph_group as tgg_mod
from marian_tpu_torch.training.graph_group import GraphGroup
from tests.test_torch_train import GOLDEN, PATHS, SEED

torch.set_num_threads(2)

BF16 = {**GOLDEN, "precision": ["bfloat16", "float32"]}
LOSS_RTOL = 1e-5
GRAD_REL = 2.0 ** -7          # of the gradient's (or update's) norm
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-9


ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's GraphGroup update, in a process of its own (see above)
_JAX_UPDATE = """
import json, sys
import jax, numpy as np
from marian_tpu.common import Options, prng
from marian_tpu.models.encoder_decoder import batch_to_arrays
from tests.test_torch_bf16_train import _setup, SEED
cfg, out = json.loads(sys.argv[1]), sys.argv[2]
jgg, _, batch = _setup(cfg, port=False)
p0 = {k: np.asarray(v) for k, v in jgg.export_params().items()}
key = prng.stream(prng.root_key(SEED), prng.STREAM_DROPOUT)
jo = jgg.update(batch_to_arrays(batch), 1, key)
p1 = {k: np.asarray(v) for k, v in jgg.export_params().items()}
np.savez(out, loss_sum=np.float32(jo.loss_sum),
         **{"p0:" + k: v for k, v in p0.items()},
         **{"p1:" + k: v for k, v in p1.items()})
"""


def jax_update_rounding_as_written(cfg, out: pathlib.Path):
    """(loss_sum, params before, params after) of one JAX GraphGroup
    update of ``cfg``, run with XLA's excess precision off."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", _JAX_UPDATE, json.dumps(cfg),
                    str(out)], env=env, cwd=ROOT, check=True, timeout=600)
    with np.load(out) as z:
        return (float(z["loss_sum"]),
                {k[3:]: z[k] for k in z.files if k.startswith("p0:")},
                {k[3:]: z[k] for k in z.files if k.startswith("p1:")})


def _vocab():
    lines = [l for p in PATHS for l in pathlib.Path(p).read_text()
             .splitlines()]
    return DefaultVocab.build(lines)


def _setup(cfg, port=True):
    """(JAX GraphGroup, port GraphGroup or None, one batch) from the JAX
    init."""
    opts = Options(cfg)
    vocab = _vocab()
    jgg = JGraphGroup(jax_model(opts, vocab, vocab), opts,
                      mesh=M.make_mesh(opts, jax.devices()[:1]))
    jgg.initialize(prng.stream(prng.root_key(SEED), prng.STREAM_INIT))
    tgg = None
    if port:
        tgg = GraphGroup(create_model(TOptions(cfg), len(vocab), len(vocab)),
                         TOptions(cfg), torch.device("cpu"))
        tgg.initialize({k: np.asarray(v) for k, v in
                        jgg.export_params().items()})
    corpus = Corpus(PATHS, [vocab, vocab], opts)
    batch = next(iter(BatchGenerator(corpus, opts, prefetch=False)))
    return jgg, tgg, batch


def _rel_norm(got, ref):
    """||got - ref|| / ||ref|| over every leaf as one vector."""
    num = sum(float(np.sum((np.float64(got[k]) - np.float64(ref[k])) ** 2))
              for k in ref)
    den = sum(float(np.sum(np.float64(ref[k]) ** 2)) for k in ref)
    return (num / den) ** 0.5


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("fused_ce", ["auto", "on"])
def test_bf16_loss_and_gradients_match_jax(fused_ce):
    """``auto``: the dense logits through ``logits_matmul`` (both packages
    off the TPU); ``on``: the fused CE in both, its plain versions here
    and the reference's kernels in interpret mode, with the bf16 table
    and the bias cast to f32."""
    jgg, tgg, batch = _setup({**BF16, "fused-ce": fused_ce})
    assert tgg.model.cfg.compute_dtype == torch.bfloat16
    jparams = jgg.export_params()
    (jl, _), jg = jax.value_and_grad(
        lambda p: jgg.model.loss(p, jax_batch_to_arrays(batch), None,
                                 train=False), has_aux=True)(jparams)
    tl, _ = tgg.model.loss(tgg.params, batch_to_arrays(batch, "cpu"), None,
                           train=False)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    assert all(p.grad.dtype == torch.float32 for p in tgg.params.values())
    rel = _rel_norm({k: p.grad.numpy() for k, p in tgg.params.items()},
                    {k: _f32(jg[k]) for k in jg})
    assert rel <= GRAD_REL, rel


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_bf16_sgd_update_matches_jax(grad_dtype, monkeypatch, tmp_path):
    """One GraphGroup update in each package (SGD, clip-norm 1): the same
    loss, the update within 2^-7 of its norm; under --gradient-dtype
    bfloat16 the port's gradients reach the update tail in bf16."""
    cfg = {**BF16, "optimizer": "sgd", "gradient-dtype": grad_dtype}
    jloss, p0, jp = jax_update_rounding_as_written(cfg, tmp_path / "j.npz")
    _, tgg, batch = _setup(cfg)
    seen = []
    tail = tgg_mod.finalize_update

    def spy(opt_cfg, opt_state, params, grads, *args):
        seen.extend(g.dtype for g in grads.values())
        return tail(opt_cfg, opt_state, params, grads, *args)
    monkeypatch.setattr(tgg_mod, "finalize_update", spy)
    for k, p in tgg.params.items():
        assert np.array_equal(p.detach().numpy(), p0[k]), k
    to = tgg.update(batch_to_arrays(batch, "cpu"), 1)
    np.testing.assert_allclose(float(to.loss_sum), jloss, rtol=LOSS_RTOL)
    want = torch.bfloat16 if grad_dtype == "bfloat16" else torch.float32
    assert set(seen) == {want}
    assert all(p.dtype == torch.float32 for p in tgg.params.values())
    rel = _rel_norm({k: p.detach().numpy() - p0[k]
                     for k, p in tgg.params.items()},
                    {k: jp[k] - p0[k] for k in p0})
    assert rel <= GRAD_REL, rel


def test_gradient_dtype_is_ignored_at_f32_compute(monkeypatch):
    """The reference's warning, and f32 gradients equal to a run without
    the flag."""
    warned = []
    monkeypatch.setattr(tgg_mod.log, "warn",
                        lambda msg, *a: warned.append(msg.format(*a)))
    cfg = {**GOLDEN, "optimizer": "sgd"}
    _, plain, batch = _setup(cfg)
    _, flagged, _ = _setup({**cfg, "gradient-dtype": "bfloat16"})
    assert warned == ["--gradient-dtype bfloat16 ignored: compute precision "
                      "is float32 (set --precision accordingly)"]
    assert flagged.grad_dtype is None
    for gg in (plain, flagged):
        gg.update(batch_to_arrays(batch, "cpu"), 1)
    for k, p in plain.params.items():
        assert torch.equal(p, flagged.params[k]), k


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adam_update_from_identical_gradients_matches_jax(state_dtype):
    """Two Adam updates of the reference's update tail and the port's from
    the same bf16 gradients: parameters and v to 1e-6, m stored in the
    asked dtype and equal to the reference's."""
    opts = {**BF16, "optimizer-state-dtype": state_dtype,
            "optimizer-params": [0.9, 0.98, 1e-9]}
    jcfg = JOptConfig.from_options(Options(opts))
    tcfg = topt.OptimizerConfig.from_options(TOptions(opts))
    rng = np.random.RandomState(7)
    shapes = {"Wemb": (23, 8), "b": (1, 8), "W": (8, 8)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jst, tst = jinit_state(jcfg, jp), topt.init_state(tcfg, tp)
    want = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    assert all(m.dtype == want for m in tst["m"].values())
    labels = jnp.asarray(31.0, jnp.float32)
    for step in range(2):
        g = {k: (rng.randn(*s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        tg = {k: torch.tensor(_f32(v)).bfloat16() for k, v in jg.items()}
        jp, jst, jnorm, _ = jfinalize_update(jcfg, jst, jp, jg, 1e-3, labels,
                                             labels)
        tnorm, _ = tgg_mod.finalize_update(tcfg, tst, tp, tg, 1e-3,
                                           torch.tensor(31.0),
                                           torch.tensor(31.0))
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL, err_msg=k)
        np.testing.assert_allclose(tst["v"][k].numpy(),
                                   np.asarray(jst["v"][k]), rtol=ADAM_RTOL,
                                   atol=ADAM_ATOL, err_msg=k)
        assert str(jst["m"][k].dtype) == state_dtype
        np.testing.assert_allclose(tst["m"][k].float().numpy(),
                                   _f32(jst["m"][k]),
                                   rtol=0 if state_dtype == "bfloat16"
                                   else ADAM_RTOL, atol=ADAM_ATOL,
                                   err_msg=k)
