"""Train-time compression in the port against the JAX package, on the CPU:

- ``quantize_tensor`` (uniform at 2, 4 and 8 bits, log-based, with
  --quantize-optimization-steps, with --quantize-range),
  ``quantize_model`` (biases and one-row tensors skipped unless
  --quantize-biases) and ``drop_gradients`` (the strided-sample
  threshold) against ``marian_tpu.optimizers.compression``: the same
  grid and the same kept entries, values within rtol 1e-6 (the two
  packages' f32 max, std and sums may round apart in the last bits);
- three Adam updates with --quantize-bits 4 and
  --gradient-dropping-rate 0.9 against the reference's ``apply_update``
  from the same parameters and gradients: parameters, moments and the
  ``qerr``/``gerr`` error feedback within rtol 1e-5, atol 1e-7, and the
  optimizer's square root the correctly rounded f32 root;
- the ``qerr:``/``gerr:`` groups resume across the two packages'
  checkpoints both ways, and a checkpoint without them is backfilled
  with zeros when the resuming run turns compression on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common import Options as JOptions
from marian_tpu.common import prng
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.optimizers import compression as jcomp
from marian_tpu.optimizers import optimizers as jopt
from marian_tpu.training import checkpoint as jckpt
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu.training.training_state import TrainingState as JState
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.models import transformer as T
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.optimizers import compression as tcomp
from marian_tpu_torch.optimizers import optimizers as topt
from marian_tpu_torch.training.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from marian_tpu_torch.training.graph_group import GraphGroup
from marian_tpu_torch.training.training_state import TrainingState

torch.set_num_threads(2)

SHAPES = {"Wemb": (40, 16), "encoder_l1_self_Wq": (16, 16),
          "encoder_l1_self_bq": (1, 16), "decoder_ff_logit_out_b": (1, 40),
          "big": (130, 70)}
TINY = {"type": "transformer", "dim-emb": 16, "transformer-heads": 2,
        "transformer-dim-ffn": 32, "enc-depth": 1, "dec-depth": 1,
        "tied-embeddings-all": True, "transformer-ffn-activation": "relu",
        "precision": ["float32", "float32"], "learn-rate": 0.01,
        "quantize-bits": 4, "gradient-dropping-rate": 0.9,
        "optimizer-params": [0.9, 0.98, 1e-9]}


def _tensor(seed, shape=(130, 70)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 0.1).astype(np.float32)


def _close(got, ref, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=1e-9)


@pytest.mark.parametrize("bits,log,steps,qrange", [
    (2, False, 0, 0.0), (4, False, 0, 0.0), (8, False, 0, 0.0),
    (4, True, 0, 0.0), (8, True, 0, 0.0), (4, False, 3, 0.0),
    (8, False, 0, 2.5)])
def test_quantize_tensor_as_the_reference(bits, log, steps, qrange):
    x = _tensor(bits + 10 * steps)
    ref = np.asarray(jcomp.quantize_tensor(jnp.asarray(x), bits, log, steps,
                                           qrange))
    got = tcomp.quantize_tensor(torch.as_tensor(x), bits, log, steps,
                                qrange).numpy()
    _close(got, ref)
    # uniform: 2 x levels + 1 values; log-based: levels + 1 magnitudes a
    # sign, and 0
    levels = 2 ** (bits - 1) - 1
    assert len(np.unique(got)) <= (2 * (levels + 1) + 1 if log
                                   else 2 * levels + 1)
    assert len(np.unique(got)) == len(np.unique(ref))


@pytest.mark.parametrize("biases", [False, True])
def test_quantize_model_as_the_reference(biases):
    p = {k: _tensor(i, s) for i, (k, s) in enumerate(SHAPES.items())}
    e = {k: _tensor(i + 20, s) * 1e-3 for i, (k, s) in
         enumerate(SHAPES.items())}
    rp, re = jcomp.quantize_model({k: jnp.asarray(v) for k, v in p.items()},
                                  {k: jnp.asarray(v) for k, v in e.items()},
                                  4, include_biases=biases)
    gp, ge = tcomp.quantize_model(
        {k: torch.as_tensor(v) for k, v in p.items()},
        {k: torch.as_tensor(v) for k, v in e.items()}, 4,
        include_biases=biases)
    for k in SHAPES:
        _close(gp[k], rp[k])
        np.testing.assert_allclose(ge[k].numpy(), np.asarray(re[k]),
                                   rtol=1e-5, atol=1e-8)
    assert np.array_equal(gp["encoder_l1_self_bq"].numpy(),
                          p["encoder_l1_self_bq"]) != biases


@pytest.mark.parametrize("rate", [0.5, 0.9, 0.99])
def test_drop_gradients_as_the_reference(rate):
    g = {k: _tensor(i, s) for i, (k, s) in enumerate(SHAPES.items())}
    # one tensor past the strided sample's 4,096 entries
    g["large"] = _tensor(9, (300, 50))
    r = {k: _tensor(i + 40, v.shape) * 0.1 for i, (k, v) in
         enumerate(g.items())}
    rg, rr = jcomp.drop_gradients({k: jnp.asarray(v) for k, v in g.items()},
                                  {k: jnp.asarray(v) for k, v in r.items()},
                                  rate)
    gg, gr = tcomp.drop_gradients({k: torch.as_tensor(v) for k, v in
                                   g.items()},
                                  {k: torch.as_tensor(v) for k, v in
                                   r.items()}, rate)
    for k in g:
        assert np.array_equal(gg[k].numpy() != 0, np.asarray(rg[k]) != 0), k
        _close(gg[k], rg[k])
        _close(gr[k], rr[k])


def test_three_updates_as_the_reference_apply_update():
    opts = {"optimizer": "adam", "optimizer-params": [0.9, 0.98, 1e-9],
            "quantize-bits": 4, "gradient-dropping-rate": 0.9}
    jcfg = jopt.OptimizerConfig.from_options(JOptions(opts))
    tcfg = topt.OptimizerConfig.from_options(Options(opts))
    p0 = {k: _tensor(i, s) for i, (k, s) in enumerate(SHAPES.items())}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    jst = jopt.init_state(jcfg, jp)
    tst = topt.init_state(tcfg, tp)
    assert set(tst) == set(jst) == {"t", "m", "v", "qerr", "gerr"}
    for step in range(3):
        g = {k: _tensor(100 + 10 * step + i, s)
             for i, (k, s) in enumerate(SHAPES.items())}
        jst, jp = jopt.apply_update(jcfg, jst, jp,
                                    {k: jnp.asarray(v) for k, v in g.items()},
                                    1e-3)
        topt.apply_update(tcfg, tst, tp,
                          {k: torch.as_tensor(v) for k, v in g.items()},
                          1e-3)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        for part in ("m", "v", "qerr", "gerr"):
            np.testing.assert_allclose(tst[part][k].numpy(),
                                       np.asarray(jst[part][k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{part}:{k}")


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"src_ids": rs.randint(2, 40, (8, 6)).astype(np.int32),
            "src_mask": np.ones((8, 6), np.float32),
            "trg_ids": rs.randint(2, 40, (8, 7)).astype(np.int32),
            "trg_mask": np.ones((8, 7), np.float32)}


def _port_batch(seed):
    return {k: torch.from_numpy(v.astype(np.int64) if "ids" in k else v)
            for k, v in _batch(seed).items()}


def _port_gg(**over):
    opts = Options({**TINY, **over})
    gg = GraphGroup(create_model(opts, 40, 40), opts, torch.device("cpu"))
    gg.initialize(T.init_params(gg.model.cfg, 3))
    return gg


def _jax_gg(**over):
    opts = JOptions({**TINY, "seed": 7, **over})
    gg = JGraphGroup(jax_model(opts, 40, 40), opts)
    gg.initialize(prng.root_key(7))
    return gg


def test_error_feedback_resumes_across_the_packages(tmp_path):
    t = _port_gg()
    for i in range(2):
        t.update(_port_batch(i), i + 1)
    flat = t.optimizer_arrays()
    assert {k.split(":")[0] for k in flat} == {"t", "m", "v", "qerr", "gerr"}
    assert any(np.abs(v).max() > 0 for k, v in flat.items()
               if k.startswith("qerr:"))
    mp = str(tmp_path / "port.npz")
    save_checkpoint(mp, t.export_params(), "x: 1\n", t,
                    TrainingState(batches=2))
    j = _jax_gg()
    jckpt.load_checkpoint(mp, j)
    for part in ("qerr", "gerr"):
        for k, v in t.opt_state[part].items():
            assert np.array_equal(np.asarray(j.opt_state[part][k]),
                                  v.numpy()), f"{part}:{k}"
    # and back: a JAX checkpoint with its own error feedback
    j = _jax_gg()
    for i in range(2):
        j.update({k: jnp.asarray(v) for k, v in _batch(i).items()}, i + 1,
                 jax.random.key(i))
    jp = str(tmp_path / "jax.npz")
    st = JState()
    st.batches = 2
    jckpt.save_checkpoint(jp, j.export_params(), "x: 1\n", j, st)
    t = _port_gg()
    load_checkpoint(jp, t)
    for part in ("qerr", "gerr"):
        for k, v in t.opt_state[part].items():
            assert np.array_equal(v.numpy(),
                                  np.asarray(j.opt_state[part][k])), \
                f"{part}:{k}"


def test_checkpoint_without_the_groups_is_backfilled(tmp_path):
    plain = _port_gg(**{"quantize-bits": 0, "gradient-dropping-rate": 0.0})
    plain.update(_port_batch(0), 1)
    mp = str(tmp_path / "plain.npz")
    save_checkpoint(mp, plain.export_params(), "x: 1\n", plain,
                    TrainingState(batches=1))
    assert not any(k.startswith(("qerr:", "gerr:"))
                   for k in plain.optimizer_arrays())
    t = _port_gg()
    load_checkpoint(mp, t)
    for part in ("qerr", "gerr"):
        assert set(t.opt_state[part]) == set(t.params)
        assert all(float(v.abs().max()) == 0.0
                   for v in t.opt_state[part].values())
    assert float(t.opt_state["t"]) == 1.0
    t.update(_port_batch(1), 2)
    assert float(t.opt_state["t"]) == 2.0


def test_optimizer_root_is_the_correctly_rounded_f32_root():
    """The optimizer's square root, taken in f64 and rounded to f32, is
    numpy's IEEE f32 root bit for bit, on every device; PyTorch's f32
    sqrt is not, for some inputs, on the card and on some CPU builds."""
    x = torch.rand(1_000_000, generator=torch.Generator().manual_seed(3))
    x = torch.cat([x, x * 1e-8, x * 1e8, torch.tensor([0.0, 1e-38])])
    assert np.array_equal(topt._sqrt(x).numpy(), np.sqrt(x.numpy()))
