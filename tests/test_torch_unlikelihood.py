"""The unlikelihood loss (--unlikelihood-loss) in the port against the
JAX package, on the CPU, with word-level data weights of both signs (a
negative weight marks a token as negative evidence: -|w|·log(1-p)):

- ``layers/loss.cross_entropy_loss`` on random logits, with and without
  label smoothing, against the reference's: within rtol 2e-5;
- ``EncoderDecoder.loss`` and every gradient against the reference's on
  a 2+2 transformer of dim 32 (one seeded JAX init): the loss within
  rtol 2e-5, each gradient within 1e-4 of its own largest magnitude
  (floored at 1% of the model's largest, as tests/test_torch_loss.py
  does), under --fused-ce off and on;
- under --fused-ce on, a batch with data weights skips the fused CE (as
  the reference does: its dense logits go through the unlikelihood
  branch), and a batch without weights takes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common import Options
from marian_tpu.layers.loss import cross_entropy_loss as jloss
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.convert import params_from_numpy
from marian_tpu_torch.layers.loss import cross_entropy_loss
from marian_tpu_torch.models import encoder_decoder as ted

torch.set_num_threads(2)

VOCAB = 29


def opts(**over):
    base = {"type": "transformer", "dim-emb": 32, "transformer-heads": 4,
            "transformer-dim-ffn": 64, "enc-depth": 2, "dec-depth": 2,
            "transformer-ffn-activation": "relu", "tied-embeddings-all": True,
            "label-smoothing": 0.1, "precision": ["float32", "float32"],
            "max-length": 64, "unlikelihood-loss": True}
    base.update(over)
    return base


def weighted_batch(seed, b=4, ts=9, tt=11, weights=True):
    rng = np.random.RandomState(seed)

    def seq(t):
        ids = rng.randint(2, VOCAB, size=(b, t)).astype(np.int32)
        mask = np.zeros((b, t), np.float32)
        for i in range(b):
            n = rng.randint(3, t + 1)
            ids[i, n - 1] = 0
            ids[i, n:] = 0
            mask[i, :n] = 1.0
        return ids, mask
    src, smask = seq(ts)
    trg, tmask = seq(tt)
    out = {"src_ids": src, "src_mask": smask, "trg_ids": trg,
           "trg_mask": tmask}
    if weights:
        out["data_weights"] = rng.choice(
            [1.0, 0.5, -0.5, -1.0], size=(b, tt)).astype(np.float32)
    return out


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_loss_matches_jax(smoothing):
    rng = np.random.RandomState(7)
    logits = (rng.randn(3, 5, VOCAB) * 3).astype(np.float32)
    # one label near certainty: log(1-p) at its clamp
    logits[0, 0, 4] = 40.0
    labels = rng.randint(0, VOCAB, (3, 5)).astype(np.int32)
    labels[0, 0] = 4
    mask = (rng.rand(3, 5) < 0.8).astype(np.float32)
    w = rng.choice([1.0, -1.0, 0.3, -0.7], size=(3, 5)).astype(np.float32)
    ref = jloss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                smoothing, jnp.asarray(w), unlikelihood=True)
    got = cross_entropy_loss(torch.as_tensor(logits),
                             torch.as_tensor(labels).long(),
                             torch.as_tensor(mask), smoothing,
                             torch.as_tensor(w), unlikelihood=True)
    np.testing.assert_allclose(got.loss_sum.item(), float(ref.loss_sum),
                               rtol=2e-5)
    assert got.labels.item() == float(ref.labels)


def to_port(batch):
    return {k: torch.as_tensor(v).long() if k.endswith("_ids")
            else torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("fused", ["off", "on"])
def test_loss_and_gradients_match_jax(fused, monkeypatch):
    o = opts(**{"fused-ce": fused})
    jm = jax_model(Options(o), VOCAB, VOCAB)
    jp = jm.init(jax.random.key(11))
    batch = weighted_batch(12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb, None, train=True), has_aux=True)(jp)

    def no_fused(*a, **kw):
        raise AssertionError("the fused CE ran on a weighted batch")
    monkeypatch.setattr(ted, "fused_softmax_xent", no_fused)
    tm = ted.create_model(TOptions(o), VOCAB, VOCAB)
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    total, _ = tm.loss(tp, to_port(batch), None, train=True)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=2e-5)
    floor = 0.01 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    for k, p in tp.items():
        ref = np.asarray(jgrads[k])
        scale = max(float(np.abs(ref).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_unweighted_batch_takes_the_fused_ce(monkeypatch):
    calls = []
    real = ted.fused_softmax_xent

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ted, "fused_softmax_xent", counted)
    o = opts(**{"fused-ce": "on"})
    jm = jax_model(Options(o), VOCAB, VOCAB)
    jp = jm.init(jax.random.key(2))
    batch = weighted_batch(3, weights=False)
    jtotal, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        None, train=True)
    tm = ted.create_model(TOptions(o), VOCAB, VOCAB)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    total, _ = tm.loss(tp, to_port(batch), None, train=True)
    assert calls == [1]
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=2e-5)
