"""``EncoderDecoder.loss`` and the gradient of every parameter vs the JAX
``model.loss`` and ``jax.grad``, on a tiny transformer (2+2 layers, dim
32, 4 heads, label smoothing 0.1, dropout 0) built from one seeded JAX
init.

Run dense on both sides, and again with ``--fused-ce on``: the port's
plain fused-CE version against the JAX interpret-mode kernel. The loss
agrees to rtol 1e-5 (f32, another summation order); each gradient to
1e-4 of its own largest magnitude, since a parameter's gradient sums
those differences over every token of the batch and every layer above.
That scale is floored at 1% of the largest gradient of the model: the
attention key biases have an exact-zero gradient (a softmax does not see
a shift shared by all keys), so both sides return rounding noise there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common import Options
from marian_tpu.models.encoder_decoder import create_model as jax_create_model
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.convert import params_from_numpy
from marian_tpu_torch.models.encoder_decoder import create_model

torch.set_num_threads(2)

VOCAB = 29


def loss_options(**over):
    base = {"type": "transformer", "dim-emb": 32, "transformer-heads": 4,
            "transformer-dim-ffn": 64, "enc-depth": 2, "dec-depth": 2,
            "transformer-ffn-activation": "relu",
            "tied-embeddings-all": True, "label-smoothing": 0.1,
            "precision": ["float32", "float32"], "max-length": 64}
    base.update(over)
    return base


def seq_batch(rng, b, t, vocab=VOCAB):
    ids = rng.randint(2, vocab, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.float32)
    for i in range(b):
        n = rng.randint(2, t + 1)
        ids[i, n - 1] = 0
        ids[i, n:] = 0
        mask[i, :n] = 1.0
    return ids, mask


def make_batch(seed, b=4, ts=9, tt=11):
    rng = np.random.RandomState(seed)
    src, smask = seq_batch(rng, b, ts)
    trg, tmask = seq_batch(rng, b, tt)
    return {"src_ids": src, "src_mask": smask, "trg_ids": trg,
            "trg_mask": tmask}


def to_port(batch):
    return {k: torch.as_tensor(v).long() if k.endswith("_ids")
            else torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("fused", ["off", "on"])
def test_loss_and_gradients_match_jax(fused):
    opts = loss_options(**{"fused-ce": fused})
    jm = jax_create_model(Options(opts), VOCAB, VOCAB)
    jp = jm.init(jax.random.key(11))
    batch = make_batch(12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        total, aux = jm.loss(p, jb, None, train=True)
        return total, aux
    (jtotal, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)

    tm = create_model(TOptions(opts), VOCAB, VOCAB)
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    total, aux = tm.loss(tp, to_port(batch), None, train=True)
    total.backward()

    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    assert aux["labels"].item() == float(jaux["labels"]) == batch[
        "trg_mask"].sum()
    assert set(tp) == set(jgrads)
    floor = 0.01 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    for k, p in tp.items():
        ref = np.asarray(jgrads[k])
        scale = max(float(np.abs(ref).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_fused_auto_stays_dense_on_cpu():
    tm = create_model(TOptions(loss_options()), VOCAB, VOCAB)
    assert tm._fused_ce_table({}, torch.device("cpu")) is None
    on = create_model(TOptions(loss_options(**{"fused-ce": "on"})), VOCAB,
                      VOCAB)
    w = torch.zeros(VOCAB, 32)
    assert on._fused_ce_table({"Wemb": w}, torch.device("cpu")) is w


def test_eval_loss_ignores_dropout():
    """train=False: dropout rates in the config change nothing."""
    batch = to_port(make_batch(3))
    jm = jax_create_model(Options(loss_options()), VOCAB, VOCAB)
    flat = {k: np.asarray(v) for k, v in jm.init(jax.random.key(1)).items()}
    plain = create_model(TOptions(loss_options()), VOCAB, VOCAB)
    drop = create_model(TOptions(loss_options(**{
        "transformer-dropout": 0.3, "transformer-dropout-ffn": 0.2})),
        VOCAB, VOCAB)
    p = params_from_numpy(flat, "cpu")
    gen = torch.Generator().manual_seed(0)
    a = plain.loss(p, batch, gen, train=False)[0]
    b = drop.loss(p, batch, gen, train=False)[0]
    c = drop.loss(p, batch, gen, train=True)[0]
    assert a.item() == b.item() and c.item() != a.item()
