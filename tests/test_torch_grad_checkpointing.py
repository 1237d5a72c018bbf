"""Gradient checkpointing (--gradient-checkpointing) in the port, on the
CPU, on a 2+2 transformer of dim 32 from one seeded JAX init:

- against the JAX package's remat (``jax.checkpoint`` per layer) at
  dropout 0: the loss within rtol 2e-5 and each gradient within 1e-4 of
  its own largest magnitude (floored at 1% of the model's largest, as
  tests/test_torch_loss.py does);
- the port with checkpointing against the port without, at dropout 0.1
  (word, attention, FFN and residual dropout all on), in f32 and bf16:
  the loss and every gradient bit-identical, and the dropout generator
  left in the same state (the recompute draws its masks from a copy of
  the state each layer started from);
- the same with --transformer-packed-attention on (the kernel's plain
  version, at dim 64 for a head size its backward is built for;
  attention dropout 0, which the kernels do not take) and with
  guided alignment (its layer is not checkpointed);
- three updates of the GraphGroup at dropout 0.1: parameters
  bit-identical with and without checkpointing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common import Options
from marian_tpu.data.alignment import WordAlignment
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.convert import params_from_numpy
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.ops.kernels import packed_attention as pa
from marian_tpu_torch.training.graph_group import GraphGroup

torch.set_num_threads(2)

VOCAB = 29
DROPOUT = {"transformer-dropout": 0.1, "transformer-dropout-attention": 0.1,
           "transformer-dropout-ffn": 0.1, "dropout-src": 0.1,
           "dropout-trg": 0.1}


def opts(**over):
    base = {"type": "transformer", "dim-emb": 32, "transformer-heads": 4,
            "transformer-dim-ffn": 64, "enc-depth": 2, "dec-depth": 2,
            "transformer-ffn-activation": "relu", "tied-embeddings-all": True,
            "label-smoothing": 0.1, "precision": ["float32", "float32"],
            "max-length": 64}
    base.update(over)
    return base


def make_batch(seed, b=4, ts=9, tt=11, guided=False):
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
    if guided:
        g = np.zeros((b, tt, ts), np.float32)
        for i in range(b):
            WordAlignment.parse(" ".join(
                f"{j % int(smask[i].sum())}-{j}"
                for j in range(int(tmask[i].sum())))).fill_dense(g[i])
        out["guided"] = g
    return out


def to_port(batch):
    return {k: torch.as_tensor(v).long() if k.endswith("_ids")
            else torch.as_tensor(v) for k, v in batch.items()}


def init(o, key=11):
    jm = jax_model(Options(o), VOCAB, VOCAB)
    return {k: np.asarray(v) for k, v in jm.init(jax.random.key(key)).items()}


def port_grads(o, flat, batch, seed=None):
    """(loss, {name: grad}, generator state after) of one forward and
    backward; dropout from a generator seeded with ``seed``."""
    tm = create_model(TOptions(o), VOCAB, VOCAB)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(flat, "cpu").items()}
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    total, _ = tm.loss(tp, to_port(batch), gen, train=True)
    total.backward()
    return (total.detach(), {k: p.grad for k, p in tp.items()},
            None if gen is None else gen.get_state())


def test_matches_jax_remat_at_dropout_0():
    o = opts(**{"gradient-checkpointing": True})
    jm = jax_model(Options(o), VOCAB, VOCAB)
    jp = jm.init(jax.random.key(11))
    assert jm.cfg.gradient_checkpointing
    batch = make_batch(12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb, None, train=True), has_aux=True)(jp)
    total, grads, _ = port_grads(o, {k: np.asarray(v) for k, v in jp.items()},
                                 batch)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=2e-5)
    floor = 0.01 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    for k, g in grads.items():
        ref = np.asarray(jgrads[k])
        scale = max(float(np.abs(ref).max()), floor)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def assert_bit_identical(o, batch):
    flat = init(o)
    off = port_grads(o, flat, batch, seed=5)
    on = port_grads({**o, "gradient-checkpointing": True}, flat, batch,
                    seed=5)
    assert torch.equal(on[0], off[0])
    assert set(on[1]) == set(off[1])
    for k in off[1]:
        assert torch.equal(on[1][k], off[1][k]), k
    assert torch.equal(on[2], off[2])
    # the masks were drawn: another seed moves the loss
    assert port_grads(o, flat, batch, seed=6)[0] != off[0]


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_bit_identical_with_and_without_at_dropout(precision):
    assert_bit_identical(opts(**DROPOUT, precision=[precision, "float32"]),
                         make_batch(3))


def test_bit_identical_through_the_packed_plain_version(monkeypatch):
    calls = []
    real = pa.packed_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(pa, "packed_attention_reference", counted)
    # head size 16: the packed backward is built for it (not for 8)
    assert_bit_identical(opts(**{**DROPOUT,
                                 "transformer-dropout-attention": 0.0,
                                 "transformer-packed-attention": "on",
                                 "dim-emb": 64}),
                         make_batch(4))
    assert calls


def test_bit_identical_with_guided_alignment():
    assert_bit_identical(opts(**DROPOUT, **{"guided-alignment": "a.txt",
                                            "transformer-guided-alignment-"
                                            "layer": "1"}),
                         make_batch(8, guided=True))


def test_updates_bit_identical_with_and_without():
    flat = init(opts())
    batches = [to_port(make_batch(20 + i)) for i in range(3)]
    params = []
    for ckpt in (False, True):
        o = TOptions(opts(**DROPOUT, **{"gradient-checkpointing": ckpt,
                                        "learn-rate": 0.01}))
        gg = GraphGroup(create_model(o, VOCAB, VOCAB), o,
                        torch.device("cpu"))
        gg.initialize(flat)
        gen = torch.Generator()
        for i, b in enumerate(batches):
            gg.update(b, i + 1, gen, 1234)
        params.append(gg.export_params())
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
