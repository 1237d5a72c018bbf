"""marian_tpu_torch transformer vs the JAX reference at tiny size.

The same parameters (JAX ``EncoderDecoder.init()`` → numpy →
``convert.params_from_numpy``) and the same inputs go through both
packages; encoder states and decode-step logits must agree to rtol 1e-5,
atol 2e-5. Both sides compute in f32 with the same op order, so what is
left is summation order inside the matrix products and ulp-level
differences of exp/sin/cos between XLA's and PyTorch's CPU kernels: a
few ulps per op, compounding over 2+2 layers to ~1e-6 on O(1) values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.models.encoder_decoder import create_model as jax_create_model
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.convert import params_from_numpy
from marian_tpu_torch.models import transformer as TT
from marian_tpu_torch.models.encoder_decoder import create_model
from tests.test_model import tiny_options

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 2e-5


def tiny_pair(vocab=23, seed=0, **over):
    """(jax model, jax params, port model, port params, options) built
    from one seeded JAX init at the tests' tiny size (dim-emb 16, 2
    heads, 2+2 layers, f32, tied embeddings)."""
    opts = tiny_options(**over)
    jmodel = jax_create_model(opts, vocab, vocab, inference=True)
    jparams = jmodel.init(jax.random.key(seed))
    flat = {k: np.asarray(v) for k, v in jparams.items()}
    tmodel = create_model(TOptions(opts.as_dict()), vocab, vocab)
    return jmodel, jparams, tmodel, params_from_numpy(flat, "cpu"), opts


def random_batch(vocab, b, ts, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, size=(b, ts)).astype(np.int32)
    mask = np.ones((b, ts), np.float32)
    for i in range(b):
        n = rng.randint(2, ts + 1)
        ids[i, n - 1] = 0                      # EOS
        ids[i, n:] = 0
        mask[i, n:] = 0.0
    return ids, mask


def test_encoder_matches_jax():
    jm, jp, tm, tp, _ = tiny_pair(seed=1)
    ids, mask = random_batch(23, 3, 9, seed=2)
    ref = jm.encode_for_decode(jp, jnp.asarray(ids), jnp.asarray(mask))
    got = tm.encode_for_decode(tp, torch.as_tensor(ids, dtype=torch.long),
                               torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_decode_steps_match_jax(fused):
    """Teacher-fed decode steps: logits at every step agree with the JAX
    unfused step; ``on`` runs the port's fused contract through the
    kernel's plain version (identity gather)."""
    jm, jp, _, tp, opts = tiny_pair(seed=3)
    tm = create_model(TOptions(opts.as_dict()).with_(
        **{"transformer-fused-decode-attention": fused}), 23, 23)
    ids, mask = random_batch(23, 2, 7, seed=4)
    L, steps = 8, 5
    jenc = jm.encode_for_decode(jp, jnp.asarray(ids), jnp.asarray(mask))
    jst = jm.start_state(jp, jenc, jnp.asarray(mask), L)
    tids = torch.as_tensor(ids, dtype=torch.long)
    tmask = torch.as_tensor(mask)
    tst = tm.start_state(tp, tm.encode_for_decode(tp, tids, tmask), tmask, L)
    prev = np.zeros((2, 1), np.int32)
    rng = np.random.RandomState(5)
    for _ in range(steps):
        jl, jst = jm.step(jp, jst, jnp.asarray(prev), jnp.asarray(mask))
        tl, tst = tm.step(tp, tst, torch.as_tensor(prev, dtype=torch.long),
                          tmask)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        prev = rng.randint(2, 23, size=(2, 1)).astype(np.int32)


@pytest.mark.parametrize("tied", [True, False])
def test_init_params_names_and_shapes_match_jax(tied):
    over = {} if tied else {"tied-embeddings-all": False}
    jm, jp, tm, _, _ = tiny_pair(**over)
    mine = TT.init_params(tm.cfg, seed=0)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_tied_embedding_is_shared_not_copied():
    _, _, tm, tp, _ = tiny_pair()
    assert "decoder_ff_logit_out_W" not in tp
    x = torch.randn(3, 16)
    np.testing.assert_allclose(
        TT.output_logits(tm.cfg, tp, x).numpy(),
        (x @ tp["Wemb"].t() + tp["decoder_ff_logit_out_b"]).numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flag,value", [
    ("transformer-decoder-autoreg", "rnn"),
    ("transformer-tied-layers", [1, 1]),
    ("transformer-moe-experts", 4),
])
def test_unported_features_are_refused(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        create_model(TOptions(tiny_options(**{flag: value}).as_dict()),
                     23, 23)
