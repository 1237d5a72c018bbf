"""The port's flash_attention (plain versions, the CPU path of its
kernels) vs the JAX kernel, and the transformer with flash forced on vs
the JAX package.

The JAX side runs ``flash_attention(..., interpret=True)``, as
tests/test_flash_attention.py runs it on the CPU. Tolerances: 2e-5 for
the forward (f32, the same products summed in another order) and 1e-4
for dq, dk and dv (each sums those differences over Tq or Tk terms).

A fully masked row averages V over the TPU kernel's padded length but
over the real keys in the port (the dense answer), so that row is held
against the JAX dense path instead.

``flash_attention_fwd_tiled_reference`` (the forward kernel's tiling:
128 query rows, 64-key tiles, the online rescale, the causal tile skip)
is held against the plain forward and the JAX kernel at ragged lengths
and the 128-row tile edges, and, with a row whose first live key lies
inside a tile, against the JAX dense path.

The model-level tests build both packages from one seeded JAX init
(``tiny_pair``) with ``--transformer-flash-attention on``, so every
multi-query attention of both runs through flash: loss and gradients
(1e-4 of each gradient's scale, as tests/test_torch_loss.py) and beam
tokens (identical).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.attention import (causal_mask, combine_masks,
                                      dense_attention)
from marian_tpu.ops.pallas.flash_attention import flash_attention as jfa
from marian_tpu.translator.beam_search import BeamSearch as JaxBeamSearch
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.convert import params_from_numpy
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.ops.kernels import flash_attention as fmod
from marian_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_tiled_reference, flash_attention_reference)
from marian_tpu_torch.translator.beam_search import BeamSearch
from tests.test_torch_loss import make_batch, to_port
from tests.test_torch_transformer import random_batch, tiny_pair

torch.set_num_threads(2)

FWD_TOL, GRAD_TOL = 2e-5, 1e-4


def _inputs(seed, b, h, tq, tk, dh, full_row=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, dh).astype(np.float32)
    k = rng.randn(b, h, tk, dh).astype(np.float32)
    v = rng.randn(b, h, tk, dh).astype(np.float32)
    do = rng.randn(b, h, tq, dh).astype(np.float32)
    m = (rng.rand(b, tk) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    if full_row is not None:
        m[full_row] = 0.0
    return q, k, v, do, m


CASES = [
    ("padding mask", 2, 2, 64, 64, 16, False),
    ("ragged, not block multiples", 2, 2, 70, 90, 32, False),
    ("causal", 2, 2, 100, 100, 16, True),
    ("cross, Tq > Tk", 2, 2, 200, 130, 32, False),
    ("cross, Tq < Tk, Dh 128", 2, 2, 30, 75, 128, False),
]


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal", CASES)
def test_forward_matches_jax_kernel(name, b, h, tq, tk, dh, causal):
    q, k, v, _, m = _inputs(tq + 3 * tk + dh, b, h, tq, tk, dh)
    ref = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              kv_mask=jnp.asarray(m), causal=causal, interpret=True)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), torch.as_tensor(m), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_lse_is_the_masked_logsumexp():
    """lse (saved for the backward) against the log-sum-exp of the JAX
    dense path's masked scores, which scale after the product as the
    kernel does."""
    q, k, v, _, m = _inputs(4, 2, 2, 33, 47, 16)
    _, lse = flash_attention_fwd(*(torch.as_tensor(a) for a in (q, k, v, m)),
                                 causal=True)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / 16 ** 0.5)
    s = s + (1.0 - jnp.asarray(m))[:, None, None, :] * -1e9
    s = jnp.where(jnp.arange(33)[:, None] >= jnp.arange(47)[None, :], s, -1e9)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", [
    (2, 2, 130, 130, 64, True),      # past one 128-row tile
    (1, 2, 257, 257, 32, True),      # two full tiles and one row
    (2, 2, 200, 150, 16, False),     # ragged, Tq > Tk
    (2, 2, 100, 300, 128, False)])   # one partial tile, Dh 128
def test_tiled_forward_matches_plain_and_jax_kernel(b, h, tq, tk, dh,
                                                    causal):
    q, k, v, _, m = _inputs(tq + 2 * tk + dh, b, h, tq, tk, dh)
    args = [torch.as_tensor(a) for a in (q, k, v, m)]
    out, lse = flash_attention_fwd_tiled_reference(*args, causal)
    ref, ref_lse = flash_attention_reference(*args, causal)
    jout = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               kv_mask=jnp.asarray(m), causal=causal, interpret=True)
    for want in (ref.numpy(), np.asarray(jout)):
        np.testing.assert_allclose(out.numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("tq", [130, 257])
def test_tiled_forward_first_live_key_inside_a_tile(tq):
    """Batch row 0's first live key (70) lies inside the first key tile
    and row 1 masks every key: with causal, row 0's first 70 queries see
    no live key, so the skip rule keeps every tile of its first query
    tile, and those rows (like row 1) average V over the real keys, the
    JAX dense path's answer; lse of the masked rows is -1e9 exactly."""
    q, k, v, _, m = _inputs(tq, 3, 2, tq, tq, 16, full_row=1)
    m[0, :70], m[0, 70] = 0.0, 1.0
    args = [torch.as_tensor(a) for a in (q, k, v, m)]
    out, lse = flash_attention_fwd_tiled_reference(*args, True)
    ref, ref_lse = flash_attention_reference(*args, True)
    mask = combine_masks(causal_mask(tq), jnp.asarray(m)[:, None, None, :])
    jout = dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask)
    for want in (ref.numpy(), np.asarray(jout)):
        np.testing.assert_allclose(out.numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    live = ref_lse > -5e8
    assert not bool(live[0, :, :70].any()) and bool(live[0, :, 70:].all())
    np.testing.assert_allclose(lse[live].numpy(), ref_lse[live].numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert torch.equal(lse[~live], ref_lse[~live])


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, m, causal):
    """(the autograd Function's gradients, the plain backward's)."""
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq_, tk_, tv_, torch.as_tensor(m), causal)
    out.backward(torch.as_tensor(do))
    auto = [t.grad.numpy() for t in (tq_, tk_, tv_)]
    args = [torch.as_tensor(a) for a in (q, k, v)]
    o, lse = flash_attention_reference(*args, torch.as_tensor(m), causal)
    plain = flash_attention_bwd_reference(*args, torch.as_tensor(m),
                                          torch.as_tensor(do), o, lse, causal)
    return auto, [g.numpy() for g in plain]


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal", [
    ("self, ragged kv_mask", 2, 2, 70, 70, 16, False),
    ("causal", 2, 2, 90, 90, 32, True),
    ("cross, Tq != Tk", 2, 2, 40, 75, 16, False)])
def test_gradients_match_jax_vjp(name, b, h, tq, tk, dh, causal):
    q, k, v, do, m = _inputs(tq * 7 + tk, b, h, tq, tk, dh)
    ref = _jax_grads(lambda a, bb, c: jfa(a, bb, c, kv_mask=jnp.asarray(m),
                                          causal=causal, interpret=True),
                     q, k, v, do)
    auto, plain = _port_grads(q, k, v, do, m, causal)
    for got in (auto, plain):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_matches_jax_dense(causal):
    """Row 1 masks every key: its output is the mean of V over the real
    keys, the JAX dense path's answer. Its output gradient is 0, as a
    padding row's is in training (no loss weight reaches it): the
    backward recomputes p = exp(s - lse) as the TPU kernel does, and in
    such a row lse = -1e9 + log(Tk) rounds to -1e9 in f32, so p is 1 per
    key there; with dO = 0 that row adds nothing, and every gradient
    agrees with the dense path's."""
    t = 40
    q, k, v, do, m = _inputs(5, 3, 2, t, t, 16, full_row=1)
    do[1] = 0.0
    mask = jnp.asarray(m)[:, None, None, :]
    if causal:
        mask = combine_masks(causal_mask(t), mask)
    ref_out = dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask)
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v, m)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_out),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), got.shape[1:]), rtol=1e-5,
        atol=1e-5)
    ref = _jax_grads(lambda a, bb, c: dense_attention(a, bb, c, mask),
                     q, k, v, do)
    auto, plain = _port_grads(q, k, v, do, m, causal)
    for grads in (auto, plain):
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g, r, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_bf16_inputs_compute_in_f32():
    q, k, v, _, m = _inputs(6, 2, 2, 20, 20, 16)
    args = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    out, lse = flash_attention_fwd(*args, torch.as_tensor(m))
    ref, ref_lse = flash_attention_fwd(*(a.float() for a in args),
                                       torch.as_tensor(m))
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float())
    torch.testing.assert_close(lse, ref_lse)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    q, k, v, do, m = _inputs(8, 1, 2, 12, 12, 16)
    before = (fmod.flash_attention_fwd.launches,
              fmod.flash_attention_dq.launches,
              fmod.flash_attention_dkv.launches)
    _port_grads(q, k, v, do, m, True)
    args = [torch.as_tensor(a) for a in (q, k, v, m, do)]
    o, lse = flash_attention_reference(*args[:4])
    for g, r in zip(fmod.flash_attention_bwd(*args, o, lse),
                    flash_attention_bwd_reference(*args, o, lse)):
        assert torch.equal(g, r)
    assert (fmod.flash_attention_fwd.launches,
            fmod.flash_attention_dq.launches,
            fmod.flash_attention_dkv.launches) == before


# -- the slice: the transformer with flash forced on, on both packages --

FLASH_ON = {"transformer-flash-attention": "on"}


def test_loss_and_gradients_with_flash_match_jax():
    jm, jp, tm, _, _ = tiny_pair(vocab=29, seed=21, **FLASH_ON)
    assert tm.cfg.flash_attention == "on"
    batch = make_batch(22, b=3, ts=9, tt=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb, None, train=True), has_aux=True)(jp)
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    before = fmod.flash_attention_fwd.launches
    total, _ = tm.loss(tp, to_port(batch), None, train=True)
    total.backward()
    assert fmod.flash_attention_fwd.launches == before     # the CPU path
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    floor = 0.01 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    for k, p in tp.items():
        ref = np.asarray(jgrads[k])
        scale = max(float(np.abs(ref).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


def test_flash_path_is_the_one_taken(monkeypatch):
    """With flash on, every multi-query attention of the training step
    goes through the flash Function (2+2 layers: 2 encoder self, 2
    causal decoder self, 2 cross attentions)."""
    _, jp, tm, tp, _ = tiny_pair(vocab=29, seed=21, **FLASH_ON)
    calls = []
    real = fmod.flash_attention_reference

    def counted(q, k, v, kv_mask=None, causal=False, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, kv_mask, causal, scale)
    monkeypatch.setattr(fmod, "flash_attention_reference", counted)
    tm.loss(tp, to_port(make_batch(22, b=3, ts=9, tt=11)), None, train=True)
    assert len(calls) == 6
    assert sorted(c[2] for c in calls) == [False] * 4 + [True] * 2


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_tokens_with_flash_match_jax(beam):
    jm, jp, _, tp, opts = tiny_pair(seed=23, **FLASH_ON)
    o = opts.with_(**{"beam-size": beam, "n-best": True, "max-length": 12,
                      "max-length-factor": 1.5, "num-devices": 1,
                      "transformer-fused-decode-attention": "off"})
    ids, mask = random_batch(23, 3, 9, seed=24)
    ref = JaxBeamSearch(jm, [jp], None, o, None).search(ids, mask)
    to = TOptions(o.as_dict()).with_(
        **{"transformer-fused-decode-attention": "auto"})
    tm = create_model(to, 23, 23)
    assert tm.cfg.flash_attention == "on"
    got = BeamSearch(tm, tp, to, torch.device("cpu")).search(ids, mask)
    assert len(got) == len(ref)
    for r_list, g_list in zip(ref, got):
        assert [h["tokens"] for h in g_list] == [h["tokens"] for h in r_list]
        np.testing.assert_allclose([h["score"] for h in g_list],
                                   [h["score"] for h in r_list], rtol=1e-5)


def test_big_parameters_carry_over_unchanged():
    """transformer-big's parameter set (16 heads, relu, tied vocabulary)
    at a narrow width: every JAX parameter arrives in the port with its
    name, shape and values, and the encoders agree (through flash)."""
    jm, jp, tm, tp, _ = tiny_pair(**{"dim-emb": 64, "transformer-heads": 16,
                                     "transformer-dim-ffn": 256, **FLASH_ON})
    assert tm.cfg.heads == 16 and tm.cfg.dim_head == 4
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == tuple(v.shape)
        assert np.array_equal(tp[k].numpy(), np.asarray(v)), k
    ids, mask = random_batch(23, 2, 11, seed=25)
    ref = jm.encode_for_decode(jp, jnp.asarray(ids), jnp.asarray(mask))
    got = tm.encode_for_decode(tp, torch.as_tensor(ids, dtype=torch.long),
                               torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)
