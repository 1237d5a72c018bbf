"""Gradients of the port's packed_attention vs ``jax.vjp`` of the JAX
kernel.

The port's gradients come two ways: autograd through the plain forward
(the CPU path of the training step) and ``packed_attention_bwd_reference``
(the backward kernel's plain version, in its op order). The JAX side runs
the Pallas kernel in interpret mode with its custom VJP, as
tests/test_packed_attention.py does on the CPU. Tolerance 1e-4: both are
f32, with the softmax and four products summed in different orders, and
the gradient sums compound those differences over Tq or Tk terms.

A fully-masked row averages over the TPU kernel's padded length but over
the real keys in the port (the dense answer), so that row is held
against ``jax.vjp`` of the JAX dense path instead.

``packed_attention_bwd_tiled_reference`` (the backward kernel's tiling:
pass 1's online row statistics over 64-key tiles, pass 2's dq, dk, dv
sums in the kernel's order, the causal tile skip) is held against the
plain backward and the JAX kernel's VJP to 1e-5 of each gradient's
largest magnitude, at lengths past one tile and up to the kernel's cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.attention import dense_attention
from marian_tpu.ops.pallas.packed_attention import packed_attention as jpa
from marian_tpu_torch.ops.kernels.packed_attention import (
    packed_attention, packed_attention_bwd, packed_attention_bwd_tiled_reference)

torch.set_num_threads(2)

TOL = 1e-4


def _inputs(seed, b, h, tq, tk, dh=16, full_row=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, dh).astype(np.float32)
    k = rng.randn(b, h, tk, dh).astype(np.float32)
    v = rng.randn(b, h, tk, dh).astype(np.float32)
    do = rng.randn(b, h, tq, dh).astype(np.float32)
    m = (rng.rand(b, tk) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if full_row is not None:
        m[full_row] = 0.0
    return q, k, v, do, m


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, m, causal):
    """(autograd through the plain forward, the backward's plain
    version)."""
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = packed_attention(tq_, tk_, tv_, torch.as_tensor(m), causal=causal)
    out.backward(torch.as_tensor(do))
    auto = [t.grad.numpy() for t in (tq_, tk_, tv_)]
    plain = packed_attention_bwd(
        *(torch.as_tensor(a) for a in (q, k, v, m, do)), out.detach(),
        causal)
    return auto, [g.numpy() for g in plain]


@pytest.mark.parametrize("name,b,h,tq,tk,causal", [
    ("self, ragged kv_mask", 3, 2, 11, 11, False),
    ("causal", 2, 2, 13, 13, True),
    ("cross, Tq != Tk", 2, 3, 9, 14, False)])
def test_packed_gradients_match_jax_vjp(name, b, h, tq, tk, causal):
    q, k, v, do, m = _inputs(tq * 7 + tk, b, h, tq, tk)
    ref = _jax_grads(lambda a, bb, c: jpa(a, bb, c, kv_mask=jnp.asarray(m),
                                          causal=causal, interpret=True),
                     q, k, v, do)
    auto, plain = _port_grads(q, k, v, do, m, causal)
    for got in (auto, plain):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)


def test_fully_masked_row_gradients_match_jax_dense():
    q, k, v, do, m = _inputs(5, 3, 2, 10, 10, full_row=1)
    mask = jnp.asarray(m)[:, None, None, :]
    ref = _jax_grads(lambda a, bb, c: dense_attention(a, bb, c, mask),
                     q, k, v, do)
    auto, plain = _port_grads(q, k, v, do, m, False)
    for got in (auto, plain):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
    # the masked row's query still gets a gradient: uniform weights over
    # the real keys, as the dense path has them
    assert np.abs(auto[0][1]).max() > 0


def test_bwd_reference_matches_autograd_of_plain_forward():
    """The backward's plain version against autograd of the plain
    forward, to f32 rounding (1e-5)."""
    q, k, v, do, m = _inputs(9, 2, 2, 8, 12)
    auto, plain = _port_grads(q, k, v, do, m, False)
    for g, r in zip(plain, auto):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def _close_to_scale(got, ref, rel=1e-5):
    """|got - ref| <= rel * max|ref| (sums in another order)."""
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= rel * scale


def _tiled_and_plain(q, k, v, do, m, causal):
    args = [torch.as_tensor(a) for a in (q, k, v, m, do)]
    out = packed_attention(*args[:3], args[3], causal=causal)
    tiled = packed_attention_bwd_tiled_reference(*args, out, causal)
    plain = packed_attention_bwd(*args, out, causal)
    return [g.numpy() for g in tiled], [g.numpy() for g in plain]


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", [
    (2, 2, 64, 64, 64, False),          # one tile
    (2, 2, 130, 130, 64, True),         # ragged
    (1, 2, 200, 200, 64, False),
    (1, 2, 256, 256, 64, True),         # the reference's cap at Dh 64
    (1, 2, 128, 128, 128, False),       # the reference's cap at Dh 128
    (2, 2, 150, 90, 32, False),         # cross, Tq != Tk
    (2, 1, 45, 45, 16, True)])          # ragged, under one tile
def test_tiled_plain_backward_matches_plain_and_jax(b, h, tq, tk, dh,
                                                    causal):
    q, k, v, do, m = _inputs(tq + tk + dh, b, h, tq, tk, dh)
    tiled, plain = _tiled_and_plain(q, k, v, do, m, causal)
    ref = _jax_grads(lambda a, bb, c: jpa(a, bb, c, kv_mask=jnp.asarray(m),
                                          causal=causal, interpret=True),
                     q, k, v, do)
    for g, p, r in zip(tiled, plain, ref):
        _close_to_scale(g, p)
        _close_to_scale(g, r)


@pytest.mark.parametrize("causal", [False, True])
def test_tiled_plain_backward_fully_masked_row_matches_jax_dense(causal):
    """Batch row 1 masks every key; batch row 0's first live key (70)
    lies inside the second key tile, so with causal its first 70 query
    rows see no live key (uniform over the real keys, as the dense path
    has them) and the tile skip must keep the tiles before it."""
    t = 150
    q, k, v, do, m = _inputs(6, 3, 2, t, t, 32, full_row=1)
    m[0, :70] = 0.0
    mask = jnp.asarray(m)[:, None, None, :]
    if causal:
        mask = mask * jnp.tril(jnp.ones((t, t)))[None, None]
    ref = _jax_grads(lambda a, bb, c: dense_attention(a, bb, c, mask),
                     q, k, v, do)
    tiled, plain = _tiled_and_plain(q, k, v, do, m, causal)
    for g, p, r in zip(tiled, plain, ref):
        _close_to_scale(g, p)
        _close_to_scale(g, r)
