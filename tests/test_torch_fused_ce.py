"""The port's fused CE (plain versions, and the autograd Function that
routes the backward through the dx / dw wrappers) vs the JAX kernel.

The JAX side is ``fused_softmax_xent(..., block_v=32, interpret=True)``
with ``jax.grad``, as tests/test_fused_ce.py runs it on the CPU; V = 45
is not a multiple of the block, so the reference pads its table and the
port masks the ragged edge. Tolerances are the reference's own: 2e-5 for
values (f32, another summation order over V), 2e-4 for gradients (sums
over N and V of those differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.fused_ce import fused_softmax_xent as jfx
from marian_tpu_torch.ops.kernels import fused_ce as fce

torch.set_num_threads(2)

VAL_TOL, GRAD_TOL = 2e-5, 2e-4
N, V, E = 37, 45, 24


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, E).astype(np.float32)
    w = (rng.randn(V, E) * 0.3).astype(np.float32)
    b = rng.randn(V).astype(np.float32)
    labels = rng.randint(0, V, size=N).astype(np.int32)
    weights = rng.rand(N).astype(np.float32)
    return x, w, b, labels, weights


def _jax(x, w, b, labels, eps):
    return jfx(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
               jnp.asarray(labels), eps, block_v=32, interpret=True)


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_ce_values_match_jax_kernel(eps):
    x, w, b, labels, _ = _inputs(1)
    ref = np.asarray(_jax(x, w, b, labels, eps))
    tx, tw, tb = _t(x, w, b)
    got = fce.fused_softmax_xent(tx, tw, tb, torch.as_tensor(labels), eps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=VAL_TOL, atol=VAL_TOL)


def test_stats_match_jax_dense():
    x, w, b, labels, _ = _inputs(2)
    logits = jnp.asarray(x) @ jnp.asarray(w).T + jnp.asarray(b)
    ref = (jax.nn.logsumexp(logits, axis=-1),
           jnp.take_along_axis(logits, jnp.asarray(labels)[:, None],
                               axis=-1)[:, 0],
           jnp.sum(logits, axis=-1))
    got = fce.fused_ce_stats(*_t(x, w, b), torch.as_tensor(labels))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=VAL_TOL,
                                   atol=VAL_TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("route", ["autograd", "function"])
def test_gradients_match_jax_grad(eps, route):
    """``autograd``: the CPU training path (autograd through the plain
    forward); ``function``: the card's autograd Function, whose backward
    calls the dx / dw wrappers (their plain versions here)."""
    x, w, b, labels, weights = _inputs(3)

    def loss(xx, ww, bb):
        return jnp.sum(jfx(xx, ww, bb, jnp.asarray(labels), eps, block_v=32,
                           interpret=True) * jnp.asarray(weights))
    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b))
    tx, tw, tb = _t(x, w, b, grad=True)
    tl = torch.as_tensor(labels)
    if route == "autograd":
        ce = fce.fused_softmax_xent(tx, tw, tb, tl, eps)
    else:
        lse, lab, tot = fce._FusedCEStats.apply(tx, tw, tb, tl)
        ce = (1.0 - eps) * (lse - lab) + eps * (lse - tot / V)
    (ce * torch.as_tensor(weights)).sum().backward()
    for g, r in zip((tx.grad, tw.grad, tb.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_bwd_reference_matches_autograd_of_dense_loss():
    """``fused_ce_bwd_reference`` against torch autograd of the dense
    logits with the same cotangents on (lse, lab, tot)."""
    x, w, b, labels, _ = _inputs(4)
    rng = np.random.RandomState(5)
    g_lse, g_lab, g_tot = (torch.as_tensor(rng.randn(N).astype(np.float32))
                           for _ in range(3))
    tx, tw, tb = _t(x, w, b, grad=True)
    tl = torch.as_tensor(labels)
    logits = tx @ tw.t() + tb
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(1, tl.long()[:, None])[:, 0]
    tot = logits.sum(dim=-1)
    ((lse * g_lse).sum() + (lab * g_lab).sum()
     + (tot * g_tot).sum()).backward()
    dx, dw, db = fce.fused_ce_bwd_reference(
        *_t(x, w, b), tl, lse.detach(), g_lse, g_lab, g_tot)
    for g, r in ((dx, tx.grad), (dw, tw.grad), (db, tb.grad)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_cap_covers_transformer_base():
    """The dx / dw accumulator holds transformer-base's E = 512 in one
    column range; a wider E (transformer-big's 1024) is split into the
    fewest 64-aligned ranges that fit a Hopper block's shared memory, so
    every hidden size runs the kernels."""
    assert fce.accumulator_width(512) == 512
    assert fce.accumulator_width(1024) == 512
    cap = 704                       # widest range that fits 227 KB
    for e in (24, 64, 512, 700, 704, 705, 1024, 1500, 4096):
        width = fce.accumulator_width(e)
        assert width % 64 == 0 and width <= cap
        assert (fce._BWD_FIXED + 64 * width) * 4 <= 232448
        assert -(-e // width) == -(-e // cap)
