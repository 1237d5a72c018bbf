"""The port's packed_attention plain version vs the JAX kernel.

The JAX side runs in Pallas interpret mode, as
tests/test_packed_attention.py runs it on the CPU. Both scale AFTER the
score product, so they agree within 2e-5 (f32, different summation
order). The TPU kernel pads sequences to 64 for its matrix unit; padded
keys get zero probability except in a fully-masked row, which the TPU
kernel averages over the padded length and the port over the real keys
(the dense path's answer), so fully-masked rows are compared against the
JAX kernel at T=64 and against the JAX dense path at a ragged T.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.attention import attention as jax_attention
from marian_tpu.ops.attention import dense_attention
from marian_tpu.ops.pallas.packed_attention import packed_attention as jpa
from marian_tpu_torch.ops import attention as tatt
from marian_tpu_torch.ops.kernels import packed_attention as kmod
from marian_tpu_torch.ops.kernels.flash_attention import flash_attention
from marian_tpu_torch.ops.kernels.packed_attention import packed_attention

torch.set_num_threads(2)

TOL = 2e-5


def _qkv(seed, b, h, tq, tk, dh=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, tq, dh).astype(np.float32),
            rng.randn(b, h, tk, dh).astype(np.float32),
            rng.randn(b, h, tk, dh).astype(np.float32), rng)


def _mask(rng, b, tk, full_row=None):
    m = (rng.rand(b, tk) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if full_row is not None:
        m[full_row] = 0.0
    return m


def _port(q, k, v, m, causal=False):
    return packed_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), torch.as_tensor(m),
                            causal=causal).numpy()


@pytest.mark.parametrize("tq,tk,causal", [
    (50, 50, False),            # ragged, not a multiple of 64
    (50, 70, False),            # Tq != Tk
    (33, 33, True),             # causal on a ragged length
])
def test_plain_matches_jax_kernel_interpret(tq, tk, causal):
    q, k, v, rng = _qkv(0, 2, 2, tq, tk)
    m = _mask(rng, 2, tk)
    ref = jpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              kv_mask=jnp.asarray(m), causal=causal, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, m, causal), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def test_fully_masked_row_uniform_matches_jax_kernel_at_64():
    q, k, v, rng = _qkv(1, 2, 2, 64, 64)
    m = _mask(rng, 2, 64, full_row=1)
    ref = jpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              kv_mask=jnp.asarray(m), interpret=True)
    got = _port(q, k, v, m)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    # uniform: every query of the masked row gets the plain mean of V
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), got[1].shape), rtol=TOL, atol=TOL)


def test_fully_masked_row_ragged_matches_jax_dense():
    q, k, v, rng = _qkv(2, 2, 2, 50, 50)
    m = _mask(rng, 2, 50, full_row=0)
    ref = dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask=jnp.asarray(m)[:, None, None, :])
    np.testing.assert_allclose(_port(q, k, v, m), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_no_mask_means_attend_everywhere():
    q, k, v, _ = _qkv(3, 1, 2, 9, 9)
    got = packed_attention(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v))
    ref = _port(q, k, v, np.ones((1, 9), np.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("flash,t", [("auto", 1024), ("on", 16)])
def test_dispatcher_raises_where_jax_picks_flash(flash, t):
    """Where the JAX dispatcher picks its flash kernel, the port's takes
    its own flash attention, ahead of the packed gate: its output is the
    flash wrapper's (on the CPU the kernel's plain version) and matches
    the JAX dispatcher's. Eight queries against t keys keep the JAX
    interpret run short."""
    q, k, v, rng = _qkv(6, 1, 2, 8, t, dh=8)
    m = _mask(rng, 1, t)
    tq, tk, tv, tm = (torch.as_tensor(a) for a in (q, k, v, m))
    out, w = tatt.attention(tq, tk, tv, tm[:, None, None, :], kv_mask=tm,
                            flash=flash, packed="on")
    assert w is None
    assert torch.equal(out, flash_attention(tq, tk, tv, tm))
    ref, jw = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(m)[:, None, None, :],
                            kv_mask=jnp.asarray(m), flash=flash, packed="on")
    assert jw is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_dispatcher_packed_on_runs_plain_version_on_cpu():
    q, k, v, rng = _qkv(4, 2, 2, 12, 12)
    m = _mask(rng, 2, 12)
    tq, tk, tv, tm = (torch.as_tensor(a) for a in (q, k, v, m))
    out, w = tatt.attention(tq, tk, tv, tm[:, None, None, :], kv_mask=tm,
                            packed="on")
    assert w is None
    assert torch.equal(out, packed_attention(tq, tk, tv, tm))


def test_dispatcher_past_cap_goes_dense():
    t = kmod.max_t(64) + 1
    q, k, v, rng = _qkv(5, 1, 1, t, t, dh=64)
    m = _mask(rng, 1, t)
    tq, tk, tv, tm = (torch.as_tensor(a) for a in (q, k, v, m))
    out, _ = tatt.attention(tq, tk, tv, tm[:, None, None, :], kv_mask=tm,
                            packed="on")
    ref, _ = tatt.dense_attention_with_weights(tq, tk, tv,
                                               tm[:, None, None, :])
    assert torch.equal(out, ref)


def test_shared_memory_cap():
    for dh in (32, 64, 128):
        cap = kmod.max_t(dh)
        smem = (lambda n: (2 * n * (dh + 1) + n + 4 * (dh + n)) * 4)
        assert smem(cap) <= 232448 < smem(cap + 1)
    assert kmod.max_t(64) == 428


def test_backward_cap_reaches_the_reference_and_fits_shared_memory():
    """max_t_bwd is at least the old cap and the reference's
    (marian_tpu/ops/auto_tuner.py :: packed_attention_max_t) at every head
    size the kernel is built for, and is the longest T whose block fits
    the 227 KB a Hopper block may use; other head sizes get 0."""
    from marian_tpu.ops.auto_tuner import packed_attention_max_t
    old = {16: 208, 32: 182, 64: 143, 128: 94}
    for dh in (16, 32, 64, 128):
        cap = kmod.max_t_bwd(dh)
        assert cap >= max(old[dh], packed_attention_max_t(dh))
        assert (kmod._bwd_smem_floats(cap, cap, dh) * 4 <= 232448
                < kmod._bwd_smem_floats(cap + 1, cap + 1, dh) * 4)
        # one tile: two sets of Q, dO, K, V (one at Dh 128) and the
        # score tiles also fit
        assert kmod._bwd_smem_floats(64, 64, dh) * 4 <= 232448
    assert [kmod.max_t_bwd(d) for d in (16, 32, 64, 128)] == [
        1868, 867, 278, 2816]
    assert kmod.max_t_bwd(8) == kmod.max_t_bwd(48) == 0


@pytest.mark.parametrize("t,dh,packed_path", [
    (256, 64, True),      # past the old cap (143), within the new one
    (279, 64, False),     # past the new cap
    (40, 8, False)])      # a head size the backward is not built for
def test_dispatcher_with_gradient_follows_the_backward_cap(monkeypatch, t, dh,
                                                           packed_path):
    """With a gradient and packed on, the dispatcher takes the packed
    path (its plain version on the CPU) up to min(max_t, max_t_bwd) and
    the dense path past it or at a head size the backward kernel does
    not take."""
    calls = []
    real = kmod.packed_attention_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(kmod, "packed_attention_reference", counted)
    q, k, v, rng = _qkv(7, 1, 2, t, t, dh=dh)
    m = _mask(rng, 1, t)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tm = torch.as_tensor(m)
    mask = tm[:, None, None, :] * torch.tril(torch.ones(t, t))[None, None]
    out, _ = tatt.attention(tq, tk, tv, mask, kv_mask=tm, causal=True,
                            packed="on")
    assert bool(calls) == packed_path
    ref = (packed_attention(tq, tk, tv, tm, causal=True) if packed_path
           else tatt.dense_attention_with_weights(tq, tk, tv, mask)[0])
    assert torch.equal(out, ref)
