"""marian_tpu_torch ops vs marian_tpu.ops at tiny shapes (2e-5, f32).

Inputs come from a numpy seed and go to both packages as numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops import attention as jatt
from marian_tpu.ops import ops as jops
from marian_tpu_torch.ops import attention as tatt
from marian_tpu_torch.ops import ops as tops

torch.set_num_threads(2)

TOL = 2e-5


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_norms_match(norm):
    rng = np.random.RandomState(0)
    x, s, b = _np(rng, 3, 5, 16), _np(rng, 1, 16), _np(rng, 1, 16)
    ref = getattr(jops, norm)(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = getattr(tops, norm)(torch.as_tensor(x), torch.as_tensor(s),
                              torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["relu", "swish", "gelu", "tanh", "sigmoid"])
def test_activations_match(name):
    x = _np(np.random.RandomState(1), 4, 33) * 3
    ref = jops.activation(name)(jnp.asarray(x))
    got = tops.activation(name)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        tops.activation("softplus")


def test_affine_matches():
    rng = np.random.RandomState(2)
    x, w, b = _np(rng, 2, 3, 8), _np(rng, 8, 12), _np(rng, 1, 12)
    ref = jops.affine(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tops.affine(torch.as_tensor(x), torch.as_tensor(w),
                      torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("tq,tk", [(1, 7), (5, 5), (6, 9)])
def test_dense_attention_matches(tq, tk):
    rng = np.random.RandomState(3)
    q, k, v = _np(rng, 2, 2, tq, 8), _np(rng, 2, 2, tk, 8), \
        _np(rng, 2, 2, tk, 8)
    mask = (rng.rand(2, 1, 1, tk) > 0.3).astype(np.float32)
    mask[..., 0] = 1.0
    ro, rw = jatt.dense_attention_with_weights(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    go, gw = tatt.dense_attention_with_weights(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(mask))
    np.testing.assert_allclose(go.numpy(), np.asarray(ro), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=TOL, atol=TOL)


def test_dispatcher_on_cpu_auto_is_dense():
    """On the CPU 'auto' keeps the dense path, like the reference off
    TPU: the packed kernel engages only on the card or with 'on'."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.as_tensor(_np(rng, 2, 2, 6, 8)) for _ in range(3))
    kvm = torch.ones(2, 6)
    out, _ = tatt.attention(q, k, v, kvm[:, None, None, :], kv_mask=kvm)
    ref, _ = tatt.dense_attention_with_weights(q, k, v, kvm[:, None, None, :])
    assert torch.equal(out, ref)


@pytest.mark.parametrize("t", [1, 4])
def test_causal_and_combined_masks_match(t):
    ref = jatt.combine_masks(jatt.causal_mask(t), None,
                             jnp.ones((1, 1, t, t)))
    got = tatt.combine_masks(tatt.causal_mask(t), None, torch.ones(1, 1, t, t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
