"""The packed attention forward's kernel order of work, in plain PyTorch,
vs the JAX kernel and the port's plain version; and its head-size route.

``packed_attention_tiled_reference`` follows the forward kernel: 64-query
tiles, each walking the 64-key tiles with an online softmax, causal key
tiles after every query skipped where the batch row has a live key at
or before the tile's first query. It must agree with the JAX kernel
(Pallas interpret mode, as tests/test_packed_attention.py runs it) and
with the port's plain version within 2e-5 (f32; sums in another order)
at key lengths of 1, 63, 64, 65, 128 and the routing cap max_t(64),
causal and cross. Fully masked rows are held against the JAX dense path,
because the TPU kernel averages them over its padding to 64 keys (see
tests/test_torch_packed_attention.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.attention import dense_attention
from marian_tpu.ops.pallas.packed_attention import packed_attention as jpa
from marian_tpu_torch.ops.kernels import packed_attention as kmod
from marian_tpu_torch.ops.kernels.packed_attention import (
    fwd_query_tile, packed_attention_reference,
    packed_attention_tiled_reference)

torch.set_num_threads(2)

TOL = 2e-5


def _qkv(seed, b, h, tq, tk, dh):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, tq, dh).astype(np.float32),
            rng.randn(b, h, tk, dh).astype(np.float32),
            rng.randn(b, h, tk, dh).astype(np.float32), rng)


def _mask(rng, b, tk):
    m = (rng.rand(b, tk) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


def _both(q, k, v, m, causal):
    args = [torch.as_tensor(a) for a in (q, k, v, m)]
    return (packed_attention_tiled_reference(*args, causal=causal).numpy(),
            packed_attention_reference(*args, causal=causal).numpy())


@pytest.mark.parametrize("tq,tk,dh,causal", [
    (1, 1, 16, False), (32, 32, 64, False), (20, 90, 64, True),
    (63, 63, 64, True), (64, 64, 64, False),
    (65, 65, 64, True), (128, 128, 32, False), (50, 65, 64, False),
    (130, 70, 16, True), (428, 428, 64, True), (100, 428, 64, False)])
def test_tiled_forward_matches_jax_kernel_and_plain(tq, tk, dh, causal):
    b, h = (1, 2) if tk > 128 else (2, 2)
    q, k, v, rng = _qkv(tq + tk + dh, b, h, tq, tk, dh)
    m = _mask(rng, b, tk)
    ref = jpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              kv_mask=jnp.asarray(m), causal=causal, interpret=True)
    tiled, plain = _both(q, k, v, m, causal)
    np.testing.assert_allclose(tiled, np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tiled, plain, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, False), (65, 65, True),
                                          (150, 150, True), (40, 130, False)])
def test_tiled_forward_fully_masked_rows_match_jax_dense(tq, tk, causal):
    """Batch row 1 masks every key (uniform over the Tk real keys); batch
    row 0's first live key (70 past 128 keys, else 3) lies inside a tile,
    so with causal its first query rows see no live key and the tile
    skip must keep every tile for the query tiles before it."""
    q, k, v, rng = _qkv(tq * tk, 3, 2, tq, tk, 32)
    m = _mask(rng, 3, tk)
    m[1] = 0.0
    m[0, :70 if tk > 128 else 3] = 0.0
    mask = jnp.asarray(m)[:, None, None, :]
    if causal:
        mask = mask * jnp.tril(jnp.ones((tq, tk)))[None, None]
    ref = dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask=mask)
    tiled, plain = _both(q, k, v, m, causal)
    np.testing.assert_allclose(tiled, np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tiled, plain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tiled[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), tiled[1].shape), rtol=TOL,
        atol=TOL)


@pytest.mark.parametrize("dh,route", [(16, "tiles"), (32, "tiles"),
                                      (64, "tiles"), (128, "tiles"),
                                      (8, "generic"), (48, "generic"),
                                      (80, "generic"), (256, "generic")])
def test_forward_head_size_route(dh, route):
    """The tile kernel at the head sizes it is built for (those of the
    backward), the generic kernel (query tile 0) at any other."""
    assert (fwd_query_tile(dh, 64) > 0) == (route == "tiles")
    assert (route == "tiles") == (dh in kmod.BWD_HEAD_SIZES)


@pytest.mark.parametrize("dh,tq,tile", [(64, 1, 32), (64, 32, 32),
                                        (64, 33, 64), (64, 64, 64),
                                        (16, 428, 64), (128, 20, 32),
                                        (48, 20, 0), (48, 200, 0)])
def test_forward_query_tile_rule(dh, tq, tile):
    """32 query rows a block up to 32 queries, else 64; 0 (the generic
    kernel) at a head size the tile kernel is not built for."""
    assert fwd_query_tile(dh, tq) == tile


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_forward_unaligned_operands_take_the_generic_kernel(dh):
    """The tile kernel stages by 16-byte copies: operands that are not
    all 16-byte aligned take the generic kernel (query tile 0) at every
    head size."""
    assert fwd_query_tile(dh, 64, aligned=True) > 0
    assert fwd_query_tile(dh, 64, aligned=False) == 0


def test_routing_cap_unchanged():
    """max_t keeps the former kernel's value at every head size, so the
    dispatcher routes as before."""
    assert [kmod.max_t(d) for d in (16, 32, 48, 64, 128)] == [
        1488, 816, 562, 428, 219]
