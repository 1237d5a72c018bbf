"""The port's decode_attention plain version vs the JAX kernel.

The JAX side runs as tests/test_decode_attention.py runs it on the CPU
(Pallas interpret mode) and through its ``_reference``. The context must
agree within 2e-5 (f32; both sides sum the same f32 products, in another
order) and the new caches must be EXACTLY equal: they are copies plus
one cast insert, and the next step reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.decode_attention import (_reference,
                                                     decode_attention as jda)
from marian_tpu_torch.ops.kernels import decode_attention as kmod
from marian_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_reference)

torch.set_num_threads(2)

R, H, L, DH = 6, 2, 16, 8


def _inputs(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q, kn, vn = (rng.randn(R, H, 1, DH).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(R, H, L, DH).astype(np.float32) for _ in range(2))
    return q, kn, vn, ck, cv, rng


def _src(kind, rng):
    if kind == "none":
        return None
    if kind == "perm":
        return rng.permutation(R).astype(np.int32)
    return rng.randint(0, R, R).astype(np.int32)      # repeats


def _pos(kind, rng):
    return {"first": 0, "mid": 5, "last": L - 1,
            "rows": rng.randint(0, L, R).astype(np.int32)}[kind]


def _torch(x):
    return None if x is None else torch.as_tensor(x)


def _check(got, ref, tol=2e-5):
    out, nk, nv = got
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref[0], np.float32),
                               rtol=tol, atol=tol)
    assert np.array_equal(nk.float().numpy(), np.asarray(ref[1], np.float32))
    assert np.array_equal(nv.float().numpy(), np.asarray(ref[2], np.float32))


@pytest.mark.parametrize("src_kind", ["none", "perm", "repeat"])
@pytest.mark.parametrize("pos_kind", ["first", "mid", "last", "rows"])
def test_plain_matches_jax_kernel_interpret(src_kind, pos_kind):
    q, kn, vn, ck, cv, rng = _inputs(7)
    src, pos = _src(src_kind, rng), _pos(pos_kind, rng)
    ref = jda(*(jnp.asarray(a) for a in (q, kn, vn, ck, cv)),
              jnp.asarray(pos, jnp.int32),
              src_rows=None if src is None else jnp.asarray(src),
              interpret=True)
    got = decode_attention(*(torch.as_tensor(a) for a in (q, kn, vn, ck, cv)),
                           _torch(pos) if isinstance(pos, np.ndarray) else pos,
                           src_rows=_torch(src))
    _check(got, ref)


@pytest.mark.parametrize("src_kind", ["none", "repeat"])
def test_plain_matches_jax_reference(src_kind):
    q, kn, vn, ck, cv, rng = _inputs(8)
    src, pos = _src(src_kind, rng), _pos("rows", rng)
    ref = _reference(*(jnp.asarray(a) for a in (q, kn, vn, ck, cv)),
                     jnp.asarray(pos), None if src is None
                     else jnp.asarray(src), 1.0 / DH ** 0.5)
    got = decode_attention_reference(
        *(torch.as_tensor(a) for a in (q, kn, vn, ck, cv)),
        torch.as_tensor(pos), _torch(src))
    _check(got, ref)


def test_long_cache_matches_jax():
    """A document-length cache (past the kernel's old 442-position cap):
    the JAX function answers through its own path there, and so does the
    port's, at any length."""
    rng = np.random.RandomState(12)
    r, h, length, dh = 3, 2, 1100, 8
    q, kn, vn = (rng.randn(r, h, 1, dh).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(r, h, length, dh).astype(np.float32)
              for _ in range(2))
    src = np.array([2, 0, 2], np.int32)
    pos = np.array([0, 700, length - 1], np.int32)
    ref = jda(*(jnp.asarray(a) for a in (q, kn, vn, ck, cv)),
              jnp.asarray(pos), src_rows=jnp.asarray(src), interpret=True)
    got = decode_attention(*(torch.as_tensor(a) for a in (q, kn, vn, ck, cv)),
                           torch.as_tensor(pos), src_rows=torch.as_tensor(src))
    _check(got, ref)


def test_bf16_caches_keep_their_dtype():
    q, kn, vn, ck, cv, rng = _inputs(9)
    src = _src("repeat", rng)
    ck16, cv16 = (jnp.asarray(a, jnp.bfloat16) for a in (ck, cv))
    ref = jda(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), ck16, cv16,
              jnp.asarray(3, jnp.int32), src_rows=jnp.asarray(src),
              interpret=True)
    got = decode_attention(
        torch.as_tensor(q), torch.as_tensor(kn), torch.as_tensor(vn),
        torch.as_tensor(np.asarray(ck16, np.float32)).to(torch.bfloat16),
        torch.as_tensor(np.asarray(cv16, np.float32)).to(torch.bfloat16),
        3, src_rows=_torch(src))
    assert got[1].dtype == torch.bfloat16 and got[0].dtype == torch.float32
    _check(got, ref)


def test_inputs_are_not_modified_and_cpu_counts_no_launch():
    q, kn, vn, ck, cv, rng = _inputs(10)
    before = kmod.decode_attention.launches
    tck = torch.as_tensor(ck.copy())
    decode_attention(torch.as_tensor(q), torch.as_tensor(kn),
                     torch.as_tensor(vn), tck, torch.as_tensor(cv), 4,
                     src_rows=None)
    assert np.array_equal(tck.numpy(), ck)
    assert kmod.decode_attention.launches == before

