"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a card every test here skips. On the
machine with the card (which has no JAX, so the repo's conftest is left
out):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Shapes are small and odd on purpose: lengths that are not multiples of a
warp, a cache and a key length whose block tiles need more than 48 KB of
shared memory (the dynamic-limit path), bf16 operands. Tolerances: 2e-5
for f32 outputs (f32 sums in another order), 2e-2 for bf16 outputs (one
bf16 rounding of the result); new caches are exact copies.
"""

import pytest
import torch

from marian_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_reference)
from marian_tpu_torch.ops.kernels.packed_attention import (
    packed_attention, packed_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dev, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("r,h,L,dh", [(5, 3, 17, 32), (12, 2, 100, 64),
                                      (7, 1, 200, 128)])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(dev, r, h, L, dh, cache_dtype):
    gen = torch.Generator().manual_seed(r * L)
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh) for _ in range(3))
    ck, cv = (_randn(gen, dev, r, h, L, dh, dtype=cache_dtype)
              for _ in range(2))
    src = torch.randint(0, r, (r,), generator=gen).to(dev, torch.int32)
    pos = torch.randint(0, L, (r,), generator=gen).to(dev, torch.int32)
    before = decode_attention.launches
    for p in (pos, 0, L - 1):
        out, nk, nv = decode_attention(q, kn, vn, ck, cv, p, src_rows=src)
        ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, p, src)
        torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
        assert torch.equal(nk, rk) and torch.equal(nv, rv)
    assert decode_attention.launches == before + 3


def test_decode_attention_ping_pong_buffers(dev):
    gen = torch.Generator().manual_seed(0)
    r, h, L, dh = 6, 2, 9, 16
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh) for _ in range(3))
    ck, cv = (_randn(gen, dev, r, h, L, dh) for _ in range(2))
    bk, bv = torch.empty_like(ck), torch.empty_like(cv)
    out, nk, nv = decode_attention(q, kn, vn, ck, cv, 4, out_k=bk, out_v=bv)
    assert nk.data_ptr() == bk.data_ptr() and nv.data_ptr() == bv.data_ptr()
    ro, rk, _ = decode_attention_reference(q, kn, vn, ck, cv, 4)
    torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
    assert torch.equal(nk, rk)
    with pytest.raises(ValueError, match="alias"):
        decode_attention(q, kn, vn, ck, cv, 4, out_k=ck, out_v=bv)


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", [
    (3, 2, 7, 7, 64, False), (2, 3, 33, 50, 32, False),
    (2, 2, 45, 45, 64, True), (1, 2, 200, 200, 64, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_matches_plain(dev, b, h, tq, tk, dh, causal,
                                        dtype):
    gen = torch.Generator().manual_seed(tq * tk)
    q = _randn(gen, dev, b, h, tq, dh, dtype=dtype)
    k, v = (_randn(gen, dev, b, h, tk, dh, dtype=dtype) for _ in range(2))
    kvm = (torch.rand(b, tk, generator=gen) > 0.3).float()
    kvm[:, 0] = 1.0
    kvm[-1] = 0.0                                   # a fully-masked row
    kvm = kvm.to(dev)
    out = packed_attention(q, k, v, kvm, causal=causal)
    ref = packed_attention_reference(q, k, v, kvm, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
