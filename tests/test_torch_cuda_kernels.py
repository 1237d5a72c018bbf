"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a card every test here skips. On the
machine with the card (which has no JAX, so the repo's conftest is left
out):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Shapes are small and odd on purpose: lengths that are not multiples of a
warp, a cache and a key length whose block tiles need more than 48 KB of
shared memory (the dynamic-limit path), decode caches of 1,024 and more
positions (many chunks of the streamed cache), bf16 operands, for the
flash kernels lengths that are not multiples of their 64- and 128-row
tiles, every head size they are built for and Dh 8, 48 and 80 (run
zero-padded to 16, 64 and 128, results at the real Dh), a fully masked
row, a row whose first live key lies inside a tile, a cross case with
fewer keys than queries and determinism checks, each case asserting its
route (aligned bf16 forward, dq and dkv on the tensor cores, held to one
bf16 spacing of the plain backward fed their own out and lse; an
unaligned bf16 view on the CUDA cores), for the packed forward the bf16
tensor-core kernel at its built head sizes, aligned or copied (one bf16
spacing of the plain version), for the packed backward the
bf16 one-tile kernel on the tensor cores up to 64 tokens (one bf16
spacing of the plain version, two calls bit-identical), and for the fused
CE token counts, vocabularies and hidden sizes that are not multiples of
its 128 x 256 tiles, a vocabulary under one tile, labels on the tile
edges, a hidden size that is not a multiple of 4 (scalar loads), forced
narrow vocabulary chunks in the backward and determinism checks of the
forward and the backward, and for the paged decode
read both routes (the vector kernel at pages that tile its chunks,
the scalar one at pages that do not and at Dh 36 in bf16), page tables
permuted over a larger pool, rows that share pages, a row past its
span, idle rows, rows at page boundaries and a determinism check.
Tolerances: 2e-5 for f32
outputs (f32 sums in another order), 2e-2 for bf16 outputs (one bf16
rounding of the result); new caches are exact copies. The packed
backward's f32 gradients and the fused CE's outputs are held to 1e-5
of the output's largest magnitude: each is a sum of hundreds to
thousands of products, taken in another order than the plain version's.
"""

import pytest
import torch

from marian_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_reference)
from marian_tpu_torch.ops.kernels import flash_attention as fa
from marian_tpu_torch.ops.ops import NEG_INF
from marian_tpu_torch.ops.kernels import fused_ce as fce
from marian_tpu_torch.ops.kernels import kv_pool as kv
from marian_tpu_torch.ops.kernels.packed_attention import (
    packed_attention, packed_attention_bwd, packed_attention_bwd_reference,
    packed_attention_reference)

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
                                      (7, 1, 200, 128), (6, 2, 1024, 64),
                                      (4, 3, 2048, 64), (3, 2, 1100, 128),
                                      (5, 2, 77, 20), (4, 3, 45, 40),
                                      (3, 2, 70, 30), (2, 2, 33, 256)])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(dev, r, h, L, dh, cache_dtype):
    """Lengths that are not multiples of a chunk, head sizes on the vector
    path (any 16-byte row) and on the scalar one (Dh 30; Dh 20 with a
    bf16 cache), pos per row, 0, L - 1, -1 (every position masked) and
    past L (the insert clamps to L - 1, every position live)."""
    gen = torch.Generator().manual_seed(r * L)
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh) for _ in range(3))
    ck, cv = (_randn(gen, dev, r, h, L, dh, dtype=cache_dtype)
              for _ in range(2))
    src = torch.randint(0, r, (r,), generator=gen).to(dev, torch.int32)
    pos = torch.randint(0, L, (r,), generator=gen).to(dev, torch.int32)
    before = decode_attention.launches
    for p in (pos, 0, L - 1, -1, L + 5):
        out, nk, nv = decode_attention(q, kn, vn, ck, cv, p, src_rows=src)
        ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, p, src)
        torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
        assert torch.equal(nk, rk) and torch.equal(nv, rv)
    assert decode_attention.launches == before + 5


@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_decode_attention_bf16_queries(dev, q_dtype, cache_dtype):
    gen = torch.Generator().manual_seed(3)
    r, h, L, dh = 6, 4, 150, 64
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh, dtype=q_dtype)
                 for _ in range(3))
    ck, cv = (_randn(gen, dev, r, h, L, dh, dtype=cache_dtype)
              for _ in range(2))
    src = torch.tensor([1, 1, 0, 5, 3, 3], device=dev, dtype=torch.int32)
    pos = torch.tensor([0, 149, 70, -1, 200, 31], device=dev,
                       dtype=torch.int32)
    out, nk, nv = decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
    ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, pos, src)
    assert out.dtype == q_dtype
    torch.testing.assert_close(out.float(), ro.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(nk, rk) and torch.equal(nv, rv)


@pytest.mark.parametrize("r,h,L,dh,pos", [
    (6, 16, 1024, 64, [0, 1023, 700, -1, 5000, 64]),
    (6, 2, 2000, 128, [1999, 3, 1000, 0, -1, 1500])])
def test_decode_attention_few_rows_match_plain_and_are_deterministic(
        dev, r, h, L, dh, pos):
    """One sentence at beam 6 over a long cache: few (row, head) pairs,
    each block walking many chunks; two calls give the same bits."""
    gen = torch.Generator().manual_seed(L)
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh) for _ in range(3))
    ck, cv = (_randn(gen, dev, r, h, L, dh) for _ in range(2))
    src = torch.tensor([2, 2, 0, 1, 5, 4], device=dev, dtype=torch.int32)
    p = torch.tensor(pos, device=dev, dtype=torch.int32)
    first = decode_attention(q, kn, vn, ck, cv, p, src_rows=src)
    second = decode_attention(q, kn, vn, ck, cv, p, src_rows=src)
    ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, p, src)
    torch.testing.assert_close(first[0], ro, rtol=2e-5, atol=2e-5)
    assert torch.equal(first[1], rk) and torch.equal(first[2], rv)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_decode_attention_is_deterministic(dev):
    gen = torch.Generator().manual_seed(11)
    r, h, L, dh = 48, 16, 1024, 64
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh) for _ in range(3))
    ck, cv = (_randn(gen, dev, r, h, L, dh) for _ in range(2))
    src = torch.randint(0, r, (r,), generator=gen).to(dev, torch.int32)
    pos = torch.randint(-1, L, (r,), generator=gen).to(dev, torch.int32)
    first = decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
    second = decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_decode_attention_unaligned_cache_takes_the_scalar_path(dev):
    """A cache view 4 bytes off a 16-byte boundary: the launcher takes
    the scalar kernel by shape, and the answer is the same."""
    gen = torch.Generator().manual_seed(5)
    r, h, L, dh = 4, 2, 40, 64
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh) for _ in range(3))
    flat = _randn(gen, dev, 2 * r * h * L * dh + 2)
    ck = flat[1:1 + r * h * L * dh].view(r, h, L, dh)
    cv = flat[2 + r * h * L * dh:].view(r, h, L, dh)
    assert ck.data_ptr() % 16 != 0
    out, nk, nv = decode_attention(q, kn, vn, ck, cv, 17)
    ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, 17)
    torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
    assert torch.equal(nk, rk) and torch.equal(nv, rv)


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


@pytest.mark.parametrize("r,h,dh,page_len,mp", [
    (5, 3, 64, 16, 8), (7, 2, 32, 4, 5), (4, 1, 128, 16, 3),
    (6, 2, 64, 7, 40), (3, 4, 16, 16, 130), (6, 2, 64, 8, 9),
    (6, 2, 64, 32, 5), (5, 2, 64, 64, 3), (6, 2, 64, 5, 12),
    (6, 2, 36, 16, 6), (40, 8, 64, 16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_matches_plain(dev, r, h, dh, page_len, mp,
                                              dtype):
    """Both routes: the vector kernel (whole pages in a chunk at pages of
    4-32, parts of a page at 64; two and four chunk buffers) and the
    scalar one (pages of 5 and 7 tile no chunk; Dh 36 in bf16 is no
    whole number of 16-byte vectors). Rows 3 and 4 share their first
    pages, as the prefix cache sends them; row 3 sits past its span. Two
    calls give the same bits."""
    gen = torch.Generator().manual_seed(r * mp + dh + page_len)
    n_pages = 1 + 2 * r * mp
    q, kn, vn = (_randn(gen, dev, r, h, 1, dh, dtype=dtype)
                 for _ in range(3))
    pk, pv = (_randn(gen, dev, n_pages, h, page_len, dh, dtype=dtype)
              for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen)[:r * mp] + 1
             ).reshape(r, mp)
    span = mp * page_len
    pos = torch.randint(-1, span, (r,), generator=gen)
    pos[:3] = torch.tensor([-1, page_len, span - 1])
    if r > 4:
        shared = (mp + 1) // 2           # the write pages stay private
        table[4, :shared] = table[3, :shared]
        pos[3], pos[4] = span + 5, span - 1
    table, pos = table.to(dev, torch.int32), pos.to(dev, torch.int32)
    route = kv.paged_route(r, h, dh, pk.element_size(), page_len, mp)
    scalar = page_len in (5, 7) or (dh == 36 and dtype == torch.bfloat16)
    assert (route == (0, 0, 0)) == scalar
    before = kv.paged_decode_attention.launches
    gk, gv = pk.clone(), pv.clone()
    out = kv.paged_decode_attention(q, kn, vn, gk, gv, table, pos)
    assert kv.paged_decode_attention.launches == before + 1
    rk, rv = pk.clone(), pv.clone()
    kv.pool_insert(rk, rv, kn, vn, table, pos)
    ref = kv.paged_decode_attention_reference(q, rk, rv, table, pos)
    assert torch.equal(gk, rk) and torch.equal(gv, rv)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    again = kv.paged_decode_attention_read(q, gk, gv, table, pos)
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", [
    (3, 2, 7, 7, 64, False), (2, 3, 33, 50, 32, False),
    (2, 2, 45, 45, 64, True), (1, 2, 200, 200, 64, False),
    (3, 2, 64, 64, 64, True), (2, 2, 65, 65, 64, True),
    (2, 2, 40, 65, 16, False), (2, 2, 128, 128, 128, True),
    (1, 2, 428, 428, 64, True), (2, 3, 100, 428, 64, False),
    (2, 2, 70, 50, 48, True), (2, 2, 33, 33, 48, False),
    (3, 2, 32, 32, 64, True), (3, 2, 20, 90, 64, True),
    (2, 2, 30, 30, 128, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_matches_plain(dev, b, h, tq, tk, dh, causal,
                                        dtype):
    """One tile pair (up to 64), key tiles walked past it (65, 128 and
    the routing cap 428), more query tiles than one, 32-query tiles (up
    to 32 queries), a fully masked row, past 128 keys a row whose first
    live key (70) lies inside a tile, and Dh 48, which the generic kernel
    takes. bf16 at the built head sizes takes the tensor cores
    (``launches_bf16_tc``), held to one bf16 spacing of the plain
    version."""
    gen = torch.Generator().manual_seed(tq * tk)
    q = _randn(gen, dev, b, h, tq, dh, dtype=dtype)
    k, v = (_randn(gen, dev, b, h, tk, dh, dtype=dtype) for _ in range(2))
    kvm = (torch.rand(b, tk, generator=gen) > 0.3).float()
    kvm[:, 0] = 1.0
    if tk > 128:
        kvm[0, :70] = 0.0
    kvm[-1] = 0.0                                   # a fully-masked row
    kvm = kvm.to(dev)
    before = (packed_attention.launches, packed_attention.launches_bf16_tc)
    out = packed_attention(q, k, v, kvm, causal=causal)
    ref = packed_attention_reference(q, k, v, kvm, causal=causal)
    tc = dtype == torch.bfloat16 and dh in (16, 32, 64, 128)
    assert (packed_attention.launches, packed_attention.launches_bf16_tc) == (
        before[0] + (not tc), before[1] + tc)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if tc:
        _close_bf16(out, ref, 1e-5)


@pytest.mark.parametrize("tq,tk,dh,causal", [(64, 64, 64, False),
                                             (200, 200, 64, True),
                                             (32, 70, 64, True),
                                             (50, 40, 48, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_is_deterministic(dev, tq, tk, dh, causal, dtype):
    gen = torch.Generator().manual_seed(tq + dh)
    q = _randn(gen, dev, 3, 4, tq, dh, dtype=dtype)
    k, v = (_randn(gen, dev, 3, 4, tk, dh, dtype=dtype) for _ in range(2))
    kvm = torch.ones(3, tk, device=dev)
    kvm[1, tk // 2:] = 0.0
    first = packed_attention(q, k, v, kvm, causal=causal)
    second = packed_attention(q, k, v, kvm, causal=causal)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_unaligned_views_match_plain(dev, dtype):
    """q, k and v views one element off a 16-byte boundary: the f32
    forward takes the generic kernel by shape, the bf16 one and the
    backward copy them to aligned buffers (the bf16 forward then runs on
    the tensor cores), and both agree with the plain version."""
    gen = torch.Generator().manual_seed(9)
    b, h, t, dh = 3, 4, 40, 64
    n = b * h * t * dh
    flat = _randn(gen, dev, 3 * n + 1, dtype=dtype)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(b, h, t, dh)
               for i in range(3))
    assert all(x.data_ptr() % 16 != 0 for x in (q, k, v))
    kvm = torch.ones(b, t, device=dev)
    kvm[1, 30:] = 0.0
    before = (packed_attention.launches, packed_attention.launches_bf16_tc)
    out = packed_attention(q, k, v, kvm, causal=True)
    tc = dtype == torch.bfloat16
    assert (packed_attention.launches, packed_attention.launches_bf16_tc) == (
        before[0] + (not tc), before[1] + tc)
    ref = packed_attention_reference(q, k, v, kvm, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if tc:
        _close_bf16(out, ref, 1e-5)
    do = _randn(gen, dev, b, h, t, dh, dtype=dtype)
    got = packed_attention_bwd(q, k, v, kvm, do, out, causal=True)
    want = packed_attention_bwd_reference(q, k, v, kvm, do, out, causal=True)
    for g, w in zip(got, want):
        if dtype == torch.float32:
            _close_to_scale(g, w, 1e-5)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)


def _close_to_scale(got, ref, rel):
    """|got - ref| <= rel * max|ref| (sums in another order)."""
    got, ref = got.detach(), ref.detach()
    scale = max(float(ref.abs().max()), 1.0)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= rel * scale, (err, scale)


def _close_bf16(got, ref, rel):
    """A bf16 output against its plain version, which rounds its own f32
    sum: |got - ref| <= one bf16 spacing of ref (at most 2^-7 of it) +
    rel * max|ref|; an f32 output as ``_close_to_scale``."""
    if ref.dtype != torch.bfloat16:
        return _close_to_scale(got, ref, rel)
    assert got.dtype == torch.bfloat16
    got, ref = got.detach().float(), ref.detach().float()
    scale = max(float(ref.abs().max()), 1.0)
    over = (got - ref).abs() - (2.0 ** -7 * ref.abs() + rel * scale)
    assert float(over.max()) <= 0.0, float(over.max())


def _packed_bwd_inputs(dev, b, h, tq, tk, dh, dtype=torch.float32):
    """q, k, v, dO and a key mask with a fully masked row and, past two
    key tiles, a row whose first live key (70) lies inside a tile."""
    gen = torch.Generator().manual_seed(tq * tk + dh)
    q = _randn(gen, dev, b, h, tq, dh, dtype=dtype)
    k, v = (_randn(gen, dev, b, h, tk, dh, dtype=dtype) for _ in range(2))
    do = _randn(gen, dev, b, h, tq, dh, dtype=dtype)
    kvm = (torch.rand(b, tk, generator=gen) > 0.3).float()
    kvm[:, 0] = 1.0
    if tk > 128:
        kvm[0, :70] = 0.0
    kvm[-1] = 0.0                                   # a fully-masked row
    return q, k, v, do, kvm.to(dev)


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", [
    (3, 2, 17, 17, 32, False), (2, 3, 33, 33, 64, True),
    (2, 2, 20, 13, 64, False), (2, 8, 64, 64, 64, True),
    (1, 2, 130, 130, 64, False), (2, 2, 200, 200, 64, True),
    (2, 3, 256, 256, 64, True), (2, 2, 256, 180, 64, False),
    (2, 2, 128, 128, 128, True), (1, 2, 182, 182, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_bwd_matches_plain(dev, b, h, tq, tk, dh, causal,
                                            dtype):
    if causal and tq != tk:
        pytest.skip("causal self-attention has Tq == Tk")
    q, k, v, do, kvm = _packed_bwd_inputs(dev, b, h, tq, tk, dh, dtype)
    out = packed_attention(q, k, v, kvm, causal=causal)
    before = (packed_attention_bwd.launches,
              packed_attention_bwd.launches_bf16_tc)
    got = packed_attention_bwd(q, k, v, kvm, do, out, causal)
    ref = packed_attention_bwd_reference(q, k, v, kvm, do, out, causal)
    # bf16 up to 64 tokens takes the tensor cores, held to one bf16
    # spacing of the plain version
    tc = dtype == torch.bfloat16 and max(tq, tk) <= 64
    assert (packed_attention_bwd.launches,
            packed_attention_bwd.launches_bf16_tc) == (
                before[0] + (not tc), before[1] + tc)
    for g, r in zip(got, ref):
        if dtype == torch.float32:
            _close_to_scale(g, r, 1e-5)
        elif tc:
            _close_bf16(g, r, 1e-5)
        else:
            torch.testing.assert_close(g.float(), r.float(), rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.parametrize("t,dh,causal,dtype", [
    (64, 64, False, torch.float32), (256, 64, True, torch.float32),
    (128, 128, False, torch.float32), (64, 64, True, torch.bfloat16),
    (50, 128, False, torch.bfloat16), (64, 16, False, torch.bfloat16)])
def test_packed_attention_bwd_is_deterministic(dev, t, dh, causal, dtype):
    # one writer per gradient element and a fixed summation order: two
    # calls give the same bits, in one tile and across tiles, and on the
    # tensor cores (bf16 up to 64 tokens)
    q, k, v, do, kvm = _packed_bwd_inputs(dev, 3, 4, t, t, dh, dtype)
    out = packed_attention(q, k, v, kvm, causal=causal)
    first = packed_attention_bwd(q, k, v, kvm, do, out, causal)
    second = packed_attention_bwd(q, k, v, kvm, do, out, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_packed_attention_autograd_runs_both_kernels(dev):
    gen = torch.Generator().manual_seed(7)
    q, k, v = (_randn(gen, dev, 2, 2, 9, 16).requires_grad_(True)
               for _ in range(3))
    kvm = torch.ones(2, 9, device=dev)
    fwd, bwd = packed_attention.launches, packed_attention_bwd.launches
    out = packed_attention(q, k, v, kvm, causal=True)
    do = torch.randn(out.shape, generator=gen).to(dev)
    out.backward(do)
    assert (packed_attention.launches, packed_attention_bwd.launches) == (
        fwd + 1, bwd + 1)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    packed_attention_reference(qr, kr, vr, kvm, causal=True).backward(do)
    for g, r in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        _close_to_scale(g, r, 1e-5)


@pytest.mark.parametrize("n,v,e,chunk", [
    (70, 200, 48, None), (64, 64, 32, None), (300, 1000, 512, None),
    (129, 3001, 96, None), (200, 1000, 1024, None), (130, 515, 1500, None),
    (301, 3001, 96, 500), (130, 515, 1500, 200), (129, 700, 50, 128),
    (1100, 300, 64, None), (70, 200, 50, None), (130, 257, 64, None),
    (133, 513, 1024, None), (4001, 32003, 512, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_kernels_match_plain(dev, n, v, e, chunk, dtype):
    """With ``chunk`` the joint backward runs over forced narrow
    vocabulary chunks (several, the last one ragged); E = 50 takes the
    scalar loads; small tile counts split the dx and dw reductions into
    slices (``k_splits``). The first labels lie on the forward's tile
    edges (columns 0, 255, 256 and V - 1); V 200 is under one tile, V 257
    leaves one column in the last; N 4,001, V 32,003 leaves ragged tiles
    in every product over 16 chunks. In bf16 (x and w; b f32) the
    forward and the backward count on ``.launches_bf16_tc`` (the
    tensor-core kernels) where E % 8 == 0 and on ``.launches_bf16`` (the
    CUDA-core ones) otherwise, and the other path's counter does not
    move; dx and dw come out bf16 and are held to one bf16 spacing of the
    plain version's."""
    gen = torch.Generator().manual_seed(n + v + e)
    x = _randn(gen, dev, n, e, dtype=dtype)
    w = (_randn(gen, dev, v, e) * (e ** -0.5)).to(dtype)
    b = _randn(gen, dev, v)
    labels = torch.randint(0, v, (n,), generator=gen)
    edges = [c for c in (0, 255, 256, v - 1) if c < v]
    labels[:len(edges)] = torch.tensor(edges)
    labels = labels.to(dev)
    count = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    path = ("launches_bf16_tc" if dtype == torch.bfloat16 and e % 8 == 0
            else count)
    counters = ((fce.fused_ce_stats, path), (fce.fused_ce_dx, path),
                (fce.fused_ce_dw, path), (fce.fused_ce_dx, "launches_bf16"),
                (fce.fused_ce_dx, "launches_bf16_tc"),
                (fce.fused_ce_stats, "launches_bf16"),
                (fce.fused_ce_stats, "launches_bf16_tc"))
    launches = tuple(getattr(c, a) for c, a in counters)
    got = fce.fused_ce_stats(x, w, b, labels)
    ref = fce.fused_ce_stats_reference(x, w, b, labels)
    for g, r in zip(got, ref):
        _close_to_scale(g, r, 1e-5)
    g_lse, g_lab, g_tot = (_randn(gen, dev, n) for _ in range(3))
    if chunk is None:
        dx = fce.fused_ce_dx(x, w, b, labels, ref[0], g_lse, g_lab, g_tot)
        dw, db = fce.fused_ce_dw(x, w, b, labels, ref[0], g_lse, g_lab,
                                 g_tot)
    else:
        dx, dw, db = fce.fused_ce_bwd(x, w, b, labels, ref[0], g_lse, g_lab,
                                      g_tot, chunk=chunk)
    rdx, rdw, rdb = fce.fused_ce_bwd_reference(x, w, b, labels, ref[0],
                                               g_lse, g_lab, g_tot)
    assert (dx.dtype, dw.dtype, db.dtype) == (dtype, dtype, torch.float32)
    _close_bf16(dx, rdx, 1e-5)
    _close_bf16(dw, rdw, 1e-5)
    _close_to_scale(db, rdb, 1e-5)
    # each path's counter moved by one, the other bf16 path's not at all
    moved = [getattr(c, a) - k for (c, a), k in zip(counters, launches)]
    if dtype == torch.bfloat16:
        assert moved == [1, 1, 1] + ([0, 1] if e % 8 == 0 else [1, 0]) * 2
    else:
        assert moved == [1, 1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_bwd_is_deterministic(dev, dtype):
    """The same inputs twice give bit-identical dx, dw and db (fixed
    chunk order, no atomics), also over several chunks; in bf16 on the
    tensor-core kernels (E 256)."""
    gen = torch.Generator().manual_seed(11)
    n, v, e = 1000, 5003, 256
    x = _randn(gen, dev, n, e, dtype=dtype)
    w = (_randn(gen, dev, v, e) * (e ** -0.5)).to(dtype)
    b = _randn(gen, dev, v)
    labels = torch.randint(0, v, (n,), generator=gen).to(dev)
    lse = fce.fused_ce_stats_reference(x, w, b, labels)[0]
    g = [_randn(gen, dev, n) for _ in range(3)]
    tc = fce.fused_ce_dx.launches_bf16_tc
    for chunk in (None, 1000):
        one = fce.fused_ce_bwd(x, w, b, labels, lse, *g, chunk=chunk)
        two = fce.fused_ce_bwd(x, w, b, labels, lse, *g, chunk=chunk)
        assert all(torch.equal(p, q) for p, q in zip(one, two))
    assert fce.fused_ce_dx.launches_bf16_tc == tc + 4 * (
        dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_fwd_is_deterministic(dev, dtype):
    """The same inputs twice give bit-identical lse, lab and tot (the
    tiles' partials merged in vocabulary order, no atomics); in bf16 on
    the tensor-core kernel, at a ragged N (1,000 = 7 x 128 + 104) and V
    (5,003 = 39 x 128 + 11)."""
    gen = torch.Generator().manual_seed(13)
    n, v, e = 1000, 5003, 256
    x = _randn(gen, dev, n, e, dtype=dtype)
    w = (_randn(gen, dev, v, e) * (e ** -0.5)).to(dtype)
    b = _randn(gen, dev, v)
    labels = torch.randint(0, v, (n,), generator=gen).to(dev)
    tc = fce.fused_ce_stats.launches_bf16_tc
    one = fce.fused_ce_stats(x, w, b, labels)
    two = fce.fused_ce_stats(x, w, b, labels)
    assert all(torch.equal(p, q) for p, q in zip(one, two))
    assert fce.fused_ce_stats.launches_bf16_tc == tc + 2 * (
        dtype == torch.bfloat16)


def test_fused_ce_fwd_unaligned_bf16_takes_the_cuda_cores(dev):
    """A bf16 x that is a view one element into its storage (contiguous,
    not 16-byte aligned) takes the CUDA-core forward (``fwd_route``),
    counted on ``.launches_bf16``, and matches the plain version."""
    gen = torch.Generator().manual_seed(17)
    n, v, e = 300, 1000, 64
    store = _randn(gen, dev, n * e + 1, dtype=torch.bfloat16)
    x = store[1:].view(n, e)
    w = (_randn(gen, dev, v, e) * (e ** -0.5)).to(torch.bfloat16)
    b = _randn(gen, dev, v)
    labels = torch.randint(0, v, (n,), generator=gen).to(dev)
    assert x.is_contiguous() and fce.fwd_route(x, w) == ("fused_ce_fwd", 256)
    launches = (fce.fused_ce_stats.launches_bf16,
                fce.fused_ce_stats.launches_bf16_tc)
    got = fce.fused_ce_stats(x, w, b, labels)
    assert (fce.fused_ce_stats.launches_bf16,
            fce.fused_ce_stats.launches_bf16_tc) == (launches[0] + 1,
                                                     launches[1])
    for g, r in zip(got, fce.fused_ce_stats_reference(x, w, b, labels)):
        _close_to_scale(g, r, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_softmax_xent_gradients_match_dense(dev, dtype):
    """One backward of the loss counts one dx and one dw launch: the
    logits are recomputed once for both. f32: against autograd of the
    dense loss; bf16: against the same function on CPU copies (the plain
    version, which rounds d to bf16 before dx and dw, as the reference
    does)."""
    gen = torch.Generator().manual_seed(3)
    n, v, e = 100, 333, 64
    x = _randn(gen, dev, n, e, dtype=dtype).requires_grad_(True)
    w = (_randn(gen, dev, v, e) * 0.125).to(dtype).requires_grad_(True)
    b = _randn(gen, dev, v).requires_grad_(True)
    labels = torch.randint(0, v, (n,), generator=gen).to(dev)
    ce = fce.fused_softmax_xent(x, w, b, labels, 0.1)
    # bf16 at E 64: the tensor-core backward
    count = "launches_bf16_tc" if dtype == torch.bfloat16 else "launches"
    launches = (getattr(fce.fused_ce_dx, count),
                getattr(fce.fused_ce_dw, count))
    ce.sum().backward()
    assert (getattr(fce.fused_ce_dx, count),
            getattr(fce.fused_ce_dw, count)) == (
        launches[0] + 1, launches[1] + 1)
    xr, wr, br = (t.detach().requires_grad_(True) for t in (x, w, b))
    if dtype == torch.float32:
        logits = xr @ wr.t() + br
        ref = torch.nn.functional.cross_entropy(
            logits, labels, reduction="none", label_smoothing=0.1)
    else:
        xr, wr, br = (t.detach().cpu().requires_grad_(True)
                      for t in (x, w, b))
        ref = fce.fused_softmax_xent(xr, wr, br, labels.cpu(), 0.1)
    ref.sum().backward()
    _close_to_scale(ce, ref.to(dev), 1e-5)
    for g, r in ((x.grad, xr.grad), (w.grad, wr.grad), (b.grad, br.grad)):
        _close_bf16(g, r.to(dev), 1e-5)


def test_fused_ce_refuses_mixed_operand_types(dev):
    """bf16 x with f32 w (and the other way) raises before any launch:
    nothing casts one to the other's type."""
    x = torch.zeros(8, 16, device=dev)
    w = torch.zeros(32, 16, device=dev)
    b = torch.zeros(32, device=dev)
    labels = torch.zeros(8, dtype=torch.int32, device=dev)
    launches = (fce.fused_ce_stats.launches, fce.fused_ce_stats.launches_bf16,
                fce.fused_ce_stats.launches_bf16_tc)
    for xx, ww in ((x.bfloat16(), w), (x, w.bfloat16())):
        with pytest.raises(TypeError):
            fce.fused_ce_stats(xx, ww, b, labels)
        with pytest.raises(TypeError):
            fce.fused_ce_bwd(xx, ww, b, labels, *(torch.zeros(8, device=dev)
                                                  for _ in range(4)))
    assert (fce.fused_ce_stats.launches, fce.fused_ce_stats.launches_bf16,
            fce.fused_ce_stats.launches_bf16_tc) == launches


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", [
    (2, 2, 64, 64, 64, False), (2, 3, 100, 130, 32, False),
    (3, 2, 150, 150, 64, True), (2, 2, 1000, 1100, 64, False),
    (1, 2, 70, 45, 16, False), (2, 1, 129, 129, 128, True),
    (2, 2, 1050, 1050, 64, True), (2, 2, 1050, 300, 64, False),
    (2, 2, 130, 130, 64, True), (1, 3, 257, 257, 64, True),
    (2, 2, 300, 260, 128, False), (2, 2, 300, 260, 48, False),
    (2, 2, 200, 200, 80, True), (1, 2, 90, 70, 8, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(dev, b, h, tq, tk, dh, causal,
                                             dtype):
    gen = torch.Generator().manual_seed(tq * tk + dh)
    q, do = (_randn(gen, dev, b, h, tq, dh, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, dev, b, h, tk, dh, dtype=dtype) for _ in range(2))
    kvm = (torch.rand(b, tk, generator=gen) > 0.3).float()
    kvm[:, 0] = 1.0
    if tq > 1024 or tq in (130, 257):
        # past the last full 128-row tile (1050 = 8 x 128 + 26; 130, 257):
        # row 0's first live key (70) lies inside a 64- and a 128-row
        # tile, so the causal tile skip must keep the tiles before it
        kvm[0, :70] = 0.0
    kvm[-1] = 0.0                                   # a fully-masked row
    kvm = kvm.to(dev)
    launches = _flash_launches()
    out, lse = fa.flash_attention_fwd(q, k, v, kvm, causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, kvm, causal)
    grads = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse, causal)
    # bf16 (aligned, every head size here: Dh 8, 48 and 80 zero-padded to
    # 16, 64 and 128) takes the tensor-core forward, dq and dkv, f32 the
    # CUDA-core ones; every output at the real Dh
    tc = dtype == torch.bfloat16
    assert fa.flash_tc_path(dtype, fa.built_head_size(dh), True) == tc
    assert _flash_launches() == tuple(
        c + n for c, n in zip(launches, (not tc, tc) * 3))
    assert out.shape == q.shape and lse.shape == (b, h, tq)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    # lse: rows with a live key to 1e-5 (lse is of order log Tk); the
    # fully-masked rows' -1e9 exactly
    live = ref_lse > 0.5 * NEG_INF
    assert bool((~live).any())
    torch.testing.assert_close(lse[live], ref_lse[live], rtol=0, atol=1e-5)
    assert torch.equal(lse[~live], ref_lse[~live])
    # the gradients against the plain backward fed the kernel's own out and
    # lse, and fed the plain forward's (a wrong lse shows there)
    for fwd in ((out, lse), (ref, ref_lse)):
        plain = fa.flash_attention_bwd_reference(q, k, v, kvm, do, *fwd,
                                                 causal)
        if dtype == torch.float32:
            for g, r in zip(grads, plain):
                _close_to_scale(g, r, 1e-5)
        else:
            for g, r in zip(grads, plain):
                torch.testing.assert_close(g.float(), r.float(), rtol=2e-2,
                                           atol=2e-2)
            if fwd[0] is out:
                # the tensor-core dq, dk and dv: one bf16 spacing of the
                # plain backward on the same out and lse
                for g, r in zip(grads, plain):
                    _close_bf16(g, r, 1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        _close_bf16(out, ref, 1e-5)


def _flash_launches():
    """The flash wrappers' counters by route: forward, forward on the
    tensor cores, dq, dq on the tensor cores, dkv, dkv on the tensor
    cores."""
    return (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.launches_bf16_tc,
            fa.flash_attention_dq.launches,
            fa.flash_attention_dq.launches_bf16_tc,
            fa.flash_attention_dkv.launches,
            fa.flash_attention_dkv.launches_bf16_tc)


@pytest.mark.parametrize("what,dtype,shift_q,shift_do,route", [
    ("aligned bf16", torch.bfloat16, 0, 0, (0, 1, 0, 1, 0, 1)),
    ("bf16 q 8 bytes in", torch.bfloat16, 4, 0, (1, 0, 1, 0, 1, 0)),
    ("bf16 dO 8 bytes in", torch.bfloat16, 0, 4, (0, 1, 1, 0, 1, 0)),
    ("f32", torch.float32, 0, 0, (1, 0, 1, 0, 1, 0))])
def test_flash_attention_takes_the_route_of_its_alignment(dev, what, dtype,
                                                          shift_q, shift_do,
                                                          route):
    """The route follows dtype and alignment alone: a q (or dO) that is
    a contiguous view 8 bytes into its buffer (16-byte aligned no more)
    keeps the forward, dq and dkv (or dq and dkv) on the CUDA cores; both
    routes
    agree with the plain versions. A bf16 q 2 bytes in, which the
    CUDA-core kernels' 8-byte reads cannot take, raises before any
    launch."""
    gen = torch.Generator().manual_seed(77)

    def shifted(t, shift):
        buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=dev)
        return buf[shift:].view(t.shape).copy_(t)
    q = shifted(_randn(gen, dev, 2, 3, 150, 64, dtype=dtype), shift_q)
    k, v = (_randn(gen, dev, 2, 3, 170, 64, dtype=dtype) for _ in range(2))
    do = shifted(_randn(gen, dev, 2, 3, 150, 64, dtype=dtype), shift_do)
    kvm = torch.ones(2, 170, device=dev)
    kvm[1, 120:] = 0.0
    before = _flash_launches()
    out, lse = fa.flash_attention_fwd(q, k, v, kvm, True)
    grads = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse, True)
    assert tuple(a - b for a, b in zip(_flash_launches(), before)) == route
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(shifted(q, 1) if dtype == torch.bfloat16
                               else shifted(q, 2), k, v, kvm, True)
    assert tuple(a - b for a, b in zip(_flash_launches(), before)) == route
    ref, _ = fa.flash_attention_reference(q, k, v, kvm, True)
    plain = fa.flash_attention_bwd_reference(q, k, v, kvm, do, out, lse,
                                             True)
    rel = 1e-5 if dtype == torch.bfloat16 else 2e-5
    _close_bf16(out, ref, rel)
    for g, r in zip(grads[1:], plain[1:]):
        _close_bf16(g, r, 1e-5)
    if route[3]:        # dq on the tensor cores: one bf16 spacing too
        _close_bf16(grads[0], plain[0], 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic(dev, causal, dtype):
    # one writer per gradient element and a fixed summation order: two
    # calls give the same bits (bf16: dq and dkv on the tensor cores)
    gen = torch.Generator().manual_seed(1050)
    q, k, v, do = (_randn(gen, dev, 2, 4, 1050, 64, dtype=dtype)
                   for _ in range(4))
    kvm = torch.ones(2, 1050)
    kvm[1, 900:] = 0.0
    kvm = kvm.to(dev)
    out, lse = fa.flash_attention_fwd(q, k, v, kvm, causal)
    first = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse, causal)
    second = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_autograd_runs_the_kernels(dev):
    gen = torch.Generator().manual_seed(11)
    q, k, v = (_randn(gen, dev, 2, 2, 80, 32).requires_grad_(True)
               for _ in range(3))
    kvm = torch.ones(2, 80, device=dev)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out = fa.flash_attention(q, k, v, kvm, causal=True)
    do = torch.randn(out.shape, generator=gen).to(dev)
    out.backward(do)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(c + 1 for c in before)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention_reference(qr, kr, vr, kvm, causal=True)[0].backward(do)
    for g, r in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        _close_to_scale(g, r, 1e-5)


def test_bf16_products_with_f32_output_match_the_cpu(dev):
    """``logits_matmul`` (its forward one cuBLAS call with an f32 output,
    its backward rounding the cotangent to bf16) and the dense attention
    in bf16 with a gradient (its f32 scores from widened operands, which
    autograd can differentiate) on the card against the same functions on
    CPU copies: f32 outputs within 1e-5 of their largest magnitude, bf16
    ones (the outputs, and logits_matmul's dx and dw, each one rounding
    of an f32 sum) within one bf16 spacing more; the attention's q, k
    and v gradients, a chain of bf16 roundings, within 2e-2 of their
    largest magnitude, the reference's bf16 tolerance."""
    from marian_tpu_torch.ops import attention as tattn
    from marian_tpu_torch.ops import ops as tops
    gen = torch.Generator().manual_seed(29)
    x = _randn(gen, dev, 3, 40, 64, dtype=torch.bfloat16)
    w = (_randn(gen, dev, 64, 333) * 0.125).to(torch.bfloat16)
    g = _randn(gen, dev, 3, 40, 333)
    q, k, v = (_randn(gen, dev, 2, 4, 30, 16, dtype=torch.bfloat16)
               for _ in range(3))
    do = _randn(gen, dev, 2, 4, 30, 16, dtype=torch.bfloat16)
    mask = torch.ones(2, 1, 30, 30, device=dev)
    mask[1, :, :, 20:] = 0.0
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        leaves = [t.detach().to(d).requires_grad_(True) for t in (x, w, q, k,
                                                                 v)]
        y = tops.logits_matmul(leaves[0], leaves[1])
        y.backward(g.to(d))
        ctx, _ = tattn.dense_attention_with_weights(
            *leaves[2:], mask.to(d), return_weights=False)
        ctx.backward(do.to(d))
        outs[name] = [y, ctx] + [t.grad for t in leaves]
    for i, (got, ref) in enumerate(zip(outs["cuda"], outs["cpu"])):
        assert got.dtype == ref.dtype
        if i < 4:
            _close_bf16(got, ref.to(dev), 1e-5)
        else:
            _close_to_scale(got, ref.to(dev), 2e-2)
