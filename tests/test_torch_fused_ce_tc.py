"""The fused CE's bf16 backward in the tensor-core kernels' order of work
(``fused_ce_bwd_tc_reference``, ``tc_chunk_ops``), its routing rule
(``tc_path``) and its chunks, on the CPU, against the JAX kernels.

The tensor-core backward stores d once, rounded to bf16, and both
products read that stored d; db sums the unrounded f32 d per 128-token
tile and then across the tiles in order. The JAX side is the
reference's ``_bwd_call`` (``_dx_kernel``, ``_dw_kernel``) in interpret
mode with bf16 x and w, on inputs padded as its ``fused_softmax_xent``
pads them. Tolerances: dx and dw (bf16) to 2^-7 of their norm (one bf16
rounding of d and of the result, summed in another order); db (f32) to
1e-5 of its largest magnitude (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.fused_ce import MASK_VALUE, _bwd_call
from marian_tpu_torch.ops.kernels import fused_ce as fce

torch.set_num_threads(2)

GRAD_NORM_TOL = 2.0 ** -7     # bf16 dx, dw: of the reference's norm
DB_TOL = 1e-5                 # f32 db: of its largest magnitude


def _inputs(seed, n, v, e):
    """bf16 x and w (as torch tensors and f32 numpy copies of the same
    values), f32 b, labels with the first on the edges 0 and V - 1, and
    the three cotangents."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(n, e).astype(np.float32)).bfloat16()
    w = torch.tensor((rng.randn(v, e) * e ** -0.5).astype(np.float32)
                     ).bfloat16()
    b = torch.tensor(rng.randn(v).astype(np.float32))
    labels = rng.randint(0, v, size=n).astype(np.int32)
    labels[:2] = (0, v - 1)
    grads = [torch.tensor(rng.randn(n).astype(np.float32)) for _ in range(3)]
    lse = fce.fused_ce_stats_reference(x, w, b, torch.as_tensor(labels))[0]
    return x, w, b, torch.as_tensor(labels), lse, grads


def _jax_bwd_call(x, w, b, labels, lse, grads, block_n=128, block_v=32):
    """The reference's ``_bwd_call`` on bf16 x and w, tokens padded to
    blocks of ``block_n`` (zero cotangents), the vocabulary to blocks of
    ``block_v`` with bias MASK_VALUE; (dx, dw, db) as f32 numpy."""
    n, v = x.shape[0], w.shape[0]
    n_pad = -(-n // block_n) * block_n
    v_pad = -(-v // block_v) * block_v

    def pad(a, rows, value=0.0):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        out = np.full((rows,) + a.shape[1:], value, a.dtype)
        out[:a.shape[0]] = a
        return jnp.asarray(out)
    cols = [pad(a, n_pad)[:, None] for a in (lse, *grads)]
    dx, dw, db = _bwd_call(pad(x, n_pad).astype(jnp.bfloat16),
                           pad(w, v_pad).astype(jnp.bfloat16),
                           pad(b, v_pad, MASK_VALUE)[None, :],
                           pad(labels.numpy(), n_pad)[:, None], *cols,
                           block_n, block_v, v, True)
    assert dx.dtype == jnp.bfloat16 and dw.dtype == jnp.bfloat16
    f32 = [np.asarray(a.astype(jnp.float32)) for a in (dx, dw, db)]
    return f32[0][:n], f32[1][:v], f32[2][:v, 0]


def _norm_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.linalg.norm(got - ref)
    assert err <= GRAD_NORM_TOL * np.linalg.norm(ref), (what, err)


def _scale_close(got, ref, what, rel=DB_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("n,v,e", [(37, 45, 24), (133, 300, 48),
                                   (260, 97, 16)])
def test_tc_reference_matches_jax_bwd_call(n, v, e):
    """Ragged N (one, two and three 128-token tiles, the last ragged) and
    ragged V (not a multiple of the reference's 32-column block)."""
    x, w, b, labels, lse, grads = _inputs(n + v + e, n, v, e)
    dx, dw, db = fce.fused_ce_bwd_tc_reference(x, w, b, labels, lse, *grads)
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16,
                                              torch.float32)
    rdx, rdw, rdb = _jax_bwd_call(x, w, b, labels, lse, grads)
    _norm_close(dx.float().numpy(), rdx, "dx")
    _norm_close(dw.float().numpy(), rdw, "dw")
    _scale_close(db.numpy(), rdb, "db")


@pytest.mark.parametrize("chunk", [16, 128, 1000, None])
def test_tc_chunk_loop_matches_jax_bwd_call(chunk):
    """``run_chunks`` with ``tc_chunk_ops`` (the stored-rounded d scratch
    and db in the d step) at narrow, tile-wide and whole-vocabulary
    chunks, against the reference's ``_bwd_call``."""
    n, v, e = 150, 260, 32
    x, w, b, labels, lse, grads = _inputs(9, n, v, e)
    dx = torch.empty(n, e)
    dw = torch.empty(v, e, dtype=torch.bfloat16)
    db = torch.empty(v)
    fce.run_chunks(fce.vocab_chunks(n, v, chunk, elem=2),
                   *fce.tc_chunk_ops(x, w, b, labels, lse, *grads, dx, dw,
                                     db))
    rdx, rdw, rdb = _jax_bwd_call(x, w, b, labels, lse, grads)
    _norm_close(dx.bfloat16().float().numpy(), rdx, "dx")
    _norm_close(dw.float().numpy(), rdw, "dw")
    _scale_close(db.numpy(), rdb, "db")


@pytest.mark.parametrize("chunk", [1, 64, 128, None])
def test_stored_d_equals_rounding_as_read(chunk):
    """d stored once rounded to bf16 gives dx and dw bit-identical to the
    CUDA-core kernels' arithmetic (``plain_chunk_ops``: d kept in f32,
    rounded as each product reads it); db, summed per 128-token tile and
    then in order, agrees with the plain column sums to 1e-5."""
    n, v, e = 300, 200, 24
    x, w, b, labels, lse, grads = _inputs(11, n, v, e)
    outs = []
    for ops in (fce.tc_chunk_ops, fce.plain_chunk_ops):
        dx = torch.empty(n, e)
        dw = torch.empty(v, e, dtype=torch.bfloat16)
        db = torch.empty(v)
        fce.run_chunks(fce.vocab_chunks(n, v, chunk),
                       *ops(x, w, b, labels, lse, *grads, dx, dw, db))
        outs.append((dx, dw, db))
    (tdx, tdw, tdb), (pdx, pdw, pdb) = outs
    assert torch.equal(tdx, pdx) and torch.equal(tdw, pdw)
    _scale_close(tdb.numpy(), pdb.numpy(), "db")


def test_tc_reference_matches_the_plain_reference():
    """``fused_ce_bwd_tc_reference`` against ``fused_ce_bwd_reference``:
    dx and dw bit-identical (the same rounded d, the same f32 products),
    db to 1e-5 (tile sums against one column sum)."""
    x, w, b, labels, lse, grads = _inputs(12, 290, 77, 40)
    tc = fce.fused_ce_bwd_tc_reference(x, w, b, labels, lse, *grads)
    plain = fce.fused_ce_bwd_reference(x, w, b, labels, lse, *grads)
    assert torch.equal(tc[0], plain[0]) and torch.equal(tc[1], plain[1])
    _scale_close(tc[2].numpy(), plain[2].numpy(), "db")


def test_tile_sums_add_the_tiles_in_order_compensated():
    """Per-tile column sums (tiles of 128 tokens, the last one ragged)
    added in order with Kahan compensation: a tile sum that a plain f32
    running sum drops (1 beside 2^24) is kept, and random columns agree
    with float64 to f32 rounding."""
    d = torch.zeros(300, 2)
    d[0, 0], d[128, 0], d[256, 0] = 2.0 ** 24, 1.0, -(2.0 ** 24)
    d[0, 1], d[128, 1], d[256, 1] = 1.0, 2.0 ** 24, -(2.0 ** 24)
    assert fce.tile_sums(d).tolist() == [1.0, 1.0]
    plain = (d[:128].sum(0) + d[128:256].sum(0)) + d[256:].sum(0)
    assert plain.tolist() == [0.0, 0.0]
    r = torch.tensor(np.random.RandomState(3).randn(1000, 7).astype(
        np.float32))
    np.testing.assert_allclose(fce.tile_sums(r).double().numpy(),
                               r.double().sum(0).numpy(), rtol=0, atol=1e-5)


def test_tc_chunk_ops_without_dw_leave_db_alone():
    """When only dx is asked for (``need_dw=False``), the d step takes no
    db sums."""
    n, v, e = 40, 50, 8
    x, w, b, labels, lse, grads = _inputs(13, n, v, e)
    dx = torch.empty(n, e)
    make_d, add_dx, _ = fce.tc_chunk_ops(x, w, b, labels, lse, *grads, dx,
                                         None, None)
    fce.run_chunks(fce.vocab_chunks(n, v, 16, elem=2), make_d, add_dx)
    ref = fce.fused_ce_bwd_tc_reference(x, w, b, labels, lse, *grads)[0]
    assert torch.equal(dx.bfloat16(), ref)


@pytest.mark.parametrize("e,dtype,aligned,takes", [
    (48, torch.bfloat16, True, True), (512, torch.bfloat16, True, True),
    (1024, torch.bfloat16, True, True), (50, torch.bfloat16, True, False),
    (1500, torch.bfloat16, True, False), (512, torch.float32, True, False),
    (1024, torch.float32, True, False), (512, torch.bfloat16, False, False)])
def test_tc_path_routing(e, dtype, aligned, takes):
    """bf16 with E % 8 == 0 and 16-byte-aligned operands takes the
    tensor-core kernels; E 50 and 1,500 (rows not of whole 16-byte
    vectors), float32 and unaligned operands do not."""
    assert fce.tc_path(e, dtype, aligned) is takes


def test_tc_path_refuses_an_unaligned_view():
    """A bf16 x that starts 2 bytes into its storage is contiguous but
    not 16-byte aligned: the wrapper's alignment check fails, so the call
    takes the CUDA-core kernels."""
    base = torch.zeros(8 * 512 + 1, dtype=torch.bfloat16)
    x = base[1:].view(8, 512)
    assert x.is_contiguous()
    w = torch.zeros(16, 512, dtype=torch.bfloat16)
    assert fce._aligned(w) and not fce._aligned(x, w)
    assert not fce.tc_path(512, torch.bfloat16, fce._aligned(x, w))
    assert fce.tc_path(512, torch.bfloat16, fce._aligned(x.clone(), w))


@pytest.mark.parametrize("n,v", [(12288, 32000), (16384, 32000), (37, 45),
                                 (1, 500000), (100003, 32003),
                                 (4_000_000, 1000)])
def test_vocab_chunks_with_a_bf16_scratch(n, v):
    """With the tensor-core path's bf16 d scratch the chunks cover [0, V)
    once, in order, every width but the last one multiple of 128 whose
    n x width x 2 bytes fit SCRATCH_BYTES (128 where even that does not
    fit), and no chunk is narrower than with the f32 scratch."""
    chunks = fce.vocab_chunks(n, v, elem=2)
    assert chunks[0][0] == 0 and sum(w for _, w in chunks) == v
    assert all(a + wa == b for (a, wa), (b, _) in zip(chunks, chunks[1:]))
    width = chunks[0][1]
    assert all(w == width for _, w in chunks[:-1]) and chunks[-1][1] <= width
    if len(chunks) > 1:
        assert width % fce.CHUNK_ALIGN == 0
    assert n * width * 2 <= fce.SCRATCH_BYTES or width <= fce.CHUNK_ALIGN
    assert width >= fce.vocab_chunks(n, v)[0][1]


def test_vocab_chunks_bf16_at_transformer_base_training():
    """12,288 target words, vocabulary 32,000: three chunks of 10,880,
    10,880 and 10,240 (n x 10,880 x 2 B = 255 MiB) instead of six."""
    assert [w for _, w in fce.vocab_chunks(12288, 32000, elem=2)] == [
        10880, 10880, 10240]
    assert len(fce.vocab_chunks(12288, 32000)) == 6


@pytest.mark.parametrize("n,e,width,want", [
    (12288, 512, 10880, (2, 3)), (12288, 512, 10240, (2, 4)),
    (16384, 1024, 8192, (1, 1)), (300, 96, 500, (1, 1))])
def test_chunk_splits_on_the_tensor_core_tiles(n, e, width, want):
    """The tensor-core products' output tiles are 128 x 128, two blocks
    an SM: the reduction splits (``k_splits``) count those tiles against
    264 block slots. At the base shape dx's 384 tiles fill 1.45 waves
    unsplit and 0.97 of 3 in two slices."""
    assert fce.chunk_splits(n, e, width, tc=True) == want
    assert fce.k_splits(384, 10880, fce.TC_SLOTS) == 2
    assert fce.k_splits(384, 10880) == 1

