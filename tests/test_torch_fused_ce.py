"""The port's fused CE (plain versions, the autograd Function that
routes the backward through ``fused_ce_bwd``, and the backward's chunk
loop over the vocabulary run with plain per-chunk operations) vs the JAX
kernels.

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
    """``autograd``: the training path (``fused_softmax_xent``, whose
    gradient runs through the autograd Function); ``function``: that
    Function alone, whose backward calls the dx / dw wrappers (their
    plain versions here)."""
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


@pytest.mark.parametrize("n,v", [(12288, 32000), (8192, 32000),
                                 (37, 45), (1, 500000), (100003, 32003),
                                 (4_000_000, 1000)])
def test_vocab_chunks_cover_the_vocabulary_within_the_scratch(n, v):
    """The backward's chunks cover [0, V) once, in order; every width but
    the last is one multiple of 128, whose [N, width] f32 d scratch fits
    the budget (a width of 128 where even that does not fit)."""
    chunks = fce.vocab_chunks(n, v)
    assert chunks[0][0] == 0
    assert all(a + wa == b for (a, wa), (b, _) in zip(chunks, chunks[1:]))
    assert sum(w for _, w in chunks) == v
    width = chunks[0][1]
    assert all(w == width for _, w in chunks[:-1]) and chunks[-1][1] <= width
    if len(chunks) > 1:
        assert width % fce.CHUNK_ALIGN == 0
    assert (n * width * 4 <= fce.SCRATCH_BYTES
            or width <= fce.CHUNK_ALIGN)


def test_vocab_chunks_at_transformer_base_training():
    """12,288 target words a batch, vocabulary 32,000: chunks of 5,376
    (n x 5,376 x 4 B = 252 MiB), the sixth one ragged."""
    chunks = fce.vocab_chunks(12288, 32000)
    assert [w for _, w in chunks] == [5376] * 5 + [5120]


@pytest.mark.parametrize("chunk,widths", [(1, [1] * 45), (16, [16, 16, 13]),
                                          (45, [45]), (100, [45])])
def test_vocab_chunks_forced_width(chunk, widths):
    assert [w for _, w in fce.vocab_chunks(N, V, chunk)] == widths


def _jax_bwd_call(x, w, b, labels, lse, grads):
    """The reference's ``_bwd_call`` (dx and dw kernels, interpret mode)
    on inputs padded as its ``fused_softmax_xent`` pads them: tokens to a
    128-row block, the vocabulary to 32-row blocks with bias MASK_VALUE;
    padded tokens get zero cotangents."""
    from marian_tpu.ops.pallas.fused_ce import MASK_VALUE, _bwd_call
    n_pad, v_pad = 128, 64

    def pad(a, rows, value=0.0):
        out = np.full((rows,) + a.shape[1:], value, a.dtype)
        out[:a.shape[0]] = a
        return jnp.asarray(out)
    cols = [pad(a, n_pad)[:, None] for a in (lse, *grads)]
    dx, dw, db = _bwd_call(pad(x, n_pad), pad(w, v_pad),
                           pad(b, v_pad, MASK_VALUE)[None, :],
                           pad(labels, n_pad)[:, None], *cols, n_pad, 32, V,
                           True)
    return np.asarray(dx)[:N], np.asarray(dw)[:V], np.asarray(db)[:V, 0]


@pytest.mark.parametrize("chunk", [1, 16, 45, 100, None])
def test_chunk_loop_matches_jax_bwd_call(chunk):
    """``run_chunks`` over ``vocab_chunks`` with the plain per-chunk
    operations (the loop the card runs, the kernels' arithmetic per chunk)
    at widths 1, a ragged last chunk, V, wider than V and the default,
    against the reference's ``_bwd_call`` (GRAD_TOL) and against
    ``fused_ce_bwd_reference`` (1e-5: the same f32 sums, cut at chunk
    edges)."""
    x, w, b, labels, _ = _inputs(6)
    rng = np.random.RandomState(7)
    grads = [rng.randn(N).astype(np.float32) for _ in range(3)]
    tx, tw, tb = _t(x, w, b)
    tl = torch.as_tensor(labels)
    lse = fce.fused_ce_stats_reference(tx, tw, tb, tl)[0]
    tg = _t(*grads)
    dx, dw, db = torch.empty(N, E), torch.empty(V, E), torch.empty(V)
    fce.run_chunks(fce.vocab_chunks(N, V, chunk),
                   *fce.plain_chunk_ops(tx, tw, tb, tl, lse, *tg, dx, dw, db))
    ref = _jax_bwd_call(x, w, b, labels, lse.numpy(), grads)
    plain = fce.fused_ce_bwd_reference(tx, tw, tb, tl, lse, *tg)
    for got, r, p in zip((dx, dw, db), ref, plain):
        np.testing.assert_allclose(got.numpy(), r, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("need_dx,need_dw", [(True, False), (False, True)])
def test_chunk_loop_computes_only_what_is_asked(need_dx, need_dw):
    """Without dx (or dw) the loop skips that operation; on the CPU
    ``fused_ce_bwd`` returns None for the part not asked for."""
    x, w, b, labels, _ = _inputs(8)
    tx, tw, tb = _t(x, w, b)
    tl = torch.as_tensor(labels)
    lse = fce.fused_ce_stats_reference(tx, tw, tb, tl)[0]
    g = _t(*(np.full(N, 0.5, np.float32) for _ in range(3)))
    plain = fce.fused_ce_bwd_reference(tx, tw, tb, tl, lse, *g)
    dx, dw, db = torch.empty(N, E), torch.empty(V, E), torch.empty(V)
    make_d, add_dx, put_dw = fce.plain_chunk_ops(tx, tw, tb, tl, lse, *g,
                                                 dx, dw, db)
    fce.run_chunks(fce.vocab_chunks(N, V, 16), make_d,
                   add_dx if need_dx else None, put_dw if need_dw else None)
    got = fce.fused_ce_bwd(tx, tw, tb, tl, lse, *g, need_dx=need_dx,
                           need_dw=need_dw)
    for part, loop, ref, asked in ((got[0], dx, plain[0], need_dx),
                                   (got[1], dw, plain[1], need_dw),
                                   (got[2], db, plain[2], need_dw)):
        assert (part is not None) == asked
        if asked:
            np.testing.assert_allclose(loop.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5)
            assert torch.equal(part, ref)


def _close_to_scale(got, ref, rel=1e-5):
    """|got - ref| <= rel * max(1, max |ref|): f32 sums over V taken in
    another order."""
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("v", [200, 256, 257, 3001])
def test_tiled_stats_match_plain_and_jax_kernel(v):
    """``fused_ce_stats_tiled_reference`` (the forward kernel's partials
    per 256-column vocabulary tile, merged in vocabulary order) against
    ``fused_ce_stats_reference`` and against the reference kernel through
    its public entry in interpret mode (``_jax``: it pads V and N and
    reaches ``_fwd_call``), at ragged V, N = 133 (not a multiple of the
    128-token tile) and labels on the tile edges 0, 255, 256 and V - 1;
    1e-5 of each output's largest magnitude (f32 sums over V in another
    order). The reference returns the CE: eps 0 gives lse - lab, eps 0.1
    brings in tot."""
    n, e = 133, 24
    rng = np.random.RandomState(v)
    x = rng.randn(n, e).astype(np.float32)
    w = (rng.randn(v, e) * 0.3).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    labels = rng.randint(0, v, size=n).astype(np.int32)
    edges = [c for c in (0, 255, 256, v - 1) if c < v]
    labels[:len(edges)] = edges
    tx, tw, tb = _t(x, w, b)
    tl = torch.as_tensor(labels)
    lse, lab, tot = fce.fused_ce_stats_tiled_reference(tx, tw, tb, tl)
    for got, plain in zip((lse, lab, tot),
                          fce.fused_ce_stats_reference(tx, tw, tb, tl)):
        _close_to_scale(got.numpy(), plain.numpy())
    for eps in (0.0, 0.1):
        ce = (1.0 - eps) * (lse - lab) + eps * (lse - tot / float(v))
        _close_to_scale(ce.numpy(), _jax(x, w, b, labels, eps))


def _tile_case(n, v, nbytes, cols=256):
    """One case; the 256-column ones keep their ids from before the
    128-column (tensor-core) cases were added."""
    case = f"{n}-{v}-{nbytes}" + ("" if cols == 256 else f"-cols{cols}")
    return pytest.param(n, v, nbytes, cols, id=case)


@pytest.mark.parametrize("n,v,nbytes,cols", [
    _tile_case(12288, 32000, 24_576_000), _tile_case(16384, 32000, 32_768_000),
    _tile_case(133, 257, 4 * 2 * 133 * 4), _tile_case(1, 200, 16),
    _tile_case(12288, 32000, 49_152_000, 128),
    _tile_case(16384, 32000, 65_536_000, 128),
    _tile_case(133, 257, 4 * 3 * 133 * 4, 128), _tile_case(1, 200, 32, 128)])
def test_fwd_tiles_cover_the_vocabulary_and_size_the_partials(n, v, nbytes,
                                                              cols):
    """The forward's vocabulary tiles cover [0, V) once, in order, ``cols``
    columns each (256 on the CUDA cores, 128 on the tensor cores) but a
    ragged last one; its partial buffer is [4, tiles, N] f32: at 256
    columns 24.6 MB at base training (N 12,288) and 32.8 MB at the doc
    shape (N 16,384); at 128, 250 tiles, 49.2 and 65.5 MB."""
    tiles = fce.fwd_tiles(v, cols)
    assert [c for v0, width in tiles for c in range(v0, v0 + width)] == \
        list(range(v))
    assert all(width == cols for _, width in tiles[:-1])
    shape = fce.fwd_part_shape(n, v, cols)
    assert shape == (4, len(tiles), n)
    assert 4 * int(np.prod(shape)) == nbytes
    if (n, v, cols) == (12288, 32000, 128):
        assert len(tiles) == 250
