"""The port's bf16 numerics against the JAX package on the CPU: the output
projection (``logits_matmul``, forward and its custom backward), the
fused CE's plain versions with bf16 operands against the reference's
kernels run in interpret mode, and the dense attention's bf16 rounding.

A product of two bf16 values is exact in f32, so where both sides
accumulate in f32 only the summation order separates them: f32 results
agree to 1e-5 of their largest magnitude. A bf16 result may land one
bf16 spacing apart (2^-8 to 2^-7 of its magnitude) where the two f32
sums straddle a rounding boundary: bf16 results are held to 2^-7 of each
value plus 1e-5 of the largest. The fused CE's dx and dw are held to
2e-2 of their largest magnitude, the reference's own bf16 tolerance
(tests/test_decode_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.attention import dense_attention_with_weights as jdense
from marian_tpu.ops.ops import logits_matmul as jlogits_matmul
from marian_tpu.ops.pallas.fused_ce import fused_softmax_xent as jfx
from marian_tpu_torch.ops import attention as tattn
from marian_tpu_torch.ops import ops as tops
from marian_tpu_torch.ops.kernels import fused_ce as fce

torch.set_num_threads(2)

F32_TOL = 1e-5            # of the largest magnitude: f32 sums in another order
BF16_STEP = 2.0 ** -7     # one bf16 spacing at most, relative to the value
CE_TOL = 1e-4             # per-token CE, absolute
FCE_GRAD_TOL = 2e-2       # of the largest magnitude


def _bf16(a):
    """numpy f32 → (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).bfloat16()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def assert_f32_close(got, ref, what):
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref).max()
    assert err <= F32_TOL * np.abs(ref).max(), (what, err)


def assert_bf16_close(got, ref, what):
    got, ref = _np(got), _np(ref)
    allowed = BF16_STEP * np.abs(ref) + F32_TOL * np.abs(ref).max()
    worst = (np.abs(got - ref) - allowed).max()
    assert worst <= 0.0, (what, worst)


@pytest.mark.parametrize("lead", [(37,), (3, 11)])
def test_logits_matmul_matches_jax(lead):
    """Forward: f32 logits from bf16 operands. Backward: the cotangent
    rounded to bf16 once, dx in bf16, dw summed in f32 then bf16."""
    rng = np.random.RandomState(0)
    d, v = 24, 45
    jx, tx = _bf16(rng.randn(*lead, d).astype(np.float32))
    jw, tw = _bf16((rng.randn(d, v) * 0.3).astype(np.float32))
    g = rng.randn(*lead, v).astype(np.float32)
    ref, vjp = jax.vjp(jlogits_matmul, jx, jw)
    rdx, rdw = vjp(jnp.asarray(g))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    got = tops.logits_matmul(tx, tw)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_f32_close(got, ref, "logits")
    got.backward(torch.tensor(g))
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16
    assert_bf16_close(tx.grad, rdx, "dx")
    assert_bf16_close(tw.grad, rdw, "dw")


def test_logits_matmul_rounds_the_cotangent():
    """The backward rounds g to bf16 before both products: dx equals the
    product of the rounded cotangent, not of the f32 one."""
    rng = np.random.RandomState(1)
    _, tx = _bf16(rng.randn(64, 32).astype(np.float32))
    _, tw = _bf16(rng.randn(32, 16).astype(np.float32))
    g = torch.tensor(rng.randn(64, 16).astype(np.float32))
    tw.requires_grad_(True)
    tops.logits_matmul(tx, tw).backward(g)
    g16 = g.bfloat16().float()
    want = (tx.float().t() @ g16).bfloat16()
    assert torch.equal(tw.grad, want)
    unrounded = (tx.float().t() @ g).bfloat16()
    assert not torch.equal(tw.grad, unrounded)


def test_logits_matmul_f32_is_plain_matmul():
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(9, 8).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.randn(8, 5).astype(np.float32), requires_grad=True)
    g = torch.tensor(rng.randn(9, 5).astype(np.float32))
    y = tops.logits_matmul(x, w)
    y.backward(g)
    assert torch.equal(y, x.detach() @ w.detach())
    assert torch.equal(x.grad, g @ w.detach().t())
    assert torch.equal(w.grad, x.detach().t() @ g)


N, V, E = 37, 45, 24


def _fce_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, E).astype(np.float32)
    w = (rng.randn(V, E) * 0.3).astype(np.float32)
    b = rng.randn(V).astype(np.float32)
    labels = rng.randint(0, V, size=N).astype(np.int32)
    weights = rng.rand(N).astype(np.float32)
    return x, w, b, labels, weights


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_ce_plain_bf16_matches_jax_kernel(eps):
    """bf16 x and w, f32 b: the port's plain forward and backward (the
    training path's autograd Function) against the reference's kernels
    in interpret mode; db (f32, the unrounded d summed) to 2e-4."""
    x, w, b, labels, weights = _fce_inputs(3)
    jx, tx = _bf16(x)
    jw, tw = _bf16(w)

    def loss(xx, ww, bb):
        ce = jfx(xx, ww, bb, jnp.asarray(labels), eps, block_v=32,
                 interpret=True)
        return jnp.sum(ce * jnp.asarray(weights)), ce
    (_, rce), rg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jx, jw, jnp.asarray(b))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    tb = torch.tensor(b, requires_grad=True)
    ce = fce.fused_softmax_xent(tx, tw, tb, torch.as_tensor(labels), eps)
    np.testing.assert_allclose(_np(ce), _np(rce), rtol=0, atol=CE_TOL)
    (ce * torch.as_tensor(weights)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16
    for name, got, ref in (("dx", tx.grad, rg[0]), ("dw", tw.grad, rg[1])):
        err = np.abs(_np(got) - _np(ref)).max()
        assert err <= FCE_GRAD_TOL * np.abs(_np(ref)).max(), (name, err)
    np.testing.assert_allclose(_np(tb.grad), _np(rg[2]), rtol=2e-4,
                               atol=2e-4)


def test_fused_ce_plain_backward_rounds_d_to_the_operand_dtype():
    """dx = round(d) . w and dw = round(d)^T . x in bf16; db sums the
    unrounded d. In f32 the rounding is a no-op."""
    x, w, b, labels, _ = _fce_inputs(4)
    rng = np.random.RandomState(5)
    g = [torch.tensor(rng.randn(N).astype(np.float32)) for _ in range(3)]
    _, tx = _bf16(x)
    _, tw = _bf16(w)
    tb, tl = torch.tensor(b), torch.as_tensor(labels)
    lse = fce.fused_ce_stats_reference(tx, tw, tb, tl)[0]
    d = fce.dlogits_reference(tx, tw, tb, tl, lse, *g)
    dx, dw, db = fce.fused_ce_bwd_reference(tx, tw, tb, tl, lse, *g)
    d16 = d.bfloat16().float()
    assert torch.equal(dx, (d16 @ tw.float()).bfloat16())
    assert torch.equal(dw, (d16.t() @ tx.float()).bfloat16())
    assert torch.equal(db, d.sum(0))
    f32 = fce.fused_ce_bwd_reference(tx.float(), tw.float(), tb, tl, lse,
                                     *g)
    assert torch.equal(f32[0], d @ tw.float())


def test_fused_ce_kernel_operands_must_share_a_supported_dtype():
    """The wrapper's operand check (reached before any launch): bf16 x
    with f32 w, f16 operands and a bf16 bias are refused."""
    x = torch.zeros(4, 8)
    w = torch.zeros(6, 8)
    b, labels = torch.zeros(6), torch.zeros(4, dtype=torch.int32)
    for xx, ww, bb in ((x.bfloat16(), w, b), (x.half(), w.half(), b),
                       (x.bfloat16(), w.bfloat16(), b.bfloat16())):
        with pytest.raises(TypeError):
            fce._operands("fused_ce_stats", xx, ww, bb, labels)
    fce._operands("fused_ce_stats", x.bfloat16(), w.bfloat16(), b, labels)


def test_dense_attention_bf16_matches_jax():
    """1/sqrt(Dh) rounded to bf16 before it scales q, the scores in f32,
    the weights and the context rounded to bf16 (Dh 8: the scale is not
    a power of two)."""
    rng = np.random.RandomState(6)
    b, h, tq, tk, dh = 2, 2, 5, 7, 8
    jq, tq_ = _bf16(rng.randn(b, h, tq, dh).astype(np.float32))
    jk, tk_ = _bf16(rng.randn(b, h, tk, dh).astype(np.float32))
    jv, tv = _bf16(rng.randn(b, h, tk, dh).astype(np.float32))
    mask = np.ones((b, 1, tq, tk), np.float32)
    mask[0, :, :, 5:] = 0.0
    ref, rw = jdense(jq, jk, jv, jnp.asarray(mask))
    got, gw = tattn.dense_attention_with_weights(tq_, tk_, tv,
                                                 torch.tensor(mask))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(gw, rw, "weights")
    assert_bf16_close(got, ref, "context")


def test_device_keeps_bf16_products_accumulating_in_f32():
    """Resolving the device switches off cuBLAS's bf16 reduction of
    split-K partial sums, as it switches off TF32: the reference's bf16
    dots accumulate in f32 (``preferred_element_type``)."""
    from marian_tpu_torch.device import resolve_device
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        resolve_device("cpu")
        assert flags.allow_bf16_reduced_precision_reduction is False
        assert flags.allow_tf32 is False
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
