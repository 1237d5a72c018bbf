"""The bf16 packed backward in the tensor-core kernel's order of work
(``packed_attention_bwd_tc_reference``), its routing rule
(``packed_tc_path``) and counter, on the CPU, against the JAX kernel.

The tensor-core kernel (Tq, Tk <= 64, one tile pair a head) forms S and
dO.V^T from bf16 products with f32 sums, P = exp(S - rowmax) / rowsum
and dS = P (dP - delta) scale in f32, and feeds dS (dQ = dS K), P^T
(dV = P^T dO) and dS^T (dK = dS^T Q) to their products as hi/lo bf16
pairs. The JAX side is ``jax.vjp`` of ``packed_attention(...,
interpret=True)`` on bf16 q, k, v, whose custom VJP runs ``_bwd_kernel``
in interpret mode, as tests/test_torch_packed_attention_grad.py runs it;
it computes in f32 and rounds dq, dk and dv to bf16. Tolerance: within
one bf16 spacing of the reference (two f32 sums in different orders may
round to neighbouring bf16 values) plus 1e-5 of its largest magnitude.

The JAX kernel pads T to 64 and averages a fully masked row over the
padded length; the port averages it over the Tk real keys. So fully
masked rows are held against the JAX kernel at T = 64, where the two
agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.packed_attention import packed_attention as jpa
from marian_tpu_torch.ops.kernels import packed_attention as pmod
from tests.test_torch_flash_attention_tc import _close_bf16, _t
from tests.test_torch_package_rules import _CudaTyped

torch.set_num_threads(2)


def _bf16_inputs(seed, b, h, tq, tk, dh, dead_row=None):
    """q, k, v, dO rounded to bf16 (numpy bf16 arrays for JAX) and a
    ragged key mask, the first key live; with ``dead_row`` that batch row
    masks every key."""
    rng = np.random.RandomState(seed)

    def bf(*shape):
        return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32),
                                    dtype=jnp.bfloat16))
    q, do = bf(b, h, tq, dh), bf(b, h, tq, dh)
    k, v = bf(b, h, tk, dh), bf(b, h, tk, dh)
    m = (rng.rand(b, tk) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    if dead_row is not None:
        m[dead_row] = 0.0
    return q, k, v, do, m


# name, B, H, Tq, Tk, Dh, causal, dead_row
CASES = [
    ("ragged", 2, 2, 50, 50, 64, False, None),
    ("ragged causal", 2, 2, 37, 37, 64, True, None),
    ("cross, Tq < Tk", 2, 2, 40, 64, 32, False, None),
    ("Dh 16", 2, 4, 23, 23, 16, False, None),
    ("Dh 32 causal", 2, 2, 64, 64, 32, True, None),
    ("Dh 128", 2, 2, 64, 64, 128, False, None),
    ("Dh 128 causal, ragged", 2, 2, 45, 45, 128, True, None),
    ("fully masked row", 3, 2, 64, 64, 64, False, 1),
    ("causal, fully masked row", 3, 2, 64, 64, 16, True, 2),
]


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal,dead_row", CASES)
def test_tc_bwd_matches_jax_vjp(name, b, h, tq, tk, dh, causal, dead_row):
    q, k, v, do, m = _bf16_inputs(tq * 7 + tk * 3 + dh + len(name), b, h,
                                  tq, tk, dh, dead_row)
    jout, vjp = jax.vjp(lambda a, bb, c: jpa(a, bb, c, kv_mask=jnp.asarray(m),
                                             causal=causal, interpret=True),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    assert all(g.dtype == jnp.bfloat16 for g in jgrads)
    # the backward reads the JAX forward's out (its delta), as the card's
    # reads the packed forward's
    args = (*(_t(a) for a in (q, k, v, m, do)), _t(np.asarray(jout)))
    grads = pmod.packed_attention_bwd_tc_reference(*args, causal)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    plain = pmod.packed_attention_bwd_reference(*args, causal)
    for what, g, jg, p in zip(("dq", "dk", "dv"), grads, jgrads, plain):
        got = g.float().numpy()
        _close_bf16(got, np.asarray(jg).astype(np.float32), f"{name} {what}")
        _close_bf16(got, p.float().numpy(),
                    f"{name} {what} against the plain backward")
    if dead_row is not None:
        # the masked row's queries still get a gradient (uniform weights
        # over the keys, as the dense path has them)
        assert bool(grads[0][dead_row].abs().max() > 0)


@pytest.mark.parametrize("dtype,dh,tq,tk,tc", [
    (torch.bfloat16, 64, 64, 64, True), (torch.bfloat16, 16, 1, 1, True),
    (torch.bfloat16, 128, 33, 64, True), (torch.bfloat16, 32, 64, 17, True),
    (torch.bfloat16, 64, 65, 64, False), (torch.bfloat16, 64, 64, 65, False),
    (torch.bfloat16, 48, 32, 32, False), (torch.float32, 64, 64, 64, False),
    (torch.float32, 128, 20, 20, False)])
def test_packed_tc_path_takes_bf16_up_to_one_tile(dtype, dh, tq, tk, tc):
    """bfloat16 at a head size the backward is built for and at most 64
    queries and keys takes the tensor cores; past 64 tokens, at another
    head size and in float32 it does not."""
    assert pmod.packed_tc_path(dtype, dh, tq, tk) == tc


def _recording(monkeypatch):
    """Stand-in entries: each records (name, its arguments) and returns
    0; the counters start from 0."""
    calls = []
    monkeypatch.setattr(pmod, "_bwd_kernel", lambda bf16: (
        lambda *a: calls.append(("bwd", bf16, a)) or 0))
    monkeypatch.setattr(pmod, "_bwd_tc_kernel", lambda: (
        lambda *a: calls.append(("bwd_tc", True, a)) or 0))
    monkeypatch.setattr(pmod, "_stream", lambda t: 0)
    monkeypatch.setattr(pmod.packed_attention_bwd, "launches", 0)
    monkeypatch.setattr(pmod.packed_attention_bwd, "launches_bf16_tc", 0)
    return calls


@pytest.mark.parametrize("dtype,t,offset,route", [
    (torch.bfloat16, 64, 0, "bwd_tc"), (torch.bfloat16, 40, 0, "bwd_tc"),
    (torch.bfloat16, 40, 3, "bwd_tc"),        # copied to an aligned buffer
    (torch.bfloat16, 65, 0, "bwd"), (torch.float32, 64, 0, "bwd")])
def test_wrapper_launches_the_routed_entry(monkeypatch, dtype, t, offset,
                                           route):
    """On (stand-in) CUDA tensors ``packed_attention_bwd`` calls the
    entry ``packed_tc_path`` names, once, with 16-byte aligned operands
    (a q one element into its storage is copied first), the tensor-core
    one with out in place of delta and without the scratch and the type
    flag, and counts it on its route's counter alone."""
    calls = _recording(monkeypatch)
    b, h, dh = 2, 3, 64

    def cuda(*shape, shift=0):
        n = int(np.prod(shape))
        return torch.zeros(n + shift, dtype=dtype)[shift:].view(
            *shape).as_subclass(_CudaTyped)
    q = cuda(b, h, t, dh, shift=offset)
    k, v, do, out = (cuda(b, h, t, dh) for _ in range(4))
    kvm = torch.ones(b, t).as_subclass(_CudaTyped)
    dq, dk, dv = pmod.packed_attention_bwd(q, k, v, kvm, do, out, True)
    assert dq.shape == (b, h, t, dh) and dq.dtype == dtype
    assert [(c[0], c[1]) for c in calls] == [
        (route, dtype == torch.bfloat16)]
    args = calls[0][2]
    tc = route == "bwd_tc"
    if tc:
        assert args[5] == out.data_ptr()          # out, not delta
    ptrs = args[:9 if tc else 10]
    assert all(p is None or p % 16 == 0 for p in ptrs)
    tail = (b, h, t, t, dh, pytest.approx(dh ** -0.5), 1)
    assert args[9 if tc else 10:][:7] == tail
    assert len(args) == (17 if tc else 19)
    assert (pmod.packed_attention_bwd.launches,
            pmod.packed_attention_bwd.launches_bf16_tc) == (
                int(not tc), int(tc))


def test_wrapper_refuses_a_misshapen_out(monkeypatch):
    """The tensor-core kernel reads out's rows for delta: an out (or dO)
    not of q's shape raises before any launch."""
    calls = _recording(monkeypatch)
    q = torch.zeros(1, 2, 9, 16, dtype=torch.bfloat16).as_subclass(
        _CudaTyped)
    bad = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16).as_subclass(
        _CudaTyped)
    with pytest.raises(ValueError, match="out is"):
        pmod.packed_attention_bwd(q, q, q, None, q, bad)
    with pytest.raises(ValueError, match="do is"):
        pmod.packed_attention_bwd(q, q, q, None, bad, q)
    assert calls == []


def test_route_counter_exists_and_counts_nothing_on_the_cpu():
    """``launches_bf16_tc`` beside ``.launches``; a CPU call (the plain
    versions, the backward through autograd and the wrapper) moves
    neither."""
    fn = pmod.packed_attention_bwd
    before = (fn.launches, fn.launches_bf16_tc)
    q, k, v, do, m = _bf16_inputs(5, 1, 2, 20, 20, 16)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = pmod.packed_attention(*leaves, _t(m), causal=True)
    out.backward(_t(do))
    assert all(t.grad is not None for t in leaves)
    fn(*(_t(a) for a in (q, k, v, m, do)), out.detach(), True)
    assert (fn.launches, fn.launches_bf16_tc) == before
