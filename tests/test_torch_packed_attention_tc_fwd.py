"""The bf16 packed forward in the tensor-core kernel's order of work
(``packed_attention_tc_reference``), its routing rule
(``packed_tc_fwd_path``), the entry the wrapper calls and its counter,
on the CPU, against the JAX kernel.

The tensor-core kernel walks query tiles of 32 or 64 rows over 64-key
tiles: S = Q.K^T from bf16 products with f32 sums, the online softmax
from a running max of -1e30, each tile's P.V taken from 0 with P as a
hi/lo bf16 pair, and the division by the sum at the end. The JAX side is
``packed_attention(..., interpret=True)`` on the same bf16 q, k, v: it
computes in f32 and rounds out to bf16. Tolerance: within one bf16
spacing of the reference (two f32 values in different orders may round
to neighbouring bf16 values) plus 1e-5 of its largest magnitude.

The JAX kernel pads T to a multiple of 64 and averages a fully masked
row over the padded length; the port averages it over the Tk real keys.
So fully masked rows are held against the JAX kernel at T = 64, where
the two agree, and past 64 keys against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.packed_attention import packed_attention as jpa
from marian_tpu_torch.ops.kernels import packed_attention as pmod
from tests.test_torch_flash_attention_tc import _close_bf16, _t
from tests.test_torch_package_rules import _CudaTyped
from tests.test_torch_packed_attention_tc import CASES, _bf16_inputs

torch.set_num_threads(2)

# the backward's cases, and: the decode encoder's 32-query tile, past one
# key tile (causal self, and cross with three key tiles and two query
# tiles)
FWD_CASES = CASES + [
    ("decode encoder, T 32", 2, 2, 32, 32, 64, False, None),
    ("T 100 causal, two key tiles", 2, 2, 100, 100, 64, True, None),
    ("cross 80 x 150, three key tiles", 2, 2, 80, 150, 64, False, None),
    ("Dh 16 causal, T 130", 2, 2, 130, 130, 16, True, None),
]


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal,dead_row", FWD_CASES)
def test_tc_fwd_matches_jax_kernel(name, b, h, tq, tk, dh, causal,
                                   dead_row):
    q, k, v, _, m = _bf16_inputs(tq * 5 + tk * 11 + dh + len(name), b, h,
                                 tq, tk, dh, dead_row)
    jout = jpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               kv_mask=jnp.asarray(m), causal=causal, interpret=True)
    assert jout.dtype == jnp.bfloat16
    args = [_t(a) for a in (q, k, v, m)]
    out = pmod.packed_attention_tc_reference(*args, causal)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, tq, dh)
    got = out.float().numpy()
    _close_bf16(got, np.asarray(jout).astype(np.float32), name)
    _close_bf16(got, pmod.packed_attention_reference(
        *args, causal).float().numpy(), f"{name} against the plain forward")
    if dead_row is not None:
        # a fully masked row comes out uniform over the keys: the mean of v
        want = _t(v)[dead_row].float().mean(dim=1, keepdim=True)
        if not causal:
            _close_bf16(got[dead_row], want.expand(h, tq, dh).numpy(),
                        f"{name} masked row")


@pytest.mark.parametrize("tq,tk,dh,lead", [(100, 100, 64, 70),
                                           (200, 200, 32, 130),
                                           (40, 90, 64, 64)])
def test_tc_fwd_causal_skip_needs_a_live_key(tq, tk, dh, lead):
    """A causal key tile wholly after every query of a tile is skipped
    only when the batch row has a live key at or before the tile's first
    query. Row 0 masks its first ``lead`` keys, so its early rows are
    fully masked and weigh every key, later tiles too: held against the
    plain forward (JAX averages such rows over its padding)."""
    q, k, v, _, m = _bf16_inputs(tq + lead, 2, 2, tq, tk, dh)
    m[0, :lead] = 0.0
    args = [_t(a) for a in (q, k, v, m)]
    got = pmod.packed_attention_tc_reference(*args, True)
    want = pmod.packed_attention_reference(*args, True)
    _close_bf16(got.float().numpy(), want.float().numpy(),
                f"causal {tq} x {tk}, {lead} keys masked")


@pytest.mark.parametrize("dtype,dh,tc", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 32, True),
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 48, False), (torch.bfloat16, 8, False),
    (torch.float32, 64, False), (torch.float32, 128, False)])
def test_packed_tc_fwd_path_takes_bf16_at_built_head_sizes(dtype, dh, tc):
    """bfloat16 at a head size the kernels are built for takes the
    tensor cores at every length; another head size and float32 do
    not."""
    assert pmod.packed_tc_fwd_path(dtype, dh) == tc


def _recording(monkeypatch):
    """Stand-in entries, forward and backward: each records (name, its
    library's type, its arguments) and returns 0; the counters start
    from 0."""
    calls = []
    monkeypatch.setattr(pmod, "_kernel", lambda bf16: (
        lambda *a: calls.append(("fwd", bf16, a)) or 0))
    monkeypatch.setattr(pmod, "_fwd_tc_kernel", lambda: (
        lambda *a: calls.append(("fwd_tc", True, a)) or 0))
    monkeypatch.setattr(pmod, "_bwd_kernel", lambda bf16: (
        lambda *a: calls.append(("bwd", bf16, a)) or 0))
    monkeypatch.setattr(pmod, "_bwd_tc_kernel", lambda: (
        lambda *a: calls.append(("bwd_tc", True, a)) or 0))
    monkeypatch.setattr(pmod, "_stream", lambda t: 0)
    for fn in (pmod.packed_attention, pmod.packed_attention_bwd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_bf16_tc", 0)
    return calls


def _cuda(dtype, *shape, shift=0):
    """A stand-in CUDA tensor, ``shift`` elements into its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + shift, dtype=dtype)[shift:].view(
        *shape).as_subclass(_CudaTyped)


@pytest.mark.parametrize("dtype,dh,tq,tk,offset,route,tile", [
    (torch.bfloat16, 64, 64, 64, 0, "fwd_tc", 64),
    (torch.bfloat16, 64, 20, 20, 0, "fwd_tc", 32),   # the decode encoder
    (torch.bfloat16, 64, 100, 150, 0, "fwd_tc", 64),
    (torch.bfloat16, 32, 40, 40, 3, "fwd_tc", 64),   # copied to alignment
    (torch.bfloat16, 128, 33, 33, 0, "fwd_tc", 64),
    (torch.bfloat16, 48, 40, 40, 0, "fwd", 0),       # the generic kernel
    (torch.float32, 64, 64, 64, 0, "fwd", 64),
    (torch.float32, 64, 30, 30, 1, "fwd", 0)])       # f32 unaligned
def test_wrapper_launches_the_routed_entry(monkeypatch, dtype, dh, tq, tk,
                                           offset, route, tile):
    """On (stand-in) CUDA tensors ``packed_attention`` calls the entry
    ``packed_tc_fwd_path`` names, once: the tensor-core one with 16-byte
    aligned q, k, v and out (a q at an odd offset is copied first),
    without the type flag, and with ``fwd_query_tile``'s rows; the
    CUDA-core one as before (an unaligned f32 q takes the generic
    kernel). Each counts on its route's counter alone."""
    calls = _recording(monkeypatch)
    b, h = 2, 3
    q = _cuda(dtype, b, h, tq, dh, shift=offset)
    k, v = _cuda(dtype, b, h, tk, dh), _cuda(dtype, b, h, tk, dh)
    kvm = torch.ones(b, tk).as_subclass(_CudaTyped)
    out = pmod.packed_attention(q, k, v, kvm, causal=True)
    assert out.shape == (b, h, tq, dh) and out.dtype == dtype
    tc = route == "fwd_tc"
    assert [(c[0], c[1]) for c in calls] == [(route, dtype == torch.bfloat16)]
    args = calls[0][2]
    assert args[4] == out.data_ptr()
    if tc:
        assert all(p % 16 == 0 for p in args[:5])
        assert args[5:] == (b, h, tq, tk, dh, pytest.approx(dh ** -0.5), 1,
                            tile, 0)
    else:
        assert args[5:] == (b, h, tq, tk, dh, pytest.approx(dh ** -0.5), 1,
                            int(dtype == torch.bfloat16), tile, 0)
    assert (pmod.packed_attention.launches,
            pmod.packed_attention.launches_bf16_tc) == (int(not tc), int(tc))
    assert (pmod.packed_attention_bwd.launches,
            pmod.packed_attention_bwd.launches_bf16_tc) == (0, 0)


def test_autograd_saves_the_tensor_core_out_for_the_backward(monkeypatch):
    """With a gradient the bf16 call goes through the autograd Function:
    its forward launches the tensor-core entry and saves that out, which
    the tensor-core backward reads for delta."""
    calls = _recording(monkeypatch)
    b, h, t, dh = 2, 2, 40, 64
    q, k, v = (_cuda(torch.bfloat16, b, h, t, dh).requires_grad_(True)
               for _ in range(3))
    out = pmod.packed_attention(q, k, v, None, causal=True)
    out.backward(_cuda(torch.bfloat16, b, h, t, dh))
    assert [c[0] for c in calls] == ["fwd_tc", "bwd_tc"]
    assert calls[1][2][5] == calls[0][2][4]       # the forward's out
    assert all(x.grad is not None for x in (q, k, v))
    assert (pmod.packed_attention.launches_bf16_tc,
            pmod.packed_attention_bwd.launches_bf16_tc) == (1, 1)


def test_forward_counters_move_nowhere_on_the_cpu():
    """``launches_bf16_tc`` beside ``.launches``; a CPU call (the plain
    versions and the wrapper, in bf16 and f32, with and without a
    gradient) moves neither."""
    fn = pmod.packed_attention
    before = (fn.launches, fn.launches_bf16_tc)
    q, k, v, do, m = _bf16_inputs(3, 1, 2, 20, 20, 64)
    args = [_t(a) for a in (q, k, v, m)]
    fn(*args, causal=True)
    fn(*(a.float() for a in args), causal=False)
    pmod.packed_attention_tc_reference(*args, True)
    leaves = [a.clone().requires_grad_(True) for a in args[:3]]
    fn(*leaves, args[3], causal=True).backward(_t(do))
    assert (fn.launches, fn.launches_bf16_tc) == before
