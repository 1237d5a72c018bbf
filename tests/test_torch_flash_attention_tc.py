"""The bf16 flash forward, dq and dkv in the tensor-core kernels' order
of work (``flash_attention_fwd_tc_reference``,
``flash_attention_dq_tc_reference``,
``flash_attention_dkv_tc_reference``), their routing rule
(``flash_tc_path``) and counters, on the CPU, against the JAX kernel.

The tensor-core kernels form the scores from bf16 products with f32
sums and feed P (forward), dS (dq) and P^T, dS^T (dkv) to their second
products as hi/lo bf16 pairs, each tile's products from 0 and added in
order. The JAX side is ``flash_attention(..., interpret=True)`` on bf16
q, k, v, and ``jax.vjp`` of it for dq, dk and dv, as
tests/test_torch_flash_attention.py runs it; its kernel computes in f32
and rounds the outputs to bf16.
Tolerances: out, dq, dk and dv within one bf16 spacing of the reference
(two f32 sums in different orders may round to neighbouring bf16
values) plus 1e-5 of its largest magnitude; lse within 1e-5 absolute on
rows that see a live key, and rows that see none exactly -1e9.

The JAX kernel pads Tk to its block and averages a row that sees no
live key over the padded length; the port averages it over the Tk real
keys (the dense answer). So those rows' outputs are held against the
JAX dense path in f32, and their output gradient is 0, as a padding
row's is in training (their p is 1 in both, and they add nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.attention import (causal_mask, combine_masks,
                                      dense_attention)
from marian_tpu.ops.pallas.flash_attention import flash_attention as jfa
from marian_tpu_torch.ops.kernels import flash_attention as fmod
from tests.test_torch_package_rules import _CudaTyped

torch.set_num_threads(2)

LSE_TOL = 1e-5


def _bf16_inputs(seed, b, h, tq, tk, dh, dead_row=None, lead=0):
    """q, k, v, dO rounded to bf16 (numpy bf16 arrays for JAX) and a key
    mask: ragged, the first key live; with ``lead`` batch row 0's first
    live key is ``lead``; with ``dead_row`` that batch row masks every
    key."""
    rng = np.random.RandomState(seed)

    def bf(*shape):
        return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32),
                                    dtype=jnp.bfloat16))
    q, do = bf(b, h, tq, dh), bf(b, h, tq, dh)
    k, v = bf(b, h, tk, dh), bf(b, h, tk, dh)
    m = (rng.rand(b, tk) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    if lead:
        m[0, :lead], m[0, lead] = 0.0, 1.0
    if dead_row is not None:
        m[dead_row] = 0.0
    return q, k, v, do, m


def _t(a):
    """A numpy array as a torch tensor of its dtype (bf16 stays bf16)."""
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).bfloat16()
    return torch.tensor(a)


def _close_bf16(got, ref, what):
    """|got - ref| within one bf16 spacing of ref plus 1e-5 of max |ref|."""
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    _, e = np.frexp(ref)               # |ref| in [2^(e-1), 2^e)
    spacing = np.where(ref == 0.0, 0.0, np.ldexp(1.0, e - 8))
    over = (np.abs(got - ref) - spacing).max()
    scale = float(np.abs(ref).max())
    assert over <= 1e-5 * scale, (f"{what}: past one bf16 spacing by {over}"
                                  f" (scale {scale})")


def _dense_f32(q, k, v, m, causal):
    """The JAX dense path in f32 on the bf16 values."""
    mask = jnp.asarray(m)[:, None, None, :]
    if causal:
        mask = combine_masks(causal_mask(q.shape[2]), mask)
    return np.asarray(dense_attention(*(jnp.asarray(a, dtype=jnp.float32)
                                        for a in (q, k, v)), mask))


def _jax_lse(q, k, m, causal):
    """log-sum-exp of the JAX masked scores in f32 (scale after the
    product, causal positions replaced by -1e9)."""
    tq, tk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q, dtype=jnp.float32),
                   jnp.asarray(k, dtype=jnp.float32)) * (1.0 / dh ** 0.5)
    s = s + (1.0 - jnp.asarray(m))[:, None, None, :] * -1e9
    if causal:
        s = jnp.where(jnp.arange(tq)[:, None] >= jnp.arange(tk)[None, :], s,
                      -1e9)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


# name, B, H, Tq, Tk, Dh, causal, dead_row, lead
CASES = [
    ("ragged Tq and Tk", 2, 2, 150, 201, 64, False, None, 0),
    ("Tk < Tq", 2, 2, 200, 70, 32, False, None, 0),
    ("causal, first live key inside a tile", 2, 2, 200, 200, 64, True,
     None, 70),
    ("fully masked row", 3, 2, 130, 140, 64, False, 1, 0),
    ("causal, fully masked row", 3, 2, 100, 100, 32, True, 2, 0),
    ("Dh 128", 2, 2, 140, 90, 128, False, None, 0),
    ("Dh 128, causal past a tile", 2, 2, 129, 129, 128, True, None, 0),
    ("Dh 32, causal, Tq < Tk", 2, 2, 77, 130, 32, True, None, 0),
    ("Dh 16", 2, 2, 66, 66, 16, False, None, 0),
]


def _seed(name, tq, tk, dh):
    return tq * 7 + tk * 3 + dh + len(name)


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal,dead_row,lead", CASES)
def test_tc_forward_matches_jax_kernel(name, b, h, tq, tk, dh, causal,
                                       dead_row, lead):
    q, k, v, _, m = _bf16_inputs(_seed(name, tq, tk, dh), b, h, tq, tk, dh,
                                 dead_row, lead)
    out, lse = fmod.flash_attention_fwd_tc_reference(
        *(_t(a) for a in (q, k, v, m)), causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, ref_lse = fmod.flash_attention_reference(
        *(_t(a) for a in (q, k, v, m)), causal)
    jout = np.asarray(jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          kv_mask=jnp.asarray(m), causal=causal,
                          interpret=True))
    assert jout.dtype == jnp.bfloat16
    live = (ref_lse > -5e8).numpy()
    assert live.any()
    got = out.float().numpy()
    _close_bf16(got[live], jout.astype(np.float32)[live], f"{name} out")
    _close_bf16(got, ref.float().numpy(), f"{name} out against the plain "
                                          f"version")
    if not live.all():
        dense = np.asarray(jnp.asarray(_dense_f32(q, k, v, m, causal),
                                       dtype=jnp.bfloat16))
        _close_bf16(got[~live], dense.astype(np.float32)[~live],
                    f"{name} rows that see no live key")
    jlse = _jax_lse(q, k, m, causal)
    np.testing.assert_allclose(lse.numpy()[live], jlse[live], rtol=0,
                               atol=LSE_TOL)
    assert np.array_equal(lse.numpy()[~live], jlse[~live])
    assert bool((lse[~torch.as_tensor(live)] == -1e9).all())


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal,dead_row,lead", CASES)
def test_tc_dkv_matches_jax_vjp(name, b, h, tq, tk, dh, causal, dead_row,
                                lead):
    q, k, v, do, m = _bf16_inputs(_seed(name, tq, tk, dh) + 1, b, h, tq, tk,
                                  dh, dead_row, lead)
    _, lse = fmod.flash_attention_fwd_tc_reference(
        *(_t(a) for a in (q, k, v, m)), causal)
    live = (lse > -5e8).numpy()
    do[~live] = 0.0
    jout, vjp = jax.vjp(lambda a, bb, c: jfa(a, bb, c, kv_mask=jnp.asarray(m),
                                             causal=causal, interpret=True),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, jdk, jdv = vjp(jnp.asarray(do))
    # the backward reads the JAX forward's out (its delta) and this lse
    dk, dv = fmod.flash_attention_dkv_tc_reference(
        *(_t(a) for a in (q, k, v, m, do)), _t(np.asarray(jout)), lse,
        causal)
    assert dk.dtype == dv.dtype == torch.bfloat16
    for what, got, ref in (("dk", dk, jdk), ("dv", dv, jdv)):
        _close_bf16(got.float().numpy(), np.asarray(ref).astype(np.float32),
                    f"{name} {what}")


@pytest.mark.parametrize("name,b,h,tq,tk,dh,causal,dead_row,lead", CASES)
def test_tc_dq_matches_jax_vjp(name, b, h, tq, tk, dh, causal, dead_row,
                               lead):
    """dq in the tensor-core order of work (128 query rows against
    64-key tiles, dS as a hi/lo pair) against the JAX kernel's VJP, and
    against the plain backward on the same out and lse."""
    q, k, v, do, m = _bf16_inputs(_seed(name, tq, tk, dh) + 2, b, h, tq, tk,
                                  dh, dead_row, lead)
    _, lse = fmod.flash_attention_fwd_tc_reference(
        *(_t(a) for a in (q, k, v, m)), causal)
    live = (lse > -5e8).numpy()
    do[~live] = 0.0
    jout, vjp = jax.vjp(lambda a, bb, c: jfa(a, bb, c, kv_mask=jnp.asarray(m),
                                             causal=causal, interpret=True),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq = vjp(jnp.asarray(do))[0]
    args = (*(_t(a) for a in (q, k, v, m, do)), _t(np.asarray(jout)), lse)
    dq = fmod.flash_attention_dq_tc_reference(*args, causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == (b, h, tq, dh)
    _close_bf16(dq.float().numpy(), np.asarray(jdq).astype(np.float32),
                f"{name} dq")
    rdq = fmod.flash_attention_bwd_reference(*args, causal)[0]
    _close_bf16(dq.float().numpy(), rdq.float().numpy(),
                f"{name} dq against the plain backward")


def test_hi_lo_pair_recovers_p_to_2_pow_minus_16():
    """hi = bf16(x), lo = bf16(x - hi): |x - hi - lo| <= 2^-16 |x| for
    probabilities (exp of scores down to -80) and dS values of either
    sign over many decades (x - hi stays a normal f32 there)."""
    rng = np.random.RandomState(3)
    x = np.concatenate([np.exp(-80.0 * rng.rand(4000)),
                        rng.randn(4000) * 10.0 ** rng.uniform(-20, 20, 4000),
                        [1.0, 0.5, 1.0 - 2.0 ** -20, 3.0 ** -30]])
    x = torch.tensor(x.astype(np.float32))
    hi, lo = fmod.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    # a single rounding is 2^-9 at worst: the pair is what keeps f32
    assert float(((x.double() - hi.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -10


@pytest.mark.parametrize("dtype,dh,offset,tc", [
    (torch.bfloat16, 64, 0, True), (torch.bfloat16, 128, 0, True),
    (torch.bfloat16, 32, 0, True), (torch.bfloat16, 16, 0, True),
    (torch.bfloat16, 64, 8, True),        # 16 bytes in: aligned
    (torch.bfloat16, 64, 4, False),       # 8 bytes in
    (torch.bfloat16, 64, 1, False),       # a view one element in
    (torch.float32, 64, 0, False), (torch.float32, 128, 0, False)])
def test_flash_tc_path_follows_dtype_head_size_and_alignment(dtype, dh,
                                                             offset, tc):
    """bf16 at a head size the tensor-core kernels are built for, every
    operand 16-byte aligned, takes them; a contiguous view one element
    into its storage and float32 do not."""
    q = torch.zeros(2 * 3 * 5 * dh + offset, dtype=dtype)[offset:].view(
        2, 3, 5, dh)
    k = torch.zeros(2, 3, 7, dh, dtype=dtype)
    assert q.is_contiguous()
    aligned = fmod._aligned(q, k, k)
    assert aligned == (offset * q.element_size() % 16 == 0)
    assert fmod.flash_tc_path(dtype, dh, aligned) == tc
    assert not fmod.flash_tc_path(torch.bfloat16, 48, True)


def _recording(monkeypatch):
    """Stand-in entries: each records (name, its arguments) and returns 0."""
    calls = []

    def kernels(bf16):
        names = ["fwd", "dq", "dkv"] + (["fwd_tc", "dq_tc", "dkv_tc"]
                                        if bf16 else [])
        return {n: (lambda n_: lambda *a: calls.append((n_, bf16, a)) or 0)(n)
                for n in names}
    monkeypatch.setattr(fmod, "_kernels", kernels)
    monkeypatch.setattr(fmod, "_stream", lambda t: 0)
    for fn in (fmod.flash_attention_fwd, fmod.flash_attention_dq,
               fmod.flash_attention_dkv):
        monkeypatch.setattr(fn, "launches", 0)
    for fn in (fmod.flash_attention_fwd, fmod.flash_attention_dq,
               fmod.flash_attention_dkv):
        monkeypatch.setattr(fn, "launches_bf16_tc", 0)
    return calls


@pytest.mark.parametrize("dtype,offset,tc", [
    (torch.bfloat16, 0, True), (torch.bfloat16, 4, False),
    (torch.float32, 0, False)])
def test_wrappers_launch_the_routed_entries(monkeypatch, dtype, offset, tc):
    """On (stand-in) CUDA tensors the forward and the backward call the
    entries ``flash_tc_path`` names, once each, with that entry's
    arguments (the tensor-core ones without the type flag), and count
    each launch on its route's counter alone; dq takes its tensor-core
    entry as the forward and dkv do. A bf16 q 8 bytes into its buffer
    (aligned for the CUDA-core kernels' 8-byte vectors, not 16) takes the
    CUDA cores."""
    calls = _recording(monkeypatch)
    b, h, tq, tk, dh = 2, 3, 5, 7, 64

    def cuda(*shape, shift=0):
        n = int(np.prod(shape))
        return torch.zeros(n + shift, dtype=dtype)[shift:].view(
            *shape).as_subclass(_CudaTyped)
    q = cuda(b, h, tq, dh, shift=offset)
    k, v = cuda(b, h, tk, dh), cuda(b, h, tk, dh)
    kvm = torch.ones(b, tk).as_subclass(_CudaTyped)
    out, lse = fmod.flash_attention_fwd(q, k, v, kvm, True)
    fmod.flash_attention_bwd(q, k, v, kvm, cuda(b, h, tq, dh), out, lse,
                             True)
    bf = dtype == torch.bfloat16
    names = [(c[0], c[1]) for c in calls]
    assert names == [("fwd_tc" if tc else "fwd", bf),
                     ("dq_tc" if tc else "dq", bf),
                     ("dkv_tc" if tc else "dkv", bf)]
    scale = dh ** -0.5
    for name, _, args in calls:
        tail = (b, h, tq, tk, dh, pytest.approx(scale), 1)
        want = tail + ((0,) if name.endswith("_tc") else (int(bf), 0))
        assert args[-len(want):] == want
    assert (fmod.flash_attention_fwd.launches,
            fmod.flash_attention_fwd.launches_bf16_tc,
            fmod.flash_attention_dq.launches,
            fmod.flash_attention_dq.launches_bf16_tc,
            fmod.flash_attention_dkv.launches,
            fmod.flash_attention_dkv.launches_bf16_tc) == (
                int(not tc), int(tc), int(not tc), int(tc), int(not tc),
                int(tc))


def test_an_unaligned_do_keeps_dkv_on_the_cuda_cores(monkeypatch):
    """dq's and dkv's routes read their own operands: an output gradient
    8 bytes into its storage sends both to the CUDA-core entries while
    the forward (q, k, v aligned) takes the tensor cores."""
    calls = _recording(monkeypatch)
    shape = (1, 2, 9, 32)
    q, k, v = (torch.zeros(*shape, dtype=torch.bfloat16).as_subclass(
        _CudaTyped) for _ in range(3))
    do = torch.zeros(int(np.prod(shape)) + 4, dtype=torch.bfloat16)[4:].view(
        *shape).as_subclass(_CudaTyped)
    kvm = torch.ones(1, 9).as_subclass(_CudaTyped)
    out, lse = fmod.flash_attention_fwd(q, k, v, kvm)
    fmod.flash_attention_bwd(q, k, v, kvm, do, out, lse)
    assert [c[0] for c in calls] == ["fwd_tc", "dq", "dkv"]


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1),
                                          (torch.bfloat16, 2),
                                          (torch.float32, 1)])
def test_misaligned_rows_raise_before_any_launch(monkeypatch, dtype, offset):
    """A q whose rows the CUDA-core kernels cannot read (bf16 not 8-byte,
    float32 not 16-byte aligned: they read whole vectors) raises a
    ValueError instead of launching, and counts nothing."""
    calls = _recording(monkeypatch)
    n = 2 * 2 * 9 * 32
    q = torch.zeros(n + offset, dtype=dtype)[offset:].view(
        2, 2, 9, 32).as_subclass(_CudaTyped)
    k = torch.zeros(2, 2, 9, 32, dtype=dtype).as_subclass(_CudaTyped)
    with pytest.raises(ValueError, match="aligned"):
        fmod.flash_attention_fwd(q, k, k)
    assert calls == [] and fmod.flash_attention_fwd.launches == 0
    assert fmod.flash_attention_fwd.launches_bf16_tc == 0


def test_route_counters_exist_and_count_nothing_on_the_cpu():
    """``launches_bf16_tc`` on the forward, dq and dkv beside
    ``.launches``; a CPU call (the plain versions, forward and backward
    through autograd) moves none of them."""
    counters = [(fmod.flash_attention_fwd, "launches"),
                (fmod.flash_attention_fwd, "launches_bf16_tc"),
                (fmod.flash_attention_dq, "launches"),
                (fmod.flash_attention_dq, "launches_bf16_tc"),
                (fmod.flash_attention_dkv, "launches"),
                (fmod.flash_attention_dkv, "launches_bf16_tc")]
    before = [getattr(fn, a) for fn, a in counters]
    q, k, v, do, m = _bf16_inputs(5, 1, 2, 20, 20, 16)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    fmod.flash_attention(*leaves, _t(m), causal=True).backward(_t(do))
    assert all(t.grad is not None for t in leaves)
    assert [getattr(fn, a) for fn, a in counters] == before


def test_ptxas_usage_names_the_flash_tensor_core_kernels():
    """The build's ``-Xptxas -v`` lines name each instance by its
    identifier and integer template arguments, so the build line shows
    ``flash_tc_fwd_kernel<64>``'s and ``flash_tc_dkv_kernel<128>``'s
    registers and spills."""
    from marian_tpu_torch.ops.kernels import _build
    tag = "_ZN48_GLOBAL__N__8a1c5e7f_18_flash_attention_cu_8a1c5e7f"
    fwd = f"{tag}19flash_tc_fwd_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKfPS1_Pfiiifi"
    dkv = f"{tag}19flash_tc_dkv_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKfS3_S5_S5_PS1_S6_iiifi"
    log = "".join(
        f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {m}\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\n"
        f"ptxas info    : Used {r} registers, used 1 barriers\n"
        for m, r in ((fwd, 128), (dkv, 242)))
    assert _build.ptxas_usage(log) == [
        f"flash_tc_{part}: Used {r} registers, used 1 barriers; 0 bytes "
        f"stack frame, 0 bytes spill stores, 0 bytes spill loads"
        for part, r in (("fwd_kernel<64>", 128), ("dkv_kernel<128>", 242))]
    assert _build.kernel_name(
        "_ZN12_GLOBAL__N_116flash_dkv_kernelI13__nv_bfloat16Li64ELi2EEEvPKT_"
    ) == "flash_dkv_kernel<64, 2>"
    assert _build.kernel_name("_ZN12_GLOBAL__N_116fce_tc_dx_kernelIfEEvPK13"
                              ) == "fce_tc_dx_kernel"


@pytest.mark.parametrize("tag, kernel", [
    ("_ZN51_GLOBAL__N__577aa515_18_flash_attention_cu_424c222f",
     "flash_tc_fwd_kernel"),
    ("_ZN51_GLOBAL__N__57a47b99_18_flash_attention_cu_16167a2f",
     "flash_tc_dq_kernel"),
    ("_ZN51_GLOBAL__N__61d8d152_18_flash_attention_cu_ed5dc373",
     "flash_tc_dkv_kernel"),
    ("_ZN52_GLOBAL__N__cd7dd454_19_packed_attention_cu_7a4883c9",
     "packed_tc_bwd_kernel"),
])
def test_kernel_name_ignores_runs_the_namespace_hash_counts(tag, kernel):
    """Digits of the anonymous namespace's hashes can count a longer run
    that also ends at the kernel's ``_kernel`` (``...2a4f18flash_tc_dq_
    kernel`` read from the ``57`` of the first hash); each instance is
    still named by its own identifier, so the build's count of
    tensor-core instances does not depend on the hashes a build drew."""
    from marian_tpu_torch.ops.kernels import _build
    mangled = (f"{tag}{len(kernel)}{kernel}ILi64EEEvPK13__nv_bfloat16S3_S3_"
               f"PKfPS1_Pfiiifi")
    assert _build.kernel_name(mangled) == f"{kernel}<64>"
