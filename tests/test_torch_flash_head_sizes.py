"""Flash attention at head sizes its kernels are not built for, on the
CPU through stand-in CUDA tensors.

The kernels are built for Dh 16, 32, 64 and 128. A call at another head
size up to 128 runs at the next built one: the wrappers zero-pad q, k,
v (and dO) along Dh, launch with the real head size's scale and cut out,
dq, dk and dv back to the real Dh. The stand-in entries record what
they were given; a stand-in launch that computes the kernels' formulas
on the padded operands (the forward's online softmax result, the
backward's p = exp(s - lse), ds = p (dO.V^T - delta) scale from the
wrapper's delta) shows that the padded call's results are the plain
version's at the real Dh, and that the padded columns of every output
come out zero. Tolerance 1e-5 of each output's largest magnitude: f32
sums over Dh + zero columns, in another order than the plain version's.

Past 128 the wrappers refuse by name, the dispatcher routes ``auto``
calls to the dense path, and the model refuses
``--transformer-flash-attention on`` when it is built.
"""

import numpy as np
import pytest
import torch

from marian_tpu_torch.models import transformer as tmod
from marian_tpu_torch.ops import attention as tatt
from marian_tpu_torch.ops.kernels import flash_attention as fmod
from marian_tpu_torch.ops.ops import NEG_INF
from tests.test_torch_flash_attention_tc import _recording
from tests.test_torch_package_rules import _CudaTyped

torch.set_num_threads(2)

REL = 1e-5


def _inputs(seed, b, h, tq, tk, dh, dtype=torch.float32):
    """q, k, v, dO as stand-in CUDA tensors from a numpy seed, and a
    ragged key mask (the last batch row fully masked)."""
    rng = np.random.RandomState(seed)

    def cuda(*shape):
        t = torch.tensor(rng.randn(*shape).astype(np.float32)).to(dtype)
        return t.as_subclass(_CudaTyped)
    q, do = cuda(b, h, tq, dh), cuda(b, h, tq, dh)
    k, v = cuda(b, h, tk, dh), cuda(b, h, tk, dh)
    m = (rng.rand(b, tk) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    m[-1] = 0.0
    return q, k, v, do, torch.tensor(m).as_subclass(_CudaTyped)


@pytest.mark.parametrize("dh,built", [(8, 16), (48, 64), (80, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_padded_entries_get_the_real_scale_and_dh(monkeypatch, dh, built,
                                                  dtype):
    """At Dh 8, 48 and 80 the forward, dq and dkv entries are called at
    the next built head size with 1/sqrt(Dh) of the real one, on
    operands zero-padded to it; out, lse, dq, dk and dv come back at the
    real shapes. bf16 takes the tensor-core entries (fresh padded
    buffers are aligned), f32 the CUDA-core ones."""
    calls = _recording(monkeypatch)
    seen = []
    launch = fmod._launch

    def recording_launch(which, tc, operands, outs, tk, causal, scale):
        seen.append((which, [t.shape[-1] for t in operands[:3]],
                     [t.shape[-1] for t in outs if t.dim() == 4]))
        return launch(which, tc, operands, outs, tk, causal, scale)
    monkeypatch.setattr(fmod, "_launch", recording_launch)
    b, h, tq, tk = 2, 3, 5, 7
    q, k, v, do, kvm = _inputs(dh, b, h, tq, tk, dh, dtype)
    out, lse = fmod.flash_attention_fwd(q, k, v, kvm, True)
    assert out.shape == (b, h, tq, dh) and lse.shape == (b, h, tq)
    assert out.dtype == dtype and out.is_contiguous()
    grads = fmod.flash_attention_bwd(q, k, v, kvm, do, out, lse, True)
    assert [g.shape for g in grads] == [(b, h, tq, dh), (b, h, tk, dh),
                                        (b, h, tk, dh)]
    assert all(g.dtype == dtype and g.is_contiguous() for g in grads)
    tc = dtype == torch.bfloat16
    assert [c[0] for c in calls] == [
        f"{w}_tc" if tc else w for w in ("fwd", "dq", "dkv")]
    for _, _, args in calls:
        tail = (b, h, tq, tk, built, pytest.approx(dh ** -0.5), 1)
        assert args[-len(tail) - 1 - (not tc):-1 - (not tc)] == tail
    assert seen == [("fwd", [built] * 3, [built]),
                    ("dq", [built] * 3, [built]),
                    ("dkv", [built] * 3, [built, built])]


def _plain_launch(padded):
    """A stand-in for ``_launch`` that computes each kernel's result with
    the kernels' formulas on the (padded) operands it is handed and
    keeps the outputs it wrote in ``padded``."""
    def launch(which, tc, operands, outs, tk, causal, scale):
        q, k, v, kvm = (t.as_subclass(torch.Tensor) for t in operands[:4])
        if which == "fwd":
            o, l = fmod.flash_attention_reference(q, k, v, kvm, causal,
                                                  scale)
            outs[0].copy_(o)
            outs[1].copy_(l)
        else:
            do, lse, delta = (t.as_subclass(torch.Tensor)
                              for t in operands[4:])
            s = fmod._scores(q, k, kvm, causal, scale)
            p = torch.exp(s - lse[..., None])
            dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
            ds = p * (dp - delta[..., None]) * scale
            if which == "dq":
                outs[0].copy_(torch.einsum("bhqk,bhkd->bhqd", ds, k.float()))
            else:
                outs[0].copy_(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()))
                outs[1].copy_(torch.einsum("bhqk,bhqd->bhkd", p, do.float()))
        padded[which] = [t.clone() for t in outs]
    return launch


def _close(got, ref, what):
    got, ref = got.float(), ref.float()
    scale = max(float(ref.abs().max()), 1.0)
    err = float((got - ref).abs().max())
    assert err <= REL * scale, f"{what}: {err} > {REL} x {scale}"


@pytest.mark.parametrize("dh,causal", [(8, False), (48, True), (80, False),
                                       (96, True)])
def test_padded_call_is_the_plain_version_at_the_real_head_size(
        monkeypatch, dh, causal):
    """Zero columns add nothing to q.k, to dO.V^T or to delta: the
    padded call's out, lse, dq, dk and dv are the plain version's at the
    real Dh and scale (a fully masked row too), and the padded columns
    of every output are zero."""
    _recording(monkeypatch)
    padded = {}
    monkeypatch.setattr(fmod, "_launch", _plain_launch(padded))
    q, k, v, do, kvm = _inputs(dh + 1, 3, 2, 70, 70 if causal else 90, dh)
    do[-1] = 0.0                    # a padding row gets no gradient
    out, lse = fmod.flash_attention_fwd(q, k, v, kvm, causal)
    grads = fmod.flash_attention_bwd(q, k, v, kvm, do, out, lse, causal)
    plain = [t.as_subclass(torch.Tensor) for t in (q, k, v, kvm, do)]
    ref, ref_lse = fmod.flash_attention_reference(*plain[:4], causal)
    _close(out, ref, "out")
    live = ref_lse > 0.5 * NEG_INF
    assert bool((~live).any())
    torch.testing.assert_close(lse[live].as_subclass(torch.Tensor),
                               ref_lse[live], rtol=0, atol=1e-5)
    assert torch.equal(lse[~live].as_subclass(torch.Tensor), ref_lse[~live])
    rgrads = fmod.flash_attention_bwd_reference(*plain, ref, ref_lse, causal)
    for what, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
        _close(g, r, what)
    for which, outs in padded.items():
        for t in outs:
            if t.dim() == 4:
                assert t.shape[-1] == fmod.built_head_size(dh)
                assert not bool(t[..., dh:].any()), which


def test_built_head_sizes():
    assert [fmod.built_head_size(d) for d in (1, 8, 16, 17, 48, 64, 80,
                                              96, 128, 129, 256)] == [
        16, 16, 16, 32, 64, 64, 128, 128, 128, None, None]
    assert fmod.MAX_HEAD_SIZE == 128


@pytest.mark.parametrize("dh", [136, 256])
def test_wrappers_refuse_head_sizes_past_128_by_name(monkeypatch, dh):
    calls = _recording(monkeypatch)
    q, k, v, do, kvm = _inputs(3, 1, 2, 9, 9, dh)
    with pytest.raises(ValueError, match=f"head size {dh}"):
        fmod.flash_attention_fwd(q, k, v, kvm)
    with pytest.raises(ValueError, match=f"head size {dh}"):
        fmod.flash_attention_bwd(q, k, v, kvm, do, q,
                                 torch.zeros(1, 2, 9).as_subclass(_CudaTyped))
    assert calls == []


@pytest.mark.parametrize("dh,flash,taken", [
    (256, "auto", False), (192, "auto", False), (128, "auto", True),
    (80, "auto", True), (256, "on", True), (256, "off", False)])
def test_dispatcher_routes_head_sizes_past_128_dense_under_auto(
        monkeypatch, dh, flash, taken):
    """On a (stand-in) CUDA tensor at a doc length, 'auto' takes flash up
    to Dh 128 and the dense path past it (the packed kernel's caps are
    far below 1,024 there); 'on' still calls flash (the model refuses it
    when built), 'off' never does."""
    calls = []
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda q, *a, **k: calls.append("flash") or q)
    monkeypatch.setattr(tatt, "packed_attention",
                        lambda q, *a, **k: calls.append("packed") or q)
    t = 1024
    q = torch.randn(1, 1, 4, dh).as_subclass(_CudaTyped)
    k = torch.randn(1, 1, t, dh).as_subclass(_CudaTyped)
    mask = torch.ones(1, 1, 1, t)
    out, w = tatt.attention(q, k, k, mask=mask, kv_mask=torch.ones(1, t),
                            flash=flash)
    assert w is None and out.shape == q.shape
    assert calls == (["flash"] if taken else [])


@pytest.mark.parametrize("dim,heads,flash,refused", [
    (2048, 8, "on", True), (1088, 8, "on", True), (1024, 8, "on", False),
    (768, 16, "on", False), (2048, 8, "auto", False),
    (2048, 8, "off", False)])
def test_model_refuses_flash_on_past_head_size_128(dim, heads, flash,
                                                   refused):
    """--transformer-flash-attention on at a head size past 128 is
    refused by name when the model is built, not mid-run; 'auto' and
    'off' build, as does 'on' at Dh 48 (padded) and 128."""
    opts = {"dim-emb": dim, "transformer-heads": heads,
            "transformer-flash-attention": flash}
    if refused:
        with pytest.raises(NotImplementedError,
                           match=f"head size {dim // heads}"):
            tmod.config_from_options(opts, 100, 100)
    else:
        cfg = tmod.config_from_options(opts, 100, 100)
        assert cfg.dim_head == dim // heads
