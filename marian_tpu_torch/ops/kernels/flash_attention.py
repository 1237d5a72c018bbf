"""Long-sequence (flash) attention, forward and backward, the port of
``marian_tpu/ops/pallas/flash_attention.py :: flash_attention``:

    out = softmax(scale * Q.K^T + (1 - kv_mask) * -1e9) V

with the scale applied AFTER the product, causal positions (query index
< key index, absolute) REPLACED by -1e9, and f32 compute whatever the
input dtype (outputs take the input dtype). The forward also returns
``lse`` [B,H,Tq] (f32), the log of each row's softmax denominator, with
a row sum of 0 guarded to 1 as the reference guards it. The backward
recomputes ``p = exp(s - lse)`` and takes ``delta = rowsum(dO * out)``
from outside the kernels, in plain torch as the reference computes it:
``dq`` sums ``ds K`` over key tiles, ``dkv`` sums ``p^T dO`` and
``ds^T Q`` over query tiles, ``ds = p * (dO V^T - delta) * scale``;
kv_mask gets no gradient. Layout [B,H,T,Dh] as in the reference.

On a CUDA tensor ``flash_attention_fwd`` and ``flash_attention_bwd``
launch the hand-written kernels of ``csrc/flash_attention.cu`` or raise
(the backward computes ``delta`` once and launches ``dq`` and ``dkv``);
on a CPU tensor they run the plain versions ``flash_attention_reference``
and ``flash_attention_bwd_reference``. ``flash_attention`` is the
differentiable call: an autograd Function (the reference's custom VJP)
whose forward saves ``out`` and ``lse`` and whose backward is
``flash_attention_bwd``, on either device. ``flash_attention_fwd``,
``flash_attention_dq`` and ``flash_attention_dkv`` count their kernel's
launches in ``.launches``.

In bfloat16 the forward, dq and dkv run on the tensor cores where
``flash_tc_path`` allows it (q, k, v, and dO, dq, dk, dv, 16-byte
aligned; the entries ``flash_attention_fwd_tc``, ``flash_attention_dq_tc``
and ``flash_attention_dkv_tc``), counted on ``.launches_bf16_tc``
instead: the scores are bf16 products with f32 sums, and P (and dS)
enter the products with V (K; dO, Q) as a hi/lo bf16 pair, hi = bf16(x),
lo = bf16(x - hi), which keeps the reference's f32 value to 2^-16; each
streamed tile's products start from 0 and are added into the f32
accumulators in order (``flash_attention_fwd_tc_reference``,
``flash_attention_dq_tc_reference`` and
``flash_attention_dkv_tc_reference`` are that order of work in plain
torch). Every other call and float32 keep the CUDA-core kernels.

The kernels are built for head sizes 16, 32, 64 and 128. A call at
another head size up to 128 (8, 48, 80, 96, ...) runs at the next built
one (``built_head_size``): q, k, v and dO are zero-padded along Dh, the
scale stays the real head size's, and out, dq, dk and dv are cut back to
the real Dh (zero columns add nothing to q.k, to dO.V^T or to delta,
and the padded columns of every output come out zero); lse is the same.
Past 128 the wrappers raise; the dispatcher (``ops/attention.py``)
routes such calls to the dense path under ``auto``, and the model
refuses ``--transformer-flash-attention on`` at such a head size when
it is built.

What is not carried over from the TPU kernel: its padding of Tq and Tk
to 128-multiples and the ``MARIAN_FLASH_BLOCK_Q/K`` overrides, both TPU
geometry. The kernels mask the ragged edges themselves, and their tile
sizes are constants. One result shows: a fully masked query row (the
batch generator's padding rows) averages V over the Tk real keys, the
dense path's answer, where the TPU kernel averages over its padded
length (the choice ``packed_attention`` makes too). So that this holds
for causal calls as well, a kernel skips a (query tile, key tile) pair
only where all its keys lie after all its queries and every query row
sees a live key (the first live key of its batch row lies at or before
the tile's first query): skipped keys then carry exp(-1e9 - max) = 0
exactly, whatever tile sizes the forward and the two backward kernels
use. In a fully masked row the backward follows the reference's
formula too: lse = -1e9 + log(Tk) rounds to -1e9 in f32, so p = 1 per key
there; a padding row gets no output gradient in training, so it adds
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..ops import NEG_INF
from . import _build
from .fused_ce import _aligned     # the tensor-core kernels' 16-byte rule

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64, 128)      # Dh the kernels are compiled for
TC_HEAD_SIZES = HEAD_SIZES          # ... the tensor-core kernels too
MAX_HEAD_SIZE = HEAD_SIZES[-1]      # the largest Dh a call may have
# csrc/flash_attention.cu FlashTc: 128 own rows a block; the forward's
# 64-key tiles (the CUDA-core forward's too); dkv's query tiles (16 at
# Dh 128)
TC_ROWS, TC_KEYS = 128, 64
# bytes of the vectors the CUDA-core kernels read q, k, v and dO in
# (attention_tiles.cuh stage_rows): a row must start so aligned
_VECTOR_BYTES = {torch.float32: 16, torch.bfloat16: 8}


def tc_query_tile(dh: int) -> int:
    return 16 if dh == 128 else 64


def built_head_size(dh: int) -> Optional[int]:
    """The head size a call at ``dh`` runs at: the smallest built one
    at or above it (its operands zero-padded along Dh), None past
    MAX_HEAD_SIZE."""
    return next((d for d in HEAD_SIZES if d >= dh), None)


def _pad_head(dh: int, *ts):
    """``ts`` zero-padded along Dh to ``dh`` (as they are when they
    already have it)."""
    pad = dh - ts[0].shape[-1]
    return tuple(torch.nn.functional.pad(t, (0, pad)) if pad else t
                 for t in ts)


def _mask(kv_mask, b: int, tk: int, device) -> torch.Tensor:
    if kv_mask is None:
        return torch.ones((b, tk), dtype=torch.float32, device=device)
    return kv_mask.to(device=device, dtype=torch.float32).reshape(b, tk)


def _scale(scale, dh: int) -> float:
    return 1.0 / (dh ** 0.5) if scale is None else float(scale)


def _scores(q, k, kvm, causal: bool, scale: float) -> torch.Tensor:
    """s = (q.k) * scale + (1 - kv_mask) * -1e9, causal positions
    replaced by -1e9: the kernels' op order, f32."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + (1.0 - kvm)[:, None, None, :] * NEG_INF
    if causal:
        live = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_reference(q, k, v, kv_mask=None, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: (out [B,H,Tq,Dh] in q's dtype, lse
    [B,H,Tq] f32), the softmax over every real key."""
    b, _, _, dh = q.shape
    kvm = _mask(kv_mask, b, k.shape[2], q.device)
    s = _scores(q, k, kvm, causal, _scale(scale, dh))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernels' hi/lo pair of an f32 tensor: hi =
    bf16(x), lo = bf16(x - hi), so that |x - hi - lo| <= 2^-16 |x| where
    x - hi is a normal f32."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_product(x: torch.Tensor, m: torch.Tensor, spec: str):
    """One tile's product on the tensor cores from 0, in f32: x as its
    hi/lo bf16 pair against the bf16 values of m."""
    hi, lo = split_bf16(x)
    return (torch.einsum(spec, hi.float(), m)
            + torch.einsum(spec, lo.float(), m))


def _fwd_tiles(q, k, v, kv_mask, causal, scale, query_tile: int,
               split: bool):
    """The forward kernels' tiling in plain PyTorch, one batch row at a
    time (see flash_attention_fwd_tiled_reference); with ``split`` each
    64-key tile's P V is the tensor-core kernel's (``_split_product``)."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    sc = _scale(scale, dh)
    kvm = _mask(kv_mask, b, tk, q.device)
    key_tile = TC_KEYS
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(qf)
    lse = torch.empty((b, h, tq), device=q.device)
    live = kvm != 0
    for bb in range(b):
        first = int(live[bb].float().argmax()) if live[bb].any() else tk
        for i0 in range(0, tq, query_tile):
            i1 = min(tq, i0 + query_tile)
            m = torch.full((h, i1 - i0), -1e30, device=q.device)
            l = torch.zeros((h, i1 - i0), device=q.device)
            acc = torch.zeros((h, i1 - i0, dh), device=q.device)
            n_k = -(-tk // key_tile)
            if causal and i0 >= first:
                n_k = min(n_k, (i0 + query_tile - 1) // key_tile + 1)
            for j0 in range(0, n_k * key_tile, key_tile):
                j1 = min(tk, j0 + key_tile)
                s = (torch.einsum("hqd,hkd->hqk", qf[bb, :, i0:i1],
                                  kf[bb, :, j0:j1]) * sc
                     + (1.0 - kvm[bb, j0:j1]) * NEG_INF)
                if causal:
                    seen = (torch.arange(i0, i1, device=q.device)[:, None]
                            >= torch.arange(j0, j1, device=q.device)[None])
                    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = alpha * l + p.sum(dim=-1)
                if split:
                    pv = _split_product(p, vf[bb, :, j0:j1], "hqk,hkd->hqd")
                else:
                    pv = torch.einsum("hqk,hkd->hqd", p, vf[bb, :, j0:j1])
                acc = acc * alpha[..., None] + pv
                m = m_new
            l = torch.where(l == 0.0, torch.ones_like(l), l)
            out[bb, :, i0:i1] = acc / l[..., None]
            lse[bb, :, i0:i1] = m + torch.log(l)
    return out.to(q.dtype), lse


def flash_attention_fwd_tiled_reference(q, k, v, kv_mask=None,
                                        causal: bool = False,
                                        scale: Optional[float] = None
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's tiling in plain PyTorch (128 query rows, 64
    at Dh 128, against 64-key tiles), one batch row at a time: each query
    tile walks the key tiles in order with an online softmax from a
    running max of -1e30 (the accumulator and sum rescaled by
    exp(m_old - m_new)); a causal query tile stops after the last key
    tile any of its rows can see once its first query sees a live key
    (the header rule), and ends with out = acc / l, lse = m + log(l), l
    == 0 guarded to 1. Returns (out in q's dtype, lse f32)."""
    return _fwd_tiles(q, k, v, kv_mask, causal, scale,
                      128 if q.shape[-1] <= 64 else 64, False)


def flash_attention_fwd_tc_reference(q, k, v, kv_mask=None,
                                     causal: bool = False,
                                     scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core forward's order of work in plain PyTorch: 128
    query rows at every head size against 64-key tiles, the online
    softmax of ``flash_attention_fwd_tiled_reference`` with the running
    sum l over the f32 P, and each tile's P V taken from 0 with P as its
    hi/lo bf16 pair (``split_bf16``), then added into the rescaled
    accumulator. Returns (out in q's dtype, lse f32)."""
    return _fwd_tiles(q, k, v, kv_mask, causal, scale, TC_ROWS, True)


def flash_attention_dq_tc_reference(q, k, v, kv_mask, do, out, lse,
                                    causal: bool = False,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """The tensor-core dq's order of work in plain PyTorch: per batch
    row, query tiles of 128 walk the 64-key tiles in order, stopping
    where the header rule skips; each tile's S = Q K^T, P = exp(S scale
    + mask - lse), dP = dO V^T, dS = P (dP - delta) scale, and its dQ +=
    dS K taken from 0 with dS as a hi/lo bf16 pair, then added into the
    f32 sum in order. delta = rowsum(dO * out), as
    ``flash_attention_bwd`` computes it. Returns dq in q's dtype."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    sc = _scale(scale, dh)
    kvm = _mask(kv_mask, b, tk, q.device)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    lse = lse.float()
    dq = torch.zeros((b, h, tq, dh), device=q.device)
    live = kvm != 0
    for bb in range(b):
        first = int(live[bb].float().argmax()) if live[bb].any() else tk
        bias = (1.0 - kvm[bb]) * NEG_INF
        for q0 in range(0, tq, TC_ROWS):
            q1 = min(tq, q0 + TC_ROWS)
            n_k = -(-tk // TC_KEYS)
            if causal and q0 >= first:
                n_k = min(n_k, (q0 + TC_ROWS - 1) // TC_KEYS + 1)
            for k0 in range(0, n_k * TC_KEYS, TC_KEYS):
                k1 = min(tk, k0 + TC_KEYS)
                s = (torch.einsum("hqd,hkd->hqk", qf[bb, :, q0:q1],
                                  kf[bb, :, k0:k1]) * sc + bias[k0:k1])
                if causal:
                    seen = (torch.arange(q0, q1, device=q.device)[:, None]
                            >= torch.arange(k0, k1, device=q.device)[None])
                    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
                p = torch.exp(s - lse[bb, :, q0:q1, None])
                dp = torch.einsum("hqd,hkd->hqk", dof[bb, :, q0:q1],
                                  vf[bb, :, k0:k1])
                ds = p * (dp - delta[bb, :, q0:q1, None]) * sc
                dq[bb, :, q0:q1] += _split_product(
                    ds, kf[bb, :, k0:k1], "hqk,hkd->hqd")
    return dq.to(q.dtype)


def flash_attention_dkv_tc_reference(q, k, v, kv_mask, do, out, lse,
                                     causal: bool = False,
                                     scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core dkv's order of work in plain PyTorch: per batch
    row, key tiles of 128 walk the query tiles (``tc_query_tile``: 64,
    16 at Dh 128) in order, skipping those the header rule skips; each
    tile is held transposed, S^T = K Q^T, P^T = exp(S^T scale + mask -
    lse), dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, and its dV +=
    P^T dO and dK += dS^T Q are taken from 0 with P^T and dS^T as hi/lo
    bf16 pairs, then added into the f32 sums in order. delta =
    rowsum(dO * out), as ``flash_attention_bwd`` computes it. Returns
    (dk, dv) in k's and v's dtypes."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    sc = _scale(scale, dh)
    kvm = _mask(kv_mask, b, tk, q.device)
    qt = tc_query_tile(dh)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    lse = lse.float()
    dk = torch.zeros((b, h, tk, dh), device=q.device)
    dv = torch.zeros_like(dk)
    live = kvm != 0
    for bb in range(b):
        first = int(live[bb].float().argmax()) if live[bb].any() else tk
        bias = (1.0 - kvm[bb]) * NEG_INF
        for k0 in range(0, tk, TC_ROWS):
            k1 = min(tk, k0 + TC_ROWS)
            for q0 in range(0, tq, qt):
                if causal and q0 >= first and q0 + qt - 1 < k0:
                    continue
                q1 = min(tq, q0 + qt)
                st = (torch.einsum("hkd,hqd->hkq", kf[bb, :, k0:k1],
                                   qf[bb, :, q0:q1]) * sc
                      + bias[k0:k1, None])
                if causal:
                    seen = (torch.arange(q0, q1, device=q.device)[None]
                            >= torch.arange(k0, k1, device=q.device)[:, None])
                    st = torch.where(seen, st, torch.full_like(st, NEG_INF))
                pt = torch.exp(st - lse[bb, :, None, q0:q1])
                dv[bb, :, k0:k1] += _split_product(
                    pt, dof[bb, :, q0:q1], "hkq,hqd->hkd")
                dpt = torch.einsum("hkd,hqd->hkq", vf[bb, :, k0:k1],
                                   dof[bb, :, q0:q1])
                dst = pt * (dpt - delta[bb, :, None, q0:q1]) * sc
                dk[bb, :, k0:k1] += _split_product(
                    dst, qf[bb, :, q0:q1], "hkq,hqd->hkd")
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, kv_mask, do, out, lse,
                                  causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain PyTorch backward in the kernels' op order: p recomputed from
    lse, ``delta = rowsum(dO * out)``, ``ds = p * (dO V^T - delta) *
    scale``; returns (dq, dk, dv) in the inputs' dtypes."""
    b, _, _, dh = q.shape
    sc = _scale(scale, dh)
    kvm = _mask(kv_mask, b, k.shape[2], q.device)
    p = torch.exp(_scores(q, k, kvm, causal, sc) - lse.float()[..., None])
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - delta) * sc
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fn(symbol: str, n_ptr: int, bf16: bool, tc: bool = False):
    """An entry of the library of one operand type: pointers, B, H, Tq,
    Tk, Dh, scale, causal, the type flag (not on the tensor-core
    entries), the stream."""
    fn = getattr(_build.load(_build.typed("flash_attention", bf16)), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int] + [ctypes.c_int] * (not tc) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernels(bf16: bool):
    fns = {"fwd": _fn("flash_attention_fwd", 6, bf16),
           "dq": _fn("flash_attention_dq", 8, bf16),
           "dkv": _fn("flash_attention_dkv", 9, bf16)}
    if bf16:
        fns["fwd_tc"] = _fn("flash_attention_fwd_tc", 6, True, True)
        fns["dq_tc"] = _fn("flash_attention_dq_tc", 8, True, True)
        fns["dkv_tc"] = _fn("flash_attention_dkv_tc", 9, True, True)
    return fns


def flash_tc_path(dtype: torch.dtype, dh: int, aligned: bool) -> bool:
    """Whether the forward, dq or dkv takes its tensor-core kernel:
    bfloat16 operands, a head size the kernels are built for
    (TC_HEAD_SIZES: the padded one, ``built_head_size``) and every
    operand and output of whole 16-byte rows 16-byte aligned
    (``aligned``: q, k, v, out; q, k, v, dO, dq; q, k, v, dO, dk, dv).
    Shape and alignment alone decide; a failure to build or launch
    raises."""
    return dtype == torch.bfloat16 and dh in TC_HEAD_SIZES and aligned


def _check(name, q, k, v, *more):
    """Shapes, dtypes and device the kernels take: q, k, v of one dtype,
    float32 or bfloat16; ``more`` are (name, tensor, shape) triples."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if built_head_size(dh) is None:
        raise ValueError(f"{name}: head size {dh} past {MAX_HEAD_SIZE}, the "
                         f"largest the kernels are built for "
                         f"({HEAD_SIZES})")
    for what, t, shape in (("k", k, (b, h, tk, dh)), ("v", v, (b, h, tk, dh)),
                           *more):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name}: {what} is {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {q.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Tq,Dh], k/v [B,H,Tk,Dh], kv_mask [B,Tk] (1.0 = attend) or
    None → (out [B,H,Tq,Dh], lse [B,H,Tq] f32). The kernel runs a block
    per 128 query rows (64 at Dh 128) over 64-key tiles loaded by
    cp.async into two stages, with an online softmax in registers
    (``flash_attention_fwd_tiled_reference`` is its tiling in plain
    torch); on ``flash_tc_path`` the tensor-core kernel, 128 query rows
    against 64-key tiles in a three-slot ring
    (``flash_attention_fwd_tc_reference``). At a head size the kernels
    are not built for, the next built one on zero-padded q, k, v, with
    this head size's scale; out comes back at Dh."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    sc = _scale(scale, dh)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, kv_mask, causal, sc)
    _check("flash_attention_fwd", q, k, v)
    q, k, v = _pad_head(built_head_size(dh), q.contiguous(), k.contiguous(),
                        v.contiguous())
    kvm = _mask(kv_mask, b, tk, q.device).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    tc = flash_tc_path(q.dtype, q.shape[-1], _aligned(q, k, v, out))
    _launch("fwd", tc, (q, k, v, kvm), (out, lse), tk, causal, sc)
    _count(flash_attention_fwd, tc)
    return out[..., :dh].contiguous() if out.shape[-1] != dh else out, lse


def _launch(which, tc, operands, outs, tk, causal, scale):
    """One kernel, ``fwd``, ``dq`` or ``dkv`` (its tensor-core entry with
    ``tc``), on ``operands`` (q, k, v, kv_mask and, for the backward, dO,
    lse, delta: contiguous, on the card), writing ``outs``."""
    q = operands[0]
    b, h, tq, dh = q.shape
    need = 16 if tc else _VECTOR_BYTES[q.dtype]
    rows = (*operands[:3], *operands[4:5])
    if not all(t.data_ptr() % need == 0 for t in rows):
        raise ValueError(f"flash_attention_{which}: q, k, v and dO must "
                         f"start {need}-byte aligned (the kernel reads "
                         f"{need}-byte vectors); a view into another "
                         f"tensor's storage may not")
    args = (*(t.data_ptr() for t in (*operands, *outs)), b, h, tq, tk, dh,
            scale, int(bool(causal)))
    if tc:
        err = _kernels(True)[f"{which}_tc"](*args, _stream(q))
    else:
        err = _kernels(q.dtype == torch.bfloat16)[which](
            *args, _DTYPES[q.dtype], _stream(q))
    _build.check(err, f"flash_attention_{which}{'_tc' if tc else ''}")


def _count(fn, tc: bool) -> None:
    if tc:
        fn.launches_bf16_tc += 1
    else:
        fn.launches += 1


def flash_attention_dq(operands, dq, causal: bool, scale: float) -> None:
    """The dq kernel's launch, writing ``dq`` (``flash_attention_bwd``
    makes it): the tensor-core kernel on ``flash_tc_path`` (128 query
    rows a block against 64-key tiles;
    ``flash_attention_dq_tc_reference``), else the CUDA-core one."""
    q, k, v, _, do = operands[:5]
    tc = flash_tc_path(q.dtype, q.shape[-1], _aligned(q, k, v, do, dq))
    _launch("dq", tc, operands, (dq,), k.shape[2], causal, scale)
    _count(flash_attention_dq, tc)


def flash_attention_dkv(operands, dk, dv, causal: bool, scale: float) -> None:
    """The dkv kernel's launch, writing ``dk`` and ``dv``
    (``flash_attention_bwd`` makes it): the tensor-core kernel on
    ``flash_tc_path`` (128 keys a block against query tiles of
    ``tc_query_tile``; ``flash_attention_dkv_tc_reference``), else the
    CUDA-core one."""
    q, k, v, _, do = operands[:5]
    tc = flash_tc_path(q.dtype, q.shape[-1], _aligned(q, k, v, do, dk, dv))
    _launch("dkv", tc, operands, (dk, dv), k.shape[2], causal, scale)
    _count(flash_attention_dkv, tc)


def flash_attention_bwd(q, k, v, kv_mask, do, out, lse, causal: bool = False,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``do``,
    from the forward's ``out`` and ``lse``: on a CUDA tensor ``delta`` =
    rowsum(dO * out) outside the kernels (as the reference computes it),
    then the dq and the dkv kernel (at a head size the kernels are not
    built for, the next built one on zero-padded q, k, v and dO, with
    this head size's scale; the gradients come back at Dh); on a CPU
    tensor the plain version."""
    b, h, tq, dh = q.shape
    sc = _scale(scale, dh)
    if not q.is_cuda:
        return flash_attention_bwd_reference(q, k, v, kv_mask, do, out, lse,
                                             causal, sc)
    _check("flash_attention_bwd", q, k, v, ("do", do, (b, h, tq, dh)),
           ("out", out, (b, h, tq, dh)), ("lse", lse, (b, h, tq)))
    do = do.to(q.dtype)
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    q, k, v, do = _pad_head(built_head_size(dh), *(
        t.contiguous() for t in (q, k, v, do)))
    kvm = _mask(kv_mask, b, k.shape[2], q.device).contiguous()
    lse = lse.float().contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    operands = (q, k, v, kvm, do, lse, delta)
    flash_attention_dq(operands, dq, causal, sc)
    flash_attention_dkv(operands, dk, dv, causal, sc)
    if q.shape[-1] != dh:
        return tuple(g[..., :dh].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The differentiable call: forward saves out and lse; backward runs
    ``flash_attention_bwd`` (kernels on the card, plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kvm, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, kvm, causal, scale)
        ctx.save_for_backward(q, k, v, kvm, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kvm, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kvm, do, out, lse,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale * Q K^T + mask) V without a score matrix in device
    memory. q [B,H,Tq,Dh], k/v [B,H,Tk,Dh], kv_mask [B,Tk] (1.0 = attend)
    or None → out [B,H,Tq,Dh]."""
    sc = _scale(scale, q.shape[-1])
    kvm = _mask(kv_mask, q.shape[0], k.shape[2], q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kvm, bool(causal), sc)
    return flash_attention_fwd(q, k, v, kvm, causal, sc)[0]


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_bf16_tc = 0
flash_attention_dq.launches = 0
flash_attention_dq.launches_bf16_tc = 0
flash_attention_dkv.launches = 0
flash_attention_dkv.launches_bf16_tc = 0
