"""Short-sequence attention, forward and backward, the port of
``marian_tpu/ops/pallas/packed_attention.py :: packed_attention``:

    softmax(scale * Q.K^T + (1 - kv_mask) * -1e9) V

with the scale applied AFTER the product (the dense path scales q
before it, so the two agree to f32 rounding, within 2e-5 at the tests'
shapes), causal positions REPLACED by -1e9, and no zero guard, so a fully
masked row comes out uniform. Layout [B,H,T,Dh] as in the reference.

On a CUDA tensor ``packed_attention`` launches the hand-written kernel
``csrc/packed_attention.cu`` or raises; on a CPU tensor it runs
``packed_attention_reference``. When an input requires a gradient on the
card, the call goes through an autograd Function (the reference's custom
VJP): its forward is the same kernel and saves ``out``; its backward,
``packed_attention_bwd``, launches the backward kernel, which recomputes
P and returns dq, dk, dv (kv_mask gets none), with ``delta = rowsum(dO *
out)`` taken in plain torch before the float32 and tiled kernels, as the
reference takes it, and inside the bf16 tensor-core one. On the CPU the
gradient is autograd through the plain forward.
``packed_attention.launches`` and ``packed_attention_bwd.launches`` count
kernel launches on the CUDA cores, ``.launches_bf16_tc`` of each those
on the tensor cores; ``packed_attention_bwd.launches_tiled`` counts
those of its ``.launches`` that took the tiled kernel (past 64 tokens).

The float32 forward kernel works on 64 x 64 tiles of queries and keys
too: a block per (batch, head) and 64 queries (32 up to 32 queries:
``fwd_query_tile``) stages its query tile and the head's K and V once,
64 keys at a time; up to 64 keys (every sentence of
the training, decode and serving paths) that is one pass, past 64 it
walks the key tiles with an online softmax.
``packed_attention_tiled_reference`` is that tiling in plain torch. It is
built for Dh 16, 32, 64 and 128 (``BWD_HEAD_SIZES``) and stages by
16-byte copies; at any other head size (in either type), or where a
float32 q, k or v is not 16-byte aligned (a view at an odd offset), the
launcher takes the former kernel, which stages a head's whole K and V
a block with scalar loads and walks one query row a warp
(``fwd_query_tile``, a choice by shape). ``max_t`` stays the forward's
routing cap at every head size.

The backward kernel works on 64 x 64 tiles of queries and keys: up to 64
of each (a training sentence) a head is one tile pair, computed once;
past that it walks the key tiles (pass 1 for each row's max and sum,
pass 2 for the products), which lifts its cap (``max_t_bwd``) to 278
tokens at Dh 64, past the reference's 256.
``packed_attention_bwd_tiled_reference`` is that tiling in plain torch.
It is built for Dh 16, 32, 64 and 128 (``BWD_HEAD_SIZES``); at another
head size ``max_t_bwd`` is 0 and the dispatcher takes the dense path when
a gradient is needed.

In bfloat16, up to 64 queries and keys (``packed_tc_path``: every
sentence of the bf16 base update), the backward runs on the tensor cores
(the entry ``packed_attention_bwd_tc``), counted on
``packed_attention_bwd.launches_bf16_tc`` instead: a block of 4 warps a
head forms S and dO.V^T from bf16 products with f32 sums, P and dS in
the order above, dQ = dS.K with dS as a hi/lo bf16 pair (hi = bf16(x),
lo = bf16(x - hi): the f32 value to 2^-16), then dV = P^T.dO and dK =
dS^T.Q from P and dS stored as hi/lo pairs; it takes delta itself, from
the staged dO and ``out``
(``packed_attention_bwd_tc_reference`` is that order of work in plain
torch). Past 64 tokens and in float32 the kernels above run.

In bfloat16 at those head sizes (``packed_tc_fwd_path``: every bf16 call
of the training, decode and serving paths) the forward runs on the
tensor cores too (the entry ``packed_attention_fwd_tc``), counted on
``packed_attention.launches_bf16_tc``: the same query tiles (32 or 64
rows, ``fwd_query_tile``), 64-key tiles and online softmax, S = Q.K^T
from bf16 products with f32 sums and P into P.V as a hi/lo bf16 pair
(``packed_attention_tc_reference`` is that order of work in plain
torch). The wrapper copies an operand that is not 16-byte aligned first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops import NEG_INF
from . import _build
# the hi/lo pair's product; the tensor-core forward's order of work
from .flash_attention import _fwd_tiles, _split_product

_SMEM_FLOATS = 232448 // 4          # a Hopper block's shared-memory ceiling
_WARPS = 4
_TILE = 64                          # the backward's query and key tile
BWD_HEAD_SIZES = (16, 32, 64, 128)  # Dh the backward kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_t(dh: int) -> int:
    """The forward's routing cap: the longest key sequence the dispatcher
    sends to the packed kernel (Tk = 428 at Dh = 64); longer ones go to
    the dense path. It keeps the value the former kernel's shared memory
    set, (2*Tk*(Dh+1) + Tk + 4*(Dh+Tk)) floats within the 227 KB a Hopper
    block may use, which still bounds the generic kernel that other head
    sizes take; the tiled kernel stages 64 keys at a time and is not
    bounded by it. Raising it would move lengths 429-1,023 off the dense
    path, a routing decision of its own."""
    return (_SMEM_FLOATS - _WARPS * dh) // (2 * dh + 3 + _WARPS)


def fwd_query_tile(dh: int, tq: int, aligned: bool = True) -> int:
    """The forward kernel a shape takes, as the query rows a block of the
    tile kernels (float32, and bf16 on the tensor cores) owns: 0 at a
    head size they are not built for, or for operands that are not all
    16-byte aligned (their copies are 16 bytes; the generic kernel, one
    query row a warp, in float32; the wrapper copies bf16 ones); 32 (a
    block of 64 threads) up to 32 queries, as the decode encoder has
    them, so no block computes a half-empty tile; else 64 (128
    threads)."""
    if dh not in BWD_HEAD_SIZES or not aligned:
        return 0
    return 32 if tq <= 32 else _TILE


def _bwd_smem_floats(tq: int, tk: int, dh: int) -> int:
    """Shared memory of the backward kernel's block, in floats
    (``csrc/packed_attention.cu :: bwd_floats``). Up to 64 queries and
    keys: Q, dO, K, V, the key mask and delta, and two 64 x 68 score
    tiles (three below Dh 64, where V's tile cannot take dS). Past that:
    K, V, the Q/dO stages (one at Dh 128), three score tiles, a max, sum
    and delta per query and a mask value per key rounded up to a float4,
    and at Dh <= 64 the dq sums [Tq, Dh]."""
    operand, score = _TILE * (dh + 4), _TILE * (_TILE + 4)
    if tq <= _TILE and tk <= _TILE:
        return 4 * operand + 2 * _TILE + (2 if dh >= 64 else 3) * score
    stats = -(-(3 * tq + tk) // 4) * 4
    stages = 1 if dh > 64 else 2
    return ((2 + 2 * stages) * operand + 3 * score + stats
            + (0 if dh > 64 else tq * dh))


@functools.lru_cache(maxsize=None)
def max_t_bwd(dh: int) -> int:
    """Longest sequence (Tq = Tk = T) the backward kernel takes: its
    block's shared memory must fit the 227 KB a Hopper block may use (T
    = 1,868 / 867 / 278 / 2,816 at Dh 16 / 32 / 64 / 128), and 0 at a
    head size it is not built for. The dispatcher sends what needs a
    gradient past it (or past the forward's ``max_t``) to the dense
    path."""
    if dh not in BWD_HEAD_SIZES:
        return 0
    t = _TILE
    while _bwd_smem_floats(t + 1, t + 1, dh) <= _SMEM_FLOATS:
        t += 1
    return t


def _mask(kv_mask, b: int, tk: int, device) -> torch.Tensor:
    if kv_mask is None:
        return torch.ones((b, tk), dtype=torch.float32, device=device)
    return kv_mask.to(device=device, dtype=torch.float32).reshape(b, tk)


def packed_attention_reference(q, k, v, kv_mask=None, causal: bool = False,
                               scale: Optional[float] = None):
    """Plain PyTorch version in the reference kernel's op order."""
    b, _, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kvm = _mask(kv_mask, b, tk, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + (1.0 - kvm)[:, None, None, :] * NEG_INF
    if causal:
        live = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def packed_attention_tiled_reference(q, k, v, kv_mask=None,
                                     causal: bool = False,
                                     scale: Optional[float] = None):
    """The forward kernel's tiling in plain PyTorch (``fwd_query_tile``
    queries by 64 keys), one batch row at a time: each query tile walks
    the key tiles in order with an online softmax (running max from
    -1e30, sum and accumulator rescaled by exp(m_old - m_new) a tile),
    keys past Tk left out, and divides by the sum at the end. A causal
    key tile wholly after every query of the tile is skipped when the
    batch row has a live key at or before the tile's first query."""
    return _tiles(q, k, v, kv_mask, causal, scale, False)


def _tiles(q, k, v, kv_mask, causal, scale, split: bool):
    """The forward kernels' tiling (flash_attention's ``_fwd_tiles`` at
    ``fwd_query_tile`` query rows and 64-key tiles; l >= 1 here, so its
    zero guard never acts); with ``split`` each tile's P.V takes P as its
    hi/lo bf16 pair. Returns out in q's dtype."""
    dh = q.shape[-1]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    return _fwd_tiles(q, k, v, kv_mask, causal, scale,
                      fwd_query_tile(dh, q.shape[2]) or _TILE, split)[0]


def packed_attention_bwd_reference(q, k, v, kv_mask, do, out,
                                   causal: bool = False,
                                   scale: Optional[float] = None):
    """Plain PyTorch backward in the kernel's op order: P recomputed,
    ``delta = rowsum(dO * out)``, ``ds = p * (dp - delta) * scale``;
    returns (dq, dk, dv)."""
    b, _, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kvm = _mask(kv_mask, b, tk, q.device)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    s = s + (1.0 - kvm)[:, None, None, :] * NEG_INF
    if causal:
        live = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_attention_bwd_tiled_reference(q, k, v, kv_mask, do, out,
                                         causal: bool = False,
                                         scale: Optional[float] = None):
    """The backward kernel's tiling in plain PyTorch (64 x 64 tiles), one
    batch row at a time: pass 1 takes each query tile across the key
    tiles it sees for every row's max and sum (online, from -1e30); pass
    2 takes the key tiles in order and, in each, the query tiles that see
    it, summing dk and dv of the key tile over the query tiles and dq of
    each query tile over the key tiles in their order. A causal (query
    tile, key tile) pair is skipped when all its keys follow all its
    queries and its first query sees a live key. Returns (dq, dk, dv)."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kvm = _mask(kv_mask, b, tk, q.device)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    qt = kt = _TILE
    live = kvm != 0
    for bb in range(b):
        first = int(live[bb].float().argmax()) if live[bb].any() else tk
        bias = (1.0 - kvm[bb]) * NEG_INF

        def sees(i0, j0):
            return not (causal and i0 >= first and j0 > i0 + qt - 1)

        def scores(i0, j0):
            i1, j1 = min(tq, i0 + qt), min(tk, j0 + kt)
            s = torch.einsum("hqd,hkd->hqk", qf[bb, :, i0:i1],
                             kf[bb, :, j0:j1]) * scale + bias[j0:j1]
            if causal:
                live = (torch.arange(i0, i1, device=q.device)[:, None]
                        >= torch.arange(j0, j1, device=q.device)[None, :])
                s = torch.where(live, s, torch.full_like(s, NEG_INF))
            return s

        m = torch.full((h, tq), -1e30, device=q.device)
        l = torch.zeros((h, tq), device=q.device)
        for i0 in range(0, tq, qt):
            rows = slice(i0, min(tq, i0 + qt))
            for j0 in range(0, tk, kt):
                if not sees(i0, j0):
                    continue
                s = scores(i0, j0)
                m_new = torch.maximum(m[:, rows], s.amax(dim=-1))
                l[:, rows] = (torch.exp(m[:, rows] - m_new) * l[:, rows]
                              + torch.exp(s - m_new[..., None]).sum(dim=-1))
                m[:, rows] = m_new
        for j0 in range(0, tk, kt):
            keys = slice(j0, min(tk, j0 + kt))
            for i0 in range(0, tq, qt):
                if not sees(i0, j0):
                    continue
                rows = slice(i0, min(tq, i0 + qt))
                p = (torch.exp(scores(i0, j0) - m[:, rows, None])
                     / l[:, rows, None])
                dp = torch.einsum("hqd,hkd->hqk", dof[bb, :, rows],
                                  vf[bb, :, keys])
                ds = p * (dp - delta[bb, :, rows, None]) * scale
                dv[bb, :, keys] += torch.einsum("hqk,hqd->hkd", p,
                                                dof[bb, :, rows])
                dk[bb, :, keys] += torch.einsum("hqk,hqd->hkd", ds,
                                                qf[bb, :, rows])
                dq[bb, :, rows] += torch.einsum("hqk,hkd->hqd", ds,
                                                kf[bb, :, keys])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_attention_bwd_tc_reference(q, k, v, kv_mask, do, out,
                                      causal: bool = False,
                                      scale: Optional[float] = None):
    """The tensor-core backward's order of work in plain PyTorch (Tq, Tk
    <= 64, one tile pair a head): S = Q K^T scale + mask (causal
    positions -1e9), P = exp(S - rowmax) / rowsum, dP = dO V^T, dS = P
    (dP - delta) scale with delta = rowsum(dO * out); then dQ = dS K, dV
    = P^T dO and dK = dS^T Q, each from 0 with dS (P) as its hi/lo bf16
    pair. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, _, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kvm = _mask(kv_mask, b, tk, q.device)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    s = s + (1.0 - kvm)[:, None, None, :] * NEG_INF
    if causal:
        live = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = _split_product(ds, kf, "bhqk,bhkd->bhqd")
    dv = _split_product(p, dof, "bhqk,bhqd->bhkd")
    dk = _split_product(ds, qf, "bhqk,bhqd->bhkd")
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_attention_tc_reference(q, k, v, kv_mask=None,
                                  causal: bool = False,
                                  scale: Optional[float] = None):
    """The tensor-core forward's order of work in plain PyTorch, one
    batch row at a time: query tiles of ``fwd_query_tile`` rows walk the
    64-key tiles in order with the online softmax from a running max of
    -1e30, each tile's P.V taken from 0 with P as its hi/lo bf16 pair
    (``_split_product``) and added into the rescaled accumulator, the
    division by the sum at the end (l >= 1: the row max contributes
    exp(0)); a causal key tile wholly after every query of the tile is
    skipped when the batch row has a live key at or before the tile's
    first query. Returns out in q's dtype."""
    return _tiles(q, k, v, kv_mask, causal, scale, True)


def packed_tc_fwd_path(dtype: torch.dtype, dh: int) -> bool:
    """Whether the forward takes its tensor-core kernel: bfloat16
    operands at a head size it is built for (BWD_HEAD_SIZES), at every
    length up to the routing cap. The wrapper hands it 16-byte aligned
    operands (it copies others); type and head size alone decide."""
    return dtype == torch.bfloat16 and dh in BWD_HEAD_SIZES


def packed_tc_path(dtype: torch.dtype, dh: int, tq: int, tk: int) -> bool:
    """Whether the backward takes its tensor-core kernel: bfloat16
    operands at a head size it is built for (BWD_HEAD_SIZES) and one
    tile pair (Tq, Tk <= 64). The wrapper hands it 16-byte aligned
    operands (it copies others); shape alone decides."""
    return (dtype == torch.bfloat16 and dh in BWD_HEAD_SIZES
            and max(tq, tk) <= _TILE)


@functools.lru_cache(maxsize=None)
def _kernel(bf16: bool):
    fn = _build.load(_build.typed("packed_attention", bf16)).packed_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_tc_kernel():
    fn = _build.load(_build.typed("packed_attention",
                                  True)).packed_attention_fwd_tc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel(bf16: bool):
    fn = _build.load(_build.typed("packed_attention",
                                  bf16)).packed_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_tc_kernel():
    fn = _build.load(_build.typed("packed_attention",
                                  True)).packed_attention_bwd_tc
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_operands(name, q, k, v):
    b, h, _, dh = q.shape
    tk = k.shape[2]
    for what, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, tk, dh) or t.device != q.device \
                or t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, expected "
                             f"{(b, h, tk, dh)} {q.dtype} on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32/bfloat16, got {q.dtype}")


def _aligned(t):
    """t, or a copy of it where it is not 16-byte aligned (the kernels
    stage by 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(q, k, v, kvm, causal, scale):
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    if packed_tc_fwd_path(q.dtype, dh):
        q, k, v = (_aligned(t) for t in (q, k, v))
        err = _fwd_tc_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
            out.data_ptr(), b, h, tq, tk, dh, float(scale),
            int(bool(causal)), fwd_query_tile(dh, tq), _stream(q))
        _build.check(err, "packed_attention_fwd_tc")
        packed_attention.launches_bf16_tc += 1
        return out
    err = _kernel(q.dtype == torch.bfloat16)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
        out.data_ptr(), b, h, tq, tk, dh, float(scale), int(bool(causal)),
        _DTYPES[q.dtype],
        fwd_query_tile(dh, tq, all(t.data_ptr() % 16 == 0 for t in (q, k, v))),
        _stream(q))
    _build.check(err, "packed_attention")
    packed_attention.launches += 1
    return out


class _PackedAttention(torch.autograd.Function):
    """The card's differentiable call: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kvm, causal, scale):
        out = _launch_fwd(q, k, v, kvm, causal, scale)
        ctx.save_for_backward(q, k, v, kvm, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kvm, out = ctx.saved_tensors
        dq, dk, dv = packed_attention_bwd(q, k, v, kvm, do, out, ctx.causal,
                                          ctx.scale)
        return dq, dk, dv, None, None, None


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: Optional[torch.Tensor] = None,
                     causal: bool = False,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,Tq,Dh], k/v [B,H,Tk,Dh], kv_mask [B,Tk] (1.0 = attend) or
    None → out [B,H,Tq,Dh]."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if not q.is_cuda:
        return packed_attention_reference(q, k, v, kv_mask, causal, scale)
    _check_operands("packed_attention", q, k, v)
    if tk > max_t(dh):
        raise ValueError(f"packed_attention: key length {tk} exceeds the "
                         f"kernel's cap {max_t(dh)} at Dh={dh}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kvm = _mask(kv_mask, b, tk, q.device).contiguous()
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if grad:
        return _PackedAttention.apply(q, k, v, kvm, bool(causal),
                                      float(scale))
    return _launch_fwd(q, k, v, kvm, causal, scale)


def packed_attention_bwd(q, k, v, kv_mask, do, out, causal: bool = False,
                         scale: Optional[float] = None):
    """(dq, dk, dv) of ``packed_attention`` for the output gradient
    ``do``: the backward kernel on a CUDA tensor (one launch: the one-tile
    kernel up to 64 queries and keys, on the tensor cores in bf16
    (``packed_tc_path``), else the tiled one, with a global f32 dq scratch
    at Dh 128), the plain version on a CPU tensor. Raises past
    ``max_t_bwd`` or at a head size the kernel is not built for."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if not q.is_cuda:
        return packed_attention_bwd_reference(q, k, v, kv_mask, do, out,
                                              causal, scale)
    _check_operands("packed_attention_bwd", q, k, v)
    if dh not in BWD_HEAD_SIZES:
        raise ValueError(f"packed_attention_bwd: head size {dh} not in "
                         f"{BWD_HEAD_SIZES}")
    if _bwd_smem_floats(tq, tk, dh) > _SMEM_FLOATS:
        raise ValueError(f"packed_attention_bwd: lengths {tq}x{tk} exceed "
                         f"the backward kernel's cap {max_t_bwd(dh)} at "
                         f"Dh={dh}")
    for what, t in (("do", do), ("out", out)):
        if tuple(t.shape) != (b, h, tq, dh):
            raise ValueError(f"packed_attention_bwd: {what} is "
                             f"{tuple(t.shape)}, expected {(b, h, tq, dh)}")
    q, k, v, do = (_aligned(t) for t in (q.contiguous(), k.contiguous(),
                                         v.contiguous(),
                                         do.to(q.dtype).contiguous()))
    kvm = _mask(kv_mask, b, tk, q.device).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if packed_tc_path(q.dtype, dh, tq, tk):
        # the kernel takes delta = rowsum(dO * out) from out, in q's dtype
        # as the forward returns it
        out = _aligned(out.to(q.dtype).contiguous())
        err = _bwd_tc_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
            do.data_ptr(), out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, tq, tk, dh, float(scale),
            int(bool(causal)), _stream(q))
        _build.check(err, "packed_attention_bwd_tc")
        packed_attention_bwd.launches_bf16_tc += 1
        return dq, dk, dv
    # delta outside the kernel, as the reference computes it
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    # past one tile the Dh 128 kernel sums dq in global f32 scratch
    dq_sum = (torch.empty((b, h, tq, dh), dtype=torch.float32,
                          device=q.device)
              if dh > 64 and max(tq, tk) > _TILE else None)
    err = _bwd_kernel(q.dtype == torch.bfloat16)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if dq_sum is None else dq_sum.data_ptr(), b, h,
        tq, tk, dh, float(scale), int(bool(causal)), _DTYPES[q.dtype],
        _stream(q))
    _build.check(err, "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    if max(tq, tk) > _TILE:
        packed_attention_bwd.launches_tiled += 1    # of .launches
    return dq, dk, dv


packed_attention.launches = 0
packed_attention.launches_bf16_tc = 0
packed_attention_bwd.launches = 0
packed_attention_bwd.launches_tiled = 0
packed_attention_bwd.launches_bf16_tc = 0
