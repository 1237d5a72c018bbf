"""Fused beam-gather + cache-update + attention read for one decode step.

The port of ``marian_tpu/ops/pallas/decode_attention.py ::
decode_attention``: per (row r, head h) read the cache row
``src_rows[r]`` (the pending beam backpointer, None = identity), insert
this step's k/v at ``pos[r]`` (``insert_index``: where the reference's
dynamic_update_slice puts it, so -1 is the last position), write the
reordered cache once, and return
``softmax(scale * q.K^T) V`` over positions <= pos (later positions are
replaced by -1e9; compute is f32, caches keep their dtype).

On a CUDA tensor ``decode_attention`` launches the hand-written kernel
``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
``decode_attention_reference``, the plain unfused sequence (row gather,
insert at pos, masked softmax read) in the reference's op order.
``decode_attention.launches`` counts kernel launches.

The kernel streams a (row, head) cache tile in chunks of 16-byte
vectors, a chunk in flight while the block copies and reads the last,
with key groups of lanes that each keep their own online softmax; the
layout (``vector_layout``) is chosen here and passed to the kernel, which
is built for each layout this rule gives.
``decode_attention_tiled_reference`` is that order of work in plain
PyTorch. A row that is not a whole
number of 16-byte vectors, or a cache that is not 16-byte aligned, takes
the scalar kernel instead (``vector_path``): the launcher chooses by the
shapes, never on a failed launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from ..ops import NEG_INF
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 128          # a block of the vector kernel


def vector_path(dh: int, itemsize: int, aligned: bool = True) -> bool:
    """Whether the vector kernel takes a cache row of ``dh`` elements of
    ``itemsize`` bytes: a whole number of 16-byte vectors (Dh % 4 in f32,
    Dh % 8 in bf16) in caches whose addresses are 16-byte aligned; else
    the scalar kernel runs."""
    return dh * itemsize % 16 == 0 and aligned


def vector_layout(dh: int, itemsize: int) -> Tuple[int, int, int]:
    """(lanes a key, vectors a lane, positions a chunk) of the vector
    kernel, which takes the first two as its layout: a key takes
    the least power of two of lanes, at least 4, that holds its row's
    16-byte vectors one a lane (two a lane past 32 vectors); the block's
    128 lanes so form 128 / lanes key groups, and a chunk gives each group
    4 / (vectors a lane) keys."""
    nv = dh * itemsize // 16
    lanes = max(4, 1 << max(0, nv - 1).bit_length())
    per_lane = 1
    if lanes > 32:
        lanes, per_lane = 32, 2
    return lanes, per_lane, (4 // per_lane) * (_THREADS // lanes)


def _pos_rows(pos, r: int, device) -> torch.Tensor:
    """``pos`` as an int32 [R] vector (scalar callers broadcast)."""
    if isinstance(pos, int):
        return torch.full((r,), pos, dtype=torch.int32, device=device)
    return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(r) \
        .contiguous()


def insert_index(p, length: int):
    """Where this step's k/v land, as the reference's dynamic_update_slice
    puts them: a negative pos counts from the end (-1 is the last
    position), then the index is clamped into the cache."""
    return torch.where(p < 0, p + length, p).clamp(0, length - 1)


def _updated_caches(k_new, v_new, cache_k, cache_v, p, src_rows):
    """The gathered caches with this step's k/v inserted at
    ``insert_index(pos)``, as new tensors."""
    r, L = cache_k.shape[0], cache_k.shape[2]
    if src_rows is not None:
        cache_k = cache_k.index_select(0, src_rows.to(torch.long))
        cache_v = cache_v.index_select(0, src_rows.to(torch.long))
    else:
        cache_k, cache_v = cache_k.clone(), cache_v.clone()
    rows = torch.arange(r, device=cache_k.device)
    ins = insert_index(p, L)
    cache_k[rows, :, ins] = k_new[:, :, 0].to(cache_k.dtype)
    cache_v[rows, :, ins] = v_new[:, :, 0].to(cache_v.dtype)
    return cache_k, cache_v


def decode_attention_reference(q, k_new, v_new, cache_k, cache_v, pos,
                               src_rows=None, scale: Optional[float] = None):
    """Plain PyTorch version (the op chain the kernel replaces): flat row
    gather, insert at ``insert_index(pos)`` (as dynamic_update_slice
    places it), masked softmax read over positions <= pos (none when pos
    < 0: the plain average of V). Returns new tensors; the inputs are
    left untouched."""
    r, _, _, dh = q.shape
    L = cache_k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    p = _pos_rows(pos, r, q.device).to(torch.long)
    cache_k, cache_v = _updated_caches(k_new, v_new, cache_k, cache_v, p,
                                       src_rows)
    s = torch.einsum("rhqd,rhkd->rhqk", q.float(), cache_k.float()) * scale
    steps = torch.arange(L, device=q.device)[None, None, None, :]
    s = torch.where(steps <= p[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("rhqk,rhkd->rhqd", w, cache_v.float()).to(q.dtype)
    return out, cache_k, cache_v


def _weights(m, mm):
    """exp(m - mm), 0 where mm is -inf (nothing scored)."""
    live = mm > -math.inf
    return torch.where(live, torch.exp(m - torch.where(live, mm, 0.0)),
                       torch.zeros_like(m))


def decode_attention_tiled_reference(q, k_new, v_new, cache_k, cache_v, pos,
                                     src_rows=None,
                                     scale: Optional[float] = None,
                                     layout: Optional[Tuple[int, int, int]]
                                     = None):
    """The vector kernel's order of work in plain PyTorch. The caches are
    gathered and updated as ``decode_attention_reference`` has them. The
    context: the chunks of ``chunk`` positions are walked in order, and
    key group g of the block's 128 / lanes takes keys g, g + groups, ...
    of each chunk, scores them (q.k * scale; -1e9 for every key when
    pos < 0; keys after pos not at all) and folds them into its own
    running max, sum and accumulator, rescaled once a chunk; the groups
    are then merged in group order. ``layout`` is ``vector_layout``'s
    triple (the f32 cache's by default). Returns (context, new caches)."""
    r, h, _, dh = q.shape
    L = cache_k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lanes, _, chunk = layout or vector_layout(dh, 4)
    groups = _THREADS // lanes
    per_group = -(-chunk // groups)
    p = _pos_rows(pos, r, q.device).to(torch.long)
    new_k, new_v = _updated_caches(k_new, v_new, cache_k, cache_v, p,
                                   src_rows)
    kf, vf, qf = new_k.float(), new_v.float(), q.float()[:, :, 0]
    none_live = (p < 0)[:, None, None, None]
    live_end = torch.where(p < 0, L, p.clamp(max=L - 1) + 1)
    slots = (torch.arange(groups)[:, None]
             + groups * torch.arange(per_group)[None, :]).to(q.device)
    m = torch.full((r, h, groups), -math.inf, device=q.device)
    l = torch.zeros((r, h, groups), device=q.device)
    acc = torch.zeros((r, h, groups, dh), device=q.device)
    for c0 in range(0, L, chunk):
        j = c0 + slots                                       # [G, U]
        scored = ((j < min(L, c0 + chunk))[None]
                  & (j[None] < live_end[:, None, None]))      # [R, G, U]
        jc = j.clamp(max=L - 1)
        s = torch.einsum("rhd,rhgud->rhgu", qf, kf[:, :, jc]) * scale
        s = torch.where(none_live, torch.full_like(s, NEG_INF), s)
        s = torch.where(scored[:, None], s, torch.full_like(s, -math.inf))
        mx = s.amax(dim=-1)
        has = mx > -math.inf
        m_new = torch.where(has, torch.maximum(m, mx), m)
        alpha = torch.where(has, _weights(m, m_new), torch.ones_like(m))
        w = torch.where(has[..., None], torch.exp(
            s - torch.where(has, m_new, 0.0)[..., None]),
            torch.zeros_like(s))
        l = l * alpha + w.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "rhgu,rhgud->rhgd", w, vf[:, :, jc])
        m = m_new
    # position 0 is always scored, so the groups' max is finite
    wg = _weights(m, m.amax(dim=-1, keepdim=True))
    o = torch.einsum("rhg,rhgd->rhd", wg, acc)
    out = (o / (wg * l).sum(dim=-1)[..., None])[:, :, None].to(q.dtype)
    return out, new_k, new_v


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: Union[int, torch.Tensor],
                     src_rows: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     out_k: Optional[torch.Tensor] = None,
                     out_v: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode-attention step.

    q/k_new/v_new [R,H,1,Dh]; cache_k/v [R,H,L,Dh]; pos an int, a 0-d or
    an [R] int tensor; src_rows [R] flat source rows (None = identity).
    Returns (context [R,H,1,Dh], new_cache_k, new_cache_v).

    The new caches are written to other buffers than the caches read
    (the gather reads rows other blocks write). ``out_k``/``out_v`` let a
    caller pass those buffers, so a decoder can ping-pong two caches per
    layer instead of allocating a fresh pair every step.
    """
    r, h, _, dh = q.shape
    L = cache_k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if not q.is_cuda:
        return decode_attention_reference(q, k_new, v_new, cache_k, cache_v,
                                          pos, src_rows, scale)
    if q.requires_grad:
        raise RuntimeError("decode_attention has no backward")
    for name, t, shape in (("k_new", k_new, (r, h, 1, dh)),
                           ("v_new", v_new, (r, h, 1, dh)),
                           ("cache_k", cache_k, (r, h, L, dh)),
                           ("cache_v", cache_v, (r, h, L, dh))):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"decode_attention: {name} is {tuple(t.shape)} "
                             f"on {t.device}, expected {shape} on {q.device}")
    if q.dtype not in _DTYPES or cache_k.dtype not in _DTYPES \
            or k_new.dtype != q.dtype or v_new.dtype != q.dtype \
            or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"decode_attention takes float32/bfloat16 q, k_new, "
                        f"v_new of one dtype and caches of one dtype, got "
                        f"{q.dtype}/{k_new.dtype}/{v_new.dtype} and "
                        f"{cache_k.dtype}/{cache_v.dtype}")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    cache_k, cache_v = cache_k.contiguous(), cache_v.contiguous()
    pos_t = _pos_rows(pos, r, q.device)
    src = (torch.arange(r, dtype=torch.int32, device=q.device)
           if src_rows is None
           else src_rows.to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty_like(q)
    new_k = torch.empty_like(cache_k) if out_k is None else out_k
    new_v = torch.empty_like(cache_v) if out_v is None else out_v
    for buf, ref in ((new_k, cache_k), (new_v, cache_v)):
        if buf.shape != ref.shape or buf.dtype != ref.dtype \
                or not buf.is_contiguous() or buf.device != q.device:
            raise ValueError("decode_attention: output cache buffers must "
                             "match the caches' shape, dtype and device")
        if buf.data_ptr() in (cache_k.data_ptr(), cache_v.data_ptr()):
            raise ValueError("decode_attention: output caches must not alias "
                             "the input caches")
    kernel = _kernel()
    itemsize = cache_k.element_size()
    lanes, per_lane = 0, 0                    # the scalar kernel
    if vector_path(dh, itemsize, all(
            t.data_ptr() % 16 == 0 for t in (cache_k, cache_v, new_k, new_v))):
        lanes, per_lane, _ = vector_layout(dh, itemsize)
    err = kernel(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos_t.data_ptr(), src.data_ptr(), out.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), r, h, L, dh, float(scale),
        _DTYPES[q.dtype], _DTYPES[cache_k.dtype], lanes, per_lane,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out, new_k, new_v


decode_attention.launches = 0
