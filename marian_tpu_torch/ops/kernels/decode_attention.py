"""Fused beam-gather + cache-update + attention read for one decode step.

The port of ``marian_tpu/ops/pallas/decode_attention.py ::
decode_attention``: per (row r, head h) read the cache row
``src_rows[r]`` (the pending beam backpointer, None = identity), insert
this step's k/v at ``pos[r]``, write the reordered cache once, and return
``softmax(scale * q.K^T) V`` over positions <= pos (later positions are
replaced by -1e9; compute is f32, caches keep their dtype).

On a CUDA tensor ``decode_attention`` launches the hand-written kernel
``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
``decode_attention_reference``, the plain unfused sequence (row gather,
insert at pos, masked softmax read) in the reference's op order.
``decode_attention.launches`` counts kernel launches. The kernel streams
the cache through shared memory in chunks with an online softmax, so it
takes a cache of any length.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..ops import NEG_INF
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pos_rows(pos, r: int, device) -> torch.Tensor:
    """``pos`` as an int32 [R] vector (scalar callers broadcast)."""
    if isinstance(pos, int):
        return torch.full((r,), pos, dtype=torch.int32, device=device)
    return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(r) \
        .contiguous()


def decode_attention_reference(q, k_new, v_new, cache_k, cache_v, pos,
                               src_rows=None, scale: Optional[float] = None):
    """Plain PyTorch version (the op chain the kernel replaces): flat row
    gather, insert at pos (clamped like dynamic_update_slice), masked
    softmax read. Returns new tensors; the inputs are left untouched."""
    r, _, _, dh = q.shape
    L = cache_k.shape[2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if src_rows is not None:
        cache_k = cache_k.index_select(0, src_rows.to(torch.long))
        cache_v = cache_v.index_select(0, src_rows.to(torch.long))
    else:
        cache_k, cache_v = cache_k.clone(), cache_v.clone()
    p = _pos_rows(pos, r, q.device).to(torch.long)
    rows = torch.arange(r, device=q.device)
    ins = p.clamp(0, L - 1)
    cache_k[rows, :, ins] = k_new[:, :, 0].to(cache_k.dtype)
    cache_v[rows, :, ins] = v_new[:, :, 0].to(cache_v.dtype)
    s = torch.einsum("rhqd,rhkd->rhqk", q.float(), cache_k.float()) * scale
    steps = torch.arange(L, device=q.device)[None, None, None, :]
    s = torch.where(steps <= p[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("rhqk,rhkd->rhqd", w, cache_v.float()).to(q.dtype)
    return out, cache_k, cache_v


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    err = _kernel()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos_t.data_ptr(), src.data_ptr(), out.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), r, h, L, dh, float(scale),
        _DTYPES[q.dtype], _DTYPES[cache_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out, new_k, new_v


decode_attention.launches = 0
