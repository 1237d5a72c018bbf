"""Short-sequence attention forward, the port of
``marian_tpu/ops/pallas/packed_attention.py :: packed_attention``:

    softmax(scale * Q.K^T + (1 - kv_mask) * -1e9) V

with the scale applied AFTER the product (the dense path scales q
before it, so the two agree to f32 rounding, within 2e-5 at the tests'
shapes), causal positions REPLACED by -1e9, and no zero guard, so a fully
masked row comes out uniform. Layout [B,H,T,Dh] as in the reference.

On a CUDA tensor ``packed_attention`` launches the hand-written kernel
``csrc/packed_attention.cu`` or raises; on a CPU tensor it runs
``packed_attention_reference``. Forward only: the backward comes with
the training slice, and the wrapper refuses a CUDA ``q`` that requires
grad. ``packed_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops import NEG_INF
from . import _build

_SMEM_FLOATS = 232448 // 4          # a Hopper block's shared-memory ceiling
_WARPS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_t(dh: int) -> int:
    """Longest key sequence the kernel stages per block: its shared
    memory, (2*Tk*(Dh+1) + Tk + 4*(Dh+Tk)) floats, must fit the 227 KB a
    Hopper block may use (Tk = 428 at Dh = 64). The dispatcher sends
    longer sequences to the dense path."""
    return (_SMEM_FLOATS - _WARPS * dh) // (2 * dh + 3 + _WARPS)


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


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("packed_attention").packed_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("packed_attention on CUDA is forward-only: its "
                           "backward comes with the training slice")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, tk, dh) or t.device != q.device \
                or t.dtype != q.dtype:
            raise ValueError(f"packed_attention: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, expected "
                             f"{(b, h, tk, dh)} {q.dtype} on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"packed_attention takes float32/bfloat16, got "
                        f"{q.dtype}")
    if tk > max_t(dh):
        raise ValueError(f"packed_attention: key length {tk} exceeds the "
                         f"kernel's cap {max_t(dh)} at Dh={dh}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kvm = _mask(kv_mask, b, tk, q.device).contiguous()
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
        out.data_ptr(), b, h, tq, tk, dh, float(scale), int(bool(causal)),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "packed_attention")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0
