"""Scaled dot-product attention and its dispatcher, ported from
``marian_tpu/ops/attention.py``.

Shapes are batch-major: q [B, H, Tq, Dh], k/v [B, H, Tk, Dh],
mask [B, 1, Tq, Tk] (1 = attend).

The dense path keeps the reference's op order (q scaled BEFORE the score
product, ``(1 - mask) * NEG_INF`` added, attention dropout on the
weights). The dispatcher keeps the reference's gates: both kernels are
applicable without returned weights, without active attention dropout,
with a structured mask and more than one query position. The flash gate
comes first, as in the reference: ``flash="on"``, or ``auto`` at
``max(Tq, Tk) >= FLASH_MIN_LEN``, takes the flash kernel on the card and
its plain version on the CPU (the reference's ``auto`` engages flash on
every backend); ``off`` leaves the call to the packed or dense path.
Under ``auto`` a head size past the flash kernels' largest
(``MAX_HEAD_SIZE``, 128) skips the flash gate, so such a call goes on to
the packed gate and, past its caps, to the dense path, as the packed
kernel's calls do at a head size its backward is not built for (the
model refuses ``on`` at such a head size when it is built). On
the card ``packed="auto"`` engages the packed kernel whenever the length
is within its cap (the reference's head-pack test is TPU geometry and is
dropped): the forward's cap and, when an input requires a gradient, the
backward kernel's too (0 at a head size it is not built for), past which
the dense path runs, as the reference's does past its packed cap. On the
CPU packed ``auto`` stays dense, ``on`` runs the kernel's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.flash_attention import MAX_HEAD_SIZE, flash_attention
from .kernels.packed_attention import max_t, max_t_bwd, packed_attention
from .ops import NEG_INF, dropout, matmul_f32, scalar

# the reference's default flash crossover (marian_tpu/ops/auto_tuner.py
# :: flash_threshold)
FLASH_MIN_LEN = 1024


def dense_attention_with_weights(q, k, v, mask=None, return_weights=True,
                                 dropout_rate: float = 0.0, generator=None):
    dh = q.shape[-1]
    # 1/sqrt(dh) computed in f32 and rounded to q's dtype, as the
    # reference computes it; the scores in f32 from q's dtype
    scale = (1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
             ).item()
    scores = matmul_f32(q * scalar(scale, q), k.transpose(-1, -2))
    if mask is not None:
        scores = scores + (1.0 - mask.to(scores.dtype)) * NEG_INF
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        weights = dropout(weights, dropout_rate, generator)
    out = torch.matmul(weights, v).to(q.dtype)
    return out, (weights if return_weights else None)


def attention(q, k, v, mask=None, kv_mask=None, causal: bool = False,
              return_weights: bool = False, flash: str = "auto",
              packed: str = "auto", dropout_rate: float = 0.0,
              generator=None):
    """Attention dispatcher: dense vs the flash and packed kernels;
    returns (context, weights or None). ``dropout_rate`` > 0 is attention
    dropout in training (the caller passes 0 otherwise), drawn from
    ``generator``."""
    applicable = (not return_weights and dropout_rate == 0.0
                  and q.shape[-2] > 1
                  and (kv_mask is not None or causal or mask is None))
    if applicable and flash != "off" and (
            flash == "on" or (max(q.shape[-2], k.shape[-2]) >= FLASH_MIN_LEN
                              and q.shape[-1] <= MAX_HEAD_SIZE)):
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal), None
    if applicable and packed != "off":
        grad = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        dh = q.shape[-1]
        cap = min(max_t(dh), max_t_bwd(dh)) if grad else max_t(dh)
        fits = max(q.shape[-2], k.shape[-2]) <= cap
        if fits and (packed == "on" or q.is_cuda):
            return packed_attention(q, k, v, kv_mask=kv_mask,
                                    causal=causal), None
    return dense_attention_with_weights(q, k, v, mask, return_weights,
                                        dropout_rate, generator)


def causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 1, T, T] future mask."""
    m = torch.tril(torch.ones((length, length), dtype=dtype, device=device))
    return m[None, None, :, :]


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else out * m
    return out
