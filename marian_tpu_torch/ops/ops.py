"""Core tensor ops, ported from ``marian_tpu/ops/ops.py`` with the
reference's op order kept (so f32 results agree to a few ulps):

- layer_norm uses epsilon inside sqrt(var + eps), Marian's eps 1e-9;
- masked softmax adds a large negative (NEG_INF) to masked logits.

Dropout is absent: this slice only decodes.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large-negative mask value; safe in bf16


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-9) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             eps: float = 1e-9) -> torch.Tensor:
    """RMSNorm (reference: rmsNorm in expression_operators.cpp)."""
    dtype = x.dtype
    x32 = x.float()
    ms = torch.square(x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": torch.relu,
    "swish": swish,
    "gelu": gelu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def activation(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation '{name}'") from None


def affine(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w + b with Marian's [in, out] weight layout."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y
