"""Core tensor ops, ported from ``marian_tpu/ops/ops.py`` with the
reference's op order kept (so f32 results agree to a few ulps):

- layer_norm uses epsilon inside sqrt(var + eps), Marian's eps 1e-9;
- masked softmax adds a large negative (NEG_INF) to masked logits;
- dropout is inverted (kept values divided by keep_prob), with its bits
  drawn from an explicit ``torch.Generator`` (the reference's PRNG keys);
- cross_entropy is Marian's label-smoothed CE, computed in f32.
"""

from __future__ import annotations

from typing import Dict, Optional

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


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; the keep mask comes from ``generator`` (on the
    tensor's device). No generator or rate 0: identity."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x, dtype=torch.float32).bernoulli_(
        keep, generator=generator)
    return torch.where(mask > 0, x / keep, torch.zeros_like(x))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-position CE with Marian's label smoothing, in f32:
    ce = (1-eps) * -logP(label) - eps * mean_v logP(v)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over a dict of gradients, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    if max_norm <= 0:
        return tree
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-8), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in tree.items()}
