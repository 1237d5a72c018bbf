"""Core tensor ops, ported from ``marian_tpu/ops/ops.py`` with the
reference's op order kept (so f32 results agree to a few ulps):

- layer_norm uses epsilon inside sqrt(var + eps), Marian's eps 1e-9;
- masked softmax adds a large negative (NEG_INF) to masked logits;
- dropout is inverted (kept values divided by keep_prob), with its bits
  drawn from an explicit ``torch.Generator`` (the reference's PRNG keys);
- cross_entropy is Marian's label-smoothed CE, computed in f32;
- in bf16, scalar constants are rounded to the compute dtype before they
  multiply (the reference's ``jnp.asarray(c, dtype)`` and weak-typed
  Python scalars), and products that the reference asks in f32
  (``preferred_element_type``) come out in f32 (``matmul_f32``);
- ``logits_matmul`` is the output projection: f32 logits from
  compute-dtype operands, its backward rounding the cotangent to the
  compute dtype, as the reference's custom VJP does.
"""

from __future__ import annotations

import functools
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


def scalar(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype (the reference's
    ``jnp.asarray(value, dtype)`` and weak-typed Python scalars), as a
    Python float: an elementwise op widens its bf16 operand and this
    value to f32, computes and rounds once, as XLA does. An f32 op
    rounds a Python scalar to f32 itself, so ``value`` is returned as it
    is there."""
    if like.dtype == torch.float32:
        return value
    return _rounded(value, like.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 from operands of one dtype (2-D, or batched with
    equal leading dimensions): f32 accumulation and an f32 result, the
    reference's ``preferred_element_type=float32``. On the card a
    bfloat16 product without a gradient is one cuBLAS call with an f32
    output (``out_dtype``, which autograd cannot differentiate);
    otherwise the operands are widened first, which is the same
    arithmetic, since a product of two bf16 values is exact in f32."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.dtype == torch.float32 or not a.is_cuda or grad:
        return torch.matmul(a.float(), b.float())
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


class _LogitsMatmul(torch.autograd.Function):
    """x [.., d] @ w [d, V] in f32 (reference: ``ops.logits_matmul``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        return matmul_f32(x2, w).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g16 = g.to(x.dtype).reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g16, w.t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = matmul_f32(x.reshape(-1, x.shape[-1]).t(), g16).to(w.dtype)
        return dx, dw


def logits_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w emitting f32 logits from compute-dtype operands; its
    backward rounds the f32 cotangent to x's dtype once, then dx = g16 .
    w^T in x's dtype and dw = x^T . g16 in f32, cast to w's dtype (the
    reference's ``_logits_matmul_bwd``). A plain GEMM outside any Pallas
    kernel in the reference, so cuBLAS runs it on the card. In f32 it is
    x @ w with autograd's own backward arithmetic, and without a gradient
    the forward alone runs, outside autograd."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return matmul_f32(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])
    return _LogitsMatmul.apply(x, w)


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
    return torch.where(mask > 0, x / scalar(keep, x), torch.zeros_like(x))


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
    """L2 norm over a dict of gradients, in f32, summed in key order (the
    order of JAX's ``tree_leaves``): a dict built from a checkpoint lists
    its names sorted, a fresh init in creation order, and the sum must
    not depend on which, or a resumed run drifts from an uninterrupted
    one in the last bits."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in sorted(tree.items())))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    if max_norm <= 0:
        return tree
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-8), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in tree.items()}
