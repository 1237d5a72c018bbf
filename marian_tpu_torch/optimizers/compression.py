"""Train-time compression, copied from
``marian_tpu/optimizers/compression.py``: model quantization and
gradient dropping, both with error feedback, both inside the update.

- Model quantizer (reference: src/optimizers/quantizer.cpp ::
  ModelQuantizer::quantize, --quantize-bits): after each optimizer
  update, snap the parameters to a 2^bits-level grid (uniform, or
  log-based power-of-two levels) with the quantization error carried to
  the next step (--quantize-optimization-steps refines the scale by
  alternating fits).
- Gradient dropping (reference: src/training/gradient_dropping/ ::
  GradientDrop, DGC-style): keep only the largest-|g| fraction of each
  gradient tensor, and carry the rest as residual error feedback. One
  device communicates nothing, so this keeps the training semantics
  (sparsified updates with error feedback), which decide the loss
  trajectory.

Every function returns new tensors; ``optimizers.apply_update`` copies
them into the live parameters and state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def quantize_tensor(v: torch.Tensor, bits: int, log_based: bool = False,
                    opt_steps: int = 0, qrange: float = 0.0) -> torch.Tensor:
    """Quantize one tensor to 2^bits symmetric levels (reference:
    ModelQuantizer::quantizeImpl; opt_steps = the alternating scale fit
    of --quantize-optimization-steps; qrange = --quantize-range, the
    scale clipped at N standard deviations instead of the absmax when
    > 0)."""
    x = v.float()
    levels = float(2 ** (bits - 1) - 1)
    if qrange > 0.0:
        # jnp.std is the population standard deviation
        s = torch.clamp(qrange * torch.std(x, unbiased=False), min=1e-12)
    else:
        s = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    if log_based:
        # centers at s * 2^-k, k in [0, levels]: round the log2 magnitude
        sign = torch.sign(x)
        mag = torch.abs(x) / s
        k = torch.clamp(torch.round(torch.log2(torch.clamp(
            mag, min=2.0 ** -60))), -levels, 0.0)
        q = sign * s * torch.exp2(k)
        # values far below the smallest center snap to zero
        q = torch.where(mag < 2.0 ** (-levels - 1), torch.zeros_like(q), q)
        return q.to(v.dtype)
    for _ in range(max(0, opt_steps)):
        qi = torch.clamp(torch.round(x / s * levels), -levels, levels)
        denom = torch.clamp(torch.sum(qi * qi), min=1e-12)
        s = torch.sum(x * qi) / denom * levels
        s = torch.clamp(torch.abs(s), min=1e-12)
    qi = torch.clamp(torch.round(x / s * levels), -levels, levels)
    # levels as a tensor on s's device: the card divides by a host
    # scalar as a product with its reciprocal, one bit off the quotient
    # for some s, which moves every value of the grid
    return (qi * (s / torch.full_like(s, levels))).to(v.dtype)


def quantize_model(params: Params, error: Params, bits: int,
                   log_based: bool = False, opt_steps: int = 0,
                   include_biases: bool = False, qrange: float = 0.0
                   ) -> Tuple[Params, Params]:
    """Quantize the parameters with error feedback: the next step sees
    param + carried error, so quantization noise does not accumulate
    (reference: ModelQuantizer keeping ``errorResidual``). Tensors with
    fewer than 2 dimensions or one row are left as they are unless
    ``include_biases``."""
    new_p: Params = {}
    new_e: Params = {}
    for k, v in params.items():
        if (v.dim() < 2 or v.shape[0] == 1) and not include_biases:
            new_p[k] = v
            new_e[k] = error[k]
            continue
        target = v.float() + error[k]
        q = quantize_tensor(target, bits, log_based, opt_steps, qrange)
        new_p[k] = q.to(v.dtype)
        new_e[k] = target - q.float()
    return new_p, new_e


def _threshold(x: torch.Tensor, keep_rate: float,
               sample: int = 4096) -> torch.Tensor:
    """The |g| threshold keeping ~keep_rate of the entries, estimated on
    a strided sample of at most ~2 x ``sample`` entries (reference:
    gradient_dropping/sparse estimates the cutoff on a sample too).
    ``torch.quantile``'s default linear interpolation is
    ``jnp.quantile``'s."""
    flat = torch.abs(x.reshape(-1))
    n = flat.shape[0]
    if n > sample:
        flat = flat[::max(1, n // sample)]
    q = min(max(1.0 - keep_rate, 0.0), 1.0)
    return torch.quantile(flat, q)


def drop_gradients(grads: Params, residual: Params, drop_rate: float
                   ) -> Tuple[Params, Params]:
    """Keep the largest-|g + residual| (1 - drop_rate) fraction of each
    tensor; everything else feeds back (reference:
    GradientDrop::dropGraph with error accumulation)."""
    keep = max(1.0 - drop_rate, 0.0)
    new_g: Params = {}
    new_r: Params = {}
    for k, g in grads.items():
        total = g.float() + residual[k]
        thr = _threshold(total, keep)
        mask = (torch.abs(total) >= thr).float()
        kept = total * mask
        new_g[k] = kept.to(g.dtype)
        new_r[k] = total - kept
    return new_g, new_r
