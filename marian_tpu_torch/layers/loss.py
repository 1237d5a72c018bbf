"""Loss assembly: cross-entropy with label smoothing and data weighting,
carried as Marian's "rational loss" (sum, label count), the unlikelihood
objective (--unlikelihood-loss) and the guided-alignment cost, ported
from ``marian_tpu/layers/loss.py`` (reference src/layers/loss.cpp,
src/layers/guided_alignment.cpp). ce-sum / ce-mean / ce-mean-words /
perplexity are different finalizations of the same pair (the gradient's
denominator, ``training/graph_group.py``, and the displayed cost,
``training/scheduler.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.ops import cross_entropy


@dataclasses.dataclass
class RationalLoss:
    loss_sum: torch.Tensor   # scalar f32
    labels: torch.Tensor     # scalar f32 (real target labels in batch)


def weighted_loss(ce: torch.Tensor, mask: torch.Tensor,
                  data_weights: Optional[torch.Tensor] = None
                  ) -> RationalLoss:
    """[B, T] per-token CE → summed over real tokens (times the data
    weights, sentence [B, 1] or word [B, T] level)."""
    w = mask.float()
    if data_weights is not None:
        w = w * torch.broadcast_to(data_weights.float(), w.shape)
    return RationalLoss(torch.sum(ce * w), torch.sum(mask.float()))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, label_smoothing: float = 0.0,
                       data_weights: Optional[torch.Tensor] = None,
                       unlikelihood: bool = False) -> RationalLoss:
    """logits [B,T,V], labels [B,T], mask [B,T] → summed CE over real
    tokens.

    unlikelihood (--unlikelihood-loss, reference: layers/loss.h ::
    SequenceUnlikelihoodLoss): the sign of the data weight selects the
    objective per token: weight >= 0 trains likelihood (-w·log p), weight
    < 0 unlikelihood (-|w|·log(1-p))."""
    if unlikelihood and data_weights is not None:
        w = mask.float()
        dw = torch.broadcast_to(data_weights.float(), w.shape)
        pos = dw >= 0
        ce_like = cross_entropy(logits, labels, label_smoothing)
        logp = -cross_entropy(logits, labels, 0.0)
        # log(1-p) = log1p(-exp(logp)), clamped away from logp == 0
        log1mp = torch.log1p(-torch.exp(torch.clamp(logp, max=-1e-6)))
        ce = torch.where(pos, ce_like, -log1mp)
        w = w * torch.abs(dw)
        return RationalLoss(torch.sum(ce * w), torch.sum(mask.float()))
    return weighted_loss(cross_entropy(logits, labels, label_smoothing),
                         mask, data_weights)


def guided_alignment_loss(attn: torch.Tensor, guided: torch.Tensor,
                          trg_mask: torch.Tensor, cost_type: str = "ce",
                          eps: float = 1e-6) -> torch.Tensor:
    """attn, guided: [B, Tt, Ts] (normalised rows) → the mean per-token
    cost between soft attention and the guided alignment, over the target
    positions that have an alignment point (reference:
    guided_alignment.cpp :: guidedAlignmentCost)."""
    a = attn.float()
    g = guided.float()
    if cost_type == "ce":
        per_tok = -torch.sum(g * torch.log(a + eps), dim=-1)
    elif cost_type == "mse":
        per_tok = 0.5 * torch.sum(torch.square(a - g), dim=-1)
    elif cost_type == "mult":
        per_tok = -torch.log(torch.sum(a * g, dim=-1) + eps)
    else:
        raise ValueError(f"Unknown guided-alignment-cost {cost_type}")
    # only the target positions with at least one alignment point count
    has_pt = (torch.sum(g, dim=-1) > 0).float() * trg_mask.float()
    n = torch.clamp(torch.sum(has_pt), min=1.0)
    return torch.sum(per_tok * has_pt) / n
