"""Loss assembly: cross-entropy with label smoothing and data weighting,
carried as Marian's "rational loss" (sum, label count), ported from
``marian_tpu/layers/loss.py``. ce-sum / ce-mean / ce-mean-words /
perplexity are different finalizations of the same pair (the gradient's
denominator, ``training/graph_group.py``, and the displayed cost,
``training/scheduler.py``).

Not ported yet: the unlikelihood objective and guided alignment; the
trainer refuses their flags.
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
    tokens."""
    if unlikelihood:
        raise NotImplementedError("--unlikelihood-loss is not ported to "
                                  "marian_tpu_torch yet (ROADMAP)")
    return weighted_loss(cross_entropy(logits, labels, label_smoothing),
                         mask, data_weights)
