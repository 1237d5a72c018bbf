"""Learning-rate schedule with Marian's warmup + inverse-sqrt decay
(reference: src/training/scheduler.h :: Scheduler::getScheduledLRate),
ported from ``marian_tpu/optimizers/schedule.py``:

base * min(step/warmup, 1) * sqrt(inv_sqrt / max(step, inv_sqrt))

times the --lr-decay factor the training Scheduler sets, with the
warmup counted from ``warmup_offset`` (--lr-warmup-at-reload,
--lr-decay-repeat-warmup), computed on the host: PyTorch runs eagerly,
so the rate is a plain float handed to the optimizer each update.
"""

from __future__ import annotations

import dataclasses
import math

from ..common.scheduling_parameter import SchedulingParameter, SchedulingUnit


@dataclasses.dataclass
class LRSchedule:
    base_lr: float
    warmup: int = 0                  # in updates
    inv_sqrt: int = 0                # warmup constant for inv-sqrt decay
    warmup_start_rate: float = 0.0
    decay_factor: float = 1.0        # multiplicative, set by Scheduler
    warmup_cycle: bool = False       # --lr-warmup-cycle: sawtooth warmup
    warmup_offset: int = 0           # warmup restarts here (--lr-warmup-at-
                                     # reload / --lr-decay-repeat-warmup)

    @classmethod
    def from_options(cls, options) -> "LRSchedule":
        warmup = SchedulingParameter.parse(str(options.get("lr-warmup", "0")))
        inv_raw = options.get("lr-decay-inv-sqrt", ["0"])
        if not isinstance(inv_raw, list):
            inv_raw = [inv_raw]
        inv = SchedulingParameter.parse(str(inv_raw[0]))
        for name, p in (("lr-warmup", warmup), ("lr-decay-inv-sqrt", inv)):
            if p and p.unit != SchedulingUnit.UPDATES:
                raise NotImplementedError(
                    f"--{name} {p}: only update-counted schedules are "
                    f"ported to marian_tpu_torch yet")
        return cls(base_lr=float(options.get("learn-rate", 1e-4)),
                   warmup=warmup.n, inv_sqrt=inv.n,
                   warmup_start_rate=float(
                       options.get("lr-warmup-start-rate", 0.0)),
                   warmup_cycle=bool(options.get("lr-warmup-cycle", False)))

    def __call__(self, step) -> float:
        """step: 1-based update count."""
        step = max(float(step), 1.0)
        lr = self.base_lr
        if self.warmup > 0:
            wstep = max(step - float(self.warmup_offset), 1.0)
            if self.warmup_cycle:
                wstep = math.fmod(wstep - 1.0, float(self.warmup)) + 1.0
            frac = min(wstep / float(self.warmup), 1.0)
            start = self.warmup_start_rate
            lr = start + (lr - start) * frac if start > 0 else lr * frac
        if self.inv_sqrt > 0:
            lr = lr * math.sqrt(float(self.inv_sqrt)
                                / max(step, float(self.inv_sqrt)))
        return lr * self.decay_factor
