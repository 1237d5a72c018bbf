"""Scheduler: update/epoch/label counting, Marian-format progress lines
and the save and stop triggers, trimmed from
``marian_tpu/training/scheduler.py`` (reference
src/training/scheduler.h :: Scheduler::update). The progress line keeps
Marian's greppable format:

Ep. 1 : Up. 1000 : Sen. 12,345 : Cost 4.52 : Time 12.3s : 45000.0 words/s

Trimmed: validation, --lr-decay strategies, early stopping, TensorBoard
and divergence handling (the trainer refuses their flags).
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ..common import logging as log
from ..common.scheduling_parameter import SchedulingParameter, SchedulingUnit
from .training_state import TrainingState


class Scheduler:
    def __init__(self, options, state: TrainingState):
        self.options = options
        self.state = state
        self.disp_freq = SchedulingParameter.parse(
            str(options.get("disp-freq", "1000u")))
        self.disp_first = int(options.get("disp-first", 0))
        self.save_freq = SchedulingParameter.parse(
            str(options.get("save-freq", "10000u")))
        self.after = SchedulingParameter.parse(str(options.get("after", "0e")))
        self.after_epochs = int(options.get("after-epochs", 0) or 0)
        self.after_batches = int(options.get("after-batches", 0) or 0)
        self.lr_report = bool(options.get("lr-report", False))
        self.disp_label_counts = bool(options.get("disp-label-counts", False))
        self.cost_type = options.get("cost-type", "ce-sum")
        self._reset_window()

    def _reset_window(self) -> None:
        self._cost_sum = 0.0
        self._label_sum = 0.0
        self._words_sum = 0.0
        self._sent_sum = 0
        self._disp_count = 0
        self._timer = time.perf_counter()

    # -- continuation conditions (reference: keepGoing) ----------------------
    def keep_going(self) -> bool:
        s = self.state
        if self.after_epochs and s.epochs >= self.after_epochs:
            return False
        if self.after_batches and s.batches >= self.after_batches:
            return False
        if self.after:
            if self.after.unit == SchedulingUnit.EPOCHS \
                    and s.epochs >= self.after.n:
                return False
            if self.after.unit == SchedulingUnit.UPDATES \
                    and s.batches >= self.after.n:
                return False
            if self.after.unit == SchedulingUnit.TRG_LABELS \
                    and s.labels_total >= self.after.n:
                return False
        return True

    # -- per-update bookkeeping (reference: Scheduler::update) ---------------
    def update(self, loss_sum, labels: float, sentences: int,
               src_words: float = 0.0, lr: Optional[float] = None) -> None:
        """``loss_sum`` may be a device scalar: it is only accumulated
        here and read at the display boundary, so the loop does not wait
        for the device every update."""
        s = self.state
        s.batches += 1
        s.batches_epoch += 1
        s.samples_epoch += sentences
        s.labels_total += int(labels)
        if lr is not None:
            s.eta = float(lr)
        self._cost_sum = self._cost_sum + loss_sum
        self._label_sum += labels
        self._words_sum += (src_words or labels)
        self._sent_sum += sentences
        self._disp_count += 1
        show = (self.disp_first and s.batches <= self.disp_first) \
            or self._hit(self.disp_freq)
        if show and self._disp_count:
            self._display()

    def _hit(self, freq: SchedulingParameter) -> bool:
        if not freq:
            return False
        s = self.state
        if freq.unit == SchedulingUnit.UPDATES:
            return s.batches % freq.n == 0
        if freq.unit == SchedulingUnit.TRG_LABELS:
            return (s.labels_total // freq.n) > (
                (s.labels_total - self._label_sum) // freq.n)
        return False  # epoch-based: new_epoch

    def _display(self) -> None:
        s = self.state
        cost_sum = float(self._cost_sum)       # the one deferred device read
        dt = max(time.perf_counter() - self._timer, 1e-9)
        if self.cost_type in ("ce-mean-words", "ce-sum"):
            cost = cost_sum / max(self._label_sum, 1.0)
        elif self.cost_type == "perplexity":
            cost = math.exp(min(cost_sum / max(self._label_sum, 1.0), 700))
        else:
            cost = cost_sum / max(self._sent_sum, 1)
        wps = self._words_sum / dt
        cost_part = f"Cost {cost:.8f}"
        if self.disp_label_counts:
            cost_part += (f" * {int(self._label_sum):,} labels"
                          f" after {s.labels_total:,}")
        line = (f"Ep. {s.epochs + 1} : Up. {s.batches} : Sen. "
                f"{s.samples_epoch:,} : {cost_part} : Time {dt:.2f}s : "
                f"{wps:.2f} words/s")
        if self.lr_report:
            line += f" : L.r. {s.eta:.4e}"
        log.info("{}", line)
        self._reset_window()

    # -- triggers ------------------------------------------------------------
    def should_save(self) -> bool:
        return bool(self.save_freq) and self._hit(self.save_freq)

    def new_epoch(self) -> None:
        seen = self.state.samples_epoch
        self.state.new_epoch()
        log.info("Seen {} samples in epoch {}", seen, self.state.epochs)
