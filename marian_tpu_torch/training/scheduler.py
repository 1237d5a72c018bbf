"""Scheduler: update/epoch/label counting, Marian-format progress lines,
the save, validation and stop triggers, the per-metric validation
bookkeeping behind early stopping and the --lr-decay strategies, trimmed
from ``marian_tpu/training/scheduler.py`` (reference
src/training/scheduler.h :: Scheduler::update/validate). The progress
line keeps Marian's greppable format:

Ep. 1 : Up. 1000 : Sen. 12,345 : Cost 4.52 : Time 12.3s : 45000.0 words/s

The trainer emits into the process-wide metrics registry the server
scrapes, under the reference's names: ``marian_train_cost``,
``marian_train_words_per_second``, ``marian_train_learn_rate``,
``marian_train_updates_total``, ``marian_train_labels_total`` and
``marian_train_updates_skipped_total`` (updates --check-gradient-nan
skipped, read at the display boundary's sync), and each display window
feeds ``obs.PERF.record_train_window``. ``--tensorboard DIR`` writes
the display's scalars through ``torch.utils.tensorboard``.

Trimmed: logical epochs and the divergence policies (--on-divergence,
--divergence-skip-window).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

from .. import obs
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
        self.valid_freq = SchedulingParameter.parse(
            str(options.get("valid-freq", "10000u")))
        self.after = SchedulingParameter.parse(str(options.get("after", "0e")))
        self.after_epochs = int(options.get("after-epochs", 0) or 0)
        self.after_batches = int(options.get("after-batches", 0) or 0)
        self.early_stopping = int(options.get("early-stopping", 10) or 0)
        # per-metric improvement margins (--early-stopping-epsilon)
        eps = options.get("early-stopping-epsilon", [0.0]) or [0.0]
        self.early_stopping_eps = [float(e) for e in (
            eps if isinstance(eps, list) else [eps])]
        self.lr_report = bool(options.get("lr-report", False))
        self.disp_label_counts = bool(options.get("disp-label-counts", False))
        self.cost_type = options.get("cost-type", "ce-sum")
        self._reset_window()
        # the trainer's series in the registry the server scrapes too;
        # get-or-create, so a second Scheduler in one process is safe
        from ..serving import metrics as msm
        self._m_cost = msm.gauge(
            "marian_train_cost", "Displayed training cost (per cost-type)")
        self._m_wps = msm.gauge(
            "marian_train_words_per_second",
            "Training throughput over the last display window")
        self._m_lr = msm.gauge(
            "marian_train_learn_rate", "Current learning rate")
        self._m_updates = msm.counter(
            "marian_train_updates_total", "Optimizer updates applied")
        self._m_labels = msm.counter(
            "marian_train_labels_total", "Target labels consumed")
        self._m_skipped = msm.counter(
            "marian_train_updates_skipped_total",
            "Updates skipped by --check-gradient-nan (params and optimizer "
            "state reverted; non-finite gradient)")
        # (update number, device 0/1 flag) of --check-gradient-nan, read
        # at the display boundary, never with a sync of its own
        self._pending_skips: List = []
        self._skip_warned = False
        # --tensorboard DIR: the display's scalars through torch's
        # SummaryWriter; an unavailable writer degrades to a warning
        self._tb = None
        tb_dir = options.get("tensorboard", None)
        if tb_dir is not None:
            if not tb_dir:
                # a bare --tensorboard is on (as --profile): beside the model
                tb_dir = str(options.get("model", "model.npz")) + ".tb"
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=str(tb_dir))
            except Exception as e:  # noqa: BLE001 — optional extra
                log.warn("--tensorboard unavailable ({}); scalars "
                         "disabled", e)

    def _tb_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            try:
                self._tb.add_scalar(tag, value, step)
            except Exception:  # noqa: BLE001 — never kill training for TB
                pass

    def close(self) -> None:
        """Resolve the last skip flags, then flush and close the
        TensorBoard writer (its event thread buffers scalars, which
        would be lost at exit)."""
        self.drain_skips()
        if self._tb is not None:
            try:
                self._tb.close()
            except Exception:  # noqa: BLE001
                pass
            self._tb = None

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
        if self.early_stopping and s.stalled >= self.early_stopping:
            log.info("Early stopping after {} stalled validations",
                     s.stalled)
            return False
        return True

    # -- per-update bookkeeping (reference: Scheduler::update) ---------------
    def update(self, loss_sum, labels: float, sentences: int,
               src_words: float = 0.0, lr: Optional[float] = None,
               skipped=None) -> None:
        """``loss_sum`` may be a device scalar: it is only accumulated
        here and read at the display boundary, so the loop does not wait
        for the device every update. ``skipped`` is the update's 0/1
        --check-gradient-nan flag (None with the guard off), queued and
        read at that boundary too."""
        s = self.state
        s.batches += 1
        s.batches_epoch += 1
        s.samples_epoch += sentences
        s.labels_total += int(labels)
        self._m_updates.inc()
        self._m_labels.inc(int(labels))
        if lr is not None:
            s.eta = float(lr)
        if skipped is not None:
            self._pending_skips.append((s.batches, skipped))
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

    def drain_skips(self) -> None:
        """Read the queued --check-gradient-nan flags into
        ``marian_train_updates_skipped_total``; the first skip also
        logs a warning."""
        pending, self._pending_skips = self._pending_skips, []
        for batch, flag in pending:
            if float(flag) <= 0.5:
                continue
            self._m_skipped.inc()
            if not self._skip_warned:
                self._skip_warned = True
                log.warn("Update {} skipped: non-finite gradient "
                         "(--check-gradient-nan kept params and optimizer "
                         "state; counted in "
                         "marian_train_updates_skipped_total)", batch)

    def _display(self) -> None:
        s = self.state
        cost_sum = float(self._cost_sum)       # the one deferred device read
        # the clock is read AFTER that read: it waited for every update
        # of the window, so words/s and the perf window divide by the
        # time the card really took, not by the time to queue the work
        dt = max(time.perf_counter() - self._timer, 1e-9)
        self.drain_skips()                     # the read above fenced them
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
        self._tb_scalar("train/cost", cost, s.batches)
        self._tb_scalar("train/words_per_sec", wps, s.batches)
        self._tb_scalar("train/learn_rate", s.eta, s.batches)
        self._tb_scalar("train/epoch", s.epochs + 1, s.batches)
        self._m_cost.set(cost)
        self._m_wps.set(wps)
        self._m_lr.set(s.eta)
        obs.PERF.record_train_window(labels=self._label_sum,
                                     src_words=self._words_sum,
                                     sentences=self._sent_sum, dt=dt)
        self._reset_window()

    # -- triggers ------------------------------------------------------------
    def should_save(self) -> bool:
        return bool(self.save_freq) and self._hit(self.save_freq)

    def should_validate(self) -> bool:
        return bool(self.valid_freq) and self._hit(self.valid_freq)

    def new_epoch(self) -> None:
        seen = self.state.samples_epoch
        self.state.new_epoch()
        log.info("Seen {} samples in epoch {}", seen, self.state.epochs)

    # -- validation bookkeeping (reference: Scheduler::validate) -------------
    def register_validation(self, metric: str, value: float,
                            lower_is_better: bool = True) -> bool:
        """Track best/stalled per metric; returns True if improved."""
        s = self.state
        rec = s.validators.setdefault(metric,
                                      {"last-best": None, "stalled": 0})
        best = rec["last-best"]
        metrics_order = (self.options.get("valid-metrics", ["cross-entropy"])
                         or ["cross-entropy"])
        idx = metrics_order.index(metric) if metric in metrics_order else 0
        eps = self.early_stopping_eps[min(idx,
                                          len(self.early_stopping_eps) - 1)]
        improved = (best is None or
                    (value < best - eps if lower_is_better
                     else value > best + eps))
        if improved:
            rec["last-best"] = float(value)
            rec["stalled"] = 0
        else:
            rec["stalled"] += 1
        # --early-stopping-on: which metrics drive the global stall count:
        # first (default) = the first valid-metric only; any = the most
        # stalled metric; all = the least stalled one
        mode = str(self.options.get("early-stopping-on", "first") or "first")
        stalls = [r["stalled"] for r in s.validators.values()] or [0]
        if mode == "any":
            s.stalled = max(stalls)
        elif mode == "all":
            s.stalled = min(stalls)
        elif metric == metrics_order[0]:
            s.stalled = rec["stalled"]
        s.max_stalled = max(s.max_stalled, s.stalled)
        return improved

    def reset_stalled(self, reset_best: bool = False) -> None:
        """--valid-reset-stalled / --valid-reset-all on resume: clear the
        stall counters (and with ``reset_best`` the recorded bests), so a
        continued run is not early-stopped by earlier validations."""
        s = self.state
        s.stalled = 0
        s.max_stalled = 0
        for rec in s.validators.values():
            rec["stalled"] = 0
            if reset_best:
                rec["last-best"] = None

    # -- LR decay (reference: Scheduler::updateLearningRate strategies) ------
    def maybe_decay_lr(self, schedule, graph_group=None) -> None:
        """After a validation: multiply the schedule's decay factor by
        --lr-decay when --lr-decay-strategy says so, optionally restart
        the warmup there and reset the optimizer state."""
        decay = float(self.options.get("lr-decay", 0.0) or 0.0)
        if decay <= 0:
            return
        strategy = self.options.get("lr-decay-strategy", "epoch+stalled")
        start = self.options.get("lr-decay-start", [10, 1])
        s = self.state
        fire = False
        if "epoch" in strategy and s.epochs + 1 >= int(start[0]):
            if "stalled" in strategy:
                fire = s.stalled >= int(start[1] if len(start) > 1 else 1)
            elif "batches" in strategy:
                freq = int(self.options.get("lr-decay-freq", 50000))
                fire = s.batches > 0 and s.batches % freq == 0
            else:
                fire = True
        elif strategy == "batches":
            freq = int(self.options.get("lr-decay-freq", 50000))
            fire = s.batches > 0 and s.batches % freq == 0
        elif strategy == "stalled":
            fire = s.stalled >= int(start[0])
        if fire:
            s.factor *= decay
            schedule.decay_factor = s.factor
            log.info("Decaying learning rate to factor {}", s.factor)
            if self.options.get("lr-decay-repeat-warmup", False):
                schedule.warmup_offset = s.batches
                log.info("Restarting learning-rate warmup at update {}",
                         s.batches)
            if graph_group is not None \
                    and self.options.get("lr-decay-reset-optimizer", False):
                graph_group.reset_optimizer()
                log.info("Optimizer state reset after learning-rate decay")
