"""The training loop's profiling on the span API, ported from
``marian_tpu/obs/profiling.py``: ``StepTimer`` (host phase accounting
that emits spans) and ``TraceWindow`` (a ``torch.profiler`` window over
a few updates, stamped on the timeline).

StepTimer's device-sync honesty
-------------------------------

CUDA launches are asynchronous: ``gg.update(...)`` returns once its
kernels are queued on the stream, and the host waits only when
something later reads a device value (the display window's one read of
the summed cost, a checkpoint copy). Phase boundaries stamped with bare
``perf_counter`` reads would then bill the dispatch phase with the
launch cost and hand the device seconds it caused to whichever later
phase happened to wait first: shares that look precise and are wrong.

The fix is placement: given a ``sync_fn`` (``marian-train
--trace-sync-phases`` passes ``torch.cuda.synchronize`` on the trainer's
device), ``phase()`` drains the device BEFORE it takes the boundary
timestamp, so each phase absorbs the device work it issued. That
serializes host and card: a diagnosis mode, off by default, and its
cost to throughput is why it is a flag. On the CPU there is nothing
asynchronous to drain and ``sync_fn`` is None.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

from ..common import logging as log
from .trace import TRACER


class StepTimer:
    """Host phase timer: where does wall-clock go between device steps?
    ``phase(name)`` closes the previous phase and opens ``name``;
    ``report()`` logs a one-line summary and mirrors the totals into the
    metrics registry. With the tracer on, every closed phase is also a
    ``train.<phase>`` span, so /tracez shows the training loop on the
    timeline serving uses."""

    def __init__(self, enabled: bool = True,
                 sync_fn: Optional[Callable[[], None]] = None,
                 span_prefix: str = "train"):
        self.enabled = enabled
        # called BEFORE each boundary timestamp (module docstring)
        self.sync_fn = sync_fn
        self.span_prefix = span_prefix
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t: Optional[float] = None
        self._phase: Optional[str] = None

    def phase(self, name: str) -> None:
        if not self.enabled:
            return
        if self.sync_fn is not None:
            # drain queued device work into the CLOSING phase
            self.sync_fn()
        now = time.perf_counter()
        if self._phase is not None and self._t is not None:
            self.spans[self._phase] = self.spans.get(self._phase, 0.0) \
                + (now - self._t)
            self.counts[self._phase] = self.counts.get(self._phase, 0) + 1
            if TRACER.enabled and self._phase != "__end__":
                TRACER.record(f"{self.span_prefix}.{self._phase}",
                              self._t, now)
        self._phase, self._t = name, now

    def stop(self) -> None:
        self.phase("__end__")
        self._phase = None

    def report(self) -> Dict[str, float]:
        out = {k: v for k, v in sorted(self.spans.items(),
                                       key=lambda kv: -kv[1])
               if k != "__end__"}
        total = sum(out.values())
        if self.enabled and total > 0:
            line = " ".join(f"{k}={v:.2f}s({100*v/total:.0f}%)"
                            for k, v in out.items())
            log.info("Step phases: {}", line)
            # mirrored into the process-wide registry: with
            # --metrics-port a scrape sees where the loop's wall-clock
            # goes (data vs dispatch vs host)
            try:
                from ..serving import metrics as msm
                g = msm.gauge("marian_step_phase_seconds",
                              "Host wall-clock per train-loop phase since "
                              "the last report", labels=("phase",))
                for k, v in out.items():
                    g.labels(k).set(v)
            except Exception:  # noqa: BLE001 — observability is optional
                pass
        return out


class TraceWindow:
    """A ``torch.profiler`` trace over updates [start, start + n): CPU
    and CUDA activity on the card, CPU activity on the CPU, written as a
    Chrome trace into the ``--profile`` directory. The device complement
    of the span tracer: spans say where host wall-clock went, the
    profiler trace what the card ran. The window's ends are stamped on
    the span timeline (``profile.window_start``/``_stop``) so the two
    exports line up."""

    def __init__(self, options, device=None):
        prof = options.get("profile", None)
        self.dir: Optional[str] = None
        # a bare `--profile` parses to "": still on
        if prof is not None and prof is not False:
            self.dir = prof if (isinstance(prof, str) and prof) \
                else "profile"
        self.start_update = int(options.get("profile-start", 10) or 10)
        self.n_updates = int(options.get("profile-updates", 5) or 5)
        self.device = device
        self.path: Optional[str] = None
        self._prof = None
        self._done = False
        self._started_at = 0

    def tick(self, update: int) -> None:
        """Call once per update with the 1-based number of the update
        about to run."""
        if self.dir is None or self._done:
            return
        if self._prof is None and update >= self.start_update:
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU]
            if getattr(self.device, "type", "cpu") == "cuda":
                acts.append(tp.ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            self._prof = tp.profile(activities=acts)
            self._prof.__enter__()
            self._started_at = update
            TRACER.event("profile.window_start", update=update,
                         dir=self.dir)
            log.info("Profiler trace started at update {} → {}", update,
                     self.dir)
        elif self._prof is not None \
                and update >= self._started_at + self.n_updates:
            self._stop(update)
            log.info("Profiler trace stopped after update {} ({} updates)"
                     "; open {} in Perfetto", update - 1, self.n_updates,
                     self.path)

    def _stop(self, update: int) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        prof.__exit__(None, None, None)
        self.path = os.path.join(
            self.dir, f"trace-{os.getpid()}-updates-{self._started_at}-"
            f"{self._started_at + self.n_updates - 1}.json")
        prof.export_chrome_trace(self.path)
        TRACER.event("profile.window_stop", update=update)

    def close(self) -> None:
        if self._prof is not None:
            self._stop(-1)
