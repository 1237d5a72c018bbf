"""Zero-downtime model lifecycle, after ``marian_tpu/serving/lifecycle/``:
the deployment control plane between the trainer's committed checkpoint
bundles (training/bundle.py) and the serving scheduler
(serving/scheduler.py).

    train ──commit──► bundle ──watch──► warmup ──swap──► serve
                        ▲                (off-path)  │
                        └────────── rollback ◄───────┘

- ``registry``   — ModelRegistry: per-version state machine
  (staged → warming → canary → live → retired, + rejected/failed)
- ``watcher``    — BundleWatcher: seq+mtime polling thread, no inotify
- ``warmup``     — compat refusal, executor load, golden decode
- ``controller`` — SwapController: atomic between-batch re-pointing (the
  quiesce protocol in iteration mode), --canary-fraction routing,
  failure-rate/p99 auto-rollback, admin verbs

The reference's ``compile_cache`` (a persisted XLA compilation cache as
a bundle member) has no counterpart here.
"""

from .controller import SwapController
from .registry import (CANARY, FAILED, LIVE, REJECTED, RETIRED, STAGED,
                       WARMING, BundleInfo, LifecycleError, ModelRegistry,
                       ModelVersion, scan_bundles)
from .warmup import (DEFAULT_GOLDEN, CompatMismatch, WarmupError,
                     load_golden)
from .watcher import BundleWatcher

__all__ = [
    "SwapController", "BundleWatcher",
    "ModelRegistry", "ModelVersion", "BundleInfo", "LifecycleError",
    "scan_bundles",
    "STAGED", "WARMING", "CANARY", "LIVE", "RETIRED", "FAILED", "REJECTED",
    "CompatMismatch", "WarmupError", "DEFAULT_GOLDEN", "load_golden",
]
