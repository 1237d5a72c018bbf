"""ModelRegistry — per-version lifecycle state for served models, a copy
of ``marian_tpu/serving/lifecycle/registry.py`` (the bookkeeping half
of the zero-downtime control plane, consumed by watcher, warmup and
controller).

Each served (or candidate) model is a ``ModelVersion`` keyed by its
bundle sequence number, moving through an explicit state machine:

    staged ──► warming ──► canary ──► live ──► retired ──► live
       │          │           │         │              (rollback)
       ▼          ▼           ▼         ▼
    rejected   failed      failed    failed
                  (canary ──► retired: superseded by a newer candidate)

- ``staged``   discovered/registered, nothing loaded yet
- ``rejected`` refused before loading weights (compat mismatch, invalid
               bundle, pinned registry) — terminal
- ``warming``  executor loading + golden decode on the card, off the
               serving path
- ``failed``   warmup error, canary rollback, or live regression
               rollback — terminal
- ``canary``   serving a --canary-fraction slice of batches
- ``live``     the version dispatch points at
- ``retired``  replaced by a newer live; the newest retired version is
               kept warm as the rollback target (``retired → live`` is
               the rollback edge)

Any other transition raises ``LifecycleError`` — state bugs must be loud,
not a silently mislabeled /lifecyclez. Bundle enumeration/validation goes
through training/bundle.py's manifest API (``scan_bundles``), the same
checksum walk restore uses, so serving never trusts a bundle the trainer
side would refuse to resume from.
"""


from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional

from ... import obs
from ...common import lockdep
from ...common import logging as log
from ...training import bundle as bdl

STAGED = "staged"
WARMING = "warming"
CANARY = "canary"
LIVE = "live"
RETIRED = "retired"
FAILED = "failed"
REJECTED = "rejected"

_ALLOWED: Dict[str, frozenset] = {
    STAGED: frozenset({WARMING, REJECTED}),
    WARMING: frozenset({CANARY, LIVE, FAILED}),
    CANARY: frozenset({LIVE, FAILED, RETIRED}),
    LIVE: frozenset({RETIRED, FAILED}),
    RETIRED: frozenset({LIVE}),
    FAILED: frozenset(),
    REJECTED: frozenset(),
}


class LifecycleError(RuntimeError):
    """An illegal state transition or a lookup of an unknown version."""


class BundleInfo(NamedTuple):
    seq: int
    bundle_dir: str
    ok: bool
    why: str
    manifest: Optional[Dict]


def scan_bundles(model_path: str) -> List[BundleInfo]:
    """Enumerate + validate every committed bundle under
    ``<model>.bundles/``, oldest first — training/bundle.py's manifest
    API is the single source of truth for 'is this bundle loadable'."""
    root = bdl.bundle_root(model_path)
    out: List[BundleInfo] = []
    for name in bdl.list_bundles(root):
        bdir = os.path.join(root, name)
        ok, why, manifest = bdl.validate_bundle(bdir)
        seq = int(manifest["seq"]) if ok and "seq" in manifest \
            else int(name.split("-")[-1])
        out.append(BundleInfo(seq, bdir, ok, why, manifest))
    return out


class ModelVersion:
    """One model version's lifecycle record. State is owned by the
    registry (read/written under the registry lock); the executor slot
    holds the warmed ``translate_lines`` callable once warming succeeds."""

    __slots__ = ("seq", "name", "bundle_dir", "manifest", "compat",
                 "state", "error", "executor")

    def __init__(self, seq: int, name: str, bundle_dir: str = "",
                 manifest: Optional[Dict] = None,
                 compat: Optional[Dict] = None):
        self.seq = seq
        self.name = name
        self.bundle_dir = bundle_dir
        self.manifest = manifest
        self.compat = compat if compat is not None \
            else bdl.manifest_compat(manifest)
        self.state = STAGED
        self.error = ""
        self.executor: Optional[Callable[[List[str]], List[str]]] = None

    def snapshot(self) -> Dict:
        return {
            "version": self.name,
            "seq": self.seq,
            "state": self.state,
            "compat_hash": bdl.compat_hash(self.compat),
            "bundle_dir": self.bundle_dir,
            "error": self.error,
        }


class ModelRegistry:
    """Thread-safe version table + state machine. The controller, the
    watcher thread, the metrics scrape thread (/lifecyclez) and the admin
    HTTP thread all read it; only controller code transitions it."""

    def __init__(self):
        self._lock = lockdep.make_lock("ModelRegistry._lock")
        self._versions: Dict[int, ModelVersion] = {}   # guarded-by: _lock

    def register(self, seq: int, name: str, bundle_dir: str = "",
                 manifest: Optional[Dict] = None,
                 compat: Optional[Dict] = None) -> ModelVersion:
        """Add a new version in ``staged``; re-registering a seq that was
        already decided (any non-terminal state or live/retired) is a
        LifecycleError — one bundle, one lifecycle record."""
        with self._lock:
            existing = self._versions.get(seq)
            if existing is not None \
                    and existing.state not in (FAILED, REJECTED):
                raise LifecycleError(
                    f"version seq {seq} already registered "
                    f"(state {existing.state})")
            v = ModelVersion(seq, name, bundle_dir, manifest, compat)
            self._versions[seq] = v
            return v

    def get(self, seq: int) -> ModelVersion:
        with self._lock:
            v = self._versions.get(seq)
            if v is None:
                raise LifecycleError(f"unknown model version seq {seq}")
            return v

    def transition(self, seq: int, new_state: str,
                   error: str = "") -> ModelVersion:
        """Move one version to ``new_state``; raises LifecycleError on an
        edge the state machine does not allow."""
        if new_state not in _ALLOWED:
            raise LifecycleError(f"unknown lifecycle state {new_state!r}")
        with self._lock:
            v = self._versions.get(seq)
            if v is None:
                raise LifecycleError(f"unknown model version seq {seq}")
            if new_state not in _ALLOWED[v.state]:
                raise LifecycleError(
                    f"illegal transition {v.state} -> {new_state} "
                    f"for version {v.name} (seq {seq})")
            log.info("model lifecycle: {} (seq {}) {} -> {}{}",
                     v.name, seq, v.state, new_state,
                     f" ({error})" if error else "")
            old_state = v.state
            v.state = new_state
            if error:
                v.error = error
        # the state-machine edge on the timeline, so a flight dump shows
        # the lifecycle history leading up to its trip (callers may hold
        # the controller's lock here: the tracer's lock nests inside it)
        obs.event("lifecycle.transition", version=v.name, seq=seq,
                  frm=old_state, to=new_state, reason=error)
        return v

    def in_state(self, *states: str) -> List[ModelVersion]:
        with self._lock:
            return [v for v in self._versions.values() if v.state in states]

    def newest_seq(self) -> int:
        with self._lock:
            return max(self._versions, default=0)

    def snapshot(self) -> List[Dict]:
        """Per-version state rows for /lifecyclez, newest first."""
        with self._lock:
            versions = sorted(self._versions.values(),
                              key=lambda v: v.seq, reverse=True)
            return [v.snapshot() for v in versions]
