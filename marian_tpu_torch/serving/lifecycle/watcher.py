"""BundleWatcher — discovers freshly committed checkpoint bundles and
feeds them to the lifecycle controller; a copy of
``marian_tpu/serving/lifecycle/watcher.py``.

A daemon thread polls the bundle root on an interval (``--model-watch``
seconds). No inotify dependency: the commit protocol's atomic
staging→bundle rename bumps the ROOT DIRECTORY's mtime, so a cheap
``os.stat`` guards the (slightly less cheap) listing + validation —
steady-state cost is one stat per interval. Sequence numbers, not
timestamps, decide novelty: a bundle is new iff its seq exceeds the last
seen one, so clock skew between the training and serving hosts (shared
filesystem deployments) cannot replay or skip versions.

Newest VALID wins: when several bundles landed between polls only the
newest valid one is delivered — warming is expensive and the
intermediate versions are already superseded (the skip is logged). A
committed-but-invalid bundle (disk damage after commit — bundles are
immutable, it will not heal) is skipped loudly and marked seen, but it
does not shadow a valid bundle committed just below it; the next HIGHER
seq is still picked up either way.

``notify()`` forces an immediate poll — wired through
``training/bundle.py :: add_commit_hook`` when trainer and server share a
process, for push latency with the same code path.
"""


from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from ...common import faultpoints as fp
from ...common import logging as log
from ...training import bundle as bdl


class BundleWatcher:
    """Polls ``root`` for newly committed bundles; calls
    ``on_bundle(bundle_dir, manifest)`` ON THE WATCHER THREAD for each
    newly discovered valid one (the controller's ingest — including
    warmup — runs there, off the serving event loop)."""

    def __init__(self, root: str,
                 on_bundle: Callable[[str, Dict], None],
                 interval: float = 2.0,
                 last_seq: int = 0):
        self.root = root
        self.on_bundle = on_bundle
        self.interval = max(0.01, float(interval))
        # poll state is watcher-thread-only once start()ed; tests drive
        # poll_now() single-threaded instead
        self._last_seq = int(last_seq)
        self._last_mtime_ns = -1
        self._stop = threading.Event()
        self._kick = threading.Event()
        # set by notify(): the next poll must do a full listing even if
        # the root mtime looks unchanged (the pushed commit may have
        # landed within the same filesystem-timestamp tick)
        self._force = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "BundleWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="bundle-watcher")
            self._thread.start()
            log.info("bundle watcher: polling {} every {}s (from seq {})",
                     self.root, self.interval, self._last_seq)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def notify(self) -> None:
        """Wake the poll loop now (in-process commit hook; tests)."""
        self._force.set()
        self._kick.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_now()
            except Exception as e:  # noqa: BLE001 — supervision: never die
                log.error("bundle watcher error (recovered): {}", e)
            self._kick.wait(self.interval)
            self._kick.clear()

    # -- one poll -----------------------------------------------------------
    def poll_now(self) -> Optional[str]:
        """One poll pass; returns the delivered bundle dir, or None."""
        try:
            st = os.stat(self.root)
        except OSError:
            return None            # no bundles committed yet
        forced = self._force.is_set()
        if forced:
            self._force.clear()
        # an unchanged mtime normally means no rename landed — but a
        # commit can land within the same filesystem-timestamp tick as
        # the recorded mtime (coarse granularity: NFS 1s, same clock
        # tick locally), which equality would skip FOREVER. So the
        # short-circuit is not trusted when notify() pushed, nor while
        # the recorded mtime is too recent for a tick to have elapsed.
        recent = (time.time_ns() - st.st_mtime_ns) < 2_000_000_000
        if st.st_mtime_ns == self._last_mtime_ns \
                and not forced and not recent:
            return None            # no rename landed since last poll
        # the mtime observed BEFORE listing is what gets recorded: a
        # commit racing the listdir is re-examined next poll instead of
        # silently skipped
        mtime_ns = st.st_mtime_ns
        names = bdl.list_bundles(self.root)
        fresh = [(int(n.split("-")[-1]), n) for n in names]
        fresh = sorted((x for x in fresh if x[0] > self._last_seq),
                       reverse=True)          # newest first
        if not fresh:
            self._last_mtime_ns = mtime_ns
            return None
        fp.fault_point("lifecycle.watch")
        # newest VALID wins: a damaged newest bundle (immutable — it
        # will not heal) is skipped loudly but must not shadow a valid
        # bundle committed just below it
        chosen = None
        for s, n in fresh:
            bdir = os.path.join(self.root, n)
            ok, why, manifest = bdl.validate_bundle(bdir)
            if ok:
                chosen = (s, n, bdir, manifest)
                break
            log.error("bundle watcher: new bundle {} failed validation "
                      "({}) — not ingesting", bdir, why)
        # poll state advances only past the validation, so a transient
        # failure above re-delivers next poll rather than losing the
        # bundle until the commit after it
        self._last_seq = fresh[0][0]
        self._last_mtime_ns = mtime_ns
        if chosen is None:
            return None
        seq, newest, bdir, manifest = chosen
        skipped = sum(1 for s, _ in fresh if s < seq)
        if skipped > 0:
            log.info("bundle watcher: {} intermediate bundle(s) "
                     "superseded by {}", skipped, newest)
        self.on_bundle(bdir, manifest)
        return bdir
