"""Runtime ownership witness, ported from ``marian_tpu/common/ownwit.py``:
the lock witness's move (``common/lockdep.py``) applied to the lifetimes
of the KV pool's page references.

With ``MARIAN_OWNWIT=1`` in the environment (read when a ``KVPool`` is
made) every acquire, release and transfer of the pool records the call
site that drove it: the nearest stack frame inside ``marian_tpu_torch/``
outside the instrumented modules (this one and ``ops/kernels/kv_pool.py``),
named ``<path from the repo root>::<function>``. A frame outside the
package (a test driving a pool directly) records as ``<external>``. A
release or transfer of an owner records the pairing of its acquire
sites with this site.

Leaks are what it checks here: :func:`live_owners` and
:func:`check_balanced` report owners still holding references (the
``pool.release_drop`` drill suppresses one real release, and the drill
tests hold that the witness and the pool auditor both catch it). The
reference also holds the observed sites and pairings against a static
ownership graph built from the source (``check``,
``check_against_static``); the port has no such analysis yet (ROADMAP).

Without ``MARIAN_OWNWIT=1`` nothing is recorded and the pool pays one
attribute read a verb. Stdlib only; imports nothing of the layers it
watches.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
from typing import Dict, List, Set, Tuple

ENV_VAR = "MARIAN_OWNWIT"

EXTERNAL_SITE = "<external>"


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


_TOKENS = itertools.count(1)


def new_token() -> int:
    """A process-unique container identity for the live-owner table: a
    raw ``id(pool)`` can be reused after the pool is collected, and a
    stale live entry would then pair one pool's acquire site with
    another's release."""
    return next(_TOKENS)


# -- the observed model --------------------------------------------------------
# Guarded by _WITNESS_LOCK, a plain lock and deliberately not witnessed:
# it is instrumentation, taken beside KVPool._lock, not part of the
# lock order the witness models.

_WITNESS_LOCK = threading.Lock()
# cls -> {(acquire_site, release_site) -> thread name (first observer)}
_PAIRS: Dict[str, Dict[Tuple[str, str], str]] = {}
_ACQ_SITES: Dict[str, Set[str]] = {}
_REL_SITES: Dict[str, Set[str]] = {}
# (cls, container token, owner repr) -> the acquire sites still live
_LIVE: Dict[Tuple[str, int, str], Set[str]] = {}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
# frames in these files are instrumentation, not call sites
_SKIP = (os.path.abspath(__file__),
         os.path.join(_PKG, "ops", "kernels", "kv_pool.py"))


def _site() -> str:
    """The acting call site: the nearest frame outside the instrumented
    modules, as ``marian_tpu_torch/<rel>::<function>`` when it lies in
    the package, else EXTERNAL_SITE. One frame walk, no path
    arithmetic past the first frame that decides."""
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename
        if not os.path.isabs(fname):
            fname = os.path.abspath(fname)
        if fname not in _SKIP:
            if fname.startswith(_PKG + os.sep):
                rel = os.path.relpath(fname, _REPO).replace(os.sep, "/")
                return f"{rel}::{f.f_code.co_name}"
            return EXTERNAL_SITE
        f = f.f_back
    return EXTERNAL_SITE


def _key(cls: str, container, owner) -> Tuple[str, int, str]:
    tok = container if isinstance(container, int) else id(container)
    return (cls, tok, repr(owner))


def note_acquire(cls: str, container, owner) -> None:
    """A fresh or extended claim for ``owner`` (claim, claim_extra,
    share, or a retable that made or kept the owner)."""
    site = _site()
    with _WITNESS_LOCK:
        _ACQ_SITES.setdefault(cls, set()).add(site)
        _LIVE.setdefault(_key(cls, container, owner), set()).add(site)


def note_release(cls: str, container, owner) -> None:
    """The owner dropped every reference (release, retable to empty):
    records the (acquire site → release site) pairings."""
    site = _site()
    thread = threading.current_thread().name
    with _WITNESS_LOCK:
        _REL_SITES.setdefault(cls, set()).add(site)
        acq = _LIVE.pop(_key(cls, container, owner), None) or set()
        pairs = _PAIRS.setdefault(cls, {})
        for a in acq:
            pairs.setdefault((a, site), thread)


def note_transfer(cls: str, container, src_owner, dst_owner) -> None:
    """References changed hands (``KVPool.transfer``): the source's
    acquire sites pair with this site, and the destination is live as
    acquired here (the prefix cache's adoption)."""
    site = _site()
    thread = threading.current_thread().name
    with _WITNESS_LOCK:
        _REL_SITES.setdefault(cls, set()).add(site)
        _ACQ_SITES.setdefault(cls, set()).add(site)
        acq = _LIVE.pop(_key(cls, container, src_owner), None) or set()
        pairs = _PAIRS.setdefault(cls, {})
        for a in acq:
            pairs.setdefault((a, site), thread)
        _LIVE.setdefault(_key(cls, container, dst_owner), set()).add(site)


def drop_container(cls: str, container) -> None:
    """A whole pool is discarded (engine teardown): forget its live
    owners, whose lifetime ends with it."""
    cid = container if isinstance(container, int) else id(container)
    with _WITNESS_LOCK:
        for k in [k for k in _LIVE if k[0] == cls and k[1] == cid]:
            del _LIVE[k]


# -- inspection and verdict ----------------------------------------------------

def observed_pairs(cls: str) -> Dict[Tuple[str, str], str]:
    with _WITNESS_LOCK:
        return dict(_PAIRS.get(cls, {}))


def observed_sites(cls: str) -> Tuple[Set[str], Set[str]]:
    with _WITNESS_LOCK:
        return (set(_ACQ_SITES.get(cls, set())),
                set(_REL_SITES.get(cls, set())))


def live_owners(cls: str) -> List[Tuple[str, List[str]]]:
    """(owner repr, acquire sites) of every owner still holding
    references: a suppressed release leaves its owner here."""
    with _WITNESS_LOCK:
        return sorted((k[2], sorted(sites))
                      for k, sites in _LIVE.items() if k[0] == cls)


def check_balanced(cls: str) -> List[str]:
    """The owners still live, as violations: for the leak drill and for
    scopes that expect a drained pool (live owners mid-run are normal)."""
    return [f"{cls} owner {owner} acquired at "
            f"{', '.join(sites) or EXTERNAL_SITE} was never "
            f"released or transferred (leak)"
            for owner, sites in live_owners(cls)]


def reset() -> None:
    """Forget everything observed so far (tests)."""
    with _WITNESS_LOCK:
        _PAIRS.clear()
        _ACQ_SITES.clear()
        _REL_SITES.clear()
        _LIVE.clear()
