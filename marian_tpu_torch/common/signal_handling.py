"""Graceful SIGTERM handling (reference: src/common/signal_handling.cpp ::
setSignalHandlers/getSignalFlag). The trainer checks ``signal_flag()`` after
every update: finish the step, save a full checkpoint, exit 0
(``--sigterm save-and-exit``), or leave without a save
(``--sigterm exit-immediately``).

A copy of ``marian_tpu/common/signal_handling.py``; the port imports
nothing of the JAX package."""

from __future__ import annotations

import signal
from typing import Optional

_flags = {}


def _handler(signum, frame):
    _flags[signum] = True


def set_signal_handlers() -> None:
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except ValueError:
            pass  # not on main thread — harness/test context


def signal_flag(signum: Optional[int] = None) -> bool:
    if signum is None:
        return bool(_flags)
    return _flags.get(signum, False)


def clear_signal_flags() -> None:
    _flags.clear()
