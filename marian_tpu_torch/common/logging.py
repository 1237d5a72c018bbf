"""Logging with Marian's look-and-feel, copied from
``marian_tpu/common/logging.py``: two named loggers, ``general``
(stderr plus an optional ``--log`` file) and ``valid`` (validation
messages, prefixed ``[valid] ``, on stderr plus an optional
``--valid-log`` file), pattern "[%Y-%m-%d %T] %v". stdout stays clean
for translations. The loggers live under their own names so both
packages can log in one process.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

_NAME = "marian_tpu_torch.general"
_VALID = "marian_tpu_torch.valid"
_initialized = False


def create_loggers(options=None) -> None:
    """Set up the general and valid loggers from Options (or defaults)."""
    global _initialized
    quiet = bool(options and options.get("quiet", False))
    if options and options.get("quiet-translation", False):
        quiet = True
    level = _LEVELS.get(options.get("log-level", "info") if options
                        else "info", logging.INFO)
    log_file: Optional[str] = options.get("log", None) if options else None
    valid_file: Optional[str] = (options.get("valid-log", None) if options
                                 else None)
    for name, prefix, path in ((_NAME, "", log_file),
                               (_VALID, "[valid] ", valid_file)):
        fmt = logging.Formatter(fmt="[%(asctime)s] " + prefix
                                + "%(message)s",
                                datefmt="%Y-%m-%d %H:%M:%S")
        lg = logging.getLogger(name)
        lg.setLevel(level)
        lg.propagate = False
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()
        if not quiet:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(fmt)
            lg.addHandler(h)
        if path:
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            lg.addHandler(fh)
        if quiet and not path:
            lg.addHandler(logging.NullHandler())
    _initialized = True


def log(level: str, msg: str, *args) -> None:
    """LOG(info, "...") equivalent; {} placeholders like spdlog."""
    if not _initialized:
        create_loggers(None)
    if args:
        msg = msg.format(*args)
    logging.getLogger(_NAME).log(_LEVELS.get(level, logging.INFO), msg)


def log_valid(level: str, msg: str, *args) -> None:
    """LOG_VALID(info, "...") equivalent: the valid logger."""
    if not _initialized:
        create_loggers(None)
    if args:
        msg = msg.format(*args)
    logging.getLogger(_VALID).log(_LEVELS.get(level, logging.INFO), msg)


def info(msg: str, *args) -> None:
    log("info", msg, *args)


def warn(msg: str, *args) -> None:
    log("warn", msg, *args)


def error(msg: str, *args) -> None:
    log("error", msg, *args)
