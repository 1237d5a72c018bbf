"""Logging with Marian's look-and-feel, trimmed to the decoder: one
``general`` logger on stderr (plus an optional ``--log`` file), pattern
"[%Y-%m-%d %T] %v". stdout stays clean for translations.

Copied from ``marian_tpu/common/logging.py`` without the validation
logger; the logger lives under its own name so both packages can log in
one process.
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
_initialized = False


def create_loggers(options=None) -> None:
    """Set up the general logger from Options (or defaults)."""
    global _initialized
    quiet = bool(options and options.get("quiet", False))
    if options and options.get("quiet-translation", False):
        quiet = True
    level = _LEVELS.get(options.get("log-level", "info") if options
                        else "info", logging.INFO)
    log_file: Optional[str] = options.get("log", None) if options else None
    fmt = logging.Formatter(fmt="[%(asctime)s] %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    lg = logging.getLogger(_NAME)
    lg.setLevel(level)
    lg.propagate = False
    for h in list(lg.handlers):
        lg.removeHandler(h)
        h.close()
    if not quiet:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        lg.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    if quiet and not log_file:
        lg.addHandler(logging.NullHandler())
    _initialized = True


def log(level: str, msg: str, *args) -> None:
    """LOG(info, "...") equivalent; {} placeholders like spdlog."""
    if not _initialized:
        create_loggers(None)
    if args:
        msg = msg.format(*args)
    logging.getLogger(_NAME).log(_LEVELS.get(level, logging.INFO), msg)


def info(msg: str, *args) -> None:
    log("info", msg, *args)


def warn(msg: str, *args) -> None:
    log("warn", msg, *args)


def error(msg: str, *args) -> None:
    log("error", msg, *args)
