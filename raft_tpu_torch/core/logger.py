"""Logger — the port of ``raft_tpu/core/logger.py`` (copied, stdlib
only), the analog of the reference spdlog wrapper.

Reference: cpp/include/raft/core/logger.hpp:113-317 (singleton logger with
set_level/set_pattern/set_callback/flush and RAFT_LOG_* macros, plus a
callback sink so Python can capture C++ log lines). Here the host language is
Python, so we wrap :mod:`logging` with the same surface: named levels
(off/error/warn/info/debug/trace), a pattern string, and an optional callback
sink receiving formatted records.

The records go to the ``raft_tpu_torch.core.logger`` logger, which
propagates nowhere: its handler and level are its own, so this logger
and the JAX package's (``raft_tpu``) can both run in one process without
either one's settings reaching the other's.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

# level numbering mirrors the reference's RAFT_LEVEL_* (logger.hpp:36-42)
OFF = 0
CRITICAL = 1
ERROR = 2
WARN = 3
INFO = 4
DEBUG = 5
TRACE = 6

_TO_PY = {
    OFF: logging.CRITICAL + 10,
    CRITICAL: logging.CRITICAL,
    ERROR: logging.ERROR,
    WARN: logging.WARNING,
    INFO: logging.INFO,
    DEBUG: logging.DEBUG,
    TRACE: 5,
}

_FROM_PY = {py: raft for raft, py in _TO_PY.items()}


def _to_raft_level(levelno: int) -> int:
    """Map a Python levelno back to reference numbering for callbacks."""
    if levelno in _FROM_PY:
        return _FROM_PY[levelno]
    if levelno >= logging.CRITICAL:
        return CRITICAL
    if levelno >= logging.ERROR:
        return ERROR
    if levelno >= logging.WARNING:
        return WARN
    if levelno >= logging.INFO:
        return INFO
    if levelno >= logging.DEBUG:
        return DEBUG
    return TRACE

logging.addLevelName(5, "TRACE")

_logger = logging.getLogger(__name__)
_handler: Optional[logging.Handler] = None
_callback: Optional[Callable[[int, str], None]] = None
_flush_fn: Optional[Callable[[], None]] = None
_pattern = "[%(levelname)s] [%(asctime)s] %(message)s"
_level = INFO


class _CallbackHandler(logging.Handler):
    """Analog of the callback sink (common/detail/callback_sink.hpp)."""

    def emit(self, record: logging.LogRecord) -> None:
        msg = self.format(record)
        if _callback is not None:
            # callbacks receive reference-numbered levels (logger.hpp:36-42:
            # higher = more verbose), not Python levelnos
            _callback(_to_raft_level(record.levelno), msg)
        else:
            sys.stderr.write(msg + "\n")

    def flush(self) -> None:
        if _flush_fn is not None:
            _flush_fn()


def _ensure_handler() -> None:
    global _handler
    if _handler is None:
        _handler = _CallbackHandler()
        _handler.setFormatter(logging.Formatter(_pattern, datefmt="%H:%M:%S"))
        _logger.addHandler(_handler)
        _logger.propagate = False
        set_level(_level)


def set_level(level: int) -> None:
    """Set verbosity using reference level numbering (0=off .. 6=trace)."""
    global _level
    _level = level
    _ensure_handler()
    _logger.setLevel(_TO_PY.get(level, logging.INFO))


def get_level() -> int:
    return _level


def should_log_for(level: int) -> bool:
    return level <= _level and _level != OFF


def set_pattern(pattern: str) -> None:
    """Set the format pattern (printf-ish in the reference; %-style here)."""
    global _pattern
    _pattern = pattern
    _ensure_handler()
    assert _handler is not None
    _handler.setFormatter(logging.Formatter(pattern, datefmt="%H:%M:%S"))


def set_callback(cb: Optional[Callable[[int, str], None]]) -> None:
    """Redirect formatted log lines to ``cb(level, message)``."""
    global _callback
    _callback = cb
    _ensure_handler()


def set_flush(fn: Optional[Callable[[], None]]) -> None:
    global _flush_fn
    _flush_fn = fn


def flush() -> None:
    _ensure_handler()
    assert _handler is not None
    _handler.flush()


def _log(level: int, msg: str, *args) -> None:
    _ensure_handler()
    if should_log_for(level):
        _logger.log(_TO_PY[level], msg % args if args else msg)


def trace(msg: str, *args) -> None:
    _log(TRACE, msg, *args)


def debug(msg: str, *args) -> None:
    _log(DEBUG, msg, *args)


def info(msg: str, *args) -> None:
    _log(INFO, msg, *args)


def warn(msg: str, *args) -> None:
    _log(WARN, msg, *args)


def error(msg: str, *args) -> None:
    _log(ERROR, msg, *args)


def critical(msg: str, *args) -> None:
    _log(CRITICAL, msg, *args)
