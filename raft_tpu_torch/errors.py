"""Error/validation layer of the PyTorch port — the same exception types
and validators as ``raft_tpu/errors.py`` (the analog of the reference's
cpp/include/raft/error.hpp:38-177: ``raft::exception`` with a collected
backtrace, ``raft::logic_error``, and the ``RAFT_EXPECTS`` /
``RAFT_FAIL`` macros), kept as the port's own copy so that importing it
never imports the JAX package.

Design notes:

* Python exceptions already carry tracebacks, so the reference's manual
  ``backtrace(3)`` collection (error.hpp:57-103) maps to the interpreter's
  native traceback; :class:`RaftException` adds the reference's
  "RAFT failure at file:line" message framing by capturing the caller's
  frame at raise time.
* ``expects``/``fail`` are plain functions on static Python conditions
  (shape/dtype checks — the overwhelming majority of ``RAFT_EXPECTS``
  uses in the reference).
* Shared validators (:func:`check_matrix`, :func:`check_same_cols`,
  :func:`check_k`) concentrate the shape/dtype contracts the reference
  spreads across per-API ``RAFT_EXPECTS`` calls (e.g.
  distance.cuh:417-426, knn.cuh:195-213). They accept numpy arrays and
  torch tensors alike.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np

__all__ = [
    "RaftException",
    "RaftLogicError",
    "RaftTimeoutError",
    "RaftOverloadError",
    "CorruptIndexError",
    "expects",
    "fail",
    "check_matrix",
    "check_same_cols",
    "check_k",
    "expect_finite",
]


class RaftException(RuntimeError):
    """Analog of ``raft::exception`` (error.hpp:38-55): message prefixed
    with the raise site, native traceback in place of the reference's
    collected backtrace."""

    def __init__(self, msg: str, *, _stacklevel: int = 1):
        # sys._getframe, not inspect.stack(): the latter materializes
        # (and reads source context for) EVERY frame — ~100s of ms on a
        # cold linecache, paid per raise. Timeouts/hedges/sheds raise on
        # the serving hot path, so frame capture must be O(1).
        try:
            frame = sys._getframe(_stacklevel)
            where = f"{frame.f_code.co_filename}:{frame.f_lineno}"
        except ValueError:  # stack shallower than _stacklevel
            where = "<unknown>"
        super().__init__(f"RAFT failure at {where}: {msg}")


class RaftLogicError(RaftException, ValueError):
    """Analog of ``raft::logic_error`` (error.hpp:107): a precondition on
    caller-supplied arguments failed. Subclasses ValueError so existing
    ``except ValueError`` callers (and tests) keep working."""


class RaftTimeoutError(RaftException, TimeoutError):
    """A bounded wait expired before the dispatched work became ready
    (``Interruptible.synchronize(timeout_s=...)``,
    ``resilience.dispatch_with_deadline``).

    Deliberately NOT a :class:`ValueError`: a timeout is an operational
    failure, not a bad argument, so existing ``except ValueError``
    handlers never swallow it. Subclasses the builtin ``TimeoutError``
    so generic deadline plumbing (``except TimeoutError``) also works."""


class RaftOverloadError(RaftException):
    """Admission control shed this request: the serving queue is at its
    configured depth bound (or the token limiter is empty), so accepting
    the request would grow latency without bound instead of answering
    anyone on time (``raft_tpu.resilience.admission``; docs/serving.md
    "Overload and shedding").

    Deliberately NOT a :class:`ValueError` (see
    :class:`RaftTimeoutError`): overload is an operational condition the
    CLIENT must back off from, not a malformed argument, so existing
    ``except ValueError`` bad-request handlers never absorb it.

    ``retry_after_s``: the server's suggested client backoff (None when
    it has no estimate) — the HTTP ``Retry-After`` analog.
    """

    def __init__(self, msg: str, *, retry_after_s: "float | None" = None,
                 _stacklevel: int = 1):
        super().__init__(msg, _stacklevel=_stacklevel + 1)
        self.retry_after_s = retry_after_s


class CorruptIndexError(RaftException):
    """A serialized index failed integrity verification at load
    (``spatial.ann.interop.load_ivf_flat``: per-array CRC32 manifest, the
    format-v2 header contract). ``field`` names the damaged entry —
    ``"__header__"`` when the archive/header itself is unreadable.

    Deliberately NOT a :class:`ValueError` (see
    :class:`RaftTimeoutError`): corruption must surface loudly rather
    than be absorbed by a bad-argument handler."""

    def __init__(self, msg: str, *, field: "str | None" = None,
                 _stacklevel: int = 1):
        super().__init__(msg, _stacklevel=_stacklevel + 1)
        self.field = field


def expects(cond: Any, msg: str, *args: Any) -> None:
    """``RAFT_EXPECTS(cond, fmt, ...)`` (error.hpp:151-158): raise
    :class:`RaftLogicError` unless ``cond`` is truthy.

    ``cond`` must be a static Python bool (shape/dtype predicates).
    """
    if not cond:
        raise RaftLogicError(msg % args if args else msg, _stacklevel=2)


def fail(msg: str, *args: Any) -> None:
    """``RAFT_FAIL(fmt, ...)`` (error.hpp:167-173): unconditional raise."""
    raise RaftLogicError(msg % args if args else msg, _stacklevel=2)


# ---------------------------------------------------------------------------
# Shared validators for public entry points
# ---------------------------------------------------------------------------

_REAL_KINDS = ("f", "i", "u", "b")


def check_matrix(x: Any, name: str, *, ndim: int = 2,
                 min_rows: int = 1) -> None:
    """Validate an array argument's rank, dtype kind, and non-degeneracy
    (the per-API ``RAFT_EXPECTS`` shape block, e.g. distance.cuh:417-426)."""
    shape = getattr(x, "shape", None)
    expects(shape is not None, "%s: expected an array, got %s", name, type(x).__name__)
    expects(
        len(shape) == ndim,
        "%s: expected a %dD array, got shape %s", name, ndim, shape,
    )
    dt = x.dtype
    if hasattr(dt, "is_complex"):            # a torch.dtype
        real = not dt.is_complex
    else:
        real = np.dtype(dt).kind in _REAL_KINDS
    expects(real, "%s: expected a real numeric dtype, got %s", name, dt)
    expects(
        shape[0] >= min_rows,
        "%s: needs at least %d row(s), got shape %s", name, min_rows, shape,
    )


def check_same_cols(x: Any, y: Any, xname: str = "x", yname: str = "y") -> None:
    """Both operands share the feature dimension (distance.cuh:420)."""
    expects(
        x.shape[-1] == y.shape[-1],
        "%s/%s: feature dims differ (%d vs %d)",
        xname, yname, x.shape[-1], y.shape[-1],
    )


def check_k(k: int, n: int, what: str = "index rows") -> None:
    """1 <= k <= n (knn.cuh select_k/brute_force_knn contracts)."""
    expects(isinstance(k, (int, np.integer)), "k must be an int, got %s", type(k).__name__)
    expects(1 <= k <= n, "k=%d out of range [1, %d] (%s)", k, n, what)


def expect_finite(x: Any, name: str = "input") -> None:
    """All-finite check for host (numpy) inputs. Cheap relative to any
    kernel that follows (one pass over host memory)."""
    arr = np.asarray(x)
    if arr.dtype.kind == "f" and not np.isfinite(arr).all():
        fail("%s contains non-finite values (NaN/Inf)", name)
