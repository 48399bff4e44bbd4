"""Cooperative cancellation — analog of ``raft::interruptible``; the port
of ``raft_tpu/core/interruptible.py``.

Reference: cpp/include/raft/core/interruptible.hpp:66-270. There, a per-thread
token lets one thread cancel another's *stream wait*: ``synchronize(stream)``
polls ``cudaStreamQuery`` in a yield loop checking the token, so CTRL+C can
break out of a long GPU wait.

On a CUDA card the port does what the reference does: :meth:`Interruptible.
synchronize` polls ``torch.cuda.Event.query()`` (``cudaEventQuery``) in a
backoff loop that checks the calling thread's token, where the JAX package
polls ``Array.is_ready()``. The per-thread token registry and
``yield_now``/``cancel`` keep their semantics; device work already
enqueued completes (cancellation is cooperative, not preemptive).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core import tree as _tree


def waitables(x: Any) -> List[Any]:
    """What to poll before ``x`` is ready: ``x`` is an event, or a tree
    (:mod:`raft_tpu_torch.core.tree`) whose leaves are events, tensors or
    numpy arrays.

    * a leaf with a ``query()`` method — a ``torch.cuda.Event``, or a
      readiness gate of the same shape — is polled as it is;
    * CUDA tensors among the leaves add ONE event per device, recorded
      now on that device's current stream: it completes once everything
      enqueued on that stream so far has, which covers the work that
      produced the tensors when the calling thread enqueued it. A caller
      that produced them on another stream passes that stream's event
      instead;
    * CPU tensors, numpy arrays and other leaves are ready at once.
    """
    out: List[Any] = []
    devices: Dict[torch.device, None] = {}
    for leaf in _tree.leaves(x):
        if callable(getattr(leaf, "query", None)):
            out.append(leaf)
        elif isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            devices[leaf.device] = None
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        out.append(ev)
    return out


class InterruptedException(RuntimeError):
    """Raised inside the cancelled thread (reference: raft::interrupted_exception).

    Deliberately NOT named ``InterruptedError`` — that would shadow the
    Python builtin (an OSError subclass) and change exception-handling
    semantics for importers.
    """


class Interruptible:
    """Per-thread cancellation token (reference interruptible.hpp:66)."""

    _registry: Dict[int, "Interruptible"] = {}
    _registry_lock = threading.Lock()

    def __init__(self) -> None:
        self._cancelled = threading.Event()

    # -- token API -----------------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation; the owner thread observes it at its next
        ``yield_now`` (reference: cancel() sets the flag, :219)."""
        self._cancelled.set()

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def clear(self) -> None:
        self._cancelled.clear()

    # -- static per-thread API ----------------------------------------------
    @classmethod
    def get_token(cls, thread_id: Optional[int] = None) -> "Interruptible":
        """Get (creating if needed) the token for a thread
        (reference interruptible.hpp:84 get_token())."""
        tid = threading.get_ident() if thread_id is None else thread_id
        with cls._registry_lock:
            # prune tokens of dead threads so the registry stays bounded and
            # a reused OS thread id cannot inherit a stale cancelled token
            # (the reference uses a weak-pointer registry for the same reason,
            # interruptible.hpp:140-168).
            live = {t.ident for t in threading.enumerate()}
            for dead in [k for k in cls._registry if k not in live and k != tid]:
                del cls._registry[dead]
            tok = cls._registry.get(tid)
            if tok is None:
                tok = cls()
                cls._registry[tid] = tok
            return tok

    @classmethod
    def yield_now(cls) -> None:
        """Check this thread's token; raise if cancelled
        (reference: yield() / yield_no_throw)."""
        tok = cls.get_token()
        if tok.cancelled():
            tok.clear()
            raise InterruptedException("raft_tpu_torch: thread interrupted")

    @classmethod
    def yield_no_throw(cls) -> bool:
        tok = cls.get_token()
        if tok.cancelled():
            tok.clear()
            return False
        return True

    @classmethod
    def cancel_thread(cls, thread_id: int) -> None:
        cls.get_token(thread_id).cancel()

    @classmethod
    def synchronize(cls, x, *, poll_interval_s: float = 0.001,
                    max_poll_interval_s: float = 0.05,
                    timeout_s: Optional[float] = None) -> None:
        """Cancellable, optionally deadline-bounded wait on an event, or
        on a tree of events and tensors (:func:`waitables` says what is
        polled for each leaf).

        The exact analog of the reference's polling loop
        (interruptible.hpp:66-120: ``cudaStreamQuery`` + token check +
        ``std::this_thread::yield``): poll ``Event.query()`` on every
        pending event, checking this thread's token between polls, so
        ``cancel()`` from another thread breaks an IN-FLIGHT wait — the
        enqueued device work itself still completes (cancellation is
        cooperative, as in the reference). CPU leaves are ready at once.

        ``timeout_s`` bounds the wait: if the work is still not ready
        after that many seconds,
        :class:`raft_tpu_torch.errors.RaftTimeoutError` is raised (the
        enqueued work still completes — the deadline abandons the WAIT,
        exactly like cancellation). Cancellation and the deadline
        compose: the token is checked before the clock every iteration,
        so whichever fires first wins and a cancel can never be masked
        by an elapsed deadline. The serving path's deadline/retry recipe
        builds on this (``raft_tpu_torch.resilience.dispatch_with_deadline``).

        The poll interval backs off exponentially from
        ``poll_interval_s`` toward ``max_poll_interval_s`` so a
        multi-second kernel doesn't burn a host core in 1 ms wakeups;
        cancellation (and deadline) latency stays bounded by the cap.
        """
        pending = waitables(x)
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        interval = poll_interval_s
        while True:
            cls.yield_now()
            pending = [w for w in pending if not w.query()]
            if not pending:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise errors.RaftTimeoutError(
                    "synchronize: enqueued work not ready within "
                    f"{timeout_s:.3g}s ({len(pending)} events pending)"
                )
            time.sleep(interval)  # the std::this_thread::yield slot
            interval = min(interval * 2.0, max_poll_interval_s)
