"""Profiler range annotations — the port of ``raft_tpu/core/annotate.py``,
the analog of the reference NVTX layer.

Reference: cpp/include/raft/core/nvtx.hpp:48-91 and
common/detail/nvtx.hpp:23-206 (RAII ``nvtx::range``, push_range /
pop_range, compiled out when NVTX is disabled). Here a range is a
``torch.profiler.record_function`` (it shows on a ``torch.profiler``
trace's CPU timeline) plus, where a CUDA device is present, a
``torch.cuda.nvtx`` range (it shows in any NVTX-aware tool).

Like the reference's ``NVTX_ENABLED`` compile-out, ranges honour a
global enable flag: while profiling is off (the default — set
``RAFT_TPU_PROFILE=1`` to force it on) :func:`annotate` and
:func:`push_range` are true no-ops, with no profiler object built and
nothing stacked. :func:`start_trace` starts a ``torch.profiler`` capture
and turns ranges on for its duration; :func:`stop_trace` writes the
trace under the capture's ``log_dir`` and restores the flag.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List

import torch

from raft_tpu_torch.core import logger

# Kineto tears CUPTI down at the end of each capture only when
# TEARDOWN_CUPTI is "1". Without it, a capture stopped while other threads
# allocate pinned memory and launch (a ProfileTrigger firing under load)
# segfaulted the process now and then on an H100 (torch 2.11, CUDA 12.8),
# and a later capture could miss the card's kernels; with it from the
# process's first capture on, none did. Turned on only after a first
# capture, captures hung or lost their kernels there, so it is set when
# this module is imported, before any capture the port makes. A value the
# caller set is kept.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

# the global range-enable gate (the NVTX_ENABLED analog): a list cell so
# every reader shares it by reference
_ENV_DEFAULT: bool = (
    os.environ.get("RAFT_TPU_PROFILE", "").strip().lower()
    in ("1", "on", "true", "yes")
)
_ENABLED: List[bool] = [_ENV_DEFAULT]
_stack: List[contextlib.ExitStack] = []
# profiling state before start_trace flipped it, restored by stop_trace
_pre_trace: List[bool] = []
# the running capture: (profiler, log_dir)
_trace: List[tuple] = []


def profiling_enabled() -> bool:
    """Are ranges currently being emitted?"""
    return _ENABLED[0]


def set_profiling(on: bool) -> bool:
    """Flip the global range gate; returns the PREVIOUS state. Ranges
    pushed while disabled are not tracked — a ``pop_range`` crossing an
    enable flip logs instead of popping someone else's range."""
    prev = _ENABLED[0]
    _ENABLED[0] = bool(on)
    return prev


@contextlib.contextmanager
def _nvtx(label: str) -> Iterator[None]:
    torch.cuda.nvtx.range_push(label)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def _enter(es: contextlib.ExitStack, label: str) -> None:
    es.enter_context(torch.profiler.record_function(label))
    if torch.cuda.is_available():
        es.enter_context(_nvtx(label))


@contextlib.contextmanager
def annotate(name: str, *args) -> Iterator[None]:
    """RAII-style range, usable as a decorator or context manager.

    ``args`` are %-formatted into ``name`` like the reference's
    printf-style range names (nvtx.hpp:54). A no-op (no profiler objects
    constructed) while profiling is off."""
    if not _ENABLED[0]:
        yield
        return
    with contextlib.ExitStack() as es:
        _enter(es, name % args if args else name)
        yield


def push_range(name: str, *args) -> None:
    """Imperative begin (reference nvtx.hpp push_range). A true no-op —
    nothing allocated, nothing stacked — while profiling is off."""
    if not _ENABLED[0]:
        return
    es = contextlib.ExitStack()
    _enter(es, name % args if args else name)
    _stack.append(es)


def pop_range() -> None:
    """Imperative end (reference nvtx.hpp pop_range). Popping an empty
    stack — an unbalanced pop, or ranges pushed while profiling was
    disabled — is a LOUD no-op (debug log), never an exception: range
    bookkeeping must not take down the path it annotates."""
    if _stack:
        _stack.pop().close()
    else:
        logger.debug(
            "pop_range: range stack empty (unbalanced pop, or the "
            "matching push_range ran while profiling was disabled)"
        )


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture (CPU activity, and CUDA where a
    device is present) and enable range emission for its duration. The
    profiler starts FIRST: if it refuses (a capture is already running),
    the range gate and its restore stack are untouched."""
    if _trace:
        raise RuntimeError("start_trace: a capture is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace.append((prof, str(log_dir)))
    _pre_trace.append(set_profiling(True))


def stop_trace() -> None:
    """Stop the capture, write it as a Chrome trace
    (``trace_<pid>_<ns>.json``) under its ``log_dir``, and restore the
    range gate to its pre-capture state. An unbalanced stop falls back
    to the env-derived default, never a hard False."""
    try:
        if _trace:
            prof, log_dir = _trace.pop()
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    finally:
        set_profiling(_pre_trace.pop() if _pre_trace else _ENV_DEFAULT)
