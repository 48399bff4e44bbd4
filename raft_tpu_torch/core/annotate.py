"""Profiler range annotations — the port of ``raft_tpu/core/annotate.py``,
the analog of the reference NVTX layer.

Reference: cpp/include/raft/core/nvtx.hpp:48-91 and
common/detail/nvtx.hpp:23-206 (RAII ``nvtx::range``, push_range /
pop_range, compiled out when NVTX is disabled). Here a range is a
CPU-scope record function (``torch._C._profiler._RecordFunctionFast``):
it shows on a ``torch.profiler`` trace's CPU timeline, parents the aten
ops and kernel launches inside it (so its ``device_time_total`` holds
their kernels), and is not a user annotation, so it puts no range of its
own on the device timeline. Under the explicit gate, and where a CUDA
device is present, it is also a ``torch.cuda.nvtx`` range (it shows in
any NVTX-aware tool).

Ranges are emitted while the explicit gate is open (``RAFT_TPU_PROFILE=1``,
:func:`set_profiling`, or a :func:`start_trace` capture) and whenever any
``torch.profiler`` capture is running, so every capture sees them
without setup: the port's own, a ``ProfileTrigger``'s, a benchmark's or
an operator's. With the gate closed and no capture, :func:`annotate`
and :func:`push_range` check one flag and the profiler's state and
return: no profiler object built, nothing stacked. :func:`start_trace`
starts a ``torch.profiler`` capture and opens the gate for its
duration; :func:`stop_trace` writes the trace under the capture's
``log_dir`` and restores the gate.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch
from torch.autograd import profiler as _torch_profiler

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

# the explicit range gate (the NVTX_ENABLED analog): a list cell so every
# reader shares it by reference
_ENV_DEFAULT: bool = (
    os.environ.get("RAFT_TPU_PROFILE", "").strip().lower()
    in ("1", "on", "true", "yes")
)
_ENABLED: List[bool] = [_ENV_DEFAULT]
_stack: List["_Range"] = []
# profiling state before start_trace flipped it, restored by stop_trace
_pre_trace: List[bool] = []
# the running capture: (profiler, log_dir)
_trace: List[tuple] = []

# is a torch.profiler capture running anywhere in the process? torch's own
# process-wide flag, which every capture sets at its start and clears at
# its stop (torch.autograd._profiler_enabled sees only a capture that
# records the calling thread: the main thread's capture of a search, not
# a capture made with every thread in view of an executor's batcher)
if hasattr(_torch_profiler, "_is_profiler_enabled"):
    def _capture_running() -> bool:
        return _torch_profiler._is_profiler_enabled
else:
    _capture_running = torch.autograd._profiler_enabled
# the one record-function type every range uses: CPU scope, not a user
# annotation (torch.profiler.record_function is one, and Kineto mirrors
# those onto the device timeline as ranges of their own)
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_NULL = contextlib.nullcontext()


def profiling_enabled() -> bool:
    """Is the explicit gate open (``RAFT_TPU_PROFILE``,
    :func:`set_profiling`, :func:`start_trace`)?"""
    return _ENABLED[0]


def ranges_on() -> bool:
    """Are ranges being emitted: the explicit gate open, or a
    ``torch.profiler`` capture running?"""
    return _ENABLED[0] or _capture_running()


def set_profiling(on: bool) -> bool:
    """Flip the explicit range gate; returns the PREVIOUS state. Ranges
    pushed while none were emitted are not tracked — a ``pop_range``
    crossing an enable flip logs instead of popping someone else's
    range."""
    prev = _ENABLED[0]
    _ENABLED[0] = bool(on)
    return prev


class _Range:
    """One open-able range: the record function, and an NVTX range when
    the explicit gate was open at construction and a CUDA device is
    present."""

    __slots__ = ("_label", "_rf", "_nvtx")

    def __init__(self, label: str):
        self._label = label
        self._rf = None
        self._nvtx = _ENABLED[0] and torch.cuda.is_available()

    def __enter__(self) -> "_Range":
        if _record_function is not None:
            self._rf = _record_function(self._label)
            self._rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._label)
        return self

    def __exit__(self, *exc) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None


def annotate(name: str, *args):
    """RAII-style range, used as a context manager.

    ``args`` are %-formatted into ``name`` like the reference's
    printf-style range names (nvtx.hpp:54). While no range is emitted
    (:func:`ranges_on` false) it returns a shared null context: nothing
    built, nothing formatted. A capture records the range only where it
    records the calling thread."""
    if not (_ENABLED[0] or _capture_running()):
        return _NULL
    return _Range(name % args if args else name)


def push_range(name: str, *args) -> None:
    """Imperative begin (reference nvtx.hpp push_range). A true no-op —
    nothing allocated, nothing stacked — while no range is emitted."""
    if not (_ENABLED[0] or _capture_running()):
        return
    rng = _Range(name % args if args else name)
    rng.__enter__()
    _stack.append(rng)


def pop_range() -> None:
    """Imperative end (reference nvtx.hpp pop_range). Popping an empty
    stack — an unbalanced pop, or ranges pushed while none were
    emitted — is a LOUD no-op (debug log), never an exception: range
    bookkeeping must not take down the path it annotates."""
    if _stack:
        _stack.pop().__exit__(None, None, None)
    else:
        logger.debug(
            "pop_range: range stack empty (unbalanced pop, or the "
            "matching push_range ran while no range was emitted)"
        )


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture (CPU activity, and CUDA where a
    device is present) and open the explicit gate for its duration
    (its ranges then carry NVTX ranges too). The
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
