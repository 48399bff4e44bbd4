"""The concurrency auditor of the port — the counterpart of
``raft_tpu/analysis/threads/``. Three cooperating parts:

* :mod:`~raft_tpu_torch.analysis.threads.census` +
  :mod:`~raft_tpu_torch.analysis.threads.rules` — the AST **static
  pass**: a per-class shared-state census feeding four lock-discipline
  rules (``unguarded-shared-state``, ``lock-in-traced-body``,
  ``blocking-call-under-lock``, ``sleep-under-lock``);
* :mod:`~raft_tpu_torch.analysis.threads.lock_order` — the cross-module
  **acquired-while-held graph**: cycle detection plus drift discipline
  against the blessed partial order in
  ``raft_tpu_torch/analysis/lock_order.json`` (CLI: ``python -m
  raft_tpu_torch.analysis --threads [--write-lock-order]``);
* :mod:`~raft_tpu_torch.analysis.threads.runtime` — the **runtime
  tracer**: :class:`~raft_tpu_torch.analysis.threads.runtime.TracedLock`
  records per-thread held-lock stacks and asserts acquisitions against
  the same pinned order under real interleavings. Enabled via
  ``RAFT_TPU_LOCKCHECK=1`` (or ``set_enabled``); zero-cost when off
  (production lock sites call
  :func:`~raft_tpu_torch.analysis.threads.runtime.make_lock`, which
  hands back a plain ``threading.Lock`` unless tracing is on).

Everything here is stdlib-only — production modules (serving, obs,
resilience, spatial) import :mod:`.runtime` at module import time, so
this package must never pull in torch or the rule registry eagerly.
"""

from raft_tpu_torch.analysis.threads.runtime import (   # noqa: F401
    HoldOutlier,
    LockOrderViolation,
    TracedLock,
    assert_clean,
    clear,
    enabled,
    held_locks,
    hold_outliers,
    load_pinned_order,
    make_condition,
    make_lock,
    note_dispatch,
    observed_edges,
    pin_order,
    pinned_order,
    set_enabled,
    violations,
)

__all__ = [
    "HoldOutlier",
    "LockOrderViolation",
    "TracedLock",
    "assert_clean",
    "clear",
    "enabled",
    "held_locks",
    "hold_outliers",
    "load_pinned_order",
    "make_condition",
    "make_lock",
    "note_dispatch",
    "observed_edges",
    "pin_order",
    "pinned_order",
    "set_enabled",
    "violations",
]
