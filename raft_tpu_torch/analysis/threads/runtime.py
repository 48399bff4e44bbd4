"""The runtime lock-order tracer — the port of
``raft_tpu/analysis/threads/runtime.py`` (stdlib only, same behaviour): :class:`TracedLock` and the
``make_lock`` / ``make_condition`` factories every production lock site
routes through.

Static analysis (census + lock-order graph, the rest of this package)
proves properties of the LEXICAL lock structure; this module checks the
same claims under real thread interleavings. With
``RAFT_TPU_LOCKCHECK=1`` in the environment (or :func:`set_enabled`),
``make_lock`` returns a :class:`TracedLock` that

* keeps a per-thread stack of held locks,
* asserts every acquisition against the pinned partial order in
  ``raft_tpu_torch/analysis/lock_order.json`` (an acquisition whose
  REVERSE path is blessed is an inversion; an edge the graph has never
  seen is drift),
* records lock-hold-time outliers into the
  ``lock_hold_ms{lock=...}`` histogram of the process registry
  (:mod:`raft_tpu_torch.obs.metrics`), and
* flags hold-while-dispatch via :func:`note_dispatch` (the serving
  executor calls it immediately before handing a batch to the device —
  dispatching while holding any serving lock would serialize the
  pipeline behind the device queue).

Disabled (the default), ``make_lock`` returns a plain
``threading.Lock`` — the zero-cost-off discipline of the obs gate
(:data:`raft_tpu_torch.obs.metrics._ENABLED`): production code pays one
function call at CONSTRUCTION time, nothing per acquisition.

Violations are recorded, not raised (a chaos test must observe ALL of
them, and a tracer that throws from ``release`` corrupts the state it
reports on); :func:`assert_clean` turns the record into a hard failure
at a point of the caller's choosing. The one exception is re-acquiring
a lock the SAME thread already holds — that is a certain deadlock on a
non-reentrant lock, so :meth:`TracedLock.acquire` raises instead of
parking the test suite forever.

stdlib-only on purpose: serving/obs/resilience modules import this at
module import time, and the metric/flight integrations are reached
lazily at violation/release time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

__all__ = [
    "TracedLock", "LockOrderViolation", "HoldOutlier",
    "make_lock", "make_condition", "enabled", "set_enabled",
    "pin_order", "pinned_order", "load_pinned_order",
    "note_dispatch", "violations", "hold_outliers", "observed_edges",
    "clear", "assert_clean",
]

#: where the port's blessed partial order lives (written from the port's
#: own source by ``python -m raft_tpu_torch.analysis --threads
#: --write-lock-order raft_tpu_torch``)
DEFAULT_LOCK_ORDER = Path(__file__).resolve().parents[1] / "lock_order.json"


def _env_enabled() -> bool:
    return os.environ.get("RAFT_TPU_LOCKCHECK", "").strip().lower() in (
        "1", "true", "on", "yes",
    )


# same list-cell idiom as the obs gate: handles created before a
# set_enabled() flip must share the cell, not a stale bool
_ENABLED: List[bool] = [_env_enabled()]

#: hold times at or above this many milliseconds are recorded as
#: outliers (the histogram records EVERY hold; the outlier list is the
#: small, readable residue a test can assert on)
HOLD_OUTLIER_MS = float(
    os.environ.get("RAFT_TPU_LOCKCHECK_HOLD_MS", "50")
)
_MAX_RECORDED = 1024   # violations/outliers each; the tracer bounds
                       # its own memory like the flight recorder's ring


def enabled() -> bool:
    """Is lock tracing on? (``RAFT_TPU_LOCKCHECK`` env at import;
    :func:`set_enabled` at runtime — affects only locks constructed
    AFTER the flip, construction is the routing point.)"""
    return _ENABLED[0]


def set_enabled(on: bool) -> bool:
    """Flip the tracing gate; returns the previous state."""
    prev = _ENABLED[0]
    _ENABLED[0] = bool(on)
    return prev


# -- per-thread held stack ----------------------------------------------------

_tls = threading.local()


def _frames() -> list:
    fr = getattr(_tls, "frames", None)
    if fr is None:
        fr = _tls.frames = []
    return fr


def held_locks() -> Tuple[str, ...]:
    """Names of the locks the CALLING thread currently holds, in
    acquisition order (outermost first)."""
    fr = getattr(_tls, "frames", None)
    return tuple(f[0].name for f in fr) if fr else ()


# -- the pinned partial order -------------------------------------------------

_pinned: Dict[str, Set[str]] = {}
_pinned_loaded = [False]


def pin_order(edges: Mapping[str, Iterable[str]]) -> None:
    """Install the blessed partial order (``held -> may-acquire``
    adjacency), replacing any previous one."""
    _pinned.clear()
    for a, bs in edges.items():
        _pinned[str(a)] = {str(b) for b in bs}
    _pinned_loaded[0] = True


def pinned_order() -> Dict[str, Set[str]]:
    return {a: set(bs) for a, bs in _pinned.items()}


def load_pinned_order(path: Optional[Path] = None) -> bool:
    """Load the port's ``lock_order.json`` (or ``path``); returns
    whether a file was found. Missing file pins the EMPTY order — every
    nested acquisition then reports as drift, which is the correct
    failure mode for a repo that lost its contract file."""
    p = Path(path) if path is not None else DEFAULT_LOCK_ORDER
    if not p.exists():
        _pinned_loaded[0] = True
        return False
    data = json.loads(p.read_text())
    pin_order(data.get("order", {}))
    return True


def _ensure_pinned() -> None:
    if not _pinned_loaded[0]:
        load_pinned_order()


def _has_path(a: str, b: str) -> bool:
    """Is there a pinned path a -> ... -> b?"""
    seen = set()
    stack = [a]
    while stack:
        n = stack.pop()
        if n == b:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_pinned.get(n, ()))
    return False


# -- violation / outlier records ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class LockOrderViolation:
    """One runtime ordering violation."""

    kind: str                  # "inversion" | "unpinned" |
                               # "hold-while-dispatch"
    held: Tuple[str, ...]      # the thread's stack, outermost first
    acquiring: str             # lock being acquired (or the dispatch
                               # site for hold-while-dispatch)
    thread: str

    def render(self) -> str:
        chain = " -> ".join(self.held) or "<none>"
        return (f"[{self.kind}] thread {self.thread!r}: holding "
                f"{chain}, acquiring {self.acquiring!r}")


@dataclasses.dataclass(frozen=True)
class HoldOutlier:
    """One lock held past :data:`HOLD_OUTLIER_MS`."""

    lock: str
    held_ms: float
    thread: str


_state_lock = threading.Lock()
_violations: List[LockOrderViolation] = []
_outliers: List[HoldOutlier] = []
_observed: Dict[str, Set[str]] = {}


def _feed_violation_counter(kind: str) -> None:
    try:
        from raft_tpu_torch.obs import metrics as _m

        if _m.enabled():
            _m.default_registry().counter(
                "lock_order_violations_total", kind=kind,
            ).inc()
    except Exception:   # noqa: BLE001 — telemetry must not kill the
        pass            # tracer (mirrors the emitter's discipline)


def _record_violation(v: LockOrderViolation) -> None:
    with _state_lock:
        if len(_violations) < _MAX_RECORDED:
            _violations.append(v)
    _feed_violation_counter(v.kind)


def violations() -> List[LockOrderViolation]:
    with _state_lock:
        return list(_violations)


def hold_outliers() -> List[HoldOutlier]:
    with _state_lock:
        return list(_outliers)


def observed_edges() -> Dict[str, Set[str]]:
    """Every (held, acquired) pair actually seen at runtime — the
    evidence a chaos run contributes to the static graph."""
    with _state_lock:
        return {a: set(bs) for a, bs in _observed.items()}


def clear() -> None:
    """Reset violations, outliers, and observed edges (test setup)."""
    with _state_lock:
        _violations.clear()
        _outliers.clear()
        _observed.clear()


def assert_clean() -> None:
    """Raise ``AssertionError`` listing every recorded violation."""
    vs = violations()
    if vs:
        raise AssertionError(
            "lockcheck: %d lock-order violation(s):\n%s"
            % (len(vs), "\n".join(v.render() for v in vs))
        )


def _check_order(name: str, held: Tuple[str, ...]) -> None:
    top = held[-1]
    if name in _pinned.get(top, ()):
        pass                       # directly blessed
    elif _has_path(name, top):     # the REVERSE direction is blessed:
        _record_violation(         # a textbook inversion
            LockOrderViolation("inversion", held, name,
                               threading.current_thread().name))
        return
    elif _has_path(top, name):
        pass                       # transitively blessed
    else:
        _record_violation(
            LockOrderViolation("unpinned", held, name,
                               threading.current_thread().name))
        return
    with _state_lock:
        _observed.setdefault(top, set()).add(name)


# -- the traced lock ----------------------------------------------------------

class TracedLock:
    """A ``threading.Lock`` that records acquisition order and hold
    time. Duck-compatible with ``threading.Lock`` (``acquire`` /
    ``release`` / context manager / ``locked``), so
    ``threading.Condition(TracedLock(...))`` works: the Condition's
    release/re-acquire during ``wait`` flows through this wrapper and
    keeps the held stack truthful."""

    __slots__ = ("name", "_lock", "_hist")

    def __init__(self, name: str):
        self.name = str(name)
        self._lock = threading.Lock()
        self._hist = None   # lazily bound lock_hold_ms handle

    def acquire(self, blocking: bool = True, timeout: float = -1):
        frames = _frames()
        # order checks only on BLOCKING acquisitions: a try-lock that
        # fails simply moves on — it cannot deadlock, and Condition's
        # _is_owned probe uses acquire(False) as a matter of course
        if blocking and _ENABLED[0] and frames:
            for f in frames:
                if f[0] is self:
                    raise RuntimeError(
                        f"lockcheck: thread "
                        f"{threading.current_thread().name!r} "
                        f"re-acquiring {self.name!r} it already holds "
                        "— certain deadlock on a non-reentrant lock"
                    )
            _ensure_pinned()
            _check_order(self.name, tuple(f[0].name for f in frames))
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            frames.append((self, time.monotonic()))
        return ok

    def release(self) -> None:
        frames = getattr(_tls, "frames", None)
        t0 = None
        if frames:
            for i in range(len(frames) - 1, -1, -1):
                if frames[i][0] is self:
                    t0 = frames[i][1]
                    del frames[i]
                    break
        self._lock.release()
        if t0 is not None:
            self._note_hold((time.monotonic() - t0) * 1e3)

    def _note_hold(self, ms: float) -> None:
        if ms >= HOLD_OUTLIER_MS:
            with _state_lock:
                if len(_outliers) < _MAX_RECORDED:
                    _outliers.append(HoldOutlier(
                        self.name, ms,
                        threading.current_thread().name))
        h = self._hist
        if h is None:
            try:
                from raft_tpu_torch.obs import metrics as _m
            except Exception:   # noqa: BLE001
                self._hist = False
                return
            h = self._hist = _m.default_registry().histogram(
                "lock_hold_ms", lock=self.name)
        if h is not False:
            h.observe(ms)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TracedLock({self.name!r})"


# -- the factories production code routes through -----------------------------

def make_lock(name: str) -> "threading.Lock | TracedLock":
    """A lock named for the static census node (``Class.attr`` or
    ``module.var``): a :class:`TracedLock` when tracing is enabled, a
    plain ``threading.Lock`` otherwise."""
    if _ENABLED[0]:
        _ensure_pinned()
        return TracedLock(name)
    return threading.Lock()


def make_condition(lock, name: Optional[str] = None,
                   ) -> threading.Condition:
    """A ``Condition`` over ``lock`` (plain or traced). Conditions
    sharing a lock share its order node — ``wait`` releases and
    re-acquires through the same wrapper, so the held stack never
    lies about a parked thread. ``name`` is documentation only."""
    del name
    return threading.Condition(lock)


def note_dispatch(what: str = "dispatch") -> None:
    """Record a hold-while-dispatch violation if the calling thread
    holds ANY traced lock. The executor calls this immediately before
    handing a staged batch to the device; no-op (one list load) when
    tracing is off."""
    if not _ENABLED[0]:
        return
    fr = getattr(_tls, "frames", None)
    if fr:
        _record_violation(LockOrderViolation(
            "hold-while-dispatch",
            tuple(f[0].name for f in fr), what,
            threading.current_thread().name))
