"""Deterministic scripted chaos schedules and declarative invariant
checkers — the port of ``raft_tpu/testing/chaos.py``, the harness that
proves the self-healing supervisor
(:mod:`raft_tpu_torch.resilience.supervisor`) rather than eyeballing it.

Three pieces compose:

- :class:`ChaosSchedule` — a seeded DSL of timed fault events built from
  the :mod:`raft_tpu_torch.testing.faults` injectors: rank kill / heal
  (actuated through a :class:`ScriptedHealth` truth the supervisor's
  probe reads), oscillating probes, straggler windows
  (``inject_straggler`` behind a gate), torn checkpoint writes
  (``inject_partial_write``), fetcher-thread crashes
  (``inject_worker_crash``) and a SIGKILL of a subprocess (``kill9``).
  Events are offsets from run start, fired replay-style (never early,
  catch-up when late — the discipline of ``testing/load.replay``), so a
  schedule is one reproducible artifact a soak can rerun verbatim.
- :class:`Invariant` checkers — declarative predicates sampled
  CONTINUOUSLY during the run, not asserted once at the end:
  :class:`AlwaysInvariant` (must hold at every sample),
  :class:`FinalInvariant` (must hold at drain), :class:`BoundInvariant`
  (a count must never exceed a bound — e.g. the engines'
  ``ENGINE_FALLBACKS`` growth 0, route pushes ≤ confirmed transitions),
  and :class:`ConvergenceInvariant` (every trigger increment answered
  within a deadline — e.g. the route converges within ``deadline_s`` of
  each confirmed down).
- :func:`run_schedule` — the loop that fires due events, samples every
  checker between them, and returns a :class:`ChaosReport` whose
  ``ok`` / ``violations`` the caller asserts.

The kill-9 leg, :func:`run_crash_ingest_cycle` (a real subprocess
ingesting through a WAL, SIGKILLed mid-ingest, its log repaired and
reread), lives in :mod:`raft_tpu_torch.testing.crash` and is
re-exported here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.testing import faults
from raft_tpu_torch.testing.crash import run_crash_ingest_cycle

__all__ = [
    "ChaosEvent",
    "ChaosSchedule",
    "ChaosReport",
    "ChaosViolation",
    "ScriptedHealth",
    "StragglerGate",
    "Invariant",
    "AlwaysInvariant",
    "FinalInvariant",
    "BoundInvariant",
    "ConvergenceInvariant",
    "inject_worker_crash",
    "run_crash_ingest_cycle",
    "run_schedule",
]


class ScriptedHealth:
    """The scripted per-rank truth a chaos run feeds the supervisor:
    ``probe`` is exactly the ``{rank: up}`` callable
    :class:`~raft_tpu_torch.resilience.supervisor.ServingSupervisor` takes,
    and schedule events actuate :meth:`set` — so the supervisor under
    test sees a probe stream indistinguishable from a heartbeat sweep,
    with the script as ground truth (thread-safe: events fire on the
    runner thread while the supervisor polls on its own)."""

    def __init__(self, n_ranks: int):
        errors.expects(n_ranks >= 1,
                       "ScriptedHealth: n_ranks=%d < 1", n_ranks)
        self._lock = lockcheck.make_lock("ScriptedHealth._lock")
        self._up = np.ones(n_ranks, dtype=bool)

    @property
    def n_ranks(self) -> int:
        # immutable array metadata (see ShardHealth.n_ranks)
        return self._up.shape[0]  # jaxlint: disable=unguarded-shared-state

    def set(self, rank: int, up: bool) -> None:
        errors.expects(0 <= rank < self.n_ranks,
                       "ScriptedHealth: rank %d out of range", rank)
        with self._lock:
            self._up[rank] = bool(up)

    def probe(self) -> Dict[int, bool]:
        with self._lock:
            return {r: bool(u) for r, u in enumerate(self._up)}


class StragglerGate:
    """A schedulable straggler window around a dispatch function: while
    enabled, calls route through ``faults.inject_straggler`` (every
    ``every``-th result polls not-ready for ``seconds``); while
    disabled, the wrapped function is called directly. The gate is what
    a :class:`ChaosSchedule` toggles to script a straggler BURST with a
    start and an end."""

    def __init__(self, fn, *, every: int = 2, seconds: float = 0.02):
        self._fn = fn
        self._straggling, self.audit = faults.inject_straggler(
            fn, every=every, seconds=seconds
        )
        self._lock = lockcheck.make_lock("StragglerGate._lock")
        self._on = False

    def enable(self) -> None:
        with self._lock:
            self._on = True

    def disable(self) -> None:
        with self._lock:
            self._on = False

    def __call__(self, *args, **kwargs):
        with self._lock:
            on = self._on
        return (self._straggling if on else self._fn)(*args, **kwargs)


def inject_worker_crash(store, *, times: int = 1,
                        exc_type=RuntimeError) -> Callable[[], None]:
    """Arm the fetcher-thread crash fault: wrap ``store.apply_moves``
    so the next ``times`` promotion batches raise ``exc_type`` inside
    the :class:`~raft_tpu_torch.tier.fetch.SlabFetcher` worker — the fault
    its bounded-restart policy (``tier_fetcher_restarts_total``) must
    absorb. Returns a ``restore()`` callable that disarms the fault."""
    errors.expects(times >= 1, "inject_worker_crash: times=%d < 1", times)
    original = store.apply_moves
    remaining = [int(times)]

    def crashing(moves, **kwargs):
        if remaining[0] > 0:
            remaining[0] -= 1
            raise exc_type("chaos: injected fetcher worker crash")
        return original(moves, **kwargs)

    store.apply_moves = crashing

    def restore() -> None:
        store.apply_moves = original

    return restore


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One timed fault: ``fire()`` runs at ``at_s`` seconds after the
    run starts (replay-style: never early, catch-up when late)."""

    at_s: float
    name: str
    fire: Callable[[], None]


class ChaosSchedule:
    """A seeded, composable script of timed fault events. ``seed``
    derandomizes the composers that need randomness (none currently
    draw, but the seed is part of the schedule's identity so a soak
    artifact names it); the rank-health composers actuate the
    ``scripted`` truth passed at construction."""

    def __init__(self, *, scripted: Optional[ScriptedHealth] = None,
                 seed: int = 0):
        self.scripted = scripted
        self.seed = int(seed)
        self._events: List[ChaosEvent] = []

    @property
    def events(self) -> List[ChaosEvent]:
        return sorted(self._events, key=lambda e: e.at_s)

    def at(self, at_s: float, name: str,
           fire: Callable[[], None]) -> "ChaosSchedule":
        """Add one raw event; returns ``self`` for chaining."""
        errors.expects(at_s >= 0.0, "ChaosSchedule: at_s=%s < 0", at_s)
        self._events.append(ChaosEvent(float(at_s), str(name), fire))
        return self

    def _need_scripted(self) -> ScriptedHealth:
        errors.expects(
            self.scripted is not None,
            "ChaosSchedule: rank-health events need scripted=ScriptedHealth",
        )
        return self.scripted

    def kill_rank(self, at_s: float, rank: int, *,
                  wreck: Optional[Callable[[], None]] = None
                  ) -> "ChaosSchedule":
        """Rank death at ``at_s``: the scripted probe starts reporting
        it down; ``wreck`` (optional) destroys its served state at the
        same instant (e.g. zero its slabs) so bit-identity checks PROVE
        the reroute rather than accidentally reading dead-rank data."""
        scripted = self._need_scripted()

        def fire() -> None:
            if wreck is not None:
                wreck()
            scripted.set(rank, False)

        return self.at(at_s, f"kill_rank_{rank}", fire)

    def heal_rank(self, at_s: float, rank: int) -> "ChaosSchedule":
        """The external heal signal at ``at_s``: the scripted probe
        starts reporting the rank up — reintegration is the
        SUPERVISOR's job from here, the schedule never calls recovery
        primitives itself."""
        scripted = self._need_scripted()
        return self.at(at_s, f"heal_rank_{rank}",
                       lambda: scripted.set(rank, True))

    def oscillate(self, at_s: float, rank: int, *, period_s: float,
                  duration_s: float) -> "ChaosSchedule":
        """An oscillating (flapping) probe: toggle the rank's scripted
        state every ``period_s`` for ``duration_s``, ending UP — the
        fault the monitor's debounce must absorb without route churn."""
        scripted = self._need_scripted()
        errors.expects(period_s > 0.0,
                       "ChaosSchedule.oscillate: period_s=%s <= 0",
                       period_s)
        n = max(1, int(round(duration_s / period_s)))
        for i in range(n):
            up = i % 2 == 1  # start by dropping, alternate
            self.at(at_s + i * period_s, f"oscillate_rank_{rank}",
                    (lambda u: lambda: scripted.set(rank, u))(up))
        return self.at(at_s + n * period_s, f"oscillate_rank_{rank}_end",
                       lambda: scripted.set(rank, True))

    def straggler_window(self, at_s: float, gate: StragglerGate, *,
                         duration_s: float) -> "ChaosSchedule":
        """A straggler burst: enable ``gate`` at ``at_s``, disable it
        ``duration_s`` later."""
        self.at(at_s, "straggler_on", gate.enable)
        return self.at(at_s + duration_s, "straggler_off", gate.disable)

    def torn_checkpoint(self, at_s: float, path, *,
                        mode: str = "truncate",
                        boundary: Optional[int] = None,
                        seed: Optional[int] = None) -> "ChaosSchedule":
        """Tear a checkpoint file at ``at_s`` (``faults.
        inject_partial_write``) — a heal that recovers from it must
        fail CRC-clean and roll back, not serve a half-written splice."""
        s = self.seed if seed is None else int(seed)
        return self.at(
            at_s, "torn_checkpoint",
            lambda: faults.inject_partial_write(
                path, mode=mode, boundary=boundary, seed=s
            ),
        )

    def crash_fetcher(self, at_s: float, store, *,
                      times: int = 1) -> "ChaosSchedule":
        """Arm ``times`` fetcher-worker crashes at ``at_s`` (see
        :func:`inject_worker_crash`; the fault disarms itself after
        ``times`` batches)."""
        return self.at(at_s, "crash_fetcher",
                       lambda: inject_worker_crash(store, times=times))

    def kill9(self, at_s: float, proc) -> "ChaosSchedule":
        """SIGKILL a subprocess at ``at_s`` — the whole-process crash
        the WAL's durable-ack contract is proven against.  The victim
        gets no cleanup, no ``atexit``, no final flush: exactly a
        power cut as seen from this host.  ``proc`` is any object with
        ``poll()``/``kill()`` (``subprocess.Popen``)."""
        def fire() -> None:
            if proc.poll() is None:
                proc.kill()
        return self.at(at_s, "kill9", fire)


# ----------------------------------------------------------------------
# invariant checkers


@dataclasses.dataclass(frozen=True)
class ChaosViolation:
    t_s: float
    invariant: str
    message: str


class Invariant:
    """Base checker: ``sample(t)`` runs at every runner tick, ``
    finish(t)`` once at drain; both append to ``violations``. Concrete
    checkers below cover the common shapes; subclass for bespoke ones."""

    def __init__(self, name: str):
        self.name = str(name)
        self.violations: List[ChaosViolation] = []

    def _fail(self, t_s: float, message: str) -> None:
        self.violations.append(
            ChaosViolation(float(t_s), self.name, str(message))
        )

    def sample(self, t_s: float) -> None:  # pragma: no cover - override
        pass

    def finish(self, t_s: float) -> None:  # pragma: no cover - override
        pass


class AlwaysInvariant(Invariant):
    """``predicate()`` must hold at EVERY sample (and at finish).
    ``detail`` (optional) is called on failure for the message."""

    def __init__(self, name: str, predicate: Callable[[], bool], *,
                 detail: Optional[Callable[[], str]] = None):
        super().__init__(name)
        self._predicate = predicate
        self._detail = detail

    def _check(self, t_s: float) -> None:
        if not self._predicate():
            self._fail(t_s, self._detail() if self._detail else "violated")

    def sample(self, t_s: float) -> None:
        self._check(t_s)

    def finish(self, t_s: float) -> None:
        self._check(t_s)


class FinalInvariant(Invariant):
    """``predicate()`` must hold once the run has drained — for checks
    that are only meaningful at quiescence (bit-identity vs the healthy
    mesh, zero acked writes lost)."""

    def __init__(self, name: str, predicate: Callable[[], bool], *,
                 detail: Optional[Callable[[], str]] = None):
        super().__init__(name)
        self._predicate = predicate
        self._detail = detail

    def finish(self, t_s: float) -> None:
        if not self._predicate():
            self._fail(t_s, self._detail() if self._detail else "violated")


class BoundInvariant(Invariant):
    """``value_fn()`` must never exceed ``bound`` — no engine fallback
    (``ENGINE_FALLBACKS`` growth ≤ 0) and the flap invariant (route
    pushes − confirmed transitions ≤ 0) are both this shape."""

    def __init__(self, name: str, value_fn: Callable[[], float],
                 bound: float):
        super().__init__(name)
        self._value_fn = value_fn
        self.bound = float(bound)

    def _check(self, t_s: float) -> None:
        v = float(self._value_fn())
        if v > self.bound:
            self._fail(t_s, f"value {v} > bound {self.bound}")

    def sample(self, t_s: float) -> None:
        self._check(t_s)

    def finish(self, t_s: float) -> None:
        self._check(t_s)


class ConvergenceInvariant(Invariant):
    """Every increment of ``trigger_fn()`` must be answered by
    ``done_fn()`` reaching at least that count within ``deadline_s`` —
    the route-convergence bound: trigger = confirmed transitions, done
    = route pushes, deadline = the supervisor's configured convergence
    budget."""

    def __init__(self, name: str, trigger_fn: Callable[[], int],
                 done_fn: Callable[[], int], deadline_s: float):
        super().__init__(name)
        self._trigger_fn = trigger_fn
        self._done_fn = done_fn
        self.deadline_s = float(deadline_s)
        self._pending: List[Tuple[int, float]] = []  # (count, t_seen)
        self._seen = 0

    def _check(self, t_s: float, *, draining: bool) -> None:
        trig = int(self._trigger_fn())
        while self._seen < trig:
            self._seen += 1
            self._pending.append((self._seen, t_s))
        done = int(self._done_fn())
        still = []
        for count, t_seen in self._pending:
            if done >= count:
                continue
            if draining or t_s - t_seen > self.deadline_s:
                self._fail(
                    t_s,
                    f"trigger #{count} (t={t_seen:.3f}s) unanswered "
                    f"after {t_s - t_seen:.3f}s (deadline "
                    f"{self.deadline_s}s)",
                )
            else:
                still.append((count, t_seen))
        self._pending = still

    def sample(self, t_s: float) -> None:
        self._check(t_s, draining=False)

    def finish(self, t_s: float) -> None:
        self._check(t_s, draining=True)


# ----------------------------------------------------------------------
# the runner


@dataclasses.dataclass(frozen=True)
class ChaosReport:
    """What :func:`run_schedule` returns: the fired event log, every
    checker violation, and the wall duration. ``ok`` is the single
    assertion a chaos test makes."""

    fired: Tuple[Tuple[float, str], ...]
    violations: Tuple[ChaosViolation, ...]
    duration_s: float

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        lines = [
            f"chaos: {len(self.fired)} events over "
            f"{self.duration_s:.3f}s, "
            f"{len(self.violations)} violation(s)"
        ]
        for v in self.violations:
            lines.append(f"  [{v.t_s:8.3f}s] {v.invariant}: {v.message}")
        return "\n".join(lines)


def run_schedule(schedule: ChaosSchedule, *, duration_s: float,
                 invariants: Sequence[Invariant] = (),
                 tick: Optional[Callable[[float], None]] = None,
                 check_interval_s: float = 0.005,
                 clock=time.monotonic, sleep=time.sleep) -> ChaosReport:
    """Fire the schedule's events at their offsets while sampling every
    invariant continuously; after the last event (and at least
    ``duration_s``), run the finish checks and return the report.

    ``tick(t_s)`` (optional) runs between samples — the hook a
    deterministic test uses to drive ``supervisor.step()`` and the load
    loop from the runner thread instead of background threads. Events
    fire replay-style: never early; when the runner falls behind, due
    events fire back-to-back in schedule order (offsets, not absolute
    times, so a paused host skews the whole script uniformly)."""
    errors.expects(duration_s > 0.0,
                   "run_schedule: duration_s=%s <= 0", duration_s)
    events = schedule.events
    end_s = max([duration_s] + [e.at_s for e in events])
    fired: List[Tuple[float, str]] = []
    t0 = clock()
    i = 0
    while True:
        now_s = clock() - t0
        while i < len(events) and events[i].at_s <= now_s:
            events[i].fire()
            fired.append((now_s, events[i].name))
            i += 1
        if tick is not None:
            tick(now_s)
        for inv in invariants:
            inv.sample(now_s)
        if i >= len(events) and now_s >= end_s:
            break
        # sleep to the earlier of: next event, next check tick
        next_at = events[i].at_s if i < len(events) else end_s
        sleep(max(0.0, min(check_interval_s, next_at - now_s)))
    final_s = clock() - t0
    for inv in invariants:
        inv.finish(final_s)
    violations = tuple(
        v for inv in invariants for v in inv.violations
    )
    return ChaosReport(fired=tuple(fired), violations=violations,
                       duration_s=final_s)
