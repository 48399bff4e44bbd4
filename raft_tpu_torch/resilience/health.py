"""Shard health tracking and communicator health checks — the port of
``raft_tpu/resilience/health.py``.

:class:`ShardHealth` is the host-side per-rank validity mask the
degraded sharded searches take (``mnmg_ivf_flat_search(...,
shard_mask=)``); :class:`HealthMonitor` debounces raw observations; and
:func:`health_check` times each communicator self-test
(:data:`raft_tpu_torch.comms.self_test.SELF_TESTS`) and records a probe
that raises as a failure — the liveness probe a serving loop runs
between batches. Rank-level downs come from external signals through
``mark_down``. The mask is a runtime operand of the search: flipping a
rank's health changes values, never the code path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "ShardHealth",
    "HealthMonitor",
    "HealthProbe",
    "HealthReport",
    "health_check",
]

# health-transition telemetry: every
# ACTUAL up/down flip counts (idempotent re-marks do not), and the
# up-rank gauge tracks the most recently flipped tracker — the
# failover-flip signal an alert watches next to
# ``failover_rerouted_shards`` (resilience/replica.py)
_reg = obs_metrics.default_registry()
_M_FLIPS = {
    "down": _reg.counter("health_transitions_total", direction="down"),
    "up": _reg.counter("health_transitions_total", direction="up"),
}
_G_RANKS_UP = _reg.gauge("health_ranks_up")
del _reg


class ShardHealth:
    """Host-side per-rank up/down tracker (thread-safe).

    ``mask()`` snapshots the per-rank validity as an int32 ``(P,)``
    array — 1 = up, 0 = down — in exactly the form the degraded sharded
    searches take as their ``shard_mask`` runtime input.
    """

    def __init__(self, n_ranks: int, *, telemetry: bool = True):
        errors.expects(n_ranks >= 1, "ShardHealth: n_ranks=%d < 1", n_ranks)
        self._lock = lockcheck.make_lock("ShardHealth._lock")
        self._up = np.ones(n_ranks, dtype=bool)
        # `telemetry=False` is for THROWAWAY trackers (the
        # resolve_shard_mask HealthReport normalization builds one per
        # search call): only a long-lived tracker may drive the global
        # flip counters/gauge, or steady degraded traffic would count
        # one fake "flip" per call and whipsaw the gauge
        self._telemetry = bool(telemetry)
        if self._telemetry:
            # seed the gauge at construction: a fresh tracker is
            # all-up, and a scrape before the first flip must not read
            # the gauge's 0.0 initial value as a total outage
            _G_RANKS_UP.set(n_ranks)

    @property
    def n_ranks(self) -> int:
        # .shape is immutable metadata of an array that is only ever
        # mutated in place, never rebound — safe to read unlocked
        return self._up.shape[0]

    def _check_rank(self, rank: int) -> None:
        errors.expects(   # .shape reads: immutable metadata, see n_ranks
            0 <= rank < self._up.shape[0],
            "ShardHealth: rank %d out of range [0, %d)",
            rank, self._up.shape[0],
        )

    def mark_down(self, rank: int) -> None:
        """Record an external down signal for ``rank`` (idempotent)."""
        self._check_rank(rank)
        with self._lock:
            flipped = bool(self._up[rank])
            self._up[rank] = False
            if flipped and self._telemetry:
                # gauge write INSIDE the lock: two concurrent flips
                # must apply their counts in flip order, or the gauge
                # holds the stale value until the next transition
                # (gauge locks are leaves — no ordering hazard)
                _M_FLIPS["down"].inc()
                _G_RANKS_UP.set(int(self._up.sum()))

    def mark_up(self, rank: int) -> None:
        """Record recovery of ``rank`` (idempotent)."""
        self._check_rank(rank)
        with self._lock:
            flipped = not bool(self._up[rank])
            self._up[rank] = True
            if flipped and self._telemetry:
                _M_FLIPS["up"].inc()
                _G_RANKS_UP.set(int(self._up.sum()))

    def is_up(self, rank: int) -> bool:
        self._check_rank(rank)
        with self._lock:
            return bool(self._up[rank])

    @property
    def n_up(self) -> int:
        with self._lock:
            return int(self._up.sum())

    @property
    def all_up(self) -> bool:
        with self._lock:
            return bool(self._up.all())

    def apply_report(self, report: "HealthReport") -> "ShardHealth":
        """Fold a :class:`HealthReport` into the tracker: every rank
        implicated by a FAILED probe is marked down — a failed probe
        carrying rank attribution (``HealthProbe.ranks``, e.g. a
        per-rank heartbeat sweep) downs exactly those ranks; one with
        no attribution downs EVERY rank, because a collective that
        cannot round-trip means no sharded program can run at all. Passing
        probes mark nothing up (recovery of an externally-downed rank
        is the external system's call — flip it back with ``mark_up``
        after :func:`raft_tpu_torch.comms.mnmg_ivf.recover_rank`). Returns
        ``self``, so the health-check → mask pipeline is one
        expression: ``health.apply_report(report).mask()``."""
        for probe in report.probes.values():
            if probe.ok:
                continue
            ranks = probe.ranks or tuple(range(self.n_ranks))
            for r in ranks:
                self.mark_down(r)
        return self

    def mask(self) -> np.ndarray:
        """Snapshot the validity mask as int32 ``(P,)`` (1 = up)."""
        with self._lock:
            return self._up.astype(np.int32)

    def __repr__(self) -> str:  # compact operator-facing summary
        with self._lock:
            down = np.nonzero(~self._up)[0].tolist()
        return (
            f"ShardHealth(n_ranks={self.n_ranks}, "
            f"down={down if down else 'none'})"
        )


class HealthMonitor:
    """Flap suppression for raw per-rank health observations
    (thread-safe): the ONE debounce spelling shared by the
    serving supervisor and
    manual health loops, with the same discipline as the SLO profile
    trigger (:mod:`raft_tpu_torch.obs.capture`): ``consecutive`` contradicting
    observations confirm a transition, and ``cooldown_s`` of hysteresis
    after each confirmed flip bounds how often a rank may change state
    no matter how hard the probe oscillates.

    ``observe(rank, up)`` folds one raw observation and returns
    ``"down"`` / ``"up"`` exactly when it CONFIRMS a transition (else
    ``None``) — the caller acts only on that edge, so an oscillating
    probe produces at most one action per cooldown window. The clock is
    injectable for deterministic tests. Confirmed flips count in
    ``health_transitions_total{rank,direction}`` (the rank-attributed
    companion of the :class:`ShardHealth` direction-only series).
    """

    def __init__(self, n_ranks: int, *, consecutive: int = 3,
                 cooldown_s: float = 1.0, clock=time.monotonic,
                 telemetry: bool = True):
        errors.expects(n_ranks >= 1,
                       "HealthMonitor: n_ranks=%d < 1", n_ranks)
        errors.expects(consecutive >= 1,
                       "HealthMonitor: consecutive=%d < 1", consecutive)
        self.consecutive = int(consecutive)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._telemetry = bool(telemetry)
        self._lock = lockcheck.make_lock("HealthMonitor._lock")
        self._confirmed = np.ones(n_ranks, dtype=bool)
        self._streak = np.zeros(n_ranks, dtype=np.int64)
        # last confirmed flip per rank; -inf so the first transition is
        # never cooldown-suppressed
        self._last_flip = np.full(n_ranks, -np.inf, dtype=np.float64)
        self._transitions = 0
        self._counters: Dict[Tuple[int, str], object] = {}

    @property
    def n_ranks(self) -> int:
        # immutable array metadata, see ShardHealth.n_ranks
        return self._confirmed.shape[0]

    def _check_rank(self, rank: int) -> None:
        errors.expects(   # .shape reads: immutable metadata
            0 <= rank < self.n_ranks,
            "HealthMonitor: rank %d out of range [0, %d)",
            rank, self.n_ranks,
        )

    def _count_flip(self, rank: int, direction: str) -> None:
        key = (rank, direction)
        c = self._counters.get(key)
        if c is None:
            reg = obs_metrics.default_registry()
            c = reg.counter("health_transitions_total",
                            rank=rank, direction=direction)
            self._counters[key] = c
        c.inc()

    def observe(self, rank: int, up: bool) -> Optional[str]:
        """Fold one raw observation; return ``"down"``/``"up"`` iff it
        confirms a transition, else ``None``.

        A transition confirms when ``consecutive`` back-to-back
        observations contradict the confirmed state AND ``cooldown_s``
        has elapsed since that rank's last confirmed flip. A
        cooldown-suppressed streak is KEPT (not reset), so a contradiction
        that persists through the window flips on the first observation
        after it expires."""
        self._check_rank(rank)
        up = bool(up)
        with self._lock:
            if up == bool(self._confirmed[rank]):
                self._streak[rank] = 0
                return None
            self._streak[rank] += 1
            if self._streak[rank] < self.consecutive:
                return None
            now = float(self._clock())
            if now - float(self._last_flip[rank]) < self.cooldown_s:
                return None  # hysteresis: streak kept, flip deferred
            self._confirmed[rank] = up
            self._streak[rank] = 0
            self._last_flip[rank] = now
            self._transitions += 1
            direction = "up" if up else "down"
            if self._telemetry:
                # counter write inside the lock, same rationale as
                # ShardHealth.mark_down (flip-ordered counts)
                self._count_flip(rank, direction)
        return direction

    def observe_report(self, report: "HealthReport") -> Dict[int, str]:
        """Fold a :class:`HealthReport` sweep as DOWN observations for
        every implicated rank, mirroring ``ShardHealth.apply_report``
        (failed attributed probes down their ranks; an unattributed
        failure implicates every rank; passing probes observe nothing —
        up-observations need a positive per-rank signal via
        :meth:`observe`). Returns ``{rank: direction}`` for the
        transitions this sweep confirmed."""
        implicated: set = set()
        for probe in report.probes.values():
            if probe.ok:
                continue
            implicated.update(probe.ranks or range(self.n_ranks))
        out: Dict[int, str] = {}
        for r in sorted(implicated):
            d = self.observe(r, False)
            if d is not None:
                out[r] = d
        return out

    def is_up(self, rank: int) -> bool:
        """The CONFIRMED (debounced) state of ``rank``."""
        self._check_rank(rank)
        with self._lock:
            return bool(self._confirmed[rank])

    def force(self, rank: int, up: bool) -> None:
        """Pin the confirmed state WITHOUT counting a transition — the
        supervisor's rollback hook: after a failed heal it forces the
        rank back to confirmed-down so only a fresh sustained up-streak
        (post-cooldown) re-triggers reintegration."""
        self._check_rank(rank)
        with self._lock:
            self._confirmed[rank] = bool(up)
            self._streak[rank] = 0
            self._last_flip[rank] = float(self._clock())

    @property
    def transition_count(self) -> int:
        """Total confirmed transitions — the flap-invariant bound
        (route pushes per supervisor must never exceed it)."""
        with self._lock:
            return int(self._transitions)

    def __repr__(self) -> str:
        with self._lock:
            down = np.nonzero(~self._confirmed)[0].tolist()
        return (
            f"HealthMonitor(n_ranks={self.n_ranks}, "
            f"consecutive={self.consecutive}, "
            f"cooldown_s={self.cooldown_s}, "
            f"down={down if down else 'none'})"
        )


@dataclasses.dataclass(frozen=True)
class HealthProbe:
    """One probe's result: pass/fail + wall time.

    ``ranks`` optionally attributes a FAILURE to specific ranks (a
    per-rank heartbeat/liveness probe); empty means the probe speaks
    for the whole group — :meth:`ShardHealth.apply_report` downs every
    rank on an unattributed failure. The collective self-test sweep
    (:func:`health_check`) emits unattributed probes."""

    ok: bool
    seconds: float
    ranks: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """The full self-test sweep with per-collective timings.

    ``probes`` maps collective name → :class:`HealthProbe`; ``ok`` is
    the conjunction. Timings include trace+compile on a cold program —
    run one warm-up sweep at bring-up if you alert on latency.
    """

    probes: Dict[str, HealthProbe]

    @property
    def ok(self) -> bool:
        return all(p.ok for p in self.probes.values())

    @property
    def failed(self) -> list:
        return sorted(n for n, p in self.probes.items() if not p.ok)

    @property
    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.probes.values())


def health_check(comms, *, health: Optional[ShardHealth] = None,
                 raise_on_failure: bool = False) -> HealthReport:
    """Run the communicator round-trip self-tests with per-collective
    timings — the serving loop's fabric liveness probe.

    Wraps :data:`raft_tpu_torch.comms.self_test.SELF_TESTS` (the
    registry behind ``run_all_self_tests``), timing each collective's round trip
    individually. A probe that RAISES (a collective error from a torn
    group) is recorded as failed, not propagated — the report is the
    failure signal.

    ``health``: when a sweep fails, every rank is marked down on the
    tracker — a collective that cannot round-trip means the sharded program
    cannot run at all, so no shard is servable until the group is rebuilt
    (rank-granular downs come from external signals via ``mark_down``).
    A PASSING sweep does NOT mark anything up: recovery of an
    externally-downed rank is the external system's call.

    ``raise_on_failure=True`` raises :class:`raft_tpu_torch.errors.RaftException`
    listing the failed collectives instead of returning the report.
    """
    from raft_tpu_torch.comms.self_test import SELF_TESTS

    probes: Dict[str, HealthProbe] = {}
    for name, fn in SELF_TESTS.items():
        t0 = time.perf_counter()
        try:
            ok = bool(fn(comms))
        except Exception:  # torn group: the failure IS the signal
            ok = False
        probes[name] = HealthProbe(ok=ok, seconds=time.perf_counter() - t0)
    report = HealthReport(probes=probes)
    if health is not None:
        # unattributed collective failures down every rank (see
        # ShardHealth.apply_report); a passing sweep marks nothing up
        health.apply_report(report)
    if raise_on_failure and not report.ok:
        raise errors.RaftException(
            f"health_check: collectives failed round-trip: {report.failed}"
        )
    return report
