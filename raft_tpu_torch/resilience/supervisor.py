"""Self-healing serving supervisor: detect → reroute → resync →
reintegrate, with no operator in the loop — the port of
``raft_tpu/resilience/supervisor.py`` (pure host code: threads, locks,
metrics; nothing in it touches a device).

Every recovery primitive is a hand-callable — ``health_check`` probes
the communicator, :class:`ShardHealth` masks a dead rank out of the
sharded searches, ``FailoverPlan.load_balanced`` reroutes its shards to
live replicas, ``recover_rank`` splices its main slabs back from a
checkpoint, ``resync_rank`` catches its mutation state up from a donor
replica, ``TieredListStore.sync_mutations`` re-syncs the cold tier.
:class:`ServingSupervisor` is the background control loop that runs the
choreography itself (the reference lineage has no analog —
``raft::comms`` exposes health state but nothing watches it):

- **Detect.** Each tick runs the injected ``probe`` (a
  :func:`~raft_tpu_torch.resilience.health.health_check` sweep, a heartbeat
  table, or a scripted truth in tests) and folds the raw per-rank
  observations through a :class:`~raft_tpu_torch.resilience.health.HealthMonitor`
  — N-consecutive confirm + cooldown hysteresis, the same debounce
  discipline everywhere in the serving tier — so a flapping probe cannot
  whipsaw the route.
- **Reroute.** A confirmed DOWN marks the rank on the shared
  :class:`ShardHealth`, recomputes a load-balanced
  :class:`~raft_tpu_torch.resilience.replica.FailoverPlan`, and
  atomically pushes ``shard_mask`` + ``failover`` into every registered
  :class:`~raft_tpu_torch.serving.executor.ServingExecutor` via
  ``set_runtime``. Both are runtime operands of the sharded searches'
  rank body, so a push changes values, never the code path.
- **Reintegrate.** A confirmed UP drives the heal pipeline as a
  RESUMABLE per-rank state machine — QUARANTINED → RECOVERING (WAL
  tail replay) → RESYNCING (recover + resync) → WARMING (tier sync +
  warm) → SERVING — each step under its own deadline with
  :class:`~raft_tpu_torch.resilience.deadline.RetryPolicy`
  backoff; a step that exhausts its budget rolls the rank back to
  QUARANTINED (optional ``rollback`` hook first), keeps the
  routed-around plan serving, and re-arms the monitor so only a fresh
  confirmed up-streak retries. Completed steps are remembered, so a
  supervisor restart (or a crash surfaced through
  ``thread_uncaught_total``) resumes mid-pipeline instead of replaying
  side-effectful steps.

Every transition emits metrics (``supervisor_state{rank}``,
``supervisor_route_pushes_total``, ``supervisor_heals_total{outcome}``)
and flight events. What the supervisor will NOT do: change topology
(grow/shrink the mesh is the elastic checkpoint path), rebuild indexes,
or tune serving knobs — it only actuates routes and the heal pipeline
over a FIXED placement.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import crash as obs_crash
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.resilience.deadline import Deadline, RetryPolicy
from raft_tpu_torch.resilience.health import (
    HealthMonitor,
    HealthReport,
    ShardHealth,
)
from raft_tpu_torch.resilience.replica import FailoverPlan, ReplicaPlacement

__all__ = [
    "HealActions",
    "ServingSupervisor",
    "SupervisorStats",
    "STATE_SERVING",
    "STATE_QUARANTINED",
    "STATE_RECOVERING",
    "STATE_RESYNCING",
    "STATE_WARMING",
]

# the per-rank reintegration state machine: QUARANTINED is the routed-
# around steady state of a down rank; RECOVERING covers durable-state
# replay (WAL tail past the checkpoint watermark); RESYNCING covers the data-plane splice (checkpoint
# recover + mutation-delta resync); WARMING covers bring-back
# validation (tier journal sync + program warm); SERVING is healthy.
# Encoded in the supervisor_state gauge as 0/1/2/3/4.
STATE_SERVING = "serving"
STATE_QUARANTINED = "quarantined"
STATE_RESYNCING = "resyncing"
STATE_WARMING = "warming"
STATE_RECOVERING = "recovering"
_STATE_CODE = {
    STATE_SERVING: 0,
    STATE_QUARANTINED: 1,
    STATE_RESYNCING: 2,
    STATE_WARMING: 3,
    STATE_RECOVERING: 4,
}

# the ordered heal pipeline; each step maps to the state the rank shows
# while it runs. Steps with no configured action are skipped (and still
# recorded as done, so resume semantics stay simple). WAL replay runs
# FIRST: the rank's durable mutation state must be current before the
# peer resync diffs against it (and before tier sync reads its epochs).
_HEAL_STEPS: Tuple[Tuple[str, str], ...] = (
    ("replay_wal", STATE_RECOVERING),
    ("recover", STATE_RESYNCING),
    ("resync", STATE_RESYNCING),
    ("sync_tier", STATE_WARMING),
    ("warm", STATE_WARMING),
)


@dataclasses.dataclass
class HealActions:
    """The reintegration actuators, injected so the supervisor stays
    decoupled from index specifics. Each is ``fn(rank) -> None`` (or
    ``None`` to skip the step): ``replay_wal`` replays the rank's
    durable WAL tail past the checkpoint watermark
    (:func:`~raft_tpu_torch.durability.wal.recover_mutable` /
    :func:`~raft_tpu_torch.comms.mnmg_mutation.mnmg_recover` — runs
    FIRST, under the RECOVERING state), ``recover`` splices the rank's
    main slabs back (:func:`~raft_tpu_torch.comms.mnmg_ivf.recover_rank`
    from the latest checkpoint), ``resync`` catches its mutation state
    up from a donor replica
    (:func:`~raft_tpu_torch.comms.mnmg_mutation.resync_rank`),
    ``sync_tier`` replays the tier journal
    (``TieredListStore.sync_mutations``), ``warm`` runs any bring-back
    validation (a healthy-mask probe search). ``rollback`` runs once
    when a step exhausts its retry/deadline budget, BEFORE the rank
    drops back to QUARANTINED — undo partial effects there (e.g. restore
    the pre-splice index cell)."""

    recover: Optional[Callable[[int], None]] = None
    resync: Optional[Callable[[int], None]] = None
    sync_tier: Optional[Callable[[int], None]] = None
    warm: Optional[Callable[[int], None]] = None
    rollback: Optional[Callable[[int], None]] = None
    replay_wal: Optional[Callable[[int], None]] = None


@dataclasses.dataclass(frozen=True)
class SupervisorStats:
    """Snapshot of the control loop's lifetime counts + per-rank
    states (strings from the STATE_* constants)."""

    ticks: int
    route_pushes: int
    heals_ok: int
    heals_rolled_back: int
    states: Dict[int, str]
    last_push_t: Optional[float]


class ServingSupervisor:
    """Background detect→reroute→resync→reintegrate control loop.

    ``probe`` is called once per tick and returns either a
    ``{rank: up}`` mapping (a heartbeat sweep; in tests a scripted
    truth) or a :class:`HealthReport` (down-attribution only — see
    :meth:`HealthMonitor.observe_report`). Confirmed transitions
    actuate the shared ``health`` tracker, push a fresh load-balanced
    route into every registered executor, and (on up) drive the heal
    pipeline. ``step()`` runs ONE tick synchronously — deterministic
    tests drive it directly with an injectable clock; ``start()`` runs
    it on a daemon thread routed through the crash excepthook, so an
    uncaught supervisor bug surfaces in ``thread_uncaught_total`` and
    ``start()`` can simply be called again (state, including mid-heal
    progress, lives on the object, not the thread).

    Lock discipline: ``ServingSupervisor._lock`` guards only the
    supervisor's own bookkeeping (states, heal progress, counters).
    Probes, health/monitor updates, route pushes, and heal actions all
    run OUTSIDE it — they take their own locks (``ShardHealth._lock``,
    ``ServingExecutor._lock``, ...), keeping the lock-order graph a
    tree rooted here.
    """

    def __init__(self, health: ShardHealth, placement: ReplicaPlacement,
                 probe: Callable[[], Any], *,
                 heal: Optional[HealActions] = None,
                 monitor: Optional[HealthMonitor] = None,
                 interval_s: float = 0.25,
                 step_deadline_s: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 load: Optional[Callable[[], Any]] = None,
                 registry=None, flight=None, name: str = "supervisor",
                 clock=time.monotonic, sleep=time.sleep):
        errors.expects(interval_s > 0.0,
                       "ServingSupervisor: interval_s=%s <= 0", interval_s)
        self.health = health
        self.placement = placement
        self.heal = heal or HealActions()
        self.monitor = monitor or HealthMonitor(
            health.n_ranks, clock=clock
        )
        errors.expects(
            self.monitor.n_ranks == health.n_ranks,
            "ServingSupervisor: monitor ranks %d != health ranks %d",
            self.monitor.n_ranks, health.n_ranks,
        )
        self.interval_s = float(interval_s)
        self.step_deadline_s = float(step_deadline_s)
        self.retry = retry or RetryPolicy()
        self.name = name
        self._probe = probe
        self._load = load
        self._registry = registry or obs_metrics.default_registry()
        self._flight = flight
        self._clock = clock
        self._sleep = sleep

        self._lock = lockcheck.make_lock("ServingSupervisor._lock")
        self._executors: List[Any] = []
        self._state: Dict[int, str] = {
            r: STATE_SERVING for r in range(health.n_ranks)
        }
        # index into _HEAL_STEPS of the next step to run per healing
        # rank — the resume cursor; absent = not healing
        self._heal_cursor: Dict[int, int] = {}
        self._timeline: List[Tuple[float, str, int]] = []
        self._ticks = 0
        self._route_pushes = 0
        self._heals_ok = 0
        self._heals_rolled_back = 0
        self._last_push_t: Optional[float] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None

        reg = self._registry
        self._c_pushes = reg.counter("supervisor_route_pushes_total")
        self._c_heals = {
            "ok": reg.counter("supervisor_heals_total", outcome="ok"),
            "rolled_back": reg.counter("supervisor_heals_total",
                                       outcome="rolled_back"),
        }
        self._g_state = {
            r: reg.gauge("supervisor_state", rank=r)
            for r in range(health.n_ranks)
        }
        # a crash in the loop thread must surface, not vanish
        obs_crash.install_excepthook()

    # ------------------------------------------------------------------
    # registration + introspection

    def register(self, executor) -> None:
        """Add an executor to the route-push fanout. Its runtime is
        synced to the CURRENT plan immediately, so an executor that
        joins after a failover serves the degraded route at once."""
        with self._lock:
            if executor not in self._executors:
                self._executors.append(executor)
        self._push_route(reason="register")

    def unregister(self, executor) -> None:
        with self._lock:
            if executor in self._executors:
                self._executors.remove(executor)

    def state(self, rank: int) -> str:
        with self._lock:
            return self._state[rank]

    def stats(self) -> SupervisorStats:
        with self._lock:
            return SupervisorStats(
                ticks=self._ticks,
                route_pushes=self._route_pushes,
                heals_ok=self._heals_ok,
                heals_rolled_back=self._heals_rolled_back,
                states=dict(self._state),
                last_push_t=self._last_push_t,
            )

    def timeline(self) -> List[Tuple[float, str, int]]:
        """Chronological ``(t, event, rank)`` records (supervisor clock;
        rank -1 for rank-less events) — what the self-heal bench row
        reads detection/convergence/reintegration stamps from."""
        with self._lock:
            return list(self._timeline)

    def _mark(self, event: str, rank: int = -1) -> None:
        t = float(self._clock())
        with self._lock:
            self._timeline.append((t, event, rank))
        if self._flight is not None:
            self._flight.record(f"supervisor_{event}", rank=rank)

    # ------------------------------------------------------------------
    # the control loop

    def step(self) -> Dict[int, str]:
        """Run ONE tick synchronously: probe → debounce → actuate.
        Returns the transitions this tick confirmed ({rank: dir}) —
        the deterministic-test entry point (no thread needed)."""
        with self._lock:
            self._ticks += 1
        observations = self._observations(self._probe())
        transitions: Dict[int, str] = {}
        for rank, up in sorted(observations.items()):
            d = self.monitor.observe(rank, up)
            if d is not None:
                transitions[rank] = d
        for rank, d in transitions.items():
            if d == "down":
                self._on_confirmed_down(rank)
            else:
                self._on_confirmed_up(rank)
        self._advance_heals()
        return transitions

    def _observations(self, raw) -> Dict[int, bool]:
        if isinstance(raw, HealthReport):
            implicated: set = set()
            for probe in raw.probes.values():
                if not probe.ok:
                    implicated.update(
                        probe.ranks or range(self.health.n_ranks)
                    )
            return {r: False for r in implicated}
        if isinstance(raw, Mapping):
            return {int(r): bool(u) for r, u in raw.items()}
        raise errors.RaftException(
            "ServingSupervisor: probe must return a {rank: up} mapping "
            f"or a HealthReport, got {type(raw).__name__}"
        )

    def _set_state(self, rank: int, state: str) -> None:
        with self._lock:
            prev = self._state[rank]
            self._state[rank] = state
        self._g_state[rank].set(_STATE_CODE[state])
        if self._flight is not None and prev != state:
            self._flight.record("supervisor_transition", rank=rank,
                                prev=prev, state=state)

    def _on_confirmed_down(self, rank: int) -> None:
        self._mark("confirmed_down", rank)
        self.health.mark_down(rank)
        # a rank that dies mid-heal abandons the pipeline: the next
        # confirmed up restarts it from the top (completed splices are
        # stale once the rank went down again)
        with self._lock:
            self._heal_cursor.pop(rank, None)
        self._set_state(rank, STATE_QUARANTINED)
        self._push_route(reason="confirmed_down", rank=rank)

    def _on_confirmed_up(self, rank: int) -> None:
        self._mark("confirmed_up", rank)
        with self._lock:
            if self._state[rank] == STATE_SERVING:
                return  # spurious: already serving
            # resume cursor survives a supervisor restart/crash; a
            # fresh heal starts at step 0
            self._heal_cursor.setdefault(rank, 0)

    def _advance_heals(self) -> None:
        with self._lock:
            healing = sorted(self._heal_cursor)
        for rank in healing:
            self._heal(rank)

    def _heal(self, rank: int) -> None:
        self._mark("heal_started", rank)
        while True:
            with self._lock:
                cursor = self._heal_cursor.get(rank)
            if cursor is None:  # rank went down again mid-pipeline
                return
            if cursor >= len(_HEAL_STEPS):
                break
            step_name, state = _HEAL_STEPS[cursor]
            self._set_state(rank, state)
            fn = getattr(self.heal, step_name)
            if fn is not None and not self._run_heal_step(
                rank, step_name, fn
            ):
                self._rollback(rank, step_name)
                return
            with self._lock:
                # re-check: a concurrent confirmed_down may have
                # aborted the pipeline while the step ran
                if rank in self._heal_cursor:
                    self._heal_cursor[rank] = cursor + 1
        with self._lock:
            self._heal_cursor.pop(rank, None)
        self.health.mark_up(rank)
        self._set_state(rank, STATE_SERVING)
        with self._lock:
            self._heals_ok += 1
        self._c_heals["ok"].inc()
        self._mark("heal_done", rank)
        self._push_route(reason="heal_done", rank=rank)

    def _run_heal_step(self, rank: int, step_name: str, fn) -> bool:
        """One pipeline step under its deadline + retry budget. The
        deadline is COOPERATIVE: it bounds whether another attempt may
        start (and clips backoff sleeps), it cannot preempt a hung host
        call — size step_deadline_s for the slowest legitimate splice."""
        deadline = Deadline.after(self.step_deadline_s)
        attempt = 0
        while True:
            attempt += 1
            try:
                fn(rank)
                if self._flight is not None:
                    self._flight.record("supervisor_heal_step", rank=rank,
                                        step=step_name, attempt=attempt,
                                        ok=True)
                return True
            except Exception as exc:
                if self._flight is not None:
                    self._flight.record(
                        "supervisor_heal_step", rank=rank, step=step_name,
                        attempt=attempt, ok=False,
                        error=f"{type(exc).__name__}: {exc}"[:160],
                    )
                if (attempt >= self.retry.max_attempts
                        or not self.retry.is_retryable(exc)
                        or deadline.expired()):
                    return False
                self._sleep(min(self.retry.backoff_s(attempt),
                                deadline.remaining()))

    def _rollback(self, rank: int, failed_step: str) -> None:
        """Partial-failure path: undo hook, back to QUARANTINED (the
        routed-around plan keeps serving), re-arm the monitor so only a
        fresh confirmed up-streak retries — from step 0, because a
        failed splice invalidates its predecessors."""
        if self.heal.rollback is not None:
            try:
                self.heal.rollback(rank)
            except Exception as exc:  # rollback must never kill the loop
                if self._flight is not None:
                    self._flight.record(
                        "supervisor_rollback_error", rank=rank,
                        error=f"{type(exc).__name__}: {exc}"[:160],
                    )
        with self._lock:
            self._heal_cursor.pop(rank, None)
            self._heals_rolled_back += 1
        self._c_heals["rolled_back"].inc()
        self.monitor.force(rank, up=False)
        self._set_state(rank, STATE_QUARANTINED)
        self._mark("heal_rolled_back", rank)
        if self._flight is not None:
            self._flight.record("supervisor_heal_rolled_back", rank=rank,
                                step=failed_step)

    def _push_route(self, *, reason: str, rank: int = -1) -> None:
        """Recompute the load-balanced plan and atomically swap it into
        every registered executor. shard_mask + failover are runtime
        operands of the rank body: a push changes values only."""
        plan = FailoverPlan.load_balanced(
            self.placement, self.health,
            self._load() if self._load is not None else None,
            registry=self._registry,
        )
        mask = self.health.mask()
        with self._lock:
            executors = list(self._executors)
        for ex in executors:
            ex.set_runtime(shard_mask=mask, failover=plan)
        with self._lock:
            self._route_pushes += 1
            self._last_push_t = float(self._clock())
        self._c_pushes.inc()
        self._mark("route_pushed", rank)
        if self._flight is not None:
            self._flight.record(
                "supervisor_route_push", rank=rank, reason=reason,
                route=[int(r) for r in plan.route],
                n_executors=len(executors),
            )

    # ------------------------------------------------------------------
    # the thread

    def start(self) -> None:
        """Start (or RESTART) the background loop. Idempotent while the
        thread is alive; after a crash — surfaced through the installed
        excepthook as ``thread_uncaught_total{thread=<name>}`` — calling
        ``start()`` again spawns a fresh thread that resumes from the
        object's state, including any mid-heal cursor."""
        with self._lock:
            self._closed = False
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._watch, name=self.name, daemon=True
            )
            thread = self._thread
        thread.start()

    def _watch(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            # deliberately NOT wrapped in try/except: an uncaught bug
            # here must hit the crash excepthook (counted + flight-
            # recorded), not be silently swallowed into a zombie loop
            self.step()
            self._sleep(self.interval_s)

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)

    def __repr__(self) -> str:
        s = self.stats()
        down = sorted(r for r, st in s.states.items()
                      if st != STATE_SERVING)
        return (
            f"ServingSupervisor(name={self.name!r}, ticks={s.ticks}, "
            f"pushes={s.route_pushes}, heals_ok={s.heals_ok}, "
            f"rolled_back={s.heals_rolled_back}, "
            f"not_serving={down if down else 'none'})"
        )
