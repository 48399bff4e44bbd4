"""The async host-to-device slab fetcher — the port of
``raft_tpu/tier/fetch.py``: promotion traffic kept off the serving path,
a bounded in-flight window, every fetch a span in the flight recorder.

A serving miss (:meth:`TieredListStore.search` probing a cold list)
costs nothing on the dispatch path — the query is answered from the hot
lists it hit, and the cold list id lands in this fetcher's bounded
queue. The fetcher thread drains up to ``window`` requests per cycle,
picks a slot for each (a free one, else the policy's coldest victim —
hysteresis lives in :class:`~raft_tpu_torch.tier.policy.PromotionPolicy`),
and runs the store's install transaction: ``non_blocking`` copies from
the pinned host slab on the store's copy stream, then the publish.
``busy_fn`` (e.g. ``lambda: executor.stats().in_flight > 0``) stamps
which fetch spans overlapped serving — the bench's
``fetch_overlap_pct``.

Bounds: the queue holds at most ``max_pending`` distinct list ids
(already-hot and already-queued ids dedup; overflow is DROPPED and
counted — a miss storm must shed fill work, not grow a queue), and at
most ``window`` slabs are installed per cycle.

A failed copy or install raises in the worker: it is counted in
``tier_fetcher_restarts_total`` and the loop restarts, up to
``max_restarts``; then the worker gives up (fill sink detached, a flight
event, the exception surfaced through ``thread_uncaught_total``). It is
never swallowed into a silent miss.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import crash as obs_crash
from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = ["SlabFetcher"]


class SlabFetcher:
    """The background promotion worker of one
    :class:`~raft_tpu_torch.tier.store.TieredListStore`.

    ``policy``: optional
    :class:`~raft_tpu_torch.tier.policy.PromotionPolicy` consulted when
    the hot set is full — it nominates a victim only when the
    candidate's measured load beats the victim's by its hysteresis
    margin, so a one-off probe never thrashes a hot list. Without a
    policy, a full hot set drops fill requests (counted).

    ``busy_fn``: sampled at each fetch's start and end; True either
    time marks the span compute-overlapped.
    """

    def __init__(self, store, *, window: int = 2,
                 max_pending: Optional[int] = None,
                 policy=None,
                 busy_fn: Optional[Callable[[], bool]] = None,
                 name: Optional[str] = None,
                 max_restarts: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        errors.expects(window >= 1, "SlabFetcher: window=%d < 1", window)
        errors.expects(max_restarts >= 0,
                       "SlabFetcher: max_restarts=%d < 0", max_restarts)
        self.store = store
        self.window = int(window)
        self.max_pending = (4 * store.n_slots if max_pending is None
                            else int(max_pending))
        self.policy = policy
        self._busy_fn = busy_fn
        self.name = name or f"{store.name}-fetch"
        self.max_restarts = int(max_restarts)
        self._clock = clock
        self._lock = lockcheck.make_lock("SlabFetcher._lock")
        self._work = lockcheck.make_condition(self._lock)
        self._queue: list = []        # FIFO of distinct cold list ids
        self._queued: set = set()
        self._closed = False
        self._drops = 0
        self._cycles = 0
        self._restarts = 0
        self._gave_up = False
        reg = obs_metrics.default_registry()
        self._c_dropped = reg.counter("tier_fill_dropped_total",
                                      tier=store.name)
        self._c_restarts = reg.counter("tier_fetcher_restarts_total",
                                       tier=store.name)
        obs_crash.install_excepthook()
        store.attach_fill_sink(self.request)
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True,
        )
        self._thread.start()

    # -- producer side -------------------------------------------------------
    def request(self, list_ids: Sequence[int]) -> int:
        """Enqueue cold lists for async promotion (the store's fill
        sink). Dedups against the queue and the current hot set;
        overflow past ``max_pending`` is dropped and counted. Returns
        the number actually enqueued."""
        hot = set(int(x) for x in self.store.hot_lists())
        added = dropped = 0
        with self._work:
            if self._closed:
                return 0
            for lid in list_ids:
                lid = int(lid)
                if lid in self._queued or lid in hot:
                    continue
                if len(self._queue) >= self.max_pending:
                    dropped += 1
                    continue
                self._queue.append(lid)
                self._queued.add(lid)
                added += 1
            if added:
                self._work.notify()
            if dropped:
                self._drops += dropped
        if dropped:
            self._c_dropped.inc(dropped)
        return added

    def stats(self) -> dict:
        with self._lock:
            return {"pending": len(self._queue), "dropped": self._drops,
                    "cycles": self._cycles, "restarts": self._restarts,
                    "gave_up": self._gave_up}

    @property
    def gave_up(self) -> bool:
        """True once the bounded restart policy is exhausted: the worker
        is dead, the fill sink is detached, and the store serves from
        its current hot set (degraded, recall-guardrail-watched) until
        a replacement fetcher is attached."""
        with self._lock:
            return self._gave_up

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the queue is empty and the in-cycle batch has
        been installed (a barrier for tests and the bench). True on
        success, False at the timeout."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            with self._lock:
                if not self._queue and not self._queued:
                    return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        """Stop the worker after its current cycle and detach the fill
        sink; joins the thread (at most 10 s)."""
        with self._work:
            if self._closed:
                return
            self._closed = True
            self._work.notify_all()
        self.store.attach_fill_sink(None)
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "SlabFetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the fetcher thread ----------------------------------------------
    def _run(self) -> None:
        """The thread target: ``_loop`` under a BOUNDED restart policy.
        Each crash counts in ``tier_fetcher_restarts_total{tier=...}``
        and the loop restarts (per-batch bookkeeping in ``_loop``'s
        ``finally`` keeps the queue consistent); after ``max_restarts``
        crashes the worker gives up: it detaches the fill sink (the
        store serves from its current hot set — degraded but correct,
        the recall guardrail watches it), records a flight event, and
        re-raises so the crash excepthook (``obs/crash.py``, installed
        in ``__init__``) counts it in ``thread_uncaught_total``."""
        while True:
            try:
                self._loop()
                return                      # clean close()
            except Exception:
                with self._lock:
                    self._restarts += 1
                    restarts = self._restarts
                    give_up = restarts > self.max_restarts
                    if give_up:
                        self._gave_up = True
                if not give_up:
                    self._c_restarts.inc()
                    continue
                # exhausted: degrade to serve-from-hot and surface
                self.store.attach_fill_sink(None)
                if getattr(self.store, "flight", None) is not None:
                    self.store.flight.record(
                        "tier_fetcher_gave_up", tier=self.store.name,
                        restarts=restarts,
                        max_restarts=self.max_restarts,
                    )
                raise

    def _loop(self) -> None:
        while True:
            with self._work:
                while not self._queue and not self._closed:
                    self._work.wait(timeout=0.05)
                if self._closed and not self._queue:
                    return
                batch = self._queue[:self.window]
                del self._queue[:len(batch)]
            try:
                self._promote_batch(batch)
            finally:
                with self._lock:
                    self._queued.difference_update(batch)
                    self._cycles += 1

    def _promote_batch(self, batch) -> None:
        """One cycle: resolve a slot per candidate (free, else the
        policy's hysteresis victim) and run the store's install
        transaction. The window bounds how many slabs one cycle
        installs."""
        store = self.store
        slot_of = store._slot_of  # noqa: SLF001 — the fetcher is the
        # store's own worker; reads are re-validated inside apply_moves
        load = store.measured_load()
        hot_now = int((slot_of >= 0).sum())
        moves = []
        victims: list = []
        for lid in batch:
            if slot_of[lid] >= 0:
                continue
            victim = None
            if hot_now + len(moves) - len(victims) >= store.n_slots:
                if self.policy is None:
                    continue            # full and no policy: shed
                victim = self.policy.pick_victim(
                    load, slot_of,
                    exclude=[m[0] for m in moves] + victims,
                    candidate_load=float(load[lid]),
                )
                if victim is None:
                    continue            # hysteresis says don't thrash
                victims.append(victim)
            moves.append((lid, victim))
        if not moves:
            return
        store.apply_moves(moves, busy=self._busy_fn or False)
