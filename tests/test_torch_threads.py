"""The port's runtime lock-order tracer under real interleavings, on the
CPU: the counterparts of ``tests/test_threads.py``'s
``TestTracedLockRuntime``, ``TestThreadCrashRouting``,
``TestCompactorStop`` and ``TestExecutorCloseRace``, against
``raft_tpu_torch``'s tracer, metrics, crash hook, compactor and
executor, with tracing on (``set_enabled``) and the port's own pinned
order (``raft_tpu_torch/analysis/lock_order.json``).

Everything is exact: edges, violation kinds and counts, resolved
futures. The one timing threshold (the hold outlier) is lowered to 5 ms
against a 20 ms hold."""

import json
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis import threads as lockcheck_pkg
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import crash as obs_crash
from raft_tpu_torch.obs import metrics as obsm
from raft_tpu_torch.obs.flight import FlightRecorder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_ORDER = REPO / "raft_tpu_torch" / "analysis" / "lock_order.json"
CPU = torch.device("cpu")


@pytest.fixture()
def lockcheck_on():
    """Tracing on with a clean slate; restores the prior gate and pinned
    order afterward."""
    prev = lockcheck.set_enabled(True)
    prev_order = lockcheck.pinned_order()
    lockcheck.clear()
    yield
    lockcheck.clear()
    lockcheck.pin_order(prev_order)
    lockcheck.set_enabled(prev)


# ------------------------------------------------ the runtime tracer
class TestTracedLockRuntime:
    def test_blessed_direct_and_transitive_clean(self, lockcheck_on):
        lockcheck.pin_order({"A": ["B"], "B": ["C"]})
        A, B, C = (lockcheck.make_lock(n) for n in "ABC")
        with A:
            with B:
                pass
        with A:
            with C:            # A -> B -> C transitively blessed
                pass
        lockcheck.assert_clean()
        assert lockcheck.observed_edges() == {"A": {"B", "C"}}

    def test_inversion_and_unpinned_recorded(self, lockcheck_on):
        lockcheck.pin_order({"A": ["B"]})
        A, B, D = (lockcheck.make_lock(n) for n in "ABD")
        with B:
            with A:            # reverse of the blessed path
                pass
        with A:
            with D:            # edge the graph has never seen
                pass
        vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["inversion", "unpinned"]
        assert vs[0].held == ("B",) and vs[0].acquiring == "A"
        assert vs[1].held == ("A",) and vs[1].acquiring == "D"
        with pytest.raises(AssertionError, match="inversion"):
            lockcheck.assert_clean()

    def test_self_reacquire_raises(self, lockcheck_on):
        lockcheck.pin_order({})
        A = lockcheck.make_lock("A")
        with pytest.raises(RuntimeError, match="re-acquiring"):
            with A:
                with A:
                    pass
        assert lockcheck.held_locks() == ()   # stack unwound cleanly

    def test_try_acquire_skips_order_check(self, lockcheck_on):
        lockcheck.pin_order({"A": ["B"]})
        A, B = lockcheck.make_lock("A"), lockcheck.make_lock("B")
        with B:
            assert A.acquire(blocking=False)   # try-lock cannot deadlock
            A.release()
        lockcheck.assert_clean()

    def test_condition_wait_keeps_stack_truthful(self, lockcheck_on):
        lockcheck.pin_order({})
        L = lockcheck.make_lock("CvLock")
        cv = lockcheck.make_condition(L)
        state = []

        def waiter():
            with cv:
                while not state:
                    cv.wait(0.5)
                state.append(lockcheck.held_locks())

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cv:
            state.append("go")
            cv.notify()
        t.join(2)
        assert not t.is_alive()
        assert state[-1] == ("CvLock",)   # re-acquired after wait
        lockcheck.assert_clean()

    def test_hold_outlier_and_histogram_feed(self, lockcheck_on,
                                             monkeypatch):
        monkeypatch.setattr(lockcheck, "HOLD_OUTLIER_MS", 5.0)
        lockcheck.pin_order({})
        prev_obs = obsm.set_enabled(True)
        try:
            A = lockcheck.make_lock("OutlierLock")
            with A:
                time.sleep(0.02)
            B = lockcheck.make_lock("QuickLock")
            with B:
                pass
            outs = lockcheck.hold_outliers()
            assert [o.lock for o in outs] == ["OutlierLock"]
            assert outs[0].held_ms >= 5.0
            snap = obsm.default_registry().snapshot()
            assert any(row["labels"].get("lock") == "OutlierLock"
                       for row in snap["lock_hold_ms"])
        finally:
            obsm.set_enabled(prev_obs)

    def test_violation_counter_feed(self, lockcheck_on):
        lockcheck.pin_order({"A": ["B"]})
        prev_obs = obsm.set_enabled(True)
        try:
            A, B = lockcheck.make_lock("A"), lockcheck.make_lock("B")
            with B:
                with A:
                    pass
            snap = obsm.default_registry().snapshot()
            assert any(
                row["labels"] == {"kind": "inversion"}
                for row in snap["lock_order_violations_total"]
            )
        finally:
            obsm.set_enabled(prev_obs)

    def test_note_dispatch(self, lockcheck_on):
        lockcheck.pin_order({})
        lockcheck.note_dispatch("x")          # nothing held: no-op
        lockcheck.assert_clean()
        A = lockcheck.make_lock("A")
        with A:
            lockcheck.note_dispatch("dev")
        vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["hold-while-dispatch"]
        assert vs[0].acquiring == "dev"

    def test_disabled_hands_back_plain_lock(self):
        prev = lockcheck.set_enabled(False)
        try:
            L = lockcheck.make_lock("P")
            assert not isinstance(L, lockcheck.TracedLock)
        finally:
            lockcheck.set_enabled(prev)

    def test_pinned_order_loads_from_the_ports_file(self, lockcheck_on):
        """The default order is the port's own file, written from the
        port's source: it loads, and it pins exactly its edges."""
        assert lockcheck.DEFAULT_LOCK_ORDER == PORT_ORDER.resolve()
        data = json.loads(PORT_ORDER.read_text())
        assert data["findings"] == {}
        assert "ServingExecutor._lock" in data["order"]
        assert lockcheck.load_pinned_order()
        assert lockcheck.pinned_order() == {
            a: set(bs) for a, bs in data["order"].items()}

    def test_package_reexports_the_runtime(self):
        assert len(lockcheck_pkg.__all__) == 17
        for name in lockcheck_pkg.__all__:
            assert getattr(lockcheck_pkg, name) is getattr(lockcheck, name)


# ------------------------------------------------ excepthook
class TestThreadCrashRouting:
    # the injected crash IS the point — pytest's threadexception plugin
    # would flag it as an unhandled thread exception
    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_uncaught_exception_counts_and_flight_event(self):
        obs_crash.install_excepthook()
        obs_crash.install_excepthook()   # idempotent
        fr = FlightRecorder(capacity=16, name="crash-test")
        prev_obs = obsm.set_enabled(True)
        obs_crash.set_flight_sink(fr)
        try:
            def boom():
                raise ValueError("injected crash")

            t = threading.Thread(target=boom, name="crashy-torch-worker",
                                 daemon=True)
            t.start()
            t.join(5)
            snap = obsm.default_registry().snapshot()
            assert any(
                row["labels"].get("thread") == "crashy-torch-worker"
                for row in snap.get("thread_uncaught_total", [])
            )
            evs = [e for e in fr.events()
                   if e["event"] == "thread_uncaught"]
            assert evs and evs[-1]["thread"] == "crashy-torch-worker"
            assert evs[-1]["exc_type"] == "ValueError"
        finally:
            obs_crash.set_flight_sink(None)
            obsm.set_enabled(prev_obs)


# ------------------------------------------------ compactor
def _cpu_snapshot():
    """A stand-in for a mutable index snapshot: all ``submit`` reads of
    it is the device its tensors live on."""
    return types.SimpleNamespace(index=types.SimpleNamespace(device=CPU))


class TestCompactorStop:
    def test_crash_then_stop_reraises(self, monkeypatch, lockcheck_on):
        from raft_tpu_torch.spatial.ann import mutation as mut

        lockcheck.load_pinned_order()
        comp = mut.BackgroundCompactor()
        assert isinstance(comp._lock, lockcheck.TracedLock)

        def exploding(mindex, **kw):
            raise RuntimeError("compaction exploded")

        monkeypatch.setattr(mut, "compact", exploding)
        assert comp.submit(_cpu_snapshot()) is True
        deadline = time.monotonic() + 5
        while comp.busy and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(RuntimeError, match="compaction exploded"):
            comp.stop(timeout_s=5.0)
        # the error is consumed exactly once: a second stop is quiet,
        # and the compactor accepts new work again
        comp.stop(timeout_s=5.0)
        assert comp.submit(_cpu_snapshot()) is True
        comp.join(5.0)
        lockcheck.assert_clean()

    def test_stop_without_worker_is_quiet(self):
        from raft_tpu_torch.spatial.ann.mutation import BackgroundCompactor

        BackgroundCompactor().stop(timeout_s=0.1)


# ------------------------------------------------ durable ingest
class TestDurableIngestTraced:
    def test_wal_ingest_round_under_tracer(self, tmp_path, lockcheck_on):
        """Upserts and deletes through ``DurableIngest`` over a WAL, with
        the group-commit thread flushing beside the ingest thread: the
        pinned ``DurableIngest._lock -> WalWriter._lock`` edge is taken,
        and nothing else."""
        from raft_tpu_torch.durability import wal
        from raft_tpu_torch.spatial.ann import mutation as mut
        from raft_tpu_torch.spatial.ann.ivf_flat import (IVFFlatParams,
                                                        ivf_flat_build)

        assert lockcheck.load_pinned_order(PORT_ORDER)
        rng = np.random.default_rng(0)
        x = rng.integers(-8, 9, (512, 8)).astype(np.float32)
        index = ivf_flat_build(x, IVFFlatParams(n_lists=8, kmeans_n_iters=4,
                                                seed=0), device=CPU)
        w = wal.WalWriter(str(tmp_path / "w"), flush_interval_s=0.0005)
        ing = wal.DurableIngest(mut.wrap_mutable(index, delta_cap=16), w)
        assert isinstance(ing._lock, lockcheck.TracedLock)
        for r in range(4):
            ids = np.arange(9000 + 4 * r, 9004 + 4 * r, dtype=np.int32)
            assert ing.upsert(x[ids - 9000], ids).all()
            assert ing.delete(np.asarray([r], np.int32)).all()
        ing.close()
        lockcheck.assert_clean()
        observed = lockcheck.observed_edges()
        assert observed.get("DurableIngest._lock") == {"WalWriter._lock"}


# ------------------------------------------------ supervisor heal
class TestSupervisorHealTraced:
    def test_kill_reroute_heal_under_tracer(self, lockcheck_on):
        """The supervisor's kill -> reroute -> heal cycle at P = 8 (the
        chaos suite's short schedule, a flapping probe included), every
        lock of it traced: it heals, no request fails, and no lock is
        taken off the pinned order or held across a dispatch."""
        from raft_tpu_torch.comms import build_comms
        from raft_tpu_torch.testing.heal_rows import self_heal_row

        assert lockcheck.load_pinned_order(PORT_ORDER)
        rng = np.random.default_rng(7)
        x = rng.standard_normal((512, 16)).astype(np.float32)
        q = rng.standard_normal((12, 16)).astype(np.float32)
        row = self_heal_row(build_comms(["cpu"] * 8, timeout_s=120.0), x, q,
                            k=5, n_probes=8, n_lists=8, request_size=4,
                            kill_at_s=0.4, heal_at_s=1.2, duration_s=2.5,
                            oscillate=(1, 0.8, 0.02, 0.1))
        assert "error" not in row and row["failed_requests"] == 0
        assert row["supervisor_heals_ok"] >= 1 and row["all_serving"]
        lockcheck.assert_clean()


# ------------------------------------------------ executor race
class TestExecutorCloseRace:
    def test_close_racing_submits_under_tracer(self, lockcheck_on):
        """Submits racing close() either resolve or raise cleanly;
        nothing wedges; the traced locks see zero order violations
        against the port's pinned order."""
        from raft_tpu_torch.obs.metrics import MetricRegistry
        from raft_tpu_torch.resilience import AdmissionController
        from raft_tpu_torch.serving import ServingExecutor

        assert lockcheck.load_pinned_order(PORT_ORDER)
        dim = 4

        def dispatch(batch, **_rt):
            return (batch,)

        ex = ServingExecutor(
            dispatch, (2, 4), dim=dim, flush_age_s=0.001,
            max_in_flight=2, device=CPU,
            admission=AdmissionController(max_concurrent=4, max_queue=64),
            flight=FlightRecorder(capacity=64, name="close-race"),
            registry=MetricRegistry(),
        )
        assert isinstance(ex._lock, lockcheck.TracedLock)
        results = {"ok": 0, "closed": 0, "shed": 0}
        res_lock = threading.Lock()
        futures = []

        def submitter(seed):
            rng = np.random.default_rng(seed)
            for _ in range(40):
                try:
                    f = ex.submit(rng.standard_normal(
                        (2, dim)).astype(np.float32))
                except errors.RaftLogicError:
                    with res_lock:
                        results["closed"] += 1
                    return
                except errors.RaftOverloadError:
                    with res_lock:
                        results["shed"] += 1
                    continue
                with res_lock:
                    futures.append(f)

        threads = [threading.Thread(target=submitter, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        ex.close(timeout_s=30)
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        # both loops actually exited — no wedged drain thread
        assert not ex._batcher.is_alive()
        assert not ex._drainer.is_alive()
        # every accepted in-flight future resolved (result or exception)
        assert futures
        for f in futures:
            assert f.done()
            if f.exception() is None:
                out = f.result()
                assert tuple(out[0].shape) == (2, dim)
        # submits AFTER close raise cleanly
        with pytest.raises(errors.RaftLogicError, match="closed"):
            ex.submit(np.zeros((2, dim), np.float32))
        # the tracer saw the pinned order and nothing else
        lockcheck.assert_clean()
        observed = lockcheck.observed_edges()
        assert "ServingExecutor._lock" in observed
        pinned = lockcheck.pinned_order()
        for a, bs in observed.items():
            assert bs <= pinned[a], (a, bs)
