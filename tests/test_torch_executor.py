"""The PyTorch port's open-loop ServingExecutor (raft_tpu_torch.serving)
on the CPU: the executor tests of tests/test_open_loop.py (demux,
shedding, hedging, the open-loop row) on the port, the port's readiness
and wait primitives, the result-cache path through the executor, and
one parity run of the same requests through the JAX executor over a JAX
index and through the port's executor over that index carried across.

The tests assert shape, demux and accounting, never a rate. Where a
module takes a clock, the test injects one; waits on futures use
generous timeouts. On the CPU the executor runs without streams or
events: outputs are ready when ``dispatch`` returns, and readiness
gates (objects with ``query()`` and ``.value``) stand in for batches
still on the card.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.serving import ServingExecutor as JServingExecutor
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import ivf_flat_build as j_ivf_flat_build
from raft_tpu.spatial.ann.ivf_flat import (
    ivf_flat_search_grouped as j_grouped,
)
from raft_tpu_torch import errors
from raft_tpu_torch.core.interruptible import (
    InterruptedException,
    Interruptible,
    waitables,
)
from raft_tpu_torch.obs import FlightRecorder, MetricRegistry
from raft_tpu_torch.resilience import (
    AdmissionController,
    HedgePolicy,
    RetryPolicy,
    dispatch_hedged,
    dispatch_with_deadline,
)
from raft_tpu_torch.serving import (
    STAGES,
    ResultCache,
    ServingExecutor,
)
from raft_tpu_torch.serving.open_loop import (
    chained_dispatch_stats,
    open_loop_row,
)
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_index_from_arrays,
    ivf_flat_search_grouped,
)

torch.set_num_threads(1)

D = 8
K = 4
N_PROBES = 4
BUCKETS = (4, 8)
CPU = torch.device("cpu")


class FakeClock:
    """A host clock that moves only when told to."""

    def __init__(self, t: float = 50.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Gate:
    """A readiness gate: ``query()`` is False until ``open()`` (or until
    ``seconds`` have passed), the result rides in ``.value`` — the
    stand-in for a batch still running on the card."""

    def __init__(self, value=None, seconds=None):
        self.value = value
        self._open = threading.Event()
        self._at = None if seconds is None else time.monotonic() + seconds

    def open(self):
        self._open.set()

    def query(self) -> bool:
        return self._open.is_set() or (
            self._at is not None and time.monotonic() >= self._at)


# ----------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def tiny_serving():
    """A tiny IVF-Flat serving setup on the CPU: per-bucket closures at
    ONE shared qcap (>= every bucket's probes: no probe drops, so
    per-row results do not depend on the batch composition), and the
    per-row reference from one full batch."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2048, D)).astype(np.float32)
    idx = ivf_flat_build(x, IVFFlatParams(n_lists=8, kmeans_n_iters=3,
                                          seed=2), device=CPU)
    qcap = 32
    for b in BUCKETS:
        idx.warmup(b, k=K, n_probes=N_PROBES, qcap=qcap)
    shapes = []

    def dispatch(batch, **_rt):
        shapes.append(int(batch.shape[0]))
        return ivf_flat_search_grouped(idx, batch, K, n_probes=N_PROBES,
                                       qcap=qcap)

    q = rng.standard_normal((32, D)).astype(np.float32)
    vref, iref = (a.numpy() for a in dispatch(torch.as_tensor(q)))
    shapes.clear()
    refs = {s: (vref[s], iref[s]) for s in range(32)}
    return idx, dispatch, q, refs, shapes


def _check_request(req_rows, result, refs):
    v, i = result
    assert isinstance(v, np.ndarray) and isinstance(i, np.ndarray)
    assert v.shape == (len(req_rows), K) and i.shape == (len(req_rows), K)
    for out_row, src in enumerate(req_rows):
        np.testing.assert_array_equal(i[out_row], refs[src][1])
        np.testing.assert_array_equal(v[out_row], refs[src][0])


def _executor(dispatch, **kw):
    kw.setdefault("registry", MetricRegistry())
    return ServingExecutor(dispatch, BUCKETS, dim=D, device=CPU, **kw)


# -------------------------------------------------------------- demux
class TestExecutorDemux:
    def test_mixed_sizes_demux_only_warmed_sizes(self, tiny_serving):
        """Requests of mixed sizes coalesce into warmed buckets; every
        caller gets exactly its own rows back; every dispatched batch
        has a warmed size."""
        idx, dispatch, q, refs, shapes = tiny_serving
        shapes.clear()
        ex = _executor(dispatch, flush_age_s=0.002, max_in_flight=3)
        reqs = []
        cursor = 0
        for m in (1, 3, 2, 4, 1, 1, 8, 2, 3, 1, 4, 2):
            rows = list(range(cursor, cursor + m))
            cursor += m
            if cursor > 32:
                break
            reqs.append((rows, ex.submit(q[rows[0]:rows[-1] + 1])))
        for rows, fut in reqs:
            _check_request(rows, fut.result(timeout=60), refs)
        ex.close()
        st = ex.stats()
        assert st.completed == len(reqs) and st.failed == 0
        assert st.submitted == st.completed + st.failed
        assert st.valid_rows == sum(len(r) for r, _ in reqs)
        assert st.batches >= 2 and len(shapes) == st.batches
        assert set(shapes) <= set(BUCKETS)
        assert st.padded_rows == sum(shapes) - st.valid_rows

    def test_smaller_than_smallest_bucket_pads(self, tiny_serving):
        """A lone 2-row request: padded to the smallest bucket, pad rows
        dispatched but never surfaced."""
        idx, dispatch, q, refs, shapes = tiny_serving
        ex = _executor(dispatch, flush_age_s=0.0)
        fut = ex.submit(q[5:7])
        _check_request([5, 6], fut.result(timeout=60), refs)
        ex.close()
        st = ex.stats()
        assert st.batches == 1 and st.padded_rows == BUCKETS[0] - 2
        assert st.flushes_deadline == 1 and st.flushes_full == 0
        assert st.pad_fraction == (BUCKETS[0] - 2) / BUCKETS[0]

    def test_straddling_requests_two_warmed_batches(self, tiny_serving):
        """Arrivals straddling the largest bucket (3+3+3 rows vs bucket
        8) become TWO warmed-size dispatches — whole requests only."""
        idx, dispatch, q, refs, shapes = tiny_serving
        gate = threading.Event()
        shapes.clear()

        def gated(batch, **rt):
            gate.wait(10.0)
            return dispatch(batch)

        ex = _executor(gated, flush_age_s=0.0)
        futs = [ex.submit(q[s:s + 3]) for s in (0, 3, 6)]
        gate.set()
        for s, fut in zip((0, 3, 6), futs):
            _check_request([s, s + 1, s + 2], fut.result(timeout=60), refs)
        ex.close()
        st = ex.stats()
        assert st.batches == 2 and sorted(shapes) == [4, 8]
        assert st.valid_rows == 9 and st.padded_rows == 3

    def test_deadline_flush_on_injected_clock(self, tiny_serving):
        """With the coalescing window on an injected clock, a sub-bucket
        request is NOT flushed while the clock stands still, and is
        flushed as a padded partial batch once the clock passes
        ``flush_age_s``."""
        idx, dispatch, q, refs, shapes = tiny_serving
        clock = FakeClock()
        ex = _executor(dispatch, flush_age_s=0.05, clock=clock)
        fut = ex.submit(q[9:10])
        time.sleep(0.2)
        assert not fut.done() and ex.stats().batches == 0
        clock.advance(0.06)
        _check_request([9], fut.result(timeout=60), refs)
        ex.close()
        st = ex.stats()
        assert st.flushes_deadline == 1 and st.batches == 1
        # every stage histogram recorded from the injected clock
        assert set(st.stage_p50_ms) == set(STAGES)
        assert st.stage_p50_ms["queue_wait"] == pytest.approx(60.0,
                                                              rel=1e-9)

    def test_dispatch_stage_times_the_dispatch_closure(self, tiny_serving):
        """The ``dispatch`` stage is the batcher thread's host time in the
        dispatch closure (and the enqueued copy back), observed once per
        batch: a dispatch that sleeps 5 ms reads a p50 of at least 4 ms
        while ``staging`` stays below that."""
        idx, dispatch, q, refs, shapes = tiny_serving
        reg = MetricRegistry()

        def slow(batch, **rt):
            time.sleep(0.005)
            return dispatch(batch)

        ex = _executor(slow, flush_age_s=0.0, registry=reg)
        starts = range(0, 12, 2)
        futs = [ex.submit(q[s:s + 2]) for s in starts]
        for s, fut in zip(starts, futs):
            _check_request([s, s + 1], fut.result(timeout=60), refs)
        ex.close()
        st = ex.stats()
        observed = sum(h.count for h in reg.series("serving_stage_ms")
                       if h.labels["stage"] == "dispatch")
        assert st.batches >= 1 and observed == st.batches
        assert set(st.stage_p50_ms) == set(STAGES)
        assert st.stage_p50_ms["dispatch"] >= 4.0
        assert st.stage_p50_ms["staging"] < 4.0

    def test_oversized_request_rejected_loudly(self, tiny_serving):
        idx, dispatch, q, refs, shapes = tiny_serving
        ex = _executor(dispatch)
        with pytest.raises(ValueError, match="largest warmed bucket"):
            ex.submit(np.zeros((BUCKETS[-1] + 1, D), np.float32))
        with pytest.raises(ValueError, match="expected"):
            ex.submit(np.zeros((2, D + 1), np.float32))
        ex.close()
        with pytest.raises(ValueError, match="closed"):
            ex.submit(q[:1])

    def test_runtime_inputs_snapshot_per_dispatch(self, tiny_serving):
        """set_runtime values flow into every LATER dispatch as keyword
        operands."""
        idx, dispatch, q, refs, shapes = tiny_serving
        seen = []

        def spying(batch, **rt):
            seen.append(dict(rt))
            return dispatch(batch)

        ex = _executor(spying, flush_age_s=0.0, runtime_inputs={"tag": 1})
        ex.submit(q[:1]).result(timeout=60)
        ex.set_runtime(tag=2)
        ex.submit(q[:1]).result(timeout=60)
        ex.set_runtime(tag=None)                      # removal
        ex.submit(q[:1]).result(timeout=60)
        ex.close()
        assert seen == [{"tag": 1}, {"tag": 2}, {}]

    def test_completion_order_demux(self, tiny_serving):
        """The drain thread demuxes whichever batch is ready first: a
        later batch completes while an earlier one is still gated."""
        idx, dispatch, q, refs, shapes = tiny_serving
        gates = []

        def gated(batch, **rt):
            g = Gate(dispatch(batch))
            gates.append(g)
            return g

        ex = _executor(gated, flush_age_s=0.0, max_in_flight=4)
        f1 = ex.submit(q[0:8])
        f2 = ex.submit(q[8:16])
        deadline = time.monotonic() + 30
        while len(gates) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        gates[1].open()
        _check_request(list(range(8, 16)), f2.result(timeout=60), refs)
        assert not f1.done()
        gates[0].open()
        _check_request(list(range(0, 8)), f1.result(timeout=60), refs)
        ex.close()

    def test_stage_override_and_flight_span(self, tiny_serving):
        """A caller-given ``stage`` is used for every batch, and the
        flight recorder traces each request submit→pack→dispatch→demux
        on the executor's clock."""
        idx, dispatch, q, refs, shapes = tiny_serving
        staged = []

        def stage(host):
            staged.append(host.shape)
            return torch.as_tensor(host).clone()

        fr = FlightRecorder(capacity=64)
        ex = _executor(dispatch, flush_age_s=0.0, stage=stage, flight=fr)
        _check_request([3, 4], ex.submit(q[3:5]).result(timeout=60), refs)
        ex.close()
        assert staged == [(BUCKETS[0], D)]
        names = [e["event"] for e in fr.events()]
        assert names == ["submit", "pack", "dispatch", "demux"]
        assert fr.events(event="pack")[0]["bucket"] == BUCKETS[0]

    def test_default_device_raises_without_cuda(self, tiny_serving):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        idx, dispatch, q, refs, shapes = tiny_serving
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingExecutor(dispatch, BUCKETS, dim=D)


# ----------------------------------------------------------- shedding
class TestExecutorShedding:
    def test_queue_bound_sheds_not_collapses(self, tiny_serving):
        """With dispatch stalled, arrivals beyond the admission queue
        shed with RaftOverloadError; everything admitted completes once
        the stall clears."""
        idx, dispatch, q, refs, shapes = tiny_serving
        gate = threading.Event()

        def gated(batch, **rt):
            gate.wait(10.0)
            return dispatch(batch)

        ctrl = AdmissionController(max_concurrent=2, max_queue=4,
                                   registry=MetricRegistry())
        ex = _executor(gated, flush_age_s=0.0, max_in_flight=1,
                       admission=ctrl)
        futs, sheds = [], 0
        for i in range(16):
            try:
                futs.append((i % 32, ex.submit(q[i % 32:i % 32 + 1])))
            except errors.RaftOverloadError as e:
                sheds += 1
                assert e.retry_after_s is None or e.retry_after_s >= 0
        gate.set()
        for src, fut in futs:
            _check_request([src], fut.result(timeout=60), refs)
        st = ctrl.stats()
        ex.close()
        assert sheds > 0 and st.shed_queue == sheds
        assert st.completed == len(futs)
        assert st.queue_depth == 0 and st.in_flight == 0
        es = ex.stats()
        assert es.submitted == len(futs) == es.completed + es.failed

    def test_caller_cancelled_future_does_not_wedge_drain(self,
                                                          tiny_serving):
        idx, dispatch, q, refs, shapes = tiny_serving
        gate = threading.Event()

        def gated(batch, **rt):
            gate.wait(10.0)
            return dispatch(batch)

        ex = _executor(gated, flush_age_s=0.0)
        f1 = ex.submit(q[:1])
        f2 = ex.submit(q[1:2])
        assert f1.cancel()               # still pending: cancel wins
        gate.set()
        _check_request([1], f2.result(timeout=60), refs)
        f3 = ex.submit(q[2:3])           # the drain thread survived
        _check_request([2], f3.result(timeout=60), refs)
        st = ex.stats()
        ex.close()
        assert not ex._drainer.is_alive() and not ex._batcher.is_alive()
        assert st.completed == 2 and st.failed == 0

    @pytest.mark.parametrize("where", ["dispatch", "stage"])
    def test_failure_fails_only_its_batch(self, tiny_serving, where):
        """A dispatch or staging failure fails that batch's futures with
        the real exception (never swallowed) and the next batch
        serves."""
        idx, dispatch, q, refs, shapes = tiny_serving
        calls, stages = [], []

        def flaky(batch, **rt):
            calls.append(batch.shape[0])
            if where == "dispatch" and len(calls) == 1:
                raise RuntimeError("injected dispatch failure")
            return dispatch(batch)

        def stage(host):
            stages.append(host.shape[0])
            if where == "stage" and len(stages) == 1:
                raise RuntimeError("injected staging failure")
            return torch.as_tensor(host).clone()

        fr = FlightRecorder(capacity=64)
        ex = _executor(flaky, flush_age_s=0.0, stage=stage, flight=fr)
        f1 = ex.submit(q[:2])
        with pytest.raises(RuntimeError, match="injected"):
            f1.result(timeout=60)
        f2 = ex.submit(q[3:4])
        _check_request([3], f2.result(timeout=60), refs)
        st = ex.stats()
        ex.close()
        assert st.failed == 1 and st.completed == 1
        assert st.submitted == st.completed + st.failed
        fail = fr.events(event="batch_fail")
        assert len(fail) == 1 and fail[0]["error"] == "RuntimeError"


# ------------------------------------------------------------- hedging
class TestExecutorHedge:
    def test_straggling_batch_hedged_to_backup(self, tiny_serving):
        """A batch whose primary stays not-ready past the hedge delay is
        re-staged from its HOST copy and dispatched through the backup
        closure by the hedge thread; the first ready answer is demuxed
        (identical results)."""
        idx, dispatch, q, refs, shapes = tiny_serving
        calls = []

        def straggling(batch, **rt):
            calls.append(1)
            out = dispatch(batch)
            return Gate(out, seconds=30.0) if len(calls) == 2 else out

        pol = HedgePolicy(default_delay_s=0.01, min_samples=10 ** 6)
        ex = _executor(straggling, flush_age_s=0.0, hedge=pol,
                       backup_dispatch=dispatch)
        f1 = ex.submit(q[:2])                 # call 1: fast
        _check_request([0, 1], f1.result(timeout=60), refs)
        f2 = ex.submit(q[4:6])                # call 2: straggles 30 s
        _check_request([4, 5], f2.result(timeout=20), refs)
        st = ex.stats()
        ex.close()
        assert st.hedged_batches == 1 and st.backup_wins == 1
        assert pol.hedges == 1 and pol.backup_wins == 1
        assert not any(t.name.startswith("serving-hedge")
                       for t in threading.enumerate())

    def test_slow_ready_dispatch_is_not_hedged(self, tiny_serving):
        """A dispatch that runs synchronously past the hedge delay but
        returns a ready answer (a CPU dispatch under load) is demuxed,
        never hedged: the drain sweep checks hedges before readiness,
        and a ready batch is no straggler."""
        idx, dispatch, q, refs, shapes = tiny_serving

        def slow(batch, **rt):
            time.sleep(0.06)                  # 6x the hedge delay
            return dispatch(batch)

        pol = HedgePolicy(default_delay_s=0.01, min_samples=10 ** 6)
        ex = _executor(slow, flush_age_s=0.0, hedge=pol,
                       backup_dispatch=dispatch)
        for a, b in ((0, 2), (4, 6), (7, 8)):
            _check_request(list(range(a, b)),
                           ex.submit(q[a:b]).result(timeout=60), refs)
        st = ex.stats()
        ex.close()
        assert st.hedged_batches == 0 and st.backup_wins == 0
        assert pol.hedges == 0 and pol.unhedged == 3

    def test_backup_requires_hedge_policy(self, tiny_serving):
        idx, dispatch, q, refs, shapes = tiny_serving
        with pytest.raises(ValueError, match="hedge="):
            _executor(dispatch, backup_dispatch=dispatch)


# ------------------------------------------------------ result cache
class TestExecutorResultCache:
    def test_second_pass_served_from_cache_bitwise(self, tiny_serving):
        """Serve requests, then the same requests again: the second pass
        is answered from the result cache (no batch), bitwise equal to
        the first."""
        idx, dispatch, q, refs, shapes = tiny_serving
        cache = ResultCache(K, n_sets=16, associativity=4, device=CPU,
                            registry=MetricRegistry())
        reqs = [(s, s + m) for s, m in ((0, 1), (1, 3), (4, 2), (6, 4),
                                        (10, 1), (11, 8))]

        def serve():
            # closing joins the drain thread: every cache fill has landed
            with _executor(dispatch, flush_age_s=0.0,
                           result_cache=cache) as ex:
                out = [ex.submit(q[a:b]).result(timeout=60)
                       for a, b in reqs]
            return out, ex.stats()

        first, st1 = serve()
        second, st = serve()
        for (a, b), r1, r2 in zip(reqs, first, second):
            _check_request(list(range(a, b)), r1, refs)
            assert r2[0].tobytes() == r1[0].tobytes()
            assert r2[1].tobytes() == r1[1].tobytes()
        assert st1.cache_hits == 0 and st1.batches == len(reqs)
        assert st.cache_hits == len(reqs) and st.batches == 0
        assert st.submitted == st.completed == len(reqs)
        assert cache.stats().inserts == sum(b - a for a, b in reqs)

    @pytest.mark.parametrize("tiers", ["host", "card"])
    def test_cache_fills_thread_follows_the_tiers(self, tiny_serving,
                                                  tiers):
        """Fills of host tiers run on the drain thread, as in the JAX
        executor; fills of tiers on the card run on the executor's
        cache-fill thread (they are device calls, and the drain thread
        makes none beyond ``Event.query()``). The card case is routed
        here by the cache's ``device`` alone, its tensors staying on the
        host. close() waits for the fills either way."""
        idx, dispatch, q, refs, shapes = tiny_serving
        cache = ResultCache(K, n_sets=16, associativity=4, device=CPU,
                            registry=MetricRegistry())
        if tiers == "card":
            cache.device = torch.device("cuda")
        threads = []
        real = cache.insert

        def insert(*a, **kw):
            threads.append(threading.current_thread().name)
            time.sleep(0.05)
            return real(*a, **kw)

        cache.insert = insert
        with _executor(dispatch, flush_age_s=0.0, result_cache=cache,
                       name="t") as ex:
            futs = [ex.submit(q[i:i + 2]) for i in range(0, 8, 2)]
            for i, f in zip(range(0, 8, 2), futs):
                _check_request([i, i + 1], f.result(timeout=60), refs)
        assert cache.stats().inserts == 8
        want = "t-cache-fill" if tiers == "card" else "t-drain"
        assert threads and all(t.startswith(want) for t in threads)
        assert (ex._filler is None) == (tiers == "host")

    def test_blocked_card_tier_fill_holds_back_no_caller(self,
                                                         tiny_serving):
        """With the tiers on the card (routed by the cache's ``device``,
        its tensors on the host), a cache fill that blocks holds back no
        caller: every later batch still demuxes, and close() waits for
        the fills once they are let go."""
        idx, dispatch, q, refs, shapes = tiny_serving
        cache = ResultCache(K, n_sets=16, associativity=4, device=CPU,
                            registry=MetricRegistry())
        cache.device = torch.device("cuda")
        gate = threading.Event()
        real = cache.insert

        def insert(*a, **kw):
            gate.wait(30.0)
            return real(*a, **kw)

        cache.insert = insert
        ex = _executor(dispatch, flush_age_s=0.0, result_cache=cache)
        try:
            for i in range(0, 8, 2):
                _check_request([i, i + 1],
                               ex.submit(q[i:i + 2]).result(timeout=60),
                               refs)
            assert cache.stats().inserts == 0
        finally:
            gate.set()
            ex.close()
        assert cache.stats().inserts == 8

    def test_identical_in_flight_request_coalesced(self, tiny_serving):
        idx, dispatch, q, refs, shapes = tiny_serving
        gate = threading.Event()

        def gated(batch, **rt):
            gate.wait(10.0)
            return dispatch(batch)

        cache = ResultCache(K, n_sets=16, associativity=4, device=CPU,
                            registry=MetricRegistry())
        ex = _executor(gated, flush_age_s=0.0, result_cache=cache)
        f1 = ex.submit(q[2:5])
        f2 = ex.submit(q[2:5])
        gate.set()
        _check_request([2, 3, 4], f1.result(timeout=60), refs)
        _check_request([2, 3, 4], f2.result(timeout=60), refs)
        st = ex.stats()
        ex.close()
        assert st.coalesced_requests == 1 and st.valid_rows == 3


# ------------------------------------------------ readiness and waits
def test_waitables_of_host_trees_are_empty():
    tree = {"a": torch.ones(3), "b": (np.zeros(2), [1, None])}
    assert waitables(tree) == []
    g = Gate()
    assert waitables([torch.ones(1), g]) == [g]


def test_synchronize_honours_cancel_and_timeout():
    g = Gate()
    t0 = time.monotonic()
    with pytest.raises(errors.RaftTimeoutError):
        Interruptible.synchronize(g, timeout_s=0.05)
    assert time.monotonic() - t0 >= 0.05
    # a cancel from another thread breaks the wait, and wins over an
    # elapsed deadline
    out = {}

    def waiter():
        out["tid"] = threading.get_ident()
        try:
            Interruptible.synchronize((g,), timeout_s=30.0)
        except InterruptedException:
            out["cancelled"] = True

    th = threading.Thread(target=waiter)
    th.start()
    while "tid" not in out:
        time.sleep(0.001)
    Interruptible.cancel_thread(out["tid"])
    th.join(10.0)
    assert not th.is_alive() and out.get("cancelled")
    g.open()
    Interruptible.synchronize({"x": g, "y": torch.zeros(2)})


def test_dispatch_with_deadline_retries_a_timeout():
    calls = []

    def fn():
        calls.append(1)
        return Gate(seconds=None if len(calls) == 1 else 0.0)

    out = dispatch_with_deadline(
        fn, timeout_s=0.02,
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    assert len(calls) == 2 and out.query()


def test_dispatch_hedged_backup_wins_and_counts():
    pol = HedgePolicy(default_delay_s=0.01, min_samples=10 ** 6)
    primary, backup = Gate(), Gate(seconds=0.0)
    seen = []
    got = dispatch_hedged(lambda: primary, hedge=pol,
                          backup_fn=lambda: backup, timeout_s=10.0,
                          on_hedge=seen.append)
    assert got is backup and seen == [0.01]
    assert pol.hedges == 1 and pol.backup_wins == 1


# ------------------------------------------------------ open-loop row
def test_open_loop_row_tiny_config(tiny_serving):
    """The open-loop row's whole pipeline — chained program timing,
    Poisson schedules, executors, saturation probe, offered-load sweep
    — on a tiny CPU config, asserting SHAPE and accounting, never a
    rate. Each search also sleeps 5 ms: the row's program rate is a
    difference of two chain times, which a loaded CPU can drown when a
    tiny search takes microseconds (the row then reports
    ``jitter-dominated``); the floor keeps the longer chain longer."""
    idx, _, q, _, _ = tiny_serving
    calls = []

    def make_run(bucket):
        qcap = idx.warmup(bucket, k=K, n_probes=N_PROBES)

        def run(qq, qcap=qcap):
            calls.append(int(qq.shape[0]))
            time.sleep(0.005)
            return ivf_flat_search_grouped(idx, qq, K, n_probes=N_PROBES,
                                           qcap=qcap)
        return run

    accepted = []
    row = open_loop_row(make_run, q, buckets=BUCKETS, request_size=2,
                        n_requests=24, chain=(1, 3), escalate=0,
                        flush_age_s=0.001, fracs=(0.5, 0.95),
                        min_duration_s=0.0, device=CPU,
                        on_submit=lambda point, rows, fut: accepted.append(
                            (point, rows, fut)))
    assert row["scenario"] == "open_loop"
    assert "error" not in row, row
    assert row["buckets"] == list(BUCKETS)
    assert row["program_qps"] > 0 and row["saturation_qps"] > 0
    assert row["qps_ratio_vs_program"] > 0
    for tag in ("50", "95"):
        assert row[f"p50_ms_{tag}"] > 0
        assert row[f"p99_ms_{tag}"] >= row[f"p50_ms_{tag}"]
        assert 0.0 <= row[f"pad_fraction_{tag}"] < 1.0
        assert set(row[f"stage_p50_ms_{tag}"]) == set(STAGES)
    tot = row["totals"]
    assert tot["submitted"] == tot["completed"] + tot["failed"]
    assert tot["failed"] == 0 and tot["submitted"] == len(accepted)
    assert tot["valid_rows"] == tot["rows_accepted"] == 2 * len(accepted)
    assert [p for p, _, _ in accepted] == sorted(
        (p for p, _, _ in accepted),
        key=["sat", "sat_off", "50", "95"].index)
    assert all(r.shape == (2, D) for _, r, _ in accepted)
    assert tot["batches"] == tot["flushes_full"] + tot["flushes_deadline"]
    # one search per executor batch, beside the warmups and the chain
    assert set(calls) <= set(BUCKETS)
    assert all(f.done() and not f.exception() for _, _, f in accepted)


def test_chained_dispatch_stats_counts_and_keys():
    calls = []
    st = chained_dispatch_stats(lambda s: s, lambda x: calls.append(x),
                                n1=1, n2=3, reps=3, device=CPU)
    assert calls == sorted(calls) and len(set(calls)) == len(calls)
    assert calls[0] == 1
    if st is not None:
        assert set(st) == {"ms", "ms_min", "spread", "repeats",
                           "escalations"}
        assert st["repeats"] in (3, 5, 7) and st["escalations"] == 0


# ------------------------------------------------ parity with the JAX side
def _int_dataset(seed, n=3000, d=16, nq=64):
    """Integer-exact clustered rows/queries (tests/test_flat_kernel.py):
    squared distances are exact in f32 for any accumulation order."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-60, 60, (8, d))
    x = (centers[rng.integers(0, 8, n)]
         + rng.integers(-6, 7, (n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, nq)]
         + rng.integers(-2, 3, (nq, d))).astype(np.float32)
    return x, q


def _assert_ids_equal_up_to_ties(dists, i0, i1):
    """ids identical except inside equal-distance runs (the group cut by
    the k-boundary is checked for distance only)."""
    for r in range(dists.shape[0]):
        start, k = 0, dists.shape[1]
        for end in range(1, k + 1):
            if end == k or dists[r, end] != dists[r, start]:
                if end < k or start == 0:
                    assert set(i0[r, start:end].tolist()) == \
                        set(i1[r, start:end].tolist()), r
                start = end


def test_executor_parity_with_jax_executor():
    """The same requests through the JAX executor over a JAX index and
    through the port's executor over that index carried across, at one
    shared qcap >= every bucket (no probe drops): per request, distances
    bitwise equal on the integer-exact fixture, ids equal up to ties."""
    x, q = _int_dataset(3)
    d, k, n_probes, qcap, buckets = q.shape[1], 5, 4, 64, (8, 16)
    jidx = j_ivf_flat_build(x, JIVFFlatParams(n_lists=12, kmeans_n_iters=4,
                                              kmeans_init="random"),
                            metric="sqeuclidean")
    s = jidx.storage
    tidx = ivf_flat_index_from_arrays({
        "centroids": np.asarray(jidx.centroids),
        "data_sorted": np.asarray(jidx.data_sorted),
        "storage.sorted_ids": np.asarray(s.sorted_ids),
        "storage.list_offsets": np.asarray(s.list_offsets),
        "storage.list_index": np.asarray(s.list_index),
        "storage.list_sizes": np.asarray(s.list_sizes),
        "storage.n": s.n, "storage.max_list": s.max_list,
    }, jidx.metric, device=CPU)

    sizes = (1, 3, 5, 2, 8, 4, 1, 6, 2, 7, 3, 1, 16, 5)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) % (64 - 16)
    reqs = [q[a:a + m] for a, m in zip(starts, sizes)]

    def serve(ex):
        with ex:
            futs = [ex.submit(r) for r in reqs]
            return [tuple(np.asarray(a) for a in f.result(timeout=120))
                    for f in futs]

    jres = serve(JServingExecutor(
        lambda b, **_: j_grouped(jidx, b, k, n_probes=n_probes, qcap=qcap),
        buckets, dim=d, flush_age_s=0.002))
    tres = serve(ServingExecutor(
        lambda b, **_: ivf_flat_search_grouped(tidx, b, k,
                                               n_probes=n_probes,
                                               qcap=qcap),
        buckets, dim=d, flush_age_s=0.002, device=CPU,
        registry=MetricRegistry()))
    for r, (jd, ji), (td, ti) in zip(reqs, jres, tres):
        assert td.shape == jd.shape == (r.shape[0], k)
        assert td.tobytes() == jd.tobytes()
        _assert_ids_equal_up_to_ties(jd, ji, ti)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    prog = (
        "import sys\n"
        "import raft_tpu_torch.core.interruptible, raft_tpu_torch.core.tree\n"
        "import raft_tpu_torch.analysis.threads.runtime\n"
        "import raft_tpu_torch.obs, raft_tpu_torch.obs.crash\n"
        "import raft_tpu_torch.resilience.deadline\n"
        "import raft_tpu_torch.resilience.admission\n"
        "import raft_tpu_torch.cache.cache\n"
        "import raft_tpu_torch.serving.result_cache\n"
        "import raft_tpu_torch.serving.executor\n"
        "import raft_tpu_torch.serving.open_loop\n"
        "import raft_tpu_torch.testing.load\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'raft_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout
