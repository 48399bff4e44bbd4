"""The serving executor's host modules in the PyTorch port
(raft_tpu_torch) against their JAX-package counterparts, on the CPU.

Each test feeds both packages the same inputs — numpy arrays from one
seed, one scripted call sequence, one injected clock — and requires the
same outputs: admission decisions and counters, deadline/retry/hedge
arithmetic, the metric registry's exposition and snapshot, the flight
recorder's JSONL, the Poisson schedules (bitwise), the set-associative
VectorCache's state after a put/get sequence, the result cache's
lookups and counters, and the exact/semantic signatures.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from raft_tpu import errors as jerrors
from raft_tpu.cache import VectorCache as JVectorCache
from raft_tpu.obs import FlightRecorder as JFlightRecorder
from raft_tpu.obs import MetricRegistry as JMetricRegistry
from raft_tpu.resilience import AdmissionController as JAdmission
from raft_tpu.resilience import Deadline as JDeadline
from raft_tpu.resilience import HedgePolicy as JHedgePolicy
from raft_tpu.resilience import RetryPolicy as JRetryPolicy
from raft_tpu.serving import CentroidSigner as JCentroidSigner
from raft_tpu.serving import ResultCache as JResultCache
from raft_tpu.serving.result_cache import (
    exact_signatures as j_exact_signatures,
)
from raft_tpu.testing import load as jload
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.cache import VectorCache
from raft_tpu_torch.core import tree
from raft_tpu_torch.obs import FlightRecorder, MetricRegistry
from raft_tpu_torch.resilience import (
    AdmissionController,
    Deadline,
    HedgePolicy,
    RetryPolicy,
)
from raft_tpu_torch.serving import CentroidSigner, ResultCache
from raft_tpu_torch.serving.result_cache import exact_signatures
from raft_tpu_torch.testing import load

torch.set_num_threads(1)

CPU = torch.device("cpu")


class FakeClock:
    """A host clock that moves only when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ------------------------------------------------------------ admission
# one scripted sequence: (op, arg, clock advance before the op)
_ADMISSION_SCRIPT = (
    ("enqueue", 1, 0.0), ("enqueue", 2, 0.001), ("begin", 3, 0.002),
    ("enqueue", 1, 0.0), ("enqueue", 1, 0.0), ("enqueue", 3, 0.0),
    ("finish", 0, 0.010), ("begin", 1, 0.0), ("enqueue", 1, 0.0),
    ("enqueue", 2, 0.0), ("abort", 1, 0.004), ("cancel", 1, 0.0),
    ("enqueue", 1, 0.5), ("enqueue", 1, 0.0), ("enqueue", 1, 0.0),
    ("begin", 2, 0.003), ("finish", 2, 0.020), ("enqueue", 4, 0.0),
    ("enqueue", 1, 0.0),
)


def _run_admission(ctrl, clock, overload):
    out, tickets = [], []
    for op, arg, dt in _ADMISSION_SCRIPT:
        clock.advance(dt)
        try:
            if op == "enqueue":
                ctrl.enqueue(arg)
                out.append(("queued", arg))
            elif op == "begin":
                # dispatch what is queued (sheds above shrink it)
                n = min(arg, ctrl.queue_depth)
                if n:
                    tickets.append(ctrl.begin_service(n))
                    out.append(("ticket", tickets[-1]))
            elif op in ("finish", "abort") and arg < len(tickets):
                if op == "finish":
                    ctrl.finish_service(tickets[arg])
                else:
                    ctrl.abort_service(tickets[arg])
                out.append((op, arg))
            elif op == "cancel":
                ctrl.cancel_queued(arg)
                out.append(("cancelled", arg))
        except overload as e:
            out.append(("shed", None if e.retry_after_s is None
                        else round(e.retry_after_s, 12)))
        s = ctrl.stats()
        out.append(dataclasses.astuple(s) + (s.shed, s.offered,
                                             s.shed_fraction))
    return out


@pytest.mark.parametrize("kw", [
    dict(max_concurrent=2, max_queue=3),
    dict(max_concurrent=2, max_queue=3, rate=200.0, burst=3),
    dict(max_concurrent=1, max_queue=0, retry_after_s=0.25),
], ids=["queue", "rate", "fallback"])
def test_admission_decisions_and_stats_match_jax(kw):
    jclock, tclock = FakeClock(), FakeClock()
    jctrl = JAdmission(clock=jclock, registry=JMetricRegistry(), **kw)
    tctrl = AdmissionController(clock=tclock, registry=MetricRegistry(),
                                **kw)
    want = _run_admission(jctrl, jclock, jerrors.RaftOverloadError)
    got = _run_admission(tctrl, tclock, terrors.RaftOverloadError)
    assert got == want
    assert any(step[0] == "shed" for step in got if len(step) == 2)


def test_admission_blocking_admit_matches_jax():
    """The blocking gate: two admitted, the third sheds on a full queue
    (max_queue=0) with the same occupancy-priced retry_after."""
    res = []
    for ctrl_cls, mreg, overload in (
            (JAdmission, JMetricRegistry, jerrors.RaftOverloadError),
            (AdmissionController, MetricRegistry,
             terrors.RaftOverloadError)):
        clock = FakeClock()
        ctrl = ctrl_cls(max_concurrent=2, max_queue=0,
                        retry_after_s=0.5, clock=clock,
                        registry=mreg())
        seq = []
        with ctrl.admit():
            clock.advance(0.01)
            with ctrl.admit():
                clock.advance(0.02)
                try:
                    with ctrl.admit(timeout_s=0.01):
                        seq.append("admitted")
                except overload as e:
                    seq.append(("shed", round(e.retry_after_s, 12)))
        seq.append(dataclasses.astuple(ctrl.stats()))
        res.append(seq)
    assert res[0] == res[1]


# ------------------------------------------ deadline / retry / hedging
def test_deadline_matches_jax():
    for cls in (JDeadline, Deadline):
        assert not cls.unbounded().bounded
        assert cls.unbounded().remaining() == math.inf
        assert not cls.after(None).bounded
        assert cls(0.0).expired()
        assert cls.after(60.0).bounded and not cls.after(60.0).expired()
    with pytest.raises(ValueError):
        JDeadline.after(0.0)
    with pytest.raises(ValueError):
        Deadline.after(0.0)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_retry_policy_backoff_and_classification_match_jax(seed):
    jp = JRetryPolicy(max_attempts=6, base_delay_s=0.01, seed=seed)
    tp = RetryPolicy(max_attempts=6, base_delay_s=0.01, seed=seed)
    for a in range(1, 9):
        assert tp.backoff_s(a) == jp.backoff_s(a)
    pairs = ((jerrors.RaftTimeoutError("t"), terrors.RaftTimeoutError("t")),
             (TimeoutError(), TimeoutError()),
             (jerrors.RaftLogicError("x"), terrors.RaftLogicError("x")),
             (RuntimeError(), RuntimeError()))
    for je, te in pairs:
        assert tp.is_retryable(te) == jp.is_retryable(je)


def test_hedge_policy_delay_matches_jax():
    rng = np.random.default_rng(3)
    samples = rng.exponential(0.004, 300)
    kw = dict(percentile=90.0, default_delay_s=0.03, min_delay_s=0.001,
              max_delay_s=0.05, window=128, min_samples=16)
    jp, tp = JHedgePolicy(**kw), HedgePolicy(**kw)
    for i, s in enumerate(samples):
        if i % 37 == 0:
            assert tp.hedge_delay_s() == jp.hedge_delay_s()
            assert tp.n_samples == jp.n_samples
        jp.record(float(s))
        tp.record(float(s))
    assert tp.hedge_delay_s() == jp.hedge_delay_s()
    with pytest.raises(ValueError):
        HedgePolicy(percentile=0.0)


# ------------------------------------------------------- metrics, flight
def _record_metrics(reg):
    c = reg.counter("serving_requests_total", executor="a",
                    outcome="completed")
    c.inc()
    c.inc(4)
    reg.counter("serving_requests_total", executor="a",
                outcome="failed").inc(2)
    g = reg.gauge("serving_coverage_min", executor="a")
    g.set(0.75)
    g.add(0.125)
    rng = np.random.default_rng(11)
    for stage in ("queue_wait", "demux"):
        for bucket in (8, 64):
            h = reg.histogram("serving_stage_ms", executor="a",
                              stage=stage, bucket=bucket)
            for v in rng.lognormal(0.0, 2.0, 50):
                h.observe(float(v))
            h.observe(0.0)
            h.observe(3.0e7)
    return reg


def test_metric_registry_exposition_and_snapshot_match_jax():
    jreg = _record_metrics(JMetricRegistry(clock=lambda: 5.0))
    treg = _record_metrics(MetricRegistry(clock=lambda: 5.0))
    assert treg.exposition() == jreg.exposition()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.text_snapshot() == jreg.text_snapshot()
    with pytest.raises(ValueError):
        treg.gauge("serving_requests_total")


def test_merged_quantile_matches_jax():
    from raft_tpu.obs import metrics as jm
    from raft_tpu_torch.obs import metrics as tm

    jreg = _record_metrics(JMetricRegistry())
    treg = _record_metrics(MetricRegistry())
    jh = list(jreg.series("serving_stage_ms"))
    th = list(treg.series("serving_stage_ms"))
    for q in (0.0, 1.0, 50.0, 95.0, 99.0, 100.0):
        assert tm.merged_quantile(th, q) == jm.merged_quantile(jh, q)
    assert tm.merged_quantile([], 50.0) is None


def test_flight_recorder_dumps_match_jax():
    outs = []
    for cls in (JFlightRecorder, FlightRecorder):
        clock = FakeClock(1.0)
        fr = cls(capacity=6, name="t", clock=clock)
        for i in range(9):
            clock.advance(0.25)
            fr.record("submit", request_id=i, rows=i % 3 + 1)
            if i % 4 == 3:
                fr.record("dispatch", batch_id=i // 4, bucket=8,
                          requests=[i - 1, i])
        outs.append((fr.dumps("batch-fail"), fr.dropped,
                     fr.events(event="dispatch"), fr.dump("x")))
    assert outs[1] == outs[0]
    head = json.loads(outs[1][0].splitlines()[0])
    assert head["n_events"] == 6 and head["dropped"] == outs[1][1]


# ---------------------------------------------------------------- load
@pytest.mark.parametrize("kw", [
    dict(rate_rps=200.0, n_requests=300, seed=0),
    dict(rate_rps=50.0, n_requests=100, seed=9, sizes=(1, 4, 16),
         size_weights=(0.5, 0.3, 0.2)),
    dict(rate_rps=1e4, n_requests=500, seed=3, sizes=2, zipf_s=1.1,
         n_templates=64),
], ids=["constant", "size-mix", "zipf"])
def test_poisson_arrivals_bitwise_match_jax(kw):
    want = jload.poisson_arrivals(**kw)
    got = load.poisson_arrivals(**kw)
    assert got.times_s.tobytes() == want.times_s.tobytes()
    assert got.sizes.tobytes() == want.sizes.tobytes()
    if want.template_ids is None:
        assert got.template_ids is None
    else:
        assert got.template_ids.tobytes() == want.template_ids.tobytes()
    assert got.offered_qps == want.offered_qps
    assert np.array_equal(load.zipf_template_weights(16, 1.1),
                          jload.zipf_template_weights(16, 1.1))


def test_replay_fires_on_schedule_with_injected_clock():
    """replay against a fake clock: every submit fires at its offset,
    sheds are data, and the lag is what the clock says."""
    sched = load.ArrivalSchedule(times_s=np.array([0.0, 0.5, 0.5, 2.0]),
                                 sizes=np.array([1, 2, 3, 4], np.int64))
    clock = FakeClock(10.0)
    fired = []

    def submit(i, size):
        fired.append((i, size, clock()))
        if i == 2:
            raise terrors.RaftOverloadError("full", retry_after_s=0.1)
        return i

    results, stamps, lag = load.replay(sched, submit, clock=clock,
                                       sleep=clock.advance)
    assert [f[:2] for f in fired] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert list(stamps) == [10.0, 10.5, 10.5, 12.0] and lag == 0.0
    assert results[0] == 0 and results[3] == 3
    assert isinstance(results[2], terrors.RaftOverloadError)


# -------------------------------------------------------- vector cache
def _cache_state(c):
    return tuple(np.asarray(a) for a in (c.keys, c.time, c.store))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_vector_cache_sequence_matches_jax(seed):
    """A random put/get/evict sequence on a tiny geometry (4 sets x 2
    lanes: same-set collisions, updates, duplicate keys within one
    insert, more new keys per set than lanes, misses beside hits in one
    probe) leaves the same keys, time, store and clock, and returns the
    same vectors and hit masks."""
    rng = np.random.default_rng(seed)
    dim = 3
    jc = JVectorCache(dim, n_sets=4, associativity=2)
    tc = VectorCache(dim, n_sets=4, associativity=2, device=CPU)
    for step in range(40):
        op = rng.integers(0, 5)
        keys = rng.integers(0, 24, int(rng.integers(1, 7))).astype(
            np.int32)
        if op <= 1:
            vecs = rng.standard_normal((keys.size, dim)).astype(np.float32)
            jc.store_vecs(keys, vecs)
            tc.store_vecs(keys, vecs)
        elif op <= 3:
            jv, jf = jc.get_vecs(keys)
            tv, tf = tc.get_vecs(keys)
            assert np.array_equal(tf.numpy(), np.asarray(jf)), step
            assert tv.numpy().tobytes() == np.asarray(jv).tobytes(), step
        else:
            jc.evict(keys)
            tc.evict(keys)
        for a, b in zip(_cache_state(tc), _cache_state(jc)):
            assert a.tobytes() == b.tobytes(), (step, op)
        assert tc.clock == jc.clock
    assert tc.n_cached == jc.n_cached


def test_vector_cache_duplicate_keys_and_wrapping_match_jax():
    """The documented placement rules on fixed inputs: duplicates of a
    key in one insert collapse onto the first occurrence's lane holding
    the LAST occurrence's vector; more distinct new keys for one set
    than lanes wrap around the set's LRU order."""
    dim = 2
    cases = [np.array([5, 9, 5, 13, 5], np.int32),
             np.array([0, 4, 8, 12, 16], np.int32),
             np.array([3, 3, 3], np.int32)]
    jc = JVectorCache(dim, n_sets=4, associativity=2, dtype=np.float32)
    tc = VectorCache(dim, n_sets=4, associativity=2, device=CPU)
    for i, keys in enumerate(cases):
        vecs = (np.arange(keys.size * dim, dtype=np.float32).reshape(
            -1, dim) + 10 * i)
        jc.store_vecs(keys, vecs)
        tc.store_vecs(keys, vecs)
        for a, b in zip(_cache_state(tc), _cache_state(jc)):
            assert a.tobytes() == b.tobytes(), i
    probe = np.array([5, 3, 7, 9], np.int32)
    jv, jf = jc.get_vecs(probe)
    tv, tf = tc.get_vecs(probe)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()


def test_vector_cache_device_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorCache(4)


def test_result_cache_tiers_default_to_the_host():
    """The tiers live on the host unless the card is asked for; asking
    for it (``device=None``) raises without a CUDA device."""
    cache = ResultCache(4, n_sets=8, associativity=2,
                        registry=MetricRegistry())
    assert cache.device.type == "cpu"
    assert cache._exact.keys.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ResultCache(4, device=None, registry=MetricRegistry())


# ------------------------------------------------ result cache, signers
def test_exact_signatures_and_centroid_signer_match_jax():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((12, 16)).astype(np.float32)
    for salt in (b"", b"k10"):
        assert np.array_equal(exact_signatures(rows, salt),
                              j_exact_signatures(rows, salt))
    sc = rng.standard_normal((9, 16)).astype(np.float32)
    for p in (1, 2, 9, 20):
        js, ts = JCentroidSigner(sc, n_probes=p), CentroidSigner(sc,
                                                                 n_probes=p)
        assert np.array_equal(ts.super_ids(rows), js.super_ids(rows))
        assert np.array_equal(ts(rows, b"k4"), js(rows, b"k4"))

    class Coarse:
        super_cents = sc

    assert np.array_equal(CentroidSigner.from_coarse(Coarse)(rows),
                          JCentroidSigner(sc)(rows))


def _cache_script(cache, rows, results, signer_rows):
    """One lookup/insert sequence: misses, inserts, L1 hits, a regrouped
    request (tier hit), a stale epoch, and semantic hits once enabled."""
    out = []
    d, i = results
    epoch = 0
    out.append(cache.lookup(rows[:3], epoch=epoch))
    cache.insert(rows[:3], d[:3], i[:3], epoch=epoch)
    cache.insert(rows[3:6], d[3:6], i[3:6], epoch=epoch)
    out.append(cache.lookup(rows[:3], epoch=epoch))       # L1 hit
    out.append(cache.lookup(rows[1:5], epoch=epoch))      # regrouped rows
    epoch = 1                                             # a write landed
    out.append(cache.lookup(rows[3:6], epoch=epoch))      # stale
    out.append(cache.lookup(rows[3:6], epoch=epoch))      # evicted: miss
    epoch = 2
    cache.insert(rows[6:8], d[6:8], i[6:8], epoch=epoch)
    out.append(cache.lookup(rows[6:8], epoch=epoch))
    if cache.signer is not None:
        cache.semantic_enabled = True
        out.append(cache.lookup(signer_rows, epoch=epoch))  # semantic
    out.append(dataclasses.astuple(cache.stats()) + (cache.stats().hit_rate,))
    return out


@pytest.mark.parametrize("semantic", [False, True], ids=["exact",
                                                         "semantic"])
def test_result_cache_lookup_insert_match_jax(semantic):
    rng = np.random.default_rng(8)
    k, d = 4, 16
    rows = rng.standard_normal((8, d)).astype(np.float32)
    dists = np.sort(rng.random((8, k)).astype(np.float32), axis=1)
    ids = rng.integers(0, 1000, (8, k)).astype(np.int32)
    sc = rng.standard_normal((3, d)).astype(np.float32)
    # near-duplicates of cached rows 6 and 7: the same top super ids
    near = rows[6:8] + np.float32(1e-4)
    outs = []
    for cache_cls, signer_cls, reg, kw in (
            (JResultCache, JCentroidSigner, JMetricRegistry, {}),
            (ResultCache, CentroidSigner, MetricRegistry,
             {"device": CPU})):
        signer = signer_cls(sc, n_probes=1) if semantic else None
        cache = cache_cls(k, n_sets=4, associativity=2, signer=signer,
                          registry=reg(), **kw)
        outs.append(_cache_script(cache, rows, (dists, ids), near))
    assert len(outs[0]) == len(outs[1])
    for want, got in zip(*outs):
        if want is None or got is None:
            assert want is None and got is None
        elif isinstance(want, tuple) and len(want) == 2:
            assert got[0].tobytes() == np.asarray(want[0]).tobytes()
            assert got[1].tobytes() == np.asarray(want[1]).tobytes()
        else:
            assert got == want


def test_result_cache_exposition_counts_match_jax():
    """The cache's counters land in the registry under the same series."""
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((4, 8)).astype(np.float32)
    d = np.zeros((4, 2), np.float32)
    i = np.zeros((4, 2), np.int32)
    expo = []
    for cache_cls, reg, kw in ((JResultCache, JMetricRegistry, {}),
                               (ResultCache, MetricRegistry,
                                {"device": CPU})):
        r = reg()
        c = cache_cls(2, n_sets=2, associativity=2, registry=r, **kw)
        c.lookup(rows, epoch=0)
        c.insert(rows, d, i, epoch=0)
        c.lookup(rows, epoch=0)
        c.lookup(rows[::-1].copy(), epoch=0)
        expo.append(r.exposition())
    assert expo[1] == expo[0]


# ----------------------------------------------------------------- tree
@dataclasses.dataclass(frozen=True)
class _Pair:
    a: object
    b: object


def test_tree_helper_leaves_and_map():
    import collections

    NT = collections.namedtuple("NT", "x y")
    t = {"z": [1, (2, None)], "a": _Pair(NT(3, 4), {"q": 5}), "m": None}
    assert tree.leaves(t) == [3, 4, 5, 1, 2]
    doubled = tree.tree_map(lambda v: 2 * v, t)
    assert doubled == {"a": _Pair(NT(6, 8), {"q": 10}), "m": None,
                       "z": [2, (4, None)]}
    assert isinstance(doubled["a"].a, NT)
    assert tree.leaves(7) == [7] and tree.tree_map(str, 7) == "7"
