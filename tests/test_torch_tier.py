"""PyTorch port of the cold tier (raft_tpu_torch tier/ and the load feed
of resilience/replica, serving/tier_rows) against the JAX package, on the
CPU.

Each test runs the JAX ``TieredListStore`` and the port's over the same
index (a JAX index carried across with the port's ``interop`` functions)
through the same call sequence, as tests/test_tier.py does for the JAX
store alone. The fixture is tests/test_torch_mutation.py's integer-exact
one (integer rows, queries and centroids), so searched distances match
bitwise and ids up to ties (ROADMAP note R1); policy plans and counters
match exactly (the host probe replay is the same numpy code on the same
arrays in both packages). The 4x-capacity acceptance runs on Gaussian
rows, as the reference's does. Where the reference asserts that a flip
never retraces its program, the port asserts that it builds no
extension (the on-card no-host-sync check is in tests/test_torch_gpu.py).
The row is checked for shape and accounting only, never for a rate
(ROADMAP note R8).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from raft_tpu.obs import metrics as jobsm
from raft_tpu.obs.flight import FlightRecorder as JFlightRecorder
from raft_tpu.resilience.replica import measured_list_load as j_measured
from raft_tpu.resilience.replica import record_list_load as j_record
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import ivf_flat_build as j_ivf_flat_build
from raft_tpu.spatial.ann import mutation as jmut
from raft_tpu.spatial.ann.ivf_flat import ivf_flat_search_grouped as j_grouped
from raft_tpu.testing import chaos as jchaos
from raft_tpu.tier import PromotionPolicy as JPolicy
from raft_tpu.tier import SlabFetcher as JFetcher
from raft_tpu.tier import TieredListStore as JStore
from raft_tpu.tier.store import _resolve_slots as j_resolve_slots
from raft_tpu_torch import _build
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.obs import metrics as tobsm
from raft_tpu_torch.obs.flight import FlightRecorder
from raft_tpu_torch.resilience import measured_list_load, record_list_load
from raft_tpu_torch.serving import ServingExecutor
from raft_tpu_torch.spatial.ann import (
    ivf_flat_index_from_arrays,
    ivf_sq_index_from_arrays,
)
from raft_tpu_torch.spatial.ann import mutation as tmut
from raft_tpu_torch.spatial.ann.ivf_flat import ivf_flat_search_grouped
from raft_tpu_torch.spatial.ann.ivf_sq import ivf_sq_search_grouped
from raft_tpu_torch.tier import PromotionPolicy, SlabFetcher, TieredListStore
from raft_tpu_torch.tier.store import StagedQueries, _resolve_slots
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties
from tests.test_torch_ivf_flat import _leaves as flat_leaves
from tests.test_torch_mutation import (
    CAP,
    D,
    N_LISTS,
    _carry,
    _int_rows,
    _jax_index,
)
from tests.test_torch_sq import _leaves as sq_leaves

torch.set_num_threads(1)

K = 5
N_PROBES = 4
NQ = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset():
    return _int_rows(5)


@pytest.fixture(scope="module")
def indexes(dataset):
    """The JAX flat index (integer centroids) and its port carry."""
    j = _jax_index("flat", dataset[0])
    return j, ivf_flat_index_from_arrays(flat_leaves(j), j.metric,
                                         device="cpu")


def make_stores(indexes, n_slots=N_LISTS, **kw):
    jidx, tidx = indexes
    j = JStore(jidx, n_slots=n_slots, registry=jobsm.MetricRegistry(), **kw)
    t = TieredListStore(tidx, n_slots=n_slots,
                        registry=tobsm.MetricRegistry(), **kw)
    return j, t


def queries(dataset, nq=NQ):
    return dataset[1][:nq]


def exact_rows(dataset, nq=NQ):
    return dataset[0][:nq]


def search_both(j, t, q, **kw):
    jv, ji = j.search(q, K, n_probes=N_PROBES, **kw)
    tv, ti = t.search(q, K, n_probes=N_PROBES, **kw)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def assert_same_answer(a, b):
    (jv, ji), (tv, ti) = a, b
    assert tv.tobytes() == jv.tobytes()
    _assert_ids_equal_up_to_ties(jv, ji, ti)


def assert_same_counters(j, t):
    js, ts = j.stats(), t.stats()
    for f in ("n_lists", "n_slots", "hot_lists", "probe_hits",
              "probe_misses", "fetches", "demotions", "invalidations",
              "overlapped_fetches", "hot_bytes", "epoch", "last_recall"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(t.hot_lists(), j.hot_lists())
    np.testing.assert_array_equal(t.measured_load(), j.measured_load())


def view_mask(store):
    return np.asarray(store.runtime()["tier"].row_mask)


# ------------------------------------------------------------- the store
class TestStoreBasics:
    def test_budget_resolves_slots(self, indexes):
        jidx, _ = indexes
        L = int(jidx.storage.max_list)
        slab = L * D * 4                      # f32 slab bytes
        for budget in (4 * slab, 4 * slab + slab - 1, 10 ** 12, 1):
            j, t = make_stores(indexes, n_slots=None,
                               hbm_budget_bytes=budget)
            assert t.n_slots == j.n_slots
        assert make_stores(indexes, n_slots=None,
                           hbm_budget_bytes=4 * slab)[1].n_slots == 4
        for args in ((3, None, 7, 16, 4, 12), (None, 1000, 7, 16, 4, 12),
                     (40, None, 7, 16, 1, 12), (None, 10 ** 9, 7, 16, 1, 12)):
            assert _resolve_slots(*args) == j_resolve_slots(*args)
        for kw in ({"n_slots": 4, "hbm_budget_bytes": slab}, {}):
            with pytest.raises(terrors.RaftLogicError):
                TieredListStore(indexes[1], **kw)
        with pytest.raises(terrors.RaftLogicError):
            _resolve_slots(0, None, 7, 16, 4, 12)

    def test_membership_promote_demote(self, indexes):
        j, t = make_stores(indexes, n_slots=4)
        for s in (j, t):
            assert s.hot_lists().tolist() == []
            assert s.promote([3, 1, 3]) == 2          # dup is a no-op
            assert s.hot_lists().tolist() == [1, 3]
            assert s.promote([0, 2, 5]) == 2          # stops when full
            assert s.demote([3, 9]) == 1              # cold 9 is a no-op
            assert s.hot_lists().tolist() == [0, 1, 2]
            assert "hot=3/12" in repr(s)
        assert_same_counters(j, t)
        assert t.stats().fetches == 4 and t.stats().demotions == 1
        assert t.runtime()["tier"].version == j.runtime()["tier"].version
        np.testing.assert_array_equal(view_mask(t), view_mask(j))
        for lid in (0, 1, 2, 7):
            for a, b in zip(t.fetch_slab(lid), j.fetch_slab(lid)):
                np.testing.assert_array_equal(a, b)

    def test_all_hot_matches_full_program(self, indexes, dataset):
        j, t = make_stores(indexes)
        for s in (j, t):
            s.promote(range(N_LISTS))
        q = queries(dataset)
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        # the port's tier against its own resident legacy search
        rv, ri = ivf_flat_search_grouped(indexes[1], torch.as_tensor(q), K,
                                         n_probes=N_PROBES, qcap=NQ,
                                         use_kernel=False)
        assert b[0].tobytes() == rv.numpy().tobytes()
        _assert_ids_equal_up_to_ties(b[0], b[1], ri.numpy())
        jv, _ = j_grouped(indexes[0], q, K, n_probes=N_PROBES, qcap=NQ)
        assert b[0].tobytes() == np.asarray(jv).tobytes()
        assert t.measure_recall(q, K, n_probes=N_PROBES) == 1.0
        assert j.measure_recall(q, K, n_probes=N_PROBES) == 1.0
        assert t.stats().hit_rate == 1.0
        assert_same_counters(j, t)

    def test_all_cold_serves_empty_and_counts_misses(self, indexes,
                                                     dataset):
        j, t = make_stores(indexes, n_slots=2)
        a, b = search_both(j, t, queries(dataset))
        assert np.all(b[1] == -1) and np.all(a[1] == -1)
        assert np.all(np.isinf(b[0]))
        s = t.stats()
        assert s.probe_misses == NQ * N_PROBES and s.probe_hits == 0
        assert_same_counters(j, t)

    def test_validation(self, indexes, dataset):
        _, t = make_stores(indexes, n_slots=2)
        with pytest.raises(terrors.RaftLogicError):
            t.search(np.zeros((2, D + 1), np.float32), K)
        with pytest.raises(terrors.RaftLogicError):
            t.search(queries(dataset), 10 ** 6)
        with pytest.raises(terrors.RaftLogicError):
            t.promote([N_LISTS])
        with pytest.raises(terrors.RaftLogicError):
            TieredListStore(np.zeros((4, 4)), n_slots=1)

    def test_partial_hot_serves_from_hot_only(self, indexes, dataset):
        """Probes landing cold contribute nothing; every id returned
        comes from a HOT list's rows, as JAX's tier answers."""
        j, t = make_stores(indexes, n_slots=4)
        for s in (j, t):
            s.promote([0, 1, 2, 3])
        a, b = search_both(j, t, queries(dataset, nq=16))
        assert_same_answer(a, b)
        st = indexes[1].storage
        offs, szs = st.list_offsets.numpy(), st.list_sizes.numpy()
        sids = st.sorted_ids.numpy()
        hot_ids = set()
        for lid in (0, 1, 2, 3):
            hot_ids |= set(sids[offs[lid]:offs[lid] + szs[lid]].tolist())
        assert any(int(g) >= 0 for g in b[1].ravel())
        for got in b[1].ravel():
            assert got == -1 or int(got) in hot_ids
        assert_same_counters(j, t)

    def test_load_feed_and_touch_signal(self, indexes, dataset):
        """The per-list series and the decayed touch signal equal JAX's
        after the same searches; the 64-series bound folds the rest into
        list="other" alike."""
        j, t = make_stores(indexes, n_slots=2, shard=9101)
        for nq in (NQ, 5, 12):
            search_both(j, t, queries(dataset, nq))
        load = measured_list_load(N_LISTS, shard=9101)
        np.testing.assert_array_equal(load, j_measured(N_LISTS, shard=9101))
        assert load.sum() == (NQ + 5 + 12) * N_PROBES
        touch = t.measured_load()
        np.testing.assert_array_equal(touch > 0, load > 0)
        assert_same_counters(j, t)
        treg, jreg = tobsm.MetricRegistry(), jobsm.MetricRegistry()
        rows = np.random.default_rng(0).integers(0, 5, 100)
        for reg, rec in ((treg, record_list_load), (jreg, j_record)):
            rec(rows, shard=3, registry=reg)
            rec(rows[::-1].copy(), shard=3, registry=reg)

        def series(reg):
            return sorted((i.labels["list"], i.value)
                          for i in reg.series("serving_list_rows_total"))

        assert series(treg) == series(jreg)
        assert len(series(treg)) == 65 and dict(series(treg))["other"] > 0
        np.testing.assert_array_equal(
            measured_list_load(100, registry=treg),
            j_measured(100, registry=jreg))

    def test_membership_and_tombstone_flips_build_nothing(
            self, indexes, dataset, monkeypatch):
        """The counterpart of the reference's zero-retrace audit: after
        promote, demote and a tombstone flip the tier answers as JAX's
        does, and no extension was built or loaded."""
        def no_build(*_a, **_k):
            raise AssertionError("a tier flip built an extension")

        monkeypatch.setattr(_build, "build_all", no_build)
        monkeypatch.setattr(_build, "load", no_build)
        libs = dict(_build._LIBS)
        j, t = make_stores(indexes, n_slots=4)
        q = queries(dataset)
        assert_same_answer(*search_both(j, t, q))
        for s in (j, t):
            s.promote([0, 1, 2, 3])
        assert_same_answer(*search_both(j, t, q))
        for s in (j, t):
            s.demote([1])
            s.promote([7])
        assert_same_answer(*search_both(j, t, q))
        for s in (j, t):
            with s._install:
                s._mask_np = s._mask_np.copy()
                s._mask_np[5] = 0
                s._publish()
        assert_same_answer(*search_both(j, t, q))
        np.testing.assert_array_equal(view_mask(t), view_mask(j))
        assert _build._LIBS == libs


# ------------------------------------------------------- promotion policy
class TestPromotionPolicy:
    def test_fills_free_slots_hottest_first(self):
        load = np.array([0.0, 9.0, 1.0, 5.0, 3.0])
        slot_of = np.full(5, -1, np.int32)
        moves = PromotionPolicy(min_touches=2.0, max_moves=4).plan(
            load, slot_of, n_slots=2)
        assert moves == JPolicy(min_touches=2.0, max_moves=4).plan(
            load, slot_of, n_slots=2)
        assert moves == [(1, None), (3, None)]   # 9 then 5; 1 < floor

    def test_hysteresis_blocks_marginal_swaps(self):
        slot_of = np.array([0, -1, 1, -1], np.int32)   # hot: 0, 2
        for load, want in ((np.array([10.0, 14.0, 20.0, 0.0]), []),
                           (np.array([10.0, 20.0, 30.0, 0.0]), [(1, 0)])):
            got = PromotionPolicy(demote_margin=1.5).plan(load, slot_of, 2)
            assert got == JPolicy(demote_margin=1.5).plan(load, slot_of, 2)
            assert got == want

    def test_max_moves_caps_a_cycle(self):
        load = np.arange(1.0, 7.0)
        slot_of = np.full(6, -1, np.int32)
        moves = PromotionPolicy(max_moves=2).plan(load, slot_of, 6)
        assert moves == JPolicy(max_moves=2).plan(load, slot_of, 6)
        assert moves == [(5, None), (4, None)]

    def test_pick_victim_honors_exclude_and_margin(self):
        p, jp = PromotionPolicy(demote_margin=1.25), JPolicy(
            demote_margin=1.25)
        load = np.array([2.0, 8.0, 4.0, 50.0])
        slot_of = np.array([0, 1, 2, -1], np.int32)
        for kw, want in (({"candidate_load": 50.0}, 0),
                         ({"candidate_load": 50.0, "exclude": [0]}, 2),
                         ({"candidate_load": 2.2}, None),
                         ({"candidate_load": 0.5}, None),
                         ({"candidate_load": 50.0, "exclude": [0, 1, 2]},
                          None)):
            got = p.pick_victim(load, slot_of, **kw)
            assert got == jp.pick_victim(load, slot_of, **kw) == want
        with pytest.raises(terrors.RaftLogicError):
            PromotionPolicy(demote_margin=0.5)
        with pytest.raises(terrors.RaftLogicError):
            PromotionPolicy(max_moves=0)


# ------------------------------------------------------- the async fetcher
def _inject_worker_crash(store, times):
    """The port's counterpart of ``raft_tpu.testing.chaos.
    inject_worker_crash``: the next ``times`` install transactions of
    ``store`` raise inside the fetcher's worker."""
    original = store.apply_moves
    remaining = [int(times)]

    def crashing(moves, **kwargs):
        if remaining[0] > 0:
            remaining[0] -= 1
            raise RuntimeError("injected fetcher worker crash")
        return original(moves, **kwargs)

    store.apply_moves = crashing

    def restore():
        store.apply_moves = original

    return restore


class TestSlabFetcher:
    def test_misses_promote_asynchronously(self, indexes, dataset):
        j, t = make_stores(indexes, n_slots=4)
        for s, F in ((j, JFetcher), (t, SlabFetcher)):
            with F(s, window=2) as f:
                s.search(queries(dataset), K, n_probes=N_PROBES)
                assert f.drain(20.0)
                assert s.stats().hot_lists == 4
            # detached on close: a later miss queues nothing
            s.search(queries(dataset, 12), K, n_probes=N_PROBES)
            assert f.stats()["pending"] == 0
        assert_same_counters(j, t)

    def test_full_hot_set_sheds_without_policy(self, indexes):
        j, t = make_stores(indexes, n_slots=2)
        for s, F in ((j, JFetcher), (t, SlabFetcher)):
            s.promote([0, 1])
            with F(s, window=2) as f:
                f.request([4, 5, 6])
                assert f.drain(20.0)
            assert s.hot_lists().tolist() == [0, 1]   # nothing thrashed
        assert_same_counters(j, t)

    def test_policy_swaps_when_margin_cleared(self, indexes):
        """With hot {0, 1} idle and the margin at 1.25x, requests for
        loaded lists 5/6/7 evict both idle lists, then 7 (20) displaces
        5 (10); a re-request of 5 bounces off the hysteresis."""
        j, t = make_stores(indexes, n_slots=2, touch_decay=1.0)
        for s, F, P in ((j, JFetcher, JPolicy), (t, SlabFetcher,
                                                 PromotionPolicy)):
            s.promote([0, 1])
            with s._lock:
                s._touch[:] = 0.0
                s._touch[[5, 6, 7]] = [10.0, 40.0, 20.0]
            with F(s, window=2, policy=P(demote_margin=1.25),
                   max_pending=32) as f:
                f.request([5, 6, 7])
                assert f.drain(20.0)
                assert set(s.hot_lists().tolist()) == {6, 7}
                assert s.stats().demotions == 3   # 0, 1, then 5
                f.request([5])                    # 10 < 1.25 * 20
                assert f.drain(20.0)
            assert set(s.hot_lists().tolist()) == {6, 7}
        assert_same_counters(j, t)

    def test_bounded_queue_drops_and_counts(self, indexes):
        j, t = make_stores(indexes, n_slots=1)
        for s, F in ((j, JFetcher), (t, SlabFetcher)):
            with F(s, window=1, max_pending=2) as f:
                # one locked enqueue: the dup dedups, the overflow drops
                assert f.request([9, 9, 10, 11, 2]) == 2
                assert f.stats()["dropped"] == 2
                assert f.drain(20.0)
                assert s.stats().hot_lists == 1   # full set sheds fills
        assert_same_counters(j, t)

    def test_overlap_stamp_via_busy_fn(self, indexes):
        j, t = make_stores(indexes, n_slots=2)
        calls = [True, False, False, False]
        for s in (j, t):
            s.promote([0], busy=True)
            s.promote([1], busy=False)
            it = iter(calls)
            s.demote([0])
            s.promote([4], busy=lambda: next(it))   # True at the start
            st = s.stats()
            assert st.overlapped_fetches == 2 and st.fetches == 3
            assert st.fetch_overlap_pct == pytest.approx(200.0 / 3)
        assert_same_counters(j, t)

    def test_worker_crash_restarts_bounded_and_counted(self, indexes):
        """A promotion-batch crash restarts the worker (counted in
        tier_fetcher_restarts_total) and the next fill proceeds."""
        j, t = make_stores(indexes, n_slots=4, name="crashy-restart")
        for s, F, inject, reg in (
                (j, JFetcher, jchaos.inject_worker_crash, jobsm),
                (t, SlabFetcher, _inject_worker_crash, tobsm)):
            restore = inject(s, times=1)
            c = reg.default_registry().counter(
                "tier_fetcher_restarts_total", tier=s.name)
            v0 = c.value
            with F(s, window=1) as f:
                f.request([4])                      # this batch crashes
                deadline = time.monotonic() + 10
                while (f.stats()["restarts"] < 1
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                assert f.stats()["restarts"] == 1 and not f.gave_up
                assert c.value - v0 == 1
                restore()
                f.request([5])                      # the restarted loop
                assert f.drain(20.0)
                assert s.hot_lists().tolist() == [5]
        assert_same_counters(j, t)

    # the final give-up re-raise IS the point — silence pytest's
    # unhandled-thread-exception warning for it
    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_worker_gives_up_after_max_restarts(self, indexes):
        """After max_restarts crashes the worker gives up: fill sink
        detached, a tier_fetcher_gave_up flight event, the final
        exception counted in thread_uncaught_total — in both packages."""
        stats = []
        for pkg in ("jax", "port"):
            reg = jobsm if pkg == "jax" else tobsm
            prev = reg.set_enabled(True)
            try:
                rec = (JFlightRecorder if pkg == "jax" else FlightRecorder)(
                    256, name="crashy")
                jidx, tidx = indexes
                S, F = ((JStore, JFetcher) if pkg == "jax"
                        else (TieredListStore, SlabFetcher))
                s = S(jidx if pkg == "jax" else tidx, n_slots=4,
                      name=f"crashy-giveup-{pkg}", flight=rec,
                      registry=reg.MetricRegistry())
                (jchaos.inject_worker_crash if pkg == "jax"
                 else _inject_worker_crash)(s, times=99)
                f = F(s, window=1, max_restarts=1,
                      name=f"crashy-giveup-fetch-{pkg}")
                try:
                    f.request([4])
                    deadline = time.monotonic() + 10
                    while (f._thread.is_alive()
                           and time.monotonic() < deadline):
                        f.request([5])
                        time.sleep(0.005)
                    assert not f._thread.is_alive() and f.gave_up
                    gave = rec.events(event="tier_fetcher_gave_up")
                    assert gave and gave[0]["tier"] == s.name
                    assert gave[0]["max_restarts"] == 1
                    snap = reg.default_registry().snapshot()
                    assert any(
                        row["labels"].get("thread")
                        == f"crashy-giveup-fetch-{pkg}"
                        for row in snap.get("thread_uncaught_total", []))
                    assert f.request([6]) in (0, 1)
                    assert s._fill_sink is None
                    st = f.stats()
                    stats.append((st["restarts"], st["gave_up"]))
                finally:
                    f.close()
            finally:
                reg.set_enabled(prev)
        assert stats[0] == stats[1] == (2, True)


# ------------------------------------------------ mutation-epoch journal
@pytest.fixture()
def mutable(indexes):
    jm = jmut.wrap_mutable(indexes[0], delta_cap=CAP)
    return jm, _carry(jm)


def _stores_over(jm, tm, **kw):
    return (JStore(jm.index, registry=jobsm.MetricRegistry(), **kw),
            TieredListStore(tm.index, registry=tobsm.MetricRegistry(), **kw))


def _write(jm, tm, op, *args):
    jm, ja = getattr(jmut, op)(jm, *args)
    tm, ta = getattr(tmut, op)(tm, *args)
    np.testing.assert_array_equal(ja, ta)
    return jm, tm, ta


class TestMutationEpochJournal:
    def test_journal_names_changed_lists(self, mutable, dataset):
        jm, tm = mutable
        assert tmut.lists_changed_since(tm, 0) == set()
        jm1, tm1, acc = _write(jm, tm, "upsert", dataset[0][:1] * 2,
                               np.array([9001], np.int32))
        assert bool(acc[0])
        ch = tmut.lists_changed_since(tm1, 0)
        assert ch == jmut.lists_changed_since(jm1, 0) and len(ch) >= 1
        assert tmut.lists_changed_since(tm1, tm1.epoch) == set()
        jm2, _ = jmut.compact(jm1)
        tm2, _ = tmut.compact(tm1)
        for e in (tm1.epoch, 0):
            assert tmut.lists_changed_since(tm2, e) is None
            assert jmut.lists_changed_since(jm2, e) is None

    def test_journal_floor_answers_none(self, mutable):
        for m, mod in zip(mutable, (jmut, tmut)):
            m.epoch = 5
            m._epoch_journal = [(5, frozenset({1}))]
            m._journal_floor = 4                  # epochs <= 4 fell off
            assert mod.lists_changed_since(m, 4) == {1}
            assert mod.lists_changed_since(m, 3) is None

    def test_delete_between_demotion_and_repromotion(self, mutable,
                                                     dataset):
        """A delete that lands while its list is demoted: the
        re-promoted slab serves the post-write truth in both packages."""
        jm, tm = mutable
        j, t = _stores_over(jm, tm, n_slots=N_LISTS)
        for s in (j, t):
            s.promote(range(N_LISTS))
        q = exact_rows(dataset)
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        victim = int(b[1][0, 0])
        jm1, tm1, found = _write(jm, tm, "delete",
                                 np.array([victim], np.int32))
        assert bool(found[0])
        changed = tmut.lists_changed_since(tm1, 0)
        assert changed and changed == jmut.lists_changed_since(jm1, 0)
        for s, m in ((j, jm1), (t, tm1)):
            s.demote(sorted(changed))
            assert s.sync_mutations(m) == changed
            s.promote(sorted(changed))
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        assert victim not in b[1].ravel().tolist()
        assert t.stats().epoch == tm1.epoch
        np.testing.assert_array_equal(view_mask(t), view_mask(j))
        assert_same_counters(j, t)

    def test_upsert_supersede_masks_main_copy(self, mutable, dataset):
        jm, tm = mutable
        j, t = _stores_over(jm, tm, n_slots=N_LISTS)
        for s in (j, t):
            s.promote(range(N_LISTS))
        q = exact_rows(dataset)
        target = int(search_both(j, t, q)[1][1][0, 0])
        jm1, tm1, acc = _write(jm, tm, "upsert", dataset[0][:1] + 100.0,
                               np.array([target], np.int32))
        assert bool(acc[0])
        ch = t.sync_mutations(tm1)
        assert ch and ch == j.sync_mutations(jm1)
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        assert target not in b[1].ravel().tolist()
        np.testing.assert_array_equal(view_mask(t), view_mask(j))

    def test_sync_is_idempotent_and_cheap_when_current(self, mutable):
        jm, tm = mutable
        j, t = _stores_over(jm, tm, n_slots=4)
        for s, m in ((j, jm), (t, tm)):
            v0 = s.runtime()["tier"].version
            assert s.sync_mutations(m) == set()
            assert s.runtime()["tier"].version == v0   # no republish

    def test_compaction_rebuilds_on_geometry_change(self, mutable,
                                                    dataset):
        """Compaction re-buckets the slab: a store refuses to sync onto
        changed geometry, and the rebuild-with-epoch path serves the
        post-compaction truth with no spurious invalidation — or, with
        the geometry kept, the sync takes the full-refresh path."""
        jm, tm = mutable
        j, t = _stores_over(jm, tm, n_slots=N_LISTS)
        for s in (j, t):
            s.promote(range(N_LISTS))
        q = exact_rows(dataset)
        victim = int(search_both(j, t, q)[1][1][0, 0])
        jm1, tm1, _ = _write(jm, tm, "delete", np.array([victim], np.int32))
        jm2, _ = jmut.compact(jm1)
        tm2, _ = tmut.compact(tm1)
        assert tm2.epoch == jm2.epoch
        same = (int(tm2.index.storage.max_list)
                == int(tm.index.storage.max_list))
        assert same == (int(jm2.index.storage.max_list)
                        == int(jm.index.storage.max_list))
        if same:
            assert t.sync_mutations(tm2) is None
            assert j.sync_mutations(jm2) is None
        else:
            with pytest.raises(terrors.RaftLogicError):
                t.sync_mutations(tm2)
            j, t = _stores_over(jm2, tm2, n_slots=N_LISTS,
                                epoch=tm2.epoch)
            for s, m in ((j, jm2), (t, tm2)):
                s.promote(range(N_LISTS))
                assert s.sync_mutations(m) == set()
        for s in (j, t):
            s.promote(range(N_LISTS))
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        assert victim not in b[1].ravel().tolist()

    def test_journal_overflow_refreshes_with_live_tombstones(
            self, mutable, dataset):
        """A journal answer of None without a compaction (the bounded
        journal overflowed) full-refreshes with the CURRENT row_mask."""
        jm, tm = mutable
        j, t = _stores_over(jm, tm, n_slots=N_LISTS)
        for s in (j, t):
            s.promote(range(N_LISTS))
        q = exact_rows(dataset)
        victim = int(search_both(j, t, q)[1][1][0, 0])
        jm1, tm1, found = _write(jm, tm, "delete",
                                 np.array([victim], np.int32))
        assert bool(found[0])
        for s, m in ((j, jm1), (t, tm1)):
            m._epoch_journal = []
            m._journal_floor = m.epoch
            assert s.sync_mutations(m) is None
            assert s.stats().invalidations == N_LISTS
            s.promote(range(N_LISTS))
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        assert victim not in b[1].ravel().tolist()
        np.testing.assert_array_equal(view_mask(t), view_mask(j))
        assert_same_counters(j, t)


# ------------------------------------------------------ recall guardrail
class TestRecallGuardrail:
    def test_breach_counts_and_flags_degraded(self, indexes, dataset):
        jidx, tidx = indexes
        treg, jreg = tobsm.MetricRegistry(), jobsm.MetricRegistry()
        tfr, jfr = FlightRecorder(64, name="t"), JFlightRecorder(64, name="j")
        t = TieredListStore(tidx, n_slots=N_LISTS, min_recall=0.95,
                            registry=treg, flight=tfr)
        j = JStore(jidx, n_slots=N_LISTS, min_recall=0.95, registry=jreg,
                   flight=jfr)
        q = queries(dataset)
        rs = []
        for s in (j, t):
            s.promote([0, 1])
            rs.append(s.measure_recall(q, K, n_probes=N_PROBES))
            assert s.degraded
        assert rs[1] == rs[0] and rs[1] < 0.95
        assert treg.counter("tier_recall_breaches_total",
                            tier="tier").value == 1
        assert treg.gauge("tier_recall", tier="tier").value == rs[1]
        assert tfr.events(event="tier_recall_breach")
        for s in (j, t):
            s.promote(range(N_LISTS))
            assert s.measure_recall(q, K, n_probes=N_PROBES) == 1.0
            assert not s.degraded
        assert_same_counters(j, t)

    def test_recall_respects_tombstones_on_both_sides(self, mutable,
                                                      dataset):
        jm, tm = mutable
        j, t = _stores_over(jm, tm, n_slots=N_LISTS)
        for s in (j, t):
            s.promote(range(N_LISTS))
        q = exact_rows(dataset)
        ids0 = search_both(j, t, q)[1][1]
        jm1, tm1, _ = _write(jm, tm, "delete",
                             np.asarray(ids0[0, :2], np.int32))
        for s, m in ((j, jm1), (t, tm1)):
            s.sync_mutations(m)
            assert s.measure_recall(q, K, n_probes=N_PROBES) == 1.0


# --------------------------------------------- capacity x4 (acceptance)
def working_set(store, data, n_lists, probes_per_query):
    """The reference test's greedy working set: at most ``n_slots`` lists
    chosen so that as many rows as possible probe only inside them."""
    probes = store.host_probes(data, probes_per_query)
    hist = np.bincount(probes.ravel(), minlength=n_lists)
    S: set = set()
    covered = np.zeros(len(data), bool)
    for _ in range(store.n_slots):
        gain = [
            (int(((~covered)
                  & np.isin(probes, sorted(S | {c})).all(1)).sum()),
             hist[c], c)
            for c in range(n_lists) if c not in S
        ]
        S.add(int(max(gain)[2]))
        covered |= np.isin(probes, sorted(S)).all(1)
    return S, np.nonzero(covered)[0]


class TestCapacityAcceptance:
    def test_4x_capacity_at_hot_recall(self):
        """The hot budget is 1/4 of the cold slab's bytes, the traffic a
        skewed working set whose probe footprint fits it; the fetcher
        converges the hot set from misses alone, then recall >= 0.95 of
        the full-resident search on that traffic — in both packages,
        from the same working set."""
        x = np.random.default_rng(7).standard_normal(
            (2048, D)).astype(np.float32)
        jidx = j_ivf_flat_build(x, JIVFFlatParams(
            n_lists=32, kmeans_n_iters=3, seed=2))
        tidx = ivf_flat_index_from_arrays(flat_leaves(jidx), jidx.metric,
                                          device="cpu")
        L = int(jidx.storage.max_list)
        slab, budget = L * D * 4, x.nbytes // 4
        kw = dict(hbm_budget_bytes=budget, min_recall=0.95,
                  touch_decay=1.0)
        t = TieredListStore(tidx, registry=tobsm.MetricRegistry(), **kw)
        j = JStore(jidx, registry=jobsm.MetricRegistry(), **kw)
        assert t.n_slots == j.n_slots == budget // slab
        assert x.nbytes / (t.n_slots * slab) >= 4.0
        assert t.stats().hot_bytes <= budget + D * 4   # sentinel row
        P = 2     # a 4-probe footprint over 32 lists cannot fit 5 slots
        data = tidx.data_sorted[:x.shape[0]].numpy()
        S, pts = working_set(t, data, 32, P)
        assert pts.size >= NQ, "cover construction found no head"
        qs = data[pts[np.arange(64) % pts.size]]
        rounds, recalls = 6, []
        for s, F, Pol in ((j, JFetcher, JPolicy),
                          (t, SlabFetcher, PromotionPolicy)):
            pol = Pol(demote_margin=1.25, min_touches=2.0, max_moves=8)
            with F(s, window=4, policy=pol, max_pending=64) as f:
                for _ in range(rounds):
                    for b in range(0, 64, NQ):
                        s.search(qs[b:b + NQ], K, n_probes=P)
                    f.drain(30.0)
            recalls.append(float(np.mean([
                s.measure_recall(qs[b:b + NQ], K, n_probes=P)
                for b in range(0, 64, NQ)])))
            assert recalls[-1] >= 0.95
            assert not s.degraded
            assert set(s.hot_lists().tolist()) <= S
            assert s.stats().hit_rate >= (rounds - 1.5) / rounds
        assert recalls[1] == recalls[0]


# ------------------------------------------- executor runtime_provider
class TestExecutorIntegration:
    def test_provider_hands_dispatch_the_current_snapshot(
            self, indexes, dataset):
        """The tier rides ``runtime_provider``: each batch dispatches
        against the snapshot current at staging time, so a promotion
        between two submits flips the answer — to JAX's full answer —
        with no extension built; the executor's ``stage=store.stage``
        hands the host rows to the accounting."""
        j, t = make_stores(indexes)
        q = queries(dataset)
        versions = []

        def dispatch(batch, tier=None, **_rt):
            assert isinstance(batch, StagedQueries)
            versions.append(tier.version)
            return t.search(batch, K, n_probes=N_PROBES, qcap=NQ,
                            runtime=tier)

        libs = dict(_build._LIBS)
        with ServingExecutor(
            dispatch, (NQ,), dim=D, flush_age_s=0.0, device=CPU,
            runtime_provider=t.runtime, stage=t.stage,
            registry=tobsm.MetricRegistry(),
        ) as ex:
            _, ids_cold = ex.submit(q).result(timeout=60)
            assert np.all(np.asarray(ids_cold) == -1)
            t.promote(range(N_LISTS))
            d_hot, ids_hot = ex.submit(q).result(timeout=60)
        assert versions == [0, 1]
        jv, ji = j_grouped(indexes[0], q, K, n_probes=N_PROBES, qcap=NQ)
        assert np.asarray(d_hot).tobytes() == np.asarray(jv).tobytes()
        _assert_ids_equal_up_to_ties(np.asarray(jv), np.asarray(ji),
                                     np.asarray(ids_hot))
        assert _build._LIBS == libs
        # the staged host rows were accounted as JAX accounts the rows
        j.search(q, K, n_probes=N_PROBES)
        j.promote(range(N_LISTS))
        j.search(q, K, n_probes=N_PROBES)
        assert_same_counters(j, t)


# ----------------------------------------------------------- int8 SQ tier
class TestSQTier:
    def test_sq_codes_tier_as_int8(self, dataset):
        jsq = _jax_index("sq", dataset[0])
        tsq = ivf_sq_index_from_arrays(sq_leaves(jsq), device="cpu")
        j, t = make_stores((jsq, tsq))
        for s in (j, t):
            s.promote(range(N_LISTS))
        # the hot slab holds CODES: one byte per element
        assert t._hot_data.dtype == torch.int8
        assert t.stats().hot_bytes == t._hot_data.shape[0] * D
        q = queries(dataset)
        a, b = search_both(j, t, q)
        assert_same_answer(a, b)
        rv, ri = ivf_sq_search_grouped(tsq, torch.as_tensor(q), K,
                                       n_probes=N_PROBES, qcap=NQ,
                                       use_kernel=False)
        assert b[0].tobytes() == rv.numpy().tobytes()
        _assert_ids_equal_up_to_ties(b[0], b[1], ri.numpy())
        for s in (j, t):
            assert s.measure_recall(q, K, n_probes=N_PROBES) == 1.0
        assert_same_counters(j, t)


# --------------------------------------------------- the bench row
class TestColdTierRow:
    def test_cold_tier_row_tiny_config(self, indexes, dataset):
        """The row end to end at a tiny CPU config: capacity, both arms,
        recall on the template traffic and the accounting, on an index a
        few slots cannot hold — shape and accounting only."""
        from raft_tpu_torch.serving.tier_rows import cold_tier_row

        row = cold_tier_row(
            indexes[1], dataset[1], k=K, n_probes=2,
            capacity_x=4.0, buckets=(8, 16), request_size=4,
            n_templates=8, n_requests=24, chain=(1, 3), escalate=0,
            min_duration_s=0.05, max_requests=200, fracs=(0.8,),
            seed=5,
        )
        assert row["scenario"] == "cold_tier" and "error" not in row
        assert 1 <= row["n_slots"] < N_LISTS
        assert row["capacity_x"] > 1.0
        assert row["hot_qps"] > 0 and row["tiered_qps"] > 0
        assert row["program_qps"] > 0
        assert 0.0 <= row["recall_vs_hot"] <= 1.0
        assert 1 <= row["template_lists"] <= N_LISTS
        for key in ("tier_hit_rate", "tier_hit_rate_80"):
            assert 0.0 <= row[key] <= 1.0
        assert row["p99_ms_80"] > 0
        assert 0.0 <= row["fetch_overlap_pct"] <= 100.0
        assert row["tier_fetches"] >= 1
        assert isinstance(row["tier_degraded"], bool)


def test_tier_imports_neither_jax_nor_the_jax_package():
    prog = (
        "import sys\n"
        "import numpy as np\n"
        "import raft_tpu_torch.tier, raft_tpu_torch.tier.store\n"
        "import raft_tpu_torch.tier.fetch, raft_tpu_torch.tier.policy\n"
        "import raft_tpu_torch.resilience.replica\n"
        "import raft_tpu_torch.serving.tier_rows\n"
        # the store's imports at call time: SQ views, accounting, sync
        "from raft_tpu_torch.spatial.ann import IVFSQParams, ivf_sq_build\n"
        "from raft_tpu_torch.spatial.ann import mutation as m\n"
        "x = np.random.default_rng(0).standard_normal((64, 8))"
        ".astype('float32')\n"
        "idx = ivf_sq_build(x, IVFSQParams(n_lists=4), device='cpu')\n"
        "s = raft_tpu_torch.tier.TieredListStore(idx, n_slots=2)\n"
        "s.search(x[:4], 2, n_probes=2)\n"
        "mi, _ = m.delete(m.wrap_mutable(idx), np.arange(3))\n"
        "s.sync_mutations(mi)\n"
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
