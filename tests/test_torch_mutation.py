"""PyTorch port of the mutation tier (raft_tpu_torch spatial/ann/mutation)
against the JAX package, on the CPU.

Both packages start from one state: a JAX IVF index built from numpy
seeds, its centroids (and PQ codebooks) rounded to integers, wrapped by
the JAX ``wrap_mutable`` and carried across with
``interop.mutable_index_from_arrays``. Rows, queries and upserted
vectors are integers too, so every assignment distance is exact in f32
and ties resolve to the lowest index in both packages (ROADMAP note R1):
states after the same writes must match bitwise, searched distances
bitwise, ids up to ties. The JAX searches run its Pallas kernels in
interpret mode (``use_pallas=True``) or its XLA scan; the port's kernel
engine runs the scans' plain versions here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import IVFPQParams as JIVFPQParams
from raft_tpu.spatial.ann import ivf_flat_build as j_ivf_flat_build
from raft_tpu.spatial.ann import ivf_pq_build as j_ivf_pq_build
from raft_tpu.spatial.ann import mutation as jmut
from raft_tpu.spatial.ann.ivf_sq import IVFSQIndex as JIVFSQIndex
from raft_tpu_torch.spatial.ann import mutable_index_from_arrays
from raft_tpu_torch.spatial.ann import mutation as tmut
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties

torch.set_num_threads(1)

K = 5
D = 16
N_LISTS = 12
CAP = 8
CPU = torch.device("cpu")
KINDS = ("flat", "sq", "pq")


def _int_rows(seed, n=600, d=D, nq=24):
    """Clustered integer rows in [-127, 127] (the SQ codes of the dyadic
    fixture) and integer-jittered queries."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-50, 50, (6, d))
    x = (centers[rng.integers(0, 6, n)]
         + rng.integers(-5, 6, (n, d))).clip(-127, 127).astype(np.float32)
    q = (x[rng.integers(0, n, nq)]
         + rng.integers(-2, 3, (nq, d))).astype(np.float32)
    return x, q


def _jax_index(kind, x):
    """A JAX index of ``kind`` over ``x`` with integer centroids (and
    codebooks): every distance the mutation tier computes is exact."""
    if kind == "pq":
        j = j_ivf_pq_build(x, JIVFPQParams(
            n_lists=N_LISTS, pq_dim=4, pq_bits=4, kmeans_n_iters=3,
            kmeans_init="random"))
        return dataclasses.replace(j, centroids=jnp.round(j.centroids),
                                   codebooks=jnp.round(j.codebooks))
    base = j_ivf_flat_build(x, JIVFFlatParams(
        n_lists=N_LISTS, kmeans_n_iters=3, kmeans_init="random"),
        metric="sqeuclidean")
    base = dataclasses.replace(base, centroids=jnp.round(base.centroids))
    if kind == "flat":
        return base
    # the dyadic SQ index: codes ARE the integer rows (vmin = -128,
    # vscale = 1)
    return JIVFSQIndex(
        centroids=base.centroids,
        codes_sorted=base.data_sorted.astype(jnp.int8),
        vmin=jnp.full((D,), -128.0, jnp.float32),
        vscale=jnp.ones((D,), jnp.float32),
        storage=base.storage,
    )


def _leaves(obj, prefix, out):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            _leaves(v, prefix + f.name + ".", out)
        elif v is None or isinstance(v, (int, str)):
            out[prefix + f.name] = v
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def _carry(jm):
    """The port's copy of a JAX MutableIndex, through
    ``mutable_index_from_arrays``."""
    arrays = _leaves(jm, "", {})
    arrays["epoch"] = jm.epoch
    ix = jm.index
    kind = {"flat": "ivf_flat", "sq": "ivf_sq", "pq": "ivf_pq"}[jm.engine]
    return mutable_index_from_arrays(
        arrays, kind, metric=getattr(ix, "metric", None),
        pq_dim=getattr(ix, "pq_dim", None),
        pq_bits=getattr(ix, "pq_bits", None), device="cpu")


def _assert_state(jm, tm):
    """Bitwise equal mutation state, host bookkeeping included."""
    for f in ("vecs", "ids", "live", "counts"):
        np.testing.assert_array_equal(getattr(tm.delta, f).numpy(),
                                      np.asarray(getattr(jm.delta, f)), f)
    assert tm.delta.cap == jm.delta.cap
    np.testing.assert_array_equal(tm.row_mask.numpy(),
                                  np.asarray(jm.row_mask))
    np.testing.assert_array_equal(tm.id_to_pos.numpy(),
                                  np.asarray(jm.id_to_pos))
    assert tm.epoch == jm.epoch
    assert tm.dirty_lists == jm.dirty_lists
    assert tm._epoch_journal == jm._epoch_journal
    assert tm._journal_floor == jm._journal_floor


@pytest.fixture(scope="module")
def dataset():
    return _int_rows(5)


@pytest.fixture(scope="module")
def jax_indexes(dataset):
    return {kind: _jax_index(kind, dataset[0]) for kind in KINDS}


def _writes(x, rng):
    """The write script every state test runs: (op, args) pairs."""
    n = x.shape[0]
    noise = lambda m: rng.integers(-3, 4, (m, D)).astype(np.float32)  # noqa
    fresh = x[rng.integers(0, n, 10)] + noise(10)
    main_new = x[rng.integers(0, n, 3)] + noise(3)
    a_vecs = np.concatenate([fresh, main_new])
    a_ids = np.concatenate([np.arange(5000, 5010), [0, 1, 2]]).astype(
        np.int32)
    # re-upsert four delta ids, overfill one list, one negative id
    resup = x[rng.integers(0, n, 4)] + noise(4)
    crowd = np.tile(x[7], (3 * CAP, 1)) + noise(3 * CAP)
    b_vecs = np.concatenate([resup, crowd, x[:1]])
    b_ids = np.concatenate([np.arange(5000, 5004),
                            np.arange(6000, 6000 + 3 * CAP), [-1]]).astype(
                                np.int32)
    dels = np.asarray([0, 5004, 10, 11, 99999, -1, 5001], np.int32)
    return [
        ("upsert", (a_vecs, a_ids)),
        ("upsert", (b_vecs, b_ids)),
        ("delete", (dels,)),
        ("upsert", (x[:4] + noise(4), np.full(4, -1, np.int32))),
        ("delete", (np.asarray([99998, -1], np.int32),)),
    ]


def _run_writes(jm, tm, script, acks=None):
    for op, args in script:
        jm, jack = getattr(jmut, op)(jm, *args)
        tm, tack = getattr(tmut, op)(tm, *args)
        np.testing.assert_array_equal(tack, np.asarray(jack), op)
        assert tack.dtype == np.bool_
        _assert_state(jm, tm)
        if acks is not None:
            acks.append(tack)
    return jm, tm


@pytest.fixture(scope="module")
def written(dataset, jax_indexes):
    """Each kind's (JAX, port) state after the write script."""
    x, _ = dataset
    out = {}
    for kind in KINDS:
        jm = jmut.wrap_mutable(jax_indexes[kind], delta_cap=CAP)
        tm = _carry(jm)
        out[kind] = _run_writes(jm, tm, _writes(x, np.random.default_rng(3)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_carried_state_equals_the_ports_own_wrap(jax_indexes, kind):
    jm = jmut.wrap_mutable(jax_indexes[kind], delta_cap=CAP)
    tm = _carry(jm)
    _assert_state(jm, tm)
    own = tmut.wrap_mutable(tm.index, delta_cap=CAP)
    _assert_state(jm, own)
    assert own.engine == jm.engine == kind
    for t in (own.delta.vecs, own.row_mask, own.id_to_pos):
        assert t.device == CPU


@pytest.mark.parametrize("kind", KINDS)
def test_write_script_state_bitwise(dataset, jax_indexes, kind):
    """Upserts (fresh ids, superseded main and delta copies, a full
    segment, a negative id), deletes (main, delta, missing, negative)
    and all-rejected / no-op batches: accepted and found masks, delta
    segments, row_mask, dirty lists, epoch and journal equal JAX's after
    every write."""
    x, _ = dataset
    jm = jmut.wrap_mutable(jax_indexes[kind], delta_cap=CAP)
    tm = _carry(jm)
    script = _writes(x, np.random.default_rng(3))
    acks = []
    jm, tm = _run_writes(jm, tm, script, acks)
    # the script exercised what it meant to: a full segment rejected,
    # the negative id rejected, the missing and negative ids not found,
    # the last two batches no-ops
    assert acks[0].all() and acks[1][:4].all()
    assert not acks[1][4:-1].all() and not acks[1][-1]
    assert acks[2].tolist() == [True, True, True, True, False, False, True]
    assert not acks[3].any() and not acks[4].any()
    assert tm.epoch == 3 and len(tm._epoch_journal) == 3
    for e in range(4):
        assert (tmut.lists_changed_since(tm, e)
                == jmut.lists_changed_since(jm, e))


def _search_kw(jm, kind, k=K, p=4):
    kw = dict(n_probes=p, qcap=64)
    if kind == "pq":
        # a refine pool covering every probed row: both packages rescore
        # all of them in exact f32
        kw["refine_ratio"] = float(p * jm.index.storage.max_list) / k + 1.0
    return kw


# ids the script deleted and did not upsert again
DEAD_IDS = {0, 5001, 5004, 10, 11}


def _live_delta(tm):
    """{id: vector} of the live delta rows."""
    ids = tm.delta.ids.reshape(-1).numpy()
    live = tm.delta.live.reshape(-1).numpy() > 0
    vecs = tm.delta.vecs.reshape(-1, D).numpy()
    return {int(i): vecs[j] for j, i in enumerate(ids) if live[j] and i >= 0}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kernel", [False, True])
def test_mutable_search_parity(dataset, written, kind, kernel):
    """Each engine of each kind against the JAX engine of the same kind:
    distances bitwise, ids up to ties; no tombstoned id surfaces, a
    superseded copy never does (an id with a live delta copy is found at
    that copy's distance), and every live delta row is its own top-1 at
    distance 0."""
    _, q = dataset
    jm, tm = written[kind]
    live = _live_delta(tm)
    qs = np.concatenate([q, np.stack(list(live.values()))])
    kw = _search_kw(jm, kind)
    d0, i0 = jmut.mutable_search(jm, qs, K, use_pallas=kernel, **kw)
    d1, i1 = tmut.mutable_search(tm, qs, K, use_kernel=kernel, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())
    got = i1.numpy()
    assert not (set(got.ravel().tolist()) & DEAD_IDS)
    for r in range(qs.shape[0]):
        for j in range(K):
            v = live.get(int(got[r, j]))
            if v is not None:
                assert float(d1[r, j]) == float(np.sum((qs[r] - v) ** 2))
    assert (d1[q.shape[0]:, 0] == 0).all()


def test_l2_root_goes_through_f64(dataset, written):
    """metric='l2': the port's root of the squared distances through f64,
    held against np.sqrt of JAX's squared distances (note R4)."""
    _, q = dataset
    jm, tm = written["flat"]
    tl2 = tmut._with(tm, index=dataclasses.replace(tm.index, metric="l2"))
    d0, _ = jmut.mutable_search(jm, q, K, n_probes=4)
    d1, _ = tmut.mutable_search(tl2, q, K, n_probes=4)
    want = np.sqrt(np.maximum(np.asarray(d0), 0).astype(np.float64))
    np.testing.assert_array_equal(d1.numpy(), want.astype(np.float32))


def test_delta_merge_blocks_give_the_whole_batch(dataset, written,
                                                 monkeypatch):
    """The query-blocked dense delta scan returns what one block over the
    whole batch returns."""
    _, q = dataset
    _, tm = written["flat"]
    d0, i0 = tmut.mutable_search(tm, q, K, n_probes=4)
    monkeypatch.setattr(tmut, "_DELTA_BLOCK_BYTES",
                        4 * tm.delta.ids.numel() * 5)
    d1, i1 = tmut.mutable_search(tm, q, K, n_probes=4)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


def _jax_arrays(ix):
    return {key: v for key, v in _leaves(ix, "", {}).items()
            if isinstance(v, np.ndarray) or key.startswith("storage.")}


def _port_arrays(ix):
    """The port index's tensors and storage statics, keyed as JAX's."""
    out = {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if f.name == "storage":
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                out["storage." + g.name] = (w.numpy() if isinstance(
                    w, torch.Tensor) else w)
        elif isinstance(v, torch.Tensor) and not f.name.startswith("_"):
            out[f.name] = v.numpy()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_compact_without_refresh_equals_jax(written, kind):
    """compact folds survivors and live delta rows into the same storage,
    rows or codes and ids as JAX's compact of the same state (SQ
    survivors keep their codes, PQ re-encodes), with the same stats, an
    empty delta, an all-live mask and the epoch chain continued."""
    jm, tm = written[kind]
    jc, js = jmut.compact(jm)
    tc, ts = tmut.compact(tm)
    assert ts == js
    want, got = _jax_arrays(jc.index), _port_arrays(tc.index)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, key)
    _assert_state(jc, tc)
    assert int(tc.delta.counts.sum()) == 0 and bool((tc.row_mask > 0).all())
    assert tc.epoch == tm.epoch + 1 and tc.dirty_lists == set(range(N_LISTS))
    real = tm.index.storage.sorted_ids >= 0
    alive = int((real & (tm.row_mask[:-1] > 0)).sum())
    assert ts["survivors"] == alive + len(_live_delta(tm))
    assert tmut.lists_changed_since(tc, tm.epoch) is None


@pytest.mark.parametrize("kernel", [False, True])
def test_search_after_compaction_equals_jax(dataset, written, kernel):
    """The compacted IVF-Flat state searches as JAX's compacted state
    does; no deleted id comes back. (Whether a search returns the same
    ids before and after compaction is not something the reference keeps:
    a delta row is seen by every query through the dense scan before, and
    only through its list's probes after.)"""
    _, q = dataset
    jm, tm = written["flat"]
    jc, _ = jmut.compact(jm)
    tc, _ = tmut.compact(tm)
    d0, i0 = jmut.mutable_search(jc, q, K, n_probes=4, use_pallas=kernel)
    d1, i1 = tmut.mutable_search(tc, q, K, n_probes=4, use_kernel=kernel)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())
    assert not (set(i1.numpy().ravel().tolist()) & DEAD_IDS)


def test_compact_with_refresh_close_to_jax(dataset, written):
    """The warm-started refresh (bf16-operand k-means from the current
    centroids) lands within 1e-3 of JAX's centroids, and both report the
    same probe overlap on the drift queries."""
    _, q = dataset
    jm, tm = written["flat"]
    kw = dict(refresh_centroids=True, kmeans_n_iters=2, drift_queries=q,
              n_probes=4)
    jc, js = jmut.compact(jm, **kw)
    tc, ts = tmut.compact(tm, **kw)
    assert ts["refreshed"] and js["refreshed"]
    np.testing.assert_allclose(tc.index.centroids.numpy(),
                               np.asarray(jc.index.centroids), atol=1e-3)
    assert ts["probe_overlap"] == js["probe_overlap"]
    assert ts["survivors"] == js["survivors"]
    with pytest.raises(ValueError, match="drift"):
        tmut.compact(tm, refresh_centroids=True, kmeans_n_iters=2,
                     drift_queries=q, n_probes=4, min_probe_overlap=1.01)


def test_compaction_stats_and_probe_overlap_agree(dataset, written):
    _, q = dataset
    for kind in KINDS:
        jm, tm = written[kind]
        assert tmut.compaction_stats(tm) == jmut.compaction_stats(jm)
    jm, tm = written["flat"]
    c = np.asarray(jm.index.centroids)
    rng = np.random.default_rng(0)
    other = rng.standard_normal(c.shape).astype(np.float32) * 10
    for b in (c, other):
        assert tmut.probe_overlap(torch.tensor(c), b, q, 4) == \
            jmut.probe_overlap(c, b, q, 4)
    policy = tmut.CompactionPolicy(max_fill_frac=0.5)
    assert policy.should_compact(tmut.compaction_stats(tm)) == \
        jmut.CompactionPolicy(max_fill_frac=0.5).should_compact(
            jmut.compaction_stats(jm))


def test_background_compactor_lifecycle(dataset, jax_indexes):
    """Nothing to do on an empty state; one compaction in flight; the
    polled result equals compact() of the snapshot; the refresh cadence;
    a failing compaction re-raises on poll and on stop."""
    _, q = dataset
    tm = _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=4))
    bc = tmut.BackgroundCompactor(tmut.CompactionPolicy(
        max_fill_frac=0.25, refresh_every=2), kmeans_n_iters=1)
    assert not bc.maybe_submit(tm)
    v = np.tile(tm.index.centroids[0].numpy(), (3, 1))
    tm, acc = tmut.upsert(tm, v, np.arange(7500, 7503, dtype=np.int32))
    assert acc.all()
    assert bc.maybe_submit(tm)
    assert not bc.submit(tm)
    bc.join(30.0)
    new, stats = bc.poll()
    assert bc.poll() is None and not stats["refreshed"]
    want, _ = tmut.compact(tm)
    assert torch.equal(new.index.storage.sorted_ids,
                       want.index.storage.sorted_ids)
    assert torch.equal(new.index.data_sorted, want.index.data_sorted)
    assert bc.submit(new)                       # the second: refreshed
    bc.join(30.0)
    assert bc.poll()[1]["refreshed"]
    bc.stop()
    bad = tmut.BackgroundCompactor(refresh_centroids=True,
                                   drift_queries=q, n_probes=4,
                                   min_probe_overlap=1.01)
    assert bad.submit(tm)
    bad.join(30.0)
    with pytest.raises(ValueError, match="drift"):
        bad.poll()
    assert bad.submit(tm)
    with pytest.raises(ValueError, match="drift"):
        bad.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_warmup_consumes_no_delta_slot(jax_indexes, kind):
    jm = jmut.wrap_mutable(jax_indexes[kind], delta_cap=CAP)
    tm = _carry(jm)
    qc = tmut.mutable_warmup(tm, 4, k=K, n_probes=4, ingest_batch=8)
    assert qc == jmut.mutable_warmup(jm, 4, k=K, n_probes=4)
    assert int(tm.delta.counts.sum()) == 0 and bool((tm.row_mask > 0).all())
    assert bool((tm.delta.ids < 0).all()) and tm.epoch == 0


def test_wrap_rejects_sparse_ids_and_foreign_indexes(jax_indexes):
    tm = _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP))
    st = tm.index.storage
    sparse = dataclasses.replace(tm.index, storage=dataclasses.replace(
        st, sorted_ids=st.sorted_ids * 100_000))
    with pytest.raises(ValueError, match="dense"):
        tmut.wrap_mutable(sparse)
    with pytest.raises(ValueError, match="expected an IVFFlatIndex"):
        tmut.wrap_mutable(object())
    with pytest.raises(ValueError, match="delta_cap"):
        tmut.wrap_mutable(tm.index, delta_cap=0)
    with pytest.raises(ValueError, match="exceeds the candidate pool"):
        tmut.mutable_search(tm, np.zeros((2, D), np.float32),
                            4 * st.max_list + 1, n_probes=4)


def test_upsert_impl_is_the_acked_path_without_the_ack(dataset,
                                                       jax_indexes):
    """_upsert_impl (the async path) gives the acked upsert's state."""
    x, _ = dataset
    tm = _carry(jmut.wrap_mutable(jax_indexes["flat"], delta_cap=CAP))
    vecs, ids = _writes(x, np.random.default_rng(3))[0][1]
    acked, acc = tmut.upsert(tm, vecs, ids)
    delta, rm, acc2, _, _ = tmut._upsert_impl(
        tm.index.centroids, tm.delta, tm.row_mask, tm.id_to_pos,
        torch.as_tensor(vecs), torch.as_tensor(ids), tm.canon)
    np.testing.assert_array_equal(acc2.numpy(), acc)
    for f in ("vecs", "ids", "live", "counts"):
        assert torch.equal(getattr(delta, f), getattr(acked.delta, f))
    assert torch.equal(rm, acked.row_mask)
    # the input state is untouched (functional updates)
    assert int(tm.delta.counts.sum()) == 0 and bool((tm.row_mask > 0).all())


# ------------------------------------------- routing across split lists
SPLIT_CAP = 40


def _split_jax_index(kind, x):
    """A JAX index whose lists split past ``SPLIT_CAP`` rows: every piece
    holds its parent's centroid row (ids >= N_LISTS)."""
    if kind == "pq":
        j = j_ivf_pq_build(x, JIVFPQParams(
            n_lists=N_LISTS, pq_dim=4, pq_bits=4, kmeans_n_iters=3,
            kmeans_init="random", max_list_cap=SPLIT_CAP))
        return dataclasses.replace(j, centroids=jnp.round(j.centroids),
                                   codebooks=jnp.round(j.codebooks))
    j = j_ivf_flat_build(x, JIVFFlatParams(
        n_lists=N_LISTS, kmeans_n_iters=3, kmeans_init="random",
        max_list_cap=SPLIT_CAP), metric="sqeuclidean")
    return dataclasses.replace(j, centroids=jnp.round(j.centroids))


def _highest_duplicate(cents):
    """Each centroid row's highest index holding the same row."""
    c = np.asarray(cents, np.float32)
    same = (c[:, None, :] == c[None, :, :]).all(-1)
    return np.array([np.nonzero(row)[0].max() for row in same])


def _ties_to_highest(monkeypatch, module):
    """Make ``module.kmeans_predict`` send every row whose nearest
    centroid is duplicated to the highest duplicate — what the card's
    GEMM rounding can do at some batch sizes."""
    orig = module.kmeans_predict

    def predict(x, centroids):
        lbl = orig(x, centroids)
        hi = torch.as_tensor(_highest_duplicate(centroids.cpu().numpy()),
                             device=lbl.device)
        return hi[lbl.long()].to(lbl.dtype)

    monkeypatch.setattr(module, "kmeans_predict", predict)


def test_canonical_lists_maps_duplicates_to_the_lowest():
    from raft_tpu_torch.cluster.kmeans import canonical_lists

    c = torch.tensor([[1.0, 2.0], [3.0, 4.0], [1.0, 2.0], [0.0, -0.0],
                      [3.0, 4.0], [0.0, 0.0], [1.0, 2.0], [5.0, 5.0]])
    got = canonical_lists(c)
    # -0.0 and 0.0 are different bits: rows 3 and 5 stay apart
    assert got.tolist() == [0, 1, 0, 3, 1, 5, 0, 7]
    assert got.dtype == torch.int64 and got.device == c.device
    nodup = torch.arange(12.0).reshape(6, 2)
    assert canonical_lists(nodup).tolist() == list(range(6))


def test_mutable_index_carries_its_routing_table(dataset):
    """The table is made once when a MutableIndex is formed (wrap, carry,
    compaction), rides every write's state, and is never archived."""
    x, _ = dataset
    jidx = _split_jax_index("flat", x)
    cents = np.asarray(jidx.centroids)
    lowest = [int(np.nonzero((cents == r).all(1))[0].min()) for r in cents]
    tm = _carry(jmut.wrap_mutable(jidx, delta_cap=8))
    assert tm.canon.tolist() == lowest
    assert tmut.wrap_mutable(tm.index).canon.tolist() == lowest
    up, _ = tmut.upsert(tm, x[:3] + 1.0, np.arange(3) + 9000)
    assert up.canon is tm.canon
    from raft_tpu_torch.spatial.ann import interop

    assert "canon" not in interop._FIELDS[tmut.MutableIndex]


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_split_list_routing_ignores_tie_rounding(monkeypatch, dataset,
                                                 kind):
    """With ``kmeans_predict`` sending ties to the HIGHEST duplicate
    centroid, upserts (and the compaction's re-route) still land where
    the reference puts them, the lowest list sharing the centroid: the
    delta segments, masks and compacted storage equal JAX's bitwise."""
    x, _ = dataset
    jidx = _split_jax_index(kind, x)
    cents = np.asarray(jidx.centroids)
    hi = _highest_duplicate(cents)
    assert cents.shape[0] > N_LISTS and (hi != np.arange(len(hi))).any()
    jm = jmut.wrap_mutable(jidx, delta_cap=32)
    tm = _carry(jm)
    _ties_to_highest(monkeypatch, tmut)
    rng = np.random.default_rng(8)
    vecs = (x[rng.integers(0, x.shape[0], 48)]
            + rng.integers(-2, 3, (48, D))).astype(np.float32)
    ids = np.arange(7000, 7048, dtype=np.int32)
    # the patched predict really moves some of these rows
    lbl = np.asarray(tmut.kmeans_predict(torch.as_tensor(vecs),
                                         tm.index.centroids))
    assert (lbl != np.asarray(jmut.kmeans_predict(vecs, cents))).sum() >= 4
    jm, tm = _run_writes(jm, tm, [
        ("upsert", (vecs[:24], ids[:24])),
        ("upsert", (vecs[24:], ids[24:])),
        ("delete", (ids[::5],)),
    ])
    jc, _ = jmut.compact(jm)
    tc, _ = tmut.compact(tm)
    want, got = _jax_arrays(jc.index), _port_arrays(tc.index)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, key)
    _assert_state(jc, tc)
