"""PyTorch port of the sharded IVF-PQ engine (raft_tpu_torch/comms/
mnmg_ivf.py) against the JAX package, on the CPU.

JAX runs on the 8-device virtual CPU mesh (tests/conftest.py), the port
in process at P = 8 (one thread per rank, every rank on the CPU). JAX's
training (its PRNG subsample, coarse k-means and PQ codebooks) cannot be
replayed in torch, so:

* the deterministic build stages — the per-rank blocked encode, the row
  exchange and the slab assembly — are fed the same integer centroids and
  integer-valued codebooks in both packages (both training steps patched)
  and must give every field of the index bitwise, on full and ragged
  shards (an empty rank included);
* searches run on a JAX-built index carried across
  (``interop.mnmg_index_from_arrays``, or its ``mnmg_ivf_pq`` archive),
  under the rule of tests/test_torch_pq.py: the two packages' f32 LUT
  contractions need not agree bitwise, so distances are held bitwise
  (ids up to ties, ROADMAP note R1) only where every rank's refine pool
  saturates on integer-valued raw rows (every probed row rescored in
  exact f32), and elsewhere the port's recall@10 within 0.01 of JAX's.

The kernel engine runs the ADC scan's plain version here.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.comms import build_comms as j_build_comms
from raft_tpu.comms import mnmg_ivf as jmi
from raft_tpu.comms import place_index as j_place
from raft_tpu.resilience import FailoverPlan as JFailoverPlan
from raft_tpu.resilience import ReplicaPlacement as JPlacement
from raft_tpu.spatial.ann import IVFPQParams as JIVFPQParams
from raft_tpu.spatial.ann import load_index as j_load
from raft_tpu.spatial.ann import save_index as j_save
from raft_tpu.spatial.ann.ivf_pq import _encode_rows as j_encode_rows
from raft_tpu_torch.comms import (
    MnmgIVFPQIndex,
    build_comms,
    mnmg_ivf_pq_build,
    mnmg_ivf_pq_build_distributed,
    mnmg_ivf_pq_search,
    place_index,
    recover_rank,
)
from raft_tpu_torch.comms import mnmg_ivf as tmi
from raft_tpu_torch.resilience import (
    FailoverPlan,
    PartialSearchResult,
    ReplicaPlacement,
)
from raft_tpu_torch.spatial.ann import (
    IVFPQParams,
    ivf_pq,
    ivf_pq_build,
    ivf_pq_search_grouped,
    load_index,
    mnmg_index_from_arrays,
    save_index,
)
from tests.oracles import np_knn_ids
from tests.test_torch_ivf_flat import (
    _assert_ids_equal_up_to_ties,
    _int_dataset,
)

torch.set_num_threads(1)

P8 = 8
K = 5
N_PROBES = 6
NL = 24
M, BITS = 4, 4
PARAMS = dict(n_lists=NL, pq_dim=M, pq_bits=BITS, kmeans_n_iters=4,
              kmeans_init="random", seed=1)


@pytest.fixture(scope="module")
def jc():
    return j_build_comms(jax.devices()[:P8])


@pytest.fixture(scope="module")
def tc():
    return build_comms(["cpu"] * P8, timeout_s=120.0)


@pytest.fixture(scope="module")
def dataset():
    return _int_dataset(7)


def _leaves(j):
    """A JAX sharded index's leaves and statics, keyed by field name (the
    coarse quantizer's under ``coarse.``)."""
    out = {}
    for f in dataclasses.fields(j):
        v = getattr(j, f.name)
        if f.name == "coarse":
            if v is not None:
                for g in dataclasses.fields(v):
                    w = getattr(v, g.name)
                    out["coarse." + g.name] = (
                        np.asarray(w) if hasattr(w, "shape") else w)
            continue
        out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


def carry(j, comms):
    return mnmg_index_from_arrays(_leaves(j), comms=comms)


@pytest.fixture(scope="module")
def jidx(jc, dataset):
    """The JAX sharded PQ index over the integer fixture, its centroids
    rounded to integers (so both packages probe the same lists)."""
    x, _ = dataset
    j = jmi.mnmg_ivf_pq_build(jc, x, JIVFPQParams(**PARAMS))
    return dataclasses.replace(j, centroids=jnp.round(j.centroids),
                               local_cents=jnp.round(j.local_cents))


@pytest.fixture(scope="module")
def tidx(jidx, tc):
    return carry(jidx, tc)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _saturating(index, p, k):
    """A refine ratio whose pool covers every probed row on every rank."""
    return float(p * index.max_list) / k + 1.0


def assert_same_answer(jout, tout):
    jd, ji = (np.asarray(a) for a in jout)
    td, ti = (_np(a) for a in tout)
    assert td.tobytes() == jd.astype(np.float32).tobytes()
    _assert_ids_equal_up_to_ties(jd, ji, ti)


def jsearch(jc, j, q, **kw):
    kw.setdefault("qcap", q.shape[0])
    kw.setdefault("refine_ratio", _saturating(j, N_PROBES, K))
    return jmi.mnmg_ivf_pq_search(jc, j, jnp.asarray(q), K,
                                  n_probes=N_PROBES, **kw)


def tsearch(tc, t, q, **kw):
    kw.setdefault("qcap", q.shape[0])
    kw.setdefault("refine_ratio", _saturating(t, N_PROBES, K))
    return mnmg_ivf_pq_search(tc, t, torch.as_tensor(q), K,
                              n_probes=N_PROBES, **kw)


def recall(ids, true):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(np.asarray(ids), true)) / true.size


# ---------------------------------------------------------------- build
def _ragged(x_all):
    """Ragged per-rank shards (rank 2 empty): (stacked (P, n_loc, d) f32,
    n_valid)."""
    n_valid = np.array([220, 180, 0, 240, 90, 200, 260, 40], np.int32)
    nloc = 260
    starts = np.concatenate([[0], np.cumsum(n_valid)[:-1]])
    xs = np.zeros((P8, nloc, x_all.shape[1]), np.float32)
    for r in range(P8):
        xs[r, :n_valid[r]] = x_all[starts[r]:starts[r] + n_valid[r]]
    return xs, n_valid


def _shards(jc, dataset, layout):
    x, _ = dataset
    if layout == "ragged":
        return _ragged(x)
    xg, n_valid = jmi.shard_rows(jc, x)
    return np.array(xg), n_valid


def _jax_sharded(jc, xs):
    import jax.sharding as jsh

    sh = jsh.NamedSharding(jc.mesh, jsh.PartitionSpec(jc.axis, None, None))
    return jax.device_put(jnp.asarray(xs), sh)


def _int_quantizers(x, seed=3):
    """Integer centroids (distinct data rows) and integer-valued
    codebooks: every encode distance is exact in f32, so labels and codes
    (ties to the lowest index in both packages) agree bitwise."""
    rng = np.random.default_rng(seed)
    cents = x[rng.choice(x.shape[0], NL, replace=False)].copy()
    cbs = rng.integers(-6, 7, (M, 1 << BITS, x.shape[1] // M)).astype(
        np.float32)
    return cents, cbs


@pytest.mark.parametrize("layout", ["full", "ragged"])
def test_blocked_encode_matches_jax(tc, dataset, layout, jc):
    """The per-rank blocked encode (blocks of 64 rows, padding rows
    included) against JAX's ``_encode_rows`` on each rank's rows: labels,
    codes and the allgathered count matrix bitwise."""
    xs, n_valid = _shards(jc, dataset, layout)
    cents, cbs = _int_quantizers(dataset[0])
    lbl, codes, C = tmi._encode_ranks(
        tc, torch.as_tensor(xs), n_valid, torch.as_tensor(cents),
        torch.as_tensor(cbs), NL, M, 64)
    ds = xs.shape[2] // M
    want_c = np.zeros((P8, NL), np.int32)
    for r in range(P8):
        jl, jcodes = j_encode_rows(jnp.asarray(xs[r]), jnp.asarray(cents),
                                   jnp.asarray(cbs), M, ds)
        np.testing.assert_array_equal(lbl[r].numpy(), np.asarray(jl))
        assert codes[r].numpy().tobytes() == np.asarray(jcodes).tobytes()
        want_c[r] = np.bincount(np.asarray(jl)[:n_valid[r]], minlength=NL)
    np.testing.assert_array_equal(C.numpy(), want_c)


def _patch_training(monkeypatch, cents, cbs):
    monkeypatch.setattr(jmi, "_train_coarse_distributed", lambda *a, **kw: (
        None, types.SimpleNamespace(centroids=jnp.asarray(cents))))
    monkeypatch.setattr(jmi, "_train_pq_codebooks",
                        lambda *a, **kw: jnp.asarray(cbs))
    monkeypatch.setattr(tmi, "_train_coarse_distributed", lambda *a, **kw: (
        None, types.SimpleNamespace(centroids=torch.as_tensor(cents))))
    monkeypatch.setattr(tmi, "_train_pq_codebooks",
                        lambda *a, **kw: torch.as_tensor(cbs))


@pytest.mark.parametrize("layout,cap,store_raw",
                         [("full", None, True), ("ragged", 64, True),
                          ("full", 0, False)])
def test_whole_build_bitwise(jc, tc, dataset, layout, cap, store_raw,
                             monkeypatch):
    """The whole distributed build with both packages' training patched
    to the same integer quantizers: every field of the index bitwise
    (the encode, the oversized-list split, LPT ownership, the exchange
    rounds with the code payload and the slab assembly)."""
    xs, n_valid = _shards(jc, dataset, layout)
    cents, cbs = _int_quantizers(dataset[0], seed=4)
    _patch_training(monkeypatch, cents, cbs)
    params = dict(PARAMS, max_list_cap=cap, store_raw=store_raw,
                  encode_block=100)
    j = jmi.mnmg_ivf_pq_build_distributed(
        jc, _jax_sharded(jc, xs), JIVFPQParams(**params), n_valid=n_valid)
    t = mnmg_ivf_pq_build_distributed(
        tc, torch.as_tensor(xs), IVFPQParams(**params), n_valid=n_valid)
    assert isinstance(t, MnmgIVFPQIndex)
    for key, v in _leaves(j).items():
        got = getattr(t, key)
        if isinstance(v, np.ndarray):
            assert _np(got).dtype == v.dtype, key
            assert _np(got).tobytes() == v.tobytes(), key
        else:
            assert got == v, key
    # every valid row lands exactly once
    szs, sids = _np(t.list_sizes), _np(t.sorted_ids)
    got = np.concatenate([sids[r, :szs[r].sum()] for r in range(P8)])
    np.testing.assert_array_equal(np.sort(got), np.arange(n_valid.sum()))


def test_port_build_recall_and_coverage(tc):
    """The port's own build (its own subsample, k-means and codebooks) on
    Gaussian blobs: every row in exactly one slab, and recall@10 at least
    the single-device index's minus 0.02 (the JAX test's rule), above
    0.85."""
    x, q = _blobs()
    params = IVFPQParams(n_lists=32, pq_dim=4, kmeans_n_iters=6, seed=3,
                         max_list_cap=512)
    t = mnmg_ivf_pq_build(tc, x, params)
    szs, sids = _np(t.list_sizes), _np(t.sorted_ids)
    got = np.concatenate([sids[r, :szs[r].sum()] for r in range(P8)])
    np.testing.assert_array_equal(np.sort(got), np.arange(x.shape[0]))
    true = np_knn_ids(x, q, 10)
    single = ivf_pq_build(x, params, device="cpu")
    _, i1 = ivf_pq_search_grouped(single, q, 10, n_probes=16,
                                  refine_ratio=4.0, qcap=q.shape[0])
    d2, i2 = mnmg_ivf_pq_search(tc, t, torch.as_tensor(q), 10, n_probes=16,
                                refine_ratio=4.0, qcap=q.shape[0])
    r1, r2 = recall(i1, true), recall(i2, true)
    assert r2 >= r1 - 0.02 and r2 > 0.85, (r1, r2)
    # merged distances are the exact squared L2 of the returned rows
    exact = ((q[:, None, :] - x[i2.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy(), exact, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------- search
@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
@pytest.mark.parametrize("qcap", [64, 8])
def test_saturated_search_matches_jax(jc, tc, dataset, jidx, tidx, engine,
                                      qcap):
    """Every rank's refine pool covers its probed rows: distances bitwise
    JAX's and ids up to ties, at a qcap that fits every probe and one
    that drops pairs (the sentinel list overflows at any qcap)."""
    _, q = dataset
    assert_same_answer(jsearch(jc, jidx, q, qcap=qcap),
                       tsearch(tc, tidx, q, qcap=qcap, use_kernel=engine))


def _blobs(seed=5, n=4000, d=16, nq=192):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 40, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    q = x[rng.integers(0, n, nq)] + 0.2 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def blob_case(jc, tc):
    x, q = _blobs()
    j = jmi.mnmg_ivf_pq_build(jc, x, JIVFPQParams(
        n_lists=32, pq_dim=4, kmeans_n_iters=6, seed=3, max_list_cap=512))
    return x, q, j, carry(j, tc)


@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_unsaturated_recall_within_jax(jc, tc, blob_case, engine):
    """refine_ratio 2 and 4 on Gaussian blobs: the two packages' LUTs may
    rank a pool boundary differently, so recall@10 is held within 0.01
    of JAX's; the merged distances are the exact distances of the
    returned rows."""
    x, q, j, t = blob_case
    true = np_knn_ids(x, q, 10)
    for rr in (2.0, 4.0):
        kw = dict(n_probes=8, refine_ratio=rr, qcap=q.shape[0])
        _, ji = jmi.mnmg_ivf_pq_search(jc, j, jnp.asarray(q), 10, **kw)
        td, ti = mnmg_ivf_pq_search(tc, t, torch.as_tensor(q), 10,
                                    use_kernel=engine, **kw)
        assert recall(ti, true) >= recall(ji, true) - 0.01, rr
        exact = ((q[:, None, :] - x[ti.numpy()]) ** 2).sum(-1)
        np.testing.assert_allclose(td.numpy(), exact, rtol=1e-4, atol=1e-3)


def test_unrefined_codes_only_within_jax(jc, tc, blob_case):
    """An index without raw rows searches unrefined (ADC sums on the
    one-hot engine): recall within 0.01 of JAX's."""
    x, q, j, _ = blob_case
    j = dataclasses.replace(j, vectors_sorted=None)
    t = carry(j, tc)
    assert t.vectors_sorted is None
    true = np_knn_ids(x, q, 10)
    kw = dict(n_probes=8, refine_ratio=4.0, qcap=q.shape[0])
    _, ji = jmi.mnmg_ivf_pq_search(jc, j, jnp.asarray(q), 10, **kw)
    _, ti = mnmg_ivf_pq_search(tc, t, torch.as_tensor(q), 10, **kw)
    assert recall(ti, true) >= recall(ji, true) - 0.01
    with pytest.raises(ValueError, match="refine"):
        mnmg_ivf_pq_search(tc, t, torch.as_tensor(q), 10, use_kernel=True,
                           **kw)


def _partial_equal(jres, tres):
    assert isinstance(tres, PartialSearchResult)
    assert_same_answer((jres.distances, jres.ids),
                       (tres.distances, tres.ids))
    assert tres.coverage.numpy().tobytes() == \
        np.asarray(jres.coverage).tobytes()
    np.testing.assert_array_equal(tres.row_valid.numpy(),
                                  np.asarray(jres.row_valid))
    assert tres.partial == jres.partial


@pytest.mark.parametrize("down", [(3,), (0, 5)])
@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_degraded_matches_jax(jc, tc, dataset, jidx, tidx, down, engine):
    """Ranks down and a NaN query row: distances, ids, coverage,
    row_valid and the partial flag as JAX's; no id of a down rank's
    lists appears."""
    _, q = dataset
    q = q.copy()
    q[5, 2] = np.nan
    mask = np.ones(P8, np.int32)
    mask[list(down)] = 0
    jres = jsearch(jc, jidx, q, shard_mask=mask)
    tres = tsearch(tc, tidx, q, shard_mask=mask, use_kernel=engine)
    _partial_equal(jres, tres)
    assert tres.partial and (tres.ids[5].numpy() == -1).all()
    offs, sids = _np(tidx.list_offsets), _np(tidx.sorted_ids)
    for r in down:
        lost = set(sids[r, :offs[r, -1]].tolist())
        assert not lost & set(tres.ids.numpy().ravel().tolist())


@pytest.fixture(scope="module")
def replicated(jc, tc, jidx, tidx):
    return (j_place(jc, jidx, replication=2),
            place_index(tc, tidx, replication=2))


def test_replicated_layout_and_failover(jc, tc, dataset, tidx, replicated):
    """Replication 2: the layout bitwise JAX's; rank 3 down with a
    FailoverPlan serves at coverage 1.0, bitwise the healthy search and
    JAX's."""
    j, t = replicated
    for key, v in _leaves(j).items():
        got = getattr(t, key)
        if isinstance(v, np.ndarray):
            assert _np(got).tobytes() == v.tobytes(), key
        else:
            assert got == v, key
    _, q = dataset
    healthy = tsearch(tc, tidx, q)
    mask = np.ones(P8, np.int32)
    mask[3] = 0
    tplan = FailoverPlan.from_health(ReplicaPlacement.striped(P8, 2), mask)
    jplan = JFailoverPlan.from_health(JPlacement.striped(P8, 2), mask)
    for engine in (False, True):
        tres = tsearch(tc, t, q, shard_mask=mask, failover=tplan,
                       use_kernel=engine)
        np.testing.assert_array_equal(tres.coverage.numpy(), 1.0)
        assert tres.distances.numpy().tobytes() == \
            healthy[0].numpy().tobytes()
        _assert_ids_equal_up_to_ties(healthy[0].numpy(),
                                     healthy[1].numpy(), tres.ids.numpy())
    _partial_equal(jsearch(jc, j, q, shard_mask=mask, failover=jplan), tres)


def test_p8_against_p1_and_jax_reshard(jc, tc, dataset, jidx, tidx):
    """The index resharded onto one rank answers bitwise as at P = 8, and
    its layout is JAX's reshard."""
    _, q = dataset
    tc1 = build_comms(["cpu"])
    t1 = place_index(tc1, tidx)
    j1 = j_place(j_build_comms(jax.devices()[:1]), jidx)
    for key, v in _leaves(j1).items():
        got = getattr(t1, key)
        if isinstance(v, np.ndarray):
            assert _np(got).tobytes() == v.tobytes(), key
    for engine in (False, True):
        d8, i8 = tsearch(tc, tidx, q, use_kernel=engine)
        d1, i1 = tsearch(tc1, t1, q, use_kernel=engine)
        assert d1.numpy().tobytes() == d8.numpy().tobytes()
        _assert_ids_equal_up_to_ties(d8.numpy(), i8.numpy(), i1.numpy())


def test_warmup_qcap_and_merge_ways(jc, tc, dataset, jidx, tidx):
    """warmup returns JAX's shape-only qcap (the throughput rule
    included, for both variants); merge_ways pads the merge as JAX's."""
    _, q = dataset
    for nq, qcap, mask in ((8, None, None), (64, "throughput", True)):
        assert tidx.warmup(tc, nq, k=K, n_probes=N_PROBES, qcap=qcap,
                           shard_mask=mask) == \
            jidx.warmup(jc, nq, k=K, n_probes=N_PROBES, qcap=qcap,
                        shard_mask=mask)
    assert_same_answer(jsearch(jc, jidx, q, merge_ways=16),
                       tsearch(tc, tidx, q, merge_ways=16))


def _header(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__header__"]).decode())


def test_archive_both_ways(jc, tc, dataset, jidx, tidx, tmp_path):
    """``mnmg_ivf_pq`` archives: JAX's loads in the port (placed on the
    ranks), the port's loads in JAX, headers equal, the same answers."""
    _, q = dataset
    jp, tp = tmp_path / "j.npz", tmp_path / "t.npz"
    j_save(jidx, jp)
    save_index(_host(tidx), tp)
    assert _header(tp) == _header(jp)
    t_from_j = load_index(jp, comms=tc)
    assert isinstance(t_from_j, MnmgIVFPQIndex)
    j_from_t = j_place(jc, j_load(tp))
    want = jsearch(jc, jidx, q)
    assert_same_answer(want, tsearch(tc, t_from_j, q))
    assert_same_answer(jsearch(jc, j_from_t, q), tsearch(tc, tidx, q))
    # the codes-only kind round-trips too (no raw slab in the archive)
    jn = dataclasses.replace(jidx, vectors_sorted=None)
    j_save(jn, jp)
    tn = load_index(jp)
    assert tn.vectors_sorted is None
    save_index(tn, tp)
    assert _header(tp) == _header(jp)
    assert j_load(tp).vectors_sorted is None


def _host(t):
    """A placed in-process index as its host form (numpy slabs)."""
    kw = {}
    for f in dataclasses.fields(t):
        if not f.init:
            continue
        v = getattr(t, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.numpy()
    return dataclasses.replace(t, **kw)


def test_recover_rank_from_archive(tc, dataset, tidx, tmp_path):
    """A rank's wrecked slabs recovered from the archive: the answer
    bitwise the healthy one; another layout's archive is refused."""
    _, q = dataset
    path = tmp_path / "ckpt.npz"
    save_index(_host(tidx), path)
    wrecked = dataclasses.replace(
        tidx, codes_sorted=tidx.codes_sorted.clone(),
        vectors_sorted=tidx.vectors_sorted.clone(),
        sorted_ids=tidx.sorted_ids.clone())
    wrecked.codes_sorted[4] = 0
    wrecked.vectors_sorted[4] = 0
    wrecked.sorted_ids[4] = 0
    healed = recover_rank(tc, wrecked, path, 4)
    d0, i0 = tsearch(tc, tidx, q)
    d1, i1 = tsearch(tc, healed, q)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    other = place_index(tc, tidx, replication=2)
    with pytest.raises(ValueError, match="recover_rank"):
        recover_rank(tc, other, path, 4)


def test_kernel_engine_launches_once_a_rank(tc, dataset, tidx, monkeypatch):
    """The kernel engine's ADC list scan runs once a rank on a batch
    whose pairs fit one LUT chunk, and the sentinel list — the target of
    every unowned probe slot, with no rows — reads as empty."""
    from raft_tpu_torch.spatial.ann import pq_kernel

    calls = []
    orig = pq_kernel.pq_adc_lists

    def counting(luts, lut_map, codes, origin, bounds, l_pad, out=None):
        res = orig(luts, lut_map, codes, origin, bounds, l_pad, out=out)
        calls.append((lut_map.clone(), bounds.clone(), res.clone()))
        return res

    monkeypatch.setattr(pq_kernel, "pq_adc_lists", counting)
    _, q = dataset
    tsearch(tc, tidx, q, use_kernel=True, refine_ratio=2.0)
    assert len(calls) == P8
    sentinel = tidx.nl_pad - 1
    for lut_map, bounds, res in calls:
        assert (bounds[sentinel, 1] - bounds[sentinel, 0]).item() == 0
        assert (lut_map[sentinel] >= 0).any()       # live sentinel slots
        assert (res[sentinel] >= pq_kernel.BIG).all()


def test_engine_resolution_per_shard(tc, dataset, tidx):
    """use_kernel=None on CPU ranks runs the one-hot engine (the rule,
    not a fallback: ENGINE_FALLBACKS unchanged); use_kernel=True on an
    unrefined search raises."""
    _, q = dataset
    before = ivf_pq.ENGINE_FALLBACKS
    a = tsearch(tc, tidx, q)
    b = tsearch(tc, tidx, q, use_kernel=False)
    assert torch.equal(a[0], b[0])
    assert ivf_pq.ENGINE_FALLBACKS == before
    with pytest.raises(ValueError, match="refine"):
        tsearch(tc, tidx, q, use_kernel=True, refine_ratio=1.0)


def test_profile_tool_takes_the_sharded_pq_engine():
    """``profile_grouped --kind sharded --engine pq`` parses, and without
    a card it refuses to run before building anything."""
    from raft_tpu_torch.tools import profile_grouped as pg

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        pg.main(["--kind", "sharded", "--engine", "pq"])
    with pytest.raises(SystemExit):
        pg.main(["--kind", "sharded", "--engine", "sq"])
