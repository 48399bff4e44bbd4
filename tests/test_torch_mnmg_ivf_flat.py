"""PyTorch port of sharded IVF-Flat (raft_tpu_torch/comms/mnmg_ivf.py and
mnmg_ivf_flat.py) against the JAX package, on the CPU.

JAX runs on the 8-device virtual CPU mesh (tests/conftest.py), the port
in process at P = 8 (one thread per rank, every rank on the CPU). The
fixture is the integer-exact ``_int_dataset`` of
tests/test_torch_ivf_flat.py with integer centroids, so every distance is
exact in f32: searched distances must match bitwise and ids up to ties
(ROADMAP note R1); the ``l2`` root is compared with ``np.sqrt`` of JAX's
squared distances (note R4). The deterministic build stages,
``_assign_lists`` and ``_exchange_and_assemble``, are fed JAX's own
inputs and must give bitwise JAX's maps and slabs (ragged shards and an
empty rank included); the whole build runs with both packages'
``_train_coarse_distributed`` patched to return the same centroids (JAX's
PRNG subsample cannot be reproduced). Gaussian blobs are held within
1e-5 x (|q|^2 + |y|^2), the rounding scale of the expanded distance.
The torch.distributed form runs as two gloo processes of
:mod:`raft_tpu_torch.testing.dist`, each with its own timeout.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.comms import attach_coarse_index as j_attach_coarse
from raft_tpu.comms import build_comms as j_build_comms
from raft_tpu.comms import build_comms_hierarchical as j_build_hier
from raft_tpu.comms import mnmg_ivf as jmi
from raft_tpu.comms import mnmg_ivf_flat as jmf
from raft_tpu.comms import place_index as j_place
from raft_tpu.comms import reshard_index as j_reshard
from raft_tpu.resilience import FailoverPlan as JFailoverPlan
from raft_tpu.resilience import ReplicaPlacement as JPlacement
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import load_index as j_load
from raft_tpu.spatial.ann import save_index as j_save
from raft_tpu_torch.comms import (
    MnmgIVFFlatIndex,
    build_comms,
    build_comms_hierarchical,
    mnmg_ivf_flat_build,
    mnmg_ivf_flat_build_distributed,
    mnmg_ivf_flat_search,
    place_index,
    recover_rank,
    reshard_index,
)
from raft_tpu_torch.comms import mnmg_ivf as tmi
from raft_tpu_torch.comms import mnmg_ivf_flat as tmf
from raft_tpu_torch.obs.metrics import MetricRegistry
from raft_tpu_torch.resilience import (
    FailoverPlan,
    PartialSearchResult,
    ReplicaPlacement,
    ShardHealth,
)
from raft_tpu_torch.serving import ServingExecutor
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    ivf_flat_build,
    load_index,
    mnmg_index_from_arrays,
    save_index,
)
from raft_tpu_torch.spatial.ann.ivf_flat import ivf_flat_search_grouped
from raft_tpu_torch.testing import dist as tdist
from tests.test_torch_ivf_flat import (
    _assert_ids_equal_up_to_ties,
    _int_dataset,
)

torch.set_num_threads(1)

P8 = 8
K = 5
N_PROBES = 6
NL = 24
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jc():
    return j_build_comms(jax.devices()[:P8])


@pytest.fixture(scope="module")
def tc():
    return build_comms(["cpu"] * P8, timeout_s=120.0)


@pytest.fixture(scope="module")
def dataset():
    return _int_dataset(7)


def _int_cents(x, nl, seed=0):
    """Integer centroids: distinct data rows (exact distances)."""
    rng = np.random.default_rng(seed)
    return x[rng.choice(x.shape[0], nl, replace=False)].copy()


@pytest.fixture(scope="module")
def jidx(jc, dataset):
    """The JAX sharded index over the integer fixture, its centroids
    rounded to integers."""
    x, _ = dataset
    j = jmf.mnmg_ivf_flat_build(
        jc, x, JIVFFlatParams(n_lists=NL, kmeans_n_iters=3, seed=1),
        metric="sqeuclidean")
    return dataclasses.replace(j, centroids=jnp.round(j.centroids))


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
def tidx(jidx, tc):
    return carry(jidx, tc)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_same_answer(jout, tout, root=False):
    jd, ji = (np.asarray(a) for a in jout)
    td, ti = (_np(a) for a in tout)
    want = np.sqrt(np.maximum(jd, 0.0)) if root else jd
    assert td.tobytes() == want.astype(np.float32).tobytes()
    _assert_ids_equal_up_to_ties(jd, ji, ti)


def jsearch(jc, j, q, **kw):
    kw.setdefault("qcap", q.shape[0])
    return jmf.mnmg_ivf_flat_search(jc, j, jnp.asarray(q), K,
                                    n_probes=N_PROBES, **kw)


def tsearch(tc, t, q, **kw):
    kw.setdefault("qcap", q.shape[0])
    return mnmg_ivf_flat_search(tc, t, torch.as_tensor(q), K,
                                n_probes=N_PROBES, **kw)


# ---------------------------------------------------------------- build
def _ragged(x_all, seed=8):
    """Ragged per-rank shards (rank 2 empty), as tests/test_mnmg_ivf_flat
    .py: (stacked (P, n_loc, d) f32, n_valid)."""
    n_valid = np.array([220, 180, 0, 240, 90, 200, 260, 40], np.int32)
    nloc = 260
    x = x_all[:int(n_valid.sum())]
    starts = np.concatenate([[0], np.cumsum(n_valid)[:-1]])
    xs = np.zeros((P8, nloc, x.shape[1]), np.float32)
    for r in range(P8):
        xs[r, :n_valid[r]] = x[starts[r]:starts[r] + n_valid[r]]
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


@pytest.mark.parametrize("layout", ["full", "ragged"])
@pytest.mark.parametrize("cap", [None, 0, 64])
def test_build_stages_bitwise(jc, tc, dataset, layout, cap):
    """``_assign_lists`` and ``_exchange_and_assemble`` fed JAX's own
    inputs (row shards, integer centroids; then JAX's labels and count
    matrix): labels, counts, owner, local ids, offsets, sizes, centroid
    slabs, sorted_ids and the vector slabs bitwise."""
    xs, n_valid = _shards(jc, dataset, layout)
    cents = _int_cents(dataset[0], 12 if layout == "ragged" else NL)
    nl = cents.shape[0]
    xg = _jax_sharded(jc, xs)
    jl, jC = jmf._assign_lists(jc, xg, n_valid, jnp.asarray(cents), nl)
    tl, tC = tmf._assign_lists(tc, torch.as_tensor(xs), n_valid,
                               torch.as_tensor(cents), nl)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tC.numpy(), np.asarray(jC))
    n = int(n_valid.sum())
    c = cap if cap is not None else max(256, 2 * -(-n // nl))
    jmaps, jslabs = jmi._exchange_and_assemble(
        jc, xg, n_valid, jl, jC, jnp.asarray(cents), c, store_vectors=True)
    tmaps, tslabs = tmi._exchange_and_assemble(
        tc, torch.as_tensor(xs), n_valid, torch.as_tensor(np.array(jl)),
        torch.as_tensor(np.array(jC)), torch.as_tensor(cents), c,
        store_vectors=True)
    for key, v in jmaps.items():
        np.testing.assert_array_equal(np.asarray(tmaps[key]), np.asarray(v),
                                      err_msg=key)
    for key in ("sids", "vecs"):
        a, b = np.asarray(jslabs[key]), tslabs[key].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    # every valid row lands exactly once
    szs, sids = tmaps["szs_sh"], tslabs["sids"].numpy()
    got = np.concatenate([sids[r, :szs[r].sum()] for r in range(P8)])
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


def _patch_training(monkeypatch, cents):
    def fake(*a, **kw):
        return None, types.SimpleNamespace(centroids=jnp.asarray(cents))

    def tfake(*a, **kw):
        return None, types.SimpleNamespace(centroids=torch.as_tensor(cents))

    monkeypatch.setattr(jmf, "_train_coarse_distributed", fake)
    monkeypatch.setattr(tmf, "_train_coarse_distributed", tfake)


@pytest.mark.parametrize("layout", ["full", "ragged"])
def test_whole_build_bitwise(jc, tc, dataset, layout, monkeypatch):
    """The whole distributed build with both packages' training patched
    to the same integer centroids: every field of the index bitwise."""
    xs, n_valid = _shards(jc, dataset, layout)
    cents = _int_cents(dataset[0], NL, seed=1)
    _patch_training(monkeypatch, cents)
    params = dict(n_lists=NL, kmeans_n_iters=3, seed=1, max_list_cap=None)
    j = jmf.mnmg_ivf_flat_build_distributed(
        jc, _jax_sharded(jc, xs), JIVFFlatParams(**params),
        n_valid=n_valid, metric="l2")
    t = mnmg_ivf_flat_build_distributed(
        tc, torch.as_tensor(xs), IVFFlatParams(**params), n_valid=n_valid,
        metric="l2")
    for key, v in _leaves(j).items():
        got = getattr(t, key)
        if isinstance(v, np.ndarray):
            assert _np(got).tobytes() == v.tobytes(), key
        else:
            assert got == v, key
    _, q = dataset
    assert_same_answer(
        jsearch(jc, dataclasses.replace(j, metric="sqeuclidean"), q),
        tsearch(tc, t, q), root=True)


def test_build_covers_rows_and_keeps_recall(tc, dataset):
    """The port's own build (its own training subsample and k-means):
    every row in exactly one slab, recall@5 at least the single-device
    index's minus 0.02 (the JAX test's rule)."""
    x, q = dataset
    params = IVFFlatParams(n_lists=NL, kmeans_n_iters=4, seed=2)
    t = mnmg_ivf_flat_build(tc, x, params, metric="sqeuclidean")
    szs, sids = t.list_sizes.numpy(), t.sorted_ids.numpy()
    got = np.concatenate([sids[r, :szs[r].sum()] for r in range(P8)])
    np.testing.assert_array_equal(np.sort(got), np.arange(x.shape[0]))
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    true = np.argsort(d2, axis=1, kind="stable")[:, :K]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(ids.tolist(), true.tolist())])

    single = ivf_flat_build(x, params, metric="sqeuclidean", device="cpu")
    _, i1 = ivf_flat_search_grouped(single, q, K, n_probes=N_PROBES,
                                    qcap=q.shape[0])
    _, i2 = tsearch(tc, t, q)
    assert recall(i2.numpy()) >= recall(i1.numpy()) - 0.02


# ---------------------------------------------------------------- search
@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
@pytest.mark.parametrize("qcap", [64, 8, None])
def test_search_matches_jax(jc, tc, dataset, jidx, tidx, engine, qcap):
    """Healthy search on both engines, at a qcap that fits every probe,
    one that drops pairs (the sentinel list overflows at any qcap), and
    the auto qcap: distances bitwise JAX's, ids up to ties."""
    _, q = dataset
    assert_same_answer(jsearch(jc, jidx, q, qcap=qcap),
                       tsearch(tc, tidx, q, qcap=qcap, use_kernel=engine))


@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_l2_root_after_merge(jc, tc, dataset, jidx, engine):
    _, q = dataset
    t = carry(dataclasses.replace(jidx, metric="l2"), tc)
    assert_same_answer(jsearch(jc, jidx, q),
                       tsearch(tc, t, q, use_kernel=engine), root=True)


def test_merge_ways_padding(jc, tc, dataset, jidx, tidx):
    _, q = dataset
    assert_same_answer(jsearch(jc, jidx, q, merge_ways=16),
                       tsearch(tc, tidx, q, merge_ways=16))
    with pytest.raises(ValueError, match="merge_ways"):
        tsearch(tc, tidx, q, merge_ways=4)


def _partial_equal(jres, tres):
    assert isinstance(tres, PartialSearchResult)
    assert_same_answer((jres.distances, jres.ids), (tres.distances,
                                                     tres.ids))
    assert tres.coverage.numpy().tobytes() == \
        np.asarray(jres.coverage).tobytes()
    np.testing.assert_array_equal(tres.row_valid.numpy(),
                                  np.asarray(jres.row_valid))
    assert tres.partial == jres.partial


@pytest.mark.parametrize("down", [(), (3,), (0, 5)])
@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_degraded_matches_jax(jc, tc, dataset, jidx, tidx, down, engine):
    """Ranks down, and a NaN query row: distances, ids, coverage,
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
    assert tres.partial
    assert np.isinf(tres.distances[5].numpy()).all()
    assert (tres.ids[5].numpy() == -1).all()
    offs, sids = tidx.list_offsets.numpy(), tidx.sorted_ids.numpy()
    for r in down:
        lost = set(sids[r, :offs[r, -1]].tolist())
        assert not lost & set(tres.ids.numpy().ravel().tolist())
    if not down:
        np.testing.assert_array_equal(
            np.delete(tres.coverage.numpy(), 5), 1.0)


def test_shard_health_mask_and_warmup(jc, tc, dataset, jidx, tidx):
    """A ShardHealth as the mask; warmup returns JAX's qcap, for both
    variants."""
    _, q = dataset
    h = ShardHealth(P8, telemetry=False)
    h.mark_down(6)
    _partial_equal(jsearch(jc, jidx, q, shard_mask=h.mask()),
                   tsearch(tc, tidx, q, shard_mask=h))
    for nq, mask in ((8, None), (64, True)):
        assert tidx.warmup(tc, nq, k=K, n_probes=N_PROBES,
                           shard_mask=mask) == \
            jidx.warmup(jc, nq, k=K, n_probes=N_PROBES, shard_mask=mask)


@pytest.fixture(scope="module")
def replicated(jc, tc, jidx, tidx):
    return (j_place(jc, jidx, replication=2),
            place_index(tc, tidx, replication=2))


def test_replicated_layout_matches_jax(replicated):
    j, t = replicated
    for key, v in _leaves(j).items():
        got = getattr(t, key)
        if isinstance(v, np.ndarray):
            assert _np(got).tobytes() == v.tobytes(), key
        else:
            assert got == v, key


@pytest.mark.parametrize("down", [(3,), (1, 6)])
def test_failover_full_coverage_bitwise(jc, tc, dataset, tidx, replicated,
                                        down):
    """Replication 2 with a FailoverPlan: coverage 1.0 and results
    bitwise the healthy search's, and JAX's."""
    j, t = replicated
    _, q = dataset
    healthy = tsearch(tc, tidx, q)
    mask = np.ones(P8, np.int32)
    mask[list(down)] = 0
    tplan = FailoverPlan.from_health(ReplicaPlacement.striped(P8, 2), mask)
    jplan = JFailoverPlan.from_health(JPlacement.striped(P8, 2), mask)
    assert tplan.fully_covered
    tres = tsearch(tc, t, q, shard_mask=mask, failover=tplan)
    _partial_equal(jsearch(jc, j, q, shard_mask=mask, failover=jplan), tres)
    np.testing.assert_array_equal(tres.coverage.numpy(), 1.0)
    assert tres.distances.numpy().tobytes() == healthy[0].numpy().tobytes()
    np.testing.assert_array_equal(tres.ids.numpy(), healthy[1].numpy())
    with pytest.raises(ValueError, match="shard_mask"):
        tsearch(tc, t, q, failover=tplan)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_hierarchical_merge_2x4(dataset, jidx, wire):
    """The two-stage cross-host merge on a 2 x 4 communicator, on both
    wires: bitwise JAX's."""
    _, q = dataset
    jh = j_build_hier(jax.devices()[:P8], mesh_shape=(2, 4))
    th = build_comms_hierarchical(["cpu"] * P8, mesh_shape=(2, 4))
    j = j_place(jh, jidx)
    t = carry(jidx, th)
    assert_same_answer(jsearch(jh, j, q, wire=wire),
                       tsearch(th, t, q, wire=wire))


@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_coarse_quantizer_attached(jc, tc, dataset, jidx, engine):
    """An index with a two-level coarse quantizer (JAX's, its supers
    rounded to integers) carried across: both probe engines against
    JAX's search."""
    _, q = dataset
    j = j_attach_coarse(jidx, n_super=5, seed=0)
    j = dataclasses.replace(j, coarse=dataclasses.replace(
        j.coarse, super_cents=jnp.round(j.coarse.super_cents)))
    t = carry(j, tc)
    assert t.coarse is not None and t.coarse.n_cents == NL
    assert_same_answer(jsearch(jc, j, q, overprobe=2.0),
                       tsearch(tc, t, q, overprobe=2.0, use_kernel=engine))


def test_mutation_argument_names_the_slice(tc, dataset, tidx):
    """``mutation=`` with a wrapped state (the sharded mutation tier)
    answers as ``mnmg_mutable_search`` does, on both engines: an upserted
    row its own top-1 at distance 0, a deleted row gone; an object that
    is no mutation state is refused."""
    from raft_tpu_torch.comms import (
        mnmg_delete,
        mnmg_mutable_search,
        mnmg_upsert,
        wrap_mnmg_mutable,
    )

    x, q = dataset
    mw = wrap_mnmg_mutable(tc, tidx, delta_cap=4)
    mw, acc = mnmg_upsert(tc, mw, q[:3] + 100.0,
                          np.arange(50000, 50003, dtype=np.int32))
    assert acc.all()
    _, before = tsearch(tc, tidx, q)
    mw, found = mnmg_delete(tc, mw, before[:2, 0].numpy())
    assert found.all()
    qq = np.concatenate([q, q[:3] + 100.0])
    for engine in (False, True):
        d, i = tsearch(tc, tidx, qq, mutation=mw, use_kernel=engine)
        d2, i2 = mnmg_mutable_search(tc, mw, torch.as_tensor(qq), K,
                                     n_probes=N_PROBES, qcap=qq.shape[0],
                                     use_kernel=engine)
        assert torch.equal(d, d2) and torch.equal(i, i2)
        np.testing.assert_array_equal(i[-3:, 0].numpy(),
                                      np.arange(50000, 50003))
        assert (d[-3:, 0] == 0).all()
        assert not np.isin(i.numpy(), before[:2, 0].numpy()).any()
    with pytest.raises(ValueError, match="mutation"):
        tsearch(tc, tidx, q, mutation=object())


def test_gaussian_blobs_within_tolerance(jc, tc):
    """Non-integer rows and centroids: distances within 1e-5 x (|q|^2 +
    |y|^2) of JAX's — the rounding of the expanded form |q|^2 + |y|^2 -
    2 q.y, whose f32 products sum in a different order in each package
    — and the same neighbours but for near-ties."""
    rng = np.random.default_rng(13)
    centers = rng.standard_normal((16, 24)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 16, 4000)]
         + rng.standard_normal((4000, 24)).astype(np.float32))
    q = x[rng.integers(0, 4000, 96)] + 0.2 * rng.standard_normal(
        (96, 24)).astype(np.float32)
    j = jmf.mnmg_ivf_flat_build(
        jc, x, JIVFFlatParams(n_lists=32, kmeans_n_iters=4, seed=4),
        metric="sqeuclidean")
    t = carry(j, tc)
    jd, ji = (np.asarray(a) for a in jsearch(jc, j, q, qcap=96))
    scale = (q * q).sum(1)[:, None] + (x[ji] * x[ji]).sum(-1)
    for engine in (False, True):
        td, ti = tsearch(tc, t, q, qcap=96, use_kernel=engine)
        assert (np.abs(td.numpy() - jd) <= 1e-5 * scale).all()
        assert (ti.numpy() == ji).mean() >= 0.99


# --------------------------------------------- layouts, archive, recovery
@pytest.mark.parametrize("n_ranks", [1, 4])
def test_reshard_matches_jax_and_answers_alike(jc, tc, dataset, jidx, tidx,
                                               n_ranks):
    """reshard_index / place_index onto fewer ranks: the layout bitwise
    JAX's reshard, distances bitwise the P = 8 search's."""
    _, q = dataset
    jsmall = j_build_comms(jax.devices()[:n_ranks])
    tsmall = build_comms(["cpu"] * n_ranks)
    jr = j_reshard(jsmall, jidx)
    tr = reshard_index(tsmall, tidx)
    for key, v in _leaves(jr).items():
        got = getattr(tr, key)
        if isinstance(v, np.ndarray):
            assert _np(got).tobytes() == v.tobytes(), key
        else:
            assert got == v, key
    d8, i8 = tsearch(tc, tidx, q)
    d1, i1 = tsearch(tsmall, place_index(tsmall, tidx), q)
    assert d1.numpy().tobytes() == d8.numpy().tobytes()
    _assert_ids_equal_up_to_ties(d8.numpy(), i8.numpy(), i1.numpy())


def _header(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__header__"]).decode("utf-8"))


@pytest.mark.parametrize("coarse", [False, True])
def test_archive_both_ways(jc, tc, dataset, jidx, tmp_path, coarse):
    """JAX writes, the port reads (host and placed); the port writes,
    JAX's load_index(path, comms=) reads: the same index and the same
    answers; headers equal (v3 with a coarse quantizer)."""
    _, q = dataset
    j = j_attach_coarse(jidx, n_super=5, seed=0) if coarse else jidx
    pj, pt = tmp_path / "j.npz", tmp_path / "t.npz"
    j_save(j, pj)
    host = load_index(pj)
    assert isinstance(host, MnmgIVFFlatIndex)
    assert isinstance(host.vectors_sorted, np.ndarray)
    t = load_index(pj, comms=tc)
    save_index(host, pt)
    hj, ht = _header(pj), _header(pt)
    assert ht["version"] == hj["version"] == (3 if coarse else 2)
    assert ht["static"] == hj["static"] and ht["type"] == "mnmg_ivf_flat"
    assert ht["integrity"] == hj["integrity"]
    back = j_load(pt, comms=jc)
    assert_same_answer(jsearch(jc, back, q), tsearch(tc, t, q))


def test_recover_rank_full_cycle(tc, dataset, tidx, replicated, tmp_path):
    """Rank 3 dies and its slab is lost: failover serves bitwise; the
    slab is restored from a saved archive (the port's, then JAX's) and
    the healthy route answers bitwise again."""
    j, t = replicated
    _, q = dataset
    v0, i0 = tsearch(tc, tidx, q)
    dead = 3
    wrecked = dataclasses.replace(
        t, vectors_sorted=t.vectors_sorted.clone(),
        sorted_ids=t.sorted_ids.clone())
    wrecked.vectors_sorted[dead] = 0
    wrecked.sorted_ids[dead] = 0
    h = ShardHealth(P8, telemetry=False)
    h.mark_down(dead)
    placement = ReplicaPlacement.of_index(t)
    res = tsearch(tc, wrecked, q, shard_mask=h,
                  failover=FailoverPlan.from_health(placement, h))
    assert not res.partial
    assert res.distances.numpy().tobytes() == v0.numpy().tobytes()
    for writer, path in ((save_index, tmp_path / "t.npz"),
                         (j_save, tmp_path / "j.npz")):
        writer(t if writer is save_index else j, path)
        healed = recover_rank(tc, wrecked, path, dead)
        np.testing.assert_array_equal(healed.sorted_ids[dead].numpy(),
                                      t.sorted_ids[dead].numpy())
        res2 = tsearch(tc, healed, q, shard_mask=np.ones(P8, np.int32))
        assert res2.distances.numpy().tobytes() == v0.numpy().tobytes()
        np.testing.assert_array_equal(res2.ids.numpy(), i0.numpy())
    with pytest.raises(ValueError, match="recover_rank"):
        recover_rank(tc, tidx, tmp_path / "t.npz", dead)


# ------------------------------------------------------------- serving
def test_served_through_executor(tc, dataset, tidx, replicated):
    """A sharded dispatch closure behind the port's ServingExecutor:
    answers equal the direct search, and the coverage gauge reads 1.0
    with every rank up and below 1 with a rank down (set_runtime)."""
    _, q = dataset
    _, t = replicated
    buckets = (8, 64)
    # one qcap >= every bucket: no probe drops, so a row's answer does not
    # depend on its batchmates
    qc = max(buckets)
    for b in buckets:
        assert t.warmup(tc, b, k=K, n_probes=N_PROBES, qcap=qc,
                        shard_mask=True) == qc

    def dispatch(batch, shard_mask=None, failover=None):
        return mnmg_ivf_flat_search(
            tc, t, batch, K, n_probes=N_PROBES, qcap=qc,
            shard_mask=shard_mask, failover=failover)

    ref = dispatch(torch.as_tensor(q), np.ones(P8, np.int32))
    reg = MetricRegistry()
    ex = ServingExecutor(dispatch, buckets, dim=q.shape[1], device=CPU,
                         flush_age_s=0.0, registry=reg,
                         runtime_inputs={"shard_mask":
                                         np.ones(P8, np.int32)})
    try:
        for a, b in ((0, 3), (3, 11), (11, 40)):
            out = ex.submit(q[a:b]).result(timeout=60)
            np.testing.assert_array_equal(out.ids, ref.ids[a:b].numpy())
            assert out.distances.tobytes() == \
                ref.distances[a:b].numpy().tobytes()
        gauge = reg.gauge("serving_coverage_min", executor=ex.name)
        assert gauge.value == 1.0
        down = np.ones(P8, np.int32)
        down[2] = 0
        ex.set_runtime(shard_mask=down)
        out = ex.submit(q[:8]).result(timeout=60)
        assert float(out.coverage.min()) < 1.0
        assert gauge.value < 1.0
    finally:
        ex.close()


# ---------------------------------------------------- torch.distributed
def test_gloo_two_processes_match_in_process(dataset, jidx, tmp_path):
    """Two gloo processes importing only the port load a JAX-written
    archive (8 ranks, re-partitioned onto their 2), pass the self-tests
    and a two-level communicator's hierarchical allreduce, and answer —
    healthy and with rank 1 down — as the in-process form at P = 2
    does."""
    _, q = dataset
    archive = tmp_path / "j.npz"
    j_save(jidx, archive)
    np.save(tmp_path / "q.npy", q)
    res = tdist.run_group(
        2, init=str(tmp_path / "rendezvous"), archive=str(archive),
        queries=str(tmp_path / "q.npy"), out=str(tmp_path / "out"), k=K,
        n_probes=N_PROBES, qcap=q.shape[0], down=[1], timeout_s=120.0)
    t2 = build_comms(["cpu"] * 2)
    t = load_index(archive, comms=t2)
    d, ids = tsearch(t2, t, q)
    mask = np.array([1, 0], np.int32)
    part = tsearch(t2, t, q, shard_mask=mask)
    for r in res:
        assert not bool(r["jax_loaded"])
        assert r["self_tests"].all(), r["self_test_names"]
        assert bool(r["hier_allreduce_ok"])
        assert r["dists"].tobytes() == d.numpy().tobytes()
        np.testing.assert_array_equal(r["ids"], ids.numpy())
        assert r["part_dists"].tobytes() == part.distances.numpy().tobytes()
        np.testing.assert_array_equal(r["part_ids"], part.ids.numpy())
        np.testing.assert_array_equal(r["coverage"], part.coverage.numpy())


# --------------------------------------------------------------- IVF-SQ
@pytest.mark.parametrize("layout", ["full", "ragged"])
def test_sq_build_bitwise(jc, tc, dataset, layout, monkeypatch):
    """The sharded IVF-SQ build with both packages' training patched to
    the same integer centroids: the affine stats, the int8 code slabs and
    every other field bitwise JAX's."""
    from raft_tpu.spatial.ann.ivf_sq import IVFSQParams as JIVFSQParams
    from raft_tpu_torch.comms import mnmg_ivf_sq_build_distributed
    from raft_tpu_torch.spatial.ann.ivf_sq import IVFSQParams

    xs, n_valid = _shards(jc, dataset, layout)
    cents = _int_cents(dataset[0], NL, seed=2)
    _patch_training(monkeypatch, cents)
    j = jmf.mnmg_ivf_sq_build_distributed(
        jc, _jax_sharded(jc, xs), JIVFSQParams(n_lists=NL), n_valid=n_valid)
    t = mnmg_ivf_sq_build_distributed(tc, torch.as_tensor(xs),
                                      IVFSQParams(n_lists=NL),
                                      n_valid=n_valid)
    for key, v in _leaves(j).items():
        got = getattr(t, key)
        if isinstance(v, np.ndarray):
            assert _np(got).tobytes() == v.tobytes(), key
        else:
            assert got == v, key


@pytest.fixture(scope="module")
def jsq(jidx):
    """The dyadic sharded SQ index over the integer fixture: the codes
    ARE the integer rows (vmin -128, vscale 1), so every decoded
    distance is exact."""
    return jmf.MnmgIVFSQIndex(
        centroids=jidx.centroids, owner=jidx.owner, local_id=jidx.local_id,
        local_cents=jidx.local_cents,
        codes_sorted=jnp.asarray(jidx.vectors_sorted).astype(jnp.int8),
        vmin=jnp.full((16,), -128.0, jnp.float32),
        vscale=jnp.ones((16,), jnp.float32),
        sorted_ids=jidx.sorted_ids, list_offsets=jidx.list_offsets,
        list_sizes=jidx.list_sizes, n_pad=jidx.n_pad, nl_pad=jidx.nl_pad,
        max_list=jidx.max_list, n_rows=jidx.n_rows)


@pytest.mark.parametrize("engine", [False, True], ids=["legacy", "kernel"])
def test_sq_search_matches_jax(jc, tc, dataset, jsq, engine):
    """Healthy and degraded (rank 4 down) SQ searches on the dyadic index
    carried across: distances bitwise JAX's, ids up to ties, the same
    coverage."""
    from raft_tpu_torch.comms import mnmg_ivf_sq_search

    _, q = dataset
    t = carry(jsq, tc)
    jout = jmf.mnmg_ivf_sq_search(jc, jsq, jnp.asarray(q), K,
                                  n_probes=N_PROBES, qcap=q.shape[0])
    tout = mnmg_ivf_sq_search(tc, t, torch.as_tensor(q), K,
                              n_probes=N_PROBES, qcap=q.shape[0],
                              use_kernel=engine)
    assert_same_answer(jout, tout)
    mask = np.ones(P8, np.int32)
    mask[4] = 0
    _partial_equal(
        jmf.mnmg_ivf_sq_search(jc, jsq, jnp.asarray(q), K,
                               n_probes=N_PROBES, qcap=q.shape[0],
                               shard_mask=mask),
        mnmg_ivf_sq_search(tc, t, torch.as_tensor(q), K, n_probes=N_PROBES,
                           qcap=q.shape[0], shard_mask=mask,
                           use_kernel=engine))
    assert t.warmup(tc, 8, k=K, n_probes=N_PROBES) == \
        jsq.warmup(jc, 8, k=K, n_probes=N_PROBES)


def test_sq_archive_both_ways_and_failover(jc, tc, dataset, jsq, tmp_path):
    """The ``mnmg_ivf_sq`` kind both ways (headers equal), and the SQ
    index at replication 2 failing over bitwise."""
    from raft_tpu_torch.comms import MnmgIVFSQIndex, mnmg_ivf_sq_search

    _, q = dataset
    pj, pt = tmp_path / "j.npz", tmp_path / "t.npz"
    j_save(jsq, pj)
    host = load_index(pj)
    assert isinstance(host, MnmgIVFSQIndex)
    save_index(host, pt)
    hj, ht = _header(pj), _header(pt)
    assert ht["type"] == hj["type"] == "mnmg_ivf_sq"
    assert ht["static"] == hj["static"]
    assert ht["integrity"] == hj["integrity"]
    back = j_load(pt, comms=jc)
    assert_same_answer(
        jmf.mnmg_ivf_sq_search(jc, back, jnp.asarray(q), K,
                               n_probes=N_PROBES, qcap=q.shape[0]),
        mnmg_ivf_sq_search(tc, load_index(pj, comms=tc), torch.as_tensor(q),
                           K, n_probes=N_PROBES, qcap=q.shape[0]))
    t2 = place_index(tc, host, replication=2)
    healthy = mnmg_ivf_sq_search(tc, t2, torch.as_tensor(q), K,
                                 n_probes=N_PROBES, qcap=q.shape[0])
    mask = np.ones(P8, np.int32)
    mask[2] = 0
    plan = FailoverPlan.from_health(ReplicaPlacement.of_index(t2), mask)
    res = mnmg_ivf_sq_search(tc, t2, torch.as_tensor(q), K,
                             n_probes=N_PROBES, qcap=q.shape[0],
                             shard_mask=mask, failover=plan)
    np.testing.assert_array_equal(res.coverage.numpy(), 1.0)
    assert res.distances.numpy().tobytes() == healthy[0].numpy().tobytes()
    _assert_ids_equal_up_to_ties(healthy[0].numpy(), healthy[1].numpy(),
                                 res.ids.numpy())


def test_expand_probe_set_matches_jax(jc, tc, dataset, jidx, tidx):
    """Unowned probe-set extras (owner -1): the healthy search and the
    degraded one (extras count as not covered) as JAX's, merge_ways
    padding the merge to a wider deployment."""
    from raft_tpu.comms import expand_probe_set as j_expand
    from raft_tpu_torch.comms import expand_probe_set

    _, q = dataset
    extra = _int_cents(dataset[0], 16, seed=9)
    j = j_expand(jidx, extra)
    t = expand_probe_set(tidx, extra)
    assert t.owner.numpy().tolist() == np.asarray(j.owner).tolist()
    assert_same_answer(jsearch(jc, j, q, merge_ways=16),
                       tsearch(tc, t, q, merge_ways=16))
    _partial_equal(jsearch(jc, j, q, shard_mask=True),
                   tsearch(tc, t, q, shard_mask=True))
