"""PyTorch port of the IVF-Flat main path (raft_tpu_torch) against the
JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. Indexes built by
the JAX package are carried across whole (its leaves as arrays, and its
npz checkpoint), because torch cannot replay JAX's random streams; on the
integer-exact ``_int_dataset`` fixture every f32 sum is exact in any
order, so searched distances must match bitwise and ids up to ties
(equal-distance runs may order differently, see ROADMAP note R1). The
grouped search's kernel engine runs the scan's plain version here.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.cluster.kmeans import KMeansParams as JKMeansParams
from raft_tpu.cluster.kmeans import kmeans_fit as j_kmeans_fit
from raft_tpu.distance.fused_l2_nn import fused_l2_nn as j_fused_l2_nn
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import common as jcommon
from raft_tpu.spatial.ann import ivf_flat_build as j_ivf_flat_build
from raft_tpu.spatial.ann.ivf_flat import ivf_flat_search as j_search
from raft_tpu.spatial.ann.ivf_flat import (
    ivf_flat_search_grouped as j_grouped,
)
from raft_tpu.spatial.ann.serialize import save_index
from raft_tpu.testing.faults import corrupt_bytes
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_index_from_arrays,
    ivf_flat_search,
    ivf_flat_search_grouped,
    load_ivf_flat,
)
from raft_tpu_torch.spatial.ann import common as tcommon
from raft_tpu_torch.spatial.ann import flat_kernel as tfk
from raft_tpu_torch.spatial.ann.ivf_flat import _resolve_scan_engine
from tests.oracles import np_knn_ids

torch.set_num_threads(1)

K_NN = 5
CPU = torch.device("cpu")


def _int_dataset(seed, n=3000, d=16, nq=64):
    """Integer-exact clustered rows/queries (the fixture of
    tests/test_flat_kernel.py): squared distances are exact in f32 for
    any accumulation order."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-60, 60, (8, d))
    x = (
        centers[rng.integers(0, 8, n)]
        + rng.integers(-6, 7, (n, d))
    ).astype(np.float32)
    q = (
        x[rng.integers(0, n, nq)] + rng.integers(-2, 3, (nq, d))
    ).astype(np.float32)
    return x, q


def _assert_ids_equal_up_to_ties(dists, i0, i1):
    """ids identical except inside equal-distance runs: each interior tie
    group must hold the same id SET; the group cut by the k-boundary is
    checked for distance only (any id at that distance is a correct k-th
    neighbor). Logic of tests/test_flat_kernel.py."""
    d = np.asarray(dists)
    a, b = np.asarray(i0), np.asarray(i1)
    for r in range(d.shape[0]):
        start = 0
        k = d.shape[1]
        for end in range(1, k + 1):
            if end == k or d[r, end] != d[r, start]:
                if end < k or start == 0:
                    assert set(a[r, start:end].tolist()) == \
                        set(b[r, start:end].tolist()), f"query {r}"
                start = end


def _leaves(jidx):
    s = jidx.storage
    return {
        "centroids": np.asarray(jidx.centroids),
        "data_sorted": np.asarray(jidx.data_sorted),
        "storage.sorted_ids": np.asarray(s.sorted_ids),
        "storage.list_offsets": np.asarray(s.list_offsets),
        "storage.list_index": np.asarray(s.list_index),
        "storage.list_sizes": np.asarray(s.list_sizes),
        "storage.n": s.n,
        "storage.max_list": s.max_list,
    }


def _with_emptied_lists(x, base, emptied):
    """``base`` with the rows of ``emptied`` lists moved into list 0: the
    lists keep their centroids (probes still pick them) but hold no rows."""
    n = base.storage.n
    n_lists = base.centroids.shape[0]
    labels = np.empty(n, np.int64)
    labels[np.asarray(base.storage.sorted_ids)] = np.repeat(
        np.arange(n_lists), np.asarray(base.storage.list_sizes))
    labels = np.where(np.isin(labels, list(emptied)), 0, labels)
    storage = jcommon.build_list_storage(labels, n_lists)
    data_sorted = jnp.concatenate([
        jnp.asarray(x[np.asarray(storage.sorted_ids)]),
        jnp.zeros((1, x.shape[1]), jnp.float32),
    ])
    return dataclasses.replace(base, data_sorted=data_sorted,
                               storage=storage)


@pytest.fixture(scope="module")
def dataset():
    return _int_dataset(7)


@pytest.fixture(scope="module")
def jax_indexes(dataset):
    x, _ = dataset
    base = j_ivf_flat_build(x, JIVFFlatParams(
        n_lists=48, kmeans_n_iters=4, kmeans_init="random",
    ), metric="sqeuclidean")
    return {"plain": base,
            "emptied": _with_emptied_lists(x, base, {1, 5, 9, 17})}


@pytest.fixture(scope="module")
def carried(jax_indexes, tmp_path_factory):
    """Each JAX index carried across both ways: from its leaves, and
    through save_index -> load_ivf_flat."""
    out = {}
    for name, jidx in jax_indexes.items():
        path = tmp_path_factory.mktemp("idx") / f"{name}.npz"
        save_index(jidx, path)
        out[name, "arrays"] = ivf_flat_index_from_arrays(
            _leaves(jidx), jidx.metric, device="cpu")
        out[name, "npz"] = load_ivf_flat(path, device="cpu")
    return out


def test_both_carries_give_the_same_index(jax_indexes, carried):
    for name, jidx in jax_indexes.items():
        a, b = carried[name, "arrays"], carried[name, "npz"]
        assert b.metric == jidx.metric and b.device == CPU
        assert (b.storage.n, b.storage.max_list) == (
            jidx.storage.n, jidx.storage.max_list)
        for f in ("centroids", "data_sorted"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        for f in ("sorted_ids", "list_offsets", "list_index", "list_sizes"):
            np.testing.assert_array_equal(
                getattr(b.storage, f).numpy(),
                np.asarray(getattr(jidx.storage, f)))
    assert (carried["emptied", "npz"].storage.list_sizes == 0).any()


@pytest.mark.parametrize("carry", ["arrays", "npz"])
@pytest.mark.parametrize("name", ["plain", "emptied"])
def test_per_query_search_parity(dataset, jax_indexes, carried, name,
                                 carry):
    _, q = dataset
    d0, i0 = j_search(jax_indexes[name], q, K_NN, n_probes=4)
    d1, i1 = ivf_flat_search(carried[name, carry], q, K_NN, n_probes=4)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def _saturating_ratio(storage, p, k):
    """rerank_ratio whose top-c sub-chunks cover every probed row."""
    l_pad = -(-storage.max_list // 128) * 128
    return float(p * l_pad // 8) / k + 1.0


@pytest.mark.parametrize("stream", [None, True])
@pytest.mark.parametrize("kernel,pool", [(False, "default"),
                                         (True, "saturated"),
                                         (True, "default")])
@pytest.mark.parametrize("name,qcap", [("plain", 64), ("emptied", 64),
                                       ("plain", 8)])
def test_grouped_search_parity(dataset, jax_indexes, carried, name, qcap,
                               kernel, pool, stream):
    """Both engines, streamed and not; the kernel engine (whose rerank
    pool the ratio sizes) with a pool that covers every probed row and
    with the default rerank_ratio=4.0; qcap=8 drops the overflow of
    hot lists."""
    _, q = dataset
    jidx = jax_indexes[name]
    p = 16 if name == "emptied" else 4
    ratio = (_saturating_ratio(jidx.storage, p, K_NN)
             if pool == "saturated" else 4.0)
    kw = dict(n_probes=p, qcap=qcap, stream_partials=stream,
              rerank_ratio=ratio)
    d0, i0 = j_grouped(jidx, q, K_NN, use_pallas=kernel, **kw)
    d1, i1 = ivf_flat_search_grouped(carried[name, "npz"], q, K_NN,
                                     use_kernel=kernel, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_large_k_exceeding_subchunk_pool(dataset):
    """Few lists, so k > p * (l_pad / 8) while k <= max_list: the kernel
    engine clamps its pool to every sub-chunk, as the JAX engine does."""
    x, q = dataset
    jidx = j_ivf_flat_build(x, JIVFFlatParams(
        n_lists=4, kmeans_n_iters=3, kmeans_init="random",
    ), metric="sqeuclidean")
    tidx = ivf_flat_index_from_arrays(_leaves(jidx), jidx.metric,
                                      device="cpu")
    L = jidx.storage.max_list
    l_tile = tfk.plan_l_tile(x.shape[1], 64, l_tile=-(-L // 128) * 128)
    width = -(-L // l_tile) * l_tile // 8
    k = min(L, width + 8)
    assert k > width
    for kernel in (False, True):
        kw = dict(n_probes=1, qcap=64, rerank_ratio=1.0)
        d0, i0 = j_grouped(jidx, q, k, use_pallas=kernel, **kw)
        d1, i1 = ivf_flat_search_grouped(tidx, q, k, use_kernel=kernel,
                                         **kw)
        assert d1.shape == (q.shape[0], k)
        np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
        _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_grouped_auto_qcap_and_l2_metric(dataset, jax_indexes):
    """qcap=None (sized from the probe map), qcap="throughput" (0.75x the
    mean occupancy, audited) and metric='l2': the port's
    distances are the correctly rounded square roots of the JAX squared
    distances (XLA's CPU sqrt may differ from that by an ulp)."""
    _, q = dataset
    jidx = jax_indexes["plain"]
    leaves = _leaves(jidx)
    tidx = ivf_flat_index_from_arrays(leaves, "l2", device="cpu")
    for qcap in (None, "throughput"):
        d0, i0 = j_grouped(jidx, q, K_NN, n_probes=4, qcap=qcap,
                           use_pallas=True)
        d1, i1 = ivf_flat_search_grouped(tidx, q, K_NN, n_probes=4,
                                         qcap=qcap, use_kernel=True)
        np.testing.assert_array_equal(
            d1.numpy(), np.sqrt(np.maximum(np.asarray(d0), 0.0)))
        _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_invert_probe_map_ranked_exact():
    rng = np.random.default_rng(3)
    nq, p, n_lists = 50, 4, 16
    # skewed probes so some lists overflow the cap and some stay empty
    probes = np.stack([rng.choice(n_lists - 3, p, replace=False,
                                  p=np.linspace(3, 1, n_lists - 3) /
                                  np.linspace(3, 1, n_lists - 3).sum())
                       for _ in range(nq)]).astype(np.int32)
    for qcap in (6, 16, 50):
        want = jcommon.invert_probe_map_ranked(jnp.asarray(probes),
                                               n_lists, qcap)
        got = tcommon.invert_probe_map_ranked(torch.as_tensor(probes),
                                              n_lists, qcap)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        wq, wl, ws = jcommon.invert_probe_map(jnp.asarray(probes), n_lists,
                                              qcap)
        gq, gl, gs = tcommon.invert_probe_map(torch.as_tensor(probes),
                                              n_lists, qcap)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert tcommon.probe_drop_stats(probes, n_lists, qcap) == \
            jcommon.probe_drop_stats(probes, n_lists, qcap)
        assert tcommon.resolve_qcap(probes, n_lists, nq, p) == \
            jcommon.resolve_qcap(jnp.asarray(probes), n_lists, nq, p)


def test_qcap_functions_exact():
    for nq in (1, 7, 8, 64, 500, 4096):
        for p in (1, 4, 8, 32):
            for nl in (1, 16, 48, 1024):
                for fn in ("default_qcap", "throughput_qcap"):
                    assert getattr(tcommon, fn)(nq, p, nl) == \
                        getattr(jcommon, fn)(nq, p, nl)
                for qc in (None, "throughput", 24):
                    assert tcommon.static_qcap(qc, nq, p, nl) == \
                        jcommon.static_qcap(qc, nq, p, nl)
    with pytest.raises(ValueError, match="qcap must be"):
        tcommon.static_qcap(True, 8, 2, 4)
    with pytest.raises(ValueError, match="not yet ported"):
        tcommon.resolve_qcap_arg(8, torch.zeros((2, 3)), torch.zeros((4, 3)),
                                 4, 2, coarse=object())


def test_split_and_build_list_storage_exact():
    rng = np.random.default_rng(5)
    n_lists = 12
    # skewed labels: a few swollen lists and an empty one
    labels = rng.choice(n_lists - 1, 2000,
                        p=np.arange(n_lists - 1, 0, -1) /
                        np.arange(n_lists - 1, 0, -1).sum()).astype(np.int32)
    cents = rng.standard_normal((n_lists, 6)).astype(np.float32)
    for cap in (150, 400, 5000):
        wl, wc = jcommon.split_oversized_lists(labels, jnp.asarray(cents),
                                               cap)
        gl, gc = tcommon.split_oversized_lists(labels,
                                               torch.as_tensor(cents), cap)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        ws = jcommon.build_list_storage(wl, wc.shape[0])
        gs = tcommon.build_list_storage(gl, gc.shape[0], CPU)
        assert (gs.n, gs.max_list) == (ws.n, ws.max_list)
        for f in ("sorted_ids", "list_offsets", "list_index", "list_sizes"):
            np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                          np.asarray(getattr(ws, f)))


def _blobs(seed, n=1200, d=8, k=6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 8.0
    x = (centers[rng.integers(0, k, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    return x.astype(np.float32)


def test_fused_l2_nn_parity():
    """Values within the expanded form's f32 cancellation error
    (1e-6 x (|x|^2 + |y|^2)); argmin equal wherever the two nearest
    rows are more than 1e-4 apart (relative)."""
    x = _blobs(1)
    y = x[::97] + 0.25
    v0, i0 = j_fused_l2_nn(jnp.asarray(x), jnp.asarray(y),
                           precision="default")
    v1, i1 = fused_l2_nn(torch.as_tensor(x), torch.as_tensor(y),
                         precision="default")
    v0, i0 = np.asarray(v0), np.asarray(i0)
    scale = (x ** 2).sum(1) + (y ** 2).sum(1)[i0]
    assert (np.abs(v1.numpy() - v0) <= 1e-6 * scale).all()
    d2 = ((x[:, None, :] - y[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-4 * two[:, 1]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(i1.numpy()[clear], i0[clear])


def test_kmeans_fit_from_injected_centroids():
    """compute_dtype='bfloat16', 4 iterations, one initial centroid far
    from every row (its cluster empties and is reseeded): centroids within
    1e-5 (the f32 sums run in another order), labels equal wherever the
    two nearest centroids are more than 1e-4 apart (relative)."""
    x = _blobs(2)
    c0 = x[:6].copy()
    c0[5] = 1000.0
    want = j_kmeans_fit(jnp.asarray(x), JKMeansParams(
        n_clusters=6, max_iter=4, compute_dtype="bfloat16"),
        centroids=jnp.asarray(c0))
    got = kmeans_fit(torch.as_tensor(x), KMeansParams(
        n_clusters=6, max_iter=4, compute_dtype="bfloat16"),
        centroids=torch.as_tensor(c0))
    assert got.n_iter == int(want.n_iter)
    wc = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), wc, rtol=1e-5,
                               atol=1e-5)
    d2 = ((x[:, None, :] - wc[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-4 * two[:, 1]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got.labels.numpy()[clear],
                                  np.asarray(want.labels)[clear])
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


def _recall(ids, true):
    ids = np.asarray(ids)
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, true)) / true.size


def test_port_built_index_recall():
    """An index built by the port on the CPU (its own k-means++ from a
    torch.Generator) reaches the JAX-built index's recall@10 within
    0.02 on the same data."""
    rng = np.random.default_rng(11)
    x = _blobs(3, n=3000, d=16, k=24)
    q = x[rng.integers(0, x.shape[0], 128)] + 0.5 * rng.standard_normal(
        (128, 16)).astype(np.float32)
    true = np_knn_ids(x, q, 10)
    params = dict(n_lists=48, kmeans_n_iters=6)
    jidx = j_ivf_flat_build(x, JIVFFlatParams(**params))
    tidx = ivf_flat_build(x, IVFFlatParams(**params), device="cpu")
    assert tidx.data_sorted.shape == (x.shape[0] + 1, 16)
    r_jax = _recall(j_grouped(jidx, q, 10, n_probes=4)[1], true)
    for kernel in (False, True):
        _, ids = ivf_flat_search_grouped(tidx, q, 10, n_probes=4,
                                         use_kernel=kernel)
        assert _recall(ids.numpy(), true) >= r_jax - 0.02, kernel


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, jax_indexes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros((16, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat_build(x, IVFFlatParams(n_lists=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat_index_from_arrays(_leaves(jax_indexes["plain"]), "l2")
    path = tmp_path / "i.npz"
    save_index(jax_indexes["plain"], path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_ivf_flat(path)


def test_corrupted_archive_raises(tmp_path, jax_indexes):
    path = tmp_path / "i.npz"
    save_index(jax_indexes["plain"], path)
    field = corrupt_bytes(path, field="data_sorted", n_bytes=4)
    with pytest.raises(terrors.CorruptIndexError, match="CRC32") as e:
        load_ivf_flat(path, device="cpu")
    assert e.value.field == field == "data_sorted"
    path.write_bytes(path.read_bytes()[:200])
    with pytest.raises(terrors.CorruptIndexError) as e:
        load_ivf_flat(path, device="cpu")
    assert e.value.field == "__header__"


def test_engine_resolution_and_unported_options(dataset, carried):
    _, q = dataset
    idx = carried["plain", "npz"]
    assert _resolve_scan_engine(None, 16, 64, CPU) is False
    assert _resolve_scan_engine(True, 16, 64, CPU) is True
    assert _resolve_scan_engine(False, 16, 64, CPU) is False
    with pytest.raises(ValueError, match="use_kernel=True unsupported"):
        _resolve_scan_engine(True, 1 << 12, 64, CPU)
    with pytest.raises(ValueError, match="per-query"):
        ivf_flat_search_grouped(idx, q, idx.storage.max_list + 1,
                                n_probes=4, use_kernel=True)
    # the IVF-SQ mode of the grouped body is reached through ivf_sq, as
    # in the JAX package, not through the flat entry point
    with pytest.raises(TypeError, match="dequant"):
        ivf_flat_search_grouped(idx, q, 5, dequant=(1, 2))
    with pytest.raises(ValueError, match="mutation"):
        ivf_flat_search_grouped(idx, q, 5, row_mask=torch.ones(3))
    assert tfk.LAUNCHES == 0


def test_cuda_index_leaving_the_kernel_is_counted_and_warned(caplog):
    """use_kernel=None on a CUDA index the kernel cannot serve runs the
    legacy scan, counts it and warns once per reason; a CPU index or an
    explicit False is not a fallback."""
    from raft_tpu_torch.spatial.ann import ivf_flat as tivf

    cuda = torch.device("cuda")
    before = tivf.ENGINE_FALLBACKS
    assert _resolve_scan_engine(None, 16, 64, CPU) is False
    assert _resolve_scan_engine(False, 1 << 12, 64, cuda) is False
    assert tivf.ENGINE_FALLBACKS == before
    tivf._fallback_reasons_warned.discard(
        "d=4096 qcap=64 does not fit the kernel's shared-memory tiles")
    with caplog.at_level("WARNING", logger="raft_tpu_torch"):
        for _ in range(3):
            assert _resolve_scan_engine(None, 1 << 12, 64, cuda) is False
    assert tivf.ENGINE_FALLBACKS == before + 3
    warned = [r for r in caplog.records if "legacy" in r.getMessage()]
    assert len(warned) == 1 and "d=4096" in warned[0].getMessage()


def test_scan_rows_bf16_made_once_per_row_count(carried):
    idx = carried["plain", "arrays"]
    n = idx.data_sorted.shape[0]
    a = idx.scan_rows(n)
    assert a is idx.scan_rows(n) and a.dtype == torch.bfloat16
    assert torch.equal(a, idx.data_sorted.to(torch.bfloat16))
    b = idx.scan_rows(n + 5)
    assert b.shape == (n + 5, idx.data_sorted.shape[1])
    assert torch.equal(b[:n], a) and not b[n:].any()
    # a replaced index starts without the old copies
    fresh = dataclasses.replace(idx, data_sorted=idx.data_sorted + 1)
    assert torch.equal(fresh.scan_rows(n),
                       (idx.data_sorted + 1).to(torch.bfloat16))
    # int8 codes (the IVF-SQ view) stay int8: no copy without padding
    codes = dataclasses.replace(idx, data_sorted=idx.data_sorted.to(
        torch.int8))
    assert codes.scan_rows(n) is codes.data_sorted
    c = codes.scan_rows(n + 3)
    assert c.dtype == torch.int8 and not c[n:].any()


def test_port_imports_neither_jax_nor_the_jax_package():
    prog = (
        "import sys\n"
        "import raft_tpu_torch, raft_tpu_torch.spatial.ann.ivf_flat\n"
        "import raft_tpu_torch.spatial.ann, raft_tpu_torch.serving.batching\n"
        "import raft_tpu_torch.spatial.knn, raft_tpu_torch.distance.pairwise\n"
        "import raft_tpu_torch.spatial, raft_tpu_torch.distance\n"
        "import raft_tpu_torch.core.interruptible, raft_tpu_torch.core.tree\n"
        "import raft_tpu_torch.analysis.threads.runtime\n"
        "import raft_tpu_torch.obs, raft_tpu_torch.obs.crash\n"
        "import raft_tpu_torch.resilience, raft_tpu_torch.cache\n"
        "import raft_tpu_torch.serving, raft_tpu_torch.serving.open_loop\n"
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
