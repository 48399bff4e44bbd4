"""PyTorch port of the MST, the connected-components fixup, the native
host library and single-linkage clustering (raft_tpu_torch.sparse mst /
connect / hierarchy, raft_tpu_torch.native) against the JAX package, on
the CPU.

Inputs come from numpy seeds; graphs are JAX ``COO``s carried across
with ``coo_from_arrays``. Tolerances, and why:

* ``boruvka_mst`` (edges, weights, colours, ``n_edges``),
  ``connect_components``, the first solve of ``build_sorted_mst`` and the
  dendrogram are bitwise equal: every step is a min-scatter, a sort or a copy, and the
  one arithmetic step (``fused_l2_nn``'s squared distances) is exact on
  integer-valued rows;
* ``single_linkage`` end to end on an integer grid: children, sizes and
  labels equal; deltas equal to JAX's within 1 f32 ulp, because the kNN
  graph's l2 roots are taken through f64 in the port and in f32 by XLA
  on the CPU (ROADMAP R4); with the JAX graph carried across, deltas
  bitwise too;
* once the fixup stitches components, the port weights its edges in the
  graph's metric and enters a pair two components pick once (ROADMAP
  C4, repaired in the port only): stitched trees are held to scipy's
  MST weight and merge order, not to the JAX package's;
* native against JAX's native and against the numpy routes: equal.
"""

import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from raft_tpu.sparse import coo_from_dense as j_coo_from_dense
from raft_tpu.sparse import hierarchy as jh
from raft_tpu.sparse.connect import connect_components as j_connect
from raft_tpu.sparse.connect import get_n_components as j_ncomp
from raft_tpu.sparse.knn_graph import knn_graph as j_knn_graph
from raft_tpu.sparse.mst import boruvka_mst as j_mst
from raft_tpu_torch import _build, native
from raft_tpu_torch.sparse import coo_from_arrays, coo_from_dense, knn_graph
from raft_tpu_torch.sparse import hierarchy as th
from raft_tpu_torch.sparse.connect import connect_components, get_n_components
from raft_tpu_torch.sparse.mst import boruvka_mst
from raft_tpu_torch.spatial import knn as tknn

torch.set_num_threads(1)

CPU = torch.device("cpu")
MST_FIELDS = ("src", "dst", "weight", "n_edges", "color")


def _carry(j):
    return coo_from_arrays({"rows": np.asarray(j.rows),
                            "cols": np.asarray(j.cols),
                            "vals": np.asarray(j.vals),
                            "nnz": np.asarray(j.nnz), "shape": j.shape},
                           device=CPU)


def _same_mst(t, j):
    for f in MST_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def _random_graph(rng, n, p=0.4, integer=True):
    if integer:
        d = rng.integers(1, 6, (n, n)).astype(np.float32)   # many ties
    else:
        d = rng.random((n, n)).astype(np.float32)
    d = np.triu(np.where(rng.random((n, n)) < p, d, 0), 1)
    return (d + d.T).astype(np.float32)


def _blobs(rng, sizes, d=4, spread=3, offset=60):
    """Integer rows: blob b around (b * offset, ...), within +-spread."""
    return np.concatenate([
        rng.integers(-spread, spread + 1, (s, d)) + b * offset
        for b, s in enumerate(sizes)]).astype(np.float32)


# -- Borůvka MST ---------------------------------------------------------------

@pytest.mark.parametrize("n,integer", [(20, True), (20, False), (40, True),
                                       (64, True)])
def test_boruvka_bitwise(n, integer):
    rng = np.random.default_rng(n + integer)
    d = _random_graph(rng, n, integer=integer)
    j = j_coo_from_dense(d)
    stats = {}
    t = boruvka_mst(_carry(j), stats=stats)
    _same_mst(t, j_mst(j))
    assert stats["rounds"] >= 1 and stats["syncs"] > stats["rounds"]


def test_boruvka_padded_capacity_bitwise():
    d = _random_graph(np.random.default_rng(3), 24)
    j = j_coo_from_dense(d, capacity=int((d != 0).sum()) + 17)
    _same_mst(boruvka_mst(_carry(j)), j_mst(j))


def test_boruvka_forest_bitwise():
    """tests/test_mst_linkage.py's two triangles with no bridge."""
    dense = np.zeros((6, 6), np.float32)
    for a, b, w in [(0, 1, 1), (1, 2, 2), (0, 2, 3), (3, 4, 1), (4, 5, 2),
                    (3, 5, 3)]:
        dense[a, b] = dense[b, a] = w
    j = j_coo_from_dense(dense)
    t = boruvka_mst(_carry(j))
    _same_mst(t, j_mst(j))
    assert int(t.n_edges) == 4
    assert int(get_n_components(t.color)) == 2 == int(j_ncomp(
        np.asarray(j_mst(j).color)))


def test_boruvka_all_ties_bitwise():
    """tests/test_mst_linkage.py's complete graph of equal weights."""
    dense = np.ones((8, 8), np.float32) - np.eye(8, dtype=np.float32)
    j = j_coo_from_dense(dense)
    t = boruvka_mst(_carry(j))
    _same_mst(t, j_mst(j))
    assert int(t.n_edges) == 7


def test_boruvka_from_port_coo_and_single_vertex():
    d = _random_graph(np.random.default_rng(5), 16)
    _same_mst(boruvka_mst(coo_from_dense(d, device=CPU)),
              j_mst(j_coo_from_dense(d)))
    one = np.zeros((1, 1), np.float32)
    _same_mst(boruvka_mst(coo_from_dense(one, device=CPU)),
              j_mst(j_coo_from_dense(one)))


# -- connect_components --------------------------------------------------------

@pytest.mark.parametrize("sizes", [(10, 10), (30, 20, 25), (7, 1, 12, 5)])
def test_connect_components_bitwise(sizes):
    rng = np.random.default_rng(len(sizes))
    x = _blobs(rng, sizes)
    color = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    j = j_connect(x, color)
    t = connect_components(torch.as_tensor(x), torch.as_tensor(color))
    for f in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.nnz) == len(sizes)
    assert int(get_n_components(torch.as_tensor(color))) == len(sizes)


def test_connect_components_ties_pick_the_lowest_row():
    # two rows of colour 0 equally near colour 1
    x = np.array([[0, 0], [2, 0], [1, 5], [1, -5]], np.float32)
    color = np.array([0, 0, 1, 1], np.int32)
    j = j_connect(x, color)
    t = connect_components(torch.as_tensor(x), torch.as_tensor(color))
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))


# -- build_sorted_mst ----------------------------------------------------------

def _euclidean_mst_weight(x):
    """The weight of the minimum spanning tree over the f64 Euclidean
    distances of all pairs (Prim's; scipy's csgraph would read a
    repeated row's 0 as no edge)."""
    from scipy.spatial.distance import cdist

    d = cdist(x.astype(np.float64), x.astype(np.float64))
    best = d[0].copy()
    done = np.zeros(len(x), bool)
    done[0] = True
    total = 0.0
    for _ in range(len(x) - 1):
        j = int(np.argmin(np.where(done, np.inf, best)))
        total += best[j]
        done[j] = True
        best = np.minimum(best, d[j])
    return total


@pytest.mark.parametrize("sizes,k", [((15, 15), 3), ((20, 9, 14, 30), 4)])
def test_build_sorted_mst_disconnected_bitwise(sizes, k):
    """A kNN graph of far blobs has one component a blob. The first
    solve's forest is JAX's, bitwise; the fixup loop then stitches the
    blobs into the Euclidean MST of all rows (scipy's weight), since
    the graph holds the Euclidean MST inside each blob."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, minimum_spanning_tree

    rng = np.random.default_rng(sum(sizes))
    x = _blobs(rng, sizes)
    jg = j_knn_graph(x, k)

    # the oracle is sound: one component a blob, each blob's MST inside
    nnz = int(jg.nnz)
    r, c = np.asarray(jg.rows)[:nnz], np.asarray(jg.cols)[:nnz]
    exact = np.sqrt(((x[r].astype(np.float64) - x[c]) ** 2).sum(1))
    g = coo_matrix((exact + 1e-300, (r, c)), shape=(len(x), len(x))).tocsr()
    n_comp, comp = connected_components(g, directed=False)
    blob = np.repeat(np.arange(len(sizes)), sizes)
    assert n_comp == len(sizes) and len(set(zip(comp, blob))) == len(sizes)
    for b in range(len(sizes)):
        sel = np.flatnonzero(blob == b)
        np.testing.assert_allclose(
            minimum_spanning_tree(g[sel][:, sel]).sum(),
            _euclidean_mst_weight(x[sel]), rtol=1e-12)

    stats = {}
    got = th.build_sorted_mst(torch.as_tensor(x), _carry(jg), stats=stats)
    forest = j_mst(jg)
    _same_mst(boruvka_mst(_carry(jg)), forest)
    np.testing.assert_array_equal(stats["forest_color"],
                                  np.asarray(forest.color))
    assert stats["forest_edges"] == int(forest.n_edges)
    assert stats["forest_weight"] == float(
        np.asarray(forest.weight)[:int(forest.n_edges)].astype(
            np.float64).sum())
    assert len(got[0]) == len(x) - 1
    np.testing.assert_allclose(float(got[2].astype(np.float64).sum()),
                               _euclidean_mst_weight(x), rtol=1e-6)
    assert stats["connect_rounds"] >= 1
    assert stats["component_syncs"] == stats["connect_rounds"] + 1
    assert len(stats["mst"]) == stats["connect_rounds"] + 1
    # every stitching pair entered once
    pairs = [tuple(sorted(p)) for rows, cols, _, _ in stats["stitches"]
             for p in zip(rows.tolist(), cols.tolist())]
    assert len(pairs) == len(set(pairs))


def test_stitched_edges_carry_twice_the_squared_distance():
    """ROADMAP C4's second effect, repaired in the port: the edge 1-2
    that both components pick enters once, at its plain distance 9 (the
    JAX package keeps fused_l2_nn's squared distance, summed with its
    mirror by sum_duplicates: 2 x 81)."""
    from scipy.cluster.hierarchy import linkage

    x = np.array([[0, 0], [1, 0], [10, 0], [11, 0]], np.float32)
    jg = j_knn_graph(x, 1)
    stats = {}
    src, dst, w = th.build_sorted_mst(torch.as_tensor(x), _carry(jg),
                                      stats=stats)
    assert list(w) == [1.0, 1.0, 9.0]
    assert sorted((int(src[2]), int(dst[2]))) == [1, 2]
    (rows, cols, ws, repeats), = stats["stitches"]
    assert (len(rows), repeats) == (1, 1) and list(ws) == [9.0]
    np.testing.assert_array_equal(linkage(x.astype(np.float64),
                                          "single")[:, 2], w)
    jw = jh.build_sorted_mst(x, jg)[2]
    assert list(np.asarray(jw)) == [1.0, 1.0, 2.0 * 81.0]


def _scipy_single(x, n_clusters, metric="euclidean"):
    from scipy.cluster.hierarchy import fcluster, linkage

    ref = linkage(x.astype(np.float64), "single", metric=metric)
    return ref, fcluster(ref, n_clusters, "maxclust")


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) \
        == len(set(b.tolist()))


def test_stitching_merges_out_of_order_below_unit_distance():
    """ROADMAP C4's first effect, repaired in the port: rows at 0, 0.25,
    0.55, 0.75. The 1-NN graph is {0, 1} and {2, 3} (edges 0.25 and
    0.2), the stitch is 1-2 at d = 0.3. scipy merges at 0.2, 0.25, 0.3
    and cuts {2, 3} from {0, 1}; so does the port. (The JAX package
    enters the stitch as 2 x 0.09 and merges it first.)"""
    x = np.array([[0.0], [0.25], [0.55], [0.75]], np.float32)
    got = th.single_linkage(x, n_clusters=2, k=1, device="cpu")
    ref, ref_labels = _scipy_single(x, 2)
    np.testing.assert_allclose(ref[:, 2], [0.2, 0.25, 0.3], rtol=1e-6)
    np.testing.assert_allclose(got.deltas, ref[:, 2], rtol=1e-6)
    np.testing.assert_array_equal(np.sort(got.children, 1),
                                  np.sort(ref[:, :2].astype(int), 1))
    assert _same_partition(got.labels.numpy(), ref_labels)
    labels = got.labels.numpy()
    assert labels[0] == labels[1] != labels[2] == labels[3]
    want = jh.single_linkage(x, n_clusters=2, k=1)
    np.testing.assert_allclose(want.deltas, [0.18, 0.2, 0.25], rtol=1e-5)


def test_stitch_picked_twice_merges_in_scipy_order():
    """ROADMAP C4's witness at any distance: 1-D rows 0, 1, 11, 12, 24,
    25 with k = 1. Both components {0, 1} and {11, 12} pick 1-11 (10);
    {24, 25} picks 12-24 (12). scipy merges at 1, 1, 1, 10, 12 and at 2
    clusters cuts off {24, 25}; the JAX package merges at 1, 1, 1, 144,
    200 and cuts off {0, 1}."""
    x = np.array([[0], [1], [11], [12], [24], [25]], np.float32)
    got = th.single_linkage(x, n_clusters=2, k=1, device="cpu")
    ref, ref_labels = _scipy_single(x, 2)
    np.testing.assert_array_equal(ref[:, 2], [1, 1, 1, 10, 12])
    np.testing.assert_array_equal(got.deltas, ref[:, 2])
    np.testing.assert_array_equal(got.sizes, ref[:, 3])
    assert _same_partition(got.labels.numpy(), ref_labels)
    labels = got.labels.numpy()
    assert len(set(labels[:4])) == 1 and labels[4] == labels[5] != labels[0]
    want = jh.single_linkage(x, n_clusters=2, k=1)
    np.testing.assert_array_equal(want.deltas, [1, 1, 1, 144, 200])


@pytest.mark.parametrize("metric,scipy_metric", [
    ("l1", "cityblock"), ("linf", "chebyshev"), ("sqeuclidean", None)])
def test_stitching_in_a_non_l2_metric(metric, scipy_metric):
    """The stitching edges take the graph's metric: l1 and linf through
    pairwise_distance on each pair's rows, squared L2 as
    connect_components gives it. On 1-D rows the L2-nearest pair across
    components is the nearest in every one of these metrics, so the
    port's merges are scipy's."""
    x = np.array([[0], [2], [3], [17], [19], [40], [41], [47]], np.float32)
    stats = {}
    got = th.single_linkage(x, n_clusters=3, k=1, metric=metric,
                            stats=stats, device="cpu")
    assert stats["connect_rounds"] >= 1
    if scipy_metric is None:
        ref, ref_labels = _scipy_single(x, 3, "sqeuclidean")
    else:
        ref, ref_labels = _scipy_single(x, 3, scipy_metric)
    np.testing.assert_allclose(got.deltas, ref[:, 2], rtol=1e-6)
    assert _same_partition(got.labels.numpy(), ref_labels)


def test_stitch_weights_against_pairwise():
    """stitch_weights on rows of width 5: every metric's weight equals
    pairwise_distance on the pair's rows; the rooted L2 metrics take the
    f64 root of the squared distance given."""
    from raft_tpu_torch.distance.pairwise import pairwise_distance

    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.random((600, 5)).astype(np.float32))
    rows = torch.as_tensor(rng.integers(0, 600, 300), dtype=torch.int32)
    cols = torch.as_tensor(rng.integers(0, 600, 300), dtype=torch.int32)
    sq = ((x[rows.long()] - x[cols.long()]) ** 2).sum(1)
    for metric in ("l1", "canberra", "cosine", "linf"):
        got = th.stitch_weights(x, rows, cols, sq, metric)
        want = torch.stack([pairwise_distance(
            x[r:r + 1], x[c:c + 1], metric)[0, 0]
            for r, c in zip(rows.long(), cols.long())])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(th.stitch_weights(x, rows, cols, sq,
                                         "l2_sqrt_expanded"),
                       torch.sqrt(sq.double()).float())
    assert th.stitch_weights(x, rows, cols, sq, "sqeuclidean") is sq


def test_first_of_pairs_masks_repeats():
    rows = torch.tensor([1, 11, 12, 3, 7, 0], dtype=torch.int32)
    cols = torch.tensor([11, 1, 24, 3, 2, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, True, False])
    keep = th.first_of_pairs(rows, cols, valid, 30)
    assert keep.tolist() == [True, False, True, True, True, False]


# -- the native library --------------------------------------------------------

def _tree(rng, n):
    src = np.arange(1, n, dtype=np.int32)
    dst = np.array([rng.integers(0, i) for i in range(1, n)], np.int32)
    w = np.sort(rng.random(n - 1).astype(np.float32))
    return src, dst, w


def _jax_numpy_route(fn, *args):
    with mock.patch.dict(sys.modules, {"raft_tpu.native": None}):
        return fn(*args)


def test_native_builds_under_the_build_root():
    assert native.available()
    path = native.lib_path()
    assert path.is_file()
    root = _build._ROOT[0]
    assert path.parent.parent == root / "native"
    assert len(path.parent.name) == 16


def test_native_build_root_moves_and_fallback_counts(tmp_path, monkeypatch):
    """A fresh build under another root; then a failed build: unavailable,
    and each host route it sends to numpy counts once."""
    monkeypatch.setattr(native, "_STATE", {"lib": None, "error": None})
    _build.set_build_root(tmp_path)
    try:
        assert native.available()
        assert native.lib_path().is_file()
        assert str(native.lib_path()).startswith(str(tmp_path))
        monkeypatch.setattr(native, "_STATE", {"lib": None, "error": None})
        monkeypatch.setattr(native, "_SRC", tmp_path / "missing.cpp")
        assert not native.available()
        with pytest.raises(ImportError, match="unavailable"):
            native.dendrogram(*_tree(np.random.default_rng(0), 5), 5)
        before = native.NATIVE_FALLBACKS
        src, dst, w = _tree(np.random.default_rng(1), 12)
        children, _, _ = th.build_dendrogram_host(src, dst, w, 12)
        th.extract_flattened_clusters(children, 12, 3)
        assert native.NATIVE_FALLBACKS == before + 2
    finally:
        _build.set_build_root(None)
    assert not any(p.suffix == ".tmp" for p in tmp_path.rglob("*"))


@pytest.mark.parametrize("n", [2, 30, 257])
def test_dendrogram_native_numpy_and_jax(n, monkeypatch):
    src, dst, w = _tree(np.random.default_rng(n), n)
    got = th.build_dendrogram_host(src, dst, w, n)
    want = jh.build_dendrogram_host(src, dst, w, n)          # JAX native
    want_np = _jax_numpy_route(jh.build_dendrogram_host, src, dst, w, n)
    monkeypatch.setattr(native, "available", lambda: False)
    got_np = th.build_dendrogram_host(src, dst, w, n)
    for a, b, c, d in zip(got, want, want_np, got_np):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 20])
def test_extract_flat_native_numpy_and_jax(k, monkeypatch):
    n = 20
    children, _, _ = native.dendrogram(*_tree(np.random.default_rng(9), n), n)
    got = th.extract_flattened_clusters(children, n, k)
    want = jh.extract_flattened_clusters(children, n, k)
    want_np = _jax_numpy_route(jh.extract_flattened_clusters, children, n, k)
    monkeypatch.setattr(native, "available", lambda: False)
    got_np = th.extract_flattened_clusters(children, n, k)
    for other in (want, want_np, got_np):
        np.testing.assert_array_equal(got, other)
    assert len(np.unique(got)) == k and got[0] == 0


def test_make_monotonic_and_merge_topk():
    """tests/test_native.py's oracles."""
    labels = np.array([7, 3, 7, 9, 3, 0], np.int32)
    np.testing.assert_array_equal(native.make_monotonic(labels),
                                  [0, 1, 0, 2, 1, 3])
    np.testing.assert_array_equal(native.make_monotonic(labels, n_max=10),
                                  [0, 1, 0, 2, 1, 3])
    rng = np.random.default_rng(42)
    P, m, k = 3, 5, 4
    d = np.sort(rng.random((P, m, k)).astype(np.float32), axis=2)
    i = rng.integers(0, 1000, (P, m, k)).astype(np.int32)
    out_d, out_i = native.merge_topk(d, i)
    want = np.sort(d.transpose(1, 0, 2).reshape(m, P * k), axis=1)[:, :k]
    np.testing.assert_array_equal(out_d, want)
    flat_d = d.transpose(1, 0, 2).reshape(m, P * k)
    flat_i = i.transpose(1, 0, 2).reshape(m, P * k)
    for r in range(m):
        for c in range(k):
            assert out_i[r, c] in flat_i[r][flat_d[r] == out_d[r, c]]


# -- single linkage ------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    """~2,000 integer rows in 5 separated blobs (some rows repeated)."""
    rng = np.random.default_rng(2000)
    return _blobs(rng, (500, 300, 450, 350, 400), d=3, spread=6, offset=40)


def _hold_linkage(got, want, x, n_clusters, n_comp, ulps):
    """The merges inside the kNN graph's ``n_comp`` components (the first
    n - n_comp) against JAX's (deltas within ``ulps``), the stitched
    ones against scipy's single-linkage heights; labels JAX's where the
    cut stays inside the components, else scipy's partition."""
    inner = len(x) - n_comp
    np.testing.assert_array_equal(got.children[:inner],
                                  want.children[:inner])
    np.testing.assert_array_equal(got.sizes[:inner], want.sizes[:inner])
    np.testing.assert_array_max_ulp(got.deltas[:inner].astype(np.float32),
                                    want.deltas[:inner].astype(np.float32),
                                    ulps)
    ref, ref_labels = _scipy_single(x, n_clusters)
    np.testing.assert_allclose(got.deltas[inner:], ref[inner:, 2],
                               rtol=1e-6)
    np.testing.assert_array_equal(got.sizes[inner:], ref[inner:, 3])
    if n_clusters >= n_comp:
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
    else:
        assert _same_partition(got.labels.numpy(), ref_labels)


@pytest.mark.parametrize("n_clusters", [2, 5, 17])
def test_single_linkage_end_to_end(grid, n_clusters):
    want = jh.single_linkage(grid, n_clusters=n_clusters, k=8)
    stats = {}
    got = th.single_linkage(torch.as_tensor(grid), n_clusters=n_clusters,
                            k=8, stats=stats)
    assert got.labels.device == CPU and got.n_clusters == n_clusters
    n_comp = len(grid) - stats["forest_edges"]
    assert n_comp == 5 and stats["connect_rounds"] >= 1
    _hold_linkage(got, want, grid, n_clusters, n_comp, 1)
    for key in ("knn_graph_s", "mst_s", "dendrogram_s", "total_s",
                "connect_rounds"):
        assert key in stats
    if n_clusters == 5:
        # the generating blobs, up to a permutation
        blob = np.repeat(np.arange(5), (500, 300, 450, 350, 400))
        pairs = set(zip(blob.tolist(), got.labels.tolist()))
        assert len(pairs) == 5


def test_single_linkage_on_the_jax_graph_bitwise(grid):
    jg = j_knn_graph(grid, 8)
    for n_clusters in (5, 2):
        want = jh.single_linkage(grid, n_clusters=n_clusters, graph=jg)
        got = th.single_linkage(torch.as_tensor(grid),
                                n_clusters=n_clusters, graph=_carry(jg))
        _hold_linkage(got, want, grid, n_clusters, 5, 0)


def test_single_linkage_golden_chain():
    """tests/test_mst_linkage.py's 4 points at 0, 1, 3, 7."""
    x = np.array([[0.0], [1.0], [3.0], [7.0]], np.float32)
    res = th.single_linkage(x, n_clusters=2, k=3, device="cpu")
    labels = res.labels.numpy()
    assert labels[0] == labels[1] == labels[2] != labels[3]
    np.testing.assert_allclose(sorted(res.deltas), [1.0, 2.0, 4.0],
                               rtol=1e-6)


def test_single_linkage_checks_arguments():
    with pytest.raises(ValueError):
        th.single_linkage(np.zeros((1, 3), np.float32), device="cpu")
    with pytest.raises(ValueError):
        th.single_linkage(np.zeros((4, 3), np.float32), n_clusters=5,
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.single_linkage(np.zeros((4, 3), np.float32))


def test_knn_graph_fused_route_matches_scan(monkeypatch):
    """The chip's route rehearsed on the CPU: with the fused route
    enabled, knn_graph runs the fused kernels' plain versions; on
    integer rows its graph equals the scan path's."""
    rng = np.random.default_rng(77)
    x = torch.as_tensor(_blobs(rng, (300, 200), d=128, spread=4,
                               offset=30))
    monkeypatch.setattr(tknn, "_fused_device_ok", lambda dev: True)
    monkeypatch.setattr(tknn, "_FUSED_MIN_ROWS", 64)
    from raft_tpu_torch.spatial import fused_knn as fz

    before = dict(fz.LAUNCHES)
    fused = knn_graph(x, 6)
    scan = knn_graph(x, 6, use_fused=False)
    assert fz.LAUNCHES == before          # plain versions: no launch
    for f in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(getattr(fused, f).numpy(),
                                      getattr(scan, f).numpy(), err_msg=f)
