"""PyTorch port of graph ANN (raft_tpu_torch sparse/ and spatial/ann/
graph, graph_kernel) against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerances, and
why:

* the sparse ops sort and combine integers and copies of values, so
  rows, cols and nnz are equal; kNN-graph values (l2 roots) differ by at
  most 1e-5 relative (the port roots through f64, ROADMAP R4);
* the prune and the reachability patch are bitwise equal on an integer
  grid (every f32 sum exact); on Gaussian data the port sums in another
  order than numpy, so at least 99% of adjacency rows are equal and each
  other row holds a comparison tied to within 4 f32 ulp;
* searches of a carried-across JAX index: distances bitwise and ids up
  to ties (ROADMAP R1) on the integer fixture; on Gaussian data ids equal
  and squared distances within 1e-6 x (‖q‖² + ‖y‖²) — the gram form
  cancels, so the f32 sums' order shows relative to the norms, not to a
  small distance;
* the kernel's plain version is bitwise equal to the JAX lax mirror and
  interpret-mode kernel on an integer grid, and within 1e-5 x (qn + yn)
  on Gaussian data (XLA's bf16 contraction sums in its own order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.sparse.coo import COO as JCOO
from raft_tpu.sparse.knn_graph import knn_graph as j_knn_graph
from raft_tpu.sparse.linalg import coo_degree as j_coo_degree
from raft_tpu.sparse.linalg import coo_symmetrize as j_coo_symmetrize
from raft_tpu.sparse.op import coo_sort as j_coo_sort
from raft_tpu.spatial.ann import GraphParams as JGraphParams
from raft_tpu.spatial.ann import common as jcommon
from raft_tpu.spatial.ann import graph as jgraph
from raft_tpu.spatial.ann import graph_build as j_graph_build
from raft_tpu.spatial.ann import graph_delete as j_graph_delete
from raft_tpu.spatial.ann import graph_kernel as jgk
from raft_tpu.spatial.ann import graph_live_mask as j_graph_live_mask
from raft_tpu.spatial.ann import graph_search as j_graph_search
from raft_tpu.spatial.ann.serialize import save_index
from raft_tpu.testing.faults import corrupt_bytes
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.sparse import COO, knn_graph
from raft_tpu_torch.sparse.linalg import coo_degree, coo_symmetrize
from raft_tpu_torch.sparse.op import coo_sort, sum_duplicates
from raft_tpu_torch.spatial.ann import (
    GraphParams,
    graph_build,
    graph_delete,
    graph_index_from_arrays,
    graph_live_mask,
    graph_restore,
    graph_search,
    load_graph,
)
from raft_tpu_torch.spatial.ann import graph as tgraph
from raft_tpu_torch.spatial.ann import graph_kernel as tgk
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties

torch.set_num_threads(1)

CPU = torch.device("cpu")


# -- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def gauss():
    """tests/test_graph_ann.py's dataset: 400 x 16 Gaussian rows, 8
    queries near rows."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    q = x[::37][:8] + 0.05 * rng.standard_normal((8, 16)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jgauss(gauss):
    return j_graph_build(gauss[0], JGraphParams(degree=8, seed=0),
                         metric="sqeuclidean")


@pytest.fixture(scope="module")
def intgrid():
    """The integer fixture of test_rerank_tail_bit_identity_saturated_pool:
    every f32 sum exact."""
    rng = np.random.default_rng(11)
    x = rng.integers(-64, 64, size=(256, 8)).astype(np.float32)
    q = rng.integers(-64, 64, size=(6, 8)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jint(intgrid):
    return j_graph_build(intgrid[0], JGraphParams(degree=8, seed=0),
                         metric="sqeuclidean")


def _leaves(jidx):
    return {
        "data_padded": np.asarray(jidx.data_padded),
        "storage.adjacency": np.asarray(jidx.storage.adjacency),
        "storage.entries": np.asarray(jidx.storage.entries),
    }


def _carried(jidx):
    return graph_index_from_arrays(_leaves(jidx), jidx.metric, device=CPU)


def _jcoo(rows, cols, vals, nnz, shape):
    return JCOO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                jnp.int32(nnz), shape)


def _tcoo(rows, cols, vals, nnz, shape):
    return COO(torch.as_tensor(rows), torch.as_tensor(cols),
               torch.as_tensor(vals), torch.tensor(nnz, dtype=torch.int32),
               shape)


def _assert_coo_equal(j, t, vals_rtol=None):
    assert int(j.nnz) == int(t.nnz) and j.capacity == t.capacity
    np.testing.assert_array_equal(np.asarray(j.rows), t.rows.numpy())
    np.testing.assert_array_equal(np.asarray(j.cols), t.cols.numpy())
    jv, tv = np.asarray(j.vals), t.vals.numpy()
    if vals_rtol is None:
        np.testing.assert_array_equal(jv, tv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=vals_rtol, atol=0)


def _random_coo(seed, shape=(40, 30), nnz=150, cap=180, dup_frac=0.3):
    """Entries with repeated (row, col) pairs and padding at the tail."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, shape[0], nnz).astype(np.int32)
    cols = rng.integers(0, shape[1], nnz).astype(np.int32)
    n_dup = int(dup_frac * nnz)
    rows[:n_dup] = rows[nnz - n_dup:]
    cols[:n_dup] = cols[nnz - n_dup:]
    vals = rng.integers(-50, 50, nnz).astype(np.float32)
    pad = cap - nnz
    return (np.concatenate([rows, np.zeros(pad, np.int32)]),
            np.concatenate([cols, np.zeros(pad, np.int32)]),
            np.concatenate([vals, np.zeros(pad, np.float32)]), nnz, shape)


# -- sparse ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_sort_matches_jax(seed):
    """Stable (row, col) order with padding last, entry for entry."""
    args = _random_coo(seed)
    _assert_coo_equal(j_coo_sort(_jcoo(*args)), coo_sort(_tcoo(*args)))


@pytest.mark.parametrize("combine", ["max", "sum"])
def test_coo_symmetrize_matches_jax(combine):
    """A ∪ Aᵀ with duplicates combined; integer values, so the sums are
    exact and every array equal. Includes the lowest-value rule of max."""
    rows, cols, vals, nnz, shape = _random_coo(5, shape=(30, 30))
    vals[:5] = np.finfo(np.float32).min        # the dtype's lowest -> 0
    j = j_coo_symmetrize(_jcoo(rows, cols, vals, nnz, shape),
                         combine=combine)
    t = coo_symmetrize(_tcoo(rows, cols, vals, nnz, shape), combine=combine)
    _assert_coo_equal(j, t)
    np.testing.assert_array_equal(np.asarray(j_coo_degree(j)),
                                  coo_degree(t).numpy())
    np.testing.assert_array_equal(np.asarray(j.to_dense()),
                                  t.to_dense().numpy())


def test_sum_duplicates_matches_jax():
    args = _random_coo(9)
    from raft_tpu.sparse.op import sum_duplicates as j_sum_duplicates

    _assert_coo_equal(j_sum_duplicates(_jcoo(*args)),
                      sum_duplicates(_tcoo(*args)))


def test_compact_matches_jax():
    """Kept entries stable-partitioned to the front, nnz recounted, the
    tail zeroed."""
    from raft_tpu.sparse.op import _compact as j_compact
    from raft_tpu_torch.sparse.op import _compact

    args = _random_coo(3)
    keep = args[2] > 0
    _assert_coo_equal(j_compact(_jcoo(*args), jnp.asarray(keep)),
                      _compact(_tcoo(*args), torch.as_tensor(keep)))


def test_knn_graph_matches_jax(gauss, monkeypatch):
    """Tie-free Gaussian rows: the symmetrized graph's rows and cols are
    equal; the l2 values within 1e-5 relative (f64 roots)."""
    x, _ = gauss
    j = j_knn_graph(jnp.asarray(x), 16)
    t = knn_graph(x, 16, device=CPU)
    _assert_coo_equal(j, t, vals_rtol=1e-5)
    # searched in query blocks, the graph is the same
    monkeypatch.setattr(sys.modules["raft_tpu_torch.sparse.knn_graph"],
                        "BLOCK_Q", 37)
    _assert_coo_equal(t, knn_graph(torch.as_tensor(x), 16))


def test_knn_graph_unsymmetrized_keeps_k_per_row(gauss):
    x, _ = gauss
    j = j_knn_graph(jnp.asarray(x), 5, symmetrize=False)
    t = knn_graph(x, 5, symmetrize=False, device=CPU)
    _assert_coo_equal(j, t, vals_rtol=1e-5)
    assert (coo_degree(t).numpy() == 5).all()


# -- prune and patch on a carried-across COO ---------------------------------

def _graph_inputs(x, degree):
    n = x.shape[0]
    deg = min(degree, n - 1)
    idg = min(max(2 * deg, deg), n - 1)
    g = j_knn_graph(jnp.asarray(x), idg, symmetrize=True)
    nnz = int(g.nnz)
    rows = np.asarray(g.rows)[:nnz].astype(np.int64)
    cols = np.asarray(g.cols)[:nnz].astype(np.int64)
    return rows, cols, deg, 2 * idg


def _prune_both(x, degree, block=None):
    rows, cols, deg, m_cap = _graph_inputs(x, degree)
    want = jgraph._occlusion_prune(x, rows, cols, deg, m_cap)
    got = tgraph._occlusion_prune(
        torch.as_tensor(x), torch.as_tensor(rows), torch.as_tensor(cols),
        deg, m_cap, block=block).numpy()
    return want, got, rows, cols


def _near_tie(x, rows, cols, u, m_cap, degree):
    """Whether node u's prune holds a comparison tied to within 4 f32
    ulp: two candidate distances d(u, ·), or a pairwise d(w, v) in gram
    form against d(u, v) in difference form (numpy's f32 values)."""
    cand = cols[rows == u]
    m = max(degree, m_cap)
    cand = cand[:m]
    cand = np.unique(cand[cand != u])
    diff = x[u][None, :] - x[cand]
    cd = np.einsum("md,md->m", diff, diff)
    cv = x[cand]
    nn = np.einsum("md,md->m", cv, cv)
    pw = nn[:, None] + nn[None, :] - 2.0 * np.einsum("md,nd->mn", cv, cv)

    def tied(a, b):
        return np.abs(a - b) <= 4 * np.spacing(np.maximum(np.abs(a),
                                                          np.abs(b)))

    off = ~np.eye(cd.size, dtype=bool)
    return bool((tied(cd[:, None], cd[None, :]) & off).any()
                or (tied(pw, cd[None, :]) & off).any())


def _assert_rows_99(want, got, x, rows, cols, m_cap, degree):
    same = (want == got).all(axis=1)
    assert same.mean() >= 0.99, f"{(~same).sum()} rows differ"
    for u in np.flatnonzero(~same):
        assert _near_tie(x, rows, cols, u, m_cap, degree), (
            f"row {u} differs without a tied comparison: "
            f"{want[u]} vs {got[u]}")


def test_prune_and_patch_bitwise_on_integer_grid(intgrid):
    x, _ = intgrid
    want, got, _, _ = _prune_both(x, 8)
    np.testing.assert_array_equal(got, want)
    # the patch from the same entries (drop edges so that rows need it)
    adj = want.copy()
    adj[::3, :6] = -1
    entries = np.array([0, 17, 100, 200], np.int32)
    want_p = jgraph._patch_reachability(adj.copy(), entries, x)
    got_p, st = tgraph._patch_reachability(
        torch.as_tensor(adj), entries, torch.as_tensor(x))
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    assert st["patch_edges"] == int((want_p != adj).sum())
    assert 0 < st["patched_rows"] <= st["patch_edges"]


@pytest.mark.parametrize("top", [64, 2, 1])
def test_patch_connects_separated_clusters_like_jax(top):
    """Four far-apart integer clusters, two entries: the kNN graph falls
    apart, the patch fills every reached row's slots, cascades over
    several rounds and rescans when a batch's nearest rows filled up;
    bitwise the JAX package's adjacency for any batch width ``top``."""
    rng = np.random.default_rng(4)
    centres = np.array([[0] * 8, [300] * 8, [-300] * 8, [300, -300] * 4],
                       np.float32)
    x = (centres[rng.integers(0, 4, 160)]
         + rng.integers(-8, 8, (160, 8))).astype(np.float32)
    want, got, _, _ = _prune_both(x, 4)
    np.testing.assert_array_equal(got, want)
    entries = np.array([3, 77], np.int32)
    want_p = jgraph._patch_reachability(want.copy(), entries, x)
    got_p, st = tgraph._patch_reachability(
        torch.as_tensor(want), entries, torch.as_tensor(x), top=top)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    assert st["patch_edges"] >= st["patched_rows"] >= 100
    assert len(st["patch_misses"]) >= 2


@pytest.mark.parametrize("block", [None, 64])
def test_prune_gaussian_rows_agree(gauss, block):
    """400 x 16 Gaussian rows, degree 8: >= 99% of rows equal, each
    other row traced to a comparison tied within 4 ulp; the block size
    does not change the result."""
    x, _ = gauss
    want, got, rows, cols = _prune_both(x, 8, block=block)
    _assert_rows_99(want, got, x, rows, cols, 32, 8)


def test_graph_build_end_to_end(gauss, jgauss):
    x, _ = gauss
    t = graph_build(x, GraphParams(degree=8, seed=0), metric="sqeuclidean",
                    device=CPU)
    np.testing.assert_array_equal(t.storage.entries.numpy(),
                                  np.asarray(jgauss.storage.entries))
    np.testing.assert_array_equal(t.data_padded.numpy(),
                                  np.asarray(jgauss.data_padded))
    rows, cols, _, _ = _graph_inputs(x, 8)
    _assert_rows_99(np.asarray(jgauss.storage.adjacency)[:-1],
                    t.storage.adjacency.numpy()[:-1], x, rows, cols, 32, 8)
    assert (t.storage.adjacency.numpy()[-1] == -1).all()
    assert t.build_stats["edges"] > 0
    assert set(t.build_stats) >= {"knn_graph_s", "prune_s", "patch_s",
                                       "patch_edges", "patched_rows",
                                       "patch_misses"}


def test_graph_build_seeds_and_tiny_n():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    t = graph_build(x, GraphParams(degree=16, seed=0), device=CPU)
    j = j_graph_build(x, JGraphParams(degree=16, seed=0))
    assert t.storage.degree == 2
    np.testing.assert_array_equal(t.storage.adjacency.numpy(),
                                  np.asarray(j.storage.adjacency))
    d, i = graph_search(t, x[:2], 2, beam=2)
    assert (i.numpy()[:, 0] == np.arange(2)).all() and d[0, 0] == 0.0
    for seed in (1, 5):
        a = graph_build(x, GraphParams(degree=2, seed=seed, n_entry=2),
                        device=CPU)
        b = j_graph_build(x, JGraphParams(degree=2, seed=seed, n_entry=2))
        np.testing.assert_array_equal(a.storage.entries.numpy(),
                                      np.asarray(b.storage.entries))


# -- search on a carried-across JAX index ------------------------------------

_SEARCH = dict(k=8, beam=16)


@pytest.fixture(scope="module")
def jint_results(jint, intgrid):
    _, q = intgrid
    return {
        name: tuple(np.asarray(a) for a in j_graph_search(
            jint, q, use_pallas=up, pallas_interpret=up, **_SEARCH))
        for name, up in (("exact", False), ("pallas", True))
    }


@pytest.mark.parametrize("jengine", ["exact", "pallas"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("source", ["arrays", "npz"])
def test_search_int_fixture_matches_jax(jint, intgrid, jint_results,
                                        tmp_path, jengine, use_kernel,
                                        source):
    """Distances bitwise, ids up to ties, every port engine against every
    JAX engine, for an index carried across as arrays or as an npz."""
    _, q = intgrid
    if source == "arrays":
        tidx = _carried(jint)
    else:
        p = tmp_path / "graph.npz"
        save_index(jint, p)
        tidx = load_graph(p, device=CPU)
    d, i = graph_search(tidx, q, use_kernel=use_kernel, **_SEARCH)
    jd, ji = jint_results[jengine]
    assert (ji >= 0).all()
    np.testing.assert_array_equal(d.numpy(), jd)
    _assert_ids_equal_up_to_ties(jd, ji, i.numpy())


def _assert_gauss_close(tidx, q, d, i, jd, ji):
    np.testing.assert_array_equal(i.numpy(), ji)
    x = tidx.data_padded.numpy()
    scale = (q * q).sum(1)[:, None] + (x[ji] ** 2).sum(-1)
    assert (np.abs(d.numpy() - jd) <= 1e-6 * scale).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_search_gauss_matches_jax(jgauss, gauss, use_kernel):
    x, q = gauss
    tidx = _carried(jgauss)
    kw = dict(k=10, beam=16, iters=12, hash_bits=14)
    d, i = graph_search(tidx, q, use_kernel=use_kernel, **kw)
    for up in (False, True):
        jd, ji = (np.asarray(a) for a in j_graph_search(
            jgauss, q, use_pallas=up, pallas_interpret=up, **kw))
        _assert_gauss_close(tidx, q, d, i, jd, ji)


def test_search_l2_metric_roots_through_f64(gauss):
    """metric='l2': the port's root is the correctly rounded root of its
    own squared distances; ids equal JAX's."""
    x, q = gauss
    j = j_graph_build(x, JGraphParams(degree=8, seed=0))
    tidx = _carried(j)
    d, i = graph_search(tidx, q, 10, beam=16)
    jd, ji = j_graph_search(j, q, 10, beam=16)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert tidx.metric == "l2"
    d_sq, _ = graph_search(
        graph_index_from_arrays(_leaves(j), "sqeuclidean", device=CPU),
        q, 10, beam=16)
    want = np.sqrt(np.maximum(d_sq.numpy(), 0).astype(np.float64))
    np.testing.assert_array_equal(d.numpy(), want.astype(np.float32))


# -- tombstones and the visited hash -----------------------------------------

def test_tombstone_delete_restore_parity(jgauss, gauss):
    x, q = gauss
    tidx = _carried(jgauss)
    _, i0 = graph_search(tidx, q, 10, beam=32)
    dead = np.unique(i0.numpy()[:, 0])
    jmask = j_graph_delete(j_graph_live_mask(jgauss), dead)
    tmask = graph_delete(graph_live_mask(tidx), dead)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for use_kernel in (False, True):
        d, i = graph_search(tidx, q, 10, beam=32, row_mask=tmask,
                            use_kernel=use_kernel)
        assert not np.isin(i.numpy(), dead).any()
        jd, ji = (np.asarray(a) for a in j_graph_search(
            jgauss, q, 10, beam=32, row_mask=jmask))
        _assert_gauss_close(tidx, q, d, i, jd, ji)
    restored = graph_restore(tmask, dead)
    assert torch.equal(restored, graph_live_mask(tidx))
    d_r, i_r = graph_search(tidx, q, 10, beam=32, row_mask=restored)
    d_0, i_0 = graph_search(tidx, q, 10, beam=32)
    assert torch.equal(i_r, i_0) and torch.equal(d_r, d_0)


@pytest.mark.parametrize("hash_bits", [10, 14, 20])
def test_visited_hash_matches_jax(hash_bits):
    """The JAX hash (uint32 multiply, shift; the sentinel to slot T) on
    ids up to 2^31 - 1."""
    rng = np.random.default_rng(hash_bits)
    n = 2**31 - 1                     # every id below is live but n
    ids = np.concatenate([
        rng.integers(0, n, 5000), [0, 1, 2**30, n - 1, n],
    ]).astype(np.int32)
    ji = jnp.asarray(ids)
    u = ji.astype(jnp.uint32) * jnp.uint32(jgraph._HASH_MULT)
    h = (u >> np.uint32(32 - hash_bits)).astype(jnp.int32)
    want = np.asarray(jnp.where(ji < n, h, 1 << hash_bits))
    got = tgraph._visited_hash(torch.as_tensor(ids), n, hash_bits)
    np.testing.assert_array_equal(got.numpy(), want)


# -- warmup, knobs and errors ------------------------------------------------

def test_warmup_returns_jax_auto_iters(jgauss):
    tidx = _carried(jgauss)
    for nq, beam, with_mask in ((8, 16, False), (3, 8, True)):
        assert tidx.warmup(nq, k=5, beam=beam, with_mask=with_mask) == \
            jgraph._auto_iters(tidx.n)
    assert tidx.warmup(2, k=5, beam=8, iters=7) == 7
    for n in (2, 3, 256, 500_000, 2**40):
        assert tgraph._auto_iters(n) == jgraph._auto_iters(n)
    for it, beam, deg, ne in ((4, 1, 1, 1), (23, 64, 16, 4),
                              (32, 256, 64, 8), (12, 16, 8, 4)):
        assert tgraph._auto_hash_bits(it, beam, deg, ne) == \
            jgraph._auto_hash_bits(it, beam, deg, ne)


def test_search_arg_validation(jgauss, gauss):
    x, q = gauss
    tidx = _carried(jgauss)
    with pytest.raises(ValueError):
        graph_search(tidx, q, 0)
    with pytest.raises(ValueError):
        graph_search(tidx, q, x.shape[0] + 1)
    with pytest.raises(ValueError):
        graph_search(tidx, q, 5, beam=0)
    with pytest.raises(ValueError, match="dims differ"):
        graph_search(tidx, q[:, :4], 5)


def test_engine_resolution_on_cpu():
    """None: the exact engine on a CPU index, no fallback counted; True:
    the kernel engine (its plain scan); unsupported configs raise."""
    before = tgraph.ENGINE_FALLBACKS
    assert tgraph._resolve_beam_engine(None, 96, 512, CPU) is False
    assert tgraph._resolve_beam_engine(True, 96, 512, CPU) is True
    assert tgraph._resolve_beam_engine(False, 96, 512, CPU) is False
    assert tgraph.ENGINE_FALLBACKS == before
    with pytest.raises(ValueError, match="use_kernel=True unsupported"):
        tgraph._resolve_beam_engine(True, 100_000, 512, CPU)
    assert tgk.beam_scan_supported(96, 512)
    assert not tgk.beam_scan_supported(96, 520)      # not on the 128 grain
    assert tgk.rows_per_block(96) == 128 and tgk.rows_per_block(600) == 64


def test_kernel_engine_routes_the_same_widths():
    """The kernel engine takes exactly the widths it took when a block
    staged 32 rows of d + 1 floats (d <= 1,755), though 16-row tiles of
    the kernel fit wider ones; d = 1,701 to 1,755 run 16-row tiles."""
    def first_model_fits(d):
        return 4 * (d + 32 * (d + 1) + 32) + 4 * 128 <= 232_448

    for d in range(1, 4001):
        assert tgk.beam_scan_supported(d, 512) == first_model_fits(d), d
    assert tgk.rows_per_block(1700) == 32
    assert tgk.rows_per_block(1701) == tgk.rows_per_block(1755) == 16
    assert tgk.rows_per_block(3000) == 16
    with pytest.raises(ValueError, match="use_kernel=True unsupported"):
        tgraph._resolve_beam_engine(True, 1756, 512, CPU)


@pytest.mark.parametrize("beam", [16, 32, 64])
def test_degree16_select_keeps_every_subchunk(beam):
    """At degree 16 with k <= beam, s = min(c_pad/8, P) equals c_pad/8:
    the kernel engine's sub-chunk select keeps every candidate."""
    k, degree = 10, 16
    c_pad = -(-beam * degree // 128) * 128
    P = max(k, beam) + beam
    assert min(c_pad // 8, P) == c_pad // 8
    assert min(c_pad * 2 // 8, max(k, beam) + beam) < c_pad * 2 // 8


def test_corrupt_npz_names_field(jgauss, tmp_path):
    p = tmp_path / "graph.npz"
    save_index(jgauss, p)
    assert corrupt_bytes(p, field="storage.adjacency", seed=2) == \
        "storage.adjacency"
    with pytest.raises(terrors.CorruptIndexError,
                       match="storage.adjacency") as ei:
        load_graph(p, device=CPU)
    assert ei.value.field == "storage.adjacency"


def test_arrays_shape_checks(jgauss):
    leaves = _leaves(jgauss)
    leaves["storage.adjacency"] = leaves["storage.adjacency"][:-1]
    with pytest.raises(ValueError, match="do not fit together"):
        graph_index_from_arrays(leaves, "l2", device=CPU)
    with pytest.raises(ValueError, match="missing"):
        graph_index_from_arrays({"data_padded": leaves["data_padded"]},
                                "l2", device=CPU)


# -- the kernel's plain version against the JAX kernel -----------------------

def _kernel_case(rng, nq, d, n, c_pad, integer):
    if integer:
        table = rng.integers(-8, 8, (n + 1, d)).astype(np.float32)
        q = rng.integers(-8, 8, (nq, d)).astype(np.float32)
    else:
        table = rng.standard_normal((n + 1, d)).astype(np.float32)
        q = rng.standard_normal((nq, d)).astype(np.float32)
    table[n] = 1e15                                      # the sentinel row
    ids = rng.integers(0, n + 1, (nq, c_pad)).astype(np.int32)
    ids[:, -20:] = n                                     # sentinel padding
    return q, table, ids


def _jax_mins(q, table, ids, bounds, interpret):
    nq, d = q.shape
    qrows = np.zeros((nq, jgk.pad_queries(1), d), np.float32)
    qrows[:, 0] = q
    cands_t = np.ascontiguousarray(table[ids].transpose(0, 2, 1))
    args = (jnp.asarray(qrows), jnp.asarray(cands_t), jnp.asarray(bounds))
    if interpret:
        out = jgk.beam_scan_subchunk_min(*args, interpret=True)
    else:
        out = jgk.beam_scan_subchunk_min_lax(*args)
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("interpret", [False, True])
def test_beam_scan_plain_matches_jax(integer, interpret):
    rng = np.random.default_rng(5 + integer)
    nq, d, n, c_pad = 4, 16, 300, 512
    q, table, ids = _kernel_case(rng, nq, d, n, c_pad, integer)
    bounds = np.asarray([[0, c_pad], [0, 200], [13, 413], [5, 5]], np.int32)
    want = _jax_mins(q, table, ids, bounds, interpret)
    got = tgk.beam_scan_subchunk_min(
        torch.as_tensor(q), torch.as_tensor(table), torch.as_tensor(ids),
        torch.as_tensor(bounds)).numpy()
    assert got.shape == (nq, c_pad // 8)
    assert (got[3] == tgk.BIG).all()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        qn = (q.astype(np.float32) ** 2).sum(1)[:, None]
        yn = (table[ids] ** 2).sum(-1).reshape(nq, -1, 8).max(-1)
        assert (np.abs(got - want) <= 1e-5 * (qn + yn)).all()
    # the sentinel row scores ~1e32, past BIG, as in JAX
    sent = tgk.beam_scan_subchunk_min(
        torch.as_tensor(q), torch.as_tensor(table),
        torch.full((nq, 8), n, dtype=torch.int32),
        torch.as_tensor(np.asarray([[0, 8]] * nq, np.int32)))
    assert (sent > 1e31).all() and torch.isfinite(sent).all()


def test_beam_scan_argument_checks():
    q = torch.zeros((2, 8))
    table = torch.zeros((10, 8))
    ids = torch.zeros((2, 16), dtype=torch.int32)
    bounds = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgk.beam_scan_subchunk_min(q, table, ids[:, :12], bounds)
    with pytest.raises(ValueError, match="float32"):
        tgk.beam_scan_subchunk_min(q.double(), table, ids, bounds)
    with pytest.raises(ValueError, match="bounds"):
        tgk.beam_scan_subchunk_min(q, table, ids, bounds[:1])
    with pytest.raises(ValueError, match="do not match"):
        tgk.beam_scan_subchunk_min(q, table[:, :4], ids, bounds)


def test_kernel_engine_calls_the_scan_once_per_round(jgauss, gauss,
                                                     monkeypatch):
    """The kernel engine scores every round through the scan wrapper
    (``iters`` calls a search), at the padded candidate width."""
    _, q = gauss
    tidx = _carried(jgauss)
    shapes = []
    wrapper = tgk.beam_scan_score

    def recording(*args):
        shapes.append(tuple(args[2].shape))
        return wrapper(*args)

    monkeypatch.setattr(tgk, "beam_scan_score", recording)
    graph_search(tidx, q, 10, beam=16, iters=6, use_kernel=True)
    assert shapes == [(q.shape[0], 128)] * 6


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kernel_engine_rounds_make_no_exact_rescore(jgauss, gauss,
                                                    monkeypatch, use_kernel):
    """The kernel engine's rounds take the scan's exact distances: a
    search calls ``score_l2_candidates`` for the init and the tail only;
    the exact engine also once a round."""
    _, q = gauss
    tidx = _carried(jgauss)
    calls = []
    real = tgraph.score_l2_candidates

    def counting(*args):
        calls.append(tuple(args[1].shape))
        return real(*args)

    monkeypatch.setattr(tgraph, "score_l2_candidates", counting)
    graph_search(tidx, q, 10, beam=16, iters=6, use_kernel=use_kernel)
    assert len(calls) == (2 if use_kernel else 8)


def test_engines_walk_alike_round_by_round(jgauss, gauss):
    """``_beam_impl``'s ``on_round`` hook sees every round's frontier and
    merged pool; on the CPU the kernel engine (the scan's plain version)
    and the exact engine walk the same pools, round by round."""
    _, q = gauss
    tidx = _carried(jgauss)
    qt = torch.as_tensor(q)
    traces = {}
    for engine in (True, False):
        trace = traces[engine] = []
        tgraph._beam_impl(tidx, qt, k=10, beam=16, iters=6, hash_bits=14,
                          use_kernel=engine,
                          on_round=lambda f, pi, pd, tr=trace: tr.append(
                              (f.clone(), pi.clone(), pd.clone())))
    assert len(traces[True]) == len(traces[False]) == 6
    for (fk, ik, dk), (fe, ie, de) in zip(traces[True], traces[False]):
        assert fk.shape == fe.shape == (q.shape[0], 16)
        assert ik.shape == (q.shape[0], 32)
        assert torch.equal(fk, fe) and torch.equal(dk, de)
        assert all(set(a) == set(b) for a, b in zip(ik.tolist(),
                                                    ie.tolist()))


def _jax_exact(q, table, ids, n):
    return np.asarray(jcommon.score_l2_candidates(
        jnp.asarray(q), jnp.asarray(table[ids]), jnp.asarray(ids < n)))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("interpret", [False, True])
def test_beam_scan_score_plain_matches_jax(integer, interpret):
    """Both outputs of the scan's plain version against JAX: the minima
    against the JAX kernel (interpret mode) or its lax mirror as
    :func:`test_beam_scan_plain_matches_jax` holds them; the exact
    distances against JAX ``score_l2_candidates`` on the gathered rows,
    bitwise on the integer grid and within 1e-6 x (qn + yn) on Gaussian
    data (f32 sums in another order), +inf at the sentinel id and the
    padded tail."""
    rng = np.random.default_rng(11 + integer)
    nq, d, n, c_pad = 4, 16, 300, 256
    q, table, ids = _kernel_case(rng, nq, d, n, c_pad, integer)
    ids[1, :40] = n                                      # more sentinels
    bounds = np.asarray([[0, c_pad], [0, 100], [9, 201], [3, 3]], np.int32)
    mins, exact = tgk.beam_scan_score(
        torch.as_tensor(q), torch.as_tensor(table), torch.as_tensor(ids),
        torch.as_tensor(bounds), n)
    assert mins.shape == (nq, c_pad // 8) and exact.shape == (nq, c_pad)
    np.testing.assert_array_equal(
        mins.numpy(), tgk.beam_scan_subchunk_min(
            torch.as_tensor(q), torch.as_tensor(table), torch.as_tensor(ids),
            torch.as_tensor(bounds)).numpy())
    want_mins = _jax_mins(q, table, ids, bounds, interpret)
    want = _jax_exact(q, table, ids, n)
    got = exact.numpy()
    assert np.array_equal(np.isinf(got), ids >= n)
    assert np.isinf(got[:, -20:]).all() and np.isinf(got[1, :40]).all()
    live = ids < n
    if integer:
        np.testing.assert_array_equal(mins.numpy(), want_mins)
        np.testing.assert_array_equal(got, want)
    else:
        qn = (q ** 2).sum(1)[:, None]
        yn = (table[ids] ** 2).sum(-1)
        assert (np.abs(got[live] - want[live]) <= 1e-6 * (qn + yn)[live]).all()
        ynm = yn.reshape(nq, -1, 8).max(-1)
        assert (np.abs(mins.numpy() - want_mins) <= 1e-5 * (qn + ynm)).all()
    # n below the table's rows: every id at n or past it is +inf
    _, cut = tgk.beam_scan_score(
        torch.as_tensor(q), torch.as_tensor(table), torch.as_tensor(ids),
        torch.as_tensor(bounds), 150)
    assert np.array_equal(np.isinf(cut.numpy()), ids >= 150)
    np.testing.assert_array_equal(cut.numpy()[ids < 150], got[ids < 150])


def test_beam_scan_score_argument_checks():
    q = torch.zeros((2, 8))
    table = torch.zeros((10, 8))
    ids = torch.zeros((2, 16), dtype=torch.int32)
    bounds = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="n=11"):
        tgk.beam_scan_score(q, table, ids, bounds, 11)
    with pytest.raises(ValueError, match="n=-1"):
        tgk.beam_scan_score(q, table, ids, bounds, -1)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgk.beam_scan_score(q, table, ids[:, :12], bounds, 9)
    with pytest.raises(ValueError, match="int32"):
        tgk.beam_scan_score(q, table, ids.long(), bounds, 9)
    with pytest.raises(ValueError, match="bounds"):
        tgk.beam_scan_score(q, table, ids, bounds[:1], 9)
    with pytest.raises(ValueError, match="do not match"):
        tgk.beam_scan_score(q, table[:, :4], ids, bounds, 9)
    mins, exact = tgk.beam_scan_score(q, table, ids, bounds, 10)
    assert mins.shape == (2, 2) and exact.shape == (2, 16)
    assert (exact == 0).all()


def test_graph_modules_import_neither_jax_nor_the_jax_package():
    prog = (
        "import sys\n"
        "import raft_tpu_torch.sparse, raft_tpu_torch.sparse.knn_graph\n"
        "import raft_tpu_torch.spatial.ann.graph\n"
        "import raft_tpu_torch.spatial.ann.graph_kernel\n"
        "import raft_tpu_torch.spatial.ann.interop\n"
        "import raft_tpu_torch.tools.profile_grouped\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'raft_tpu' or m.startswith('raft_tpu.')]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout
