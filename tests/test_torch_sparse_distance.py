"""PyTorch port of the sparse distances and sparse kNN
(raft_tpu_torch.sparse.distance) against the JAX package, on the CPU.

Inputs are scipy sparse matrices drawn from numpy seeds, carried into
both packages with ``csr_from_scipy``. Tolerances, and why:

* on integer-valued entries the squared L2, inner-product, L1 and Linf
  distances are exact in f32 in any summation order, so both packages'
  values are bitwise equal; the L2 root is compared with ``np.sqrt`` of
  the JAX squared value taken in f64 (the port roots through f64, the
  JAX package's f32 root on the CPU is not correctly rounded, ROADMAP
  R4), bitwise;
* the other metrics (cosine, correlation, Hellinger, Canberra,
  Bray-Curtis, Hamming, Minkowski) divide or take roots and logs in f32:
  within 2e-6 relative and absolute on integer data, and every metric
  within 1e-5 on generic data (products summed in another order);
* ids are compared up to ties: an id may differ from the JAX package's
  only where the two distances are equal.
"""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

from raft_tpu.sparse import csr_from_scipy as j_csr_from_scipy
from raft_tpu.sparse import distance as jd
from raft_tpu_torch.sparse import csr_from_scipy
from raft_tpu_torch.sparse import distance as td

torch.set_num_threads(1)

CPU = torch.device("cpu")
EXACT = ("sqeuclidean", "inner_product", "l1", "chebyshev")
OTHER = ("cosine", "correlation", "hellinger", "canberra", "braycurtis",
         "hamming")


def _rand(rng, m, d, nnz_per_row, integer=True):
    rvs = ((lambda k: rng.integers(1, 5, k).astype(np.float32)) if integer
           else (lambda k: rng.random(k).astype(np.float32)))
    return ss.random(m, d, density=nnz_per_row / d, format="csr",
                     dtype=np.float32, random_state=rng, data_rvs=rvs)


def _both(sp):
    return j_csr_from_scipy(sp), csr_from_scipy(sp, device=CPU)


def _hold(got, want, metric, integer=True):
    got = got.numpy()
    want = np.asarray(want)
    if metric in EXACT and integer:
        np.testing.assert_array_equal(got, want, err_msg=metric)
    elif metric == "euclidean" and integer:
        return
    else:
        tol = 2e-6 if integer else 1e-5
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=metric)


def _ids_up_to_ties(d_got, i_got, d_want, i_want):
    d_got, i_got = d_got.numpy(), i_got.numpy()
    d_want, i_want = np.asarray(d_want), np.asarray(i_want)
    assert i_got.dtype == np.int32
    diff = i_got != i_want
    assert (d_got[diff] == d_want[diff]).all()
    for r in np.flatnonzero(diff.any(1)):
        assert sorted(i_got[r][d_got[r] < d_got[r, -1]].tolist()) == sorted(
            i_want[r][d_want[r] < d_want[r, -1]].tolist())


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    return _rand(rng, 23, 70, 12), _rand(rng, 31, 70, 12)


# -- densify_rows --------------------------------------------------------------

@pytest.mark.parametrize("start,rows", [(0, 8), (16, 8), (20, 16)])
def test_densify_rows_bitwise(small, start, rows):
    a, _ = small
    ja, ta = _both(a)
    np.testing.assert_array_equal(td.densify_rows(ta, start, rows).numpy(),
                                  np.asarray(jd.densify_rows(ja, start, rows)))


# -- sparse_pairwise_distance --------------------------------------------------

@pytest.mark.parametrize("metric", EXACT + ("euclidean",) + OTHER
                         + ("minkowski",))
@pytest.mark.parametrize("strategy", ["dense", "colblock"])
def test_pairwise_against_jax_integer(small, metric, strategy):
    a, b = small
    (ja, ta), (jb, tb) = _both(a), _both(b)
    kw = dict(strategy=strategy, p=3.0)
    if strategy == "colblock":
        kw.update(col_block=16, block_n=8)
    got = td.sparse_pairwise_distance(ta, tb, metric, **kw)
    want = jd.sparse_pairwise_distance(ja, jb, metric, **kw)
    assert got.dtype == torch.float32 and got.shape == (23, 31)
    _hold(got, want, metric)
    if metric == "euclidean":
        sq = jd.sparse_pairwise_distance(ja, jb, "sqeuclidean", **kw)
        np.testing.assert_array_equal(
            got.numpy(),
            np.sqrt(np.asarray(sq, np.float64)).astype(np.float32))


@pytest.mark.parametrize("metric", ("sqeuclidean", "euclidean", "cosine",
                                    "correlation", "l1", "canberra"))
def test_pairwise_generic_data_within_tolerance(metric):
    rng = np.random.default_rng(1)
    a, b = _rand(rng, 19, 90, 15, False), _rand(rng, 27, 90, 15, False)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    for kw in (dict(strategy="dense"),
               dict(strategy="colblock", col_block=32, block_n=16)):
        got = td.sparse_pairwise_distance(ta, tb, metric, **kw)
        want = jd.sparse_pairwise_distance(ja, jb, metric, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{metric} {kw}")


def test_pairwise_auto_strategy_and_host_syncs():
    """auto densifies a narrow problem (no host read) and takes colblock
    once a densified side passes the 256 MiB budget (one host read of
    the block occupancy a call)."""
    rng = np.random.default_rng(2)
    narrow = _rand(rng, 10, 50, 5)
    _, tn = _both(narrow)
    before = td.HOST_SYNCS
    td.sparse_pairwise_distance(tn, tn, "sqeuclidean")
    assert td.HOST_SYNCS == before
    wide = _rand(rng, 12, 6_000_000, 4)
    (jw, tw) = _both(wide)
    got = td.sparse_pairwise_distance(tw, tw, "sqeuclidean",
                                      col_block=1 << 20)
    assert td.HOST_SYNCS == before + 1
    want = jd.sparse_pairwise_distance(jw, jw, "sqeuclidean",
                                       col_block=1 << 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the prebuilt index --------------------------------------------------------

@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(3)
    return _rand(rng, 300, 20_000, 30), _rand(rng, 40, 20_000, 30)


@pytest.mark.parametrize("row_block", [4096, 64])
def test_index_build_matches_jax(wide, row_block):
    idx, _ = wide
    j = jd.sparse_colblock_index_build(idx, col_block=4096,
                                       row_block=row_block)
    t = td.sparse_colblock_index_build(idx, col_block=4096,
                                       row_block=row_block, device=CPU)
    for f in ("rows", "lcols", "vals", "counts", "rb_off"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.shape, t.col_block, t.row_block, t.cap_cell) == (
        tuple(j.shape), j.col_block, j.row_block, j.cap_cell)
    np.testing.assert_array_equal(t.rb_off_host, np.asarray(j.rb_off))
    np.testing.assert_array_equal(t.counts_host, np.asarray(j.counts))


@pytest.mark.parametrize("metric", ("sqeuclidean", "euclidean", "l1",
                                    "cosine", "hellinger"))
@pytest.mark.parametrize("row_block", [4096, 64])
def test_prebuilt_route_against_jax(wide, metric, row_block):
    idx, qry = wide
    j = jd.sparse_colblock_index_build(idx, col_block=4096,
                                       row_block=row_block)
    t = td.sparse_colblock_index_build(idx, col_block=4096,
                                       row_block=row_block, device=CPU)
    jq, tq = _both(qry)
    before = td.HOST_SYNCS
    dt, it = td.sparse_brute_force_knn(t, tq, 7, metric=metric)
    assert td.HOST_SYNCS == before + 1       # the query side's occupancy
    dj, ij = jd.sparse_brute_force_knn(j, jq, 7, metric=metric)
    if metric == "euclidean":
        sq, _ = jd.sparse_brute_force_knn(j, jq, 7, metric="sqeuclidean")
        np.testing.assert_array_equal(
            dt.numpy(), np.sqrt(np.asarray(sq, np.float64)).astype(
                np.float32))
    else:
        _hold(dt, dj, metric)
    _ids_up_to_ties(dt, it, dj if metric != "euclidean" else dt, ij)
    pt = td.sparse_pairwise_distance(tq, t, metric)
    pj = jd.sparse_pairwise_distance(jq, j, metric)
    if metric != "euclidean":
        _hold(pt, pj, metric)


def test_prebuilt_route_repeated_entries_summed_in_order():
    """A scipy COO with repeated (row, column) entries: the prebuilt index
    keeps them apart and the search adds them in their sorted order, as
    the JAX package's sorted segment sum does."""
    rng = np.random.default_rng(4)
    r = rng.integers(0, 50, 900)
    c = rng.integers(0, 3000, 900)
    v = rng.random(900).astype(np.float32)
    r, c, v = np.concatenate([r, r[:300]]), np.concatenate([c, c[:300]]), \
        np.concatenate([v, v[:300] * 3.0])
    idx = ss.coo_matrix((v, (r, c)), shape=(50, 3000))
    j = jd.sparse_colblock_index_build(idx, col_block=512, row_block=16)
    t = td.sparse_colblock_index_build(idx, col_block=512, row_block=16,
                                       device=CPU)
    jq, tq = _both(_rand(rng, 9, 3000, 40, False))
    for metric in ("inner_product", "sqeuclidean"):
        np.testing.assert_allclose(
            td.sparse_pairwise_distance(tq, t, metric).numpy(),
            np.asarray(jd.sparse_pairwise_distance(jq, j, metric)),
            rtol=1e-6, atol=1e-6, err_msg=metric)


# -- sparse_brute_force_knn on CSR indexes -------------------------------------

@pytest.mark.parametrize("metric", ("sqeuclidean", "l1", "chebyshev",
                                    "cosine", "correlation", "braycurtis"))
@pytest.mark.parametrize("strategy", ["dense", "colblock"])
def test_knn_against_jax(metric, strategy):
    rng = np.random.default_rng(5)
    idx, qry = _rand(rng, 150, 400, 20), _rand(rng, 37, 400, 20)
    (ji, ti), (jq, tq) = _both(idx), _both(qry)
    kw = dict(strategy=strategy, block_q=16, block_n=48)
    if strategy == "colblock":
        kw.update(col_block=128)
    dt, it = td.sparse_brute_force_knn(ti, tq, 6, metric=metric, **kw)
    dj, ij = jd.sparse_brute_force_knn(ji, jq, 6, metric=metric, **kw)
    assert dt.shape == (37, 6) and it.dtype == torch.int32
    _hold(dt, dj, metric)
    _ids_up_to_ties(dt, it, dj, ij)


def test_knn_colblock_single_block_and_scipy_oracle(wide):
    """The colblock route with one index row block (the whole index in
    one accumulator) against JAX and scipy's f64 CSR product."""
    idx, qry = wide
    (ji, ti), (jq, tq) = _both(idx), _both(qry)
    before = td.HOST_SYNCS
    dt, it = td.sparse_brute_force_knn(ti, tq, 5, metric="sqeuclidean",
                                       strategy="colblock", col_block=4096)
    assert td.HOST_SYNCS == before + 1
    dj, ij = jd.sparse_brute_force_knn(ji, jq, 5, metric="sqeuclidean",
                                       strategy="colblock", col_block=4096)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    _ids_up_to_ties(dt, it, dj, ij)
    q64, i64 = qry.astype(np.float64), idx.astype(np.float64)
    full = (np.asarray(q64.multiply(q64).sum(1)) + np.asarray(
        i64.multiply(i64).sum(1)).T - 2.0 * (q64 @ i64.T).toarray())
    want = np.sort(full, 1)[:, :5]
    np.testing.assert_array_equal(dt.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(
        np.take_along_axis(full, it.numpy().astype(np.int64), 1), want)


def test_precision_values_all_run_f32(wide):
    """``precision`` "default" and "highest" give the bits of None (R3)."""
    idx, qry = wide
    _, tq = _both(qry)
    t = td.sparse_colblock_index_build(idx, device=CPU)
    d0, i0 = td.sparse_brute_force_knn(t, tq, 5, metric="sqeuclidean")
    for precision in ("default", "highest"):
        d1, i1 = td.sparse_brute_force_knn(t, tq, 5, metric="sqeuclidean",
                                           precision=precision)
        assert torch.equal(d0, d1) and torch.equal(i0, i1)
    with pytest.raises(ValueError, match="precision"):
        td.sparse_brute_force_knn(t, tq, 5, precision="bf16")


def test_arguments_checked_and_device_rule(small):
    a, b = small
    _, ta = _both(a)
    with pytest.raises(ValueError, match="strategy"):
        td.sparse_pairwise_distance(ta, ta, strategy="hash")
    with pytest.raises(ValueError):
        td.sparse_brute_force_knn(ta, ta, 100)
    t = td.sparse_colblock_index_build(a, col_block=16, device=CPU)
    with pytest.raises(ValueError, match="haversine"):
        td.sparse_pairwise_distance(ta, t, "haversine")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.sparse_colblock_index_build(a)


# -- archives ------------------------------------------------------------------

def test_jax_archive_loads_into_the_port_and_back(wide, tmp_path):
    """A JAX ``sparse_colblock`` archive loads into the port and searches
    as JAX's index does; the port's archive loads into JAX the same."""
    from raft_tpu.spatial.ann.serialize import load_index as j_load
    from raft_tpu.spatial.ann.serialize import save_index as j_save
    from raft_tpu_torch.spatial.ann import interop

    idx, qry = wide
    j = jd.sparse_colblock_index_build(idx, col_block=4096, row_block=128)
    j_save(j, tmp_path / "j.npz")
    t = interop.load_index(tmp_path / "j.npz", device=CPU)
    assert isinstance(t, td.SparseColBlockIndex)
    assert t.shape == (300, 20_000) and t.row_block == 128
    np.testing.assert_array_equal(t.rb_off_host, np.asarray(j.rb_off))
    jq, tq = _both(qry)
    dt, it = td.sparse_brute_force_knn(t, tq, 5, metric="sqeuclidean")
    dj, ij = jd.sparse_brute_force_knn(j, jq, 5, metric="sqeuclidean")
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    _ids_up_to_ties(dt, it, dj, ij)
    assert isinstance(interop.load_sparse_colblock(tmp_path / "j.npz",
                                                   device=CPU),
                      td.SparseColBlockIndex)

    interop.save_index(t, tmp_path / "t.npz")
    back = j_load(tmp_path / "t.npz")
    for f in ("rows", "lcols", "vals", "counts", "rb_off"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert tuple(back.shape) == tuple(j.shape)
    assert (back.col_block, back.row_block, back.cap_cell) == (
        j.col_block, j.row_block, j.cap_cell)


def test_public_names_match_the_jax_module():
    import raft_tpu.sparse as jsparse
    import raft_tpu_torch.sparse as tsparse

    for name in jd.__all__:
        assert hasattr(td, name), name
        assert getattr(tsparse, name) is getattr(td, name)
        assert hasattr(jsparse, name)
    assert td._DENSE_BYTES_BUDGET == jd._DENSE_BYTES_BUDGET == 1 << 28
    assert td._ACC_BYTES_BUDGET == jd._ACC_BYTES_BUDGET == 1 << 28
