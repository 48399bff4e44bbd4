"""PyTorch port of the sparse suite's CSR, converters, structural ops and
sparse linear algebra (raft_tpu_torch.sparse coo / op / linalg) against
the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages, or a JAX ``COO`` /
``CSR`` is carried across (``coo_from_arrays`` / ``csr_from_arrays``).
Tolerances, and why:

* every container, converter and structural op, ``csr_add``,
  ``transpose``, the row norms and normalizations, ``spmv`` and ``spmm``
  are bitwise equal on integer-valued f32 entries (the ops sort and copy
  integers, and every sum is exact; a normalization divides the same
  two f32 numbers), padding included;
* ``fit_embedding`` draws its Lanczos start from a ``torch.Generator``
  where JAX uses a key, so the embeddings are compared up to a sign per
  column, within 1e-3 (a converged Ritz vector is accurate to its
  residual over the spectral gap, ~1e-4 here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import scipy.sparse as sp

from raft_tpu.sparse import coo as jcoo
from raft_tpu.sparse import linalg as jlin
from raft_tpu.sparse import op as jop
from raft_tpu_torch import sparse as tsparse
from raft_tpu_torch.sparse import coo as tcoo
from raft_tpu_torch.sparse import linalg as tlin
from raft_tpu_torch.sparse import op as top

torch.set_num_threads(1)

CPU = torch.device("cpu")
COO_FIELDS = ("rows", "cols", "vals", "nnz")
CSR_FIELDS = ("indptr", "indices", "data", "nnz")


def _dense(seed, m=12, n=9, p=0.35, lo=-5, hi=6):
    rng = np.random.default_rng(seed)
    d = rng.integers(lo, hi, (m, n)).astype(np.float32)
    return np.where(rng.random((m, n)) < p, d, 0).astype(np.float32)


def _arrays(obj, fields):
    out = {f: np.asarray(getattr(obj, f)) for f in fields}
    out["shape"] = obj.shape
    return out


def _carry_coo(j):
    return tcoo.coo_from_arrays(_arrays(j, COO_FIELDS), device=CPU)


def _carry_csr(j):
    return tcoo.csr_from_arrays(_arrays(j, CSR_FIELDS), device=CPU)


def _same(t, j, fields):
    assert tuple(t.shape) == tuple(j.shape)
    for f in fields:
        got, want = getattr(t, f), np.asarray(getattr(j, f))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def _pair(seed, cap_extra=5):
    d = _dense(seed)
    cap = int((d != 0).sum()) + cap_extra
    return d, jcoo.coo_from_dense(d, capacity=cap), tcoo.coo_from_dense(
        d, capacity=cap, device=CPU)


# -- containers and converters -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_from_dense_bitwise(seed):
    d, j, t = _pair(seed)
    _same(t, j, COO_FIELDS)
    np.testing.assert_array_equal(t.to_dense().numpy(), d)
    np.testing.assert_array_equal(t.degree().numpy(), np.asarray(j.degree()))


def test_coo_from_dense_default_capacity_and_empty():
    d = _dense(3)
    _same(tcoo.coo_from_dense(d, device=CPU), jcoo.coo_from_dense(d),
          COO_FIELDS)
    z = np.zeros((3, 4), np.float32)
    _same(tcoo.coo_from_dense(z, device=CPU), jcoo.coo_from_dense(z),
          COO_FIELDS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_from_coo_and_back_bitwise(seed):
    d, j, t = _pair(seed)
    jc = jcoo.csr_from_coo(j)
    tc = tcoo.csr_from_coo(t)
    _same(tc, jc, CSR_FIELDS)
    np.testing.assert_array_equal(tc.row_ids().numpy(),
                                  np.asarray(jc.row_ids()))
    np.testing.assert_array_equal(tc.to_dense().numpy(), d)
    np.testing.assert_array_equal(tc.valid_mask().numpy(),
                                  np.asarray(jc.valid_mask()))
    _same(tcoo.coo_from_csr(tc), jcoo.coo_from_csr(jc), COO_FIELDS)


def test_csr_from_coo_sorted_rows_skips_the_sort():
    d, j, t = _pair(4)
    js = jop.coo_sort(j)
    ts = top.coo_sort(t)
    _same(tcoo.csr_from_coo(ts, sorted_rows=True),
          jcoo.csr_from_coo(js, sorted_rows=True), CSR_FIELDS)


def test_csr_from_scipy_bitwise():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 10, 40)
    cols = rng.integers(0, 7, 40)
    vals = rng.integers(-3, 4, 40).astype(np.float64)
    m = sp.coo_matrix((vals, (rows, cols)), (10, 7))   # duplicates summed
    _same(tcoo.csr_from_scipy(m, device=CPU), jcoo.csr_from_scipy(m),
          CSR_FIELDS)


def test_arrays_carry_jax_containers_across():
    d, j, _ = _pair(6)
    jc = jcoo.csr_from_coo(j)
    _same(_carry_coo(j), j, COO_FIELDS)
    _same(_carry_csr(jc), jc, CSR_FIELDS)
    np.testing.assert_array_equal(_carry_csr(jc).to_dense().numpy(), d)


def test_sparse_exports():
    import raft_tpu.sparse as jsparse

    missing = set(jsparse.__all__) - set(tsparse.__all__)
    # every name, the sparse distances' included
    assert missing == set()


# -- structural ops ------------------------------------------------------------

@pytest.mark.parametrize("scalar", [0, 1, -3, 5])
def test_coo_remove_scalar_bitwise(scalar):
    d = _dense(7)
    d[d == 2] = scalar
    j = jcoo.coo_from_dense(d, capacity=80)
    t = _carry_coo(j)
    _same(top.coo_remove_scalar(t, scalar), jop.coo_remove_scalar(j, scalar),
          COO_FIELDS)


def test_coo_remove_zeros_bitwise():
    # explicit zeros inside nnz (a carried COO keeps them)
    j = jcoo.COO(jnp.asarray([0, 1, 1, 2, 3, 0], jnp.int32),
                 jnp.asarray([1, 0, 2, 2, 1, 0], jnp.int32),
                 jnp.asarray([3.0, 0.0, -1.0, 0.0, 2.0, 0.0], jnp.float32),
                 jnp.int32(5), (4, 3))
    t = _carry_coo(j)
    _same(top.coo_remove_zeros(t), jop.coo_remove_zeros(j), COO_FIELDS)


@pytest.mark.parametrize("start,stop", [(0, 12), (0, 1), (3, 8), (11, 12),
                                        (5, 5)])
def test_csr_row_slice_bitwise(start, stop):
    _, j, _ = _pair(8)
    jc = jcoo.csr_from_coo(j)
    _same(top.csr_row_slice(_carry_csr(jc), start, stop),
          jop.csr_row_slice(jc, start, stop), CSR_FIELDS)


def test_csr_row_op_bitwise():
    _, j, _ = _pair(9)
    jc = jcoo.csr_from_coo(j)
    scale_j = jnp.arange(12, dtype=jnp.float32) + 1
    scale_t = torch.arange(12, dtype=torch.float32) + 1
    got = top.csr_row_op(_carry_csr(jc), lambda r, v: v * scale_t[r] + r)
    want = jop.csr_row_op(jc, lambda r, v: v * scale_j[r] + r)
    _same(got, want, CSR_FIELDS)


# -- sparse linalg -------------------------------------------------------------

@pytest.mark.parametrize("norm", ["l1", "l2", "linf"])
def test_rows_norm_bitwise(norm):
    _, j, _ = _pair(10)
    jc = jcoo.csr_from_coo(j)
    np.testing.assert_array_equal(
        tlin.rows_norm(_carry_csr(jc), norm).numpy(),
        np.asarray(jlin.rows_norm(jc, norm)))


def test_rows_norm_unknown():
    _, j, _ = _pair(10)
    with pytest.raises(ValueError):
        tlin.rows_norm(_carry_csr(jcoo.csr_from_coo(j)), "l3")


@pytest.mark.parametrize("fn", ["csr_row_normalize_l1",
                                "csr_row_normalize_max"])
def test_row_normalize_bitwise(fn):
    d = _dense(11)
    d[4] = 0                                   # an empty row stays 0
    j = jcoo.csr_from_coo(jcoo.coo_from_dense(d, capacity=70))
    _same(getattr(tlin, fn)(_carry_csr(j)), getattr(jlin, fn)(j), CSR_FIELDS)


@pytest.mark.parametrize("seed", [12, 13])
def test_transpose_and_degree_bitwise(seed):
    d, j, t = _pair(seed)
    tt = tlin.transpose(t)
    _same(tt, jlin.transpose(j), COO_FIELDS)
    np.testing.assert_array_equal(tt.to_dense().numpy(), d.T)
    np.testing.assert_array_equal(tlin.coo_degree(t).numpy(),
                                  np.asarray(jlin.coo_degree(j)))


@pytest.mark.parametrize("seeds", [(14, 15), (16, 16)])
def test_csr_add_bitwise(seeds):
    da, ja, _ = _pair(seeds[0])
    db, jb, _ = _pair(seeds[1] + 100)
    jca, jcb = jcoo.csr_from_coo(ja), jcoo.csr_from_coo(jb)
    got = tlin.csr_add(_carry_csr(jca), _carry_csr(jcb))
    _same(got, jlin.csr_add(jca, jcb), CSR_FIELDS)
    np.testing.assert_array_equal(got.to_dense().numpy(), da + db)


@pytest.mark.parametrize("seed", [17, 18])
def test_spmv_spmm_bitwise(seed):
    d, j, _ = _pair(seed)
    jc = jcoo.csr_from_coo(j)
    tc = _carry_csr(jc)
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, 9).astype(np.float32)
    X = rng.integers(-4, 5, (9, 3)).astype(np.float32)
    np.testing.assert_array_equal(tlin.spmv(tc, torch.as_tensor(x)).numpy(),
                                  np.asarray(jlin.spmv(jc, x)))
    np.testing.assert_array_equal(tlin.spmv(tc, x).numpy(), d @ x)
    np.testing.assert_array_equal(tlin.spmm(tc, torch.as_tensor(X)).numpy(),
                                  np.asarray(jlin.spmm(jc, X)))


def test_fit_embedding_up_to_sign():
    """A weighted path with chords (distinct small eigenvalues): the
    embeddings span the same eigenvectors."""
    n = 48
    rng = np.random.default_rng(19)
    d = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        d[i, i + 1] = d[i + 1, i] = 1.0 + (i % 5)
    for _ in range(10):
        a, b = rng.integers(0, n, 2)
        if a != b:
            d[a, b] = d[b, a] = 0.5
    jc = jcoo.csr_from_coo(jcoo.coo_from_dense(d))
    want = np.asarray(jlin.fit_embedding(jc, 3))
    info = {}
    got = tlin.fit_embedding(_carry_csr(jc), 3, info=info).numpy()
    assert got.shape == want.shape == (n, 3)
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * signs, want, atol=1e-3)
    assert info["restarts"] >= 0 and info["residuals"].shape == (4,)
    # against the dense Laplacian's eigenvectors 1..3
    lap = np.diag(d.sum(1)) - d
    w, v = np.linalg.eigh(lap.astype(np.float64))
    np.testing.assert_allclose(info["eigenvalues"].numpy(), w[:4],
                               rtol=1e-4, atol=1e-5)
