"""PyTorch port of ``linalg/`` (raft_tpu_torch.linalg) against the JAX
package, on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerances, and
why:

* elementwise ops, reductions, the by-key reductions, GEMM / GEMV and
  the matrix-vector ops are bitwise equal on integer-valued f32 inputs
  (every product and sum is exact, so no summation order shows);
* decompositions: values within 1e-4 relative (1e-5 absolute floor),
  eigen- and singular vectors up to a sign per column within 1e-4 —
  LAPACK through PyTorch and through XLA round differently, and a
  vector is unique only up to sign;
* randomized SVD: the test matrices differ (a ``torch.Generator``
  against a JAX key), so the singular values of an exactly low-rank
  input are compared, within 1e-4 relative;
* Lanczos: the same ``v0`` in both packages; eigenvalues within 1e-4
  relative with a 1e-5 absolute floor (the Laplacian's zero eigenvalue
  converges to ~1e-6 in f32 in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import linalg as jl
from raft_tpu.linalg import matrix_vector as jmv
from raft_tpu.linalg.lanczos import lanczos_solver as j_lanczos
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.linalg import matrix_vector as tmv
from raft_tpu_torch.linalg.lanczos import lanczos_solver as t_lanczos

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5


def _ints(rng, shape, lo=-8, hi=8):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _up_to_sign(got, want, atol=1e-4):
    """Columns equal up to a sign each."""
    got, want = _np(got), np.asarray(want)
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1
    np.testing.assert_allclose(got * signs[None, :], want, atol=atol)


@pytest.fixture
def mats():
    rng = np.random.default_rng(42)
    return _ints(rng, (17, 9)), _ints(rng, (17, 9)), _ints(rng, (17, 9))


# -- elementwise ---------------------------------------------------------------

_BINARY = ["add", "subtract", "eltwise_multiply"]
_SCALAR = ["add_scalar", "subtract_scalar", "multiply_scalar",
           "scalar_multiply", "divide_scalar"]


@pytest.mark.parametrize("name", _BINARY)
def test_binary_arithmetic_bitwise(mats, name):
    a, b, _ = mats
    _bitwise(getattr(tl, name)(_t(a), _t(b)), getattr(jl, name)(a, b))


@pytest.mark.parametrize("name", _SCALAR)
def test_scalar_arithmetic_bitwise(mats, name):
    a, _, _ = mats
    _bitwise(getattr(tl, name)(_t(a), 4.0), getattr(jl, name)(a, 4.0))


def test_eltwise_divide_bitwise(mats):
    a, b, _ = mats
    b = np.where(b == 0, 1, b).astype(np.float32)
    _bitwise(tl.eltwise_divide(_t(a), _t(b)), jl.eltwise_divide(a, b))


def test_op_wrappers_bitwise(mats):
    a, b, c = mats
    _bitwise(tl.unary_op(_t(a), lambda x: x * x - 1),
             jl.unary_op(a, lambda x: x * x - 1))
    _bitwise(tl.binary_op(_t(a), _t(b), lambda x, y: x * y + x),
             jl.binary_op(a, b, lambda x, y: x * y + x))
    _bitwise(tl.ternary_op(_t(a), _t(b), _t(c), lambda x, y, z: x * y - z),
             jl.ternary_op(a, b, c, lambda x, y, z: x * y - z))
    _bitwise(tl.map_op(lambda x, y: x - 2 * y, _t(a), _t(b)),
             jl.map_op(lambda x, y: x - 2 * y, a, b))


def test_map_then_reduce_bitwise(mats):
    a, b, _ = mats
    _bitwise(tl.map_then_reduce(lambda x, y: (x - y) ** 2, _t(a), _t(b)),
             jl.map_then_reduce(lambda x, y: (x - y) ** 2, a, b))
    _bitwise(tl.map_then_reduce(lambda x: x, _t(a), reduce_fn=torch.amax),
             jl.map_then_reduce(lambda x: x, a, reduce_fn=jnp.max))


@pytest.mark.parametrize("scalar", [None, 2.0, 3.0])
def test_power_bitwise(mats, scalar):
    a, _, _ = mats
    _bitwise(tl.power(_t(a), scalar), jl.power(a, scalar))


def test_sqrt_reciprocal(mats):
    a, _, _ = mats
    sq = np.abs(a) ** 2
    _bitwise(tl.sqrt(_t(sq)), jl.sqrt(sq))
    x = np.array([2.0, 0.0, 4.0, -8.0, 1e-20], np.float32)
    for setzero in (False, True):
        _bitwise(tl.reciprocal(_t(x), scalar=2.0, setzero=setzero),
                 jl.reciprocal(x, scalar=2.0, setzero=setzero))


def test_sign_flip_bitwise(mats):
    a, _, _ = mats
    a = a.copy()
    a[:, 3] = 0            # an all-zero column keeps its sign
    a[0, 4], a[5, 4] = -8, 8   # a tie: the first occurrence decides
    _bitwise(tl.sign_flip(_t(a)), jl.sign_flip(a))


def test_axpy_dot_bitwise():
    rng = np.random.default_rng(1)
    x, y = _ints(rng, 33), _ints(rng, 33)
    _bitwise(tl.axpy(2.0, _t(x), _t(y)), jl.axpy(2.0, x, y))
    _bitwise(tl.dot(_t(x), _t(y)), jl.dot(x, y))


def test_arrays_go_to_the_device_asked_for():
    x = np.arange(4, dtype=np.float64)
    out = tl.add(x, x, device="cpu")
    assert out.dtype == torch.float32 and out.device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.add(x, x)


# -- reductions ----------------------------------------------------------------

@pytest.mark.parametrize("norm_type", ["l1", "l2", "linf"])
@pytest.mark.parametrize("axis", [0, -1])
def test_norms_bitwise(mats, norm_type, axis):
    a, _, _ = mats
    _bitwise(tl.norm(_t(a), norm_type, axis=axis),
             jl.norm(a, norm_type, axis=axis))
    fn_t, fn_j = ((tl.row_norm, jl.row_norm) if axis == -1
                  else (tl.col_norm, jl.col_norm))
    _bitwise(fn_t(_t(a), norm_type), fn_j(a, norm_type))


def test_norm_sqrt_and_unknown(mats):
    a, _, _ = mats
    _bitwise(tl.row_norm(_t(a), tl.L2Norm, do_sqrt=True),
             np.sqrt(np.asarray(jl.row_norm(a, jl.L2Norm))))
    with pytest.raises(ValueError):
        tl.norm(_t(a), "l3")


def test_generic_reductions_bitwise(mats):
    a, _, _ = mats
    _bitwise(tl.coalesced_reduction(_t(a)), jl.coalesced_reduction(a))
    _bitwise(tl.strided_reduction(_t(a)), jl.strided_reduction(a))
    _bitwise(tl.reduce(_t(a), 1, main_op=torch.abs, reduce_op=torch.amax,
                       final_op=lambda v: v * 2),
             jl.reduce(a, 1, main_op=jnp.abs, reduce_op=jnp.max,
                       final_op=lambda v: v * 2))


@pytest.mark.parametrize("n_keys", [5, 4097])
@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_rows_by_key_bitwise(n_keys, weighted):
    """Both routes: the one-hot matmul (<= 4,096 keys) and the
    scatter-add (above)."""
    rng = np.random.default_rng(n_keys)
    x = _ints(rng, (60, 7))
    keys = rng.integers(0, n_keys, 60).astype(np.int32)
    w = _ints(rng, 60, 0, 4) if weighted else None
    got = tl.reduce_rows_by_key(_t(x), _t(keys), n_keys,
                                weights=None if w is None else _t(w))
    _bitwise(got, jl.reduce_rows_by_key(x, keys, n_keys, weights=w))


def test_reduce_rows_by_key_integer_input():
    rng = np.random.default_rng(3)
    x = rng.integers(-5, 5, (40, 3)).astype(np.int32)
    keys = rng.integers(0, 4, 40).astype(np.int32)
    got = tl.reduce_rows_by_key(_t(x), _t(keys), 4)
    assert got.dtype == torch.int32
    _bitwise(got, jl.reduce_rows_by_key(x, keys, 4))


def test_reduce_cols_by_key_bitwise():
    rng = np.random.default_rng(4)
    x = _ints(rng, (6, 20))
    keys = rng.integers(0, 4, 20).astype(np.int32)
    _bitwise(tl.reduce_cols_by_key(_t(x), _t(keys), 4),
             jl.reduce_cols_by_key(x, keys, 4))


def test_mse_and_divide_bitwise(mats):
    a, b, _ = mats
    _bitwise(tl.mean_squared_error(_t(a), _t(b), weight=0.5),
             jl.mean_squared_error(a, b, weight=0.5))
    num = np.array([1.0, 2.0, -3.0], np.float32)
    den = np.array([2.0, 0.0, 4.0], np.float32)
    for rz in (False, True):
        _bitwise(tl.binary_div_skip_zero(_t(num), _t(den), return_zero=rz),
                 jl.binary_div_skip_zero(num, den, return_zero=rz))


# -- gemm / matrix-vector ------------------------------------------------------

@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_gemm_bitwise(trans_a, trans_b):
    rng = np.random.default_rng(5)
    a, b, c = _ints(rng, (5, 7)), _ints(rng, (7, 3)), _ints(rng, (5, 3))
    a_in = a.T.copy() if trans_a else a
    b_in = b.T.copy() if trans_b else b
    _bitwise(tl.gemm(_t(a_in), _t(b_in), trans_a=trans_a, trans_b=trans_b),
             jl.gemm(a_in, b_in, trans_a=trans_a, trans_b=trans_b))
    _bitwise(tl.gemm(_t(a_in), _t(b_in), trans_a=trans_a, trans_b=trans_b,
                     alpha=2.0, beta=0.5, c=_t(c)),
             jl.gemm(a_in, b_in, trans_a=trans_a, trans_b=trans_b,
                     alpha=2.0, beta=0.5, c=c))


def test_gemv_transpose_bitwise():
    rng = np.random.default_rng(6)
    a, x, y = _ints(rng, (5, 7)), _ints(rng, 7), _ints(rng, 5)
    _bitwise(tl.gemv(_t(a), _t(x)), jl.gemv(a, x))
    _bitwise(tl.gemv(_t(a.T.copy()), _t(x), trans_a=True, alpha=3.0,
                     beta=2.0, y=_t(y)),
             jl.gemv(a.T.copy(), x, trans_a=True, alpha=3.0, beta=2.0, y=y))
    _bitwise(tl.transpose(_t(a)), jl.transpose(a))
    t3 = _ints(rng, (2, 3, 4))
    _bitwise(tl.transpose(_t(t3)), jl.transpose(t3))


@pytest.mark.parametrize("along_rows", [True, False])
def test_matrix_vector_bitwise(mats, along_rows):
    a, _, _ = mats
    rng = np.random.default_rng(7)
    n = a.shape[1] if along_rows else a.shape[0]
    v1, v2 = _ints(rng, n), _ints(rng, n)
    _bitwise(tmv.matrix_vector_add(_t(a), _t(v1), along_rows),
             jmv.matrix_vector_add(a, v1, along_rows))
    _bitwise(tmv.matrix_vector_mul(_t(a), _t(v1), along_rows),
             jmv.matrix_vector_mul(a, v1, along_rows))
    _bitwise(tmv.matrix_vector_op(_t(a), _t(v1), lambda m, v: m - 2 * v,
                                  along_rows),
             jmv.matrix_vector_op(a, v1, lambda m, v: m - 2 * v, along_rows))
    _bitwise(tmv.matrix_vector_binary(_t(a), _t(v1), _t(v2),
                                      lambda m, p, q: (m - p) * q,
                                      along_rows),
             jmv.matrix_vector_binary(a, v1, v2, lambda m, p, q: (m - p) * q,
                                      along_rows))
    _bitwise(tmv.linewise_op(_t(a), lambda m, p, q: m * p + q, along_rows,
                             _t(v1), _t(v2)),
             jmv.linewise_op(a, lambda m, p, q: m * p + q, along_rows, v1,
                             v2))


def test_export_list_matches():
    assert set(tl.__all__) == set(jl.__all__)


# -- decompositions ------------------------------------------------------------

@pytest.fixture
def sym():
    a = np.random.default_rng(8).standard_normal((12, 12)).astype(np.float32)
    return (a + a.T) / 2


def test_eig_dc_and_jacobi(sym):
    jv, jw = jl.eig_dc(sym)
    for got in (tl.eig_dc(_t(sym)), tl.eig_jacobi(_t(sym), tol=1e-6,
                                                  sweeps=4)):
        _close(got[1], jw)
        _up_to_sign(got[0], jv)
    v, w = tl.eig_dc(_t(sym), n_eig_vals=4)
    _close(w, np.asarray(jw)[:4])
    _up_to_sign(v, np.asarray(jv)[:, :4])
    with pytest.raises(ValueError):
        tl.eig_jacobi(_t(sym), tol=0.0)
    with pytest.raises(ValueError):
        tl.svd_jacobi(_t(sym), sweeps=0)


@pytest.mark.parametrize("largest", [True, False])
def test_eig_sel_dc(sym, largest):
    jv, jw = jl.eig_sel_dc(sym, 3, largest=largest)
    v, w = tl.eig_sel_dc(_t(sym), 3, largest=largest)
    _close(w, jw)
    _up_to_sign(v, jv)


def test_qr():
    a = np.random.default_rng(9).standard_normal((15, 6)).astype(np.float32)
    jq, jr = jl.qr_get_qr(a)
    q, r = tl.qr_get_qr(_t(a))
    _up_to_sign(q, jq)
    _up_to_sign(r.T, np.asarray(jr).T)
    _up_to_sign(tl.qr_get_q(_t(a)), jq)


@pytest.mark.parametrize("fn", ["svd_qr", "svd_jacobi", "svd_eig"])
def test_svd_variants(fn):
    a = np.random.default_rng(10).standard_normal((40, 5)).astype(np.float32)
    ju, js, jv = getattr(jl, fn)(a)
    u, s, v = getattr(tl, fn)(_t(a))
    _close(s, js)
    _up_to_sign(u, ju, atol=1e-3 if fn == "svd_eig" else 1e-4)
    _up_to_sign(v, jv)
    _close(tl.svd_reconstruction(u, s, v),
           jl.svd_reconstruction(ju, js, jv), atol=1e-4)


def test_svd_qr_without_vectors():
    a = np.random.default_rng(11).standard_normal((8, 4)).astype(np.float32)
    u, s, v = tl.svd_qr(_t(a), gen_left_vec=False, gen_right_vec=False)
    assert u is None and v is None
    _close(s, jl.svd_qr(a)[1])


@pytest.mark.parametrize("n_iters", [0, 3])
def test_rsvd_fixed_rank_low_rank(n_iters):
    rng = np.random.default_rng(12)
    a = (_ints(rng, (60, 5)) @ _ints(rng, (5, 30))).astype(np.float32)
    _, js, _ = jl.rsvd_fixed_rank(a, k=5, p=8, n_iters=n_iters)
    u, s, v = tl.rsvd_fixed_rank(_t(a), k=5, p=8, n_iters=n_iters,
                                 generator=torch.Generator().manual_seed(3))
    _close(s, js, atol=0)
    _close(u @ torch.diag(s) @ v.T, a, rtol=0, atol=1e-4 * np.abs(a).max())
    # rsvd_perc picks the rank from the fraction
    _, ps, _ = tl.rsvd_perc(_t(a), 0.2, p=8)
    assert ps.shape == (6,)
    _close(ps[:5], js, atol=0)


@pytest.mark.parametrize("fn", ["lstsq_svd_qr", "lstsq_svd_jacobi",
                                "lstsq_eig", "lstsq_qr"])
def test_lstsq(fn):
    rng = np.random.default_rng(13)
    a = rng.standard_normal((40, 6)).astype(np.float32)
    b = a @ rng.standard_normal(6).astype(np.float32)
    _close(getattr(tl, fn)(_t(a), _t(b)), getattr(jl, fn)(a, b), atol=1e-4)
    b2 = np.stack([b, 2 * b], axis=1)
    # several right-hand sides; JAX's lstsq_eig takes one only
    want = (np.linalg.lstsq(a, b2, rcond=None)[0] if fn == "lstsq_eig"
            else getattr(jl, fn)(a, b2))
    _close(getattr(tl, fn)(_t(a), _t(b2)), want, atol=1e-4)


@pytest.mark.parametrize("lower", [True, False])
def test_cholesky_rank1_update(lower):
    a = np.random.default_rng(14).standard_normal((6, 6)).astype(np.float32)
    spd = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    lj = jnp.zeros((6, 6), jnp.float32)
    lt = torch.zeros((6, 6))
    for n in range(1, 7):
        if lower:
            lj = lj.at[n - 1, :n].set(spd[n - 1, :n])
            lt[n - 1, :n] = _t(spd[n - 1, :n])
        else:
            lj = lj.at[:n, n - 1].set(spd[n - 1, :n])
            lt[:n, n - 1] = _t(spd[n - 1, :n])
        lj = jl.cholesky_rank1_update(lj, n, lower=lower)
        lt = tl.cholesky_rank1_update(lt, n, lower=lower)
        _close(lt, lj, atol=1e-4)
    want = np.linalg.cholesky(spd)
    _close(lt, want if lower else want.T, atol=1e-4)


# -- Lanczos -------------------------------------------------------------------

@pytest.mark.parametrize("smallest", [True, False])
def test_lanczos_dense_same_v0(smallest):
    n = 60
    a = np.random.default_rng(15).standard_normal((n, n)).astype(np.float32)
    sym = (a + a.T) / 2
    v0 = np.random.default_rng(16).standard_normal(n).astype(np.float32)
    wj, vj = j_lanczos(lambda v: jnp.asarray(sym) @ v, n, 3, ncv=40, v0=v0,
                       smallest=smallest)
    st = _t(sym)
    wt, vt = t_lanczos(lambda v: st @ v, n, 3, ncv=40, v0=_t(v0),
                       smallest=smallest)
    _close(wt, wj)
    _up_to_sign(vt, vj, atol=1e-3)
    fn = (tl.lanczos_smallest_eigenvectors if smallest
          else tl.lanczos_largest_eigenvectors)
    _close(fn(lambda v: st @ v, n, 3, ncv=40, v0=_t(v0))[0], wj)


def test_lanczos_large_laplacian_same_v0():
    """tests/test_linalg.py:193's graph: a 50,000-node ring with random
    chords, ncv 48 << n, so restarts are needed."""
    import scipy.sparse as sp

    from raft_tpu_torch.sparse import csr_from_scipy
    from raft_tpu_torch.sparse.linalg import spmv

    n = 50_000
    rng = np.random.default_rng(0)
    rows = np.arange(n)
    ij = np.concatenate([np.stack([rows, (rows + 1) % n]),
                         rng.integers(0, n, size=(2, n // 2))], axis=1)
    a = sp.coo_matrix((np.ones(ij.shape[1]), (ij[0], ij[1])), (n, n))
    a = ((a + a.T) > 0).astype(np.float64)
    lap = (sp.diags(np.asarray(a.sum(1)).ravel()) - a).tocsr().astype(
        np.float32)
    data, indices = jnp.asarray(lap.data), jnp.asarray(lap.indices)
    row_ids = jnp.searchsorted(jnp.asarray(lap.indptr),
                               jnp.arange(lap.nnz), side="right") - 1

    def jmatvec(v):
        import jax

        return jax.ops.segment_sum(data * v[indices], row_ids,
                                   num_segments=n)

    v0 = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    wj, _, rj, itj = j_lanczos(jmatvec, n, 4, ncv=48, tol=1e-6, v0=v0,
                               return_info=True)
    csr = csr_from_scipy(lap, device="cpu")
    wt, vecs, rt, itt = t_lanczos(lambda v: spmv(csr, v), n, 4, ncv=48,
                                  tol=1e-6, v0=_t(v0), return_info=True)
    assert itt >= 1 and int(itj) >= 1
    _close(wt, wj)
    assert vecs.shape == (n, 4) and rt.shape == (4,)


def test_lanczos_argument_checks():
    st = torch.eye(10)
    with pytest.raises(ValueError, match="out of range"):
        t_lanczos(lambda v: st @ v, 10, 11, device="cpu")
    with pytest.raises(ValueError, match="needs ncv"):
        t_lanczos(lambda v: st @ v, 10, 5, ncv=6, device="cpu")
