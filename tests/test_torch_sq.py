"""PyTorch port of IVF-SQ (raft_tpu_torch spatial/ann/ivf_sq + sq_kernel)
against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. The JAX SQ index
is carried across through its npz checkpoint (``save_index`` ->
``load_ivf_sq``). On the dyadic fixture (codes that are the integer rows,
``vmin = -128``, ``vscale = 1``, the fixture of tests/test_sq_kernel.py)
every decoded value is a bf16-exact integer and every f32 sum exact, so
searched distances must match bitwise and ids up to ties (equal-distance
runs may order differently, ROADMAP note R1). The kernel engine runs the
scan's plain version here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import IVFSQParams as JIVFSQParams
from raft_tpu.spatial.ann import ivf_flat_build as j_ivf_flat_build
from raft_tpu.spatial.ann import ivf_sq_build as j_ivf_sq_build
from raft_tpu.spatial.ann import sq_kernel as jsq
from raft_tpu.spatial.ann.ivf_sq import IVFSQIndex as JIVFSQIndex
from raft_tpu.spatial.ann.ivf_sq import ivf_sq_search as j_search
from raft_tpu.spatial.ann.ivf_sq import ivf_sq_search_grouped as j_grouped
from raft_tpu.spatial.ann.ivf_sq import sq_decode as j_sq_decode
from raft_tpu.spatial.ann.ivf_sq import sq_encode as j_sq_encode
from raft_tpu.spatial.ann.serialize import save_index
from raft_tpu.testing.faults import corrupt_bytes
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.spatial.ann import (
    IVFSQParams,
    ivf_sq_build,
    ivf_sq_index_from_arrays,
    ivf_sq_search,
    ivf_sq_search_grouped,
    load_ivf_sq,
)
from raft_tpu_torch.spatial.ann import flat_kernel as tfk
from raft_tpu_torch.spatial.ann import ivf_sq as tivf_sq
from raft_tpu_torch.spatial.ann import scan_core as tsc
from raft_tpu_torch.spatial.ann import sq_kernel as tsq
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties

torch.set_num_threads(1)

K_NN = 5
CPU = torch.device("cpu")


# -- encode / decode ---------------------------------------------------------

def test_sq_encode_decode_bitwise(rng_np):
    """The affine encoder (round half to even, a true division, the clip)
    and decoder equal the JAX package's bit for bit, half-way points and
    out-of-range values included."""
    x = (rng_np.standard_normal((300, 12)) * 20).astype(np.float32)
    vmin = x.min(0) + 1.0          # rows below vmin and above vmax clip
    vscale = (np.maximum(x.max(0) - 1.0 - vmin, 1e-12) / 255.0).astype(
        np.float32)
    # exact half-way points: (x - vmin) / vscale = j + 0.5
    x[:8] = (vmin + (np.arange(8)[:, None] + 0.5) * vscale).astype(
        np.float32)
    want = np.asarray(j_sq_encode(jnp.asarray(x), vmin, vscale))
    got = tivf_sq.sq_encode(torch.as_tensor(x), torch.as_tensor(vmin),
                            torch.as_tensor(vscale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == -128 and got.max() == 127
    codes = want.astype(np.float32)
    np.testing.assert_array_equal(
        tivf_sq.sq_decode(torch.as_tensor(codes), torch.as_tensor(vmin),
                          torch.as_tensor(vscale)).numpy(),
        np.asarray(j_sq_decode(jnp.asarray(codes), jnp.asarray(vmin),
                               jnp.asarray(vscale))))


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (a power of two times 2^-7)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_dequant_tile_bitwise_on_dyadic_within_an_ulp_on_generic(rng_np):
    """_dequant_tile: bitwise on dyadic stats (every step exact), and
    within one bf16 ulp on generic stats (XLA may fuse the multiply-add
    that the port rounds twice, which can move the single bf16 rounding
    across a tie)."""
    codes = rng_np.integers(-128, 128, (3, 16, 40)).astype(np.int8)
    for dyadic in (True, False):
        if dyadic:
            vmin = rng_np.integers(-8, 8, 16).astype(np.float32)
            vscale = np.full(16, 0.5, np.float32)
        else:
            vmin = rng_np.standard_normal(16).astype(np.float32)
            vscale = (np.abs(rng_np.standard_normal(16)) / 255.0
                      + 1e-3).astype(np.float32)
        want = np.asarray(jsq._dequant_tile(
            jnp.asarray(codes), jnp.asarray(vmin).reshape(1, 16, 1),
            jnp.asarray(vscale).reshape(1, 16, 1))).astype(np.float32)
        got = tsq._dequant_tile(
            torch.as_tensor(codes), torch.as_tensor(vmin).reshape(1, 16, 1),
            torch.as_tensor(vscale).reshape(1, 16, 1))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        if dyadic:
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()


# -- the SQ scan: plain version against the JAX kernel -----------------------

def _sq_case(rng, lb, q, d, l_pad, dyadic=True):
    qrows = rng.integers(-64, 64, (lb, q, d)).astype(np.float32)
    codes_t = rng.integers(-128, 128, (lb, d, l_pad)).astype(np.int8)
    if dyadic:
        vmin = rng.integers(-8, 8, (d,)).astype(np.float32)
        vscale = np.full((d,), 0.5, np.float32)
    else:
        vmin = rng.standard_normal(d).astype(np.float32)
        vscale = (np.abs(rng.standard_normal(d)) / 255.0 + 1e-3).astype(
            np.float32)
    return qrows, codes_t, vmin, vscale


def _plain_sq(qrows, codes_t, bounds, vmin, vscale):
    return tsq.sq_scan_subchunk_min(
        torch.as_tensor(qrows).to(torch.bfloat16), torch.as_tensor(codes_t),
        torch.as_tensor(bounds), torch.as_tensor(vmin),
        torch.as_tensor(vscale)).numpy()


@pytest.mark.parametrize(
    "lb,q,d,l_pad,l_tile,dyadic",
    [
        (3, 32, 16, 256, 128, True),    # two slab tiles per list
        (2, 16, 24, 128, 128, False),   # generic affine stats
        (1, 48, 8, 512, 256, True),     # wider tiles
    ],
)
def test_plain_sq_scan_matches_jax_kernel_and_mirror(rng_np, lb, q, d, l_pad,
                                                     l_tile, dyadic):
    """Bitwise on dyadic inputs (every decoded value and every sum
    exact). On generic affine stats the decoded values may differ by one
    bf16 ulp (see the dequant test), so each distance is held within
    2 d max|y - q| ulp(y) + the f32 summation bound of its sums."""
    qrows, codes_t, vmin, vscale = _sq_case(rng_np, lb, q, d, l_pad,
                                            dyadic)
    bounds = np.asarray([[i, max(i, l_pad - 7 * i)] for i in range(lb)],
                        np.int32)
    args = (jnp.asarray(qrows), jnp.asarray(codes_t), jnp.asarray(bounds),
            jnp.asarray(vmin), jnp.asarray(vscale))
    ref_kernel = np.asarray(jsq.sq_scan_subchunk_min(
        *args, interpret=True, l_tile=l_tile))
    ref_mirror = np.asarray(jsq.sq_scan_subchunk_min_lax(*args))
    got = _plain_sq(qrows, codes_t, bounds, vmin, vscale)
    assert got.shape == (lb, q, l_pad // tsc.SUBCHUNK)
    if dyadic:
        np.testing.assert_array_equal(got, ref_kernel)
        np.testing.assert_array_equal(got, ref_mirror)
        return
    y = np.asarray(jsq._dequant_tile(
        jnp.asarray(codes_t), jnp.asarray(vmin).reshape(1, d, 1),
        jnp.asarray(vscale).reshape(1, d, 1))).astype(np.float32)
    qv = np.asarray(jnp.asarray(qrows, jnp.bfloat16)).astype(np.float32)
    dev = np.abs(qv).max() + np.abs(y).max()
    scale = (qv ** 2).sum(-1).max() + (y ** 2).sum(1).max()
    tol = 2 * d * dev * _bf16_ulp(np.abs(y).max()) + 4 * d * 2.0 ** -24 * (
        scale + 2 * np.sqrt(scale) * dev)
    for ref in (ref_kernel, ref_mirror):
        masked = ref >= tsc.BIG
        np.testing.assert_array_equal(got[masked], ref[masked])
        assert (np.abs(got - ref)[~masked] <= tol).all()


def test_plain_sq_scan_empty_full_ranges_and_checks(rng_np):
    qrows, codes_t, vmin, vscale = _sq_case(rng_np, 2, 16, 16, 256)
    bounds = np.asarray([[5, 5], [0, 256]], np.int32)
    got = _plain_sq(qrows, codes_t, bounds, vmin, vscale)
    assert (got[0] == tsq.BIG).all() and (got[1] < tsq.BIG).all()
    q = torch.zeros((1, 5, 16), dtype=torch.bfloat16)
    c = torch.zeros((1, 16, 136), dtype=torch.int8)
    b = torch.zeros((1, 2), dtype=torch.int32)
    v = torch.zeros(16)
    # any Q and any Lpad on the 8-row granule
    assert tuple(tsq.sq_scan_subchunk_min(q, c, b, v, v).shape) == (1, 5, 17)
    with pytest.raises(ValueError, match="int8"):
        tsq.sq_scan_subchunk_min(q, c.to(torch.uint8), b, v, v)
    with pytest.raises(ValueError, match="query dim"):
        tsq.sq_scan_subchunk_min(
            q, torch.zeros((1, 24, 136), dtype=torch.int8), b, v, v)
    with pytest.raises(ValueError, match="vscale"):
        tsq.sq_scan_subchunk_min(q, c, b, v, torch.zeros(15))
    assert tsq.LAUNCHES == 0


def test_window_plan_and_supported_match_jax():
    from raft_tpu.spatial.ann import scan_core as jsc

    for d in (1, 8, 96, 400, 960, 4096):
        for qcap in (1, 8, 24, 64, 512):
            for L in (1, 57, 300, 512, 3000):
                q_pad = jsc.pad_queries(qcap)
                cap = -(-L // 128) * 128
                assert tsq.plan_l_tile(
                    d, q_pad, l_tile=cap, profile=tsc.tile_profile(qcap)
                ) == jsq.plan_l_tile(d, q_pad, l_tile=cap,
                                     profile=jsc.tile_profile(qcap))
            # the port adds its list kernel's shared-memory model (query
            # tile sized to qcap) to the JAX rule
            assert tsq.sq_scan_supported(d, qcap) == (
                jsq.sq_scan_supported(d, qcap)
                and tfk._sq_lists_smem_bytes(d, tfk._q_tile(qcap)) <= 232_448)
    assert tsq.sq_scan_supported(96, 24) and not tsq.sq_scan_supported(0, 8)
    assert not tsq.sq_scan_supported(1000, 8)


# -- the index: carried across from the JAX package --------------------------

def _int_dataset(seed, n=3000, d=16, nq=64):
    """tests/test_sq_kernel.py's fixture: integer rows in [-127, 127]."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-60, 60, (8, d))
    x = (centers[rng.integers(0, 8, n)]
         + rng.integers(-6, 7, (n, d))).clip(-127, 127).astype(np.float32)
    q = (x[rng.integers(0, n, nq)]
         + rng.integers(-2, 3, (nq, d))).astype(np.float32)
    return x, q


def _int_sq_index(x_int, n_lists=48):
    """The dyadic JAX SQ index: codes ARE the integer rows (vmin = -128,
    vscale = 1 -> y = code)."""
    d = x_int.shape[1]
    base = j_ivf_flat_build(x_int, JIVFFlatParams(
        n_lists=n_lists, kmeans_n_iters=4, kmeans_init="random",
    ), metric="sqeuclidean")
    return JIVFSQIndex(
        centroids=base.centroids,
        codes_sorted=base.data_sorted.astype(jnp.int8),
        vmin=jnp.full((d,), -128.0, jnp.float32),
        vscale=jnp.ones((d,), jnp.float32),
        storage=base.storage,
    )


def _leaves(jidx):
    s = jidx.storage
    return {
        "centroids": np.asarray(jidx.centroids),
        "codes_sorted": np.asarray(jidx.codes_sorted),
        "vmin": np.asarray(jidx.vmin), "vscale": np.asarray(jidx.vscale),
        "storage.sorted_ids": np.asarray(s.sorted_ids),
        "storage.list_offsets": np.asarray(s.list_offsets),
        "storage.list_index": np.asarray(s.list_index),
        "storage.list_sizes": np.asarray(s.list_sizes),
        "storage.n": s.n, "storage.max_list": s.max_list,
    }


@pytest.fixture(scope="module")
def dataset():
    return _int_dataset(7)


@pytest.fixture(scope="module")
def jax_index(dataset):
    return _int_sq_index(dataset[0])


@pytest.fixture(scope="module")
def index(jax_index, tmp_path_factory):
    path = tmp_path_factory.mktemp("sq") / "sq.npz"
    save_index(jax_index, path)
    return load_ivf_sq(path, device="cpu")


def test_load_and_arrays_give_the_jax_index(jax_index, index):
    a = ivf_sq_index_from_arrays(_leaves(jax_index), device="cpu")
    for t in (a, index):
        assert t.device == CPU and t.codes_sorted.dtype == torch.int8
        for f in ("centroids", "codes_sorted", "vmin", "vscale"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(jax_index, f)))
        for f in ("sorted_ids", "list_offsets", "list_index", "list_sizes"):
            np.testing.assert_array_equal(
                getattr(t.storage, f).numpy(),
                np.asarray(getattr(jax_index.storage, f)))
        assert (t.storage.n, t.storage.max_list) == (
            jax_index.storage.n, jax_index.storage.max_list)


def _saturating_ratio(index, p, k, d=16):
    l_tile = jsq.plan_l_tile(d, 64)
    l_pad = -(-index.storage.max_list // l_tile) * l_tile
    return float(p * l_pad // 8) / k + 1.0


@pytest.mark.parametrize("stream", [None, True])
@pytest.mark.parametrize("kernel,pool", [(False, "default"),
                                         (True, "saturated"),
                                         (True, "default")])
def test_grouped_search_parity(dataset, jax_index, index, kernel, pool,
                               stream):
    """Both engines, streamed and not: distances bitwise, ids up to ties,
    against the JAX engine of the same kind (the kernel engine with a
    pool covering every probed row and with the default ratio)."""
    _, q = dataset
    p = 4
    ratio = (_saturating_ratio(jax_index, p, K_NN) if pool == "saturated"
             else 4.0)
    kw = dict(n_probes=p, qcap=64, stream_partials=stream,
              rerank_ratio=ratio)
    d0, i0 = j_grouped(jax_index, q, K_NN, use_pallas=kernel, **kw)
    d1, i1 = ivf_sq_search_grouped(index, q, K_NN, use_kernel=kernel, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_engines_and_per_query_search_agree(dataset, jax_index, index):
    """At full probe width the per-query search, both grouped engines of
    the port and the JAX per-query search return the same distances."""
    _, q = dataset
    nl = index.centroids.shape[0]
    d0, i0 = j_search(jax_index, q, K_NN, n_probes=nl)
    d1, i1 = ivf_sq_search(index, q, K_NN, n_probes=nl)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())
    kw = dict(n_probes=nl, qcap=q.shape[0],
              rerank_ratio=_saturating_ratio(jax_index, nl, K_NN))
    for kernel in (False, True):
        d2, i2 = ivf_sq_search_grouped(index, q, K_NN, use_kernel=kernel,
                                       **kw)
        np.testing.assert_array_equal(d2.numpy(), np.asarray(d0))
        _assert_ids_equal_up_to_ties(d0, i0, i2.numpy())


def test_tiny_index_pads_codes_with_zeros(dataset):
    """An index whose n + 1 rows are fewer than one padded window: the
    kernel engine appends zero code rows (they decode to 128·vscale +
    vmin, not 0, and lie outside every list's [lo, hi)); results match
    the JAX engine."""
    x, q = dataset
    jidx = _int_sq_index(x[:90], n_lists=4)
    tidx = ivf_sq_index_from_arrays(_leaves(jidx), device="cpu")
    assert tidx.codes_sorted.shape[0] < 128
    kw = dict(n_probes=2, qcap=64, rerank_ratio=40.0)
    d0, i0 = j_grouped(jidx, q, K_NN, use_pallas=True, **kw)
    d1, i1 = ivf_sq_search_grouped(tidx, q, K_NN, use_kernel=True, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())
    pad = tidx.code_rows(128)
    assert pad.dtype == torch.int8 and not pad[tidx.codes_sorted.shape[0]:].any()


def test_build_from_injected_centroids_matches_jax(monkeypatch):
    """ivf_sq_build with both packages' k-means started from the same
    centroids: the affine stats and codes bitwise, the list layout
    equal (integer rows: every k-means distance is exact or far from a
    tie)."""
    from raft_tpu.cluster.kmeans import kmeans_fit as jfit
    from raft_tpu_torch.cluster.kmeans import kmeans_fit as tfit

    x, _ = _int_dataset(3, n=1200, d=8)
    x = x + np.float32(0.25)       # generic affine stats
    c0 = x[:: 1200 // 16][:16].copy()

    def j_fit(xx, params=None, **kw):
        return jfit(xx, params, centroids=jnp.asarray(c0))

    def t_fit(xx, params=None, **kw):
        return tfit(xx, params, centroids=torch.as_tensor(c0))

    monkeypatch.setattr("raft_tpu.spatial.ann.ivf_sq.kmeans_fit", j_fit)
    monkeypatch.setattr("raft_tpu_torch.spatial.ann.ivf_sq.kmeans_fit", t_fit)
    params = dict(n_lists=16, kmeans_n_iters=3, max_list_cap=100)
    jidx = j_ivf_sq_build(x, JIVFSQParams(**params))
    tidx = ivf_sq_build(x, IVFSQParams(**params), device="cpu")
    for f in ("vmin", "vscale"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy(),
                                      np.asarray(getattr(jidx, f)))
    np.testing.assert_allclose(tidx.centroids.numpy(),
                               np.asarray(jidx.centroids), rtol=1e-5,
                               atol=1e-5)
    for f in ("sorted_ids", "list_offsets", "list_sizes"):
        np.testing.assert_array_equal(getattr(tidx.storage, f).numpy(),
                                      np.asarray(getattr(jidx.storage, f)))
    np.testing.assert_array_equal(tidx.codes_sorted.numpy(),
                                  np.asarray(jidx.codes_sorted))


def test_port_built_index_serves_with_both_engines():
    """The port's own build (k-means++ from a torch.Generator), warmed
    and searched: both engines reach the JAX-built index's recall@10
    within 0.02 on the same clustered data."""
    from tests.oracles import np_knn_ids

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((24, 16)).astype(np.float32) * 8.0
    x = (centers[rng.integers(0, 24, 3000)]
         + rng.standard_normal((3000, 16)).astype(np.float32))
    q = x[rng.integers(0, 3000, 128)] + 0.5 * rng.standard_normal(
        (128, 16)).astype(np.float32)
    true = np_knn_ids(x, q, 10)
    params = dict(n_lists=48, kmeans_n_iters=6)
    jidx = j_ivf_sq_build(x, JIVFSQParams(**params))
    tidx = ivf_sq_build(x, IVFSQParams(**params), device="cpu")
    assert tidx.codes_sorted.shape == (3001, 16)
    assert tidx.warmup(128, k=10, n_probes=4) == 24

    def rec(ids):
        return sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(np.asarray(ids), true)) / true.size

    r_jax = rec(j_grouped(jidx, q, 10, n_probes=4)[1])
    for kernel in (False, True):
        _, ids = ivf_sq_search_grouped(tidx, q, 10, n_probes=4,
                                       use_kernel=kernel)
        assert rec(ids.numpy()) >= r_jax - 0.02, kernel


def test_engine_resolver_raises_and_counts(dataset, index):
    """The entries' own raises; the engine rule's answers, messages and
    counts are ``tests/test_torch_grouped.py``'s."""
    _, q = dataset
    with pytest.raises(ValueError, match="per-query"):
        ivf_sq_search_grouped(index, q, index.storage.max_list + 1,
                              n_probes=4, use_kernel=True)
    with pytest.raises(ValueError, match="grouped"):
        ivf_sq_search(index, q, K_NN, use_kernel=True)


def test_corrupted_archive_and_wrong_kind_raise(tmp_path, jax_index):
    path = tmp_path / "sq.npz"
    save_index(jax_index, path)
    field = corrupt_bytes(path, field="codes_sorted", n_bytes=4)
    with pytest.raises(terrors.CorruptIndexError, match="CRC32") as e:
        load_ivf_sq(path, device="cpu")
    assert e.value.field == field == "codes_sorted"
    from raft_tpu_torch.spatial.ann import load_ivf_flat

    save_index(jax_index, path)
    with pytest.raises(ValueError, match="ivf_sq"):
        load_ivf_flat(path, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, jax_index):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_sq_build(np.zeros((16, 4), np.float32), IVFSQParams(n_lists=2))
    path = tmp_path / "sq.npz"
    save_index(jax_index, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_ivf_sq(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_sq_index_from_arrays(_leaves(jax_index))


def test_replaced_index_gets_a_fresh_view(index):
    """A replaced index's kernel slab is its own codes, not a cached
    slab of the index it came from."""
    other = dataclasses.replace(index, codes_sorted=index.codes_sorted + 1)
    n = index.codes_sorted.shape[0]
    assert index.code_rows(n) is index.codes_sorted
    assert other._code_rows == {}
    assert other.code_rows(n) is other.codes_sorted
