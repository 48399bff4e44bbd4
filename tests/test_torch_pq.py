"""PyTorch port of IVF-PQ (raft_tpu_torch spatial/ann/ivf_pq + pq_kernel,
and the k-means pieces it needs) against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. JAX PQ indexes are
carried across through their npz checkpoints (``save_index`` ->
``load_ivf_pq``), because torch cannot replay JAX's random streams. The
ADC tables are products of non-integer codebooks, and the two packages'
f32 contractions need not agree bitwise, so ADC candidate ranking can
differ at the pool boundary: search results are held bitwise (distances;
ids up to ties, ROADMAP note R1) where the refine pool saturates and both
packages rescore every probed row in exact f32, on integer-valued raw
rows; elsewhere the port's recall is held within 0.01 of JAX's. The
kernel engine runs the ADC scan's plain version here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.cluster.kmeans import KMeansParams as JKMeansParams
from raft_tpu.cluster.kmeans import kmeans_fit as j_kmeans_fit
from raft_tpu.cluster.kmeans import kmeans_predict as j_kmeans_predict
from raft_tpu.spatial.ann import IVFPQParams as JIVFPQParams
from raft_tpu.spatial.ann import ivf_pq_build as j_ivf_pq_build
from raft_tpu.spatial.ann import pq_kernel as jpq
from raft_tpu.spatial.ann.ivf_pq import _encode_rows as j_encode_rows
from raft_tpu.spatial.ann.ivf_pq import ivf_pq_search as j_search
from raft_tpu.spatial.ann.ivf_pq import ivf_pq_search_grouped as j_grouped
from raft_tpu.spatial.ann.serialize import save_index
from raft_tpu.testing.faults import corrupt_bytes
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.cluster.kmeans import (
    KMeansParams,
    kmeans_fit,
    kmeans_fit_batched,
    kmeans_predict,
)
from raft_tpu_torch.spatial.ann import (
    IVFPQParams,
    ivf_pq_build,
    ivf_pq_index_from_arrays,
    ivf_pq_search,
    ivf_pq_search_grouped,
    load_ivf_pq,
)
from raft_tpu_torch.spatial.ann import pq_kernel as tpq
from raft_tpu_torch.spatial.ann.ivf_pq import _encode_rows
from tests.oracles import np_knn_ids
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties

torch.set_num_threads(1)

K_NN = 5
CPU = torch.device("cpu")


# -- the ADC scan: plain version against the JAX kernel ----------------------

def _adc_case(rng, lb, q, m, k_codes, l_pad, integer):
    if integer:
        # small integers: exact in bf16, every sum of M of them exact
        luts = rng.integers(-64, 64, (lb, q, m * k_codes)).astype(np.float32)
    else:
        luts = rng.standard_normal((lb, q, m * k_codes)).astype(np.float32)
    codes = rng.integers(0, k_codes, (lb, m, l_pad)).astype(np.uint8)
    return np.array(jnp.asarray(luts, jnp.bfloat16).astype(jnp.float32)), \
        codes


def _plain_adc(luts, codes, bounds):
    return tpq.pq_adc_subchunk_min(
        torch.as_tensor(luts).to(torch.bfloat16), torch.as_tensor(codes),
        torch.as_tensor(bounds)).numpy()


def _adc_tol(luts, codes, m):
    """Per sub-chunk bound on |port - JAX| for M-term f32 sums in two
    orders: M 2^-24 sum_m |lut[m, code]|, maxed over the sub-chunk."""
    lb, q, mk = luts.shape
    k_codes = mk // m
    lut = np.abs(luts).reshape(lb, q, m, k_codes)
    tot = np.zeros((lb, q, codes.shape[2]), np.float64)
    for mm in range(m):
        tot += np.take_along_axis(
            lut[:, :, mm, :], codes[:, None, mm, :].astype(np.int64)
            .repeat(q, 1), 2)
    return (m * 2.0 ** -24 * tot).reshape(lb, q, -1, 8).max(-1)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize(
    "lb,q,m,k_codes,l_pad,l_tile",
    [
        (3, 32, 4, 16, 256, 128),    # two code tiles per list
        (2, 16, 3, 256, 128, 128),   # full 8-bit codebook width
        (1, 48, 5, 32, 512, 256),    # ragged M, wider tiles
    ],
)
def test_plain_adc_scan_matches_jax_kernel(rng_np, lb, q, m, k_codes, l_pad,
                                           l_tile, integer):
    """Bitwise on integer-valued LUTs (every sum exact); on Gaussian
    LUTs within M 2^-24 sum|lut| per sub-chunk (the JAX kernel sums the
    M selected entries in its contraction's order)."""
    luts, codes = _adc_case(rng_np, lb, q, m, k_codes, l_pad, integer)
    bounds = np.asarray([[i, max(i, l_pad - 7 * i)] for i in range(lb)],
                        np.int32)
    args = (jnp.asarray(luts, jnp.bfloat16), jnp.asarray(codes),
            jnp.asarray(bounds))
    ref_kernel = np.asarray(jpq.pq_adc_subchunk_min(
        *args, interpret=True, l_tile=l_tile))
    ref_mirror = np.asarray(jpq.pq_adc_subchunk_min_lax(*args))
    got = _plain_adc(luts, codes, bounds)
    assert got.shape == (lb, q, l_pad // 8)
    for ref in (ref_kernel, ref_mirror):
        if integer:
            np.testing.assert_array_equal(got, ref)
        else:
            masked = ref >= tpq.BIG
            np.testing.assert_array_equal(got[masked], ref[masked])
            assert (np.abs(got - ref) <= _adc_tol(luts, codes, m)).all()
    # a gathered row-major (LB, Lpad, M) slab passed as a transposed view
    rows = torch.as_tensor(np.ascontiguousarray(codes.transpose(0, 2, 1)))
    view = tpq.pq_adc_subchunk_min(torch.as_tensor(luts).to(torch.bfloat16),
                                   rows.transpose(1, 2),
                                   torch.as_tensor(bounds))
    np.testing.assert_array_equal(view.numpy(), got)


def test_plain_adc_empty_and_full_ranges_and_checks(rng_np):
    luts, codes = _adc_case(rng_np, 2, 16, 4, 16, 256, False)
    got = _plain_adc(luts, codes, np.asarray([[5, 5], [0, 256]], np.int32))
    assert (got[0] == tpq.BIG).all() and (got[1] < tpq.BIG).all()
    lt = torch.zeros((1, 5, 64), dtype=torch.bfloat16)
    c = torch.zeros((1, 4, 136), dtype=torch.uint8)
    b = torch.zeros((1, 2), dtype=torch.int32)
    assert tuple(tpq.pq_adc_subchunk_min(lt, c, b).shape) == (1, 5, 17)
    with pytest.raises(ValueError, match="uint8"):
        tpq.pq_adc_subchunk_min(lt, c.to(torch.int8), b)
    with pytest.raises(ValueError, match="M\\*K"):
        tpq.pq_adc_subchunk_min(lt, torch.zeros((1, 5, 136),
                                                dtype=torch.uint8), b)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpq.pq_adc_subchunk_min(lt, c[:, :, :130], b)
    assert tpq.LAUNCHES == 0


def test_plan_supported_and_query_tiles():
    from raft_tpu.spatial.ann import scan_core as jsc

    for mk in (64, 6144, 96 * 256):
        for qcap in (1, 8, 24, 512, 1024):
            q_pad = jsc.pad_queries(qcap)
            for L in (57, 512, 3000):
                cap = -(-L // 128) * 128
                lt = jpq.plan_l_tile(mk, q_pad, l_tile=cap,
                                     profile=jsc.tile_profile(qcap))
                assert tpq.plan_l_tile(mk, q_pad, l_tile=cap,
                                       profile=jsc.tile_profile(qcap)) == lt
                # the JAX rule's window where it plans, one lane where not
                assert tpq.window_l_pad(mk, qcap, L) == \
                    -(-L // (lt or 128)) * (lt or 128)
    # the kernel's own rule: uint8 codes and one LUT row in shared memory,
    # whatever the qcap; it holds wherever the JAX rule does
    for m, bits in ((24, 8), (4, 4), (96, 8), (4096, 8)):
        assert tpq.pq_adc_supported(m, bits) == (
            tpq._slots(1, m, 1 << bits) >= 1)
        for qcap in (8, 24, 512):
            assert tpq.pq_adc_supported(m, bits) or not \
                jpq.pq_adc_supported(m, bits, qcap)
    assert not tpq.pq_adc_supported(24, 9)
    assert not tpq.pq_adc_supported(4096, 8)
    # the slice's configuration at the auto qcap of a clustered 4,096
    # batch: the JAX window rule has no plan, the kernel serves it
    assert not jpq.pq_adc_supported(24, 8, 1024)
    assert tpq.pq_adc_supported(24, 8)
    assert tpq.window_l_pad(24 * 256, 1024, 512) == 512
    # the slice's configuration: 8 slots' LUT rows of 12 KB fit beside a
    # code tile; fewer slots where Q is smaller or the rows are wider
    assert tpq._slots(24, 24, 256) == 8
    assert tpq._slots(8, 24, 256) == 8
    assert tpq._slots(3, 24, 256) == 4
    assert tpq._slots(1, 24, 256) == 1
    assert tpq._slots(13, 96, 256) == 4
    assert tpq._smem_bytes(8, 24, 256) <= 232_448
    # staged LUT rows are 16-byte rows whose word stride puts the S slots
    # of one code on S distinct banks (32/S apart)
    for mk in (6144, 21, 160, 24576):
        for s in (1, 2, 4, 8):
            w = tpq._lut_stride_words(mk, s)
            assert w % 4 == 0 and 2 * w >= mk
            assert len({(i * w) % 32 for i in range(s)}) == s


# -- k-means pieces ------------------------------------------------------------

def test_kmeans_predict_matches_jax_with_lowest_index_ties(rng_np):
    """Integer rows and centroids: every distance exact, so labels equal
    JAX's bit for bit, ties (duplicated centroids) to the lowest index."""
    x = rng_np.integers(-20, 20, (500, 6)).astype(np.float32)
    c = rng_np.integers(-20, 20, (17, 6)).astype(np.float32)
    c[9] = c[3]                                  # a tie on every row of 3
    want = np.asarray(j_kmeans_predict(jnp.asarray(x), jnp.asarray(c)))
    got = kmeans_predict(torch.as_tensor(x), torch.as_tensor(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy() == 9).any()


def _blobs(seed, n=1200, d=8, k=6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 8.0
    return (centers[rng.integers(0, k, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def test_kmeans_fit_batched_is_per_problem_kmeans_fit():
    """B problems from given initial centroids: each equals kmeans_fit of
    that problem bitwise, and JAX's kmeans_fit(centroids=) within the f32
    tolerance of tests/test_torch_ivf_flat.py (centroids within 1e-5,
    labels equal where the two nearest centroids are 1e-4 apart)."""
    xs = np.stack([_blobs(s, n=600, d=4) for s in (1, 2, 3)])
    c0 = xs[:, :8].copy()
    params = KMeansParams(n_clusters=8, max_iter=5)
    out = kmeans_fit_batched(torch.as_tensor(xs), params,
                             centroids=torch.as_tensor(c0))
    assert tuple(out.centroids.shape) == (3, 8, 4)
    assert tuple(out.labels.shape) == (3, 600)
    for b in range(3):
        one = kmeans_fit(torch.as_tensor(xs[b]), params,
                         centroids=torch.as_tensor(c0[b]))
        assert torch.equal(out.centroids[b], one.centroids)
        assert torch.equal(out.labels[b], one.labels)
        assert int(out.n_iter[b]) == one.n_iter
        want = j_kmeans_fit(jnp.asarray(xs[b]), JKMeansParams(
            n_clusters=8, max_iter=5), centroids=jnp.asarray(c0[b]))
        wc = np.asarray(want.centroids)
        np.testing.assert_allclose(one.centroids.numpy(), wc, rtol=1e-5,
                                   atol=1e-5)
        d2 = ((xs[b][:, None, :] - wc[None]) ** 2).sum(-1)
        two = np.sort(d2, axis=1)[:, :2]
        clear = (two[:, 1] - two[:, 0]) > 1e-4 * two[:, 1]
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(one.labels.numpy()[clear],
                                      np.asarray(want.labels)[clear])
    # seeded: problem b's draw comes after problem b-1's, deterministic
    a = kmeans_fit_batched(torch.as_tensor(xs), n_clusters=8, max_iter=2,
                           init="random", seed=4)
    b = kmeans_fit_batched(torch.as_tensor(xs), n_clusters=8, max_iter=2,
                           init="random", seed=4)
    assert torch.equal(a.centroids, b.centroids)


def test_encode_rows_on_carried_quantizers_matches_jax(rng_np):
    """_encode_rows against the JAX package's on integer-valued
    quantizers and rows (every distance exact): labels and codes equal,
    ties to the lowest index."""
    x = rng_np.integers(-30, 30, (700, 8)).astype(np.float32)
    cents = rng_np.integers(-30, 30, (12, 8)).astype(np.float32)
    cents[7] = cents[2]
    books = rng_np.integers(-10, 10, (4, 16, 2)).astype(np.float32)
    books[:, 5] = books[:, 1]
    wl, wc = j_encode_rows(jnp.asarray(x), jnp.asarray(cents),
                           jnp.asarray(books), 4, 2)
    gl, gc = _encode_rows(torch.as_tensor(x), torch.as_tensor(cents),
                          torch.as_tensor(books), 4, 2)
    assert gl.dtype == torch.int32 and gc.dtype == torch.uint8
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert not (gc.numpy() == 5).any() and not (gl.numpy() == 7).any()


# -- the index: carried across from the JAX package --------------------------

def _int_blobs(seed, n=3000, d=16, nq=64):
    """Clustered integer rows (8 blobs) and integer-jittered queries:
    exact f32 rescoring in any order; with 48 lists some stay empty."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-60, 60, (8, d))
    x = (centers[rng.integers(0, 8, n)]
         + rng.integers(-6, 7, (n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, nq)]
         + rng.integers(-2, 3, (nq, d))).astype(np.float32)
    return x, q


def _leaves(jidx):
    s = jidx.storage
    out = {
        "centroids": np.asarray(jidx.centroids),
        "codebooks": np.asarray(jidx.codebooks),
        "codes_sorted": np.asarray(jidx.codes_sorted),
        "vectors_sorted": (None if jidx.vectors_sorted is None
                           else np.asarray(jidx.vectors_sorted)),
        "storage.sorted_ids": np.asarray(s.sorted_ids),
        "storage.list_offsets": np.asarray(s.list_offsets),
        "storage.list_index": np.asarray(s.list_index),
        "storage.list_sizes": np.asarray(s.list_sizes),
        "storage.n": s.n, "storage.max_list": s.max_list,
    }
    return out


@pytest.fixture(scope="module")
def dataset():
    return _int_blobs(7)


@pytest.fixture(scope="module")
def jax_index(dataset):
    return j_ivf_pq_build(dataset[0], JIVFPQParams(
        n_lists=48, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
        kmeans_init="random",
    ))


@pytest.fixture(scope="module")
def index(jax_index, tmp_path_factory):
    path = tmp_path_factory.mktemp("pq") / "pq.npz"
    save_index(jax_index, path)
    return load_ivf_pq(path, device="cpu")


def test_load_and_arrays_give_the_jax_index(jax_index, index):
    a = ivf_pq_index_from_arrays(_leaves(jax_index), 4, 4, device="cpu")
    for t in (a, index):
        assert (t.pq_dim, t.pq_bits, t.device) == (4, 4, CPU)
        for f in ("centroids", "codebooks", "codes_sorted",
                  "vectors_sorted"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(jax_index, f)))
        for f in ("sorted_ids", "list_offsets", "list_index", "list_sizes"):
            np.testing.assert_array_equal(
                getattr(t.storage, f).numpy(),
                np.asarray(getattr(jax_index.storage, f)))


def _saturating(storage, p, k):
    return float(p * storage.max_list) / k + 1.0


@pytest.mark.parametrize("stream", [None, True])
@pytest.mark.parametrize("exact_selection", [True, False])
@pytest.mark.parametrize("kernel", [False, True])
def test_saturated_pool_search_parity(dataset, jax_index, index, kernel,
                                      exact_selection, stream):
    """Refine pools covering every probed row: each engine of the port
    and of the JAX package rescores the whole probed pool in exact f32,
    so distances match bitwise and ids up to ties."""
    _, q = dataset
    p = 4
    kw = dict(n_probes=p, refine_ratio=_saturating(index.storage, p, K_NN),
              qcap=64, exact_selection=exact_selection,
              stream_partials=stream)
    d0, i0 = j_grouped(jax_index, q, K_NN, use_pallas=kernel, **kw)
    d1, i1 = ivf_pq_search_grouped(index, q, K_NN, use_kernel=kernel, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def _with_emptied_lists(x, base, emptied):
    """``base`` with the rows of ``emptied`` lists moved into list 0: the
    lists keep their centroids (probes still pick them) but hold no rows
    (the fixture of tests/test_pq_kernel.py)."""
    from raft_tpu.spatial.ann.common import build_list_storage

    n = base.storage.n
    n_lists = base.centroids.shape[0]
    sid = np.asarray(base.storage.sorted_ids)
    labels = np.empty(n, np.int64)
    labels[sid] = np.repeat(np.arange(n_lists),
                            np.asarray(base.storage.list_sizes))
    labels = np.where(np.isin(labels, list(emptied)), 0, labels)
    storage = build_list_storage(labels, n_lists)
    codes = np.empty((n, base.pq_dim), np.uint8)
    codes[sid] = np.asarray(base.codes_sorted)[:-1]
    sid2 = np.asarray(storage.sorted_ids)
    return dataclasses.replace(
        base, storage=storage,
        codes_sorted=jnp.concatenate([jnp.asarray(codes[sid2]),
                                      jnp.zeros((1, base.pq_dim), jnp.uint8)]),
        vectors_sorted=jnp.concatenate([jnp.asarray(x[sid2]),
                                        jnp.zeros((1, x.shape[1]))]),
    )


@pytest.mark.parametrize("kernel", [False, True])
def test_emptied_lists_saturated_parity(dataset, jax_index, kernel):
    """Probes that hit empty lists and sub-chunk windows that overhang a
    list's tail into its neighbour's rows: saturated-pool results equal
    JAX's, and every returned id lies in a probed list."""
    x, q = dataset
    jidx = _with_emptied_lists(x, jax_index, {1, 5, 9, 17})
    tidx = ivf_pq_index_from_arrays(_leaves(jidx), 4, 4, device="cpu")
    assert (tidx.storage.list_sizes == 0).any()
    p = 16
    kw = dict(n_probes=p, refine_ratio=_saturating(tidx.storage, p, K_NN),
              qcap=64, exact_selection=True)
    d0, i0 = j_grouped(jidx, q, K_NN, use_pallas=kernel, **kw)
    d1, i1 = ivf_pq_search_grouped(tidx, q, K_NN, use_kernel=kernel, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_kernel_engine_past_the_window_plan(dataset, jax_index, index,
                                           monkeypatch):
    """A qcap at which the JAX window rule has no plan (its budget cut
    here so that qcap=64 does not fit): the kernel engine still runs,
    on a one-lane window, and a saturated pool gives the JAX kernel
    engine's results (planned at the full budget)."""
    from raft_tpu_torch.spatial.ann import scan_core as tsc

    _, q = dataset
    p = 4
    mk = index.pq_dim * (1 << index.pq_bits)
    monkeypatch.setattr(tsc, "WINDOW_BUDGET",
                        tpq._step_bytes(mk, tsc.pad_queries(64), 128) - 1)
    assert tpq.plan_l_tile(mk, tsc.pad_queries(64)) is None
    kw = dict(n_probes=p, refine_ratio=_saturating(index.storage, p, K_NN),
              qcap=64, exact_selection=True)
    d0, i0 = j_grouped(jax_index, q, K_NN, use_pallas=True, **kw)
    d1, i1 = ivf_pq_search_grouped(index, q, K_NN, use_kernel=True, **kw)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_per_query_search_parity(dataset, jax_index, index):
    """The per-query ADC search with a saturated refine pool."""
    _, q = dataset
    p = 4
    rr = _saturating(index.storage, p, K_NN)
    d0, i0 = j_search(jax_index, q, K_NN, n_probes=p, refine_ratio=rr)
    d1, i1 = ivf_pq_search(index, q, K_NN, n_probes=p, refine_ratio=rr,
                           block_q=16)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


@pytest.fixture(scope="module")
def blob_case():
    """Generic-float clustered data with an index that drops candidates
    at a modest refine ratio."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((20, 16)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 20, 3000)]
         + rng.standard_normal((3000, 16)).astype(np.float32))
    q = x[rng.integers(0, 3000, 200)] + 0.3 * rng.standard_normal(
        (200, 16)).astype(np.float32)
    jidx = j_ivf_pq_build(x, JIVFPQParams(
        n_lists=32, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
        kmeans_init="random"))
    return x, q, jidx, ivf_pq_index_from_arrays(_leaves(jidx), 4, 4,
                                                device="cpu")


def _recall(ids, true):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(np.asarray(ids), true)) / true.size


@pytest.mark.parametrize("kernel", [False, True])
def test_unsaturated_recall_within_jax(blob_case, kernel):
    """refine_ratio 2: the LUTs of the two packages may rank the pool
    boundary differently, so recall@10 is held within 0.01 of JAX's
    (same engine), and the unrefined search's recall too."""
    x, q, jidx, tidx = blob_case
    true = np_knn_ids(x, q, 10)
    for rr in (2.0, 1.0):
        if kernel and rr == 1.0:
            continue
        kw = dict(n_probes=6, refine_ratio=rr, qcap=64)
        r0 = _recall(j_grouped(jidx, q, 10, use_pallas=kernel, **kw)[1],
                     true)
        r1 = _recall(ivf_pq_search_grouped(tidx, q, 10, use_kernel=kernel,
                                           **kw)[1].numpy(), true)
        assert r1 >= r0 - 0.01, (rr, r0, r1)


def test_large_k_exceeding_subchunk_pool(dataset, jax_index, index):
    """k > p * (l_pad / 8) while k <= p * max_list: the kernel engine
    clamps its pool to every sub-chunk, as the JAX engine does."""
    _, q = dataset
    L = index.storage.max_list
    p = 2
    l_tile = tpq.plan_l_tile(4 * 16, 64)
    l_pad = -(-L // l_tile) * l_tile
    k = min(p * L, p * l_pad // 8 + 8)
    assert k > p * l_pad // 8
    rr = float(p * L) / k + 1.0
    for kernel in (False, True):
        kw = dict(n_probes=p, refine_ratio=rr, qcap=64,
                  exact_selection=True)
        d0, i0 = j_grouped(jax_index, q, k, use_pallas=kernel, **kw)
        d1, i1 = ivf_pq_search_grouped(index, q, k, use_kernel=kernel, **kw)
        assert d1.shape == (q.shape[0], k)
        np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
        _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


def test_codes_only_archive_with_refine_dataset(dataset, tmp_path):
    """A store_raw=False index has no vectors_sorted: the archive loads
    without it, and searches refine from the caller's dataset."""
    x, q = dataset
    jidx = j_ivf_pq_build(x, JIVFPQParams(
        n_lists=48, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
        kmeans_init="random", store_raw=False))
    path = tmp_path / "pq.npz"
    save_index(jidx, path)
    tidx = load_ivf_pq(path, device="cpu")
    assert tidx.vectors_sorted is None
    p = 4
    kw = dict(n_probes=p, refine_ratio=_saturating(tidx.storage, p, K_NN),
              qcap=64)
    for kernel in (False, True):
        d0, i0 = j_grouped(jidx, q, K_NN, use_pallas=kernel,
                           refine_dataset=jnp.asarray(x), **kw)
        d1, i1 = ivf_pq_search_grouped(tidx, q, K_NN, use_kernel=kernel,
                                       refine_dataset=x, **kw)
        np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
        _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())
    with pytest.raises(ValueError, match="refine"):
        ivf_pq_search_grouped(tidx, q, K_NN, n_probes=p, use_kernel=True,
                              refine_ratio=4.0)


def test_tiny_dataset_build(dataset):
    """n < 2^bits: per-subspace codebooks padded with inf rows. The
    port's build has the JAX build's structure, its archive loads, and
    a JAX tiny index searches identically in the port (saturated pool)."""
    x, q = dataset
    x = x[:40]
    params = dict(n_lists=4, pq_dim=4, pq_bits=6, kmeans_n_iters=3,
                  pq_kmeans_n_iters=3, kmeans_init="random")
    tidx = ivf_pq_build(x, IVFPQParams(**params), device="cpu")
    jidx = j_ivf_pq_build(x, JIVFPQParams(**params))
    for idx in (tidx, jidx):
        books = np.asarray(idx.codebooks)
        assert books.shape == (4, 64, 4)
        assert np.isinf(books[:, 40:]).all()
        assert np.isfinite(books[:, :40]).all()
        assert (np.asarray(idx.codes_sorted)[:-1] < 40).all()
    carried = ivf_pq_index_from_arrays(_leaves(jidx), 4, 6, device="cpu")
    assert np.isinf(carried.codebooks.numpy()).any()
    kw = dict(n_probes=4, refine_ratio=_saturating(carried.storage, 4,
                                                   K_NN), qcap=64)
    for kernel in (False, True):
        d0, i0 = j_grouped(jidx, q, K_NN, use_pallas=kernel, **kw)
        d1, i1 = ivf_pq_search_grouped(carried, q, K_NN, use_kernel=kernel,
                                       **kw)
        np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
        _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())
    d2, _ = ivf_pq_search_grouped(tidx, q, K_NN, **kw)
    assert torch.isfinite(d2).all()


def test_port_built_index_recall(blob_case):
    """The port's own build (one-shot path, batched codebooks, encode),
    warmed and searched: over three seeds, each engine's mean recall@10
    is within 0.02 of the JAX-built indexes' (the two packages draw
    different initial centroids, so one seed's recall varies by a few
    hundredths either way)."""
    x, q, _, _ = blob_case
    true = np_knn_ids(x, q, 10)
    r_jax, r_port = [], {False: [], True: []}
    for seed in range(3):
        params = dict(n_lists=32, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
                      kmeans_init="random", seed=seed)
        jidx = j_ivf_pq_build(x, JIVFPQParams(**params))
        tidx = ivf_pq_build(x, IVFPQParams(**params), device="cpu")
        assert tidx.codes_sorted.shape == (3001, 4)
        assert tidx.vectors_sorted.shape == (3001, 16)
        assert tidx.warmup(200, k=10, n_probes=6) == 80
        r_jax.append(_recall(j_grouped(jidx, q, 10, n_probes=6)[1], true))
        for kernel in (False, True):
            _, ids = ivf_pq_search_grouped(tidx, q, 10, n_probes=6,
                                           use_kernel=kernel)
            r_port[kernel].append(_recall(ids.numpy(), true))
    for kernel, r in r_port.items():
        assert np.mean(r) >= np.mean(r_jax) - 0.02, (kernel, r, r_jax)


def test_blocked_build_trains_on_a_subsample(blob_case):
    """train_size < n: the coarse quantizer and the codebooks train on a
    subsample, every row is encoded in blocks, and the auto list cap
    splits swollen lists."""
    x, q, _, _ = blob_case
    tidx = ivf_pq_build(x, IVFPQParams(
        n_lists=8, pq_dim=4, pq_bits=4, kmeans_n_iters=3,
        pq_kmeans_n_iters=3, kmeans_init="random", train_size=1000,
        encode_block=700), device="cpu")
    assert tidx.storage.n == 3000
    assert tidx.storage.max_list <= max(256, 2 * -(-3000 // 8))
    assert tidx.centroids.shape[0] >= 8
    true = np_knn_ids(x, q, 10)
    _, ids = ivf_pq_search_grouped(tidx, q, 10, n_probes=4,
                                   refine_ratio=4.0)
    assert _recall(ids.numpy(), true) > 0.5


def test_corrupted_archive_raises(tmp_path, jax_index):
    path = tmp_path / "pq.npz"
    save_index(jax_index, path)
    field = corrupt_bytes(path, field="codebooks", n_bytes=4)
    with pytest.raises(terrors.CorruptIndexError, match="CRC32") as e:
        load_ivf_pq(path, device="cpu")
    assert e.value.field == field == "codebooks"


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, jax_index):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_pq_build(np.zeros((64, 8), np.float32),
                     IVFPQParams(n_lists=2, pq_dim=2, pq_bits=4))
    path = tmp_path / "pq.npz"
    save_index(jax_index, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_ivf_pq(path)


def test_code_rows_padded_once(index):
    n = index.codes_sorted.shape[0]
    assert index.code_rows(n) is index.codes_sorted
    a = index.code_rows(n + 7)
    assert a is index.code_rows(n + 7) and not a[n:].any()
    fresh = dataclasses.replace(index)
    assert fresh._code_rows == {}


def test_profile_tool_takes_the_quantized_kinds():
    """``profile_grouped --kind sq|pq`` parses, and without a card it
    refuses to run before building anything."""
    from raft_tpu_torch.tools import profile_grouped as pg

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kind in ("sq", "pq"):
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            pg.main(["--kind", kind])
    with pytest.raises(SystemExit):
        pg.main(["--kind", "graph"])
