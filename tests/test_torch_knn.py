"""PyTorch port of brute-force kNN (raft_tpu_torch.spatial: selection,
fused_knn, knn) against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. The JAX side runs
its Pallas kernels as its own tests do (``interpret=True``, the CPU
default of ``fused_l2_knn``); the port's kernel wrappers run their plain
versions on CPU tensors. On integer-exact inputs every f32 sum is exact
in any order, so phase-1 minima, rescore scores and searched distances
must match bitwise, and ids up to ties (the port breaks every tie lowest
index first, as ``lax.top_k`` does). On Gaussian inputs distances are
held to rtol 1e-5 (f32 sums in another order) and ids must agree on all
but rounding-level near-ties. L2 roots are compared with the correctly
rounded root of the JAX squared distance (ROADMAP note R4).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from raft_tpu.distance.distance_type import DistanceType as JDT
from raft_tpu.spatial import fused_knn as jfk
from raft_tpu.spatial import knn as jknn
from raft_tpu.spatial import selection as jsel
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.spatial import (
    SelectKAlgo,
    brute_force_knn,
    epsilon_neighborhood,
    haversine_knn,
    knn_merge_parts,
    merge_topk,
    select_k,
    select_k_blocked,
)
from raft_tpu_torch.spatial import fused_knn as tfk
from raft_tpu_torch.spatial import knn as tknn
from raft_tpu_torch.spatial import selection as tsel

torch.set_num_threads(1)

CPU = "cpu"


def _ints(rng, *shape, lo=-8, hi=8):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _np(t):
    return np.asarray(t)


def _assert_ids_up_to_ties(dists, i0, i1):
    """ids identical except inside runs of equal distance, where the id
    sets must agree; the last run may be cut by the k-th place, so it is
    checked by distance alone (any id at that distance is a right k-th
    neighbour)."""
    d, a, b = _np(dists), _np(i0), _np(i1)
    for r in range(d.shape[0]):
        k = d.shape[1]
        start = 0
        for end in range(1, k):
            if d[r, end] != d[r, start]:
                assert set(a[r, start:end]) == set(b[r, start:end]), r
                start = end


def _padded(y, yn, npad):
    n, d = y.shape
    yp = np.concatenate([y, np.zeros((npad - n, d), y.dtype)])
    ynp = np.concatenate([yn, np.full(npad - n, 1e30, np.float32)])
    return yp, ynp


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def test_top_k_smallest_is_lax_top_k_order():
    """Ties lowest index first; -0.0 before 0.0; NaN by its sign bit —
    what lax.top_k(-x) selects."""
    x = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -1.0, np.nan, -np.nan, 1.0]],
                 np.float32)
    nv, ni = lax.top_k(-jnp.asarray(x), 9)
    v, i = tsel.top_k_smallest(torch.as_tensor(x), 9)
    np.testing.assert_array_equal(i.numpy(), _np(ni))
    np.testing.assert_array_equal(
        v.numpy().view(np.int32), (-_np(nv)).view(np.int32))
    v, i = tsel.top_k_smallest(torch.as_tensor(x).double(), 4)
    np.testing.assert_array_equal(i.numpy(), _np(ni)[:, :4])


_NEG_NAN = np.array([0xffc00000], np.uint32).view(np.float32)[0]
# every special value, BIG (the searches' sentinel) among them, and a tie
_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, _NEG_NAN, 1e30,
                      -1e30, 1.0, 1.0], np.float32)


def _select_rows(kind, shape, rng):
    if kind == "ties":
        return rng.integers(0, 3, shape).astype(np.float32)
    if kind == "specials":
        return rng.choice(_SPECIALS, shape)
    if kind == "special_row":           # each special value, shuffled
        return _SPECIALS[[6, 4, 1, 8, 0, 2, 5, 3, 7, 9, 1, 0]][None, :]
    x = rng.random(shape).astype(np.float32) * 400 + 100
    return np.where(rng.random(shape) < 0.1, np.float32(1e30), x)


@pytest.mark.parametrize("kind,shape,k,dtype", [
    (kind, shape, k, np.float32)
    for kind in ("ties", "specials", "distance")
    for shape, k in (((5, 37), 1), ((5, 37), 37), ((3, 300), 40),
                     ((4, 6, 50), 10), ((2, 3, 4, 9), 9), ((1, 1), 1))
] + [("special_row", None, 12, np.float32)] + [
    ("ties", (6, 70), 12, np.int32), ("ties", (6, 70), 12, np.int64),
    ("specials", (6, 70), 12, np.float64),
    ("specials", (6, 70), 12, np.float16),
])
def test_top_k_smallest_total_order_is_lax_top_k(kind, shape, k, dtype):
    """More rows for the test above: tie-heavy, special-value and
    distance-like rows at k = 1, k = n, a middle k and leading batch axes,
    and integer, f64 and f16 rows (the sort's other routes): the indices
    lax.top_k(-x) selects, each with its value's own bits."""
    rng = np.random.default_rng(sum(shape or ()) + k)
    with np.errstate(over="ignore"):            # BIG is inf in f16
        x = _select_rows(kind, shape, rng).astype(dtype)
    # lax.top_k over f32 (x64 is off): exact for f16 and for these f64
    xj = x if np.dtype(dtype).kind == "i" else x.astype(np.float32)
    _, ni = lax.top_k(-jnp.asarray(xj), k)
    v, i = tsel.top_k_smallest(torch.as_tensor(x), k)
    np.testing.assert_array_equal(i.numpy(), _np(ni))
    want = np.take_along_axis(x, _np(ni).astype(np.int64), -1)
    np.testing.assert_array_equal(v.numpy().view(np.uint8),
                                  want.view(np.uint8))


@pytest.mark.parametrize("algo", [SelectKAlgo.TOPK, SelectKAlgo.SORT,
                                  SelectKAlgo.CHUNK_MIN, SelectKAlgo.APPROX])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_matches_jax(algo, select_min, rng_np):
    d = _ints(rng_np, 30, 512, lo=-20, hi=20)      # many ties
    labels = rng_np.integers(100, 999, d.shape).astype(np.int32)
    jv, ji = jsel.select_k(jnp.asarray(d), 7, select_min=select_min,
                           indices=jnp.asarray(labels), algo=algo)
    tv, ti = select_k(torch.as_tensor(d), 7, select_min=select_min,
                      indices=torch.as_tensor(labels), algo=algo)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    assert ti.dtype == torch.int32
    if algo == SelectKAlgo.APPROX:
        _assert_ids_up_to_ties(jv, ji, ti)     # exact here, both orders
    else:
        np.testing.assert_array_equal(ti.numpy(), _np(ji))


def test_chunk_min_select_k_merge_and_blocked_match_jax(rng_np):
    d = _ints(rng_np, 12, 1024, lo=-30, hi=30)
    for k in (5, 9):
        jv, ji = jsel.chunk_min_select_k(jnp.asarray(d), k)
        tv, ti = tsel.chunk_min_select_k(torch.as_tensor(d), k)
        np.testing.assert_array_equal(tv.numpy(), _np(jv))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
    # ragged width: the plain top-k branch
    jv, ji = jsel.chunk_min_select_k(jnp.asarray(d[:, :300]), 4,
                                     select_min=False)
    tv, ti = tsel.chunk_min_select_k(torch.as_tensor(d[:, :300]), 4,
                                     select_min=False)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    a = np.sort(d[:, :6], 1)
    b = np.sort(d[:, 6:12], 1)
    ia = np.tile(np.arange(6, dtype=np.int32), (12, 1))
    jm = jsel.merge_topk(jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b),
                         jnp.asarray(ia + 6))
    tm = merge_topk(torch.as_tensor(a), torch.as_tensor(ia),
                    torch.as_tensor(b), torch.as_tensor(ia + 6))
    np.testing.assert_array_equal(tm[0].numpy(), _np(jm[0]))
    np.testing.assert_array_equal(tm[1].numpy(), _np(jm[1]))
    jb = jsel.select_k_blocked(jnp.asarray(d[:, :333]), 9, block_n=64)
    tb = select_k_blocked(torch.as_tensor(d[:, :333]), 9, block_n=64)
    np.testing.assert_array_equal(tb[0].numpy(), _np(jb[0]))
    np.testing.assert_array_equal(tb[1].numpy(), _np(jb[1]))


def test_merge_parts_select_k_and_provenance_match_jax(rng_np):
    pv = np.sort(_ints(rng_np, 3, 5, 4, lo=0, hi=6), axis=2)
    pi = rng_np.integers(0, 1000, (3, 5, 4)).astype(np.int32)
    for ways in (None, 5):
        jv, ji = jsel.merge_parts_select_k(jnp.asarray(pv), jnp.asarray(pi),
                                           4, ways=ways)
        tv, ti = tsel.merge_parts_select_k(torch.as_tensor(pv),
                                           torch.as_tensor(pi), 4, ways=ways)
        np.testing.assert_array_equal(tv.numpy(), _np(jv))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
    jout = jsel.merge_parts_provenance_select_k(jnp.asarray(pv),
                                                jnp.asarray(pi), 6)
    tout = tsel.merge_parts_provenance_select_k(torch.as_tensor(pv),
                                                torch.as_tensor(pi), 6)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), _np(j))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,d", [(37, 8192 + 37, 19), (200, 16384, 128)])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_chunk_mins_plain_matches_jax_kernel_bitwise(m, n, d, storage,
                                                     compute, rng_np):
    q, y = _ints(rng_np, m, d), _ints(rng_np, n, d)
    bm, bn = jfk._plan_blocks(m, n, d)
    npad = -(-n // bn) * bn
    yn = (y * y).sum(1)
    yp, ynp = _padded(y, yn, npad)
    want = _np(jfk._chunk_mins(
        jnp.asarray(q), jnp.asarray(yp, storage), jnp.asarray(ynp)[:, None],
        bm=bm, bn=bn, compute_dtype=jnp.dtype(compute), interpret=True))
    yt = torch.as_tensor(y).to(getattr(torch, storage))
    before = dict(tfk.LAUNCHES)
    got = tfk.chunk_mins(torch.as_tensor(q), yt, torch.as_tensor(yn), npad,
                         getattr(torch, compute))
    assert tfk.LAUNCHES == before            # the CPU runs the plain version
    assert tuple(got.shape) == (m, npad // 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # rows past n score BIG: whole padded chunks are exactly BIG
    assert (got[:, -(-n // 128):] == tfk.BIG).all()


@pytest.mark.parametrize("m,n,d", [
    (130, 4096, 16),         # m off the bf16 kernel's 128-query tile
    (40, 4096, 20),          # d off the 16-wide mma grain
    (40, 4096 + 77, 32),     # a ragged last chunk
    (40, 2100, 48),          # npad with whole chunks past n
])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_chunk_mins_bf16_plain_matches_jax_kernel_at_tile_edges(
        m, n, d, storage, rng_np):
    """bf16 compute, the tensor-core kernel's edges: the plain version
    equals the JAX kernel in interpret mode bit for bit on integer
    inputs (bf16 products exact in f32, integer sums exact)."""
    q, y = _ints(rng_np, m, d), _ints(rng_np, n, d)
    bm, bn = jfk._plan_blocks(m, n, d)
    npad = -(-n // bn) * bn
    yn = (y * y).sum(1)
    yp, ynp = _padded(y, yn, npad)
    want = _np(jfk._chunk_mins(
        jnp.asarray(q), jnp.asarray(yp, storage), jnp.asarray(ynp)[:, None],
        bm=bm, bn=bn, compute_dtype=jnp.bfloat16, interpret=True))
    got = tfk.chunk_mins(torch.as_tensor(q),
                         torch.as_tensor(y).to(getattr(torch, storage)),
                         torch.as_tensor(yn), npad, torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, -(-n // 128):] == tfk.BIG).all()
    if n % 128:
        assert (got[:, n // 128] < tfk.BIG).all()     # the ragged chunk


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_rescore_plain_matches_jax_kernel_bitwise(storage, rng_np):
    m, n, d, c = 16, 4096 + 57, 128, 8
    q, y = _ints(rng_np, m, d), _ints(rng_np, n, d)
    npad = -(-n // 2048) * 2048
    cids = rng_np.integers(0, npad // 128, (m, c)).astype(np.int32)
    yp, _ = _padded(y, (y * y).sum(1), npad)
    want = _np(jfk._rescore_scores(jnp.asarray(q), jnp.asarray(cids),
                                   jnp.asarray(yp, storage), c=c,
                                   interpret=True))
    got = tfk.rescore_scores(torch.as_tensor(q), torch.as_tensor(cids),
                             torch.as_tensor(y).to(getattr(torch, storage)))
    rows = (cids[:, :, None] * 128 + np.arange(128)).reshape(m, -1)
    valid = rows < n
    np.testing.assert_array_equal(got.numpy()[valid], want[valid])
    assert (got.numpy()[~valid] == 0).all()


# (query, slot) pairs one rescore block scores (csrc/fused_knn.cu kGroup)
_RESCORE_GROUP = 32


def _rescore_plan(cids, n: int):
    """The rescore kernel's inverted pair map, in plain PyTorch (the
    launch builds the same on the card before its blocks run). The
    (query i, slot j) pairs ``p = i·c + j`` of the (m, c) chunk ids go
    into one bucket per chunk id (bucket ``ceil(n/128)`` takes every id
    outside ``[0, ceil(n/128))``: rows past the index, scoring 0), and
    each bucket is cut into groups of at most 32 pairs, one block
    each. Returns int32 ``(start, count, gstart, gkey, pairs)``: bucket k
    holds ``pairs[start[k]:start[k] + count[k]]``; its groups are
    ``gstart[k]:gstart[k + 1]`` (``gstart[-1]``, the group count); group
    g belongs to bucket ``gkey[g]`` and holds the bucket's pairs from
    ``start[k] + (g − gstart[k])·32``. The kernel fills a bucket in
    arrival order (atomics), this version in pair order: any order gives
    the same scores, since each pair's sums are its own."""
    m, c = cids.shape
    n_chunks = -(-n // 128)
    keys = cids.reshape(m * c).long()
    keys = torch.where((keys >= 0) & (keys < n_chunks), keys,
                       torch.full_like(keys, n_chunks))
    count = torch.bincount(keys, minlength=n_chunks + 1)
    start = torch.cumsum(count, 0) - count
    groups = -(-count // _RESCORE_GROUP)
    gstart = torch.cat([groups.new_zeros(1), torch.cumsum(groups, 0)])
    gkey = torch.repeat_interleave(
        torch.arange(n_chunks + 1, device=cids.device), groups)
    pairs = torch.argsort(keys, stable=True)
    i32 = torch.int32
    return (start.to(i32), count.to(i32), gstart.to(i32), gkey.to(i32),
            pairs.to(i32))


def _rescore_through_plan(q, cids, y):
    """The rescore kernel's traversal in plain PyTorch: one step per
    group of :func:`_rescore_plan` (the block's lookup: its bucket, its
    slice of the bucket's pairs), each scoring its chunk's 128 rows for
    the group's pairs only (the plain formula), written to each pair's
    slot. Also checks the plan's invariants."""
    m, c = cids.shape
    n = y.shape[0]
    n_chunks = -(-n // 128)
    group = _RESCORE_GROUP
    start, count, gstart, gkey, pairs = _rescore_plan(cids, n)
    for t in (start, count, gstart, gkey, pairs):
        assert t.dtype == torch.int32
    assert start.shape == count.shape == (n_chunks + 1,)
    assert gstart.shape == (n_chunks + 2,)
    assert int(count.sum()) == m * c and int(gstart[0]) == 0
    assert torch.equal(torch.sort(pairs).values,
                       torch.arange(m * c, dtype=torch.int32))
    flat = cids.reshape(-1).long()
    bucket = torch.where((flat >= 0) & (flat < n_chunks), flat, n_chunks)
    groups = int(gstart[-1])
    # the launch's grid bound covers every group
    assert groups <= min(m * c, m * c // group + n_chunks + 1)
    assert gkey.shape == (groups,)
    out = torch.full((m, c * 128), float("nan"))
    for g in range(groups):
        k = int(gkey[g])
        assert int(gstart[k]) <= g < int(gstart[k + 1])
        s0 = int(start[k]) + (g - int(gstart[k])) * group
        s1 = min(s0 + group, int(start[k] + count[k]))
        assert 1 <= s1 - s0 <= group
        p = pairs[s0:s1].long()
        assert (bucket[p] == k).all()
        sc = tfk.rescore_scores_plain(
            q[p // c], torch.full((s1 - s0, 1), k, dtype=torch.int32), y)
        for r, pp in enumerate(p.tolist()):
            i, j = divmod(pp, c)
            out[i, j * 128:(j + 1) * 128] = sc[r]
    assert not torch.isnan(out).any()
    return out


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 48])
def test_rescore_plan_inverts_the_pair_map(storage, c, rng_np):
    """The rescore kernel's pair inversion (pairs sorted by chunk, runs
    cut into groups of at most 32) against ``rescore_scores_plain``,
    bitwise on integer-exact inputs: one chunk in every query's list
    (more queries than a group holds), a chunk named by exactly 32, ids
    past the index and negative ones (rows scoring 0), f32 and bf16
    storage."""
    m, n, d = 70, 3000 + 57, 24
    q = torch.as_tensor(_ints(rng_np, m, d))
    y = torch.as_tensor(_ints(rng_np, n, d)).to(getattr(torch, storage))
    cids = rng_np.integers(0, -(-n // 128), (m, c)).astype(np.int32)
    cids[:, 0] = 5                          # every query: 70 > 32 pairs
    cids[:32, 1] = 7                        # exactly one full group
    cids[:, 1][32:] = 9
    cids[3, 2] = -(-n // 128)               # past the index
    cids[4, 3] = 40
    cids[5, 4] = -2                         # negative: scores 0 too
    cids = torch.as_tensor(cids)
    want = tfk.rescore_scores_plain(q, cids, y)
    got = _rescore_through_plan(q, cids, y)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[3, 2 * 128:3 * 128] == 0).all()
    assert (got[5, 4 * 128:5 * 128] == 0).all()
    # the last chunk is ragged: its rows past n score 0
    last = (-(-n // 128)) - 1
    cids2 = torch.full((2, 1), last, dtype=torch.int32)
    tail = _rescore_through_plan(q[:2], cids2, y)
    assert (tail[:, n - last * 128:] == 0).all()
    assert torch.equal(tail, tfk.rescore_scores_plain(q[:2], cids2, y))


def test_rescore_plan_group_count_and_bound():
    """Groups: one per run of at most 32 pairs of a chunk, each chunk's
    bucket in order; a chunk no query names has no group."""
    cids = torch.zeros((100, 1), dtype=torch.int32)
    start, count, gstart, gkey, _ = _rescore_plan(cids, 1000)
    assert count.tolist() == [100] + [0] * 8
    assert gstart.tolist() == [0] + [4] * 9 and gkey.tolist() == [0] * 4
    cids = torch.arange(40, dtype=torch.int32).reshape(20, 2)
    start, count, gstart, gkey, pairs = _rescore_plan(cids, 128 * 40)
    assert gkey.tolist() == list(range(40)) and pairs.tolist() == \
        list(range(40))
    assert gstart[-1] == 40 and count[-1] == 0


def test_kernel_wrappers_check_operands():
    q = torch.zeros((3, 16))
    y = torch.zeros((300, 16))
    yn = torch.zeros(300)
    with pytest.raises(ValueError, match="float32"):
        tfk.chunk_mins(q.double(), y, yn, 384)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfk.chunk_mins(q, y, yn, 300)
    with pytest.raises(ValueError, match="ynorm"):
        tfk.chunk_mins(q, y, yn[:-1], 384)
    with pytest.raises(ValueError, match="contiguous"):
        tfk.chunk_mins(q, torch.zeros((16, 300)).T, yn, 384)
    with pytest.raises(ValueError, match="compute_dtype"):
        tfk.chunk_mins(q, y, yn, 384, torch.float16)
    with pytest.raises(ValueError, match="int32"):
        tfk.rescore_scores(q, torch.zeros((3, 2), dtype=torch.int64), y)
    with pytest.raises(ValueError, match="index"):
        tfk.rescore_scores(q, torch.zeros((3, 2), dtype=torch.int32),
                           y[:, :8])


_F32, _BF16 = torch.float32, torch.bfloat16
_WG = tfk.WGMMA_MAX_D


@pytest.mark.parametrize("d,compute,route", [
    (1, _BF16, "wgmma"),
    (64, _BF16, "wgmma"),                # one 64-feature block
    (96, _BF16, "wgmma"),                # DEEP's width
    (128, _BF16, "wgmma"),               # the SIFT cell
    (160, _BF16, "wgmma"),               # three blocks
    (_WG - 1, _BF16, "wgmma"),
    (_WG, _BF16, "wgmma"),               # the limit
    (_WG + 1, _BF16, "mma"),             # just past it
    (768, _BF16, "mma"),                 # the smoke's wide partition
    (4096, _BF16, "mma"),
    (1, _F32, "f32"),
    (128, _F32, "f32"),
    (_WG, _F32, "f32"),
    (_WG + 1, _F32, "f32"),
    (128, "bfloat16", "wgmma"),          # dtype names, as chunk_mins takes
    (768, "float32", "f32"),
])
def test_chunk_mins_route_rule(d, compute, route):
    """The phase-1 route is a function of the width and the compute type:
    bf16 compute takes wgmma up to WGMMA_MAX_D and mma.sync past it, f32
    compute its own kernel at every width."""
    assert tfk.chunk_mins_route(d, compute) == route


def test_chunk_mins_route_limit_is_the_kernels():
    """WGMMA_MAX_D mirrors the kernel's kWgMaxD, the widest row whose
    resident tile and ring fit in shared memory."""
    import re
    from pathlib import Path

    src = (Path(tfk.__file__).resolve().parents[1] / "csrc" /
           "fused_knn.cu").read_text()
    found = re.findall(r"constexpr int kWgMaxD = (\d+);", src)
    assert found == [str(tfk.WGMMA_MAX_D)]
    assert tfk.WGMMA_MAX_D >= 256


@pytest.mark.parametrize("compute", [torch.float16, torch.int8, "float64"])
def test_chunk_mins_route_checks_compute_type(compute):
    """The rule takes the compute types chunk_mins takes, and refuses the
    others as chunk_mins does."""
    with pytest.raises(ValueError, match="compute_dtype"):
        tfk.chunk_mins_route(128, compute)
    q = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="compute_dtype"):
        tfk.chunk_mins(q, q, torch.zeros(2), 128, compute)


def test_chunk_mins_counts_calls_by_route():
    """Every phase-1 call counts one ``knn_chunk_mins_calls_total`` on the
    route it took: ``plain`` for CPU tensors, whatever the compute type
    and width; the kernel routes only on a card; the obs gate stops it."""
    from raft_tpu_torch.obs import default_registry
    from raft_tpu_torch.obs import metrics as obs_metrics

    def read():
        return {c.labels["route"]: c.value for c in
                default_registry().series("knn_chunk_mins_calls_total")}

    rng = np.random.default_rng(4)
    prev = obs_metrics.set_enabled(True)
    try:
        before = read()
        for d, cd in ((20, _BF16), (300, _BF16), (20, _F32)):
            q = torch.as_tensor(_ints(rng, 3, d))
            y = torch.as_tensor(_ints(rng, 200, d))
            tfk.chunk_mins(q, y, (y * y).sum(1), 256, cd)
        after = read()
        assert after["plain"] == before.get("plain", 0) + 3
        assert set(after) <= {"plain", "wgmma", "mma", "f32"}
        for route in ("wgmma", "mma", "f32"):
            assert after.get(route, 0) == before.get(route, 0)
        obs_metrics.set_enabled(False)
        tfk.chunk_mins(q, y, (y * y).sum(1), 256, _BF16)
        assert read() == after
    finally:
        obs_metrics.set_enabled(prev)


def test_plan_and_supported_predicate_match_jax():
    """The block plan is JAX's; so is the support rule up to k = 128, the
    JAX package's cap. Past it the port serves k up to its selection
    kernel's cap (SELECT_K_MAX_K) wherever JAX's rule at k = 128 holds and
    there are k chunks to cover."""
    L2, L1 = DistanceType.L2SqrtExpanded, DistanceType.L1
    for m in (1, 37, 128, 1000, 10000):
        for n in (1000, 4109, 8192, 65536, 1_000_000):
            for d in (19, 128, 768, 4096, 5000):
                assert tfk._plan_blocks(m, n, d) == jfk._plan_blocks(m, n, d)
                for k in (1, 10, 32, 128, 129, 256, 257):
                    for metric in (L2, L1, DistanceType.L2Unexpanded):
                        got = tfk.fused_knn_supported(metric, m, n, d, k)
                        jax_rule = jfk.fused_knn_supported(
                            JDT(int(metric)), m, n, d, min(k, 128))
                        assert got == (jax_rule and k <= 256
                                       and n // 128 >= k)


# ---------------------------------------------------------------------------
# fused_l2_knn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,d,k", [
    (37, 8192, 19, 7),       # ragged everything (gather rescore)
    (128, 5000, 64, 10),     # n not a multiple of the chunk width
    (10, 4109, 96, 3),       # prime-ish n
    (200, 16384, 128, 32),   # larger k (rescore kernel route)
])
def test_fused_l2_knn_matches_jax(m, n, d, k, rng_np):
    q, y = _ints(rng_np, m, d), _ints(rng_np, n, d)
    jd, ji = jfk.fused_l2_knn(q, y, k, metric=JDT.L2Expanded)
    td, ti = tfk.fused_l2_knn(q, y, k, metric=DistanceType.L2Expanded,
                              device=CPU)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    _assert_ids_up_to_ties(jd, ji, ti)
    sd, si = tfk.fused_l2_knn(q, y, k, device=CPU)          # L2SqrtExpanded
    np.testing.assert_array_equal(sd.numpy(), np.sqrt(_np(jd)))
    np.testing.assert_array_equal(si.numpy(), ti.numpy())
    if m * n > 1 << 20:
        return           # the Gaussian case at the three smaller shapes
    qg = rng_np.standard_normal((m, d)).astype(np.float32)
    yg = rng_np.standard_normal((n, d)).astype(np.float32)
    jd, ji = jfk.fused_l2_knn(qg, yg, k, metric=JDT.L2Expanded)
    td, ti = tfk.fused_l2_knn(qg, yg, k, metric="l2_expanded", device=CPU)
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-5, atol=1e-4)
    assert (ti.numpy() == _np(ji)).mean() >= 0.99


def test_fused_metric_variants_bf16_and_gather_rows(rng_np):
    q, y = _ints(rng_np, 16, 128), _ints(rng_np, 4096 + 130, 128)
    for metric in (JDT.L2Expanded, JDT.L2SqrtExpanded, JDT.L2Unexpanded):
        jd, ji = jfk.fused_l2_knn(q, y, 4, metric=metric)
        td, ti = tfk.fused_l2_knn(q, y, 4, metric=int(metric), device=CPU)
        want = (np.sqrt(_np(jfk.fused_l2_knn(q, y, 4,
                                             metric=JDT.L2Expanded)[0]))
                if metric == JDT.L2SqrtExpanded else _np(jd))
        np.testing.assert_array_equal(td.numpy(), want)
        _assert_ids_up_to_ties(want, ji, ti)
    # bf16 phase 1 with the wide margin, f32 and bf16 storage
    for storage in (jnp.float32, jnp.bfloat16):
        yj = jnp.asarray(y, storage)
        jd, ji = jfk.fused_l2_knn(q, yj, 10, metric=JDT.L2Expanded,
                                  compute_dtype=jnp.bfloat16,
                                  extra_chunks=32)
        yt = torch.as_tensor(y).to(torch.bfloat16 if storage == jnp.bfloat16
                                   else torch.float32)
        td, ti = tfk.fused_l2_knn(torch.as_tensor(q), yt, 10,
                                  metric="l2_expanded",
                                  compute_dtype=torch.bfloat16,
                                  extra_chunks=32)
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        _assert_ids_up_to_ties(jd, ji, ti)
    # the gather rescore, pinned both ways, and its bf16 query operand
    for gather_rows, cd in ((False, jnp.float32), (True, jnp.bfloat16)):
        jd, ji = jfk.fused_l2_knn(q, jnp.asarray(y, cd), 7,
                                  metric=JDT.L2Expanded,
                                  gather_rows=gather_rows, compute_dtype=cd)
        td, ti = tfk.fused_l2_knn(
            torch.as_tensor(q),
            torch.as_tensor(y).to(getattr(torch, jnp.dtype(cd).name)),
            7, metric="l2_expanded", gather_rows=gather_rows,
            compute_dtype=jnp.dtype(cd).name)
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        _assert_ids_up_to_ties(jd, ji, ti)


def test_fused_bf16_recall_gaussian(rng_np):
    """bf16 phase 1 with extra_chunks=32 stays near-exact (the JAX test's
    0.99 floor), and the port picks the JAX package's neighbours."""
    q = rng_np.standard_normal((64, 64)).astype(np.float32)
    x = rng_np.standard_normal((20000, 64)).astype(np.float32)
    _, ji = jfk.fused_l2_knn(q, x, 10, compute_dtype=jnp.bfloat16,
                             extra_chunks=32)
    _, ti = tfk.fused_l2_knn(q, x, 10, compute_dtype=torch.bfloat16,
                             extra_chunks=32, device=CPU)
    d2 = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    truth = np.argsort(d2, 1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(ti.numpy(), truth)])
    assert recall >= 0.99, recall
    assert (ti.numpy() == _np(ji)).mean() >= 0.99


def test_fused_index_norms_init_and_grid_limit(rng_np):
    q, y = _ints(rng_np, 19, 32), _ints(rng_np, 12000, 32)
    norms = (y * y).sum(1)
    d1, i1 = tfk.fused_l2_knn(q, y, 5, device=CPU)
    d2, i2 = tfk.fused_l2_knn(q, y, 5, index_norms=norms, device=CPU)
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    with pytest.raises(ValueError, match="index_norms"):
        tfk.fused_l2_knn(q, y, 5, index_norms=norms[:-1], device=CPU)
    # warm start: partition b's search from partition a's results
    a, b = y[:6000], y[6000:]
    ja = jfk.fused_l2_knn(q, a, 6, metric=JDT.L2Expanded)
    jb = jfk.fused_l2_knn(q, b, 6, metric=JDT.L2Expanded,
                          init=(ja[0], ja[1] + 6000))
    ta = tfk.fused_l2_knn(q, a, 6, metric="l2_expanded", device=CPU)
    tb = tfk.fused_l2_knn(q, b, 6, metric="l2_expanded",
                          init=(ta[0], ta[1] + 6000), device=CPU)
    np.testing.assert_array_equal(tb[0].numpy(), _np(jb[0]))
    _assert_ids_up_to_ties(jb[0], jb[1], tb[1])
    # a small rescore grid limit tiles the kernel route's launches
    q2, y2 = _ints(rng_np, 40, 128), _ints(rng_np, 4096, 128)
    jd, ji = jfk._fused_l2_knn_impl(
        q2, y2, 5, JDT.L2Expanded, bm=1024, bn=2048, bq2=40, extra_chunks=8,
        compute_dtype=jnp.dtype(jnp.float32), interpret=True, grid_limit=16)
    td, ti = tfk._fused_l2_knn_impl(
        torch.as_tensor(q2), torch.as_tensor(y2), 5, DistanceType.L2Expanded,
        bm=1024, bn=2048, bq2=40, extra_chunks=8,
        compute_dtype=torch.float32, grid_limit=16)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    _assert_ids_up_to_ties(jd, ji, ti)


def test_fused_unsupported_and_partition_guard(rng_np, monkeypatch):
    q, y = _ints(rng_np, 8, 16), _ints(rng_np, 8192, 16)
    with pytest.raises(ValueError, match="unsupported"):
        tfk.fused_l2_knn(q, y[:256], 3, device=CPU)
    with pytest.raises(ValueError, match="unsupported"):
        tfk.fused_l2_knn(q, y, 3, metric="l1", device=CPU)
    monkeypatch.setenv("RAFT_TPU_MAX_GRID_STEPS", "10")
    assert not tfk.fused_grid_ok(8, 8192, 16)
    with pytest.raises(ValueError, match="partitions of <= 1280 rows"):
        tfk.fused_l2_knn(q, y, 3, device=CPU)
    monkeypatch.setenv("RAFT_TPU_MAX_GRID_STEPS", "64")
    assert tfk.fused_grid_ok(8, 8192, 16)
    monkeypatch.setenv("RAFT_TPU_MAX_GRID_STEPS", "-3")
    with pytest.raises(ValueError, match="positive"):
        tfk._max_grid_steps()
    monkeypatch.delenv("RAFT_TPU_MAX_GRID_STEPS")
    assert tfk._max_grid_steps() == 2**31 - 1
    # the phase-1 grid: one block per (128-query tile, chunk)
    assert tfk._grid_steps(10000, 1_001_472) == 79 * 7824


def test_cuda_defaulting_entry_points_raise_without_a_card(rng_np):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, y = _ints(rng_np, 4, 16), _ints(rng_np, 8192, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfk.probe_grid_steps(64)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tfk.probe_grid_steps(64, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfk.fused_l2_knn(q, y, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brute_force_knn(y, q, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        epsilon_neighborhood(q, y, 1.0)


# ---------------------------------------------------------------------------
# brute_force_knn and friends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "l1",
                                    "inner_product"])
def test_brute_force_knn_scan_matches_jax(metric, rng_np):
    index = _ints(rng_np, 200, 16)
    queries = _ints(rng_np, 35, 16)
    base = "sqeuclidean" if metric == "l2" else metric
    jd, ji = jknn.brute_force_knn(index, queries, 8, metric=base)
    td, ti = brute_force_knn(index, queries, 8, metric=metric, device=CPU)
    want = np.sqrt(_np(jd)) if metric == "l2" else _np(jd)
    np.testing.assert_array_equal(td.numpy(), want)
    _assert_ids_up_to_ties(jd, ji, ti)
    # Gaussian inputs, blocked index and queries
    xg = rng_np.standard_normal((257, 8)).astype(np.float32)
    qg = rng_np.standard_normal((19, 8)).astype(np.float32)
    jd, ji = jknn.brute_force_knn(xg, qg, 5, metric=metric, block_n=64,
                                  block_q=7)
    td, ti = brute_force_knn(xg, qg, 5, metric=metric, block_n=64,
                             block_q=7, device=CPU)
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    ed, ei = brute_force_knn(xg, qg, 5, metric=metric, exact=False,
                             device=CPU)
    np.testing.assert_array_equal(ed.numpy(), brute_force_knn(
        xg, qg, 5, metric=metric, device=CPU)[0].numpy())


def test_partitions_translations_and_merge_parts(rng_np):
    full = _ints(rng_np, 300, 12)
    queries = _ints(rng_np, 21, 12)
    parts = [full[:100], full[100:180], full[180:]]
    jd, ji = jknn.brute_force_knn(parts, queries, 6, metric="sqeuclidean",
                                  translations=[5000, 0, 900])
    td, ti = brute_force_knn([torch.as_tensor(p) for p in parts], queries, 6,
                             metric="sqeuclidean",
                             translations=[5000, 0, 900])
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    _assert_ids_up_to_ties(jd, ji, ti)
    md, mi = brute_force_knn(parts, queries, 6, metric="sqeuclidean",
                             device=CPU)
    sd, si = brute_force_knn(full, queries, 6, metric="sqeuclidean",
                             device=CPU)
    np.testing.assert_array_equal(md.numpy(), sd.numpy())
    np.testing.assert_array_equal(mi.numpy(), si.numpy())
    pd = np.sort(rng_np.random((2, 5, 3)).astype(np.float32), axis=2)
    pi = np.tile(np.arange(3, dtype=np.int32), (2, 5, 1))
    jm = jknn.knn_merge_parts(pd, pi, translations=[0, 1000])
    tm = knn_merge_parts(torch.as_tensor(pd), torch.as_tensor(pi),
                         translations=[0, 1000])
    np.testing.assert_array_equal(tm[0].numpy(), _np(jm[0]))
    np.testing.assert_array_equal(tm[1].numpy(), _np(jm[1]))


def test_fused_route_partitions_norms_and_tuning_args(rng_np, caplog):
    q, y = _ints(rng_np, 19, 32), _ints(rng_np, 12000, 32)
    norms = (y * y).sum(1)
    a, b = y[:6000], y[6000:]
    jd, ji = jknn.brute_force_knn([a, b], q, 5, metric="sqeuclidean",
                                  use_fused=True,
                                  index_norms=[norms[:6000], norms[6000:]])
    td, ti = brute_force_knn([a, b], q, 5, metric="sqeuclidean",
                             use_fused=True,
                             index_norms=[norms[:6000], norms[6000:]],
                             device=CPU)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    _assert_ids_up_to_ties(jd, ji, ti)
    with pytest.raises(ValueError, match="use_fused=True"):
        brute_force_knn(y[:256], q, 3, use_fused=True, device=CPU)
    small = _ints(rng_np, 500, 32)
    with pytest.raises(ValueError, match="tune the fused path"):
        brute_force_knn([small, small], q, 3,
                        compute_dtype=torch.bfloat16, device=CPU)
    with pytest.raises(ValueError, match="tune the fused path"):
        # CPU tensors never take the fused path under use_fused=None
        brute_force_knn(y, q, 3, index_norms=norms, device=CPU)


def test_auto_route_counts_scan_fallbacks(rng_np, monkeypatch, caplog):
    """use_fused=None: a partition the fused kernels would serve on a
    Hopper card takes them; past the grid limit it takes the scan path,
    counted and warned about once. (The device test is patched so the
    CPU tensors stand in; the kernels' plain versions then run.)"""
    monkeypatch.setattr(tknn, "_fused_device_ok", lambda dev: True)
    q, y = _ints(rng_np, 8, 16), _ints(rng_np, 70000, 16)
    before_fb = tknn.SCAN_FALLBACKS
    fd, fi = brute_force_knn(y, q, 4, metric="sqeuclidean", device=CPU)
    assert tknn.SCAN_FALLBACKS == before_fb
    jd, _ = jfk.fused_l2_knn(q, y, 4, metric=JDT.L2Expanded)
    np.testing.assert_array_equal(fd.numpy(), _np(jd))
    # mixed routing: norms of the scan-routed small partition are ignored
    small = _ints(rng_np, 500, 16)
    with caplog.at_level(logging.WARNING, logger="raft_tpu_torch"):
        md, _ = brute_force_knn([y, small], q, 4, metric="sqeuclidean",
                                index_norms=[None, (small ** 2).sum(1)],
                                device=CPU)
    assert "index_norms[1] ignored" in caplog.text
    jd, _ = jknn.brute_force_knn([y, small], q, 4, metric="sqeuclidean")
    np.testing.assert_array_equal(md.numpy(), _np(jd))
    monkeypatch.setenv("RAFT_TPU_MAX_GRID_STEPS", "8")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="raft_tpu_torch"):
        sd, si = brute_force_knn(y, q, 4, metric="sqeuclidean", device=CPU)
        brute_force_knn(y, q, 4, metric="sqeuclidean", device=CPU)
    assert tknn.SCAN_FALLBACKS == before_fb + 2
    assert caplog.text.count("past the launch limit") <= 1
    np.testing.assert_array_equal(sd.numpy(), fd.numpy())
    monkeypatch.delenv("RAFT_TPU_MAX_GRID_STEPS")
    before_g = tfk.RESCORE_GATHER_CALLS
    tfk.fused_l2_knn(q, y, 4, device=CPU)
    assert tfk.RESCORE_GATHER_CALLS == before_g     # counted for CUDA only


def test_haversine_knn_and_epsilon_neighborhood_match_jax(rng_np):
    lat = rng_np.uniform(-np.pi / 2, np.pi / 2, 50)
    lon = rng_np.uniform(-np.pi, np.pi, 50)
    index = np.stack([lat, lon], 1).astype(np.float32)
    jd, ji = jknn.haversine_knn(index, index[:9], 4)
    td, ti = haversine_knn(index, index[:9], 4, device=CPU)
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(ti.numpy()[:, 0], np.arange(9))
    x, y = _ints(rng_np, 40, 6, lo=-3, hi=3), _ints(rng_np, 30, 6, lo=-3,
                                                    hi=3)
    ja, jv = jknn.epsilon_neighborhood(x, y, 2.5)
    ta, tv = epsilon_neighborhood(x, y, 2.5, device=CPU)
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    assert tv.dtype == torch.int32
