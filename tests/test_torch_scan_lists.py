"""The list-scan entries of the port's flat, IVF-SQ and ADC scans
(``flat_kernel.flat_scan_lists``, ``sq_kernel.sq_scan_lists``,
``pq_kernel.pq_adc_lists``), which the grouped searches launch once per
batch (flat, SQ) or once per LUT chunk (IVF-PQ), reading query rows by
id and list rows in place.

On the CPU each runs its plain version, which must equal the gathered
form (``flat_scan_subchunk_min_plain`` / ``sq_scan_subchunk_min_plain`` /
``pq_adc_subchunk_min_plain`` on gathered query rows, LUTs and slabs) on
live slots and score BIG on dead ones, and match the JAX lax mirrors
through the gathered form. The
grouped searches must return what the per-block gathered form returned
before, and the live-pair LUTs must equal ``block_luts``'s rows bit for
bit. The CUDA kernels are checked against these plain versions in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.spatial.ann import flat_kernel as jfk
from raft_tpu.spatial.ann import pq_kernel as jpq
from raft_tpu.spatial.ann import sq_kernel as jsq
from raft_tpu_torch.spatial.ann import flat_kernel as tfk
from raft_tpu_torch.spatial.ann import ivf_pq as tivf_pq
from raft_tpu_torch.spatial.ann import pq_kernel as tpq
from raft_tpu_torch.spatial.ann import sq_kernel as tsq
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    IVFPQParams,
    IVFSQParams,
    ivf_flat_build,
    ivf_flat_search_grouped,
    ivf_pq_build,
    ivf_pq_search_grouped,
    ivf_sq_build,
    ivf_sq_search_grouped,
)

torch.set_num_threads(1)

BIG = tfk.BIG


def _windows(rng, n_lists, rows_pad, l_pad):
    """List windows as the grouped search makes them: offsets and sizes
    of contiguous lists, origins clamped to the storage tail, [lo, hi)
    relative to the origin. Lists 0 and 1 are empty; the last list sits
    at the tail, so its window is clamped."""
    sizes = rng.integers(1, l_pad + 1, n_lists)
    sizes[:2] = 0
    sizes[-1] = min(sizes[-1], l_pad // 2)
    offsets = rng.integers(0, rows_pad - l_pad, n_lists)
    offsets[-1] = rows_pad - 1 - sizes[-1]           # the tail list
    origins = np.minimum(offsets, rows_pad - l_pad)
    lo = offsets - origins
    bounds = np.stack([lo, lo + sizes], 1)
    return (torch.as_tensor(origins, dtype=torch.int32),
            torch.as_tensor(bounds, dtype=torch.int32))


def _slot_map(rng, n_lists, q, n_live, dead):
    """(lists, Q) ids: live slots front-packed with ids in [0, n_live),
    the rest ``dead``; list 2 has no live slot."""
    occ = rng.integers(0, q + 1, n_lists)
    occ[2] = 0
    occ[3] = q
    occ[-1] = max(occ[-1], 1)
    ids = rng.integers(0, n_live, (n_lists, q))
    return torch.as_tensor(
        np.where(np.arange(q)[None, :] < occ[:, None], ids, dead),
        dtype=torch.int32)


def _flat_case(seed, n_lists, q, d, l_pad, integer):
    rng = np.random.default_rng(seed)
    nq, n_rows = 40, 3 * l_pad + 5
    draw = ((lambda s: rng.integers(-64, 64, s).astype(np.float32))
            if integer else
            (lambda s: rng.standard_normal(s).astype(np.float32)))
    queries = torch.as_tensor(np.concatenate(
        [draw((nq, d)), np.zeros((1, d), np.float32)])).to(torch.bfloat16)
    rows = torch.as_tensor(draw((n_rows, d))).to(torch.bfloat16)
    origins, bounds = _windows(rng, n_lists, n_rows, l_pad)
    qmat = _slot_map(rng, n_lists, q, nq, nq)
    return queries, qmat, rows, origins, bounds


def _gathered(rows, origins, l_pad):
    win = origins.long()[:, None] + torch.arange(l_pad)
    return rows[win]                                  # (lists, l_pad, ·)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n_lists,q,d,l_pad", [
    (6, 8, 16, 136),     # one query tile, a ragged window
    (5, 13, 24, 256),    # ragged Q and d
    (4, 70, 8, 512),     # Q past one 64-slot tile
])
def test_flat_lists_plain_is_the_gathered_form_on_live_slots(
        n_lists, q, d, l_pad, integer):
    queries, qmat, rows, origins, bounds = _flat_case(
        n_lists + q + d, n_lists, q, d, l_pad, integer)
    got = tfk.flat_scan_lists(queries, qmat, rows, origins, bounds, l_pad)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (n_lists, q, l_pad // 8)
    want = tfk.flat_scan_subchunk_min_plain(
        queries[qmat.long()], _gathered(rows, origins, l_pad).transpose(1, 2),
        bounds)
    live = qmat < queries.shape[0] - 1
    assert torch.equal(got[live], want[live])
    assert (got[~live] == BIG).all()
    assert (got[0] == BIG).all() and (got[1] == BIG).all()   # empty lists
    assert (got[2] == BIG).all()                             # no live slot
    # the tail list's window was clamped: its range starts past 0
    assert bounds[-1, 0] > 0 and (got[-1][live[-1]] < BIG).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_flat_lists_plain_matches_jax_mirror_through_gathered_form(seed):
    """Integer-exact inputs: the JAX lax mirror on the gathered query
    rows and slabs equals the list scan bit for bit on live slots."""
    queries, qmat, rows, origins, bounds = _flat_case(
        seed, 5, 16, 16, 256, True)
    got = tfk.flat_scan_lists(queries, qmat, rows, origins, bounds, 256)
    qv = queries[qmat.long()].float().numpy()
    slabs_t = _gathered(rows, origins, 256).transpose(1, 2).float().numpy()
    ref = np.asarray(jfk.flat_scan_subchunk_min_lax(
        jnp.asarray(qv), jnp.asarray(slabs_t), jnp.asarray(bounds.numpy())))
    live = (qmat < queries.shape[0] - 1).numpy()
    np.testing.assert_array_equal(got.numpy()[live], ref[live])


def test_flat_lists_checks_and_cpu_counts_no_launch():
    queries, qmat, rows, origins, bounds = _flat_case(3, 4, 8, 16, 136, True)
    before = tfk.LAUNCHES
    tfk.flat_scan_lists(queries, qmat, rows, origins, bounds, 136)
    assert tfk.LAUNCHES == before
    with pytest.raises(ValueError, match="bfloat16"):
        tfk.flat_scan_lists(queries.float(), qmat, rows, origins, bounds, 136)
    with pytest.raises(ValueError, match="int32"):
        tfk.flat_scan_lists(queries, qmat.long(), rows, origins, bounds, 136)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfk.flat_scan_lists(queries, qmat, rows, origins, bounds, 130)
    with pytest.raises(ValueError, match="row dim"):
        tfk.flat_scan_lists(queries[:, :8], qmat, rows, origins, bounds, 136)
    with pytest.raises(ValueError, match="bounds"):
        tfk.flat_scan_lists(queries, qmat, rows, origins, bounds[:2], 136)


def _sq_case(seed, n_lists, q, d, l_pad, dyadic):
    """An SQ list-scan case: bf16 query rows (integers with dyadic
    stats, Gaussian with generic ones) with the sentinel last, int8 code
    rows, the slot map, the windows and the affine stats."""
    rng = np.random.default_rng(seed)
    nq, n_rows = 40, 3 * l_pad + 5
    if dyadic:
        qr = rng.integers(-64, 64, (nq, d)).astype(np.float32)
        vmin = rng.integers(-8, 8, d).astype(np.float32)
        vscale = np.full(d, 0.5, np.float32)
    else:
        qr = rng.standard_normal((nq, d)).astype(np.float32)
        vmin = rng.standard_normal(d).astype(np.float32)
        vscale = (np.abs(rng.standard_normal(d)) / 255.0 + 1e-3).astype(
            np.float32)
    queries = torch.as_tensor(np.concatenate(
        [qr, np.zeros((1, d), np.float32)])).to(torch.bfloat16)
    codes = torch.as_tensor(rng.integers(-128, 128, (n_rows, d)),
                            dtype=torch.int8)
    origins, bounds = _windows(rng, n_lists, n_rows, l_pad)
    qmat = _slot_map(rng, n_lists, q, nq, nq)
    return (queries, qmat, codes, origins, bounds, torch.as_tensor(vmin),
            torch.as_tensor(vscale))


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n_lists,q,d,l_pad", [
    (6, 8, 16, 136),     # one query tile, a ragged window
    (5, 13, 24, 256),    # ragged Q, d off the 16-byte code grain
    (4, 70, 20, 512),    # Q past one 64-slot tile, d = 20
    (5, 9, 96, 264),     # the path's width, a ragged Lpad
])
def test_sq_lists_plain_is_the_gathered_form_on_live_slots(
        n_lists, q, d, l_pad, dyadic):
    queries, qmat, codes, origins, bounds, vmin, vscale = _sq_case(
        n_lists + q + d, n_lists, q, d, l_pad, dyadic)
    got = tsq.sq_scan_lists(queries, qmat, codes, origins, bounds, l_pad,
                            vmin, vscale)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (n_lists, q, l_pad // 8)
    want = tsq.sq_scan_subchunk_min_plain(
        queries[qmat.long()], _gathered(codes, origins, l_pad).transpose(1, 2),
        bounds, vmin, vscale)
    live = qmat < queries.shape[0] - 1
    assert torch.equal(got[live], want[live])
    assert (got[~live] == BIG).all()
    assert (got[:3] == BIG).all()            # empty lists, no live slot
    assert bounds[-1, 0] > 0 and (got[-1][live[-1]] < BIG).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_sq_lists_plain_matches_jax_mirror_through_gathered_form(seed):
    """Dyadic stats and integer queries: the JAX lax mirror on the
    gathered query rows and code slabs equals the list scan bit for bit
    on live slots."""
    queries, qmat, codes, origins, bounds, vmin, vscale = _sq_case(
        seed, 5, 16, 16, 256, True)
    got = tsq.sq_scan_lists(queries, qmat, codes, origins, bounds, 256,
                            vmin, vscale)
    qv = queries[qmat.long()].float().numpy()
    codes_t = _gathered(codes, origins, 256).transpose(1, 2).numpy()
    ref = np.asarray(jsq.sq_scan_subchunk_min_lax(
        jnp.asarray(qv), jnp.asarray(codes_t), jnp.asarray(bounds.numpy()),
        jnp.asarray(vmin.numpy()), jnp.asarray(vscale.numpy())))
    live = (qmat < queries.shape[0] - 1).numpy()
    np.testing.assert_array_equal(got.numpy()[live], ref[live])


def test_sq_lists_checks_and_cpu_counts_no_launch():
    queries, qmat, codes, origins, bounds, vmin, vscale = _sq_case(
        3, 4, 8, 16, 136, True)
    before = tsq.LAUNCHES
    tsq.sq_scan_lists(queries, qmat, codes, origins, bounds, 136, vmin,
                      vscale)
    assert tsq.LAUNCHES == before
    with pytest.raises(ValueError, match="int8"):
        tsq.sq_scan_lists(queries, qmat, codes.to(torch.bfloat16), origins,
                          bounds, 136, vmin, vscale)
    with pytest.raises(ValueError, match="bfloat16"):
        tsq.sq_scan_lists(queries.float(), qmat, codes, origins, bounds, 136,
                          vmin, vscale)
    with pytest.raises(ValueError, match="int32"):
        tsq.sq_scan_lists(queries, qmat.long(), codes, origins, bounds, 136,
                          vmin, vscale)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsq.sq_scan_lists(queries, qmat, codes, origins, bounds, 130, vmin,
                          vscale)
    with pytest.raises(ValueError, match="vscale"):
        tsq.sq_scan_lists(queries, qmat, codes, origins, bounds, 136, vmin,
                          vscale[:8])
    with pytest.raises(ValueError, match="vmin"):
        tsq.sq_scan_lists(queries, qmat, codes, origins, bounds, 136,
                          vmin.double(), vscale)


def _pq_case(seed, n_lists, q, m, k_codes, l_pad, integer):
    rng = np.random.default_rng(seed)
    n_pairs, n_rows = 30, 3 * l_pad + 5
    luts = (rng.integers(-64, 64, (n_pairs, m * k_codes)).astype(np.float32)
            if integer else
            rng.standard_normal((n_pairs, m * k_codes)).astype(np.float32))
    codes = torch.as_tensor(rng.integers(0, k_codes, (n_rows, m)),
                            dtype=torch.uint8)
    origins, bounds = _windows(rng, n_lists, n_rows, l_pad)
    lut_map = _slot_map(rng, n_lists, q, n_pairs, -1)
    return (torch.as_tensor(luts).to(torch.bfloat16), lut_map, codes,
            origins, bounds)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n_lists,q,m,k_codes,l_pad", [
    (6, 8, 4, 16, 136),
    (5, 13, 3, 256, 264),
    (4, 24, 5, 7, 512),
])
def test_pq_lists_plain_is_the_gathered_form_on_live_slots(
        n_lists, q, m, k_codes, l_pad, integer):
    luts, lut_map, codes, origins, bounds = _pq_case(
        n_lists + q + m, n_lists, q, m, k_codes, l_pad, integer)
    got = tpq.pq_adc_lists(luts, lut_map, codes, origins, bounds, l_pad)
    assert tuple(got.shape) == (n_lists, q, l_pad // 8)
    want = tpq.pq_adc_subchunk_min_plain(
        luts[lut_map.clamp(min=0).long()],
        _gathered(codes, origins, l_pad).transpose(1, 2), bounds)
    live = lut_map >= 0
    assert torch.equal(got[live], want[live])
    assert (got[~live] == BIG).all()
    assert (got[:3] == BIG).all()            # empty lists, no live slot
    out = torch.empty_like(got)
    assert tpq.pq_adc_lists(luts, lut_map, codes, origins, bounds, l_pad,
                            out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_pq_lists_plain_matches_jax_mirror_through_gathered_form(seed):
    luts, lut_map, codes, origins, bounds = _pq_case(
        seed, 5, 16, 4, 16, 256, True)
    got = tpq.pq_adc_lists(luts, lut_map, codes, origins, bounds, 256)
    lg = luts[lut_map.clamp(min=0).long()].float().numpy()
    codes_t = _gathered(codes, origins, 256).transpose(1, 2).numpy()
    ref = np.asarray(jpq.pq_adc_subchunk_min_lax(
        jnp.asarray(lg, jnp.bfloat16), jnp.asarray(codes_t),
        jnp.asarray(bounds.numpy())))
    live = (lut_map >= 0).numpy()
    np.testing.assert_array_equal(got.numpy()[live], ref[live])


def test_pq_lists_checks_and_an_empty_lut():
    luts, lut_map, codes, origins, bounds = _pq_case(4, 4, 8, 4, 16, 136,
                                                     True)
    with pytest.raises(ValueError, match="uint8"):
        tpq.pq_adc_lists(luts, lut_map, codes.to(torch.int8), origins,
                         bounds, 136)
    with pytest.raises(ValueError, match="M\\*K"):
        tpq.pq_adc_lists(luts[:, :63], lut_map, codes, origins, bounds, 136)
    with pytest.raises(ValueError, match="int32"):
        tpq.pq_adc_lists(luts, lut_map, codes, origins.long(), bounds, 136)
    # a chunk without a live pair: no LUT rows, every minimum BIG
    got = tpq.pq_adc_lists(luts[:0], torch.full_like(lut_map, -1), codes,
                           origins, bounds, 136)
    assert (got == BIG).all()


# -- the grouped searches around the list scans --------------------------------

def _int_rows(seed, n=2500, d=16, nq=48):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-60, 60, (8, d))
    x = (centers[rng.integers(0, 8, n)]
         + rng.integers(-6, 7, (n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, nq)]
         + rng.integers(-2, 3, (nq, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def flat_index():
    x, q = _int_rows(11)
    return ivf_flat_build(x, IVFFlatParams(
        n_lists=40, kmeans_n_iters=4, kmeans_init="random"),
        device="cpu"), q


def _gathered_flat_lists(queries, qmat, rows, origins, bounds, l_pad):
    """The flat kernel engine's scan as it ran before the list entry: a
    query-row and slab gather, then one gathered-form scan, per block of
    32 lists."""
    outs = []
    for s in range(0, qmat.shape[0], 32):
        blk = slice(s, s + 32)
        outs.append(tfk.flat_scan_subchunk_min(
            queries[qmat[blk].long()],
            _gathered(rows, origins[blk], l_pad).transpose(1, 2),
            bounds[blk]))
    return torch.cat(outs)


@pytest.mark.parametrize("stream", [None, True])
@pytest.mark.parametrize("qcap", [8, 64])
def test_flat_grouped_kernel_engine_unchanged(flat_index, monkeypatch,
                                              qcap, stream):
    index, q = flat_index
    kw = dict(n_probes=6, qcap=qcap, stream_partials=stream,
              use_kernel=True)
    launches = []
    real = tfk.flat_scan_lists

    def counted(*a):
        launches.append(a[1].shape[0])
        return real(*a)

    monkeypatch.setattr(tfk, "flat_scan_lists", counted)
    d1, i1 = ivf_flat_search_grouped(index, q, 5, **kw)
    # one scan of all 40 lists per batch, or one per streamed 32-list block
    assert launches == ([32, 32] if stream else [40])
    monkeypatch.setattr(tfk, "flat_scan_lists", _gathered_flat_lists)
    d0, i0 = ivf_flat_search_grouped(index, q, 5, **kw)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)


@pytest.fixture(scope="module")
def sq_index():
    x, q = _int_rows(13)
    return ivf_sq_build(x, IVFSQParams(n_lists=40, kmeans_n_iters=4),
                        device="cpu"), q


def _gathered_sq_lists(queries, qmat, codes, origins, bounds, l_pad, vmin,
                       vscale):
    """The SQ kernel engine's scan as it ran before the list entry: a
    query-row and code-slab gather, then one gathered-form scan, per
    block of 32 lists."""
    outs = []
    for s in range(0, qmat.shape[0], 32):
        blk = slice(s, s + 32)
        outs.append(tsq.sq_scan_subchunk_min(
            queries[qmat[blk].long()],
            _gathered(codes, origins[blk], l_pad).transpose(1, 2),
            bounds[blk], vmin, vscale))
    return torch.cat(outs)


@pytest.mark.parametrize("stream", [None, True])
@pytest.mark.parametrize("qcap", [8, 64])
def test_sq_grouped_kernel_engine_unchanged(sq_index, monkeypatch, qcap,
                                            stream):
    index, q = sq_index
    kw = dict(n_probes=6, qcap=qcap, stream_partials=stream,
              use_kernel=True)
    launches = []
    real = tsq.sq_scan_lists

    def counted(*a):
        launches.append(a[1].shape[0])
        return real(*a)

    monkeypatch.setattr(tsq, "sq_scan_lists", counted)
    d1, i1 = ivf_sq_search_grouped(index, q, 5, **kw)
    # one scan of all 40 lists per batch, or one per streamed 32-list block
    assert launches == ([32, 32] if stream else [40])
    monkeypatch.setattr(tsq, "sq_scan_lists", _gathered_sq_lists)
    d0, i0 = ivf_sq_search_grouped(index, q, 5, **kw)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)


@pytest.fixture(scope="module")
def pq_index():
    x, q = _int_rows(12)
    return ivf_pq_build(x, IVFPQParams(
        n_lists=40, pq_dim=4, pq_bits=5, kmeans_n_iters=4,
        pq_kmeans_n_iters=4, kmeans_init="random"), device="cpu"), q


def _block_luts(q_pad, qmat_l, cents, cb, cb_n, lblk, m):
    """The one-hot engine's block of ADC rows, (LB, qcap, M, K) f32 before
    the bf16 cast, in the order the LUT kernel fixes: one rounded f32 op
    a tensor op, the norm and the dot over ascending j."""
    qcap = qmat_l.shape[1]
    ds = q_pad.shape[1] // m
    lb = lblk.shape[0]
    qids = qmat_l[lblk]
    res = (q_pad[qids] - cents[lblk][:, None, :]).reshape(lb, qcap, m, ds)
    res_n = res[..., 0] * res[..., 0]
    dots = res[..., None, 0] * cb[..., 0]
    for j in range(1, ds):
        res_n = res_n + res[..., j] * res[..., j]
        dots = dots + res[..., None, j] * cb[..., j]
    return qids, (res_n[..., None] + cb_n) - 2.0 * dots


def _gathered_pq_lists(luts, lut_map, codes, origins, bounds, l_pad,
                      out=None):
    """The ADC kernel engine's scan as it ran before the list entry: per
    block of 8 lists a dense (8, qcap) LUT gather, a code-slab gather and
    one gathered-form scan."""
    outs = []
    for s in range(0, lut_map.shape[0], 8):
        blk = slice(s, s + 8)
        outs.append(tpq.pq_adc_subchunk_min(
            luts[lut_map[blk].clamp(min=0).long()],
            _gathered(codes, origins[blk], l_pad).transpose(1, 2),
            bounds[blk]))
    res = torch.cat(outs)
    return res if out is None else out.copy_(res)


def test_pair_luts_equal_block_luts_rows_bitwise(pq_index):
    """The kernel engine's live-pair rows equal the one-hot engine's
    block rows bit for bit, and both equal the order written out over
    the block (:func:`_block_luts`)."""
    index, q = pq_index
    rng = np.random.default_rng(5)
    qf = torch.as_tensor(q) + torch.as_tensor(
        rng.standard_normal(q.shape).astype(np.float32))
    cents = index.centroids.float()
    cb, cb_n = tivf_pq._finite_codebooks(index)
    n_lists, qcap, nq = cents.shape[0], 6, qf.shape[0]
    qmat = torch.as_tensor(rng.integers(0, nq + 1, (n_lists, qcap)),
                           dtype=torch.int64)
    q_pad = torch.cat([qf, torch.zeros((1, qf.shape[1]))])
    lblk = torch.arange(n_lists)
    _, lut = _block_luts(q_pad, qmat, cents, cb, cb_n, lblk, index.pq_dim)
    block = tpq.pq_lut_rows(q_pad, cents, cb, cb_n,
                            lblk.repeat_interleave(qcap), qmat.flatten())
    assert torch.equal(
        block, lut.reshape(n_lists * qcap, -1).to(torch.bfloat16))
    live = qmat < nq
    pl, ps = torch.nonzero(live, as_tuple=True)
    got = tpq.pq_lut_rows(qf, cents, cb, cb_n, pl, qmat[pl, ps])
    want = lut[pl, ps].reshape(pl.shape[0], -1).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_lut_chunks_cover_every_list_under_the_budgets():
    cum = np.cumsum([0, 3, 5, 0, 9, 2, 2, 0, 0, 4])
    for max_pairs, max_lists in ((1, 100), (6, 100), (8, 3), (100, 100)):
        chunks = tivf_pq._lut_chunks(cum, max_pairs, max_lists)
        assert chunks[0][0] == 0 and chunks[-1][1] == len(cum)
        assert all(a < b for a, b in chunks)
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(chunks, chunks[1:]))
        for a, b in chunks:
            pairs = cum[b - 1] - (cum[a - 1] if a else 0)
            assert b - a <= max_lists
            assert pairs <= max_pairs or b - a == 1
    assert tivf_pq._lut_chunks(cum, 100, 100) == [(0, 10)]


def test_pair_luts_of_no_pair_is_an_empty_table(pq_index):
    index, q = pq_index
    cb, cb_n = tivf_pq._finite_codebooks(index)
    none = torch.zeros(0, dtype=torch.int64)
    got = tpq.pq_lut_rows(torch.as_tensor(q), index.centroids.float(), cb,
                          cb_n, none, none)
    assert tuple(got.shape) == (0, cb.shape[0] * cb.shape[1])
    assert got.dtype == torch.bfloat16


def _count_pq_launches(monkeypatch):
    launches = []
    real = tpq.pq_adc_lists

    def counted(*a, **k):
        launches.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(tpq, "pq_adc_lists", counted)
    return launches


@pytest.mark.parametrize("stream", [None, True])
@pytest.mark.parametrize("lut_bytes", [None, 4096])
def test_pq_grouped_kernel_engine_unchanged(pq_index, monkeypatch, stream,
                                            lut_bytes):
    """The chunked live-pair pool returns what the per-block pool with
    dense LUTs returned, in one chunk or in many (a 4 KB LUT budget holds
    ~8 pairs at M*K = 128)."""
    index, q = pq_index
    kw = dict(n_probes=5, qcap=16, refine_ratio=3.0, stream_partials=stream,
              use_kernel=True)
    if lut_bytes is not None:
        monkeypatch.setattr(tivf_pq, "_LUT_BLOCK_BYTES", lut_bytes)
    launches = _count_pq_launches(monkeypatch)
    d1, i1 = ivf_pq_search_grouped(index, q, 5, **kw)
    assert sum(m.shape[0] for m in launches) <= 40
    assert all((m >= 0).any() for m in launches)    # no chunk without a pair
    if lut_bytes is None and not stream:
        assert [m.shape[0] for m in launches] == [40]   # one for the batch
    if lut_bytes is not None:
        assert len(launches) > 5
    monkeypatch.setattr(tpq, "pq_adc_lists", _gathered_pq_lists)
    d0, i0 = ivf_pq_search_grouped(index, q, 5, **kw)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)


@pytest.mark.parametrize("stream,lut_bytes,rows", [
    (True, None, [0]),          # streamed 8-list blocks, 3 of 40 probed
    (None, 512, [0, 0]),        # 1 pair a chunk; each probed list holds 2
])
def test_pq_grouped_kernel_engine_skips_chunks_without_pairs(
        pq_index, monkeypatch, stream, lut_bytes, rows):
    """A query probing 3 of 40 lists cuts chunks that hold no live pair
    (whole streamed blocks, or the empty lists before a list past the
    pair budget); they are skipped, and the results are the gathered
    form's."""
    index, q = pq_index
    kw = dict(n_probes=3, qcap=8, refine_ratio=3.0, stream_partials=stream,
              use_kernel=True)
    if lut_bytes is not None:
        monkeypatch.setattr(tivf_pq, "_LUT_BLOCK_BYTES", lut_bytes)
    chunks = []
    real_chunks = tivf_pq._lut_chunks

    def kept_chunks(*a):
        chunks.extend(real_chunks(*a))
        return chunks

    monkeypatch.setattr(tivf_pq, "_lut_chunks", kept_chunks)
    launches = _count_pq_launches(monkeypatch)
    qs = q[rows]
    d1, i1 = ivf_pq_search_grouped(index, qs, 5, **kw)
    assert 0 < len(launches) <= 3 < len(chunks)
    assert all((m >= 0).any() for m in launches)
    monkeypatch.setattr(tpq, "pq_adc_lists", _gathered_pq_lists)
    d0, i0 = ivf_pq_search_grouped(index, qs, 5, **kw)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)
    assert bool(torch.isfinite(d1).all())
