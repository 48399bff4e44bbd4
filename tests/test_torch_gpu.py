"""The PyTorch port's CUDA kernels against their plain versions, on a
Hopper card.

Marked ``gpu``: each test decides inside itself whether a card is
present and skips when none is. The file imports neither JAX nor the
JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from raft_tpu_torch.spatial.ann import flat_kernel as tfk


def _int_case(rng, lb, q, d, l_pad):
    # integers in [-64, 64): exact in bf16, every distance sum exact in f32
    qrows = rng.integers(-64, 64, (lb, q, d)).astype(np.float32)
    slabs_t = rng.integers(-64, 64, (lb, d, l_pad)).astype(np.float32)
    return qrows, slabs_t


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """On a Hopper card: the kernel against its plain version, bitwise on
    integer-exact inputs (ragged, empty and full ranges, odd Q, a ragged
    row tile, a transposed-view slab), within 1e-5 x (qn + yn) on
    Gaussian inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for lb, q, d, l_pad in ((4, 64, 96, 3072), (3, 13, 24, 136)):
        qrows, slabs_t = _int_case(rng, lb, q, d, l_pad)
        bounds = np.asarray(
            [[0, l_pad], [7, 7], [5, l_pad - 11], [1, 9]][:lb], np.int32)
        qt, st = _bf16(qrows).to(dev), _bf16(slabs_t).to(dev)
        bt = torch.as_tensor(bounds, device=dev)
        before = tfk.LAUNCHES
        got = tfk.flat_scan_subchunk_min(qt, st, bt)
        assert tfk.LAUNCHES == before + 1
        want = tfk.flat_scan_subchunk_min_plain(qt, st, bt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        view = tfk.flat_scan_subchunk_min(
            qt, st.transpose(1, 2).contiguous().transpose(1, 2), bt)
        assert torch.equal(view, got)
        qg = torch.randn((lb, q, d), device=dev).to(torch.bfloat16)
        sg = torch.randn((lb, d, l_pad), device=dev).to(torch.bfloat16)
        got = tfk.flat_scan_subchunk_min(qg, sg, bt)
        want = tfk.flat_scan_subchunk_min_plain(qg, sg, bt)
        qn = (qg.float() ** 2).sum(-1)[:, :, None]
        yn = (sg.float() ** 2).sum(1).reshape(lb, 1, -1, 8).amax(-1)
        assert ((got - want).abs() <= 1e-5 * (qn + yn)).all()


def _hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


# (m, n, d): ragged (rows, queries and width off every tile), aligned
_FUSED_SHAPES = ((37, 8192 + 37, 19), (200, 16384, 128))


# phase 1 adds: d = 768 (the wide regime, many feature slices), a width
# off every 8-element grain, m off the bf16 kernel's 128-query tile, and a
# width whose query tile no longer fits shared memory (streamed slices)
_CHUNK_MINS_SHAPES = _FUSED_SHAPES + ((300, 3000, 768), (129, 5000, 20),
                                      (70, 3000, 1000))


def _chunk_mins_routes():
    from raft_tpu_torch.obs import default_registry

    return {c.labels["route"]: c.value for c in
            default_registry().series("knn_chunk_mins_calls_total")}


def _tol(q, yn_max, d):
    # 2 d u (max |y|^2 + 2 |q| max |y|), u = 2^-24: the recursive-summation
    # bound of two f32 sums of d terms in different orders
    qn = q.float().norm(dim=1, keepdim=True)
    return 2 * d * 2.0**-24 * (yn_max + 2 * qn * yn_max ** 0.5)


@pytest.mark.gpu
def test_chunk_mins_kernel_matches_plain_version():
    """On a Hopper card: the phase-1 kernels against their plain
    version, bitwise on integer-exact inputs, for f32 and bf16 storage
    and both compute types (bf16 compute on the tensor cores), with whole
    padded chunks past n, d = 768, a ragged d and m off the query tile;
    on Gaussian inputs with bf16 compute within the f32 summation bound.
    Each call counts one on the route ``chunk_mins_route`` names: wgmma
    up to WGMMA_MAX_D, mma past it (768, 1000), f32 for f32 compute."""
    from raft_tpu_torch.obs import metrics as obs_metrics
    from raft_tpu_torch.spatial import fused_knn as tfk

    dev = _hopper()
    rng = np.random.default_rng(0)
    prev = obs_metrics.set_enabled(True)
    try:
        _check_chunk_mins_shapes(tfk, dev, rng)
    finally:
        obs_metrics.set_enabled(prev)


def _check_chunk_mins_shapes(tfk, dev, rng):
    for m, n, d in _CHUNK_MINS_SHAPES:
        q = torch.as_tensor(rng.integers(-8, 8, (m, d)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(rng.integers(-8, 8, (n, d)), dtype=torch.float32,
                            device=dev)
        npad = -(-n // 2048) * 2048
        for yt in (y, y.to(torch.bfloat16)):
            yn = (yt.float() ** 2).sum(1)
            for cd in (torch.float32, torch.bfloat16):
                before = tfk.LAUNCHES["chunk_mins"]
                routes = _chunk_mins_routes()
                got = tfk.chunk_mins(q, yt, yn, npad, cd)
                assert tfk.LAUNCHES["chunk_mins"] == before + 1
                route = tfk.chunk_mins_route(d, cd)
                assert route == ("f32" if cd == torch.float32 else
                                 "wgmma" if d <= 256 else "mma")
                assert _chunk_mins_routes()[route] == routes.get(route, 0) + 1
                want = tfk.chunk_mins_plain(q, yt, yn, npad, cd)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, n, d, yt.dtype, cd)
                assert (got[:, -(-n // 128):] == tfk.BIG).all()
        qg = torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32,
                             device=dev)
        yg = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                             device=dev)
        for yt in (yg, yg.to(torch.bfloat16)):
            yn = (yt.float() ** 2).sum(1)
            got = tfk.chunk_mins(qg, yt, yn, npad, torch.bfloat16)
            want = tfk.chunk_mins_plain(qg, yt, yn, npad, torch.bfloat16)
            err = (got - want).abs()
            assert (err <= _tol(qg, yn.max().item(), d)).all(), (
                m, n, d, yt.dtype, err.max().item())


# (m, n): m off the 64-query tile (and 1), n off the chunk and off the
# 512- and 256-row resident tiles, with whole padded tiles past n; m = 1000
# is 16 query tiles, so every block's ring of 3-4 stages wraps 4-5 times
_WGMMA_SHAPES = ((1, 3000), (65, 5000 + 77), (203, 9 * 512 + 129),
                 (1000, 2 * 512 + 300))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 96, 100, 128, 160, 256])
def test_chunk_mins_wgmma_route_matches_plain_version(d):
    """On a Hopper card: bf16-compute phase 1 at widths up to WGMMA_MAX_D
    (1 to 4 64-feature blocks, each a template of its own) takes the wgmma
    kernel (the route counter says so, one call each) and matches its
    plain version bitwise on integer-exact inputs and within the f32
    summation bound on Gaussian ones, for f32 and bf16 storage, ragged m
    and n. The mma.sync launcher refuses these widths."""
    from raft_tpu_torch.obs import metrics as obs_metrics
    from raft_tpu_torch.spatial import fused_knn as tfk

    dev = _hopper()
    assert tfk.chunk_mins_route(d, torch.bfloat16) == "wgmma"
    rng = np.random.default_rng(d)
    q = torch.zeros((64, d), device=dev)
    out = torch.empty((64, 1), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = tfk._lib().raft_fused_chunk_mins(
            q.data_ptr(), q.data_ptr(), out.data_ptr(), out.data_ptr(), 64,
            64, d, 1, 0, 1, stream)
    assert err == 1  # cudaErrorInvalidValue, before any launch
    prev = obs_metrics.set_enabled(True)
    try:
        for m, n in _WGMMA_SHAPES:
            npad = -(-n // 2048) * 2048
            f32 = dict(dtype=torch.float32, device=dev)
            ints = [torch.as_tensor(rng.integers(-8, 8, s), **f32)
                    for s in ((m, d), (n, d))]
            gauss = [torch.as_tensor(rng.standard_normal(s), **f32)
                     for s in ((m, d), (n, d))]
            for (q, y), exact in ((ints, True), (gauss, False)):
                for yt in (y, y.to(torch.bfloat16)):
                    yn = (yt.float() ** 2).sum(1)
                    before = _chunk_mins_routes()
                    got = tfk.chunk_mins(q, yt, yn, npad, torch.bfloat16)
                    after = _chunk_mins_routes()
                    assert after["wgmma"] == before.get("wgmma", 0) + 1
                    assert after.get("mma", 0) == before.get("mma", 0)
                    want = tfk.chunk_mins_plain(q, yt, yn, npad,
                                                torch.bfloat16)
                    torch.cuda.synchronize()
                    key = (m, n, d, yt.dtype)
                    if exact:
                        assert torch.equal(got, want), key
                    else:
                        err = (got - want).abs()
                        assert (err <= _tol(q, yn.max().item(), d)).all(), (
                            key, err.max().item())
                    assert (got[:, -(-n // 128):] == tfk.BIG).all(), key
    finally:
        obs_metrics.set_enabled(prev)


@pytest.mark.gpu
def test_rescore_kernel_matches_plain_version():
    """On a Hopper card: the rescore kernel against its plain version,
    bitwise on integer-exact inputs (f32 and bf16 storage, vector and
    scalar row loads, chunk ids past the index)."""
    from raft_tpu_torch.spatial import fused_knn as tfk

    dev = _hopper()
    rng = np.random.default_rng(1)
    for m, n, d in _FUSED_SHAPES:
        q = torch.as_tensor(rng.integers(-8, 8, (m, d)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(rng.integers(-8, 8, (n, d)), dtype=torch.float32,
                            device=dev)
        cids = torch.as_tensor(rng.integers(0, -(-n // 2048) * 16, (m, 24)),
                               dtype=torch.int32, device=dev)
        for yt in (y, y.to(torch.bfloat16)):
            before = tfk.LAUNCHES["rescore_scores"]
            got = tfk.rescore_scores(q, cids, yt)
            assert tfk.LAUNCHES["rescore_scores"] == before + 1
            want = tfk.rescore_scores_plain(q, cids, yt)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, n, d, yt.dtype)


@pytest.mark.gpu
def test_probe_grid_steps_on_the_card():
    """The launch probe runs a phase-1-sized grid and reports a grid the
    card refuses (past the 2**31 - 1 block limit of a 1-D grid); the
    tile is copied by the grid's last block and by no other, at 1 block,
    at a phase-1 grid and at the largest grid the card takes."""
    from raft_tpu_torch.spatial import fused_knn as tfk

    dev = _hopper()
    before = tfk.LAUNCHES["probe_grid_steps"]
    assert tfk.probe_grid_steps(79 * 7824)
    assert tfk.LAUNCHES["probe_grid_steps"] == before + 1
    assert not tfk.probe_grid_steps(2**31)
    assert tfk.LAUNCHES["probe_grid_steps"] == before + 1
    lib = tfk._lib()
    src = torch.arange(1024, dtype=torch.float32, device=dev).reshape(8, 128)
    stream = torch.cuda.current_stream().cuda_stream
    for steps in (1, 79 * 7824, 2**31 - 1):
        dst = torch.zeros_like(src)
        copies = torch.zeros(2, dtype=torch.int64, device=dev)
        assert lib.raft_fused_probe_grid_steps(
            src.data_ptr(), dst.data_ptr(), copies.data_ptr(), steps,
            stream) == 0
        torch.cuda.synchronize()
        # one copying block, and it is the last
        assert copies.tolist() == [1, steps - 1], steps
        assert torch.equal(dst, src), steps
        assert tfk.probe_grid_steps(steps)


def _bounds(l_pad):
    # full, empty, ragged off the 8-row grain, a short run
    return [[0, l_pad], [7, 7], [5, l_pad - 11], [1, 9]]


@pytest.mark.gpu
def test_sq_kernel_matches_plain_version():
    """On a Hopper card: the SQ dequant + scan kernel (the gathered
    entry) against its plain version — bitwise on dyadic affine stats
    with integer queries (the dequant rounds its multiply and add on their own, as the plain
    version does, and every partial sum is exact), within 1e-5 x (qn +
    yn) on generic ones (the tensor cores sum the dot in their own
    order) — at ragged Q and Lpad, with empty and full ranges and a
    transposed-view code slab."""
    from raft_tpu_torch.spatial.ann import sq_kernel as tsq

    dev = _hopper()
    rng = np.random.default_rng(2)
    for lb, q, d, l_pad in ((4, 64, 96, 512), (3, 13, 24, 136),
                            (2, 70, 96, 264)):
        codes = torch.as_tensor(rng.integers(-128, 128, (lb, l_pad, d)),
                                dtype=torch.int8)
        bt = torch.as_tensor(_bounds(l_pad)[:lb], dtype=torch.int32,
                             device=dev)
        for dyadic in (True, False):
            qrows = torch.as_tensor(
                rng.integers(-64, 64, (lb, q, d)) if dyadic
                else rng.standard_normal((lb, q, d)),
                dtype=torch.float32).to(torch.bfloat16)
            if dyadic:
                vmin = torch.as_tensor(rng.integers(-8, 8, d),
                                       dtype=torch.float32)
                vscale = torch.full((d,), 0.5)
            else:
                vmin = torch.as_tensor(rng.standard_normal(d),
                                       dtype=torch.float32)
                vscale = torch.as_tensor(
                    np.abs(rng.standard_normal(d)) / 255.0 + 1e-3,
                    dtype=torch.float32)
            args = (qrows.to(dev), codes.to(dev).transpose(1, 2), bt,
                    vmin.to(dev), vscale.to(dev))
            before = tsq.LAUNCHES
            got = tsq.sq_scan_subchunk_min(*args)
            assert tsq.LAUNCHES == before + 1
            want = tsq.sq_scan_subchunk_min_plain(*args)
            torch.cuda.synchronize()
            if dyadic:
                assert torch.equal(got, want), (lb, q, d, l_pad)
            else:
                assert ((got - want).abs()
                        <= 1e-5 * _sq_norm_scale(*args)).all(), (lb, q, d)
            assert (got[1] == tsq.BIG).all()
            contiguous = tsq.sq_scan_subchunk_min(
                args[0], args[1].contiguous(), *args[2:])
            assert torch.equal(contiguous, got)


def _sq_norm_scale(qrows, codes_t, bounds, vmin, vscale):
    """qn + yn of the gathered SQ scan per (list, slot, sub-chunk): the
    query's squared norm plus the largest squared norm of the
    sub-chunk's dequantized rows."""
    from raft_tpu_torch.spatial.ann import sq_kernel as tsq

    lb, q, d = qrows.shape
    y = tsq._dequant_tile(codes_t, vmin.reshape(1, d, 1),
                          vscale.reshape(1, d, 1)).float()
    qn = (qrows.float() ** 2).sum(-1)[:, :, None]
    return qn + (y ** 2).sum(1).reshape(lb, 1, -1, 8).amax(-1)


@pytest.mark.gpu
def test_pq_kernel_matches_plain_version():
    """On a Hopper card: the ADC kernel against its plain version,
    bitwise on Gaussian LUTs (both add the M entries in ascending m), at
    ragged Q and Lpad, with empty and full ranges, and at an M·K whose
    LUT rows need more than one query tile of shared memory."""
    from raft_tpu_torch.spatial.ann import pq_kernel as tpq

    dev = _hopper()
    rng = np.random.default_rng(3)
    for lb, q, m, k_codes, l_pad in ((4, 24, 24, 256, 512),
                                     (3, 13, 5, 32, 136),
                                     (2, 13, 96, 256, 264),
                                     (1, 40, 3, 7, 520)):
        luts = torch.as_tensor(rng.standard_normal((lb, q, m * k_codes)),
                               dtype=torch.float32).to(torch.bfloat16)
        codes = torch.as_tensor(rng.integers(0, k_codes, (lb, l_pad, m)),
                                dtype=torch.uint8)
        bt = torch.as_tensor(_bounds(l_pad)[:lb], dtype=torch.int32,
                             device=dev)
        args = (luts.to(dev), codes.to(dev).transpose(1, 2), bt)
        before = tpq.LAUNCHES
        got = tpq.pq_adc_subchunk_min(*args)
        assert tpq.LAUNCHES == before + 1
        want = tpq.pq_adc_subchunk_min_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (lb, q, m, k_codes, l_pad)
        if lb > 1:
            assert (got[1] == tpq.BIG).all()
        lib = tpq._lib()
        slots = tpq._slots(q, m, k_codes)
        assert lib.raft_pq_lists_slots(q, m, k_codes) == slots
        assert lib.raft_pq_lists_smem_bytes(slots, m, k_codes) == \
            tpq._smem_bytes(slots, m, k_codes)
    assert tpq._slots(13, 96, 256) < 8           # fewer slots per block


@pytest.mark.gpu
def test_beam_scan_kernel_matches_plain_version():
    """On a Hopper card: the beam-scan kernel against its plain version,
    bitwise on integer, Gaussian and sentinel-padded inputs, with
    bounds narrower than Cpad (ragged, empty, full), at a Cpad over
    several 128-row blocks and a ragged one, at the 16-byte-load width
    and at a width off it."""
    from raft_tpu_torch.spatial.ann import graph_kernel as tgk

    dev = _hopper()
    rng = np.random.default_rng(4)
    for nq, d, n, c_pad in ((4, 96, 2000, 1024), (3, 19, 300, 136),
                            (4, 96, 500, 512)):
        bounds = torch.as_tensor(_bounds(c_pad)[:nq], dtype=torch.int32,
                                 device=dev)
        for integer in (True, False):
            if integer:
                table = rng.integers(-8, 8, (n + 1, d)).astype(np.float32)
                q = rng.integers(-8, 8, (nq, d)).astype(np.float32)
            else:
                table = rng.standard_normal((n + 1, d)).astype(np.float32)
                q = rng.standard_normal((nq, d)).astype(np.float32)
            table[n] = 1e15
            ids = rng.integers(0, n + 1, (nq, c_pad)).astype(np.int32)
            ids[:, -(c_pad // 4):] = n
            args = tuple(torch.as_tensor(a, device=dev)
                         for a in (q, table, ids)) + (bounds,)
            before = tgk.LAUNCHES
            got = tgk.beam_scan_subchunk_min(*args)
            assert tgk.LAUNCHES == before + 1
            want = tgk.beam_scan_subchunk_min_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (nq, d, n, c_pad, integer)
            assert (got[1] == tgk.BIG).all()
    lib = tgk._lib()
    for d in (19, 96, 600, 1752, 1755, 2000):
        assert lib.raft_beam_scan_rows_per_block(d) == tgk.rows_per_block(d)


def _beam_tol(q, table, ids):
    # 2 d u (qn + yn + 2 |q| |y|), u = 2^-24: the recursive-summation
    # bound of the norms and the dot, each summed in two orders
    d = q.shape[1]
    qn = (q.double() ** 2).sum(1)[:, None]
    yn = (table.double() ** 2).sum(1)[ids.long()]
    return 2 * d * 2.0**-24 * (qn + yn + 2 * (qn * yn).sqrt())


@pytest.mark.gpu
def test_beam_scan_score_kernel_matches_plain_version():
    """On a Hopper card: both outputs of the beam scan against
    ``beam_scan_score_plain`` at nq 1 and 4096, Cpad 256 / 1024 and a
    ragged 136, d 96 / 20 / 600, 19 (off the 16-byte load) and 1755 /
    1752 (16-row tiles, the widest the engine routes here), random
    ids with repeats and sentinel ids, n below the table's rows: the
    minima bitwise, the exact distances bitwise on integer inputs and
    within the f32 summation bound on Gaussian ones, +inf exactly at ids
    >= n."""
    from raft_tpu_torch.spatial.ann import graph_kernel as tgk

    dev = _hopper()
    rng = np.random.default_rng(8)
    for nq, d, n, c_pad in ((1, 96, 5000, 1024), (4096, 96, 20000, 1024),
                            (4096, 20, 3000, 256), (1, 600, 2000, 256),
                            (64, 600, 3000, 1024), (3, 19, 300, 136),
                            (2, 1755, 2000, 256), (512, 1752, 3000, 256)):
        bounds = torch.as_tensor(
            (_bounds(c_pad) * nq)[:nq], dtype=torch.int32, device=dev)
        for integer in (True, False):
            if integer:
                table = rng.integers(-8, 8, (n + 1, d)).astype(np.float32)
                q = rng.integers(-8, 8, (nq, d)).astype(np.float32)
            else:
                table = rng.standard_normal((n + 1, d)).astype(np.float32)
                q = rng.standard_normal((nq, d)).astype(np.float32)
            table[n] = 1e15
            ids = rng.integers(0, n + 1, (nq, c_pad)).astype(np.int32)
            ids[:, 5] = ids[:, 4]                        # a repeat
            ids[:, -(c_pad // 4):] = n                   # sentinel padding
            args = tuple(torch.as_tensor(a, device=dev)
                         for a in (q, table, ids)) + (bounds,)
            for cut in (n, n // 2):
                before = tgk.LAUNCHES
                mins, exact = tgk.beam_scan_score(*args, cut)
                assert tgk.LAUNCHES == before + 1
                want_m, want_e = tgk.beam_scan_score_plain(*args, cut)
                torch.cuda.synchronize()
                what = (nq, d, n, c_pad, integer, cut)
                assert torch.equal(mins, want_m), what
                assert torch.equal(mins, tgk.beam_scan_subchunk_min(*args))
                assert torch.equal(torch.isinf(exact), args[2] >= cut), what
                live = args[2] < cut
                if integer:
                    assert torch.equal(exact, want_e), what
                else:
                    err = (exact - want_e).abs()[live].double()
                    tol = _beam_tol(args[0], args[1], args[2])[live]
                    assert (err <= tol).all(), (what, err.max().item())


@pytest.mark.gpu
def test_beam_scan_score_at_the_graph_cell_launch():
    """On a Hopper card: both outputs of the beam scan at the launch of the
    ``sift1m-graph`` cell, Cpad 2,048 (beam 32 x degree 64) at d = 128,
    over 100,000 rows with repeated and sentinel ids, for 64 queries: the
    minima bitwise, the exact distances bitwise on integer inputs and
    within the f32 summation bound on Gaussian ones."""
    from raft_tpu_torch.spatial.ann import graph_kernel as tgk

    dev = _hopper()
    rng = np.random.default_rng(12)
    nq, d, n, c_pad = 64, 128, 100_000, 2048
    bounds = torch.tensor([[0, c_pad]], dtype=torch.int32,
                          device=dev).expand(nq, 2).contiguous()
    for integer in (True, False):
        if integer:
            table = rng.integers(-8, 8, (n + 1, d)).astype(np.float32)
            q = rng.integers(-8, 8, (nq, d)).astype(np.float32)
        else:
            table = rng.standard_normal((n + 1, d)).astype(np.float32)
            q = rng.standard_normal((nq, d)).astype(np.float32)
        table[n] = 1e15
        ids = rng.integers(0, n, (nq, c_pad)).astype(np.int32)
        ids[:, 1::7] = ids[:, ::7][:, :ids[:, 1::7].shape[1]]   # repeats
        ids[:, -300:] = n                                        # sentinels
        args = tuple(torch.as_tensor(a, device=dev)
                     for a in (q, table, ids)) + (bounds, n)
        mins, exact = tgk.beam_scan_score(*args)
        want_m, want_e = tgk.beam_scan_score_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(mins, want_m), integer
        live = args[2] < n
        assert torch.equal(torch.isinf(exact), ~live)
        if integer:
            assert torch.equal(exact, want_e)
        else:
            err = (exact - want_e).abs()[live].double()
            tol = _beam_tol(args[0], args[1], args[2])[live]
            assert (err <= tol).all(), err.max().item()


@pytest.mark.gpu
def test_graph_patch_on_card_equals_plain_version():
    """On a Hopper card: the reachability patch's device form against its
    plain version on the pruned degree-64 graph of 100,000 rows of a
    64-centre mixture at width 128 (the kNN graph at k + 1 = 129 on the
    fused kernels): the adjacency and the patch counts bitwise."""
    from raft_tpu_torch.sparse import knn_graph
    from raft_tpu_torch.spatial import knn as bfk
    from raft_tpu_torch.spatial.ann import graph as tgraph

    dev = _hopper()
    gen = torch.Generator(device=dev).manual_seed(19)
    n, d = 100_000, 128
    centres = 2.0 * torch.randn((64, d), generator=gen, device=dev)
    lab = torch.randint(0, 64, (n,), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev) + centres[lab]
    bfk.SCAN_FALLBACKS = 0
    g = knn_graph(x, 128, symmetrize=True)
    assert bfk.SCAN_FALLBACKS == 0
    nnz = int(g.nnz)
    adj = tgraph._occlusion_prune(x, g.rows[:nnz].long(), g.cols[:nnz].long(),
                                  64, 256)
    entries = np.array([11, 4242, 50000, 99999], np.int32)
    got, got_st = tgraph._patch_reachability(adj, entries, x)
    want, want_st = tgraph._patch_reachability_plain(adj, entries, x)
    assert torch.equal(got, want)
    assert got_st == want_st and got_st["patch_edges"] > n // 2


# (m, n, d, c): d 128 (f32 and bf16 index) and 768 (the wide regime)
_RESCORE_SHAPES = ((300, 20000 + 37, 128, 24), (200, 16384, 128, 48),
                   (96, 6000, 768, 48), (40, 3000, 768, 24))


@pytest.mark.gpu
def test_rescore_pair_inverted_kernel_matches_plain_version():
    """On a Hopper card: the rescore kernel over its inverted pair map
    against its plain version, d 128 and 768, f32 and bf16 storage, c 24
    and 48, skewed ids (one chunk in every query's list, a chunk named by
    more than 32 queries, one by exactly 32) and ids past n: bitwise on
    integer-exact inputs, within the f32 summation bound on Gaussian
    ones."""
    from raft_tpu_torch.spatial import fused_knn as tfk

    dev = _hopper()
    # the group cap of the plan's plain mirror in test_torch_knn.py
    assert tfk._lib().raft_fused_rescore_group() == 32
    rng = np.random.default_rng(9)
    for m, n, d, c in _RESCORE_SHAPES:
        n_chunks = -(-n // 128)
        cids = rng.integers(0, n_chunks, (m, c)).astype(np.int32)
        cids[:, 0] = n_chunks - 1               # every query, the ragged one
        cids[:40, 1] = 3                        # 40 > 32 queries
        cids[40:72, 2] = 4                      # exactly 32
        cids[1, 3] = n_chunks                   # past the index
        cids[2, 4] = n_chunks + 5
        cids = torch.as_tensor(cids, device=dev)
        for integer in (True, False):
            if integer:
                q = torch.as_tensor(rng.integers(-8, 8, (m, d)),
                                    dtype=torch.float32, device=dev)
                y = torch.as_tensor(rng.integers(-8, 8, (n, d)),
                                    dtype=torch.float32, device=dev)
            else:
                q = torch.as_tensor(rng.standard_normal((m, d)),
                                    dtype=torch.float32, device=dev)
                y = torch.as_tensor(rng.standard_normal((n, d)),
                                    dtype=torch.float32, device=dev)
            for yt in (y, y.to(torch.bfloat16)):
                before = tfk.LAUNCHES["rescore_scores"]
                got = tfk.rescore_scores(q, cids, yt)
                assert tfk.LAUNCHES["rescore_scores"] == before + 1
                want = tfk.rescore_scores_plain(q, cids, yt)
                torch.cuda.synchronize()
                what = (m, n, d, c, integer, yt.dtype)
                assert (got[1, 3 * 128:4 * 128] == 0).all(), what
                if integer:
                    assert torch.equal(got, want), what
                else:
                    yn = (yt.float() ** 2).sum(1).max().item()
                    err = (got - want).abs()
                    assert (err <= _tol(q, yn, d)).all(), (
                        what, err.max().item())


@pytest.mark.gpu
def test_graph_search_engines_agree_on_card():
    """A small index built on the card: the kernel engine and the exact
    engine return equal distances and ids up to ties, and the kernel
    engine launches the kernel once per round."""
    from raft_tpu_torch.spatial.ann import GraphParams, graph_build
    from raft_tpu_torch.spatial.ann import graph as tgraph
    from raft_tpu_torch.spatial.ann import graph_kernel as tgk

    dev = _hopper()
    rng = np.random.default_rng(6)
    centres = rng.uniform(-10, 10, (20, 32)).astype(np.float32)
    x = centres[rng.integers(0, 20, 3000)] + rng.standard_normal(
        (3000, 32)).astype(np.float32)
    q = x[rng.integers(0, 3000, 64)] + 0.3 * rng.standard_normal(
        (64, 32)).astype(np.float32)
    index = graph_build(x, GraphParams(degree=16, seed=0),
                        metric="sqeuclidean", device=dev)
    assert index.device.type == "cuda"
    fallbacks = tgraph.ENGINE_FALLBACKS
    before = tgk.LAUNCHES
    dk, ik = tgraph.graph_search(index, q, 10, beam=32, iters=9)
    assert tgk.LAUNCHES == before + 9
    assert tgraph.ENGINE_FALLBACKS == fallbacks
    de, ie = tgraph.graph_search(index, q, 10, beam=32, iters=9,
                                 use_kernel=False)
    assert torch.equal(dk, de)
    d, a, b = de.cpu().numpy(), ie.cpu().numpy(), ik.cpu().numpy()
    for r in range(d.shape[0]):
        start = 0
        for end in range(1, 11):
            if end == 10 or d[r, end] != d[r, start]:
                if end < 10 or start == 0:
                    assert set(a[r, start:end]) == set(b[r, start:end])
                start = end


# qcap 1, 7, 8, 9, 64 and 65 (query tiles of 8, 16, 64 and two of 40),
# at d = 96 and a ragged d
_LIST_QCAPS = (1, 7, 8, 9, 64, 65)


def _list_windows(rng, n_lists, n_rows, l_pad, dev):
    """Windows as the grouped search makes them: lists 0 and 1 empty,
    list 2 full (the whole window), the last list at the storage tail
    (its origin clamped, its range off the 8-row grain), the rest
    ragged."""
    sizes = rng.integers(1, l_pad + 1, n_lists)
    sizes[:2] = 0
    sizes[2] = l_pad
    sizes[-1] = l_pad // 2 + 3
    offsets = rng.integers(0, n_rows - l_pad, n_lists)
    offsets[-1] = n_rows - 1 - sizes[-1]
    origins = np.minimum(offsets, n_rows - l_pad)
    lo = offsets - origins
    bounds = np.stack([lo, lo + sizes], 1)
    return (torch.as_tensor(origins, dtype=torch.int32, device=dev),
            torch.as_tensor(bounds, dtype=torch.int32, device=dev))


def _list_slots(rng, n_lists, q, n_live, dead, dev):
    """Front-packed live slots; list 3 has none, list 2 all of them."""
    occ = rng.integers(0, q + 1, n_lists)
    occ[2], occ[3] = q, 0
    ids = rng.integers(0, n_live, (n_lists, q))
    return torch.as_tensor(
        np.where(np.arange(q)[None, :] < occ[:, None], ids, dead),
        dtype=torch.int32, device=dev)


@pytest.mark.gpu
def test_flat_scan_lists_kernel_matches_plain_version():
    """On a Hopper card: the one-launch list scan against its plain
    version — bitwise on integer-exact inputs, within 1e-5 x (qn + yn)
    on Gaussian ones — at every query-tile width, with dead slots, a
    list without a live slot, empty and full ranges and the clamped tail
    window, at d = 96 (16-byte copies) and a ragged d (plain loads)."""
    dev = _hopper()
    rng = np.random.default_rng(7)
    n_lists, nq, l_pad = 9, 50, 1160          # 3 row groups, a ragged one
    for d in (96, 20):
        n_rows = 4 * l_pad + 3
        origins, bounds = _list_windows(rng, n_lists, n_rows, l_pad, dev)
        for integer in (True, False):
            if integer:
                qr = rng.integers(-64, 64, (nq + 1, d))
                rows = rng.integers(-64, 64, (n_rows, d))
            else:
                qr = rng.standard_normal((nq + 1, d))
                rows = rng.standard_normal((n_rows, d))
            qr[nq] = 0
            qt = torch.as_tensor(qr, dtype=torch.float32,
                                 device=dev).to(torch.bfloat16)
            rt = torch.as_tensor(rows, dtype=torch.float32,
                                 device=dev).to(torch.bfloat16)
            yn_rows = (rt.float() ** 2).sum(1)
            for q in _LIST_QCAPS:
                qmat = _list_slots(rng, n_lists, q, nq, nq, dev)
                args = (qt, qmat, rt, origins, bounds, l_pad)
                before = tfk.LAUNCHES
                got = tfk.flat_scan_lists(*args)
                assert tfk.LAUNCHES == before + 1
                want = tfk.flat_scan_lists_plain(*args)
                torch.cuda.synchronize()
                live = qmat < nq
                assert (got[~live] == tfk.BIG).all(), (d, q)
                assert (got[:2] == tfk.BIG).all() and (got[3] == tfk.BIG).all()
                if integer:
                    assert torch.equal(got, want), (d, q)
                    continue
                qn = (qt.float() ** 2).sum(1)[qmat.long()][:, :, None]
                win = origins.long()[:, None] + torch.arange(l_pad,
                                                             device=dev)
                yn = yn_rows[win].reshape(n_lists, 1, -1, 8).amax(-1)
                err = (got - want).abs()
                assert (err <= 1e-5 * (qn + yn)).all(), (d, q)


def _f32_sum_tol(d, qn, yn):
    # (4 d + 8) u (qn + yn), u = 2^-24: each side's qn, yn and 2 q.y are
    # f32 sums of d terms within d u of their magnitudes in any order
    # (|2 q.y| <= qn + yn), and two more rounded adds; twice that apart
    return (4 * d + 8) * 2.0**-24 * (qn + yn)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [768, 960, 1001, 1536, 2048])
def test_flat_scan_lists_wide_form_matches_plain_version(d):
    """On a Hopper card: the wide form of the list scan (rows streamed in
    256-feature slices) against the plain version — bitwise on
    integer-exact inputs, within the f32 summation bound on Gaussian
    ones — at query tiles of 8 (d >= 960), a full 64 (or the width's
    cap) and a ragged last tile, with dead slots, empty and full ranges
    and the clamped tail window; d = 1001 takes the plain loads and the
    zeroed K padding. At d = 768 an 8-slot tile keeps the resident
    form, which must agree too."""
    dev = _hopper()
    rng = np.random.default_rng(d)
    n_lists, nq, l_pad = 9, 50, 1160
    n_rows = 4 * l_pad + 3
    origins, bounds = _list_windows(rng, n_lists, n_rows, l_pad, dev)
    forms = set()
    for integer in (True, False):
        if integer:
            qr = rng.integers(-64, 64, (nq + 1, d))
            rows = rng.integers(-64, 64, (n_rows, d))
        else:
            qr = rng.standard_normal((nq + 1, d))
            rows = rng.standard_normal((n_rows, d))
        qr[nq] = 0
        qt = torch.as_tensor(qr, dtype=torch.float32,
                             device=dev).to(torch.bfloat16)
        rt = torch.as_tensor(rows, dtype=torch.float32,
                             device=dev).to(torch.bfloat16)
        yn_rows = (rt.float() ** 2).sum(1)
        for q in (8, 64, 65, 201):
            wide, q_tile, _ = tfk.scan_form(d, q)
            forms.add((q, wide, q_tile))
            qmat = _list_slots(rng, n_lists, q, nq, nq, dev)
            args = (qt, qmat, rt, origins, bounds, l_pad)
            got = tfk.flat_scan_lists(*args)
            want = tfk.flat_scan_lists_plain(*args)
            torch.cuda.synchronize()
            live = qmat < nq
            assert (got[~live] == tfk.BIG).all(), (d, q)
            assert (got[:2] == tfk.BIG).all() and (got[3] == tfk.BIG).all()
            if integer:
                assert torch.equal(got, want), (d, q)
                continue
            qn = (qt.float() ** 2).sum(1)[qmat.long()][:, :, None]
            win = origins.long()[:, None] + torch.arange(l_pad, device=dev)
            yn = yn_rows[win].reshape(n_lists, 1, -1, 8).amax(-1)
            fin = got < tfk.BIG
            assert torch.equal(fin, want < tfk.BIG), (d, q)
            err = (got - want).abs()[fin]
            assert (err <= _f32_sum_tol(d, qn, yn).expand_as(got)[fin]).all(), \
                (d, q, float(err.max()))
    # every width past the resident form's stages at 64 slots takes the
    # wide form, and a ragged last tile exists at 65 and 201 slots
    assert all(w for q, w, _ in forms if q >= 64), forms
    assert all(-(-q // t) * t > q for q, _, t in forms if q in (65, 201))


@pytest.mark.gpu
def test_grouped_flat_search_at_960_takes_the_wide_kernel():
    """On a Hopper card, ``use_kernel=None`` at d = 960 runs the kernel
    engine (the wide form), counts its searches under ``form="kernel"``
    and leaves ``ENGINE_FALLBACKS["ivf_flat"]`` where it was; it returns
    the legacy engine's neighbours, their distances within the f32
    summation bound (both engines rescore in f32, in other orders)."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, grouped, ivf_flat_build, ivf_flat_search_grouped,
        search_obs)

    dev = _hopper()
    g = torch.Generator(device=dev).manual_seed(5)
    centres = 3 * torch.randn((16, 960), generator=g, device=dev)
    x = centres[torch.randint(0, 16, (8192,), generator=g, device=dev)]
    x = x + torch.randn(x.shape, generator=g, device=dev)
    q = x[:256] + 0.5 * torch.randn((256, 960), generator=g, device=dev)
    index = ivf_flat_build(x, IVFFlatParams(n_lists=64, seed=0), device=dev)
    fallbacks = grouped.ENGINE_FALLBACKS["ivf_flat"]
    kernel0 = search_obs.scan_forms("ivf_flat", "kernel")
    launches = tfk.LAUNCHES
    qcap = index.warmup(256, k=10, n_probes=8)
    dk, ik = ivf_flat_search_grouped(index, q, 10, n_probes=8, qcap=qcap)
    assert tfk.LAUNCHES == launches + 2
    assert search_obs.scan_forms("ivf_flat", "kernel") == kernel0 + 2
    assert grouped.ENGINE_FALLBACKS["ivf_flat"] == fallbacks
    assert tfk.scan_form(960, qcap)[0]
    dl, il = ivf_flat_search_grouped(index, q, 10, n_probes=8, qcap=qcap,
                                     use_kernel=False)
    torch.cuda.synchronize()
    assert grouped.ENGINE_FALLBACKS["ivf_flat"] == fallbacks
    same = ik == il
    assert same.float().mean() >= 0.99
    qn = (q * q).sum(1)[:, None].expand_as(dk)
    yn = (x * x).sum(1)[ik.clamp(min=0).long()]
    gap = (dk.double() ** 2 - dl.double() ** 2).abs()
    assert (gap <= _f32_sum_tol(960, qn, yn))[same].all()


@pytest.mark.gpu
def test_pq_adc_lists_kernel_matches_plain_version():
    """On a Hopper card: the one-launch ADC list scan against its plain
    version, bitwise on Gaussian and integer LUTs, at every slot count
    per block (S = 1 .. 8), with dead slots, a list without a live slot,
    empty and full ranges and the clamped tail window, at the path's
    (M, K) = (24, 256), a ragged one, and rows wide enough to cut S."""
    from raft_tpu_torch.spatial.ann import pq_kernel as tpq

    dev = _hopper()
    rng = np.random.default_rng(8)
    n_lists, l_pad = 9, 1032                  # 5 code tiles, a ragged one
    n_rows = 4 * l_pad + 3
    origins, bounds = _list_windows(rng, n_lists, n_rows, l_pad, dev)
    for m, k_codes in ((24, 256), (5, 7), (96, 256)):
        codes = torch.as_tensor(rng.integers(0, k_codes, (n_rows, m)),
                                dtype=torch.uint8, device=dev)
        for integer in (True, False):
            n_luts = 60
            luts = (rng.integers(-64, 64, (n_luts, m * k_codes)) if integer
                    else rng.standard_normal((n_luts, m * k_codes)))
            luts = torch.as_tensor(luts, dtype=torch.float32,
                                   device=dev).to(torch.bfloat16)
            for q in _LIST_QCAPS:
                lut_map = _list_slots(rng, n_lists, q, n_luts, -1, dev)
                args = (luts, lut_map, codes, origins, bounds, l_pad)
                before = tpq.LAUNCHES
                got = tpq.pq_adc_lists(*args)
                assert tpq.LAUNCHES == before + 1
                want = tpq.pq_adc_lists_plain(*args)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, k_codes, q, integer)
                assert (got[lut_map < 0] == tpq.BIG).all()
                out = torch.empty_like(got)
                tpq.pq_adc_lists(*args, out=out)
                assert torch.equal(out, got)


def _lut_case(rng, n_pairs, m, k, ds, nq, n_lists, dev):
    """Gaussian queries (the last row the zero pad row), centroids and
    codebooks on ``dev``; pair ids that repeat and name the pad row."""
    d = m * ds
    queries = torch.as_tensor(rng.standard_normal((nq + 1, d)),
                              dtype=torch.float32, device=dev)
    queries[nq] = 0.0
    cents = torch.as_tensor(rng.standard_normal((n_lists, d)),
                            dtype=torch.float32, device=dev)
    cb = torch.as_tensor(rng.standard_normal((m, k, ds)),
                         dtype=torch.float32, device=dev)
    lists = torch.as_tensor(rng.integers(0, n_lists, n_pairs), device=dev)
    qids = torch.as_tensor(rng.integers(0, nq + 1, n_pairs), device=dev)
    return queries, cents, cb, (cb * cb).sum(2), lists, qids


@pytest.mark.gpu
def test_pq_lut_rows_kernel_matches_plain_version():
    """On a Hopper card: the ADC table build against its plain version,
    bitwise on Gaussian inputs (both compute in one fixed f32 order), at
    the DEEP-10M cell's LUT chunk (10,922 pairs, M 24, K 256, ds 4), at
    the CPU test's shapes (ds 1/3/4/8, K 16/256, one pair and a ragged
    count), and at shapes off the register path (ds 9 and 12, K 7); no
    launch for no pair."""
    from raft_tpu_torch.spatial.ann import pq_kernel as tpq

    dev = _hopper()
    rng = np.random.default_rng(22)
    shapes = [(10_922, 24, 256, 4, 10_000, 4096)]
    shapes += [(p, 3 if k == 16 else 2, k, ds, 5, 6)
               for ds in (1, 3, 4, 8) for k in (16, 256) for p in (1, 7)]
    shapes += [(37, 5, 16, 12, 9, 4), (41, 3, 7, 3, 9, 4),
               (29, 2, 256, 9, 9, 4), (1000, 600, 8, 8, 9, 4)]
    for n_pairs, m, k, ds, nq, n_lists in shapes:
        args = _lut_case(rng, n_pairs, m, k, ds, nq, n_lists, dev)
        before = tpq.LUT_LAUNCHES
        got = tpq.pq_lut_rows(*args)
        assert tpq.LUT_LAUNCHES == before + 1
        want = tpq.pq_lut_rows_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (n_pairs, m * k) and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), \
            (n_pairs, m, k, ds)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    before = tpq.LUT_LAUNCHES
    got = tpq.pq_lut_rows(*args[:4], none, none)
    assert got.shape == (0, m * k) and tpq.LUT_LAUNCHES == before


@pytest.mark.gpu
def test_pq_grouped_search_builds_one_lut_a_chunk(monkeypatch):
    """A grouped PQ search at the DEEP-10M cell's parameters (4,096
    lists, M 24, K 256, 32 probes, refine 4, 10,000 queries at the
    warm-up's qcap) over 200,000 mixture rows: one LUT launch for each
    LUT chunk with a live pair, as many as ADC launches, and no engine
    fallback."""
    from raft_tpu_torch.spatial.ann import (
        IVFPQParams, grouped, ivf_pq, ivf_pq_build, ivf_pq_search_grouped,
        pq_kernel as tpq,
    )

    dev = _hopper()
    gen = torch.Generator(device=dev).manual_seed(22)
    centres = 2.0 * torch.randn((64, 96), generator=gen, device=dev)

    def rows(n):
        pick = torch.randint(0, 64, (n,), generator=gen, device=dev)
        return centres[pick] + torch.randn((n, 96), generator=gen,
                                           device=dev)

    x, q = rows(200_000), rows(10_000)
    index = ivf_pq_build(x, IVFPQParams(
        n_lists=4096, pq_dim=24, pq_bits=8, kmeans_n_iters=4,
        pq_kmeans_n_iters=4, kmeans_init="random"), device=dev)
    kw = dict(n_probes=32, refine_ratio=4.0)
    qcap = index.warmup(10_000, k=10, **kw)
    chunks = []
    real = ivf_pq._lut_chunks

    def kept(cum, *a):
        out = real(cum, *a)
        chunks.extend(c for c in out
                      if cum[c[1] - 1] > (cum[c[0] - 1] if c[0] else 0))
        return out

    monkeypatch.setattr(ivf_pq, "_lut_chunks", kept)
    grouped.ENGINE_FALLBACKS["ivf_pq"] = 0
    lut0, adc0 = tpq.LUT_LAUNCHES, tpq.LAUNCHES
    ivf_pq_search_grouped(index, q, 10, qcap=qcap, **kw)
    torch.cuda.synchronize()
    n = tpq.LUT_LAUNCHES - lut0
    assert n == len(chunks) == tpq.LAUNCHES - adc0
    assert n >= -(-10_000 * 32 // ivf_pq._max_lut_pairs(24 * 256))
    assert grouped.ENGINE_FALLBACKS["ivf_pq"] == 0


@pytest.mark.gpu
def test_sq_scan_lists_kernel_matches_plain_version():
    """On a Hopper card: the one-launch IVF-SQ list scan against its
    plain version — bitwise on dyadic stats with integer queries, within
    1e-5 x (qn + yn) on generic stats and Gaussian queries — at every
    query-tile width, with dead slots, a list without a live slot, empty
    and full ranges and the clamped tail window, at d = 96 (16-byte code
    copies) and d = 20 and 24 (plain loads)."""
    from raft_tpu_torch.spatial.ann import sq_kernel as tsq

    dev = _hopper()
    rng = np.random.default_rng(9)
    n_lists, nq, l_pad = 9, 50, 1160
    for d in (96, 20, 24):
        n_rows = 4 * l_pad + 3
        origins, bounds = _list_windows(rng, n_lists, n_rows, l_pad, dev)
        codes = torch.as_tensor(rng.integers(-128, 128, (n_rows, d)),
                                dtype=torch.int8, device=dev)
        for dyadic in (True, False):
            if dyadic:
                qr = rng.integers(-64, 64, (nq + 1, d))
                vmin = rng.integers(-8, 8, d)
                vscale = np.full(d, 0.5)
            else:
                qr = rng.standard_normal((nq + 1, d))
                vmin = rng.standard_normal(d)
                vscale = np.abs(rng.standard_normal(d)) / 255.0 + 1e-3
            qr[nq] = 0
            qt = torch.as_tensor(qr, dtype=torch.float32,
                                 device=dev).to(torch.bfloat16)
            vmin = torch.as_tensor(vmin, dtype=torch.float32, device=dev)
            vscale = torch.as_tensor(vscale, dtype=torch.float32, device=dev)
            y = tsq._dequant_tile(codes, vmin, vscale).float()
            yn_rows = (y ** 2).sum(1)
            for q in _LIST_QCAPS:
                qmat = _list_slots(rng, n_lists, q, nq, nq, dev)
                args = (qt, qmat, codes, origins, bounds, l_pad, vmin, vscale)
                before = tsq.LAUNCHES
                got = tsq.sq_scan_lists(*args)
                assert tsq.LAUNCHES == before + 1
                want = tsq.sq_scan_lists_plain(*args)
                torch.cuda.synchronize()
                live = qmat < nq
                assert (got[~live] == tsq.BIG).all(), (d, q)
                assert (got[:2] == tsq.BIG).all() and (got[3] == tsq.BIG).all()
                if dyadic:
                    assert torch.equal(got, want), (d, q)
                    continue
                qn = (qt.float() ** 2).sum(1)[qmat.long()][:, :, None]
                win = origins.long()[:, None] + torch.arange(l_pad,
                                                             device=dev)
                yn = yn_rows[win].reshape(n_lists, 1, -1, 8).amax(-1)
                err = (got - want).abs()
                assert (err <= 1e-5 * (qn + yn)).all(), (d, q)


# ---------------------------------------------------------------------------
# The open-loop ServingExecutor on the card: events recorded at dispatch,
# pinned copy-back, cancellable event waits
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# spin cycles of torch.cuda._sleep: ~1-2 s on a card clocked near 2 GHz
_SLEEP_CYCLES = 3_000_000_000


@pytest.mark.gpu
def test_executor_demuxes_in_completion_order_on_card():
    """A fast batch, then a batch that holds the executor's stream with
    ``torch.cuda._sleep``: the first future resolves while the second
    batch still runs (its event was recorded at dispatch, so it does not
    wait on later work), and the second resolves after, both right."""
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving import ServingExecutor

    dev = _cuda()
    calls = []

    def dispatch(batch, **_rt):
        calls.append(batch.shape[0])
        if len(calls) == 2:
            torch.cuda._sleep(_SLEEP_CYCLES)
        return batch * 2.0 + 1.0, batch.sum(1)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((4, 8)).astype(np.float32)
    with ServingExecutor(dispatch, (4,), dim=8, flush_age_s=0.0,
                         max_in_flight=4, device=dev,
                         registry=MetricRegistry()) as ex:
        f1 = ex.submit(a)
        f2 = ex.submit(b)
        r1 = f1.result(timeout=60)
        second_pending = not f2.done()
        r2 = f2.result(timeout=120)
        st = ex.stats()
    assert second_pending, "the first batch waited for the second"
    for r, q in ((r1, a), (r2, b)):
        want = torch.as_tensor(q, device=dev)
        assert r[0].tobytes() == (want * 2.0 + 1.0).cpu().numpy().tobytes()
        assert r[1].tobytes() == want.sum(1).cpu().numpy().tobytes()
    assert st.batches == 2 and st.completed == 2
    assert st.stage_p50_ms["dispatch_ready"] < st.stage_p99_ms[
        "dispatch_ready"]


@pytest.mark.gpu
def test_executor_pinned_copy_back_is_bitwise():
    """The pinned copy-back of every output leaf (f32, int32, int64, a
    nested dict) returns the device result bitwise: each request's
    demuxed leaves equal the same function run on that request alone on
    the card and brought back with a plain ``.cpu()``. The function is
    row-wise and exact (integer-valued squared distances, stable sorts),
    so a request's rows do not depend on the batch around them. Staging
    goes through a pinned buffer kept with the batch."""
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving import ServingExecutor

    dev = _cuda()
    rng = np.random.default_rng(1)
    ref = torch.as_tensor(
        rng.integers(-8, 8, (12, 16)).astype(np.float32), device=dev)
    seen = []

    def rows_fn(batch):
        d = ((batch[:, None, :] - ref[None]) ** 2).sum(-1)
        order = torch.argsort(d, dim=1, stable=True)[:, :3]
        return {"d": d, "x": batch * 0.37 + 0.1,
                "i": (order.to(torch.int32), order)}

    def dispatch(batch, **_rt):
        seen.append(batch.device)
        return rows_fn(batch)

    reqs = [rng.integers(-8, 8, (m, 16)).astype(np.float32)
            for m in (1, 3, 8, 2, 5, 7, 16, 4)]
    with ServingExecutor(dispatch, (8, 16), dim=16, device=dev,
                         registry=MetricRegistry()) as ex:
        out = ex._to_host(dispatch(torch.zeros(8, 16, device=dev)))
        assert out.host["d"].is_pinned() and out.host["i"][0].is_pinned()
        staged, pinned = ex._stage_batch(np.ones((8, 16), np.float32))
        assert staged.is_cuda and pinned.is_pinned()
        got = [f.result(timeout=60) for f in [ex.submit(r) for r in reqs]]
        st = ex.stats()
    assert all(dv.type == "cuda" for dv in seen)
    assert st.batches >= 2 and st.completed == len(reqs)
    for r, g in zip(reqs, got):
        want = rows_fn(torch.as_tensor(r, device=dev))
        want = {"d": want["d"].cpu().numpy(), "x": want["x"].cpu().numpy(),
                "i": tuple(t.cpu().numpy() for t in want["i"])}
        assert set(g) == {"d", "x", "i"}
        for gl, wl in ((g["d"], want["d"]), (g["x"], want["x"]),
                       (g["i"][0], want["i"][0]),
                       (g["i"][1], want["i"][1])):
            assert gl.dtype == wl.dtype and gl.shape == wl.shape
            assert gl.tobytes() == wl.tobytes()
        assert g["i"][0].dtype == np.int32 and g["i"][1].dtype == np.int64


@pytest.mark.gpu
def test_interruptible_synchronize_on_event_cancel_and_timeout():
    """``Interruptible.synchronize`` on a CUDA event still pending (a
    spinning stream): a timeout raises RaftTimeoutError, a cancel from
    another thread raises InterruptedException, and once the event is
    done the wait returns."""
    import threading

    from raft_tpu_torch import errors
    from raft_tpu_torch.core.interruptible import (
        InterruptedException,
        Interruptible,
    )

    dev = _cuda()
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        torch.cuda._sleep(_SLEEP_CYCLES)
        ev = torch.cuda.Event()
        ev.record(s)
    with pytest.raises(errors.RaftTimeoutError):
        Interruptible.synchronize(ev, timeout_s=0.05)
    out = {}

    def waiter():
        out["tid"] = threading.get_ident()
        try:
            Interruptible.synchronize({"e": ev}, timeout_s=60.0)
        except InterruptedException:
            out["cancelled"] = not ev.query()

    th = threading.Thread(target=waiter)
    th.start()
    while "tid" not in out:
        pass
    Interruptible.cancel_thread(out["tid"])
    th.join(30.0)
    assert not th.is_alive() and out.get("cancelled")
    Interruptible.synchronize(ev, timeout_s=60.0)
    assert ev.query()


@pytest.mark.gpu
def test_vector_cache_on_card_matches_cpu():
    """The VectorCache's scatters keep the last writer of a slot on the
    card as on the CPU: one put/get/evict sequence with collisions and
    duplicate keys leaves equal state and answers."""
    from raft_tpu_torch.cache import VectorCache

    dev = _cuda()
    rng = np.random.default_rng(4)
    caches = [VectorCache(3, n_sets=4, associativity=2, device=d)
              for d in (torch.device("cpu"), dev)]
    for step in range(60):
        keys = rng.integers(0, 24, int(rng.integers(1, 9))).astype(np.int32)
        op = rng.integers(0, 3)
        vecs = rng.standard_normal((keys.size, 3)).astype(np.float32)
        res = []
        for c in caches:
            if op == 0:
                c.store_vecs(keys, vecs)
            elif op == 1:
                res.append([t.cpu() for t in c.get_vecs(keys)])
            else:
                c.evict(keys)
        if res:
            assert all(torch.equal(a, b) for a, b in zip(*res)), step
        for a, b in zip((caches[0].keys, caches[0].time, caches[0].store),
                        (caches[1].keys, caches[1].time, caches[1].store)):
            assert torch.equal(a, b.cpu()), step


@pytest.mark.gpu
def test_two_level_probe_kernel_engine_on_the_card():
    """The two-level probe's kernel engine on the card (two flat-scan
    launches, no engine fallback) against the same engine's plain
    versions on the CPU, the legacy engine on both, and the legacy
    member stage over the kernel engine's own supers: bitwise on
    integer-exact centroids, supers and queries."""
    from raft_tpu_torch.spatial.ann import coarse, common as cm

    dev = _hopper()
    rng = np.random.default_rng(3)
    hubs = rng.integers(-60, 60, (64, 96))
    cents = (hubs[rng.integers(0, 64, 4096)]
             + rng.integers(-6, 7, (4096, 96))).astype(np.float32)
    q = (cents[rng.integers(0, 4096, 1000)]
         + rng.integers(-3, 4, (1000, 96))).astype(np.float32)
    card = cm.build_coarse_index(torch.as_tensor(cents, device=dev))
    card = dataclasses.replace(card, super_cents=torch.round(
        card.super_cents))
    host = dataclasses.replace(
        card, super_cents=card.super_cents.cpu(),
        member_ids=card.member_ids.cpu(),
        cents_padded=card.cents_padded.cpu())
    S = cm.n_super_probes(8, card.n_super)
    assert card.n_super > S

    def args(c):
        return (c.super_cents, c.member_ids, c.cents_padded, c.n_cents, 8,
                S)

    qt = torch.as_tensor(q, device=dev)
    before, fb = tfk.LAUNCHES, coarse.COARSE_ENGINE_FALLBACKS
    pk, dk = coarse.two_level_probe(qt, *args(card), use_kernel=True)
    torch.cuda.synchronize()
    assert tfk.LAUNCHES == before + 2
    assert coarse.COARSE_ENGINE_FALLBACKS == fb
    pp, dp = coarse.two_level_probe(q, *args(host), use_kernel=True)
    assert torch.equal(dk.cpu(), dp) and torch.equal(pk.cpu(), pp)
    pl, dl = coarse.two_level_probe(qt, *args(card))
    pl_h, dl_h = coarse.two_level_probe(q, *args(host))
    assert torch.equal(dl.cpu(), dl_h) and torch.equal(pl.cpu(), pl_h)
    sup = coarse._super_scan_kernel(qt, card.super_cents, S, 256)
    d_ref, _ = cm.rerank_members(qt, sup, card.member_ids,
                                 card.cents_padded, card.n_cents, 8)
    assert torch.equal(d_ref, dk)
    sup_l, _ = cm.coarse_probe(qt, card.super_cents, S)
    same = (torch.sort(sup, 1).values
            == torch.sort(sup_l, 1).values).all(1)
    assert same.any() and torch.equal(dk[same], dl[same])
    # the result cache's semantic signer takes the index on the card
    from raft_tpu_torch.serving.result_cache import CentroidSigner

    rows = q[:5]
    assert np.array_equal(CentroidSigner.from_coarse(card)(rows),
                          CentroidSigner.from_coarse(host)(rows))


def _moved(obj, dev):
    """A port index (or its nested storage) with every tensor on ``dev``."""
    kw = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif dataclasses.is_dataclass(v):
            v = _moved(v, dev)
        kw[f.name] = v
    return type(obj)(**kw)


@pytest.mark.gpu
def test_mutable_search_kernel_engines_on_the_card():
    """The mutable search of each kind (IVF-Flat, IVF-SQ, IVF-PQ) on the
    card after the same upserts and tombstones as a CPU copy: the kernel
    engine (one launch of its list scan, no engine fallback) equal to the
    same engine's plain versions on the CPU and the legacy engine equal
    to its CPU run, bitwise on integer-exact rows, queries and centroids;
    the kernel engine never returns a dead id and finds every upserted
    row at distance 0; on IVF-Flat and IVF-SQ, whose legacy engine scores
    every probed row exactly, its distances are never below the legacy
    engine's."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, IVFPQParams, IVFSQIndex, grouped, ivf_flat_build,
        ivf_pq_build, mutation, pq_kernel, sq_kernel,
    )

    dev = _hopper()
    cpu = torch.device("cpu")
    rng = np.random.default_rng(5)
    centers = rng.integers(-60, 60, (16, 32))
    x = (centers[rng.integers(0, 16, 4000)]
         + rng.integers(-6, 7, (4000, 32))).clip(-127, 127).astype(
             np.float32)
    q = (x[rng.integers(0, 4000, 256)]
         + rng.integers(-2, 3, (256, 32))).astype(np.float32)
    flat = ivf_flat_build(x, IVFFlatParams(n_lists=32, kmeans_n_iters=4,
                                           kmeans_init="random"),
                          metric="sqeuclidean", device="cpu")
    flat = dataclasses.replace(flat, centroids=torch.round(flat.centroids))
    sq = IVFSQIndex(flat.centroids, flat.data_sorted.to(torch.int8),
                    torch.full((32,), -128.0), torch.ones(32), flat.storage)
    pq = ivf_pq_build(x, IVFPQParams(n_lists=32, pq_dim=8, pq_bits=4,
                                     kmeans_n_iters=4, kmeans_init="random"),
                      device="cpu")
    pq = dataclasses.replace(pq, centroids=torch.round(pq.centroids),
                             codebooks=torch.round(pq.codebooks))
    up_v = (x[rng.integers(0, 4000, 64)]
            + rng.integers(-3, 4, (64, 32))).astype(np.float32)
    up_ids = np.arange(50_000, 50_064, dtype=np.int32)
    dead = rng.choice(4000, 200, replace=False).astype(np.int32)
    dead = np.concatenate([dead, up_ids[:8]])
    checks = ((flat, tfk, "ivf_flat", {}),
              (sq, sq_kernel, "ivf_sq", {}),
              (pq, pq_kernel, "ivf_pq", {"refine_ratio": 4.0}))
    for index, kmod, engine, kw in checks:
        states = {}
        for d in (cpu, dev):
            m = mutation.wrap_mutable(
                index if d == cpu else _moved(index, dev), delta_cap=16)
            m, acc = mutation.upsert(m, up_v, up_ids)
            assert acc.all()
            m, found = mutation.delete(m, dead)
            assert found.all()
            states[d] = m
        qs = np.concatenate([q, up_v[8:]])
        out = {}
        for d, m in states.items():
            for kernel in (True, False):
                before = kmod.LAUNCHES
                fb = grouped.ENGINE_FALLBACKS[engine]
                dist, ids = mutation.mutable_search(
                    m, torch.as_tensor(qs, device=d), 10, n_probes=8,
                    use_kernel=kernel, **kw)
                if d == dev:
                    torch.cuda.synchronize()
                    assert kmod.LAUNCHES == before + (1 if kernel else 0)
                    assert grouped.ENGINE_FALLBACKS[engine] == fb
                out[d.type, kernel] = (dist.cpu(), ids.cpu())
        for kernel in (True, False):
            a, b = out["cuda", kernel], out["cpu", kernel]
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        dk, ik = out["cuda", True]
        dl, _ = out["cuda", False]
        assert not np.isin(ik.numpy(), dead).any()
        assert (dk[q.shape[0]:, 0] == 0).all()
        assert index is pq or (dk >= dl).all()


@pytest.mark.gpu
def test_tier_dispatch_races_flips_into_its_slots():
    """The cold tier's copy-publish install on the card: 50 times, a
    tiered dispatch on the executor's stream is held behind
    ``torch.cuda._sleep`` while the test thread demotes the hot lists
    and promotes others into the same slots; every answer is bitwise the
    one of the membership its snapshot named, and the tiered search runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync would
    fail the batch)."""
    import threading

    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving import ServingExecutor
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build
    from raft_tpu_torch.tier import TieredListStore

    dev = _cuda()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20_000, 32)).astype(np.float32)
    idx = ivf_flat_build(x, IVFFlatParams(n_lists=64, kmeans_n_iters=5),
                         device=dev)
    store = TieredListStore(idx, n_slots=16, registry=MetricRegistry())
    sets = (list(range(16)), list(range(16, 32)))
    q = x[rng.integers(0, x.shape[0], 64)]

    def flip_to(which):
        store.demote(sets[1 - which])
        assert store.promote(sets[which]) == 16
        return store.runtime()["tier"].version

    expected, label = [], {}
    for which in (0, 1):
        label[flip_to(which)] = which
        d, i = store.search(q, 10, n_probes=8, qcap=64, account=False)
        expected.append((d.cpu().numpy(), i.cpu().numpy()))
    assert not np.array_equal(expected[0][1], expected[1][1])

    enqueued = threading.Event()
    seen = []

    def dispatch(batch, tier=None, **_rt):
        seen.append(tier.version)
        torch.cuda._sleep(_SLEEP_CYCLES // 30)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = store.search(batch, 10, n_probes=8, qcap=64,
                               runtime=tier)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        enqueued.set()
        return out

    with ServingExecutor(dispatch, (64,), dim=32, flush_age_s=0.0,
                         device=dev, runtime_provider=store.runtime,
                         stage=store.stage, registry=MetricRegistry()) as ex:
        for it in range(50):
            enqueued.clear()
            fut = ex.submit(q)
            assert enqueued.wait(60)
            label[flip_to(it % 2)] = it % 2     # while the batch waits
            d, i = fut.result(timeout=120)
            want = expected[label[seen[-1]]]
            assert d.tobytes() == want[0].tobytes(), it
            assert i.tobytes() == want[1].tobytes(), it
    assert len(seen) == 50 and len({label[v] for v in seen}) == 2


@pytest.mark.gpu
def test_sharded_search_p8_equals_p1_on_card():
    """Sharded IVF-Flat on one card: P = 8 in-process ranks against the
    same index placed at P = 1, bitwise on integer-exact rows (each list
    is scored by one rank with the same kernel), the flat-scan kernel
    launched once a rank for a batch, on the caller's stream, with no
    engine fallback; a rank that raises reaches the caller."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    from raft_tpu_torch.comms import (
        build_comms, mnmg_ivf_flat_build, mnmg_ivf_flat_search,
        place_index,
    )
    from raft_tpu_torch.spatial.ann import IVFFlatParams, grouped

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(12)
    centers = rng.integers(-60, 60, (16, 32))
    x = (centers[rng.integers(0, 16, 20_000)]
         + rng.integers(-6, 7, (20_000, 32))).astype(np.float32)
    q = torch.as_tensor(x[rng.integers(0, 20_000, 512)]
                        + rng.integers(-2, 3, (512, 32)).astype(np.float32),
                        device=dev)
    c8, c1 = build_comms([dev] * 8), build_comms([dev])
    idx8 = mnmg_ivf_flat_build(c8, x, IVFFlatParams(
        n_lists=64, kmeans_n_iters=4, kmeans_init="random"),
        metric="sqeuclidean")
    idx1 = place_index(c1, idx8)
    grouped.ENGINE_FALLBACKS["ivf_flat"] = 0
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        before = tfk.LAUNCHES
        d8, i8 = mnmg_ivf_flat_search(c8, idx8, q, 10, n_probes=8,
                                      qcap=512)
        launches = tfk.LAUNCHES - before
        d1, i1 = mnmg_ivf_flat_search(c1, idx1, q, 10, n_probes=8,
                                      qcap=512)
    torch.cuda.synchronize()
    assert launches == 8
    assert grouped.ENGINE_FALLBACKS["ivf_flat"] == 0
    assert torch.equal(d8, d1)
    # ids equal up to ties: equal-distance runs hold the same id set, but
    # the run the k-boundary cuts
    d, a, b = (t.cpu().numpy() for t in (d8, i8, i1))
    for r in range(d.shape[0]):
        runs = np.split(np.arange(10), np.flatnonzero(np.diff(d[r])) + 1)
        for run in runs[:-1]:
            assert set(a[r, run]) == set(b[r, run]), r

    def body(ax, x_):
        if ax.get_rank() == 6:
            raise RuntimeError("rank 6 failed")
        return ax.allreduce(x_)

    with pytest.raises(RuntimeError, match="rank 6"):
        c8.run(body, sharded=(torch.ones(8, 4, device=dev),))


@pytest.mark.gpu
def test_sharded_pq_search_p8_equals_p1_on_card():
    """The sharded IVF-PQ engine at P = 8 ranks on one card against the
    same index resharded to P = 1: the ADC kernel (#4) launched once a
    rank on a batch within one LUT chunk, no engine fallback, the
    sentinel list (every unowned probe slot, no rows) read as empty.
    Each rank refines its own top candidates, so at refine 4 the P = 8
    pools are a superset of P = 1's (distances never worse); at a
    saturated pool both refine every probed row: distances bitwise, ids
    equal up to ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    from raft_tpu_torch.comms import (
        build_comms,
        mnmg_ivf_pq_build,
        mnmg_ivf_pq_search,
        place_index,
    )
    from raft_tpu_torch.spatial.ann import IVFPQParams, grouped
    from raft_tpu_torch.spatial.ann import pq_kernel as tpk

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(4)
    centers = rng.uniform(-10, 10, (64, 32)).astype(np.float32)
    x = (centers[rng.integers(0, 64, 40_000)]
         + rng.standard_normal((40_000, 32), dtype=np.float32))
    q = torch.as_tensor(
        x[rng.integers(0, 40_000, 512)]
        + 0.3 * rng.standard_normal((512, 32), dtype=np.float32),
        device=dev)
    c8, c1 = build_comms([dev] * 8), build_comms([dev])
    idx8 = mnmg_ivf_pq_build(c8, x, IVFPQParams(
        n_lists=128, pq_dim=8, kmeans_n_iters=5, kmeans_init="random",
        max_list_cap=512))
    idx1 = place_index(c1, idx8)
    grouped.ENGINE_FALLBACKS["ivf_pq"] = 0
    calls = []
    orig = tpk.pq_adc_lists

    def keep(luts, lut_map, codes, origin, bounds, l_pad, out=None):
        res = orig(luts, lut_map, codes, origin, bounds, l_pad, out=out)
        calls.append((lut_map, bounds, res))
        return res

    tpk.pq_adc_lists = keep
    try:
        before = tpk.LAUNCHES
        d8, i8 = mnmg_ivf_pq_search(c8, idx8, q, 10, n_probes=16,
                                    refine_ratio=4.0, qcap="throughput")
        launches = tpk.LAUNCHES - before
    finally:
        tpk.pq_adc_lists = orig
    d1, i1 = mnmg_ivf_pq_search(c1, idx1, q, 10, n_probes=16,
                                refine_ratio=4.0, qcap="throughput")
    torch.cuda.synchronize()
    assert launches == 8 and len(calls) == 8
    assert grouped.ENGINE_FALLBACKS["ivf_pq"] == 0
    sentinel = idx8.nl_pad - 1
    for lut_map, bounds, res in calls:
        assert int(bounds[sentinel, 1] - bounds[sentinel, 0]) == 0
        assert bool((lut_map[sentinel] >= 0).any())
        assert bool((res[sentinel] >= tpk.BIG).all())
    assert bool((d8 <= d1).all())
    rr = 16 * idx8.max_list / 10 + 1.0
    d8, i8 = mnmg_ivf_pq_search(c8, idx8, q[:128], 10, n_probes=16,
                                refine_ratio=rr, qcap=128)
    d1, i1 = mnmg_ivf_pq_search(c1, idx1, q[:128], 10, n_probes=16,
                                refine_ratio=rr, qcap=128)
    assert torch.equal(d8, d1)
    d, a, b = (t.cpu().numpy() for t in (d8, i8, i1))
    for r in range(d.shape[0]):
        runs = np.split(np.arange(10), np.flatnonzero(np.diff(d[r])) + 1)
        for run in runs[:-1]:
            assert set(a[r, run]) == set(b[r, run]), r


def _hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _ties_ok(d_ref, i_ref, i_got, tol):
    """Every id the reference ranks below its k-th distance by more than
    ``tol`` is in the other answer's row."""
    inner = d_ref < d_ref[:, -1:] - tol
    present = (i_ref[:, :, None] == i_got[:, None, :]).any(-1)
    return bool((present | ~inner).all())


@pytest.mark.gpu
def test_approx_knn_search_on_card_equals_cpu():
    """approx_knn_search on the card (the grouped kernel engine at 1,040
    queries, the per-query path at 24) against the same index searched
    on the CPU: distances within the f32 gram bound, ids up to ties."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, approx_knn_build_index, approx_knn_search,
    )

    dev = _hopper()
    rng = np.random.default_rng(5)
    x = (rng.integers(-20, 20, (20, 32))[rng.integers(0, 20, 20000)]
         + rng.integers(-3, 4, (20000, 32))).astype(np.float32)
    q = (x[rng.integers(0, 20000, 1040)]
         + rng.integers(-2, 3, (1040, 32))).astype(np.float32)
    cpu = approx_knn_build_index(x, IVFFlatParams(n_lists=64,
                                                  kmeans_n_iters=4),
                                 device="cpu")
    card = dataclasses.replace(
        cpu, centroids=cpu.centroids.to(dev),
        data_sorted=cpu.data_sorted.to(dev),
        storage=dataclasses.replace(cpu.storage, **{
            f: getattr(cpu.storage, f).to(dev) for f in (
                "sorted_ids", "list_offsets", "list_index", "list_sizes")}))
    for nq in (24, 1040):
        dc, ic = approx_knn_search(cpu, torch.as_tensor(q[:nq]), 10,
                                   n_probes=8)
        dg, ig = approx_knn_search(card, torch.as_tensor(q[:nq], device=dev),
                                   10, n_probes=8)
        # integer rows: every squared distance is exact on both devices
        assert torch.equal(dg.cpu(), dc)
        assert _ties_ok(dc, ic, ig.cpu(), 0.5)


@pytest.mark.gpu
def test_rbc_knn_query_on_card_equals_cpu():
    """rbc_knn_query on the card against the same index on the CPU, both
    metrics: distances within 1e-5 relative, ids up to ties, the
    certificates equal but at ulp-scale margins."""
    from raft_tpu_torch.spatial.ann import rbc_build_index, rbc_knn_query
    from raft_tpu_torch.spatial.ann.ball_cover import _assemble

    dev = _hopper()
    rng = np.random.default_rng(6)
    hubs = np.deg2rad(rng.uniform([-60, -170], [70, 170], (50, 2)))
    geo = (hubs[rng.integers(0, 50, 20000)]
           + rng.normal(0, 0.02, (20000, 2))).astype(np.float32)
    l2 = (rng.integers(-30, 30, (50, 3))[rng.integers(0, 50, 20000)]
          + rng.integers(-4, 5, (20000, 3))).astype(np.float32)
    for metric, x in (("haversine", geo), ("l2", l2)):
        cpu = rbc_build_index(x, metric=metric, seed=1, device="cpu")
        lab = torch.empty(cpu.storage.n, dtype=torch.int64)
        lab[cpu.storage.sorted_ids.long()] = torch.repeat_interleave(
            torch.arange(cpu.landmarks.shape[0]), cpu.storage.list_sizes)
        card = _assemble(torch.as_tensor(x, device=dev),
                         cpu.landmarks.to(dev), lab.to(dev), metric)
        q = x[rng.integers(0, 20000, 512)]
        dc, ic, ec = rbc_knn_query(cpu, q, 10, n_probes=8)
        dg, ig, eg = rbc_knn_query(card, torch.as_tensor(q, device=dev),
                                   10, n_probes=8)
        torch.testing.assert_close(dg.cpu(), dc, rtol=1e-5, atol=1e-6)
        assert _ties_ok(dc, ic, ig.cpu(), 1e-5 * dc[:, -1:] + 1e-6)
        assert (eg.cpu() != ec).float().mean() <= 0.01


@pytest.mark.gpu
def test_upsert_routing_is_batch_independent_on_card():
    """A list split past its cap shares its centroid with its pieces; on
    the card the GEMM may round the tie apart by batch size, and the
    routing table must hide it: 256 upserts in one batch and in 2 x 128
    leave the same state."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, ivf_flat_build, upsert, wrap_mutable,
    )

    dev = _hopper()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((200, 96)).astype(np.float32)[
        rng.integers(0, 200, 100000)] * 2.0
        + rng.standard_normal((100000, 96)).astype(np.float32))
    index = ivf_flat_build(x, IVFFlatParams(n_lists=128, kmeans_n_iters=4,
                                            max_list_cap=400), device=dev)
    assert index.centroids.shape[0] > 128
    m0 = wrap_mutable(index, delta_cap=64)
    rows = x[rng.integers(0, 100000, 256)] + 0.01 * rng.standard_normal(
        (256, 96)).astype(np.float32)
    ids = np.arange(200000, 200256, dtype=np.int32)
    one, a = upsert(m0, rows, ids)
    two, b = upsert(m0, rows[:128], ids[:128])
    two, c = upsert(two, rows[128:], ids[128:])
    assert a.all() and b.all() and c.all()
    for f in ("vecs", "ids", "live", "counts"):
        assert torch.equal(getattr(one.delta, f), getattr(two.delta, f))
    assert torch.equal(one.row_mask, two.row_mask)


@pytest.mark.gpu
def test_native_host_library_builds_and_loads(monkeypatch):
    """The native host library builds with g++ under the build root, the
    host dendrogram takes it (no fallback counted), and its children,
    deltas and sizes equal the numpy route's."""
    from raft_tpu_torch import native
    from raft_tpu_torch.sparse import hierarchy

    _cuda()
    assert native.available(), "the native host library did not build"
    assert native.lib_path().is_file()
    rng = np.random.default_rng(8)
    n = 500
    src = np.arange(1, n, dtype=np.int32)
    dst = np.array([rng.integers(0, i) for i in range(1, n)], np.int32)
    w = np.sort(rng.random(n - 1).astype(np.float32))
    before = native.NATIVE_FALLBACKS
    monkeypatch.setattr(native, "NATIVE_FALLBACKS", before)
    got = hierarchy.build_dendrogram_host(src, dst, w, n)
    assert native.NATIVE_FALLBACKS == before
    monkeypatch.setattr(native, "available", lambda: False)
    want = hierarchy.build_dendrogram_host(src, dst, w, n)
    assert native.NATIVE_FALLBACKS == before + 1
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_knn_graph_fused_against_scan_on_card():
    """knn_graph at 65,536 rows of width 128 on the fused kernels (#6,
    #7) against its scan-path graph: on integer rows every distance is
    exact, so each row's neighbour distances are equal (ids may differ
    only inside a tie); the MST of the fused graph on the card equals the
    CPU's bitwise, and single linkage on the card gives the CPU's labels
    up to a permutation and its merge distances."""
    from raft_tpu_torch.sparse import knn_graph
    from raft_tpu_torch.sparse.hierarchy import single_linkage
    from raft_tpu_torch.sparse.mst import boruvka_mst
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial import knn as bfk

    dev = _hopper()
    rng = np.random.default_rng(9)
    n, d, k = 65536, 128, 16
    x = (rng.integers(-40, 40, (64, d))[np.repeat(np.arange(64), n // 64)]
         + rng.integers(-3, 4, (n, d))).astype(np.float32)
    xd = torch.as_tensor(x, device=dev)
    before = dict(fz.LAUNCHES)
    bfk.SCAN_FALLBACKS = 0
    fused = knn_graph(xd, k, symmetrize=False)
    assert fz.LAUNCHES["chunk_mins"] > before["chunk_mins"]
    assert fz.LAUNCHES["rescore_scores"] > before["rescore_scores"]
    assert bfk.SCAN_FALLBACKS == 0
    scan = knn_graph(xd, k, symmetrize=False, use_fused=False)
    assert torch.equal(fused.rows, scan.rows)
    assert torch.equal(fused.vals.reshape(n, k).sort(1).values,
                       scan.vals.reshape(n, k).sort(1).values)
    sym = knn_graph(xd, k)
    card = boruvka_mst(sym)
    cpu = boruvka_mst(dataclasses.replace(
        sym, rows=sym.rows.cpu(), cols=sym.cols.cpu(), vals=sym.vals.cpu(),
        nnz=sym.nnz.cpu()))
    for f in ("src", "dst", "weight", "n_edges", "color"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    sub = x[::16]
    a = single_linkage(torch.as_tensor(sub, device=dev), n_clusters=64)
    b = single_linkage(torch.as_tensor(sub), n_clusters=64)
    assert a.labels.device.type == "cuda"
    pairs = set(zip(a.labels.cpu().tolist(), b.labels.tolist()))
    assert len(pairs) == 64
    np.testing.assert_array_equal(np.sort(a.deltas), np.sort(b.deltas))


@pytest.mark.gpu
def test_knn_graph_past_k_128_stays_fused_on_card():
    """knn_graph at 65,536 rows and k = 128 (a query of 129 rows with the
    row itself, past the JAX package's cap of 128) on the fused kernels,
    against its scan-path graph: on integer rows each row's neighbour
    distances are equal."""
    from raft_tpu_torch.sparse import knn_graph
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial import knn as bfk

    dev = _hopper()
    rng = np.random.default_rng(10)
    n, d, k = 65536, 128, 128
    x = (rng.integers(-40, 40, (64, d))[np.repeat(np.arange(64), n // 64)]
         + rng.integers(-3, 4, (n, d))).astype(np.float32)
    xd = torch.as_tensor(x, device=dev)
    before = dict(fz.LAUNCHES)
    bfk.SCAN_FALLBACKS = 0
    fused = knn_graph(xd, k, symmetrize=False)
    assert fz.LAUNCHES["rescore_scores"] > before["rescore_scores"]
    assert bfk.SCAN_FALLBACKS == 0
    scan = knn_graph(xd, k, symmetrize=False, use_fused=False)
    assert torch.equal(fused.rows, scan.rows)
    assert torch.equal(fused.vals.reshape(n, k).sort(1).values,
                       scan.vals.reshape(n, k).sort(1).values)


@pytest.mark.gpu
def test_lanczos_and_partition_on_card_equal_cpu():
    """Lanczos on a CSR Laplacian on the card against the CPU (same v0):
    eigenvalues within 1e-4 relative, 1e-5 absolute; spmv bitwise on an
    integer graph. Then ``partition`` of four blocks on the card and on
    the CPU: on each, every eigenvalue within its Ritz residual plus the
    solver's f32 floor, 10 eps x the spectral scale (``lanczos_solver``'s
    docstring; ~5e-5 here), of the dense Laplacian's f64 ``eigvalsh``,
    and labels the blocks up to a permutation (the k-means draws differ
    by device)."""
    import scipy.sparse as sp

    from raft_tpu_torch.linalg.lanczos import lanczos_solver
    from raft_tpu_torch.sparse import csr_from_scipy
    from raft_tpu_torch.sparse.linalg import spmv
    from raft_tpu_torch.spectral import (
        ClusterSolverConfig, EigenSolverConfig, partition,
    )

    dev = _cuda()
    n = 20000
    rng = np.random.default_rng(10)
    r = np.arange(n)
    ij = np.concatenate([np.stack([r, (r + 1) % n]),
                         rng.integers(0, n, (2, n // 2))], axis=1)
    a = sp.coo_matrix((np.ones(ij.shape[1]), (ij[0], ij[1])), (n, n))
    a = ((a + a.T) > 0).astype(np.float32)
    lap = (sp.diags(np.asarray(a.sum(1)).ravel()) - a).tocsr()
    cc = csr_from_scipy(lap, device="cpu")
    cg = csr_from_scipy(lap, device=dev)
    v = torch.as_tensor(rng.integers(-3, 4, n).astype(np.float32))
    assert torch.equal(spmv(cg, v.to(dev)).cpu(), spmv(cc, v))
    v0 = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    wc, _ = lanczos_solver(lambda u: spmv(cc, u), n, 4, ncv=48, tol=1e-6,
                           v0=v0)
    wg, _ = lanczos_solver(lambda u: spmv(cg, u), n, 4, ncv=48, tol=1e-6,
                           v0=v0.to(dev))
    assert wg.device.type == "cuda"
    torch.testing.assert_close(wg.cpu(), wc, rtol=1e-4, atol=1e-5)

    # four blocks of 1,000 rows, 12 random neighbours a row inside its
    # block, 40 bridges between blocks
    nb, per = 4, 1000
    block = np.repeat(np.arange(nb), per)
    src = np.repeat(np.arange(nb * per), 12)
    dst = block[src] * per + rng.integers(0, per, src.shape[0])
    bridges = rng.integers(0, nb * per, (2, 40))
    ij = np.concatenate([np.stack([src, dst]), bridges], axis=1)
    g = sp.coo_matrix((np.ones(ij.shape[1]), (ij[0], ij[1])),
                      (nb * per, nb * per))
    g = ((g + g.T) > 0).astype(np.float32)
    g.setdiag(0)
    g.eliminate_zeros()
    eig, clu = EigenSolverConfig(n_eig_vecs=nb), ClusterSolverConfig(
        n_clusters=nb)
    info_card, info_cpu = {}, {}
    on_card = partition(csr_from_scipy(g, device=dev), eig, clu,
                        info=info_card)
    on_cpu = partition(csr_from_scipy(g, device="cpu"), eig, clu,
                       info=info_cpu)
    assert on_card.labels.device.type == "cuda"
    dense = g.toarray().astype(np.float64)
    spectrum = np.linalg.eigvalsh(np.diag(dense.sum(1)) - dense)
    want = spectrum[:nb]
    floor = 10 * np.finfo(np.float32).eps * spectrum[-1]
    for res, info in ((on_card, info_card), (on_cpu, info_cpu)):
        got = res.eigenvalues.cpu().double().numpy()
        bound = info["residuals"].cpu().double().numpy() + floor
        assert (np.abs(got - want) <= bound).all(), (got, want, bound)
        labels = res.labels.cpu()
        assert len(set(zip(block.tolist(), labels.tolist()))) == nb


@pytest.mark.gpu
def test_spmv_spmm_repeat_bitwise_on_card():
    """``spmv`` / ``spmm`` on float inputs give the same bits on every
    call on the card (each row summed in its entries' order), and agree
    with the CPU within f32 summation error."""
    import scipy.sparse as sp

    from raft_tpu_torch.sparse import csr_from_scipy
    from raft_tpu_torch.sparse.linalg import spmm, spmv

    dev = _cuda()
    rng = np.random.default_rng(11)
    n = 131072
    rows = np.repeat(np.arange(n), 32)
    a = sp.csr_matrix((rng.standard_normal(rows.shape[0]).astype(np.float32),
                       (rows, rng.integers(0, n, rows.shape[0]))), (n, n))
    cg = csr_from_scipy(a, device=dev)
    v = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=dev)
    xm = torch.as_tensor(rng.standard_normal((n, 8)).astype(np.float32),
                         device=dev)
    y, ym = spmv(cg, v), spmm(cg, xm)
    for _ in range(20):
        assert torch.equal(spmv(cg, v), y)
        assert torch.equal(spmm(cg, xm), ym)
    cc = csr_from_scipy(a, device="cpu")
    torch.testing.assert_close(y.cpu(), spmv(cc, v.cpu()), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(ym.cpu(), spmm(cc, xm.cpu()), rtol=1e-5,
                               atol=1e-5)


# -- C4, sparse kNN, ProfileTrigger, random, stats,
# label, LAP, matrix ---------------------------------------------------------

@pytest.mark.gpu
def test_linkage_stitching_in_scipy_order_on_card():
    """ROADMAP C4's witnesses on the card: merges at 1, 1, 1, 10, 12 and
    {24, 25} cut off at 2 clusters; 0.2, 0.25, 0.3 below distance 1."""
    from raft_tpu_torch.sparse.hierarchy import single_linkage

    dev = _cuda()
    x = torch.tensor([[0.0], [1], [11], [12], [24], [25]], device=dev)
    res = single_linkage(x, n_clusters=2, k=1)
    assert res.deltas.tolist() == [1, 1, 1, 10, 12]
    lab = res.labels.cpu().tolist()
    assert len(set(lab[:4])) == 1 and lab[4] == lab[5] != lab[0]
    x = torch.tensor([[0.0], [0.25], [0.55], [0.75]], device=dev)
    np.testing.assert_allclose(single_linkage(x, n_clusters=2, k=1).deltas,
                               [0.2, 0.25, 0.3], rtol=1e-6)


@pytest.mark.gpu
def test_sparse_knn_routes_on_card():
    """The CSR colblock route, the prebuilt route and the dense route on
    the card against the CPU: on integer entries every squared distance
    is exact, so distances are bitwise and ids equal up to ties; each
    colblock call makes one host read; a repeat call gives the same
    bits."""
    import scipy.sparse as ss

    from raft_tpu_torch.sparse import csr_from_scipy
    from raft_tpu_torch.sparse import distance as td

    dev = _cuda()
    rng = np.random.default_rng(16)

    def rand(m, d, nnz):
        return ss.random(m, d, density=nnz / d, format="csr",
                         dtype=np.float32, random_state=rng,
                         data_rvs=lambda k: rng.integers(1, 5, k).astype(
                             np.float32))

    idx, qry = rand(3000, 50_000, 40), rand(300, 50_000, 40)
    layout = td.sparse_colblock_index_build(idx, col_block=4096,
                                            row_block=1024, device=dev)
    layout_cpu = td.sparse_colblock_index_build(idx, col_block=4096,
                                                row_block=1024, device="cpu")
    qd, qc = csr_from_scipy(qry, device=dev), csr_from_scipy(qry,
                                                             device="cpu")
    idd, idc = csr_from_scipy(idx, device=dev), csr_from_scipy(idx,
                                                               device="cpu")
    for route in ("prebuilt", "colblock"):
        a, b = (layout, layout_cpu) if route == "prebuilt" else (idd, idc)
        before = td.HOST_SYNCS
        dg, ig = td.sparse_brute_force_knn(a, qd, 10, metric="sqeuclidean",
                                           strategy="colblock")
        assert td.HOST_SYNCS == before + 1, route
        dc, ic = td.sparse_brute_force_knn(b, qc, 10, metric="sqeuclidean",
                                           strategy="colblock")
        assert dg.device.type == "cuda"
        assert torch.equal(dg.cpu(), dc), route
        diff = ig.cpu() != ic
        assert torch.equal(dg.cpu()[diff], dc[diff]), route
        d2, i2 = td.sparse_brute_force_knn(a, qd, 10, metric="sqeuclidean",
                                           strategy="colblock")
        assert torch.equal(d2, dg) and torch.equal(i2, ig), route
    # auto -> dense at width 2,048: no host read
    small = csr_from_scipy(rand(2000, 2048, 40), device=dev)
    sq = csr_from_scipy(rand(100, 2048, 40), device=dev)
    before = td.HOST_SYNCS
    dg, _ = td.sparse_brute_force_knn(small, sq, 5, metric="l1")
    assert td.HOST_SYNCS == before
    assert dg.shape == (100, 5) and bool(torch.isfinite(dg).all())


@pytest.mark.gpu
def test_profile_trigger_captures_cuda_kernels(tmp_path):
    """One real capture on the card: the Chrome trace holds the CUDA
    kernels run during the window."""
    import glob
    import json

    from raft_tpu_torch.obs import MetricRegistry, ProfileTrigger

    dev = _cuda()
    reg = MetricRegistry()
    h = reg.histogram("e2e_ms")
    trig = ProfileTrigger(h, threshold_ms=1.0, log_dir=str(tmp_path),
                          consecutive=1, capture_s=0.05, registry=reg)
    x = torch.randn(1024, 1024, device=dev)

    def busy(_s):
        for _ in range(5):
            x @ x
        torch.cuda.synchronize()

    trig._sleep = busy
    h.observe(5.0)
    assert trig.check() == str(tmp_path)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.gpu
def test_random_on_card():
    """The same state gives the same bits on the card; make_blobs'
    round-robin counts are exact and its clusters sit at their centres;
    permute is a permutation."""
    from raft_tpu_torch import random as rr

    dev = _cuda()
    a = rr.normal(rr.RngState(3), (1 << 20,), device=dev)
    b = rr.normal(rr.RngState(3), (1 << 20,), device=dev)
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1) < 0.01
    data, labels = rr.make_blobs(100_000, 16, n_clusters=10,
                                 state=rr.RngState(0), cluster_std=0.5,
                                 device=dev)
    counts = torch.bincount(labels.long())
    assert counts.tolist() == [10_000] * 10
    perm, _ = rr.permute(rr.RngState(1), 50_000, device=dev)
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(50_000, device=dev))


@pytest.mark.gpu
def test_stats_on_card_equal_cpu():
    """Contingency bitwise; ARI, v-measure, silhouette (batched and
    whole) and trustworthiness on the card against the CPU within f32
    summation error (trustworthiness equal on integer rows)."""
    from raft_tpu_torch import stats as ts

    dev = _cuda()
    rng = np.random.default_rng(5)
    truth = torch.as_tensor(rng.integers(0, 8, 3000))
    pred = torch.where(torch.as_tensor(rng.random(3000) < 0.2),
                       torch.as_tensor(rng.integers(0, 8, 3000)), truth)
    assert torch.equal(ts.contingency_matrix(truth.to(dev), pred.to(dev),
                                             8).cpu(),
                       ts.contingency_matrix(truth, pred, 8))
    for name in ("adjusted_rand_index", "v_measure"):
        g = getattr(ts, name)(truth.to(dev), pred.to(dev), 8)
        c = getattr(ts, name)(truth, pred, 8)
        torch.testing.assert_close(g.cpu(), c, rtol=1e-5, atol=1e-6)
    x = torch.as_tensor(rng.integers(-6, 7, (3000, 8)).astype(np.float32))
    x[truth == 1] += 20
    s_g = ts.batched_silhouette_score(x.to(dev), truth.to(dev), 8,
                                      batch_size=1024)
    s_c = ts.silhouette_score(x, truth, 8)
    torch.testing.assert_close(s_g.cpu(), s_c, rtol=1e-5, atol=1e-6)
    emb = x[:, :3]
    assert float(ts.trustworthiness_score(x.to(dev), emb.to(dev), 5,
                                          "sqeuclidean")) == float(
        ts.trustworthiness_score(x, emb, 5, "sqeuclidean"))


@pytest.mark.gpu
def test_lap_label_matrix_on_card():
    """The auction on the card in f64: the objective equals scipy's
    exactly, the batch equals its single solves bitwise, and equals the
    CPU's solves; labels and matrix helpers bitwise the CPU's."""
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch import label as tl
    from raft_tpu_torch import lap as tlap
    from raft_tpu_torch import matrix as tm

    dev = _cuda()
    rng = np.random.default_rng(6)
    costs = rng.integers(0, 1001, (4, 128, 128)).astype(np.float64)
    rows, objs = tlap.solve_lap_batched(torch.as_tensor(costs, device=dev))
    for b in range(4):
        r1, o1 = tlap.solve_lap(torch.as_tensor(costs[b], device=dev))
        assert torch.equal(r1, rows[b]) and torch.equal(o1, objs[b])
        r, c = linear_sum_assignment(costs[b])
        assert float(o1) == costs[b][r, c].sum()
        rc, oc = tlap.solve_lap(torch.as_tensor(costs[b]))
        assert torch.equal(rc, r1.cpu()) and float(oc) == float(o1)
    labels = torch.as_tensor(rng.integers(0, 5000, 200_000))
    b = torch.as_tensor(rng.integers(0, 5000, 200_000))
    assert torch.equal(tl.make_monotonic(labels.to(dev)).cpu(),
                       tl.make_monotonic(labels))
    assert torch.equal(tl.merge_labels(labels.to(dev), b.to(dev)).cpu(),
                       tl.merge_labels(labels, b))
    m = torch.as_tensor(rng.integers(-3, 4, (512, 512)).astype(np.float32))
    for fn in (tm.sort_cols_per_row, tm.argmax, tm.argmin):
        got, want = fn(m.to(dev)), fn(m)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.cpu(), w), fn.__name__


# top_k_smallest's selection kernel at the cells' shapes: the IVF pool of
# 32 probes x 448 sub-chunks with c = 40, the coarse probe over 4,096
# lists, and the brute force's two selections at SIFT-1M's shape
_SELECT_K_SHAPES = ((10_000, 14_336, 40), (10_000, 4096, 32),
                    (10_000, 7824, 48), (10_000, 6144, 10))


_INT_BITS = {torch.float16: torch.int16, torch.float32: torch.int32,
             torch.float64: torch.int64}


def _select_k_rows(kind, rows, n, gen, dev):
    """Rows of one kind: distance-like (positive, a share of them BIG),
    tie-heavy (four distinct values), or the special values (-0.0 and
    0.0, both infinities, both NaN signs, BIG) among a few ties."""
    from raft_tpu_torch.spatial.fused_knn import BIG

    if kind == "distance":
        x = torch.rand((rows, n), generator=gen, device=dev) * 400 + 100
        return torch.where(torch.rand((rows, n), generator=gen, device=dev)
                           < 0.05, BIG, x)
    if kind == "ties":
        return torch.randint(0, 4, (rows, n), generator=gen,
                             device=dev).float()
    neg_nan = torch.tensor([0xffc00000 - 2 ** 32], dtype=torch.int32)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                            float("nan"), BIG, 1.0, 1.0], device=dev)
    special = torch.cat([special, neg_nan.view(torch.float32).to(dev)])
    pick = torch.randint(0, special.numel(), (rows, n), generator=gen,
                         device=dev)
    return special[pick]


def _assert_select_k_bitwise(x, k):
    from raft_tpu_torch.spatial import selection as tsel

    before = tsel.SELECT_K_LAUNCHES
    vals, idx = tsel.top_k_smallest(x, k)
    assert tsel.SELECT_K_LAUNCHES == before + 1
    want_v, want_i = tsel.top_k_smallest_plain(x, k)
    again_v, again_i = tsel.top_k_smallest(x, k)
    torch.cuda.synchronize()
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    assert torch.equal(idx, want_i), tuple(x.shape)
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(again_i, idx)
    assert torch.equal(again_v.view(torch.int32), vals.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _SELECT_K_SHAPES)
def test_select_k_kernel_bitwise_the_sort_at_cell_shapes(shape):
    """On a Hopper card: the selection kernel against the stable-sort
    route at a cell's shape, on distance-like, tie-heavy and special-value
    rows (values' bits and indices), and twice over the same input."""
    dev = _hopper()
    rows, n, k = shape
    gen = torch.Generator(device=dev).manual_seed(n + k)
    for kind in ("distance", "ties", "special"):
        _assert_select_k_bitwise(_select_k_rows(kind, rows, n, gen, dev), k)


@pytest.mark.gpu
def test_select_k_kernel_edges_and_routes_on_card():
    """On a Hopper card: odd row lengths, k = 1 and k = n, the cap on k
    and on the row length, rows off 16-byte alignment, leading batch axes
    and a strided view all take the kernel and equal the sort bit for
    bit; past the caps and in other dtypes the sort runs, counted."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.spatial import selection as tsel

    dev = _hopper()
    gen = torch.Generator(device=dev).manual_seed(7)
    cap_n, cap_k = tsel.SELECT_K_MAX_ROW, tsel.SELECT_K_MAX_K
    for rows, n, k in ((3, 1, 1), (5, 7, 7), (9, 200, 200), (33, 4095, 1),
                       (17, 14_337, 40), (8, 300, 256), (4, cap_n, cap_k),
                       (3, cap_n, 1)):
        for kind in ("distance", "ties", "special"):
            _assert_select_k_bitwise(_select_k_rows(kind, rows, n, gen, dev),
                                     k)
    flat = _select_k_rows("ties", 1, 65 * 64 + 1, gen, dev)[0]
    _assert_select_k_bitwise(flat[1:].view(65, 64), 9)      # misaligned rows
    batch = _select_k_rows("special", 6 * 11, 96, gen, dev)
    _assert_select_k_bitwise(batch.view(6, 11, 96), 10)     # (LB, qcap, L)
    _assert_select_k_bitwise(batch.view(6, 11, 96)[:, :, ::2], 5)
    _assert_select_k_bitwise(batch.t().contiguous().t(), 12)

    def sorts():
        return sum(c.value for c in metrics.default_registry().series(
            "select_k_calls_total") if c.labels == {"route": "sort"})

    prev = metrics.set_enabled(True)
    try:
        before, sorted_before = tsel.SELECT_K_LAUNCHES, sorts()
        x = _select_k_rows("special", 4, 300, gen, dev)
        for arg, k in ((x, cap_k + 1), (x.double(), 5), (x.half(), 5),
                       (torch.randint(-9, 9, (4, 300), device=dev), 5),
                       (_select_k_rows("ties", 2, cap_n + 1, gen, dev), 5)):
            v, i = tsel.top_k_smallest(arg, k)
            wv, wi = tsel.top_k_smallest_plain(arg, k)
            bits = _INT_BITS.get(arg.dtype, arg.dtype)
            assert torch.equal(i, wi)
            assert torch.equal(v.view(bits), wv.view(bits))
        assert tsel.SELECT_K_LAUNCHES == before
        assert sorts() == sorted_before + 5
    finally:
        metrics.set_enabled(prev)


# R at the cells' widths (DEEP-10M 96, SIFT 128, GIST-1M 960) and one off
# the 16-byte loads
_RERANK_WIDTHS = (96, 128, 960, 97)


def _rerank_pool(rng, n, nq, c, l_pad=64):
    """(nq, c * 8) slab positions and their mask as the kernel engines'
    pool gives them (``common.subchunk_pool_rows``): 8-row sub-chunks of
    ragged lists' windows, clamped at the slab's end, so a window
    overhangs into the next list or past the sentinel; a tenth of the
    sub-chunks masked, a tenth of the rows tombstoned, and a few rows at
    or past the sentinel marked valid (the rerank must still refuse
    them)."""
    cuts = np.sort(rng.choice(np.arange(1, n), 40, replace=False))
    offsets = np.concatenate([[0], cuts, [n]])
    sizes = np.diff(offsets)
    # a slab padded a sub-chunk past the sentinel
    rows_pad = max(n + 1, l_pad) + 8
    lists = rng.integers(0, sizes.size, (nq, c))
    chunks = rng.integers(0, l_pad // 8, (nq, c))
    origin = np.minimum(offsets[lists], rows_pad - l_pad)
    # the last list's window clamped at the slab's end, its last chunks
    lists[0, :4] = sizes.size - 1
    origin[0, :4] = rows_pad - l_pad
    chunks[0, :4] = np.arange(l_pad // 8 - 4, l_pad // 8)
    base = origin + 8 * chunks
    rpos = base[:, :, None] + np.arange(8)
    off = offsets[lists][:, :, None]
    valid = ((rpos >= off) & (rpos < off + sizes[lists][:, :, None])
             & (rng.random((nq, c, 1)) < 0.9)
             & (rng.random((nq, c, 8)) < 0.9))
    valid |= rpos >= n
    return (torch.as_tensor(rpos.reshape(nq, c * 8)),
            torch.as_tensor(valid.reshape(nq, c * 8)))


@pytest.mark.gpu
@pytest.mark.parametrize("d", _RERANK_WIDTHS)
def test_rerank_kernel_matches_plain_version(d):
    """On a Hopper card: R (``rerank.rescore_rows_kernel``, one launch)
    against its plain version (``score_l2_candidates`` over the gathered
    rows) — bitwise on integer-valued rows, within the f32 summation
    bound on Gaussian ones — with masked sub-chunks, windows overhanging
    into the next list and past the sentinel, tombstoned rows,
    valid-marked rows at or past the sentinel (+inf), a ragged last
    candidate tile, rows off 16-byte alignment (the 4-byte loads) and a
    batch of one."""
    from raft_tpu_torch.spatial.ann import rerank as rr

    dev = _hopper()
    rng = np.random.default_rng(d)
    n, nq, c = 6000, 37, 40
    rpos, valid = _rerank_pool(rng, n, nq, c)
    rpos, valid = rpos.to(dev), valid.to(dev)
    dead = ~valid | (rpos >= n)
    assert dead.any() and (~dead).any() and (valid & (rpos >= n)).any()
    for integer in (True, False):
        if integer:
            src = rng.integers(-64, 64, (n + 1, d))
            q = rng.integers(-64, 64, (nq, d))
        else:
            src = rng.standard_normal((n + 1, d))
            q = rng.standard_normal((nq, d))
        src[n] = 0
        st = torch.as_tensor(src, dtype=torch.float32, device=dev)
        qt = torch.as_tensor(q, dtype=torch.float32, device=dev)
        before = rr.RERANK_LAUNCHES
        got = rr.rescore_rows_kernel(qt, st, rpos, valid)
        assert rr.RERANK_LAUNCHES == before + 1
        want = rr.rescore_rows_plain(qt, st, rpos, valid)
        torch.cuda.synchronize()
        assert torch.isinf(got[dead]).all() and torch.isinf(want[dead]).all()
        if not integer:
            qn = (qt * qt).sum(1)[:, None]
            yn = (st * st).sum(1)[torch.clamp(rpos, 0, n)]
            err = (got - want).abs()[~dead]
            assert (err <= _f32_sum_tol(d, qn, yn)[~dead]).all(), \
                float(err.max())
            continue
        assert torch.equal(got, want), d
        buf = torch.zeros((n + 1) * d + 1, device=dev)
        skew = buf[1:].view(n + 1, d)
        skew.copy_(st)
        assert torch.equal(rr.rescore_rows_kernel(qt, skew, rpos, valid),
                           want)
        one = rr.rescore_rows_kernel(qt[3:4], st, rpos[3:4, :100],
                                     valid[3:4, :100])
        assert torch.equal(one, want[3:4, :100])


@pytest.mark.gpu
@pytest.mark.parametrize("less", [0, 1])
def test_rerank_kernel_at_its_widest_rows(less):
    """On a Hopper card: R at the widest rows the route admits
    (``RERANK_MAX_D``, 16-byte loads, and one less, 4-byte loads), whose
    query row and norm pass the 48 KB of shared memory a block has by
    default: the route takes them, and the kernel launches and gives its
    plain version's bits on integer-valued rows (every sum under 2^24)."""
    from raft_tpu_torch.spatial.ann import rerank as rr

    dev = _hopper()
    d = rr.RERANK_MAX_D - less
    rng = np.random.default_rng(d)
    n, nq, c = 700, 5, 24
    rpos, valid = _rerank_pool(rng, n, nq, c)
    rpos, valid = rpos.to(dev), valid.to(dev)
    src = torch.as_tensor(rng.integers(-16, 17, (n + 1, d)),
                          dtype=torch.float32, device=dev)
    src[n] = 0
    qt = torch.as_tensor(rng.integers(-16, 17, (nq, d)), dtype=torch.float32,
                         device=dev)
    assert rr.rerank_kernel_fits(qt, src)
    before = rr.RERANK_LAUNCHES
    got = rr.rescore_rows_kernel(qt, src, rpos, valid)
    want = rr.rescore_rows_plain(qt, src, rpos, valid)
    torch.cuda.synchronize()
    assert rr.RERANK_LAUNCHES == before + 1
    assert torch.isfinite(want).any()
    assert torch.equal(got, want), d


def _ids_up_to_ties(dists, i0, i1):
    """ids equal except inside equal-distance runs, where each interior
    run holds the same id set (the run cut by the k-th place is checked
    by distance alone): the grouped tests' rule."""
    dists, i0, i1 = dists.cpu(), i0.cpu(), i1.cpu()
    for r in range(dists.shape[0]):
        start, k = 0, dists.shape[1]
        for end in range(1, k + 1):
            if end == k or dists[r, end] != dists[r, start]:
                if end < k or start == 0:
                    assert set(i0[r, start:end].tolist()) == \
                        set(i1[r, start:end].tolist()), r
                start = end


def _reranks(engine):
    from raft_tpu_torch.obs import default_registry

    return {c.labels["route"]: c.value
            for c in default_registry().series("ivf_rerank_calls_total")
            if c.labels["engine"] == engine}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 960])
def test_grouped_search_rerank_routes_agree_on_card(d, monkeypatch):
    """On a Hopper card, a DEEP-like (d = 96: IVF-Flat and IVF-PQ with its
    stored rows) and a GIST-like (d = 960: IVF-Flat) grouped search of
    integer-valued rows rerank by R, one launch a search counted under
    ``route="kernel"``, and return what the gather route returns (the
    rule forced off): the distances bit for bit, the ids up to ties."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, IVFPQParams, ivf_flat_build, ivf_flat_search_grouped,
        ivf_pq_build, ivf_pq_search_grouped)
    from raft_tpu_torch.spatial.ann import rerank as rr

    dev = _hopper()
    g = torch.Generator(device=dev).manual_seed(d)
    centres = torch.randint(-6, 7, (16, d), generator=g, device=dev).float()
    x = centres[torch.randint(0, 16, (8192,), generator=g, device=dev)]
    x = x + torch.randint(-3, 4, x.shape, generator=g, device=dev).float()
    q = x[:256] + torch.randint(-2, 3, (256, d), generator=g,
                                device=dev).float()
    searches = {"ivf_flat": functools.partial(
        ivf_flat_search_grouped,
        ivf_flat_build(x, IVFFlatParams(n_lists=64, seed=0), device=dev),
        q, 10, n_probes=8, qcap=64)}
    if d == 96:
        pq = ivf_pq_build(x, IVFPQParams(n_lists=64, pq_dim=24, pq_bits=8),
                          device=dev)
        searches["ivf_pq"] = functools.partial(
            ivf_pq_search_grouped, pq, q, 10, n_probes=8, qcap=64,
            refine_ratio=4.0)
    for engine, search in searches.items():
        routes, launches = _reranks(engine), rr.RERANK_LAUNCHES
        dk, ik = search()
        torch.cuda.synchronize()
        assert rr.RERANK_LAUNCHES == launches + 1, engine
        after = _reranks(engine)
        assert after["kernel"] == routes.get("kernel", 0) + 1
        assert after.get("gather", 0) == routes.get("gather", 0)
        with monkeypatch.context() as m:
            m.setattr(rr, "rerank_kernel_fits", lambda qf, src: False)
            dg, ig = search()
        torch.cuda.synchronize()
        assert rr.RERANK_LAUNCHES == launches + 1
        assert _reranks(engine)["gather"] == after.get("gather", 0) + 1
        assert torch.equal(dk, dg), engine
        _ids_up_to_ties(dk, ik, ig)
