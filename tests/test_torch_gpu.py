"""The PyTorch port's CUDA kernels against their plain versions, on a
Hopper card.

Marked ``gpu``: each test decides inside itself whether a card is
present and skips when none is. The file imports neither JAX nor the
JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

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
    on Gaussian inputs with bf16 compute within the f32 summation bound."""
    from raft_tpu_torch.spatial import fused_knn as tfk

    dev = _hopper()
    rng = np.random.default_rng(0)
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
                got = tfk.chunk_mins(q, yt, yn, npad, cd)
                assert tfk.LAUNCHES["chunk_mins"] == before + 1
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
    from raft_tpu_torch.spatial.ann import common as cm

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
    before, fb = tfk.LAUNCHES, cm.COARSE_ENGINE_FALLBACKS
    pk, dk = cm.two_level_probe(qt, *args(card), use_kernel=True)
    torch.cuda.synchronize()
    assert tfk.LAUNCHES == before + 2
    assert cm.COARSE_ENGINE_FALLBACKS == fb
    pp, dp = cm.two_level_probe(q, *args(host), use_kernel=True)
    assert torch.equal(dk.cpu(), dp) and torch.equal(pk.cpu(), pp)
    pl, dl = cm.two_level_probe(qt, *args(card))
    pl_h, dl_h = cm.two_level_probe(q, *args(host))
    assert torch.equal(dl.cpu(), dl_h) and torch.equal(pl.cpu(), pl_h)
    sup = cm._super_scan_kernel(qt, card.super_cents, S, 256)
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
        IVFFlatParams, IVFPQParams, IVFSQIndex, ivf_flat_build,
        ivf_pq_build, ivf_pq as tpq_ivf, ivf_sq as tsq_ivf,
        ivf_flat as tflat_ivf, mutation, pq_kernel, sq_kernel,
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
    checks = ((flat, tfk, tflat_ivf, {}),
              (sq, sq_kernel, tsq_ivf, {}),
              (pq, pq_kernel, tpq_ivf, {"refine_ratio": 4.0}))
    for index, kmod, imod, kw in checks:
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
                before, fb = kmod.LAUNCHES, imod.ENGINE_FALLBACKS
                dist, ids = mutation.mutable_search(
                    m, torch.as_tensor(qs, device=d), 10, n_probes=8,
                    use_kernel=kernel, **kw)
                if d == dev:
                    torch.cuda.synchronize()
                    assert kmod.LAUNCHES == before + (1 if kernel else 0)
                    assert imod.ENGINE_FALLBACKS == fb
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
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat

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
    ivf_flat.ENGINE_FALLBACKS = 0
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
    assert ivf_flat.ENGINE_FALLBACKS == 0
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
    from raft_tpu_torch.spatial.ann import IVFPQParams, ivf_pq
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
    ivf_pq.ENGINE_FALLBACKS = 0
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
    assert ivf_pq.ENGINE_FALLBACKS == 0
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
