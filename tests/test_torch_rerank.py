"""The exact rerank's route and sources, on the CPU
(raft_tpu_torch.spatial.ann.rerank and grouped._rerank).

Which route a rerank takes is decided by the engine's source (its f32
rows, or None) and, for a source, by its device, dtype, contiguity and
width alone (:func:`rerank_kernel_fits`); each rerank is counted in
``ivf_rerank_calls_total{engine,route}``. Every CPU search gathers; the
gather route is held here to the plain version
(:func:`rescore_rows_plain`), and forcing the rule, with the kernel stood
in by its plain version, walks the kernel route's Python around the
launch, which must give the gather route's answers. The kernel itself is
held to the plain version on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from raft_tpu_torch.obs import default_registry
from raft_tpu_torch.spatial.ann import common, grouped
from raft_tpu_torch.spatial.ann import rerank as rr

MAX_D = rr.RERANK_MAX_D


def _like(shape, dtype=torch.float32, device="cuda", contiguous=True):
    """Stands in for a tensor: what the route reads of it."""
    return types.SimpleNamespace(
        device=torch.device(device), dtype=dtype, shape=torch.Size(shape),
        dim=lambda: len(shape), is_contiguous=lambda: contiguous)


Q = _like((10_000, 96))


@pytest.mark.parametrize("q,src,fits", [
    (Q, _like((10_000_001, 96)), True),               # DEEP-10M
    (_like((10_000, 960)), _like((1_000_001, 960)), True),   # GIST-1M
    (_like((5, 128)), _like((9, 128)), True),
    (_like((5, 97)), _like((9, 97)), True),          # the 4-byte loads
    (_like((5, 1)), _like((9, 1)), True),
    (_like((5, MAX_D)), _like((9, MAX_D)), True),    # the cap
    (_like((5, MAX_D + 1)), _like((9, MAX_D + 1)), False),
    (_like((5, 0)), _like((9, 0)), False),
    (Q, None, False),                                # no source
    (Q, _like((9, 96), torch.float64), False),
    (Q, _like((9, 96), torch.bfloat16), False),
    (Q, _like((9, 96), torch.int8), False),          # SQ codes
    (_like((5, 96), torch.float64), _like((9, 96)), False),
    (Q, _like((9, 96), contiguous=False), False),
    (Q, _like((9, 4, 24)), False),
    (Q, _like((9, 96), device="cpu"), False),
    (Q, _like((9, 96), device="meta"), False),
])
def test_route_follows_device_dtype_contiguity_and_width(q, src, fits,
                                                         monkeypatch):
    monkeypatch.setattr(rr, "hopper_device", lambda dev: True)
    assert rr.rerank_kernel_fits(q, src) is fits


def test_route_needs_a_capability_9_card(monkeypatch):
    monkeypatch.setattr(rr, "hopper_device", lambda dev: False)
    assert rr.rerank_kernel_fits(Q, _like((9, 96))) is False


def _rows(rng, n, d, nq):
    """Integer-valued (n + 1, d) rows, the sentinel zero row last, and
    (nq, d) queries: every f32 sum exact."""
    src = rng.integers(-16, 17, (n + 1, d)).astype(np.float32)
    src[n] = 0
    return (torch.as_tensor(src),
            torch.as_tensor(rng.integers(-16, 17, (nq, d)).astype(
                np.float32)))


def _pool(rng, nq, c, n):
    """(nq, c * 8) positions of 8-row sub-chunks (some running past the
    sentinel, as a window's tail does) and a mask with holes."""
    base = rng.integers(0, n + 8, (nq, c)) // 8 * 8
    rpos = (base[:, :, None] + np.arange(8)).reshape(nq, c * 8)
    valid = rng.random((nq, c * 8)) < 0.8
    return torch.as_tensor(rpos), torch.as_tensor(valid)


@pytest.mark.parametrize("d", [96, 97, 960])
def test_plain_version_is_the_gathered_score(d):
    """``rescore_rows_plain`` is ``score_l2_candidates`` over the gathered
    rows: +inf where masked and at or past the sentinel."""
    rng = np.random.default_rng(d)
    n, nq = 203, 6
    src, qf = _rows(rng, n, d, nq)
    rpos, valid = _pool(rng, nq, 5, n)
    got = rr.rescore_rows_plain(qf, src, rpos, valid)
    want = common.score_l2_candidates(
        qf, src[torch.clamp(rpos, 0, n)], valid & (rpos < n))
    assert torch.equal(got, want)
    assert torch.isinf(got[~valid | (rpos >= n)]).all()
    assert torch.isfinite(got[valid & (rpos < n)]).all()


def test_plain_version_checks_its_shapes():
    src, qf = _rows(np.random.default_rng(0), 20, 8, 3)
    rpos, valid = _pool(np.random.default_rng(1), 3, 2, 20)
    for fn in (rr.rescore_rows_plain, rr.rescore_rows_kernel):
        with pytest.raises(ValueError, match="width"):
            fn(qf[:, :4], src, rpos, valid)
        with pytest.raises(ValueError, match="mask"):
            fn(qf, src, rpos, valid[:, :3])
        with pytest.raises(ValueError, match="sentinel"):
            fn(qf, src[:0], rpos, valid)
    with pytest.raises(ValueError, match="capability-9.0"):
        rr.rescore_rows_kernel(qf, src, rpos, valid)


def _indexes():
    """Small CPU indexes of integer-valued rows: IVF-Flat, IVF-SQ on its
    rows' int8 codes, IVF-PQ with and without its raw rows."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, IVFPQParams, IVFSQIndex, ivf_flat_build,
        ivf_pq_build)

    rng = np.random.default_rng(7)
    centres = rng.integers(-40, 40, (8, 16))
    x = (centres[rng.integers(0, 8, 1500)]
         + rng.integers(-4, 5, (1500, 16))).astype(np.float32)
    q = (x[rng.integers(0, 1500, 40)]
         + rng.integers(-2, 3, (40, 16))).astype(np.float32)
    flat = ivf_flat_build(x, IVFFlatParams(n_lists=16, kmeans_n_iters=4,
                                           kmeans_init="random"),
                          device="cpu")
    flat = dataclasses.replace(flat, centroids=torch.round(flat.centroids))
    sq = IVFSQIndex(flat.centroids, flat.data_sorted.to(torch.int8),
                    torch.full((16,), -128.0), torch.ones(16), flat.storage)
    params = IVFPQParams(n_lists=16, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
                         kmeans_init="random")
    pq = ivf_pq_build(x, params, device="cpu")
    pq_bare = ivf_pq_build(x, dataclasses.replace(params, store_raw=False),
                           device="cpu")
    return flat, sq, pq, pq_bare, x, torch.as_tensor(q)


def test_each_engine_names_its_source():
    """IVF-Flat reads its list-sorted rows, IVF-PQ its stored rows, and
    neither IVF-SQ (int8 codes) nor IVF-PQ without them (a caller's
    dataset, by original id) gives a source."""
    from raft_tpu_torch.spatial.ann.ivf_pq import PQEngine
    from raft_tpu_torch.spatial.ann.ivf_sq import SQEngine

    flat, sq, pq, pq_bare, x, _ = _indexes()
    assert grouped.FlatEngine.of(flat, True, 64).rerank_source() \
        is flat.data_sorted
    assert SQEngine.of(sq, True, 64).rerank_source() is None
    assert PQEngine.of(pq, True, ratio=4.0).rerank_source() \
        is pq.vectors_sorted
    bare = PQEngine.of(pq_bare, True, ratio=4.0, refine_dataset=x)
    assert bare.rescore and bare.rerank_source() is None
    assert pq.vectors_sorted.shape[0] == pq.storage.n + 1
    assert flat.data_sorted.shape[0] == flat.storage.n + 1


def _reranks():
    return {(c.labels["engine"], c.labels["route"]): c.value
            for c in default_registry().series("ivf_rerank_calls_total")}


def _searches(flat, sq, pq, pq_bare, x, q):
    """One search of every engine that reranks: the kernel forms of
    IVF-Flat, IVF-SQ and IVF-PQ (stored rows and a caller's dataset),
    and IVF-PQ's legacy refine."""
    from raft_tpu_torch.spatial.ann import (
        ivf_flat_search_grouped, ivf_pq_search_grouped)
    from raft_tpu_torch.spatial.ann.ivf_sq import ivf_sq_search_grouped

    kw = {"n_probes": 4, "qcap": 40}
    return {
        ("ivf_flat", True): ivf_flat_search_grouped(
            flat, q, 10, use_kernel=True, **kw),
        ("ivf_sq", True): ivf_sq_search_grouped(
            sq, q, 10, use_kernel=True, **kw),
        ("ivf_pq", True): ivf_pq_search_grouped(
            pq, q, 10, use_kernel=True, refine_ratio=4.0, **kw),
        ("ivf_pq_bare", True): ivf_pq_search_grouped(
            pq_bare, q, 10, use_kernel=True, refine_ratio=4.0,
            refine_dataset=x, **kw),
        ("ivf_pq", False): ivf_pq_search_grouped(
            pq, q, 10, use_kernel=False, refine_ratio=4.0, **kw),
    }


def _plain_kernel(monkeypatch):
    """Stand the kernel in by its plain version; returns the list of the
    stand-in's calls (their row sources)."""
    calls = []

    def plain(qf, src, rpos, valid):
        calls.append(src)
        return rr.rescore_rows_plain(qf, src, rpos, valid)

    monkeypatch.setattr(rr, "rescore_rows_kernel", plain)
    return calls


def test_searches_count_each_rerank_by_route(monkeypatch):
    """On the CPU every rerank gathers. With the rule forced and the
    kernel stood in by its plain version, the engines with a source
    (IVF-Flat, IVF-PQ with its rows, in both forms) take the kernel route,
    one call a search over that source, and give the gather route's
    answers bit for bit; IVF-SQ and IVF-PQ without its rows still gather.
    Nothing launches."""
    idx = _indexes()
    before = _reranks()
    gathered = _searches(*idx)
    mid = _reranks()
    counts = {"ivf_flat": 1, "ivf_sq": 1, "ivf_pq": 3}
    for engine, n in counts.items():
        assert mid.get((engine, "gather"), 0) == \
            before.get((engine, "gather"), 0) + n
        assert mid.get((engine, "kernel"), 0) == \
            before.get((engine, "kernel"), 0)
    seen = []

    def fits(qf, src):
        seen.append(src is not None)
        return src is not None

    monkeypatch.setattr(rr, "rerank_kernel_fits", fits)
    calls = _plain_kernel(monkeypatch)
    launches = rr.RERANK_LAUNCHES
    forced = _searches(*idx)
    after = _reranks()
    assert rr.RERANK_LAUNCHES == launches
    assert seen == [True, False, True, False, True]
    flat, _, pq = idx[:3]
    assert [id(c) for c in calls] == [id(flat.data_sorted),
                                       id(pq.vectors_sorted),
                                       id(pq.vectors_sorted)]
    assert after[("ivf_flat", "kernel")] == \
        mid.get(("ivf_flat", "kernel"), 0) + 1
    assert after[("ivf_pq", "kernel")] == mid.get(("ivf_pq", "kernel"), 0) + 2
    assert after[("ivf_pq", "gather")] == mid[("ivf_pq", "gather")] + 1
    assert after[("ivf_sq", "gather")] == mid[("ivf_sq", "gather")] + 1
    for key, (dg, ig) in gathered.items():
        df, i_f = forced[key]
        assert torch.equal(dg, df) and torch.equal(ig, i_f), key


def test_mutable_search_kernel_route_keeps_tombstones(monkeypatch):
    """The mutable IVF-Flat search on the kernel route (forced, the kernel
    stood in by its plain version) after deletes: the gather route's
    answers bit for bit, no deleted id among them."""
    from raft_tpu_torch.spatial.ann import mutation

    flat, *_, x, q = _indexes()
    m = mutation.wrap_mutable(flat, delta_cap=16)
    dead = np.arange(0, 1500, 7, dtype=np.int32)
    m, found = mutation.delete(m, dead)
    assert found.all()
    dg, ig = mutation.mutable_search(m, q, 10, n_probes=4, use_kernel=True)
    monkeypatch.setattr(rr, "rerank_kernel_fits",
                        lambda qf, src: src is not None)
    calls = _plain_kernel(monkeypatch)
    before = _reranks().get(("ivf_flat", "kernel"), 0)
    dk, ik = mutation.mutable_search(m, q, 10, n_probes=4, use_kernel=True)
    assert _reranks()[("ivf_flat", "kernel")] == before + 1
    assert len(calls) == 1
    assert torch.equal(dg, dk) and torch.equal(ig, ik)
    assert not np.isin(ik.numpy(), dead).any()


def test_gather_route_blocks_the_queries(monkeypatch):
    """The gather route bounds each query block's gather by
    ``RERANK_BLOCK_BYTES`` (at least 8 queries a block) and its answers
    do not depend on the blocks."""
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped

    flat, *_, q = _indexes()
    whole = ivf_flat_search_grouped(flat, q, 10, n_probes=4, qcap=40,
                                    use_kernel=True)
    blocks = []
    real = grouped.map_query_blocks

    def spy(fn, args, block_q):
        blocks.append(block_q)
        return real(fn, args, block_q)

    monkeypatch.setattr(grouped, "map_query_blocks", spy)
    # 40 candidates x 8 rows x 16 features x 4 bytes = 20 KB a query
    monkeypatch.setattr(grouped, "RERANK_BLOCK_BYTES", 20480 * 9)
    got = ivf_flat_search_grouped(flat, q, 10, n_probes=4, qcap=40,
                                  use_kernel=True)
    assert blocks == [9]
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


@pytest.mark.parametrize("d", [16, 97])
def test_gather_route_is_the_plain_version(d):
    """The gather route of ``grouped._rerank`` (every CPU search takes it)
    scores a pool as the plain version does, bit for bit, in query blocks
    or not: its top ``k`` is ``select_candidates`` over
    ``rescore_rows_plain`` of the engine's rows, and it counts one
    ``gather`` rerank."""
    from raft_tpu_torch.spatial.ann.common import select_candidates

    flat = _indexes()[0]
    rng = np.random.default_rng(d)
    n = flat.storage.n
    src = torch.as_tensor(
        rng.integers(-16, 17, (n + 1, d)).astype(np.float32))
    src[n] = 0
    engine = grouped.FlatEngine(flat.centroids, flat.storage, src)
    qf = torch.as_tensor(rng.integers(-16, 17, (30, d)).astype(np.float32))
    rpos, valid = _pool(rng, 30, 6, n)
    want = select_candidates(flat.storage, rpos,
                             rr.rescore_rows_plain(qf, src, rpos, valid), 10)
    before = _reranks().get(("ivf_flat", "gather"), 0)
    for block_bytes in (grouped.RERANK_BLOCK_BYTES, 48 * 4 * d * 8):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(grouped, "RERANK_BLOCK_BYTES", block_bytes)
            got = grouped._rerank(engine, qf, rpos, valid, 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _reranks()[("ivf_flat", "gather")] == before + 2
