"""PyTorch port of the serving slice: shape-bucketed micro-batching
(raft_tpu_torch.serving.batching against the JAX package's module) and
bucketed serving of an IVF-Flat index on the CPU — warm one batch size
per bucket, pack requests, search each batch at its warmed qcap, demux.
"""

import numpy as np
import pytest
import torch

from raft_tpu.serving import batching as jb
from raft_tpu.spatial.ann import common as jcommon
from raft_tpu_torch.serving import batching as tb
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_search,
    ivf_flat_search_grouped,
)

torch.set_num_threads(1)


def _drain(mod, pending, buckets, dim):
    """Pack until nothing is pending; returns the batches as plain
    (bucket, n_valid, [(request index, start)], queries) tuples."""
    index_of = {id(r): i for i, r in enumerate(pending)}
    out = []
    while pending:
        batch, pending = mod.pack_requests(pending, buckets, dim)
        assert batch is not None
        out.append((batch.bucket, batch.n_valid,
                    [(index_of[id(r)], s) for r, s in batch.entries],
                    batch.queries))
    return out


@pytest.mark.parametrize("sizes", [(8, 64, 512, 4096), (4, 8), (1,)])
def test_pack_requests_matches_jax_module(sizes):
    rng = np.random.default_rng(len(sizes))
    dim = 6
    largest = max(sizes)
    rows = rng.integers(1, largest + 1, 60)
    reqs = [rng.standard_normal((int(m), dim)).astype(np.float32)
            for m in rows]
    jbs, tbs = jb.BucketSet.of(sizes), tb.BucketSet.of(sizes)
    assert tbs.sizes == jbs.sizes
    for n in (1, 3, largest, largest + 5):
        assert tbs.select(n) == jbs.select(n)
    want = _drain(jb, [jb.PendingRequest(r, None, 0.0) for r in reqs],
                  jbs, dim)
    got = _drain(tb, [tb.PendingRequest(r, None, 0.0) for r in reqs],
                 tbs, dim)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        np.testing.assert_array_equal(g[3], w[3])


def test_bucket_set_validation():
    for bad in ((), (0, 4), (8, 4), (2, 2)):
        with pytest.raises(ValueError):
            tb.BucketSet(tuple(bad))
    with pytest.raises(ValueError):
        tb.BucketSet.of((4,)).select(0)
    assert tb.pack_requests([], tb.BucketSet.of((4,)), 3) == (None, [])


def test_bucketed_serving_matches_per_query_search():
    """Warm each bucket (the returned qcap is JAX's shape-only cap), then
    serve requests through pack_requests -> grouped search at the warmed
    qcap -> demux: every request gets what the per-query search returns
    for its rows (qcap at its bucket size drops no probe pairs)."""
    rng = np.random.default_rng(4)
    centers = rng.integers(-40, 40, (10, 8))
    x = (centers[rng.integers(0, 10, 1500)]
         + rng.integers(-5, 6, (1500, 8))).astype(np.float32)
    index = ivf_flat_build(x, IVFFlatParams(n_lists=24, kmeans_n_iters=4,
                                            kmeans_init="random"),
                           metric="sqeuclidean", device="cpu")
    buckets = tb.BucketSet.of((4, 16, 64))
    k, p = 5, 3
    qcaps = {}
    for b in buckets.sizes:
        qcaps[b] = index.warmup(b, k=k, n_probes=p, qcap=b,
                                use_kernel=True)
        assert qcaps[b] == jcommon.static_qcap(b, b, p, 24) == b
        assert index.warmup(b, k=k, n_probes=p) == \
            jcommon.static_qcap(None, b, p, 24)
    reqs = [(x[rng.integers(0, 1500, m)] + rng.integers(-2, 3, (m, 8))
             ).astype(np.float32) for m in rng.integers(1, 30, 20)]
    pending = [tb.PendingRequest(r, None, 0.0) for r in reqs]
    results = {}
    while pending:
        batch, pending = tb.pack_requests(pending, buckets, 8)
        d, i = ivf_flat_search_grouped(
            index, batch.queries, k, n_probes=p,
            qcap=qcaps[batch.bucket], use_kernel=True)
        assert d.shape == (batch.bucket, k)
        for req, start in batch.entries:
            results[id(req.queries)] = (d[start:start + req.n_rows],
                                        i[start:start + req.n_rows])
    for r in reqs:
        d, i = results[id(r)]
        d_ref, i_ref = ivf_flat_search(index, r, k, n_probes=p)
        assert torch.equal(d, d_ref)
        assert torch.isfinite(d).all() and (i >= 0).all()


def test_profile_tool_busy_time_and_no_card():
    """The profiling script's device-busy time is the union of the
    kernels' intervals, and without a card it refuses to run."""
    from raft_tpu_torch.tools import profile_grouped as pg

    assert pg._busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.8)]) == 4.0
    assert pg._busy_us([]) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            pg.main([])
