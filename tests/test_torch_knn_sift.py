"""Brute-force kNN as the ``sift1m-brute_force`` configuration runs it, at
a small size on the CPU: the fused route (``use_fused=True``: the
kernels' plain versions here) with a bf16 phase 1, ``extra_chunks=32`` and
f32 rows, held to the benchmark's plain reference
(``benchmark/reference/exact.py``) and its comparison (``benchmark/judge.py``).

The limit is the configuration's own: ``dist_gap`` <= 1e-4. The rescore
is exact f32 (``Σ y·(y − 2q)`` over 128 terms, plus ``‖q‖²``), so a
returned squared distance is off the f64 one by a few f32 roundings of
terms no larger than ``|q|² + |x|²``: about 128 · 2^-24 ≈ 7.6e-6 of that
scale at the worst, far less in practice. A bf16-stored index rescores
rows rounded to 8 bits of mantissa (2^-9 ≈ 2e-3 of each coordinate), a
gap of order 1e-3: the limit lies between the two, with room on both
sides.
"""

import numpy as np
import torch

from benchmark import data, judge
from benchmark.engines import brute_force as engine
from benchmark.reference import exact
from raft_tpu_torch.spatial import brute_force_knn

torch.set_num_threads(1)

N, D, NQ, K = 16384, 128, 64, 10
LIMIT = 1e-4
CFG = {"n_rows": N, "dim": D, "n_queries": NQ, "k": K,
       "data": {"kind": "gaussian_mixture", "n_centres": 64, "centre_spread": 2.0,
                "noise": 1.0, "seed": 19},
       "index": {"storage": "float32", "compute_dtype": "bfloat16", "extra_chunks": 32}}


def _rows():
    return data.make(CFG, 2**31 + 7, torch.device("cpu"))


def _search(x, q):
    return brute_force_knn(x, q, K, metric="l2_expanded", use_fused=True,
                           compute_dtype=torch.bfloat16, extra_chunks=32)


def _gap(x, q, d, i):
    return judge.dist_gap(x, q, torch.arange(q.shape[0]), d, i, "sqeuclidean")


def _assert_ids_up_to_ties(dists, got, want):
    """ids identical except inside runs of equal reference distance, where
    the sets must agree; the run cut by the k-th place is left to the
    distance check."""
    d, a, b = np.asarray(dists), np.asarray(got), np.asarray(want)
    for r in range(d.shape[0]):
        start = 0
        for end in range(1, K + 1):
            if end == K or d[r, end] != d[r, start]:
                if end < K or start == 0:
                    assert set(a[r, start:end]) == set(b[r, start:end]), f"query {r}"
                start = end


def test_fused_bf16_route_matches_the_plain_reference():
    x, q = _rows()
    assert N // 128 >= 32
    d, i = _search(x, q)
    ref_d, ref_i = exact.topk(x, q, K)
    _assert_ids_up_to_ties(ref_d, i.long(), ref_i)
    assert judge.recall_hits(ref_i, torch.arange(NQ), i) == NQ * K
    assert _gap(x, q, d, i) <= LIMIT


def test_bf16_stored_rows_fail_the_limit():
    """The same search over a bf16 copy of the rows: its rescore reads the
    rounded rows, and the gap to the exact distances is over the limit."""
    x, q = _rows()
    d, i = _search(x.to(torch.bfloat16), q)
    gap = _gap(x, q, d, i)
    assert gap > LIMIT
    sound_d, sound_i = _search(x, q)
    assert gap > 10 * _gap(x, q, sound_d, sound_i)


def test_engine_adapter_agrees_with_the_direct_call_bitwise():
    x, q = _rows()
    index = engine.build(x, CFG, 0, torch.device("cpu"))
    assert index["rows"].dtype == torch.float32 and index["rows"].is_contiguous()
    assert torch.allclose(index["norms"], (x * x).sum(1), rtol=1e-6)
    d, i = engine.search_fn(index, CFG, NQ)(q)
    want_d, want_i = brute_force_knn(
        x, q, K, metric="l2_expanded", use_fused=True, compute_dtype=torch.bfloat16,
        extra_chunks=32, index_norms=[index["norms"]])
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    assert engine.DISTANCE == "sqeuclidean"
