"""PyTorch port of the generic ANN entry points
(raft_tpu_torch/spatial/ann/approx.py) against the JAX package, on the
CPU.

Both packages search one JAX-built index of each kind (integer rows and
centroids, integer PQ codebooks, the dyadic SQ codes of the mutation
tests' fixture), carried across with ``interop.*_index_from_arrays``.
Every f32 sum is exact there, so distances must match bitwise and ids up
to ties (ROADMAP note R1). In each package ``approx_knn_search`` must
answer exactly as the search it dispatches to, in every mode.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import errors as jerrors
from raft_tpu.core import logger as jlogger
from raft_tpu.spatial.ann import approx as japprox
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import IVFPQParams as JIVFPQParams
from raft_tpu.spatial.ann import IVFSQParams as JIVFSQParams
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.core import logger as tlogger
from raft_tpu_torch.spatial.ann import (
    IVFFlatIndex,
    IVFFlatParams,
    IVFPQParams,
    IVFSQParams,
    approx_knn_build_index,
    approx_knn_search,
    ivf_flat_index_from_arrays,
    ivf_pq_index_from_arrays,
    ivf_sq_index_from_arrays,
)
from raft_tpu_torch.spatial.ann import approx as tapprox
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties
from tests.test_torch_mutation import _int_rows, _jax_index, _leaves

torch.set_num_threads(1)

K = 5
P = 4
KINDS = ("flat", "sq", "pq")
# below, at and above the auto split (1,024 queries)
NQ_SMALL, NQ_BIG = 24, 1040


@pytest.fixture(scope="module")
def dataset():
    x, q = _int_rows(21, n=800, nq=NQ_BIG)
    return x, q


@pytest.fixture(scope="module")
def pairs(dataset):
    """{kind: (JAX index, the port's carried copy)}."""
    x, _ = dataset
    out = {}
    for kind in KINDS:
        j = _jax_index(kind, x)
        leaves = _leaves(j, "", {})
        if kind == "flat":
            t = ivf_flat_index_from_arrays(leaves, j.metric, device="cpu")
        elif kind == "sq":
            t = ivf_sq_index_from_arrays(leaves, device="cpu")
        else:
            t = ivf_pq_index_from_arrays(leaves, j.pq_dim, j.pq_bits,
                                         device="cpu")
        out[kind] = (j, t)
    return out


def _kw(kind, j):
    if kind == "pq":
        # a refine pool covering every probed row: exact f32 rescoring
        return {"refine_ratio": float(P * j.storage.max_list) / K + 1.0}
    return {}


def _direct(pkg, kind, grouped):
    mod = japprox if pkg == "jax" else tapprox
    per_query, group = {
        "flat": (mod.ivf_flat_search, mod.ivf_flat_search_grouped),
        "sq": (mod.ivf_sq_search, None),
        "pq": (mod.ivf_pq_search, mod.ivf_pq_search_grouped),
    }[kind]
    return group if grouped and group is not None else per_query


def _grouped_taken(kind, mode, nq):
    if kind == "sq":
        return False
    return mode == "throughput" or (mode == "auto" and nq >= 1024)


CASES = [(kind, mode, nq) for kind in KINDS
         for mode, nq in (("auto", NQ_SMALL), ("auto", NQ_BIG),
                          ("latency", NQ_SMALL), ("throughput", NQ_SMALL))
         if not (kind == "sq" and mode == "throughput")]


@pytest.mark.parametrize("kind,mode,nq", CASES)
def test_dispatch_equals_direct_call_and_jax(dataset, pairs, kind, mode,
                                             nq):
    """approx_knn_search answers as the path it dispatches to (bitwise,
    in each package), and the port as JAX (distances bitwise, ids up to
    ties)."""
    _, q = dataset
    q = q[:nq]
    j, t = pairs[kind]
    kw = _kw(kind, j)
    grouped = _grouped_taken(kind, mode, nq)
    jd, ji = japprox.approx_knn_search(j, jnp.asarray(q), K, n_probes=P,
                                       mode=mode, **kw)
    jd0, ji0 = _direct("jax", kind, grouped)(j, jnp.asarray(q), K,
                                             n_probes=P, **kw)
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(jd0))
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(ji0))
    tq = torch.as_tensor(q)
    td, ti = approx_knn_search(t, tq, K, n_probes=P, mode=mode, **kw)
    td0, ti0 = _direct("torch", kind, grouped)(t, tq, K, n_probes=P, **kw)
    assert torch.equal(td, td0) and torch.equal(ti, ti0)
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    _assert_ids_equal_up_to_ties(np.asarray(jd), np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_kernel_engine_through_the_dispatch(dataset, pairs, kind):
    """The throughput path's kernel knob passes through: the port's
    ``use_kernel=True`` (the scan's plain version on CPU tensors) and
    JAX's ``use_pallas=True`` (interpret mode) answer alike."""
    _, q = dataset
    q = q[:NQ_SMALL]
    j, t = pairs[kind]
    kw = _kw(kind, j)
    jd, ji = japprox.approx_knn_search(j, jnp.asarray(q), K, n_probes=P,
                                       mode="throughput", use_pallas=True,
                                       qcap=NQ_SMALL, **kw)
    td, ti = approx_knn_search(t, torch.as_tensor(q), K, n_probes=P,
                               mode="throughput", use_kernel=True,
                               qcap=NQ_SMALL, **kw)
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    _assert_ids_equal_up_to_ties(np.asarray(jd), np.asarray(ji), ti.numpy())


def _accepted(mod, index_type):
    """The kwargs some search path of ``index_type`` takes, read as the
    dispatch reads them."""
    def sig(fn):
        return set(inspect.signature(
            inspect.unwrap(getattr(fn, "__wrapped__", fn))).parameters)

    per_query, grouped = mod._SEARCHERS[index_type]
    return sig(per_query) | (sig(grouped) if grouped is not None else set())


@pytest.mark.parametrize("kind", KINDS)
def test_kwarg_sets_match_jax_with_use_kernel_for_use_pallas(pairs, kind):
    j, t = pairs[kind]
    jset = _accepted(japprox, type(j))
    tset = _accepted(tapprox, type(t))
    mapped = {"use_kernel" if n == "use_pallas" else n for n in jset}
    assert tset == mapped
    assert ("use_pallas" in jset) == ("use_kernel" in tset)


def test_unknown_kwarg_mode_and_types_raise_in_both(dataset, pairs):
    x, q = dataset
    j, t = pairs["flat"]
    with pytest.raises(jerrors.RaftException, match="refine_ration"):
        japprox.approx_knn_search(j, jnp.asarray(q[:4]), K,
                                  refine_ration=2.0)
    with pytest.raises(terrors.RaftException, match="refine_ration"):
        approx_knn_search(t, torch.as_tensor(q[:4]), K, refine_ration=2.0)
    with pytest.raises(jerrors.RaftException, match="mode"):
        japprox.approx_knn_search(j, jnp.asarray(q[:4]), K, mode="fast")
    with pytest.raises(terrors.RaftException, match="mode"):
        approx_knn_search(t, torch.as_tensor(q[:4]), K, mode="fast")
    with pytest.raises(jerrors.RaftException):
        japprox.approx_knn_build_index(x, object())
    with pytest.raises(terrors.RaftException):
        approx_knn_build_index(x, object(), device="cpu")
    with pytest.raises(jerrors.RaftException):
        japprox.approx_knn_search(object(), q[:4], K)
    with pytest.raises(terrors.RaftException):
        approx_knn_search(object(), q[:4], K)
    # IVF-SQ has no throughput path in either package
    js, ts = pairs["sq"]
    with pytest.raises(jerrors.RaftException, match="no throughput"):
        japprox.approx_knn_search(js, jnp.asarray(q[:4]), K,
                                  mode="throughput")
    with pytest.raises(terrors.RaftException, match="no throughput"):
        approx_knn_search(ts, torch.as_tensor(q[:4]), K, mode="throughput")


def test_dropped_kwarg_is_logged_through_the_ports_logger(dataset, pairs):
    """A kwarg only the other mode accepts is dropped and logged through
    ``raft_tpu_torch.core.logger``; the JAX package's logger sees none
    of it (and the answer is the per-query path's)."""
    _, q = dataset
    _, t = pairs["flat"]
    got, jgot = [], []
    tlogger.set_callback(lambda lvl, msg: got.append((lvl, msg)))
    jlogger.set_callback(lambda lvl, msg: jgot.append((lvl, msg)))
    prev = tlogger.get_level()
    tlogger.set_level(tlogger.INFO)
    try:
        tq = torch.as_tensor(q[:8])
        d, i = approx_knn_search(t, tq, K, n_probes=P, mode="latency",
                                 qcap=8, block_q=4)
    finally:
        tlogger.set_level(prev)
        tlogger.set_callback(None)
        jlogger.set_callback(None)
    assert any("qcap" in m and lvl == tlogger.INFO for lvl, m in got), got
    assert not jgot
    d0, i0 = tapprox.ivf_flat_search(t, tq, K, n_probes=P, block_q=4)
    assert torch.equal(d, d0) and torch.equal(i, i0)


@pytest.mark.parametrize("kind", KINDS)
def test_build_dispatches_on_params_and_forwards_device(dataset, kind):
    """approx_knn_build_index builds the index its params name, on the
    device it is given, equal to the direct build (one seed, one
    generator)."""
    x, _ = dataset
    params = {
        "flat": IVFFlatParams(n_lists=8, kmeans_n_iters=3),
        "sq": IVFSQParams(n_lists=8, kmeans_n_iters=3),
        "pq": IVFPQParams(n_lists=8, pq_dim=4, pq_bits=4, kmeans_n_iters=3),
    }[kind]
    idx = approx_knn_build_index(x, params, device="cpu")
    direct = tapprox._BUILDERS[type(params)](x, params, device="cpu")
    assert type(idx) is type(direct)
    assert idx.centroids.device.type == "cpu"
    assert torch.equal(idx.centroids, direct.centroids)
    assert torch.equal(idx.storage.sorted_ids, direct.storage.sorted_ids)
    jtypes = {IVFFlatParams: JIVFFlatParams, IVFSQParams: JIVFSQParams,
              IVFPQParams: JIVFPQParams}
    assert set(tapprox._BUILDERS) == set(jtypes)
    assert ({c.__name__ for c in japprox._BUILDERS}
            == {c.__name__ for c in tapprox._BUILDERS})
    assert isinstance(approx_knn_build_index(
        x, IVFFlatParams(n_lists=4, kmeans_n_iters=2), device="cpu"),
        IVFFlatIndex)


def test_auto_split_is_jax_s():
    assert tapprox._AUTO_THROUGHPUT_NQ == 1024
    assert ({c.__name__: g is None
             for c, (_, g) in japprox._SEARCHERS.items()}
            == {c.__name__: g is None
                for c, (_, g) in tapprox._SEARCHERS.items()})
