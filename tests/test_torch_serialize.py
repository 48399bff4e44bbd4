"""The port's numpy-only index writer and reader
(``raft_tpu_torch/spatial/ann/interop.py``: ``save_index``,
``load_index``, version 1 archives) against the JAX package's
``spatial/ann/serialize.py``, on the CPU.

An archive the port writes must load in the JAX package's
``load_index`` as the same index (every leaf bitwise, the statics equal)
and search to the same results as the port's index (distances bitwise on
integer-exact fixtures, ids up to ties); its header (kind, version,
statics, CRC32/shape/dtype manifest) must equal what the JAX package
writes for the same arrays.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from raft_tpu.spatial.ann import GraphParams as JGraphParams
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import IVFPQParams as JIVFPQParams
from raft_tpu.spatial.ann import graph_build as j_graph_build
from raft_tpu.spatial.ann import ivf_flat_build as j_ivf_flat_build
from raft_tpu.spatial.ann import ivf_pq_build as j_ivf_pq_build
from raft_tpu.spatial.ann.graph import graph_search as j_graph_search
from raft_tpu.spatial.ann.ivf_flat import (
    ivf_flat_search_grouped as j_flat_grouped,
)
from raft_tpu.spatial.ann.ivf_pq import ivf_pq_search as j_pq_search
from raft_tpu.spatial.ann.ivf_sq import (
    ivf_sq_search_grouped as j_sq_grouped,
)
from raft_tpu.spatial.ann.serialize import load_index as j_load_index
from raft_tpu.spatial.ann.serialize import save_index as j_save_index
from raft_tpu.testing.faults import corrupt_bytes
from raft_tpu_torch import errors as terrors
from raft_tpu_torch.spatial.ann import (
    GraphIndex,
    GraphParams,
    IVFFlatIndex,
    IVFFlatParams,
    IVFPQIndex,
    IVFPQParams,
    IVFSQIndex,
    IVFSQParams,
    graph_build,
    graph_search,
    ivf_flat_build,
    ivf_flat_search_grouped,
    ivf_pq_build,
    ivf_pq_search,
    ivf_sq_build,
    ivf_sq_search_grouped,
    load_graph,
    load_index,
    load_ivf_flat,
    load_ivf_pq,
    load_ivf_sq,
    save_index,
)
from tests.test_torch_ivf_flat import _assert_ids_equal_up_to_ties
from tests.test_torch_ivf_flat import _int_dataset
from tests.test_torch_sq import _int_sq_index

torch.set_num_threads(1)

KINDS = ("ivf_flat", "ivf_sq", "ivf_pq", "ivf_pq_noraw", "graph")
_TYPES = {"ivf_flat": IVFFlatIndex, "ivf_sq": IVFSQIndex,
          "ivf_pq": IVFPQIndex, "ivf_pq_noraw": IVFPQIndex,
          "graph": GraphIndex}


@pytest.fixture(scope="module")
def data():
    """The integer-exact IVF fixture, and the graph's integer grid."""
    x, q = _int_dataset(7)
    rng = np.random.default_rng(11)
    gx = rng.integers(-64, 64, size=(256, 8)).astype(np.float32)
    gq = rng.integers(-64, 64, size=(6, 8)).astype(np.float32)
    return x, q, gx, gq


@pytest.fixture(scope="module")
def jax_indexes(data):
    x, _, gx, _ = data
    pq = j_ivf_pq_build(x, JIVFPQParams(
        n_lists=48, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
        kmeans_init="random"))
    return {
        "ivf_flat": j_ivf_flat_build(x, JIVFFlatParams(
            n_lists=48, kmeans_n_iters=4, kmeans_init="random"),
            metric="sqeuclidean"),
        "ivf_sq": _int_sq_index(x),
        "ivf_pq": pq,
        "ivf_pq_noraw": dataclasses.replace(pq, vectors_sorted=None),
        "graph": j_graph_build(gx, JGraphParams(degree=8, seed=0),
                               metric="sqeuclidean"),
    }


@pytest.fixture(scope="module")
def archives(jax_indexes, tmp_path_factory):
    """Each JAX index saved by the JAX package, loaded by the port, and
    saved again by the port: {kind: (jax path, port index, port path)}."""
    out = {}
    for kind, jidx in jax_indexes.items():
        d = tmp_path_factory.mktemp(kind)
        jpath, tpath = d / "jax.npz", d / "port.npz"
        j_save_index(jidx, jpath)
        idx = load_index(jpath, device="cpu")
        save_index(idx, tpath)
        out[kind] = (jpath, idx, tpath)
    return out


@pytest.fixture(scope="module")
def port_built(data):
    """Indexes the port builds itself, on the CPU."""
    x, _, gx, _ = data
    return {
        "ivf_flat": ivf_flat_build(x, IVFFlatParams(
            n_lists=48, kmeans_n_iters=4, kmeans_init="random"),
            metric="sqeuclidean", device="cpu"),
        "ivf_sq": ivf_sq_build(x, IVFSQParams(n_lists=48, kmeans_n_iters=4),
                               device="cpu"),
        "ivf_pq": ivf_pq_build(x, IVFPQParams(
            n_lists=48, pq_dim=4, pq_bits=4, kmeans_n_iters=4,
            kmeans_init="random"), device="cpu"),
        "graph": graph_build(gx, GraphParams(degree=8, seed=0),
                             metric="sqeuclidean", device="cpu"),
    }


def _header(path):
    with np.load(path) as npz:
        return json.loads(bytes(npz["__header__"]).decode("utf-8"))


def _arrays(path):
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files if k != "__header__"}


def _leaves(idx, prefix=""):
    """Every array leaf of an index of either package, as numpy, keyed
    as the archive keys it (None for an absent optional leaf)."""
    out = {}
    for f in dataclasses.fields(idx):
        if f.name.startswith("_") or f.name == "build_stats":
            continue
        v = getattr(idx, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, prefix + f.name + "."))
        elif v is None or hasattr(v, "shape"):
            out[prefix + f.name] = (
                None if v is None else v.numpy() if isinstance(
                    v, torch.Tensor) else np.asarray(v))
    return out


def _assert_same_index(jidx, tidx):
    a, b = _leaves(jidx), _leaves(tidx)
    assert a.keys() == b.keys()
    for k, v in a.items():
        if v is None:
            assert b[k] is None, k
        else:
            assert v.dtype == b[k].dtype and np.array_equal(v, b[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_port_archive_header_equals_jax_archive_header(archives, kind):
    """The port rewrites a JAX archive as the same archive: one key per
    leaf under the same names with the same bytes, and a header with the
    same kind, version, statics and integrity manifest."""
    jpath, idx, tpath = archives[kind]
    assert isinstance(idx, _TYPES[kind])
    hj, ht = _header(jpath), _header(tpath)
    assert ht == hj
    assert ht["version"] == (5 if kind == "graph" else 2)
    aj, at = _arrays(jpath), _arrays(tpath)
    assert list(at) == list(aj)
    for k in aj:
        assert aj[k].dtype == at[k].dtype and np.array_equal(aj[k], at[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_port_archive_loads_in_jax_as_the_same_index(archives,
                                                     jax_indexes, kind):
    _, idx, tpath = archives[kind]
    loaded = j_load_index(tpath)
    assert type(loaded) is type(jax_indexes[kind])
    _assert_same_index(jax_indexes[kind], loaded)
    _assert_same_index(loaded, idx)


def _search_both(kind, jidx, tidx, data):
    """(JAX results, port results) of one exact-distance search."""
    x, q, _, gq = data
    if kind == "ivf_flat":
        kw = dict(n_probes=4, qcap=64)
        return (j_flat_grouped(jidx, q, 5, use_pallas=False, **kw),
                ivf_flat_search_grouped(tidx, q, 5, use_kernel=False, **kw))
    if kind == "ivf_sq":
        kw = dict(n_probes=4, qcap=64)
        return (j_sq_grouped(jidx, q, 5, use_pallas=False, **kw),
                ivf_sq_search_grouped(tidx, q, 5, use_kernel=False, **kw))
    if kind == "ivf_pq":
        # a refine pool covering every probed row: exact f32 distances
        rr = float(4 * tidx.storage.max_list) / 5 + 1.0
        return (j_pq_search(jidx, q, 5, n_probes=4, refine_ratio=rr),
                ivf_pq_search(tidx, q, 5, n_probes=4, refine_ratio=rr))
    return (j_graph_search(jidx, gq, 8, beam=16, use_pallas=False),
            graph_search(tidx, gq, 8, beam=16, use_kernel=False))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_sq", "ivf_pq", "graph"])
def test_port_archive_searches_alike_in_jax(archives, port_built, data,
                                            tmp_path, kind):
    """The index the JAX package loads from the port's archive searches
    to the port index's results: distances bitwise, ids up to ties. IVF-
    Flat and the graph are built by the port on integer data; IVF-SQ (the
    dyadic index, whose codes are the integer rows) and IVF-PQ (at a
    saturated refine pool) are JAX builds the port carried and rewrote."""
    if kind in ("ivf_flat", "graph"):
        tidx = port_built[kind]
        path = tmp_path / "i.npz"
        save_index(tidx, path)
    else:
        _, tidx, path = archives[kind]
    jidx = j_load_index(path)
    _assert_same_index(jidx, tidx)
    (d0, i0), (d1, i1) = _search_both(kind, jidx, tidx, data)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    _assert_ids_equal_up_to_ties(d0, i0, i1.numpy())


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_sq", "ivf_pq", "graph"])
def test_port_built_archive_round_trips(port_built, tmp_path, kind):
    """A port-built index: JAX reads the port's archive as the same
    leaves and statics, and the port reads it back whole through
    load_index and through its kind's loader."""
    tidx = port_built[kind]
    path = tmp_path / "i.npz"
    save_index(tidx, path)
    _assert_same_index(j_load_index(path), tidx)
    loader = {"ivf_flat": load_ivf_flat, "ivf_sq": load_ivf_sq,
              "ivf_pq": load_ivf_pq, "graph": load_graph}[kind]
    for back in (load_index(path, device="cpu"), loader(path, device="cpu")):
        assert type(back) is type(tidx)
        _assert_same_index(back, tidx)
    if kind == "ivf_pq":
        assert (back.pq_dim, back.pq_bits) == (tidx.pq_dim, tidx.pq_bits)
    if kind in ("ivf_flat", "graph"):
        assert back.metric == tidx.metric


def _write_v1(src, dst):
    """A version 1 archive (no integrity manifest) of ``src``'s arrays."""
    header = _header(src)
    header["version"] = 1
    del header["integrity"]
    with open(dst, "wb") as f:
        np.savez(f, __header__=np.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=np.uint8),
            **_arrays(src))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_sq", "ivf_pq"])
def test_v1_archive_loads_in_both_packages(archives, jax_indexes, tmp_path,
                                           kind):
    """A hand-built v1 archive loads unverified in both packages as the
    same index."""
    _, idx, tpath = archives[kind]
    p = tmp_path / "v1.npz"
    _write_v1(tpath, p)
    assert _header(p)["version"] == 1 and "integrity" not in _header(p)
    _assert_same_index(j_load_index(p), jax_indexes[kind])
    _assert_same_index(load_index(p, device="cpu"), idx)


def test_corrupted_port_archive_names_the_field(archives, tmp_path):
    """A damaged array in an archive the port wrote: both packages raise
    CorruptIndexError naming it; a v1 archive has no manifest to catch
    silent damage, but a v2 one does."""
    _, _, tpath = archives["ivf_flat"]
    p = tmp_path / "bad.npz"
    p.write_bytes(tpath.read_bytes())
    field = corrupt_bytes(p, field="storage.list_sizes", n_bytes=4)
    with pytest.raises(terrors.CorruptIndexError, match="CRC32") as e:
        load_index(p, device="cpu")
    assert e.value.field == field == "storage.list_sizes"
    from raft_tpu import errors as jerrors

    with pytest.raises(jerrors.CorruptIndexError) as je:
        j_load_index(p)
    assert je.value.field == field


def test_future_version_and_unported_kinds_raise(archives, tmp_path):
    _, _, tpath = archives["ivf_flat"]
    arrays = _arrays(tpath)
    for change, names in (({"version": 99}, "99"),
                          ({"type": "mutable_ivf", "version": 4},
                           "mutable_ivf"),
                          ({"type": "ball_cover"}, "ball_cover")):
        header = dict(_header(tpath), **change)
        p = tmp_path / "x.npz"
        with open(p, "wb") as f:
            np.savez(f, __header__=np.frombuffer(
                json.dumps(header).encode("utf-8"), dtype=np.uint8),
                **arrays)
        with pytest.raises(terrors.CorruptIndexError, match=names) as e:
            load_index(p, device="cpu")
        assert e.value.field == "__header__"
    # a kind's own loader still refuses another kind
    with pytest.raises(ValueError, match="not 'ivf_sq'"):
        load_ivf_sq(tpath, device="cpu")


def test_mnmg_ivf_pq_archive_round_trips(data, tmp_path):
    """The ``mnmg_ivf_pq`` kind (the sharded IVF-PQ index, every rank's
    slab) both ways: a JAX archive loads in the port with every array
    bitwise, the port's re-save has JAX's header, and JAX loads it back
    as the same index."""
    import jax

    from raft_tpu.comms import build_comms as j_build_comms
    from raft_tpu.comms import mnmg_ivf_pq_build as j_mnmg_pq_build
    from raft_tpu_torch.comms import MnmgIVFPQIndex

    x = data[0]
    j = j_mnmg_pq_build(j_build_comms(jax.devices()[:2]), x, JIVFPQParams(
        n_lists=12, pq_dim=4, pq_bits=4, kmeans_n_iters=2,
        kmeans_init="random"))
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    j_save_index(j, jpath)
    t = load_index(jpath)
    assert isinstance(t, MnmgIVFPQIndex)
    save_index(t, tpath)
    assert _header(tpath) == _header(jpath)
    back = j_load_index(tpath)
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(back, f.name)
        if hasattr(a, "shape"):
            assert np.asarray(b).tobytes() == np.asarray(a).tobytes(), f.name
            assert np.asarray(getattr(t, f.name)).tobytes() == \
                np.asarray(a).tobytes(), f.name
        else:
            assert a == b == getattr(t, f.name), f.name


def test_save_index_refuses_other_types(tmp_path):
    with pytest.raises(ValueError, match="unsupported index type"):
        save_index(object(), tmp_path / "x.npz")


def test_bf16_leaf_is_archived_as_its_words(archives, tmp_path):
    """A bf16 leaf goes into the archive as uint16 words tagged
    ``bfloat16`` in the statics, as the JAX writer stores it, and both
    packages read it back bitwise."""
    _, idx, _ = archives["ivf_flat"]
    bf = dataclasses.replace(idx, data_sorted=idx.data_sorted.to(
        torch.bfloat16))
    p = tmp_path / "bf16.npz"
    save_index(bf, p)
    h = _header(p)
    assert h["static"]["data_sorted.__dtype__"] == "bfloat16"
    assert h["integrity"]["data_sorted"]["dtype"] == "uint16"
    back = load_index(p, device="cpu")
    assert back.data_sorted.dtype == torch.bfloat16
    assert torch.equal(back.data_sorted, bf.data_sorted)
    j = j_load_index(p)
    assert np.array_equal(np.asarray(j.data_sorted).view(np.uint16),
                          bf.data_sorted.view(torch.int16).numpy().view(
                              np.uint16))
