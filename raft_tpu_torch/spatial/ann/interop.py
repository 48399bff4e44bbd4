"""Carrying IVF and graph indexes across from the JAX package.

* ``*_index_from_arrays`` take a JAX index's leaves as numpy arrays,
  keyed as the npz archive keys them. An IVF index has ``centroids``,
  the four ``storage.*`` arrays with the ``storage.n`` and
  ``storage.max_list`` ints, and the kind's own arrays (IVF-Flat
  ``data_sorted``; IVF-SQ ``codes_sorted``, ``vmin``, ``vscale``; IVF-PQ
  ``codebooks``, ``codes_sorted`` and, unless built with
  ``store_raw=False``, ``vectors_sorted``). A graph index has
  ``data_padded``, ``storage.adjacency`` and ``storage.entries``.
* :func:`coarse_index_from_arrays` takes a JAX ``CoarseIndex``'s
  leaves under the archive's ``coarse.`` field names.
* :func:`mutable_index_from_arrays` takes a JAX ``MutableIndex``'s
  leaves as the v4 ``mutable_ivf`` archive keys them: the wrapped
  index's under ``index.``, ``delta.vecs`` / ``ids`` / ``live`` /
  ``counts`` with the ``delta.cap`` int, ``row_mask`` and ``id_to_pos``,
  and the host-side ``epoch`` the archive does not keep.
* :func:`mnmg_index_from_arrays` takes a JAX ``MnmgIVFFlatIndex``'s,
  ``MnmgIVFSQIndex``'s or ``MnmgIVFPQIndex``'s leaves (its field names,
  the coarse quantizer's under ``coarse.``) and statics, and returns the
  port's sharded index on the host or, with ``comms``, placed on its
  ranks one rank's slab at a time.
* :func:`mnmg_mutation_state_from_arrays` takes a JAX
  ``MnmgMutationState``'s ``row_mask`` / ``delta_vecs`` / ``delta_ids``
  / ``delta_counts`` and returns the port's state, on the host or placed
  on a communicator's ranks.
* :func:`save_index` writes the repo's npz index format (the JAX
  package's ``spatial/ann/serialize.py``) with numpy alone, for the
  ``"ivf_flat"``, ``"ivf_sq"``, ``"ivf_pq"``, ``"graph"``,
  ``"mutable_ivf"``, ``"mnmg_ivf_flat"``, ``"mnmg_ivf_sq"`` and
  ``"mnmg_ivf_pq"`` kinds: the
  ``__header__`` JSON (type, the lowest format version that holds the
  payload, the static fields, the per-array CRC32/shape/dtype manifest),
  one key per leaf under the reference's field names, bf16 arrays as
  their 16-bit words.
* :func:`load_index` and ``load_*`` read that format for the same kinds:
  versions 1-5, the manifest verified exactly as the writer computed it
  (version 1 archives have none and load unverified). Damage, a future
  version or a kind the port lacks raises
  :class:`~raft_tpu_torch.errors.CorruptIndexError` naming the field.
"""

from __future__ import annotations

import json
import zlib

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.spatial.ann.common import CoarseIndex, ListStorage
from raft_tpu_torch.spatial.ann.graph import GraphIndex, GraphStorage
from raft_tpu_torch.spatial.ann.ivf_flat import IVFFlatIndex
from raft_tpu_torch.spatial.ann.ivf_pq import IVFPQIndex
from raft_tpu_torch.spatial.ann.ivf_sq import IVFSQIndex
from raft_tpu_torch.spatial.ann.mutation import DeltaStore, MutableIndex

__all__ = [
    "coarse_index_from_arrays", "graph_index_from_arrays",
    "ivf_flat_index_from_arrays", "ivf_pq_index_from_arrays",
    "ivf_sq_index_from_arrays", "load_graph", "load_index",
    "load_ivf_flat", "load_ivf_pq", "load_ivf_sq",
    "mnmg_index_from_arrays", "mnmg_mutation_state_from_arrays",
    "mutable_index_from_arrays", "save_index",
]

# 1: no integrity manifest (loads unverified); 2: the manifest; 3-5: the
# coarse quantizer of the sharded indexes, the mutation tier, the graph
# index (the port reads the kinds it has of each)
_READABLE_VERSIONS = (1, 2, 3, 4, 5)
_STORAGE = ("storage.sorted_ids", "storage.list_offsets",
            "storage.list_index", "storage.list_sizes")
# the arrays of each IVF kind, besides centroids and storage
_KIND_ARRAYS = {
    "ivf_flat": ("data_sorted",),
    "ivf_sq": ("codes_sorted", "vmin", "vscale"),
    "ivf_pq": ("codebooks", "codes_sorted", "vectors_sorted"),
}
_GRAPH_ARRAYS = ("data_padded", "storage.adjacency", "storage.entries")
_COARSE_ARRAYS = ("coarse.super_cents", "coarse.member_ids",
                  "coarse.cents_padded")
# the mutation state of a mutable_ivf archive, beside the wrapped index's
# arrays under "index."
_MUTABLE_ARRAYS = ("delta.vecs", "delta.ids", "delta.live", "delta.counts",
                   "row_mask", "id_to_pos")
# the arrays and statics of each sharded kind, in the JAX field order
_MNMG_ARRAYS = {
    "mnmg_ivf_flat": ("centroids", "owner", "local_id", "local_cents",
                      "vectors_sorted", "sorted_ids", "list_offsets",
                      "list_sizes"),
    "mnmg_ivf_sq": ("centroids", "owner", "local_id", "local_cents",
                    "codes_sorted", "vmin", "vscale", "sorted_ids",
                    "list_offsets", "list_sizes"),
    "mnmg_ivf_pq": ("centroids", "codebooks", "owner", "local_id",
                    "local_cents", "codes_sorted", "vectors_sorted",
                    "sorted_ids", "list_offsets", "list_sizes"),
}
_MNMG_STATICS = {
    "mnmg_ivf_flat": ("n_pad", "nl_pad", "max_list", "n_rows", "metric",
                      "replication", "replica_offset"),
    "mnmg_ivf_sq": ("n_pad", "nl_pad", "max_list", "n_rows", "replication",
                    "replica_offset"),
    "mnmg_ivf_pq": ("pq_dim", "pq_bits", "n_pad", "nl_pad", "max_list",
                    "n_rows", "replication", "replica_offset"),
}
# a store_raw=False PQ index has no raw slab
_MNMG_OPTIONAL = frozenset({"vectors_sorted"})
_ALL_MNMG_STATICS = ("pq_dim", "pq_bits", "n_pad", "nl_pad", "max_list",
                     "n_rows", "metric", "replication", "replica_offset")
_COARSE_STATICS = ("coarse.n_cents", "coarse.n_super", "coarse.max_members",
                   "coarse.build_args")
# the wrapped index's nested type name -> its kind
_WRAPPED_KIND = {"IVFFlatIndex": "ivf_flat", "IVFSQIndex": "ivf_sq",
                 "IVFPQIndex": "ivf_pq"}


def _array_crc(arr: np.ndarray) -> int:
    """CRC32 of the array's raw C-order bytes (the writer's rule)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _storage(kind: str, arrays: dict, put) -> ListStorage:
    """Check the leaves of an IVF index against each other (each kind's
    arrays by their leading row count n + 1 and width) and build its
    :class:`ListStorage` on the device ``put`` places arrays on."""
    for key in ("centroids",) + _STORAGE + ("storage.n", "storage.max_list"):
        errors.expects(key in arrays, "%s arrays: missing %r", kind, key)
    n = int(arrays["storage.n"])
    max_list = int(arrays["storage.max_list"])
    n_lists, d = arrays["centroids"].shape
    want = {
        "storage.sorted_ids": (n,),
        "storage.list_offsets": (n_lists + 1,),
        "storage.list_index": (n_lists, max_list),
        "storage.list_sizes": (n_lists,),
        "data_sorted": (n + 1, d),
        "vectors_sorted": (n + 1, d),
        "vmin": (d,),
        "vscale": (d,),
    }
    if "codes_sorted" in arrays:
        want["codes_sorted"] = (n + 1, d if kind == "ivf_sq"
                                else arrays["codes_sorted"].shape[1])
    for key, shape in want.items():
        if arrays.get(key) is not None:
            errors.expects(
                tuple(arrays[key].shape) == shape,
                "%s arrays: %s has shape %s, expected %s", kind, key,
                tuple(arrays[key].shape), shape,
            )
    return ListStorage(*(put(key) for key in _STORAGE), n, max_list)


def _placer(arrays: dict, device):
    """``put(key)``: the array under ``key`` as a tensor on ``device``."""
    dev = resolve_device(device)

    def put(key):
        v = arrays[key]
        if not isinstance(v, torch.Tensor):
            # torch wants writable memory; copies only read-only arrays
            v = np.require(v, requirements="W")
        return torch.as_tensor(v, device=dev)

    return put


def ivf_flat_index_from_arrays(arrays: dict, metric: str,
                               device=None) -> IVFFlatIndex:
    """Build an :class:`IVFFlatIndex` on ``device`` (CUDA by default)
    from the JAX index's leaves; shapes are checked against each other."""
    put = _placer(arrays, device)
    errors.expects("data_sorted" in arrays,
                   "ivf_flat arrays: missing 'data_sorted'")
    storage = _storage("ivf_flat", arrays, put)
    return IVFFlatIndex(put("centroids"), put("data_sorted"), storage,
                        metric)


def ivf_sq_index_from_arrays(arrays: dict, device=None) -> IVFSQIndex:
    """Build an :class:`IVFSQIndex` on ``device`` (CUDA by default) from
    the JAX index's leaves (int8 ``codes_sorted``, f32 ``vmin`` and
    ``vscale``); shapes are checked against each other."""
    put = _placer(arrays, device)
    for key in _KIND_ARRAYS["ivf_sq"]:
        errors.expects(key in arrays, "ivf_sq arrays: missing %r", key)
    storage = _storage("ivf_sq", arrays, put)
    return IVFSQIndex(put("centroids"), put("codes_sorted"), put("vmin"),
                      put("vscale"), storage)


def ivf_pq_index_from_arrays(arrays: dict, pq_dim: int, pq_bits: int,
                             device=None) -> IVFPQIndex:
    """Build an :class:`IVFPQIndex` on ``device`` (CUDA by default) from
    the JAX index's leaves and its statics ``pq_dim`` / ``pq_bits``.
    ``vectors_sorted`` may be absent or None (a ``store_raw=False``
    index); ``codebooks`` may hold inf rows (a build over fewer rows
    than codebook entries)."""
    put = _placer(arrays, device)
    for key in ("codebooks", "codes_sorted"):
        errors.expects(key in arrays, "ivf_pq arrays: missing %r", key)
    storage = _storage("ivf_pq", arrays, put)
    d = arrays["centroids"].shape[1]
    errors.expects(
        tuple(arrays["codebooks"].shape)
        == (pq_dim, 1 << pq_bits, d // max(pq_dim, 1))
        and tuple(arrays["codes_sorted"].shape)[1:] == (pq_dim,),
        "ivf_pq arrays: codebooks %s / codes_sorted %s do not match "
        "pq_dim=%d pq_bits=%d at d=%d", tuple(arrays["codebooks"].shape),
        tuple(arrays["codes_sorted"].shape), pq_dim, pq_bits, d,
    )
    raw = (put("vectors_sorted")
           if arrays.get("vectors_sorted") is not None else None)
    return IVFPQIndex(put("centroids"), put("codebooks"),
                      put("codes_sorted"), storage, raw, int(pq_dim),
                      int(pq_bits))


def graph_index_from_arrays(arrays: dict, metric: str,
                            device=None) -> GraphIndex:
    """Build a :class:`~.graph.GraphIndex` on ``device`` (CUDA by
    default) from the JAX graph index's leaves: ``data_padded`` (n + 1,
    d), stored as f32 (exact for the float types the JAX package keeps),
    the int32 ``storage.adjacency`` (n + 1, degree) and
    ``storage.entries``; shapes are checked against each other."""
    put = _placer(arrays, device)
    for key in _GRAPH_ARRAYS:
        errors.expects(key in arrays, "graph arrays: missing %r", key)
    data, adj, ent = (tuple(arrays[key].shape) for key in _GRAPH_ARRAYS)
    errors.expects(
        len(data) == 2 and len(adj) == 2 and adj[0] == data[0]
        and data[0] >= 2 and len(ent) == 1 and ent[0] >= 1,
        "graph arrays: data_padded %s, storage.adjacency %s and "
        "storage.entries %s do not fit together", data, adj, ent,
    )
    storage = GraphStorage(put("storage.adjacency").to(torch.int32),
                           put("storage.entries").to(torch.int32))
    return GraphIndex(put("data_padded").float(), storage, metric)


def coarse_index_from_arrays(arrays: dict, device=None) -> CoarseIndex:
    """Build the port's :class:`~.common.CoarseIndex` on ``device`` (CUDA
    by default) from a JAX ``CoarseIndex``'s leaves, keyed as the archive
    keys them: ``coarse.super_cents`` (n_super, d), ``coarse.member_ids``
    (n_super, max_members) int32 with the sentinel ``coarse.n_cents``,
    ``coarse.cents_padded`` (n_super, max_members, d), and optionally the
    ``coarse.n_super`` / ``coarse.max_members`` statics (checked against
    the shapes) and ``coarse.build_args``."""
    put = _placer(arrays, device)
    for key in _COARSE_ARRAYS + ("coarse.n_cents",):
        errors.expects(key in arrays, "coarse arrays: missing %r", key)
    sc, mi, cp = (tuple(arrays[key].shape) for key in _COARSE_ARRAYS)
    errors.expects(
        len(sc) == 2 and len(mi) == 2 and mi[0] == sc[0]
        and cp == mi + sc[1:]
        and int(arrays.get("coarse.n_super", sc[0])) == sc[0]
        and int(arrays.get("coarse.max_members", mi[1])) == mi[1],
        "coarse arrays: super_cents %s, member_ids %s and cents_padded %s "
        "do not fit together or the statics", sc, mi, cp,
    )
    return CoarseIndex(
        super_cents=put("coarse.super_cents").float(),
        member_ids=put("coarse.member_ids").to(torch.int32),
        cents_padded=put("coarse.cents_padded").float(),
        n_cents=int(arrays["coarse.n_cents"]),
        n_super=sc[0],
        max_members=mi[1],
        build_args=tuple(arrays.get("coarse.build_args",
                                    (None, None, 10, 0))),
    )


def mutable_index_from_arrays(arrays: dict, kind: str, *, metric=None,
                              pq_dim=None, pq_bits=None,
                              device=None) -> MutableIndex:
    """Build a :class:`~.mutation.MutableIndex` on ``device`` (CUDA by
    default) from a JAX ``MutableIndex``'s leaves: the wrapped ``kind``
    index (``"ivf_flat"`` with ``metric``, ``"ivf_sq"``, or ``"ivf_pq"``
    with ``pq_dim`` / ``pq_bits``) from its leaves under ``index.``,
    the delta segments, ``row_mask``, ``id_to_pos`` and the ``epoch``
    (0 when absent). The dirty set and the journal start empty, as after
    the JAX package's ``load_index``."""
    errors.expects(kind in _WRAPPED_KIND.values(),
                   "mutable arrays: unknown wrapped kind %r", kind)
    for key in _MUTABLE_ARRAYS + ("delta.cap",):
        errors.expects(key in arrays, "mutable arrays: missing %r", key)
    inner = {key[len("index."):]: v for key, v in arrays.items()
             if key.startswith("index.")}
    if kind == "ivf_flat":
        index = ivf_flat_index_from_arrays(inner, metric, device)
    elif kind == "ivf_sq":
        index = ivf_sq_index_from_arrays(inner, device)
    else:
        index = ivf_pq_index_from_arrays(inner, pq_dim, pq_bits, device)
    nl, d = index.centroids.shape
    cap = int(arrays["delta.cap"])
    shapes = {key: tuple(arrays[key].shape) for key in _MUTABLE_ARRAYS}
    want = {"delta.vecs": (nl, cap, d), "delta.ids": (nl, cap),
            "delta.live": (nl, cap), "delta.counts": (nl,),
            "row_mask": (index.storage.n + 1,)}
    for key, shape in want.items():
        errors.expects(shapes[key] == shape,
                       "mutable arrays: %s has shape %s, expected %s", key,
                       shapes[key], shape)
    errors.expects(len(shapes["id_to_pos"]) == 1,
                   "mutable arrays: id_to_pos has shape %s",
                   shapes["id_to_pos"])
    put = _placer(arrays, device)
    delta = DeltaStore(put("delta.vecs"), put("delta.ids"),
                       put("delta.live"), put("delta.counts"), cap)
    out = MutableIndex(index, delta, put("row_mask"), put("id_to_pos"))
    out.epoch = int(arrays.get("epoch", 0))
    return out


def mnmg_index_from_arrays(arrays: dict, comms=None):
    """Build the port's sharded index — a
    :class:`~raft_tpu_torch.comms.MnmgIVFFlatIndex`, a
    :class:`~raft_tpu_torch.comms.MnmgIVFSQIndex` when the arrays hold
    ``vmin``, or a :class:`~raft_tpu_torch.comms.MnmgIVFPQIndex` when
    they hold ``codebooks`` — from a JAX sharded index's leaves and
    statics, keyed by its field names (``centroids``, ``owner``,
    ``local_id``, the per-rank ``local_cents`` / ``vectors_sorted`` /
    ``codes_sorted`` / ``sorted_ids`` / ``list_offsets`` /
    ``list_sizes`` slabs, SQ's ``vmin`` / ``vscale``, PQ's ``codebooks``,
    ``pq_dim`` and ``pq_bits``, ``n_pad``, ``nl_pad``, ``max_list``,
    ``n_rows``, the flat kind's ``metric``, and optionally
    ``replication``, ``replica_offset`` and a ``coarse.`` quantizer; a
    PQ index built with ``store_raw=False`` has no ``vectors_sorted``).
    Shapes are checked against the statics. Returns the host index
    (numpy slabs) or, with ``comms``, the index placed on its ranks
    (:func:`~raft_tpu_torch.comms.place_index`, one rank's slab at a
    time, re-partitioning an index of another rank count)."""
    from raft_tpu_torch.comms.mnmg_ivf import MnmgIVFPQIndex, place_index
    from raft_tpu_torch.comms.mnmg_ivf_flat import (
        MnmgIVFFlatIndex,
        MnmgIVFSQIndex,
    )

    kind = ("mnmg_ivf_pq" if arrays.get("codebooks") is not None
            else "mnmg_ivf_sq" if arrays.get("vmin") is not None
            else "mnmg_ivf_flat")
    names, statics = _MNMG_ARRAYS[kind], _MNMG_STATICS[kind]
    n_required = 6 if kind == "mnmg_ivf_pq" else 4
    for key in names + statics[:n_required]:
        errors.expects(key in arrays or key in _MNMG_OPTIONAL,
                       "%s arrays: missing %r", kind, key)
    a = {key: (None if arrays.get(key) is None
               else np.asarray(arrays[key])) for key in names}
    st = {key: arrays.get(key, 1) for key in statics}
    n_pad, nl_pad = int(st["n_pad"]), int(st["nl_pad"])
    nl_g, d = a["centroids"].shape
    P = a["sorted_ids"].shape[0]
    slab = {"mnmg_ivf_sq": "codes_sorted",
            "mnmg_ivf_flat": "vectors_sorted"}.get(kind)
    want = {
        "owner": (nl_g,), "local_id": (nl_g,),
        "local_cents": (P, nl_pad, d), "sorted_ids": (P, n_pad),
        "list_offsets": (P, nl_pad + 1), "list_sizes": (P, nl_pad),
        "vmin": (d,), "vscale": (d,),
    }
    if slab is not None:
        want[slab] = (P, n_pad + 1, d)
    else:
        m, bits = int(st["pq_dim"]), int(st["pq_bits"])
        want.update(codebooks=(m, 1 << bits, d // m),
                    codes_sorted=(P, n_pad + 1, m),
                    vectors_sorted=(P, n_pad + 1, d))
    for key, shape in want.items():
        errors.expects(
            a.get(key) is None or a[key].shape == shape,
            "%s arrays: %s has shape %s, expected %s", kind, key,
            None if a.get(key) is None else a[key].shape, shape,
        )
    coarse = None
    if arrays.get("coarse.super_cents") is not None:
        coarse = coarse_index_from_arrays(arrays, device="cpu")
    kw = dict(n_pad=n_pad, nl_pad=nl_pad, max_list=int(st["max_list"]),
              n_rows=int(st["n_rows"]), replication=int(st["replication"]),
              replica_offset=int(st["replica_offset"]), coarse=coarse)
    if kind == "mnmg_ivf_pq":
        host = MnmgIVFPQIndex(**a, pq_dim=int(st["pq_dim"]),
                              pq_bits=int(st["pq_bits"]), **kw)
    elif kind == "mnmg_ivf_sq":
        host = MnmgIVFSQIndex(**a, **kw)
    else:
        host = MnmgIVFFlatIndex(**a, metric=str(st["metric"]), **kw)
    return host if comms is None else place_index(comms, host)


def mnmg_mutation_state_from_arrays(arrays: dict, comms=None):
    """The port's :class:`~raft_tpu_torch.comms.mnmg_mutation.MnmgMutationState`
    from a JAX sharded mutation state's four slabs as numpy arrays:
    ``row_mask`` (P, n_pad + 1), ``delta_vecs`` (P, nl_pad * cap, d),
    ``delta_ids`` (P, nl_pad * cap) and ``delta_counts`` (P, nl_pad);
    ``cap`` follows from the shapes. Returns the state on the host or,
    with ``comms``, placed on its ranks (wrap it with the index it was
    made for in a ``MnmgMutableIndex``)."""
    from raft_tpu_torch.comms.mnmg_ivf import _place_sharded
    from raft_tpu_torch.comms.mnmg_mutation import MnmgMutationState

    a = {key: np.asarray(arrays[key]) for key in (
        "row_mask", "delta_vecs", "delta_ids", "delta_counts")}
    P, nlp = a["delta_counts"].shape
    DL = a["delta_ids"].shape[1] if a["delta_ids"].ndim == 2 else -1
    errors.expects(
        a["row_mask"].ndim == 2 and a["row_mask"].shape[0] == P
        and a["delta_ids"].shape == (P, DL) and DL % nlp == 0
        and a["delta_vecs"].shape[:2] == (P, DL),
        "mnmg mutation arrays: inconsistent shapes %s",
        {key: v.shape for key, v in a.items()},
    )
    kw = {key: v if comms is None else _place_sharded(comms, v)
          for key, v in a.items()}
    return MnmgMutationState(**kw, cap=DL // nlp)


# ---------------------------------------------------------------- writer
# each kind's fields in the reference's dataclass order (its key order in
# the archive and in the header's statics), and the nested storages'
_FIELDS = {
    IVFFlatIndex: ("centroids", "data_sorted", "storage", "metric"),
    IVFSQIndex: ("centroids", "codes_sorted", "vmin", "vscale", "storage"),
    IVFPQIndex: ("centroids", "codebooks", "codes_sorted", "storage",
                 "vectors_sorted", "pq_dim", "pq_bits"),
    GraphIndex: ("data_padded", "storage", "metric"),
    ListStorage: ("sorted_ids", "list_offsets", "list_index", "list_sizes",
                  "n", "max_list"),
    GraphStorage: ("adjacency", "entries"),
    MutableIndex: ("index", "delta", "row_mask", "id_to_pos"),
    DeltaStore: ("vecs", "ids", "live", "counts", "cap"),
    CoarseIndex: ("super_cents", "member_ids", "cents_padded", "n_cents",
                  "n_super", "max_members", "build_args"),
}
_KIND_OF = {IVFFlatIndex: "ivf_flat", IVFSQIndex: "ivf_sq",
            IVFPQIndex: "ivf_pq", GraphIndex: "graph",
            MutableIndex: "mutable_ivf"}
# the lowest format version holding each kind (2 for the frozen IVF kinds)
_VERSION_OF = {GraphIndex: 5, MutableIndex: 4}


def _register_sharded() -> None:
    # lazy: the comms package imports this module's package
    from raft_tpu_torch.comms.mnmg_ivf import MnmgIVFPQIndex
    from raft_tpu_torch.comms.mnmg_ivf_flat import (
        MnmgIVFFlatIndex,
        MnmgIVFSQIndex,
    )

    if MnmgIVFFlatIndex not in _KIND_OF:
        for cls, kind, tail in (
                (MnmgIVFFlatIndex, "mnmg_ivf_flat", ("coarse",)),
                (MnmgIVFSQIndex, "mnmg_ivf_sq",
                 ("vectors_sorted", "coarse")),
                (MnmgIVFPQIndex, "mnmg_ivf_pq", ("coarse",))):
            _FIELDS[cls] = _MNMG_ARRAYS[kind] + _MNMG_STATICS[kind] + tail
            _KIND_OF[cls] = kind


def _archived(t, key: str, static: dict) -> np.ndarray:
    """A leaf as the archive holds it: a host array, bf16 as its 16-bit
    words with the dtype tagged in the statics. Host arrays and lists of
    per-rank tensors are accepted too."""
    if isinstance(t, (list, tuple)):
        return np.stack([_archived(b, key, static) for b in t])
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        static[key + ".__dtype__"] = "bfloat16"
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(obj, prefix: str, arrays: dict, static: dict) -> None:
    for name in _FIELDS[type(obj)]:
        v = getattr(obj, name)
        key = prefix + name
        if v is None:
            static[key] = None
        elif type(v) in _FIELDS:
            static[key] = {"__nested__": type(v).__name__}
            _flatten(v, key + ".", arrays, static)
        elif isinstance(v, (torch.Tensor, np.ndarray, list)):
            arrays[key] = _archived(v, key, static)
        elif isinstance(v, tuple):
            static[key] = list(v)
        else:
            static[key] = v


def save_index(index, path) -> None:
    """Write an IVF-Flat, IVF-SQ, IVF-PQ, graph, mutable IVF
    (:class:`~.mutation.MutableIndex`) or sharded IVF-Flat / IVF-SQ /
    IVF-PQ (:class:`~raft_tpu_torch.comms.MnmgIVFFlatIndex`,
    :class:`~raft_tpu_torch.comms.MnmgIVFSQIndex`,
    :class:`~raft_tpu_torch.comms.MnmgIVFPQIndex`, every rank's slab)
    index to ``path`` in the reference's npz format, readable by the JAX
    package's ``load_index``: the header carries the kind, the lowest
    format version that holds the payload (5 for a graph, 4 for a
    mutable index, 3 with a coarse quantizer attached, 2 otherwise), the
    static fields and a CRC32/shape/dtype manifest of the archived bytes
    of every array. Written straight to the file (no second copy in
    memory)."""
    if type(index) not in _KIND_OF:
        _register_sharded()
    if getattr(index, "_placed", None) is not None:
        errors.fail("save_index: the index holds only the slabs of ranks "
                    "%s; save the host index it was placed from",
                    index._placed)
    errors.expects(
        type(index) in _KIND_OF,
        "save_index: unsupported index type %s (supported: %s)",
        type(index).__name__, sorted(_KIND_OF.values()),
    )
    arrays: dict = {}
    static: dict = {}
    _flatten(index, "", arrays, static)
    integrity = {
        key: {"crc32": _array_crc(arr), "shape": list(arr.shape),
              "dtype": str(arr.dtype)}
        for key, arr in arrays.items()
    }
    header = {
        "type": _KIND_OF[type(index)],
        "version": _VERSION_OF.get(
            type(index), 3 if getattr(index, "coarse", None) is not None
            else 2),
        "static": static,
        "integrity": integrity,
    }
    with open(path, "wb") as f:
        np.savez(f, __header__=np.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=np.uint8), **arrays)


# ---------------------------------------------------------------- reader
def _read(npz, manifest, key: str, where: str) -> np.ndarray:
    try:
        arr = npz[key]
    except Exception as e:  # zipfile.BadZipFile, ValueError, OSError
        raise errors.CorruptIndexError(
            f"{where}: array {key!r} unreadable ({e})", field=key
        ) from e
    if manifest is None:        # a version 1 archive: nothing to verify
        return arr
    want = manifest.get(key)
    if want is None:
        raise errors.CorruptIndexError(
            f"{where}: array {key!r} missing from the integrity manifest "
            "(truncated or foreign header)", field=key,
        )
    if list(arr.shape) != want["shape"] or str(arr.dtype) != want["dtype"]:
        raise errors.CorruptIndexError(
            f"{where}: array {key!r} is {arr.dtype}{arr.shape}, manifest "
            f"says {want['dtype']}{tuple(want['shape'])}", field=key,
        )
    if _array_crc(arr) != want["crc32"]:
        raise errors.CorruptIndexError(
            f"{where}: array {key!r} failed CRC32 verification — the "
            "checkpoint is corrupt; rebuild or restore from a replica",
            field=key,
        )
    return arr


def _load_archive(path, kind=None):
    """Read and verify an archive of ``kind`` (None: any kind the port
    has): returns (arrays keyed as archived, with bf16-tagged arrays as
    torch bf16 tensors, the header's statics, the kind)."""
    where = "load_index" if kind is None else f"load_{kind}"
    try:
        npz_file = np.load(path)
    except Exception as e:  # not a zip / truncated central directory
        raise errors.CorruptIndexError(
            f"{where}: archive unreadable ({e})", field="__header__"
        ) from e
    with npz_file as npz:
        try:
            header = json.loads(bytes(npz["__header__"]).decode("utf-8"))
        except Exception as e:  # missing key, bad zip member, bad JSON
            raise errors.CorruptIndexError(
                f"{where}: header unreadable ({e})", field="__header__",
            ) from e
        if header.get("version") not in _READABLE_VERSIONS:
            raise errors.CorruptIndexError(
                f"{where}: format version {header.get('version')!r} is not "
                f"readable (readable: {list(_READABLE_VERSIONS)})",
                field="__header__",
            )
        if kind is None:
            kind = header.get("type")
            if kind not in _FROM_ARRAYS:
                raise errors.CorruptIndexError(
                    f"{where}: index type {kind!r} is not readable by "
                    f"raft_tpu_torch (readable: {sorted(_FROM_ARRAYS)})",
                    field="__header__",
                )
        errors.expects(
            header.get("type") == kind,
            "%s: archive holds a %r index, not %r", where,
            header.get("type"), kind,
        )
        static = header["static"]
        manifest = (None if header["version"] == 1
                    else header.get("integrity") or {})
        if kind == "graph":
            keys = _GRAPH_ARRAYS
        elif kind in _MNMG_ARRAYS:
            keys = _MNMG_ARRAYS[kind] + (
                _COARSE_ARRAYS if static.get("coarse") is not None else ())
        elif kind == "mutable_ivf":
            wrapped = _WRAPPED_KIND.get(
                (static.get("index") or {}).get("__nested__"))
            if wrapped is None:
                raise errors.CorruptIndexError(
                    f"{where}: mutable_ivf archive wraps "
                    f"{static.get('index')!r}, not an IVF index",
                    field="__header__",
                )
            static = dict(static, __wrapped_kind__=wrapped)
            keys = tuple("index." + key for key in ("centroids",) + _STORAGE
                         + _KIND_ARRAYS[wrapped]) + _MUTABLE_ARRAYS
        else:
            keys = ("centroids",) + _STORAGE + _KIND_ARRAYS[kind]
        arrays = {key: _read(npz, manifest, key, where) for key in keys
                  if static.get(key, "") is not None}
    for key, arr in arrays.items():
        tagged = static.get(key + ".__dtype__")
        if tagged is not None:
            # bf16 arrays are archived as their uint16 bits
            errors.expects(tagged == "bfloat16",
                           "%s: unsupported %s dtype %r", where, key, tagged)
            arrays[key] = torch.from_numpy(
                arr.view(np.int16)).view(torch.bfloat16)
    for key in ("storage.n", "storage.max_list", "index.storage.n",
                "index.storage.max_list", "delta.cap") + (
                    _ALL_MNMG_STATICS + _COARSE_STATICS):
        if key in static:
            arrays[key] = static[key]
    return arrays, static, kind


# each readable kind's index from its arrays and statics
_FROM_ARRAYS = {
    "ivf_flat": lambda a, st, dev: ivf_flat_index_from_arrays(
        a, st["metric"], dev),
    "ivf_sq": lambda a, st, dev: ivf_sq_index_from_arrays(a, dev),
    "ivf_pq": lambda a, st, dev: ivf_pq_index_from_arrays(
        a, st["pq_dim"], st["pq_bits"], dev),
    "graph": lambda a, st, dev: graph_index_from_arrays(
        a, st["metric"], dev),
    "mutable_ivf": lambda a, st, dev: mutable_index_from_arrays(
        a, st["__wrapped_kind__"], metric=st.get("index.metric"),
        pq_dim=st.get("index.pq_dim"), pq_bits=st.get("index.pq_bits"),
        device=dev),
    # the sharded kinds are placed by a communicator, not on a device
    "mnmg_ivf_flat": None,
    "mnmg_ivf_sq": None,
    "mnmg_ivf_pq": None,
}


def _load(path, kind, device, comms=None):
    arrays, static, kind = _load_archive(path, kind)
    if kind in _MNMG_ARRAYS:
        return mnmg_index_from_arrays(arrays, comms)
    return _FROM_ARRAYS[kind](arrays, static, resolve_device(device))


def load_index(path, device=None, comms=None):
    """Load an index archive of any kind the port has (``"ivf_flat"``,
    ``"ivf_sq"``, ``"ivf_pq"``, ``"graph"``, ``"mutable_ivf"`` — a
    :class:`~.mutation.MutableIndex` at epoch 0 with an empty dirty
    set, as the JAX package loads it — ``"mnmg_ivf_flat"`` and
    ``"mnmg_ivf_sq"`` and ``"mnmg_ivf_pq"``), written by either
    package's ``save_index``,
    verifying every array against the CRC32 manifest (a version 1
    archive has none), onto ``device`` (CUDA by default). A sharded
    index loads onto the host, or with ``comms`` placed on its ranks
    (re-partitioned when it was saved at another rank count)."""
    return _load(path, None, device, comms)


def load_ivf_flat(path, device=None) -> IVFFlatIndex:
    """Load an ``"ivf_flat"`` index archive written by ``save_index``
    (either package's), verifying every array against the CRC32
    manifest, onto ``device`` (CUDA by default)."""
    return _load(path, "ivf_flat", device)


def load_ivf_sq(path, device=None) -> IVFSQIndex:
    """Load an ``"ivf_sq"`` index archive written by ``save_index``
    (either package's), verifying every array against the CRC32
    manifest, onto ``device`` (CUDA by default)."""
    return _load(path, "ivf_sq", device)


def load_ivf_pq(path, device=None) -> IVFPQIndex:
    """Load an ``"ivf_pq"`` index archive written by ``save_index``
    (either package's), verifying every array against the CRC32
    manifest, onto ``device`` (CUDA by default). A ``store_raw=False``
    archive has no ``vectors_sorted``; search it with
    ``refine_dataset=``."""
    return _load(path, "ivf_pq", device)


def load_graph(path, device=None) -> GraphIndex:
    """Load a ``"graph"`` index archive (format v5) written by
    ``save_index`` (either package's), verifying every array against the
    CRC32 manifest, onto ``device`` (CUDA by default)."""
    return _load(path, "graph", device)
