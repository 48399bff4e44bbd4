"""Carrying IVF and graph indexes across from the JAX package.

* ``*_index_from_arrays`` take a JAX index's leaves as numpy arrays,
  keyed as the npz archive keys them. An IVF index has ``centroids``,
  the four ``storage.*`` arrays with the ``storage.n`` and
  ``storage.max_list`` ints, and the kind's own arrays (IVF-Flat
  ``data_sorted``; IVF-SQ ``codes_sorted``, ``vmin``, ``vscale``; IVF-PQ
  ``codebooks``, ``codes_sorted`` and, unless built with
  ``store_raw=False``, ``vectors_sorted``). A graph index has
  ``data_padded``, ``storage.adjacency`` and ``storage.entries``.
* ``load_*`` read the repo's npz index format (the JAX package's
  ``spatial/ann/serialize.py``) for the ``"ivf_flat"``, ``"ivf_sq"``,
  ``"ivf_pq"`` and ``"graph"`` kinds with numpy alone: the
  ``__header__`` JSON (format versions 2-5), the ``storage.`` key
  prefix, bf16 arrays archived as their 16-bit words, and the per-array
  CRC32/shape/dtype manifest, verified exactly as the writer computed
  it. Damage raises
  :class:`~raft_tpu_torch.errors.CorruptIndexError` naming the field.
"""

from __future__ import annotations

import json
import zlib

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.spatial.ann.common import ListStorage
from raft_tpu_torch.spatial.ann.graph import GraphIndex, GraphStorage
from raft_tpu_torch.spatial.ann.ivf_flat import IVFFlatIndex
from raft_tpu_torch.spatial.ann.ivf_pq import IVFPQIndex
from raft_tpu_torch.spatial.ann.ivf_sq import IVFSQIndex

__all__ = [
    "graph_index_from_arrays", "ivf_flat_index_from_arrays",
    "ivf_pq_index_from_arrays", "ivf_sq_index_from_arrays", "load_graph",
    "load_ivf_flat", "load_ivf_pq", "load_ivf_sq",
]

_READABLE_VERSIONS = (2, 3, 4, 5)
_STORAGE = ("storage.sorted_ids", "storage.list_offsets",
            "storage.list_index", "storage.list_sizes")
# the arrays of each IVF kind, besides centroids and storage
_KIND_ARRAYS = {
    "ivf_flat": ("data_sorted",),
    "ivf_sq": ("codes_sorted", "vmin", "vscale"),
    "ivf_pq": ("codebooks", "codes_sorted", "vectors_sorted"),
}
_GRAPH_ARRAYS = ("data_padded", "storage.adjacency", "storage.entries")


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


def _read(npz, manifest: dict, key: str, where: str) -> np.ndarray:
    try:
        arr = npz[key]
    except Exception as e:  # zipfile.BadZipFile, ValueError, OSError
        raise errors.CorruptIndexError(
            f"{where}: array {key!r} unreadable ({e})", field=key
        ) from e
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


def _load_archive(path, kind: str):
    """Read and verify an archive of ``kind``: returns (arrays keyed as
    archived, with bf16-tagged arrays as torch bf16 tensors, and the
    header's statics)."""
    where = f"load_{kind}"
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
        errors.expects(
            header.get("type") == kind,
            "%s: archive holds a %r index, not %r", where,
            header.get("type"), kind,
        )
        static = header["static"]
        manifest = header.get("integrity") or {}
        keys = (_GRAPH_ARRAYS if kind == "graph"
                else ("centroids",) + _STORAGE + _KIND_ARRAYS[kind])
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
    for key in ("storage.n", "storage.max_list"):
        if key in static:
            arrays[key] = static[key]
    return arrays, static


def load_ivf_flat(path, device=None) -> IVFFlatIndex:
    """Load an ``"ivf_flat"`` index archive written by the JAX package's
    ``save_index``, verifying every array against the CRC32 manifest,
    onto ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    arrays, static = _load_archive(path, "ivf_flat")
    return ivf_flat_index_from_arrays(arrays, static["metric"], dev)


def load_ivf_sq(path, device=None) -> IVFSQIndex:
    """Load an ``"ivf_sq"`` index archive written by the JAX package's
    ``save_index``, verifying every array against the CRC32 manifest,
    onto ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    arrays, _ = _load_archive(path, "ivf_sq")
    return ivf_sq_index_from_arrays(arrays, dev)


def load_ivf_pq(path, device=None) -> IVFPQIndex:
    """Load an ``"ivf_pq"`` index archive written by the JAX package's
    ``save_index``, verifying every array against the CRC32 manifest,
    onto ``device`` (CUDA by default). A ``store_raw=False`` archive has
    no ``vectors_sorted``; search it with ``refine_dataset=``."""
    dev = resolve_device(device)
    arrays, static = _load_archive(path, "ivf_pq")
    return ivf_pq_index_from_arrays(arrays, static["pq_dim"],
                                    static["pq_bits"], dev)


def load_graph(path, device=None) -> GraphIndex:
    """Load a ``"graph"`` index archive (format v5) written by the JAX
    package's ``save_index``, verifying every array against the CRC32
    manifest, onto ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    arrays, static = _load_archive(path, "graph")
    return graph_index_from_arrays(arrays, static["metric"], dev)
