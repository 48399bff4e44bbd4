"""Carrying an IVF-Flat index across from the JAX package.

* :func:`ivf_flat_index_from_arrays` takes the JAX index's leaves as
  numpy arrays — ``centroids``, ``data_sorted`` and the four
  ``storage.*`` arrays, with the ``storage.n`` and ``storage.max_list``
  ints — keyed as the npz archive keys them.
* :func:`load_ivf_flat` reads the repo's npz index format (the JAX
  package's ``spatial/ann/serialize.py``) for the ``"ivf_flat"`` kind
  with numpy alone: the ``__header__`` JSON (format versions 2-5), the
  ``storage.`` key prefix, and the per-array CRC32/shape/dtype manifest,
  verified exactly as the writer computed it. Damage raises
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
from raft_tpu_torch.spatial.ann.ivf_flat import IVFFlatIndex

__all__ = ["ivf_flat_index_from_arrays", "load_ivf_flat"]

_READABLE_VERSIONS = (2, 3, 4, 5)
_ARRAYS = ("centroids", "data_sorted", "storage.sorted_ids",
           "storage.list_offsets", "storage.list_index",
           "storage.list_sizes")


def _array_crc(arr: np.ndarray) -> int:
    """CRC32 of the array's raw C-order bytes (the writer's rule)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def ivf_flat_index_from_arrays(arrays: dict, metric: str,
                               device=None) -> IVFFlatIndex:
    """Build an :class:`IVFFlatIndex` on ``device`` (CUDA by default)
    from the JAX index's leaves; shapes are checked against each other."""
    dev = resolve_device(device)
    for key in _ARRAYS + ("storage.n", "storage.max_list"):
        errors.expects(key in arrays, "ivf_flat arrays: missing %r", key)
    n = int(arrays["storage.n"])
    max_list = int(arrays["storage.max_list"])
    n_lists, d = arrays["centroids"].shape
    want = {
        "data_sorted": (n + 1, d),
        "storage.sorted_ids": (n,),
        "storage.list_offsets": (n_lists + 1,),
        "storage.list_index": (n_lists, max_list),
        "storage.list_sizes": (n_lists,),
    }
    for key, shape in want.items():
        errors.expects(
            tuple(arrays[key].shape) == shape,
            "ivf_flat arrays: %s has shape %s, expected %s", key,
            tuple(arrays[key].shape), shape,
        )

    def put(key):
        v = arrays[key]
        if not isinstance(v, torch.Tensor):
            # torch wants writable memory; copies only read-only arrays
            v = np.require(v, requirements="W")
        return torch.as_tensor(v, device=dev)

    storage = ListStorage(
        put("storage.sorted_ids"), put("storage.list_offsets"),
        put("storage.list_index"), put("storage.list_sizes"), n, max_list,
    )
    return IVFFlatIndex(put("centroids"), put("data_sorted"), storage,
                        metric)


def _read(npz, manifest: dict, key: str) -> np.ndarray:
    try:
        arr = npz[key]
    except Exception as e:  # zipfile.BadZipFile, ValueError, OSError
        raise errors.CorruptIndexError(
            f"load_ivf_flat: array {key!r} unreadable ({e})", field=key
        ) from e
    want = manifest.get(key)
    if want is None:
        raise errors.CorruptIndexError(
            f"load_ivf_flat: array {key!r} missing from the integrity "
            "manifest (truncated or foreign header)", field=key,
        )
    if list(arr.shape) != want["shape"] or str(arr.dtype) != want["dtype"]:
        raise errors.CorruptIndexError(
            f"load_ivf_flat: array {key!r} is {arr.dtype}{arr.shape}, "
            f"manifest says {want['dtype']}{tuple(want['shape'])}",
            field=key,
        )
    if _array_crc(arr) != want["crc32"]:
        raise errors.CorruptIndexError(
            f"load_ivf_flat: array {key!r} failed CRC32 verification — the "
            "checkpoint is corrupt; rebuild or restore from a replica",
            field=key,
        )
    return arr


def load_ivf_flat(path, device=None) -> IVFFlatIndex:
    """Load an ``"ivf_flat"`` index archive written by the JAX package's
    ``save_index``, verifying every array against the CRC32 manifest,
    onto ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    try:
        npz_file = np.load(path)
    except Exception as e:  # not a zip / truncated central directory
        raise errors.CorruptIndexError(
            f"load_ivf_flat: archive unreadable ({e})", field="__header__"
        ) from e
    with npz_file as npz:
        try:
            header = json.loads(bytes(npz["__header__"]).decode("utf-8"))
        except Exception as e:  # missing key, bad zip member, bad JSON
            raise errors.CorruptIndexError(
                f"load_ivf_flat: header unreadable ({e})",
                field="__header__",
            ) from e
        if header.get("version") not in _READABLE_VERSIONS:
            raise errors.CorruptIndexError(
                f"load_ivf_flat: format version {header.get('version')!r} "
                f"is not readable (readable: {list(_READABLE_VERSIONS)})",
                field="__header__",
            )
        errors.expects(
            header.get("type") == "ivf_flat",
            "load_ivf_flat: archive holds a %r index, not 'ivf_flat'",
            header.get("type"),
        )
        static = header["static"]
        manifest = header.get("integrity") or {}
        arrays = {key: _read(npz, manifest, key) for key in _ARRAYS}
    arrays["storage.n"] = static["storage.n"]
    arrays["storage.max_list"] = static["storage.max_list"]
    tagged = static.get("data_sorted.__dtype__")
    if tagged is not None:
        # bf16 rows are archived as their uint16 bits
        errors.expects(tagged == "bfloat16",
                       "load_ivf_flat: unsupported data_sorted dtype %r",
                       tagged)
        arrays["data_sorted"] = torch.from_numpy(
            arrays["data_sorted"].view(np.int16)).view(torch.bfloat16)
    return ivf_flat_index_from_arrays(arrays, static["metric"], dev)
