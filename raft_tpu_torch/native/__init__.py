"""Native host runtime of the port — the counterpart of
``raft_tpu/native`` (analog of the reference's precompiled runtime
libraries, cpp/src/): ``ctypes`` bindings over the C++ host algorithms in
``src/host_algos.cpp``, the port's own copy of the JAX package's source.

The library is compiled with ``g++`` at first use (never at import) into
``build/raft_tpu_torch/native/<source hash>/`` under the checkout — the
root that ``raft_tpu_torch._build.set_build_root`` moves — through a
temporary file and an atomic rename, so a failed or concurrent build
never leaves a half-written library behind. Nothing is written next to
the package.

When the library cannot be built or loaded, :func:`available` is False
and the callers (``sparse.hierarchy``) take their numpy routes, as the
JAX package falls back when its import fails; each such fallback counts
in :data:`NATIVE_FALLBACKS`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["NATIVE_FALLBACKS", "available", "dendrogram", "extract_flat",
           "lib_path", "make_monotonic", "merge_topk"]

_SRC = Path(__file__).resolve().parent / "src" / "host_algos.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB_NAME = "libraft_tpu_torch_host.so"

# host routes taken because the library was unavailable
NATIVE_FALLBACKS = 0

_LOCK = threading.Lock()
_STATE = {"lib": None, "error": None}


def lib_path() -> Path:
    """Where the library of the current source lives: the build root,
    ``native``, the first 16 hex digits of the source's and flags'
    SHA-256."""
    from raft_tpu_torch import _build

    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _build._ROOT[0] / "native" / h.hexdigest()[:16] / _LIB_NAME


def _compile(lib: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.chmod(tmp, 0o755)        # mkstemp's 0600 would keep others out
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_i32, c_i64 = ctypes.c_int32, ctypes.c_int64
    lib.rt_build_dendrogram.restype = c_i64
    lib.rt_build_dendrogram.argtypes = [i32, i32, f32, c_i64, c_i32, i64,
                                        f64, i64]
    lib.rt_extract_flat.restype = None
    lib.rt_extract_flat.argtypes = [i64, c_i64, c_i32, c_i32, i32]
    lib.rt_make_monotonic.restype = c_i32
    lib.rt_make_monotonic.argtypes = [i32, i32, c_i64, c_i32]
    lib.rt_merge_topk.restype = None
    lib.rt_merge_topk.argtypes = [f32, i32, c_i32, c_i32, c_i32, f32, i32]
    return lib


def _lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``ImportError``
    (with the cause) when it cannot be built or loaded. A failure is
    kept, so the build is tried once a process."""
    with _LOCK:
        if _STATE["lib"] is None and _STATE["error"] is None:
            try:
                lib = lib_path()
                if not lib.exists():
                    _compile(lib)
                _STATE["lib"] = _bind(ctypes.CDLL(str(lib)))
            except Exception as e:      # no toolchain, a failed build
                _STATE["error"] = e
        if _STATE["lib"] is None:
            raise ImportError(
                f"raft_tpu_torch.native unavailable: {_STATE['error']}")
        return _STATE["lib"]


def available() -> bool:
    """Whether the native library is built and loaded (building it on
    first call)."""
    try:
        _lib()
    except ImportError:
        return False
    return True


def dendrogram(src, dst, weights, n: int):
    """Agglomerative merge of weight-sorted edges (native
    build_dendrogram_host). Returns (children (n_merges, 2) int64, deltas
    f64, sizes int64)."""
    lib = _lib()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    children = np.zeros((max(n - 1, 1), 2), np.int64)
    deltas = np.zeros(max(n - 1, 1), np.float64)
    sizes = np.zeros(max(n - 1, 1), np.int64)
    n_merges = lib.rt_build_dendrogram(src, dst, weights, len(src), n,
                                       children.reshape(-1), deltas, sizes)
    return children[:n_merges], deltas[:n_merges], sizes[:n_merges]


def extract_flat(children, n: int, n_clusters: int) -> np.ndarray:
    """The dendrogram cut into ``n_clusters`` flat labels, relabelled by
    first occurrence (int32)."""
    lib = _lib()
    children = np.ascontiguousarray(children, np.int64)
    labels = np.zeros(n, np.int32)
    lib.rt_extract_flat(children.reshape(-1), len(children), n, n_clusters,
                        labels)
    return labels


def make_monotonic(labels, n_max: int = None) -> np.ndarray:
    """First-occurrence monotonic relabel (label/classlabels.cuh)."""
    lib = _lib()
    labels = np.ascontiguousarray(labels, np.int32)
    if n_max is None:
        n_max = int(labels.max()) + 1 if len(labels) else 1
    out = np.zeros_like(labels)
    lib.rt_make_monotonic(labels, out, len(labels), n_max)
    return out


def merge_topk(part_dists, part_indices):
    """P-way sorted merge of (P, m, k) top-k lists: (m, k) distances f32,
    ids int32."""
    lib = _lib()
    d = np.ascontiguousarray(part_dists, np.float32)
    i = np.ascontiguousarray(part_indices, np.int32)
    P, m, k = d.shape
    out_d = np.zeros((m, k), np.float32)
    out_i = np.zeros((m, k), np.int32)
    lib.rt_merge_topk(d.reshape(-1), i.reshape(-1), P, m, k,
                      out_d.reshape(-1), out_i.reshape(-1))
    return out_d, out_i
