"""Build and load the port's CUDA kernels.

Each ``raft_tpu_torch/csrc/<name>.cu`` compiles at first use into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). All sources build together,
one ``nvcc`` process each, into ``build/raft_tpu_torch/<hash>/`` under
the checkout; the hash covers every source, header and flag, so an
edited source rebuilds and an unchanged one is reused. Only the sources
in this package are ever compiled. A failed build raises with nvcc's
stderr. :func:`set_build_root` moves the root (``core.resources
.enable_compilation_cache`` points it at a cache directory of the
caller's).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_all", "load", "set_build_root"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "raft_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict = {}
# the directory the hashed build directories go under
_ROOT = [_BUILD_ROOT]


def set_build_root(path=None) -> None:
    """Build (and look for built libraries) under ``path`` from now on;
    None restores the default under the checkout. Libraries already
    loaded stay loaded."""
    with _LOCK:
        _ROOT[0] = _BUILD_ROOT if path is None else Path(path)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "raft_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin and PATH); the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _ROOT[0] / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source whose library is missing, all in parallel;
    returns the build directory."""
    out_dir = _build_dir()
    todo = [s for s in _sources()
            if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failures = []
    for src, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failures:
        raise RuntimeError(
            "raft_tpu_torch: nvcc failed for " + "\n".join(failures)
        )
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _LIBS[name] = lib
        return lib
