"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

A package of its own beside the JAX package ``raft_tpu``, which stays the
reference: each module here keeps the path and public names of its JAX
counterpart, and every TPU (Pallas) kernel on a ported path is a
hand-written CUDA kernel under ``csrc/``, built at first use. Nothing
here imports JAX or the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise.

The submodules, and ``Resources`` / ``DeviceResources`` /
``get_default_resources`` / ``logger``, load on first access, so
``import raft_tpu_torch`` imports no torch (the WAL's kill-9 child,
``python -m raft_tpu_torch.testing.crash``, starts without it).
"""

import importlib

__version__ = "0.1.0"

__all__ = [
    "Resources",
    "DeviceResources",
    "get_default_resources",
    "logger",
    "errors",
    "analysis",
    "cache",
    "cluster",
    "comms",
    "core",
    "distance",
    "durability",
    "label",
    "lap",
    "linalg",
    "matrix",
    "native",
    "obs",
    "pylibraft",
    "random",
    "resilience",
    "serving",
    "sparse",
    "spatial",
    "spectral",
    "stats",
    "testing",
    "tier",
    "tools",
    "utils",
    "__version__",
]

_SUBMODULES = {
    "analysis", "cache", "cluster", "comms", "core", "distance",
    "durability", "errors", "label", "lap", "linalg", "matrix", "native",
    "obs", "pylibraft", "random", "resilience", "serving", "sparse",
    "spatial", "spectral", "stats", "testing", "tier", "tools", "utils",
}

_CORE = {
    "Resources": "raft_tpu_torch.core.resources",
    "DeviceResources": "raft_tpu_torch.core.resources",
    "get_default_resources": "raft_tpu_torch.core.resources",
}


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _CORE:
        return getattr(importlib.import_module(_CORE[name]), name)
    if name == "logger":
        return importlib.import_module(f"{__name__}.core.logger")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
