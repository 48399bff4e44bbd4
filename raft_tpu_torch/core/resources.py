"""Resource handle — the port of ``raft_tpu/core/resources.py``, the
analog of ``raft::handle_t``.

The reference handle (cpp/include/raft/core/handle.hpp:54-335) carries
CUDA streams, a stream pool, library handles, device properties and an
injected communicator. Here it carries:

* the device computations land on (a ``torch.device``, CUDA unless the
  caller asks for the CPU: :func:`~raft_tpu_torch.core.device
  .resolve_device`) and an optional communicator of the port's comms
  layer (:mod:`raft_tpu_torch.comms`) in the mesh slot, with named
  sub-communicators (reference handle.hpp:239-264 ``set_comms`` /
  ``get_comms`` / ``set_subcomm``);
* policy: the default float dtype, the matmul precision (accepted for
  the JAX package's API; every value runs full f32 with TF32 off, as
  :func:`~raft_tpu_torch.core.device.full_f32` pins it), and
  ``n_lanes``, the stream-pool-size analog;
* the compile cache: the port's only compile step is the nvcc build of
  its kernels (:mod:`raft_tpu_torch._build`), and
  :func:`enable_compilation_cache` moves that build's root.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch

from raft_tpu_torch.core.device import resolve_device

__all__ = [
    "Resources", "DeviceResources", "compilation_cache_dir",
    "enable_compilation_cache", "ensure_resources", "get_default_resources",
]


@dataclasses.dataclass
class Resources:
    """Per-algorithm-invocation resource context.

    Attributes
    ----------
    device : the ``torch.device`` computations land on (``None`` -> the
        current CUDA device; raises without one).
    mesh : optional communicator of the port's comms layer (a
        ``build_comms`` result), the analog of the injected ``comms_t``.
    sub_meshes : named sub-communicators.
    dtype : default floating dtype of algorithm internals.
    matmul_precision : accepted for the JAX package's API; every value
        runs full f32 products (TF32 off).
    n_lanes : stream-pool-size analog (reference handle.hpp:158-237).
    compilation_cache_dir : when set, :func:`enable_compilation_cache`
        runs with this path: the kernels build under it.
    """

    device: Any = None
    mesh: Optional[Any] = None
    sub_meshes: dict = dataclasses.field(default_factory=dict)
    dtype: Any = torch.float32
    matmul_precision: str = "highest"
    n_lanes: int = 1
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.compilation_cache_dir is not None:
            enable_compilation_cache(self.compilation_cache_dir)

    # -- comms slot ---------------------------------------------------------
    def set_mesh(self, mesh) -> None:
        """Inject the communicator (analog of handle.set_comms)."""
        self.mesh = mesh

    def get_mesh(self):
        if self.mesh is None:
            raise RuntimeError(
                "No mesh set on Resources (analog of 'ERROR: communicator "
                "was not initialized')"
            )
        return self.mesh

    @property
    def has_mesh(self) -> bool:
        return self.mesh is not None

    def set_sub_mesh(self, key: str, mesh) -> None:
        self.sub_meshes[key] = mesh

    def get_sub_mesh(self, key: str):
        return self.sub_meshes[key]

    # -- stream-pool parity --------------------------------------------------
    def get_n_lanes(self) -> int:
        return max(1, int(self.n_lanes))

    # -- device properties ---------------------------------------------------
    def device_kind(self) -> str:
        """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def is_tpu(self) -> bool:
        """Always False: the port runs on CUDA cards or the CPU."""
        return False

    def sync(self, *tensors) -> None:
        """Block until the device's queued work is done (analog of
        ``handle.sync_stream()``): the devices of the given tensors, or
        with none given, the handle's device. A CPU device has nothing
        queued."""
        devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
        if not tensors:
            devs = {self.device}
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


# the name raft 22.08 gave handle_t (device_resources)
DeviceResources = Resources

_cache_lock = threading.Lock()
_cache_dir_enabled: Optional[str] = None


def enable_compilation_cache(
    path: str,
    *,
    min_compile_time_secs: float = 0.0,
    min_entry_size_bytes: int = -1,
) -> None:
    """Build the port's CUDA kernels under ``path`` from now on
    (idempotent; a different path switches over), so a fresh process
    with the same sources loads the built libraries instead of running
    nvcc. The JAX package's knobs of its persistent XLA cache
    (``min_compile_time_secs``, ``min_entry_size_bytes``) are accepted
    and have nothing to set here. Libraries already loaded stay
    loaded."""
    global _cache_dir_enabled
    del min_compile_time_secs, min_entry_size_bytes
    from raft_tpu_torch import _build

    with _cache_lock:
        if _cache_dir_enabled == path:
            return
        _build.set_build_root(path)
        _cache_dir_enabled = path


def compilation_cache_dir() -> Optional[str]:
    """The cache path enabled through this module, or None."""
    with _cache_lock:
        return _cache_dir_enabled


_default_lock = threading.Lock()
_default_resources: Optional[Resources] = None


def get_default_resources() -> Resources:
    """Process-wide default handle (lazily created: on the CUDA device,
    raising without one)."""
    global _default_resources
    with _default_lock:
        if _default_resources is None:
            _default_resources = Resources()
        return _default_resources


def ensure_resources(res: Optional[Resources]) -> Resources:
    return res if res is not None else get_default_resources()
