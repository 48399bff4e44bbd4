"""Handle / Stream facade — the port of ``raft_tpu/pylibraft/common.py``,
the analog of pylibraft.common (python/pylibraft/pylibraft/common/
handle.pyx Handle, common/cuda.pyx Stream; pyraft
python/raft/raft/common/handle.pyx:30-60).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources

__all__ = ["Handle", "Stream", "DeviceResources"]


class Stream:
    """API-parity stream object (reference common/cuda.pyx): a named
    ``torch.cuda.Stream`` where a CUDA device is present. ``sync()``
    waits for the work queued on it; without a card it is a no-op."""

    def __init__(self, name: str = "default"):
        self.name = name
        self.stream = (torch.cuda.Stream() if torch.cuda.is_available()
                       else None)

    def sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


class Handle(Resources):
    """pyraft/pylibraft Handle (handle.pyx:30-60): a Resources subclass
    with the n_streams constructor knob mapped to dispatch lanes."""

    def __init__(self, n_streams: int = 0, device=None, mesh=None):
        super().__init__(device=device, mesh=mesh, n_lanes=max(n_streams, 1))

    def sync(self, *tensors) -> None:  # handle.sync() parity
        super().sync(*tensors)


DeviceResources = Handle


def _place(x, handle) -> torch.Tensor:
    """``x`` (anything ``torch.as_tensor`` takes) as a tensor on the
    handle's device; float64 becomes float32, as the JAX package stores
    f64 input."""
    from raft_tpu_torch.core.device import as_tensor

    return as_tensor(x, ensure_resources(handle).device)
