"""Device resolution and matmul precision for the port's entry points.

The port runs on a CUDA card unless the caller asks for the CPU:
``device=None`` means CUDA, and resolving it on a machine without a CUDA
device raises instead of quietly running on the CPU. Tests pass
``device="cpu"`` explicitly.

Every float32 product that the JAX package runs at default or HIGHEST
precision runs in full float32 here: on its CPU reference both mean
IEEE f32, while TF32 would keep about three decimal digits.
:func:`full_f32` pins that for the duration of a call.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["as_tensor", "call_device", "full_f32", "hopper_device",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raise when CUDA is asked for
    (explicitly or by default) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "raft_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly"
        )
    return dev


def hopper_device(device: torch.device) -> bool:
    """Whether ``device`` is a CUDA card of compute capability 9.0, the
    target of the port's ``sm_90a`` kernels."""
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) == (9, 0))


def call_device(*args, device=None) -> torch.device:
    """The device a call runs on: ``device`` when given, else that of
    the first tensor among ``args``, else :func:`resolve_device`'s
    default (CUDA, or raise)."""
    if device is not None:
        return resolve_device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``; float64 becomes float32, as the
    JAX package stores f64 input (x64 off)."""
    t = torch.as_tensor(x, device=device)
    return t.float() if t.dtype == torch.float64 else t


@contextlib.contextmanager
def _full_f32_ctx():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def full_f32(fn):
    """Decorator: run ``fn`` with TF32 matmuls off (restored after)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _full_f32_ctx():
            return fn(*args, **kwargs)
    return wrapped
