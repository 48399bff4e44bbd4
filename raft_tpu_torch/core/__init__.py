"""Core runtime of the port — the counterpart of ``raft_tpu/core``:
the resources handle (:class:`Resources`, the analog of ``handle_t``),
the logger, profiler ranges (:mod:`annotate`: ``torch.profiler`` and
NVTX), the mdarray factories, cooperative cancellation
(:mod:`interruptible`), and the port's own device resolution and f32
pinning (:mod:`device`) and container traversal (:mod:`tree`).
"""

from raft_tpu_torch.core.resources import (
    DeviceResources,
    Resources,
    compilation_cache_dir,
    enable_compilation_cache,
    get_default_resources,
)
from raft_tpu_torch.core import logger
from raft_tpu_torch.core.annotate import annotate, pop_range, push_range
from raft_tpu_torch.core.interruptible import (
    InterruptedException as RaftInterruptedError,
    Interruptible,
)

__all__ = [
    "Resources",
    "DeviceResources",
    "enable_compilation_cache",
    "compilation_cache_dir",
    "get_default_resources",
    "logger",
    "annotate",
    "push_range",
    "pop_range",
    "Interruptible",
    "RaftInterruptedError",
]
