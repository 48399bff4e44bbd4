"""Test and load-generation helpers of the port: the seeded open-loop
arrival schedules of :mod:`raft_tpu_torch.testing.load`, the kill-9
ingest gate of :mod:`raft_tpu_torch.testing.crash`, the multi-process
sharded search of :mod:`raft_tpu_torch.testing.dist`, deterministic
fault injection (:mod:`raft_tpu_torch.testing.faults`) and the scripted
chaos-schedule harness with its invariant checkers
(:mod:`raft_tpu_torch.testing.chaos`) that proves the self-healing
supervisor, and the self-heal row that drives it against a live stream
(:mod:`raft_tpu_torch.testing.heal_rows`).

The submodules load on first access, so the kill-9 child
(``python -m raft_tpu_torch.testing.crash``) starts without torch."""

import importlib

__all__ = ["chaos", "faults", "heal_rows", "load"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
