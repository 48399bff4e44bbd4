"""Linear assignment of the port — the counterpart of ``raft_tpu.lap``
(analog of raft/lap: cpp/include/raft/lap/lap.cuh:44-192
``LinearAssignmentProblem``), by the auction algorithm with epsilon
scaling.
"""

from raft_tpu_torch.lap.lap import (
    LinearAssignmentProblem,
    solve_lap,
    solve_lap_batched,
)

__all__ = ["LinearAssignmentProblem", "solve_lap", "solve_lap_batched"]
