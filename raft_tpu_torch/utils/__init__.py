"""Small host utilities — the port of ``raft_tpu/utils`` (copied, numpy
only): the prime sieve (reference raft/common/seive.hpp) and the
power-of-two and integer rounding helpers (pow2_utils.cuh,
integer_utils.h).
"""

from raft_tpu_torch.utils.seive import Seive
from raft_tpu_torch.utils.pow2 import (
    Pow2,
    div_rounding_up,
    round_down_safe,
    round_up_safe,
)

__all__ = [
    "Seive",
    "Pow2",
    "round_up_safe",
    "round_down_safe",
    "div_rounding_up",
]
