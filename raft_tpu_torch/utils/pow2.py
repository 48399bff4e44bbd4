"""Power-of-two arithmetic helpers — analog of
cpp/include/raft/pow2_utils.cuh (struct Pow2: roundUp/roundDown/mod/div)
and integer_utils.h (round_up_safe, div_rounding_up_safe)."""

from __future__ import annotations

__all__ = ["Pow2", "round_up_safe", "round_down_safe", "div_rounding_up"]


class Pow2:
    """Mirror of the reference Pow2<Value> helper (pow2_utils.cuh)."""

    def __init__(self, value: int):
        if value <= 0 or value & (value - 1):
            raise ValueError(f"{value} is not a power of two")
        self.value = value
        self.mask = value - 1
        self.log2 = value.bit_length() - 1

    def round_up(self, x: int) -> int:
        return (x + self.mask) & ~self.mask

    def round_down(self, x: int) -> int:
        return x & ~self.mask

    def div(self, x: int) -> int:
        return x >> self.log2

    def mod(self, x: int) -> int:
        return x & self.mask

    def is_aligned(self, x: int) -> bool:
        return (x & self.mask) == 0


def round_up_safe(x: int, multiple: int) -> int:
    """reference integer_utils.h round_up_safe."""
    return ((x + multiple - 1) // multiple) * multiple


def round_down_safe(x: int, multiple: int) -> int:
    return (x // multiple) * multiple


def div_rounding_up(x: int, divisor: int) -> int:
    return (x + divisor - 1) // divisor
