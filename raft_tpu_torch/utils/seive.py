"""Host prime sieve — analog of cpp/include/raft/common/seive.hpp
(class Seive: Sieve of Eratosthenes over a fixed range, used by hashing
utilities)."""

from __future__ import annotations

import numpy as np

__all__ = ["Seive"]


class Seive:
    """Sieve of Eratosthenes up to ``n`` (reference seive.hpp:28)."""

    def __init__(self, n: int):
        self.n = n
        sieve = np.ones(n + 1, bool)
        sieve[:2] = False
        for p in range(2, int(n**0.5) + 1):
            if sieve[p]:
                sieve[p * p :: p] = False
        self._mask = sieve

    def is_prime(self, x: int) -> bool:
        """reference seive.hpp isPrime()."""
        return bool(self._mask[x])

    def primes(self) -> np.ndarray:
        return np.nonzero(self._mask)[0]
