"""Seedable deterministic randomness threaded through the whole framework.

Rebuild of the reference's RandomSource abstraction
(ref: accord-core/src/main/java/accord/utils/RandomSource.java): every
component that needs randomness receives a RandomSource so the entire
distributed system is a pure function of (seed, workload).  Includes the
biased / zipf helpers the burn test relies on
(ref: accord-core/src/test/java/accord/utils/Gens.java).
"""

from __future__ import annotations

import math
import random as _pyrandom
from typing import List, Sequence, TypeVar

T = TypeVar("T")


class RandomSource:
    """Deterministic RNG. Fork with ``fork()`` to derive independent streams."""

    __slots__ = ("_rng",)

    def __init__(self, seed: int):
        self._rng = _pyrandom.Random(seed)

    # -- core ---------------------------------------------------------------
    def next_int(self, bound: int) -> int:
        """Uniform int in [0, bound)."""
        return self._rng.randrange(bound)

    def next_int_range(self, lo: int, hi: int) -> int:
        """Uniform int in [lo, hi)."""
        return self._rng.randrange(lo, hi)

    def next_long(self) -> int:
        return self._rng.getrandbits(63)

    def next_float(self) -> float:
        return self._rng.random()

    def next_boolean(self) -> bool:
        return self._rng.random() < 0.5

    def decide(self, probability: float) -> bool:
        return self._rng.random() < probability

    def fork(self) -> "RandomSource":
        return RandomSource(self._rng.getrandbits(62))

    def seed(self) -> int:
        """Derive a child seed (advances this source)."""
        return self._rng.getrandbits(62)

    # -- collections --------------------------------------------------------
    def pick(self, items: Sequence[T]) -> T:
        return items[self._rng.randrange(len(items))]

    def pick_weighted(self, items: Sequence[T], weights: Sequence[float]) -> T:
        return self._rng.choices(list(items), weights=list(weights), k=1)[0]

    def shuffle(self, items: List[T]) -> List[T]:
        self._rng.shuffle(items)
        return items

    def sample(self, items: Sequence[T], k: int) -> List[T]:
        return self._rng.sample(list(items), k)

    # -- distributions (burn-test workload shaping) -------------------------
    def next_zipf(self, n: int, skew: float = 0.9) -> int:
        """Zipf-distributed int in [0, n). Inverse-CDF by bisection over the
        harmonic partial sums; O(log n) per draw with a cached table."""
        table = self._zipf_table(n, skew)
        u = self._rng.random() * table[-1]
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if table[mid] < u:
                lo = mid + 1
            else:
                hi = mid
        return lo

    _zipf_cache: dict = {}

    @classmethod
    def _zipf_table(cls, n: int, skew: float):
        key = (n, skew)
        tab = cls._zipf_cache.get(key)
        if tab is None:
            acc, tab = 0.0, []
            for i in range(1, n + 1):
                acc += 1.0 / math.pow(i, skew)
                tab.append(acc)
            cls._zipf_cache[key] = tab
        return tab

    def next_biased(self, lo: int, median: int, hi: int) -> int:
        """Biased int in [lo, hi): half the mass below ``median``
        (mirrors the reference's biased generators in test Gens)."""
        if self._rng.random() < 0.5:
            return self._rng.randrange(lo, max(lo + 1, median))
        return self._rng.randrange(min(median, hi - 1), hi)
