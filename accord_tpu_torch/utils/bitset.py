"""Long-word bitsets backing WaitingOn execution frontiers.

Rebuild of the reference's SimpleBitSet/ImmutableBitSet
(ref: accord-core/src/main/java/accord/utils/SimpleBitSet.java:27,
ImmutableBitSet.java:21).  Python ints are arbitrary-precision so the word
array collapses to a single int; ``to_words()`` exports the uint32-word view
that the device drain kernel consumes (accord_tpu.ops.drain)."""

from __future__ import annotations

from typing import Iterator, List


class SimpleBitSet:
    __slots__ = ("_bits", "size")

    def __init__(self, size: int, bits: int = 0):
        self.size = size
        self._bits = bits

    @classmethod
    def full(cls, size: int) -> "SimpleBitSet":
        return cls(size, (1 << size) - 1)

    def set(self, i: int) -> bool:
        """Set bit i; returns True if it was previously unset."""
        was = (self._bits >> i) & 1
        self._bits |= 1 << i
        return not was

    def unset(self, i: int) -> bool:
        was = (self._bits >> i) & 1
        self._bits &= ~(1 << i)
        return bool(was)

    def get(self, i: int) -> bool:
        return bool((self._bits >> i) & 1)

    def is_empty(self) -> bool:
        return self._bits == 0

    def count(self) -> int:
        return bin(self._bits).count("1")

    def first_set(self) -> int:
        """Index of lowest set bit, or -1."""
        if self._bits == 0:
            return -1
        return (self._bits & -self._bits).bit_length() - 1

    def last_set(self) -> int:
        if self._bits == 0:
            return -1
        return self._bits.bit_length() - 1

    def next_set(self, from_i: int) -> int:
        """Lowest set bit >= from_i, or -1."""
        masked = self._bits >> from_i
        if masked == 0:
            return -1
        return from_i + ((masked & -masked).bit_length() - 1)

    def prev_set(self, from_i: int) -> int:
        """Highest set bit <= from_i, or -1."""
        masked = self._bits & ((1 << (from_i + 1)) - 1)
        if masked == 0:
            return -1
        return masked.bit_length() - 1

    def __iter__(self) -> Iterator[int]:
        bits, base = self._bits, 0
        while bits:
            low = bits & -bits
            yield base + low.bit_length() - 1
            bits &= bits - 1

    def bits(self) -> int:
        return self._bits

    def to_words(self, word_bits: int = 32) -> List[int]:
        n_words = (self.size + word_bits - 1) // word_bits
        mask = (1 << word_bits) - 1
        return [(self._bits >> (w * word_bits)) & mask for w in range(n_words)]

    def copy(self) -> "SimpleBitSet":
        return SimpleBitSet(self.size, self._bits)

    def freeze(self) -> "ImmutableBitSet":
        return ImmutableBitSet(self.size, self._bits)

    def __eq__(self, o):
        return isinstance(o, SimpleBitSet) and self._bits == o._bits and self.size == o.size

    def __hash__(self):
        return hash((self.size, self._bits))

    def __repr__(self):
        return f"BitSet({list(self)}/{self.size})"


class ImmutableBitSet(SimpleBitSet):
    __slots__ = ()

    def set(self, i: int) -> bool:
        raise TypeError("immutable")

    def unset(self, i: int) -> bool:
        raise TypeError("immutable")

    def with_set(self, i: int) -> "ImmutableBitSet":
        return ImmutableBitSet(self.size, self._bits | (1 << i))

    def with_unset(self, i: int) -> "ImmutableBitSet":
        return ImmutableBitSet(self.size, self._bits & ~(1 << i))
