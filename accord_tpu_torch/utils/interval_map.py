"""Sorted-boundary interval maps with merge semantics.

Rebuild of the reference's ReducingIntervalMap/ReducingRangeMap
(ref: accord-core/src/main/java/accord/utils/ReducingIntervalMap.java,
ReducingRangeMap.java:30) — the base of RedundantBefore, DurableBefore,
MaxConflicts and rejectBefore.  A map is a step function over the token
space: sorted boundary tokens plus one value per gap (including the two
unbounded ends).  Watermarks being step functions over sorted boundaries is
also what makes them natural device arrays (searchsorted lookup).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

from ..utils import invariants

V = TypeVar("V")


class ReducingRangeMap(Generic[V]):
    """Immutable step function token -> V.

    ``boundaries`` is a sorted list of tokens [b0..bn); ``values`` has
    len(boundaries)+1 entries: values[i] applies to [b(i-1), b(i)) with
    values[0] for (-inf, b0) and values[-1] for [bn, +inf).  None means
    'absent'.
    """

    __slots__ = ("boundaries", "values")

    def __init__(self, boundaries: Sequence[int], values: Sequence[Optional[V]]):
        invariants.check_argument(len(values) == len(boundaries) + 1,
                                  "values must have len(boundaries)+1 entries")
        if invariants.PARANOID:
            invariants.check_state(all(boundaries[i] < boundaries[i + 1]
                                       for i in range(len(boundaries) - 1)),
                                   "boundaries must be strictly sorted")
        self.boundaries = tuple(boundaries)
        self.values = tuple(values)

    @classmethod
    def empty(cls) -> "ReducingRangeMap[V]":
        return cls((), (None,))

    @classmethod
    def of_ranges(cls, ranges, value: V) -> "ReducingRangeMap[V]":
        """Step function that is ``value`` on the ranges and None elsewhere."""
        boundaries: List[int] = []
        values: List[Optional[V]] = [None]
        for r in ranges:
            boundaries.extend((r.start, r.end))
            values.extend((value, None))
        return cls(boundaries, values)

    def is_empty(self) -> bool:
        return all(v is None for v in self.values)

    # -- lookup -------------------------------------------------------------
    def _index_of(self, token: int) -> int:
        return bisect_right(self.boundaries, token)

    def get(self, token: int) -> Optional[V]:
        return self.values[self._index_of(token)]

    def fold_over_ranges(self, ranges, fn: Callable[[V, "object"], "object"],
                         initial):
        """Fold fn over every non-None value intersecting the ranges."""
        acc = initial
        for r in ranges:
            lo, hi = self._index_of(r.start), self._index_of(r.end - 1)
            for i in range(lo, hi + 1):
                v = self.values[i]
                if v is not None:
                    acc = fn(v, acc)
        return acc

    def fold_with_bounds(self, fn, initial):
        """Fold fn(value, start_token, end_token, acc) over every segment."""
        import itertools
        from ..primitives.keys import MAX_TOKEN, MIN_TOKEN
        bounds = [MIN_TOKEN, *self.boundaries, MAX_TOKEN]
        acc = initial
        for i, v in enumerate(self.values):
            if v is not None:
                acc = fn(v, bounds[i], bounds[i + 1], acc)
        return acc

    def fold_over_ranges_with_gaps(self, ranges, fn, initial):
        """Like fold_over_ranges, but uncovered segments are passed as None
        — for folds where a coverage gap must not be silently skipped
        (e.g. min-watermark queries)."""
        acc = initial
        for r in ranges:
            lo, hi = self._index_of(r.start), self._index_of(r.end - 1)
            for i in range(lo, hi + 1):
                acc = fn(self.values[i], acc)
        return acc

    def values_intersecting(self, ranges) -> List[V]:
        out: List[V] = []
        self.fold_over_ranges(ranges, lambda v, acc: (out.append(v), acc)[1], None)
        return out

    # -- merge --------------------------------------------------------------
    def merge(self, other: "ReducingRangeMap[V]",
              reduce_fn: Callable[[V, V], V]) -> "ReducingRangeMap[V]":
        """Pointwise merge: where both defined, reduce; else whichever is
        defined (ref: ReducingIntervalMap.merge)."""
        if other.is_empty():
            return self
        if self.is_empty():
            return ReducingRangeMap(other.boundaries, other.values)
        all_bounds = sorted(set(self.boundaries) | set(other.boundaries))
        values: List[Optional[V]] = []

        # evaluate each resulting gap at a representative point
        def at(m: "ReducingRangeMap[V]", i_gap: int) -> Optional[V]:
            # gap i spans (all_bounds[i-1], all_bounds[i]); probe with the
            # left edge (or -inf for the first gap)
            if i_gap == 0:
                return m.values[0]
            return m.get(all_bounds[i_gap - 1])

        for gap in range(len(all_bounds) + 1):
            a, b = at(self, gap), at(other, gap)
            if a is None:
                values.append(b)
            elif b is None:
                values.append(a)
            else:
                values.append(reduce_fn(a, b))
        return ReducingRangeMap(all_bounds, values)._compact()

    def _compact(self) -> "ReducingRangeMap[V]":
        """Drop boundaries separating equal values."""
        if not self.boundaries:
            return self
        boundaries: List[int] = []
        values: List[Optional[V]] = [self.values[0]]
        for i, b in enumerate(self.boundaries):
            if self.values[i + 1] != values[-1]:
                boundaries.append(b)
                values.append(self.values[i + 1])
        return ReducingRangeMap(boundaries, values)

    def add(self, ranges, value: V,
            reduce_fn: Callable[[V, V], V]) -> "ReducingRangeMap[V]":
        """Merge ``value`` over ``ranges`` into this map.

        The hot shape on the serving path is ONE range into a map of N
        segments (MaxConflicts/RedundantBefore take one add per commit),
        so ranges splice in one at a time via :meth:`_add_one` — O(log N
        + touched) instead of the full merge's O(N) rebuild-and-compact.
        The result is the same canonical compacted form the merge path
        produces (``tests/test_utils.py`` pins the equivalence over
        randomized cases)."""
        out = self
        for r in ranges:
            out = out._add_one(r.start, r.end, value, reduce_fn)
        return out

    def _add_one(self, s: int, e: int, value: V,
                 reduce_fn: Callable[[V, V], V]) -> "ReducingRangeMap[V]":
        """Splice ``value`` over [s, e): copy the untouched prefix/suffix,
        reduce only the covered gaps, and re-compact only the joints the
        splice could have made equal (the rest was compacted already)."""
        if s >= e:
            return self
        b, v = self.boundaries, self.values
        lo = bisect_right(b, s)    # gap containing s (== first interior
        #                            boundary index)
        hi = bisect_left(b, e)     # first boundary >= e
        covered = [value if x is None else reduce_fn(x, value)
                   for x in v[lo:hi + 1]]
        nb: List[int] = list(b[:lo])
        nv: List[Optional[V]] = list(v[:lo])
        if not (lo and b[lo - 1] == s):
            nb.append(s)
            nv.append(v[lo])       # left sliver of the split gap
        w0 = len(nb) - 1           # first joint the splice can affect
        nb.extend(b[lo:hi])
        nv.extend(covered)
        if hi < len(b) and b[hi] == e:
            w1 = len(nb)           # joint between last covered and suffix
            nb.extend(b[hi:])
            nv.extend(v[hi + 1:])
        else:
            w1 = len(nb)
            nb.append(e)
            nb.extend(b[hi:])
            nv.extend(v[hi:])      # right sliver keeps the old value
        # local compaction over boundary indices [w0, w1]: drop any
        # boundary whose two sides became equal (reduce can equalize
        # neighbours — e.g. a max() above both)
        kb: List[int] = list(nb[:max(w0, 0)])
        kv: List[Optional[V]] = list(nv[:max(w0, 0) + 1])
        for k in range(max(w0, 0), len(nb)):
            if k <= w1 and nv[k + 1] == kv[-1]:
                continue
            kb.append(nb[k])
            kv.append(nv[k + 1])
        return ReducingRangeMap(kb, kv)

    def __eq__(self, o):
        return (isinstance(o, ReducingRangeMap)
                and self.boundaries == o.boundaries and self.values == o.values)

    def __repr__(self):
        return f"RangeMap(b={list(self.boundaries)}, v={list(self.values)})"
