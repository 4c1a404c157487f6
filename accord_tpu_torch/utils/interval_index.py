"""Checkpointed interval index for range stabbing/overlap queries.

Rebuild of ref: accord-core/src/main/java/accord/utils/SearchableRangeList
.java:19-48 + CheckpointIntervalArrayBuilder.java (the CINTIA structure):
intervals sorted by start, with periodic checkpoints recording which earlier
intervals are still open, so a stabbing query scans O(checkpoint window + k)
instead of the whole list.  This is the host analogue of the device
interval-overlap kernel's footprint table (accord_tpu.ops.deps_kernel).
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator, List, Tuple

_CHECKPOINT_EVERY = 8


class SearchableRangeList:
    """Immutable index over (start, end, payload) half-open intervals."""

    __slots__ = ("_entries", "_starts", "_checkpoints")

    def __init__(self, entries: Iterable[Tuple[int, int, object]]):
        self._entries: List[Tuple[int, int, object]] = sorted(
            entries, key=lambda e: (e[0], e[1]))
        self._starts = [e[0] for e in self._entries]
        # checkpoint i covers entry index i*_CHECKPOINT_EVERY and stores the
        # indices of EARLIER intervals still open at that entry's start
        self._checkpoints: List[Tuple[int, ...]] = []
        open_: List[int] = []
        for i, (s, _e, _p) in enumerate(self._entries):
            if i % _CHECKPOINT_EVERY == 0:
                open_ = [j for j in open_ if self._entries[j][1] > s]
                self._checkpoints.append(tuple(open_))
            open_.append(i)

    def __len__(self) -> int:
        return len(self._entries)

    def stabbing(self, token: int) -> Iterator[Tuple[int, int, object]]:
        """Entries whose [start, end) contains ``token``."""
        pos = bisect.bisect_right(self._starts, token)
        if pos == 0:
            return
        cp = (pos - 1) // _CHECKPOINT_EVERY
        for j in self._checkpoints[cp]:
            s, e, p = self._entries[j]
            if s <= token < e:
                yield self._entries[j]
        for j in range(cp * _CHECKPOINT_EVERY, pos):
            s, e, p = self._entries[j]
            if s <= token < e:
                yield self._entries[j]

    def overlapping(self, lo: int, hi: int) -> Iterator[Tuple[int, int, object]]:
        """Entries overlapping [lo, hi) — the stabbing set at lo plus every
        entry starting inside the window."""
        emitted = set()
        for entry in self.stabbing(lo):
            emitted.add(id(entry))
            yield entry
        i = bisect.bisect_left(self._starts, lo)
        # entries with start == lo are caught by stabbing only if end > lo;
        # walk from the first start >= lo
        for j in range(i, len(self._entries)):
            s, e, p = self._entries[j]
            if s >= hi:
                break
            entry = self._entries[j]
            if id(entry) not in emitted and e > lo:
                yield entry
