"""LatestDeps: the ballot-aware per-range dependency merge for recovery.

Rebuild of ref: accord-core/src/main/java/accord/primitives/LatestDeps.java:40
— a ReducingRangeMap from token segments to (grade, ballot, coordinated deps,
local deps) entries.  Per segment, the MOST DECIDED knowledge wins; among
equal Accept-phase proposals the HIGHEST BALLOT wins (a superseding Accept
replaces lower proposals — unioning them over-constrains recovery's
re-proposal under contention); pre-Accept local witness scans union (any of
them may hold a fact the eventual proposal must cover).

Grades mirror Status.KnownDeps phases:
  LOCAL    — no coordinated proposal; deps are the replica's own witness scan
             (ref DepsUnknown + localDeps);
  PROPOSED — an Accept-phase proposal under ``ballot`` (ref DepsProposed;
             tie-breaks by ballot);
  DECIDED  — committed deps: all replicas that have them hold the same
             agreed set (ref DepsKnown and above).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.interval_map import ReducingRangeMap
from .deps import Deps
from .keys import Range, Ranges
from .timestamp import Ballot

LOCAL = 0
PROPOSED = 1
DECIDED = 2


class LatestEntry:
    __slots__ = ("known", "ballot", "coordinated", "local")

    def __init__(self, known: int, ballot: Ballot,
                 coordinated: Optional[Deps], local: Optional[Deps]):
        self.known = known
        self.ballot = ballot
        self.coordinated = coordinated
        self.local = local

    @staticmethod
    def reduce(a: "LatestEntry", b: "LatestEntry") -> "LatestEntry":
        """(ref: AbstractEntry.reduce) — pick the more decided entry; within
        PROPOSED the higher ballot; union locals below DECIDED."""
        win, lose = a, b
        if (b.known, b.ballot if b.known == PROPOSED else Ballot.ZERO) > \
                (a.known, a.ballot if a.known == PROPOSED else Ballot.ZERO):
            win, lose = b, a
        if win.known >= DECIDED:
            return win
        local = _union(win.local, lose.local)
        if local is win.local:
            return win
        return LatestEntry(win.known, win.ballot, win.coordinated, local)

    def __eq__(self, o):
        return (isinstance(o, LatestEntry) and self.known == o.known
                and self.ballot == o.ballot
                and self.coordinated == o.coordinated
                and self.local == o.local)

    def __repr__(self):
        tag = {LOCAL: "local", PROPOSED: "proposed", DECIDED: "decided"}
        return f"LatestEntry({tag[self.known]}@{self.ballot})"


def _union(a: Optional[Deps], b: Optional[Deps]) -> Optional[Deps]:
    if a is None:
        return b
    if b is None:
        return a
    return a.with_(b)


def _slice(deps: Optional[Deps], ranges: Ranges) -> Optional[Deps]:
    if deps is None:
        return None
    return Deps(deps.key_deps.slice(ranges), deps.range_deps.slice(ranges))


class LatestDeps:
    """(ref: primitives/LatestDeps.java)."""

    __slots__ = ("map",)

    def __init__(self, map: Optional[ReducingRangeMap] = None):
        self.map = map if map is not None else ReducingRangeMap.empty()

    @classmethod
    def none(cls) -> "LatestDeps":
        return cls()

    @classmethod
    def create(cls, ranges: Ranges, known: int, ballot: Ballot,
               coordinated: Optional[Deps],
               local: Optional[Deps]) -> "LatestDeps":
        if ranges.is_empty():
            return cls()
        entry = LatestEntry(known, ballot, _slice(coordinated, ranges),
                            _slice(local, ranges))
        return cls(ReducingRangeMap.of_ranges(ranges, entry))

    def merge(self, other: "LatestDeps") -> "LatestDeps":
        return LatestDeps(self.map.merge(other.map, LatestEntry.reduce))

    @staticmethod
    def merge_all(items: List["LatestDeps"]) -> "LatestDeps":
        out = LatestDeps.none()
        for it in items:
            if it is not None:
                out = out.merge(it)
        return out

    # -- extraction ----------------------------------------------------------
    def merge_proposal(self) -> Deps:
        """Deps to re-propose (ref: LatestDeps.mergeProposal / forProposal):
        per segment the winning proposal's deps alone — NOT the union of all
        proposals — with local witness scans only where nothing was
        proposed."""
        def fn(entry: LatestEntry, start: int, end: int, acc: Deps) -> Deps:
            seg = Ranges.of(Range(start, end))
            if entry.known >= PROPOSED:
                picked = _slice(entry.coordinated, seg)
            else:
                picked = _slice(entry.local, seg)
            return acc if picked is None else acc.with_(picked)

        return self.map.fold_with_bounds(fn, Deps.none())

    def merge_commit(self, accept_local: bool) -> Tuple[Deps, Ranges]:
        """Deps for committing/executing plus the ranges they are sufficient
        for (ref: LatestDeps.mergeCommit / forCommit).  ``accept_local`` is
        txnId == executeAt: there, local witness scans (and proposal+local
        unions) are equivalent to what a commit would have decided, so
        LOCAL/PROPOSED segments count as sufficient.  Otherwise only DECIDED
        segments do — the coordinator must CollectDeps the rest
        (ref: Recover.java:353)."""
        sufficient: List[Range] = []

        def fn(entry: LatestEntry, start: int, end: int, acc: Deps) -> Deps:
            seg = Ranges.of(Range(start, end))
            if entry.known >= DECIDED:
                sufficient.append(Range(start, end))
                picked = _slice(entry.coordinated, seg)
            elif not accept_local:
                return acc
            else:
                sufficient.append(Range(start, end))
                picked = _slice(entry.coordinated, seg) \
                    if entry.known == PROPOSED else None
                picked = _union(picked, _slice(entry.local, seg))
            return acc if picked is None else acc.with_(picked)

        deps = self.map.fold_with_bounds(fn, Deps.none())
        return deps, Ranges.of(*sufficient)

    def is_empty(self) -> bool:
        return self.map.is_empty()

    def __eq__(self, o):
        return isinstance(o, LatestDeps) and self.map == o.map

    def __repr__(self):
        return f"LatestDeps({self.map})"
