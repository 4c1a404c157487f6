"""Replica contact-order policy: prefer replicas covering more of the route.

Rebuild of ref: accord-core/src/main/java/accord/impl/
SizeOfIntersectionSorter.java — when picking which replica of a shard to
contact first (read legs, bootstrap donors, route probes), prefer the one
whose ownership intersects the most of the whole selection: it can answer
for more shards, so the fan-out touches fewer nodes.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from .. import api
from ..primitives.keys import Ranges


class SizeOfIntersectionSorter(api.TopologySorter):
    """(ref: impl/SizeOfIntersectionSorter.java)."""

    def compare(self, a: int, b: int, shards) -> int:
        sa = sum(s.range.end - s.range.start for s in shards if a in s.nodes)
        sb = sum(s.range.end - s.range.start for s in shards if b in s.nodes)
        if sa != sb:
            return -1 if sa > sb else 1   # wider coverage contacts first
        return -1 if a < b else (1 if a > b else 0)

    @staticmethod
    def scores(topology, select=None) -> Dict[int, int]:
        """node -> token span of its shards' INTERSECTION with ``select``
        (whole topology when select is None) — crediting the full shard span
        would rank a barely-intersecting wide owner above a replica fully
        covering the selection."""
        out: Dict[int, int] = {}
        shards = (topology.for_selection(select) if select is not None
                  else topology.shards)
        for shard in shards:
            if select is not None and isinstance(select, Ranges):
                span = sum(r.end - r.start for r in
                           select.intersecting(Ranges.of(shard.range)))
            else:
                span = shard.range.end - shard.range.start
            for n in shard.nodes:
                out[n] = out.get(n, 0) + span
        return out

    @classmethod
    def preferred(cls, topology, candidates: Iterable[int], select=None,
                  prefer: Optional[int] = None) -> List[int]:
        """Candidates ordered by descending coverage (ties by node id for
        determinism); ``prefer`` (usually the local node) goes first."""
        scores = cls.scores(topology, select)
        out = sorted(candidates, key=lambda n: (-scores.get(n, 0), n))
        if prefer is not None and prefer in out:
            out.remove(prefer)
            out.insert(0, prefer)
        return out


def pick_read_nodes(node, trackers, topology) -> set:
    """One replica per execution shard: self where possible, otherwise the
    replica covering the most of the topology — so one node can serve many
    shards and the read fan-out stays small (ref: ReadTracker's initial
    contact ordering via the TopologySorter)."""
    scores = SizeOfIntersectionSorter.scores(topology)
    chosen: set = set()
    for t in trackers:
        shard = t.shard
        if any(n in chosen for n in shard.nodes):
            continue
        if node.node_id in shard.nodes:
            chosen.add(node.node_id)
        else:
            chosen.add(min(shard.nodes, key=lambda n: (-scores.get(n, 0), n)))
    return chosen
