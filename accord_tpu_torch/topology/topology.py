"""One epoch's shard map + multi-epoch windows.

Rebuild of ref: accord-core/src/main/java/accord/topology/Topology.java:59-497
and Topologies.java:35-452.  A Topology is a sorted array of non-overlapping
Shards for one epoch, with per-node subset views; Topologies is the window of
epochs a coordination must contact (oldest..newest), with the node union.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from ..primitives.keys import Range, Ranges, Route, RoutingKeys, Unseekables
from ..utils import invariants
from .shard import Shard


class Topology:
    __slots__ = ("epoch", "shards", "_starts", "_node_shards")

    def __init__(self, epoch: int, shards: Sequence[Shard]):
        self.epoch = epoch
        self.shards: Tuple[Shard, ...] = tuple(
            sorted(shards, key=lambda s: s.range.start))
        if invariants.PARANOID:
            for a, b in zip(self.shards, self.shards[1:]):
                invariants.check_state(a.range.end <= b.range.start,
                                       "overlapping shards %s %s", a, b)
        self._starts = [s.range.start for s in self.shards]
        nodes: Dict[int, List[Shard]] = {}
        for s in self.shards:
            for n in s.nodes:
                nodes.setdefault(n, []).append(s)
        self._node_shards = nodes

    @classmethod
    def empty(cls) -> "Topology":
        return cls(0, ())

    def is_empty(self) -> bool:
        return not self.shards

    def size(self) -> int:
        return len(self.shards)

    def nodes(self) -> Set[int]:
        return set(self._node_shards)

    def ranges(self) -> Ranges:
        return Ranges([s.range for s in self.shards])

    def ranges_for_node(self, node: int) -> Ranges:
        return Ranges([s.range for s in self._node_shards.get(node, ())])

    def shards_for_node(self, node: int) -> List[Shard]:
        return list(self._node_shards.get(node, ()))

    def shard_for_token(self, token: int) -> Optional[Shard]:
        i = bisect.bisect_right(self._starts, token) - 1
        if i >= 0 and self.shards[i].contains_token(token):
            return self.shards[i]
        return None

    def for_selection(self, select: Unseekables) -> List[Shard]:
        """Shards intersecting the given keys/ranges (ref: Topology.forSelection)."""
        out: List[Shard] = []
        if isinstance(select, (Ranges,)):
            for s in self.shards:
                if select.intersects(Ranges.of(s.range)):
                    out.append(s)
        else:
            seen = set()
            for t in select:
                sh = self.shard_for_token(t)
                if sh is not None and id(sh) not in seen:
                    seen.add(id(sh))
                    out.append(sh)
        return out

    def for_route(self, route: Route) -> List[Shard]:
        return self.for_selection(route.participants)

    def foldl_intersecting(self, select: Unseekables, fn: Callable, acc):
        for s in self.for_selection(select):
            acc = fn(s, acc)
        return acc

    def __iter__(self) -> Iterator[Shard]:
        return iter(self.shards)

    def __eq__(self, o):
        return isinstance(o, Topology) and self.epoch == o.epoch and self.shards == o.shards

    def __repr__(self):
        return f"Topology(epoch={self.epoch}, {list(self.shards)})"


class Topologies:
    """Multi-epoch window, newest first
    (ref: accord/topology/Topologies.java Single/Multi)."""

    __slots__ = ("_topologies",)

    def __init__(self, topologies: Sequence[Topology]):
        invariants.check_argument(len(topologies) > 0, "empty Topologies")
        if invariants.PARANOID:
            for a, b in zip(topologies, topologies[1:]):
                invariants.check_state(a.epoch == b.epoch + 1,
                                       "epochs must be contiguous descending")
        self._topologies = tuple(topologies)

    @classmethod
    def single(cls, t: Topology) -> "Topologies":
        return cls((t,))

    def current(self) -> Topology:
        return self._topologies[0]

    def current_epoch(self) -> int:
        return self._topologies[0].epoch

    def oldest_epoch(self) -> int:
        return self._topologies[-1].epoch

    def size(self) -> int:
        return len(self._topologies)

    def get(self, i: int) -> Topology:
        return self._topologies[i]

    def for_epoch(self, epoch: int) -> Topology:
        i = self.current_epoch() - epoch
        invariants.check_argument(0 <= i < len(self._topologies),
                                  "epoch %d outside window", epoch)
        return self._topologies[i]

    def contains_epoch(self, epoch: int) -> bool:
        return self.oldest_epoch() <= epoch <= self.current_epoch()

    def for_epochs(self, min_epoch: int, max_epoch: int) -> "Topologies":
        out = [t for t in self._topologies if min_epoch <= t.epoch <= max_epoch]
        return Topologies(out)

    def nodes(self) -> Set[int]:
        out: Set[int] = set()
        for t in self._topologies:
            out.update(t.nodes())
        return out

    def __iter__(self) -> Iterator[Topology]:
        return iter(self._topologies)

    def __repr__(self):
        return f"Topologies({[t.epoch for t in self._topologies]})"
