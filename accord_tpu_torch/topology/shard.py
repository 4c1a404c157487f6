"""Shard: a replicated token range with fast-path electorate.

Rebuild of ref: accord-core/src/main/java/accord/topology/Shard.java:38-110.
Quorum math (exact formulas from the reference):
    maxFailures        = (rf - 1) // 2
    slowPathQuorumSize = rf - maxFailures          (majority)
    fastPathQuorumSize = (maxFailures + electorate) // 2 + 1
    recoveryFastPathSize = (maxFailures + 1) // 2
A fast-path quorum of the electorate guarantees intersection with every
recovery quorum in at least recoveryFastPathSize electorate members.
"""

from __future__ import annotations

from typing import FrozenSet, List, Sequence, Tuple

from ..primitives.keys import Key, Range
from ..utils import invariants


class Shard:
    __slots__ = ("range", "nodes", "sorted_nodes", "fast_path_electorate",
                 "joining", "max_failures", "recovery_fast_path_size",
                 "fast_path_quorum_size", "slow_path_quorum_size")

    def __init__(self, rng: Range, nodes: Sequence[int],
                 fast_path_electorate: FrozenSet[int] = frozenset(),
                 joining: FrozenSet[int] = frozenset()):
        self.range = rng
        self.nodes: Tuple[int, ...] = tuple(nodes)
        self.sorted_nodes: Tuple[int, ...] = tuple(sorted(nodes))
        electorate = frozenset(fast_path_electorate) if fast_path_electorate else frozenset(nodes)
        self.fast_path_electorate = electorate
        self.joining = frozenset(joining)
        invariants.check_argument(all(j in self.nodes for j in self.joining),
                                  "joining nodes must be in nodes")
        self.max_failures = self.max_tolerated_failures(len(self.nodes))
        invariants.check_argument(
            len(electorate) >= len(self.nodes) - self.max_failures,
            "electorate too small: %d < %d", len(electorate),
            len(self.nodes) - self.max_failures)
        self.recovery_fast_path_size = (self.max_failures + 1) // 2
        self.slow_path_quorum_size = self.slow_path_quorum(len(self.nodes))
        self.fast_path_quorum_size = self.fast_path_quorum(
            len(self.nodes), len(electorate), self.max_failures)

    @staticmethod
    def max_tolerated_failures(rf: int) -> int:
        return (rf - 1) // 2

    @staticmethod
    def slow_path_quorum(rf: int) -> int:
        return rf - Shard.max_tolerated_failures(rf)

    @staticmethod
    def fast_path_quorum(rf: int, electorate: int, f: int) -> int:
        invariants.check_argument(electorate >= rf - f, "electorate too small")
        return (f + electorate) // 2 + 1

    def rf(self) -> int:
        return len(self.nodes)

    def rejects_fast_path(self, reject_count: int) -> bool:
        """Can the fast path still be attained given this many electorate
        rejects (ref: Shard.java rejectsFastPath)."""
        return reject_count > len(self.fast_path_electorate) - self.fast_path_quorum_size

    def contains_token(self, token: int) -> bool:
        return self.range.contains_token(token)

    def contains_key(self, key: Key) -> bool:
        return self.range.contains_key(key)

    def contains_node(self, node: int) -> bool:
        return node in self.nodes

    def __eq__(self, o):
        return (isinstance(o, Shard) and self.range == o.range
                and self.nodes == o.nodes
                and self.fast_path_electorate == o.fast_path_electorate
                and self.joining == o.joining)

    def __hash__(self):
        return hash((self.range, self.nodes))

    def __repr__(self):
        return f"Shard[{self.range.start},{self.range.end}):{list(self.nodes)}"
