"""Topology construction helpers for tests / maelstrom
(ref: accord-maelstrom/src/main/java/accord/maelstrom/TopologyFactory.java:
hash-space split into `shards` ranges x rf)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..primitives.keys import MAX_TOKEN, MIN_TOKEN, Range
from ..topology.shard import Shard
from ..topology.topology import Topology


def build_topology(epoch: int, node_ids: Sequence[int], rf: int,
                   num_shards: int,
                   min_token: int = 0, max_token: int = 1_000_000,
                   fast_path_all: bool = True) -> Topology:
    """Split [min_token, max_token) into num_shards ranges, replicating each
    on rf consecutive nodes (round-robin)."""
    node_ids = sorted(node_ids)
    n = len(node_ids)
    assert rf <= n
    span = max_token - min_token
    shards: List[Shard] = []
    for i in range(num_shards):
        start = min_token + span * i // num_shards
        end = min_token + span * (i + 1) // num_shards
        replicas = [node_ids[(i + j) % n] for j in range(rf)]
        electorate = frozenset(replicas) if fast_path_all else frozenset()
        shards.append(Shard(Range(start, end), replicas, electorate))
    return Topology(epoch, shards)


def split_shard(topology: Topology, rng, epoch: int) -> Topology:
    """True SPLIT (ref: TopologyRandomizer.java:427 SPLIT): one range
    becomes two at a random interior token, SAME owners both sides — every
    replica keeps all its data (no bootstrap), but scope slicing, dual-
    quorum windows and deps coverage now see two shards."""
    shards = list(topology.shards)
    wide = [i for i, s in enumerate(shards)
            if s.range.end - s.range.start >= 2]
    if not wide:
        return Topology(epoch, shards)
    i = wide[rng.next_int(len(wide))]
    s = shards[i]
    cut = s.range.start + 1 + rng.next_int(s.range.end - s.range.start - 1)
    shards[i:i + 1] = [
        Shard(Range(s.range.start, cut), list(s.nodes), s.fast_path_electorate),
        Shard(Range(cut, s.range.end), list(s.nodes), s.fast_path_electorate)]
    return Topology(epoch, shards)


def merge_shards(topology: Topology, rng, epoch: int) -> Topology:
    """MERGE (ref: TopologyRandomizer MERGE): two adjacent ranges become
    one owned by the FIRST's replicas — the second range's owners that are
    not in the first set lose it (a partial handoff), and first-set
    replicas that did not own the second range bootstrap just that slice
    (the old owner keeps part of its data: the partial-bootstrap path)."""
    shards = list(topology.shards)
    if len(shards) < 3:
        return Topology(epoch, shards)
    i = rng.next_int(len(shards) - 1)
    a, b = shards[i], shards[i + 1]
    merged = Shard(Range(a.range.start, b.range.end), list(a.nodes),
                   frozenset(a.nodes))
    shards[i:i + 2] = [merged]
    return Topology(epoch, shards)


def move_boundary(topology: Topology, rng, epoch: int) -> Topology:
    """Single-boundary move (ref: TopologyRandomizer MOVE): shift the
    boundary between two adjacent shards — each side keeps most of its
    range while one slice changes owners, so adopters bootstrap a sub-range
    of a shard they otherwise retain."""
    shards = list(topology.shards)
    if len(shards) < 2:
        return Topology(epoch, shards)
    i = rng.next_int(len(shards) - 1)
    a, b = shards[i], shards[i + 1]
    lo = a.range.start + 1
    hi = b.range.end - 1
    if hi <= lo:
        return Topology(epoch, shards)
    cut = lo + rng.next_int(hi - lo)
    shards[i:i + 2] = [
        Shard(Range(a.range.start, cut), list(a.nodes),
              a.fast_path_electorate),
        Shard(Range(cut, b.range.end), list(b.nodes),
              b.fast_path_electorate)]
    return Topology(epoch, shards)


def mutate_electorates(topology: Topology, rng) -> Topology:
    """Randomize each shard's fast-path electorate within the legal bounds
    (ref: topology/TopologyRandomizer.java updateFastPath): any subset of
    the replicas with at least ``rf - max_failures`` members keeps the
    fast/slow quorum intersection sound (Shard asserts it)."""
    shards: List[Shard] = []
    for s in topology.shards:
        lo = len(s.nodes) - s.max_failures
        size = lo + rng.next_int(len(s.nodes) - lo + 1)
        chosen: List[int] = list(s.nodes)
        while len(chosen) > size:
            chosen.pop(rng.next_int(len(chosen)))
        shards.append(Shard(s.range, list(s.nodes), frozenset(chosen),
                            joining=s.joining))
    return Topology(topology.epoch, shards)
