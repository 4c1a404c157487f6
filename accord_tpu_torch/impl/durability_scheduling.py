"""Background durability scheduling: rotate shard-durable rounds over the
node's owned ranges and periodic globally-durable gossip rounds.

Rebuild of ref: accord-core/src/main/java/accord/impl/
CoordinateDurabilityScheduling.java:77-345 — each node walks the token ring
in slices on a target cycle time, coordinating CoordinateShardDurable for
slices it is responsible for (nodes take turns by index so the ring is
covered without duplicate rounds), and nodes take turns running
CoordinateGloballyDurable on a slower cycle.
"""

from __future__ import annotations

from typing import List, Optional

from ..coordinate.durability import (coordinate_globally_durable,
                                     coordinate_shard_durable)
from ..primitives.keys import Ranges


class DurabilityScheduling:
    """(ref: impl/CoordinateDurabilityScheduling.java)."""

    def __init__(self, node,
                 shard_cycle_micros: int = 10_000_000,
                 global_cycle_micros: int = 30_000_000,
                 slices: int = 4):
        self.node = node
        self.shard_cycle_micros = shard_cycle_micros
        self.global_cycle_micros = global_cycle_micros
        self.slices = slices
        self._slice_index = 0
        self._scheduled = None
        self._global_scheduled = None
        self._inflight = False
        self._stopped = False
        # counters for tests/observability
        self.shard_rounds_ok = 0
        self.shard_rounds_failed = 0
        self.global_rounds = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        step = max(1, self.shard_cycle_micros // self.slices)
        # stagger nodes so rounds for the same ranges don't collide
        # (ref: CoordinateDurabilityScheduling round-offset by node index)
        offset = 1 + ((self.node.node_id * 2654435761) % step)

        def arm():
            if self._stopped:
                return   # stop() raced the stagger timer
            self._scheduled = self.node.scheduler.recurring(
                step, self._shard_tick)
            self._global_scheduled = self.node.scheduler.recurring(
                self.global_cycle_micros, self._global_tick)
        self.node.scheduler.once(offset, arm)

    def stop(self) -> None:
        self._stopped = True
        if self._scheduled is not None:
            self._scheduled.cancel()
        if self._global_scheduled is not None:
            self._global_scheduled.cancel()

    # -- manual driving (deterministic sim: the burn/test harness ticks
    # explicitly instead of arming wall-clock-style recurring timers, which
    # would defeat the simulator's quiescence detection) -------------------
    def shard_tick(self) -> None:
        self._shard_tick()

    def global_tick(self) -> None:
        self._global_tick()

    # -- shard rounds ---------------------------------------------------------
    def _shard_tick(self) -> None:
        if self._inflight:
            return   # one round at a time per node
        ranges = self._next_slice()
        if ranges is None or ranges.is_empty():
            return
        self._inflight = True

        def on_done(_sync_id, failure):
            self._inflight = False
            if failure is None:
                self.shard_rounds_ok += 1
            else:
                self.shard_rounds_failed += 1   # retried on a later cycle

        coordinate_shard_durable(self.node, ranges).begin(on_done)

    def _next_slice(self) -> Optional[Ranges]:
        """The next slice of ranges this node is responsible for: its owned
        ranges where it is the FIRST replica (nodes take turns; every range
        has exactly one first replica, so the whole ring is covered with no
        duplicate rounds)."""
        topology = self.node.topology_manager.current()
        # responsibility = the shard's first replica in DECLARED order (the
        # round-robin rotation), so responsibility spreads across nodes
        mine = [s.range for s in topology.shards
                if s.nodes and s.nodes[0] == self.node.node_id]
        if not mine:
            return None
        i = self._slice_index % len(mine)
        self._slice_index += 1
        return Ranges.of(mine[i])

    # -- global rounds ----------------------------------------------------------
    def _global_tick(self) -> None:
        topology = self.node.topology_manager.current()
        nodes = sorted(topology.nodes())
        if not nodes:
            return
        # nodes take turns: the round number selects whose turn it is
        round_no = self.global_rounds
        self.global_rounds += 1
        if nodes[round_no % len(nodes)] != self.node.node_id:
            return
        coordinate_globally_durable(
            self.node, topology.epoch).begin(lambda _r, _f: None)
