"""Durability rounds: shard-durable and globally-durable coordination.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/
CoordinateShardDurable.java, CoordinateGloballyDurable.java (both driven by
impl/CoordinateDurabilityScheduling.java — ours lives in
accord_tpu/impl/durability_scheduling.py).

Flow: coordinate an ExclusiveSyncPoint over a range slice; once EVERY
replica of the slice has applied it (AllTracker over WaitUntilApplied),
broadcast SetShardDurable so each replica advances its shard redundancy +
durability watermarks and truncates below them.  Periodically, a node
QueryDurableBefore's everyone, max-merges the maps, and gossips the result
back out via SetGloballyDurable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import Callback
from ..messages.durability import (ApplyThenWaitUntilApplied,
                                   DurableBeforeReply, QueryDurableBefore,
                                   SetGloballyDurable, SetShardDurable,
                                   WaitUntilApplied)
from ..primitives.keys import Ranges
from ..primitives.timestamp import TxnId
from ..utils import async_chain
from .sync_point import coordinate_sync_point
from .tracking import AllTracker, QuorumTracker, RequestStatus


def coordinate_shard_durable(node, ranges: Ranges) -> async_chain.AsyncResult:
    """(ref: CoordinateShardDurable.coordinate).  Resolves with the sync
    TxnId once SetShardDurable has been broadcast; fails on timeout (the
    scheduler simply retries the slice on a later cycle)."""
    result = async_chain.AsyncResult()

    def on_sync_point(sync_point, failure):
        if failure is not None:
            result.set_failure(failure)
            return
        sync_id = sync_point.sync_id
        topologies = node.topology().for_epoch(ranges, sync_id.epoch())
        tracker = AllTracker(topologies)

        class WaitCallback(Callback):
            def on_success(self, from_id: int, reply) -> None:
                if not reply.is_ok():
                    return   # replica couldn't serve; timeout will fail us
                if tracker.record_success(from_id) is RequestStatus.Success:
                    # applied at EVERY replica: durable + redundant shard-wide
                    for to in tracker.nodes():
                        node.send(to, SetShardDurable(sync_id, ranges))
                    if not result.is_done():
                        result.set_success(sync_id)

            def on_failure(self, from_id: int, failure: BaseException) -> None:
                if tracker.record_failure(from_id) is RequestStatus.Failed \
                        and not result.is_done():
                    result.set_failure(failure)

        cb = WaitCallback()
        if sync_point.execute_at is not None and sync_point.route is not None:
            # fused leg (ref: ExecuteSyncPoint sends ApplyThenWaitUntilApplied):
            # a replica that missed the Apply fan-out gets the decided
            # executeAt+deps with the wait, instead of wedging until a fetch
            request = ApplyThenWaitUntilApplied(
                sync_id, sync_point.route, sync_point.execute_at,
                sync_point.deps)
        else:
            request = WaitUntilApplied(sync_id, ranges)
        for to in sorted(tracker.nodes()):
            node.send(to, request, cb)

    coordinate_sync_point(node, ranges, exclusive=True).begin(on_sync_point)
    return result


def coordinate_globally_durable(node, epoch: int) -> async_chain.AsyncResult:
    """(ref: CoordinateGloballyDurable.java:39-91)."""
    result = async_chain.AsyncResult()
    topology = node.topology().get_topology_for_epoch(epoch)
    all_ranges = Ranges.of(*(s.range for s in topology.shards))
    topologies = node.topology().for_epoch(all_ranges, epoch)
    tracker = QuorumTracker(topologies)
    merged: List[Tuple[int, int, TxnId, TxnId]] = []

    class QueryCallback(Callback):
        def on_success(self, from_id: int, reply: DurableBeforeReply) -> None:
            merged.extend(reply.entries)
            if tracker.record_success(from_id) is RequestStatus.Success:
                for to in tracker.nodes():
                    node.send(to, SetGloballyDurable(epoch, merged))
                if not result.is_done():
                    result.set_success(None)

        def on_failure(self, from_id: int, failure: BaseException) -> None:
            if tracker.record_failure(from_id) is RequestStatus.Failed \
                    and not result.is_done():
                result.set_failure(failure)

    cb = QueryCallback()
    for to in sorted(tracker.nodes()):
        node.send(to, QueryDurableBefore(epoch), cb)
    return result
