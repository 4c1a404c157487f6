"""Epoch ledger: which topologies are known, synced, closed, redundant.

Rebuild of ref: accord-core/src/main/java/accord/topology/TopologyManager.java:70-671.
Per-epoch EpochState tracks a per-shard quorum of "sync complete"
acknowledgements from replicas; coordination selects either the precise
epoch window or extends it backwards over unsynced epochs (dual-quorum
PreAccept across reconfiguration, ref: messages/PreAccept.java:109-114).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set

from ..primitives.keys import Ranges, Route, Unseekables
from ..utils import async_chain, invariants
from .topology import Topologies, Topology


class _EpochState:
    __slots__ = ("topology", "synced_nodes", "sync_complete", "closed", "redundant",
                 "ready_future")

    def __init__(self, topology: Topology):
        self.topology = topology
        self.synced_nodes: Set[int] = set()
        self.sync_complete = topology.is_empty()
        self.closed = Ranges.empty()
        self.redundant = Ranges.empty()
        self.ready_future: async_chain.AsyncResult = async_chain.AsyncResult()

    def record_sync(self, node: int) -> bool:
        """Record a node's sync-complete; returns True if the epoch just
        became fully synced (per-shard quorums of acks).  The ack is
        recorded even once quorum-synced: ``all_members_synced`` (the
        serving no-stacking guard) needs the laggards' acks too."""
        self.synced_nodes.add(node)
        if self.sync_complete:
            return False
        for shard in self.topology.shards:
            acked = sum(1 for n in shard.nodes if n in self.synced_nodes)
            if acked < shard.slow_path_quorum_size:
                return False
        self.sync_complete = True
        return True

    def synced_for(self, select: Unseekables) -> bool:
        if self.sync_complete:
            return True
        for shard in self.topology.for_selection(select):
            acked = sum(1 for n in shard.nodes if n in self.synced_nodes)
            if acked < shard.slow_path_quorum_size:
                return False
        return True


class TopologyManager:
    """(ref: topology/TopologyManager.java)."""

    def __init__(self, node_id: int, sorter=None):
        self.node_id = node_id
        self.sorter = sorter
        self._epochs: List[_EpochState] = []   # ascending epoch order
        self._min_epoch = 0
        self._awaiting: Dict[int, async_chain.AsyncResult] = {}
        # sync notifications that arrived before their epoch's topology
        self._pending_syncs: Dict[int, Set[int]] = {}

    # -- epoch ingest -------------------------------------------------------
    def on_topology_update(self, topology: Topology) -> None:
        if self._epochs:
            expected = self._epochs[-1].topology.epoch + 1
            invariants.check_argument(
                topology.epoch == expected,
                "non-contiguous topology epoch %d (expected %d)",
                topology.epoch, expected)
        else:
            self._min_epoch = topology.epoch
        state = _EpochState(topology)
        # first epoch needs no sync
        if not self._epochs:
            state.sync_complete = True
        self._epochs.append(state)
        for node in self._pending_syncs.pop(topology.epoch, set()):
            self.on_epoch_sync_complete(node, topology.epoch)
        waiter = self._awaiting.pop(topology.epoch, None)
        if waiter is not None:
            waiter.set_success(topology)

    def on_epoch_sync_complete(self, node: int, epoch: int) -> None:
        state = self._state(epoch)
        if state is None:
            if epoch > self.epoch():
                self._pending_syncs.setdefault(epoch, set()).add(node)
            return
        state.record_sync(node)

    def on_epoch_closed(self, ranges: Ranges, epoch: int) -> None:
        state = self._state(epoch)
        if state is not None:
            state.closed = state.closed.with_(ranges)

    def on_epoch_redundant(self, ranges: Ranges, epoch: int) -> None:
        state = self._state(epoch)
        if state is not None:
            state.redundant = state.redundant.with_(ranges)

    # -- queries ------------------------------------------------------------
    def _state(self, epoch: int) -> Optional[_EpochState]:
        i = epoch - self._min_epoch
        if 0 <= i < len(self._epochs):
            return self._epochs[i]
        return None

    def epoch(self) -> int:
        return self._epochs[-1].topology.epoch if self._epochs else 0

    def min_epoch(self) -> int:
        return self._min_epoch

    def has_epoch(self, epoch: int) -> bool:
        return self._state(epoch) is not None

    def current(self) -> Topology:
        invariants.check_state(bool(self._epochs), "no topology known")
        return self._epochs[-1].topology

    def current_local(self) -> Topology:
        t = self.current()
        return t  # per-node trimming is done by CommandStores

    def get_topology_for_epoch(self, epoch: int) -> Topology:
        state = self._state(epoch)
        invariants.check_state(state is not None, "unknown epoch %d", epoch)
        return state.topology  # type: ignore[union-attr]

    def await_epoch(self, epoch: int) -> async_chain.AsyncResult:
        state = self._state(epoch)
        if state is not None:
            done = async_chain.AsyncResult()
            done.set_success(state.topology)
            return done
        fut = self._awaiting.get(epoch)
        if fut is None:
            fut = self._awaiting[epoch] = async_chain.AsyncResult()
        return fut

    def is_sync_complete(self, epoch: int) -> bool:
        s = self._state(epoch)
        return s is not None and s.sync_complete

    def all_members_synced(self, epoch: int) -> bool:
        """Every MEMBER of the epoch has acked it (stronger than
        ``is_sync_complete``'s per-shard quorum — the serving reconfig
        verb's no-stacking guard needs the laggards too)."""
        s = self._state(epoch)
        if s is None:
            return False
        return s.sync_complete and all(
            n in s.synced_nodes for n in s.topology.nodes())

    def retire_below(self, epoch: int) -> int:
        """Retire (drop) epoch states strictly below ``epoch`` — the
        serving cluster's epoch-lifecycle tail (ref: TopologyManager's
        truncation of epochs below ``minEpoch``).  Only SYNC-COMPLETE
        epochs retire (an unsynced epoch still anchors dual-quorum
        windows), the newest epoch always survives, and the caller owns
        the policy of how far back is safe (the serving manager keeps the
        newest prefix-synced epoch plus a donor-catalogue lag).  Returns
        the number retired."""
        n = 0
        while (len(self._epochs) > 1
               and self._epochs[0].topology.epoch < epoch
               and self._epochs[0].sync_complete):
            self._epochs.pop(0)
            n += 1
        if n:
            self._min_epoch = self._epochs[0].topology.epoch
        return n

    # -- coordination topology selection ------------------------------------
    @staticmethod
    def _trim(topology: Topology, select: Unseekables) -> Topology:
        """Restrict to shards intersecting the selection
        (ref: Topology.forSelection / trim)."""
        return Topology(topology.epoch, topology.for_selection(select))

    def precise_epochs(self, select: Unseekables, min_epoch: int,
                       max_epoch: int) -> Topologies:
        out = [self._trim(self._require(e).topology, select)
               for e in range(max_epoch, min_epoch - 1, -1)]
        return Topologies(out)

    def with_unsynced_epochs(self, select: Unseekables, min_epoch: int,
                             max_epoch: int) -> Topologies:
        """Window [min..max] extended backwards while epochs remain unsynced
        for the selection (ref: TopologyManager.withUnsyncedEpochs)."""
        lo = min_epoch
        while lo > self._min_epoch and not self._require(lo).synced_for(select):
            lo -= 1
        out = [self._trim(self._require(e).topology, select)
               for e in range(max_epoch, lo - 1, -1)]
        return Topologies(out)

    def _require(self, epoch: int) -> _EpochState:
        s = self._state(epoch)
        invariants.check_state(s is not None, "unknown epoch %d", epoch)
        return s  # type: ignore[return-value]

    def for_epoch(self, select: Unseekables, epoch: int) -> Topologies:
        return self.precise_epochs(select, epoch, epoch)
