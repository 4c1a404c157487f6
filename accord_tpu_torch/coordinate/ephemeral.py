"""CoordinateEphemeralRead: non-durable per-key-linearizable reads.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/
CoordinateEphemeralRead.java — no Accept/Commit rounds and no recovery: a
quorum of GetEphemeralReadDeps establishes everything that might have
finished before the read began (and the latest epoch — re-running there if
any replica is ahead); one replica per shard then performs the read once
those deps have applied locally.  Strict-serializable for single keys,
per-key linearizable for multi-key reads.
"""

from __future__ import annotations

from typing import Dict, List, Set

from .. import api
from ..messages.ephemeral import (GetEphemeralReadDeps,
                                  GetEphemeralReadDepsOk,
                                  ReadEphemeralTxnData)
from ..messages.read_data import ReadNack, ReadOk
from ..primitives.timestamp import Domain, Timestamp, TxnId, TxnKind
from ..primitives.txn import Txn
from ..utils import async_chain
from .errors import Exhausted, Timeout
from .tracking import QuorumTracker, ReadTracker, RequestStatus


def coordinate_ephemeral_read(node, txn: Txn) -> async_chain.AsyncChain:
    txn_id = node.next_txn_id(TxnKind.EphemeralRead, Domain.Key)
    route = node.compute_route(txn_id, txn.keys)
    return _EphemeralRead(node, txn_id, txn, route,
                          txn_id.epoch())._start()


class _EphemeralRead(api.Callback):
    MAX_EPOCH_RETRIES = 2

    def __init__(self, node, txn_id: TxnId, txn: Txn, route,
                 execution_epoch: int, attempt: int = 0):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.execution_epoch = execution_epoch
        self.attempt = attempt
        self.topologies = node.topology().with_unsynced_epochs(
            route.participants, txn_id.epoch(), execution_epoch)
        self.tracker = QuorumTracker(self.topologies)
        self.oks: List[GetEphemeralReadDepsOk] = []
        self.result: async_chain.AsyncResult = async_chain.AsyncResult()
        self.deps_done = False
        self.done = False
        self.read_tracker = None
        self.data = None

    def _start(self) -> async_chain.AsyncChain:
        request = GetEphemeralReadDeps(self.txn_id, self.route, self.txn.keys,
                                       self.execution_epoch)
        for to in sorted(self.tracker.nodes()):
            self.node.send(to, request, self)
        return self.result

    # -- deps phase ----------------------------------------------------------
    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, GetEphemeralReadDepsOk) and not self.deps_done:
            self.oks.append(reply)
            if self.tracker.record_success(from_id) is RequestStatus.Success:
                self.deps_done = True
                self._on_deps()
        elif isinstance(reply, ReadOk):
            if reply.data is not None:
                self.data = (reply.data if self.data is None
                             else self.data.merge(reply.data))
            if self.read_tracker.record_read_success(from_id) \
                    is RequestStatus.Success:
                self._finish()
        elif isinstance(reply, ReadNack):
            self._read_failed(from_id)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if not self.deps_done:
            if self.tracker.record_failure(from_id) is RequestStatus.Failed:
                self._fail(Timeout(self.txn_id))
        else:
            self._read_failed(from_id)

    def _on_deps(self) -> None:
        latest = max(ok.latest_epoch for ok in self.oks)
        if latest > self.execution_epoch:
            if self.attempt < self.MAX_EPOCH_RETRIES:
                # a replica is in a later epoch: our quorum may no longer be
                # an active one there — re-establish deps at that epoch
                # (ref: CoordinateEphemeralRead's executeAtEpoch retry)
                nxt = _EphemeralRead(self.node, self.txn_id, self.txn,
                                     self.route, latest, self.attempt + 1)
                self.node.with_epoch(
                    latest, lambda: nxt._start().begin(self.result.settle))
                self.done = True
                return
            # Retries exhausted with the topology still moving: executing at
            # the stale epoch could miss writes committed under the newer
            # one (the deps quorum may not be an active quorum there), which
            # breaks per-key linearizability.  The reference never executes
            # at a known-stale epoch; the documented contract is that the
            # caller simply retries the ephemeral read.
            self._fail(Exhausted(self.txn_id))
            return
        merged = self.oks[0].deps
        for ok in self.oks[1:]:
            merged = merged.with_partial(ok.deps)
        self.deps = merged
        exec_topology = self.topologies.for_epoch(self.execution_epoch)
        from ..topology.topology import Topologies
        self.read_tracker = ReadTracker(Topologies.single(exec_topology))
        for to in sorted(self._read_nodes()):
            self.read_tracker.record_in_flight(to)
            self.node.send(to, ReadEphemeralTxnData(
                self.txn_id, self.txn.read, self.txn.keys, self.deps,
                self.execution_epoch), self)

    def _read_nodes(self) -> Set[int]:
        from ..impl.sorter import pick_read_nodes
        return pick_read_nodes(
            self.node, self.read_tracker.trackers,
            self.topologies.for_epoch(self.execution_epoch))

    def _read_failed(self, from_id: int) -> None:
        status, to_contact = self.read_tracker.record_read_failure(from_id)
        if status is RequestStatus.Failed:
            self._fail(Exhausted(self.txn_id))
            return
        if status is RequestStatus.Success:
            self._finish()
            return
        for to in to_contact:
            self.read_tracker.record_in_flight(to)
            self.node.send(to, ReadEphemeralTxnData(
                self.txn_id, self.txn.read, self.txn.keys, self.deps,
                self.execution_epoch), self)

    def _finish(self) -> None:
        if self.done:
            return
        self.done = True
        result = (self.txn.result(self.txn_id, Timestamp.MAX, self.data)
                  if self.txn.query is not None else self.data)
        self.result.set_success(result)

    def _fail(self, exc: BaseException) -> None:
        if not self.done:
            self.done = True
            self.result.set_failure(exc)
