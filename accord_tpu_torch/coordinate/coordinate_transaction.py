"""The transaction entry FSM: PreAccept round -> fast/slow path.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/
CoordinateTransaction.java:50-101 and AbstractCoordinatePreAccept.java:46-250.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import api
from ..messages.preaccept import PreAccept, PreAcceptNack, PreAcceptOk
from ..primitives.deps import Deps
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import Txn
from ..obs import spans_of
from ..utils import async_chain
from .errors import Exhausted, Preempted, Rejected, Timeout
from .adapter import Adapters
from .tracking import FastPathTracker, RequestStatus


class CoordinateTransaction(api.Callback):
    """(ref: coordinate/CoordinateTransaction.java)."""

    @staticmethod
    def coordinate(node, txn_id: TxnId, txn: Txn) -> async_chain.AsyncChain:
        return CoordinateTransaction(node, txn_id, txn)._start()

    def __init__(self, node, txn_id: TxnId, txn: Txn):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = node.compute_route(txn_id, txn.keys)
        # the pipeline-strategy seam (ref: CoordinationAdapter.java:49)
        self.adapter = Adapters.for_kind(txn_id.kind())
        self.result: async_chain.AsyncResult = async_chain.AsyncResult()
        self.topologies = node.topology().with_unsynced_epochs(
            self.route.participants, txn_id.epoch(), txn_id.epoch())
        self.tracker = FastPathTracker(self.topologies)
        self.oks: Dict[int, PreAcceptOk] = {}
        self.done = False
        self._spans = spans_of(node)
        self._sp = None

    def _start(self) -> async_chain.AsyncChain:
        if self._spans is not None:
            self._sp = self._spans.begin(
                str(self.txn_id), "preaccept", node=self.node.node_id,
                contacted=len(self.tracker.nodes()))
        request = PreAccept(self.txn_id, self.txn, self.route,
                            self.topologies.current_epoch(),
                            min_epoch=self.topologies.oldest_epoch())
        for to in sorted(self.tracker.nodes()):
            self.node.send(to, request, self)
        return self.result

    # -- Callback -----------------------------------------------------------
    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, PreAcceptNack) or not reply.is_ok():
            if getattr(reply, "rejected", False):
                # fenced by an ExclusiveSyncPoint: this TxnId can never
                # decide — the caller retries with a fresh id
                self._fail(Rejected(self.txn_id,
                                    floor=getattr(reply, "reject_floor",
                                                  None)))
            else:
                # a higher ballot owns this txn: a recovery coordinator
                # preempted us
                self._fail(Preempted(self.txn_id))
            return
        self.oks[from_id] = reply
        fast_vote = reply.witnessed_at == self.txn_id
        status = self.tracker.record_success(from_id, fast_vote)
        if status is RequestStatus.Success:
            self._on_preaccepted()
        elif status is RequestStatus.Failed:
            self._fail(Exhausted(self.txn_id))

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        status = self.tracker.record_failure(from_id)
        if status is RequestStatus.Failed:
            self._fail(Timeout(self.txn_id))
        elif status is RequestStatus.Success:
            # the failure settled the fast-path decision (elector lost ->
            # fast path impossible, slow quorum already in hand): proceed
            # (ref: AbstractCoordinatePreAccept.onFailure -> onPreAccepted)
            self._on_preaccepted()

    # -- decision (ref: CoordinateTransaction.java:71-101) ------------------
    def _on_preaccepted(self) -> None:
        self.done = True
        oks = list(self.oks.values())
        fast = self.tracker.has_fast_path_accepted()
        if self._spans is not None:
            # the span's duration IS the preaccept quorum RTT in sim time
            self._spans.end(self._sp, oks=len(oks),
                            path="fast" if fast else "slow")
            self._spans.decision(str(self.txn_id),
                                 "fast" if fast else "slow")
        if fast:
            # fast path: executeAt == txnId, deps from fast-path voters
            deps = Deps.merge([ok.deps for ok in oks
                               if ok.witnessed_at == self.txn_id])
            self.node.agent.events_listener().on_fast_path_taken(self.txn_id, deps)
            self.adapter.execute(self.node, self.txn_id, self.txn, self.route,
                                 self.txn_id, deps).begin(self.result.settle)
        else:
            execute_at = self.txn_id
            for ok in oks:
                if ok.witnessed_at > execute_at:
                    execute_at = ok.witnessed_at
            if execute_at.epoch() > self.txn_id.epoch() and \
                    not self.txn_id.kind().is_sync_point():
                # NOTE: done=True was already set above, so _fail() would
                # no-op — settle the result directly so the caller's
                # fence-Rejected invalidate-then-retry path triggers
                # rejectExecuteAt (ref: PreAccept.java:283-335 +
                # CoordinateTransaction.java:71-101): the slow-path executeAt
                # crossed into a later epoch — abort and retry with a fresh
                # TxnId allocated there.  Beyond matching the reference,
                # this breaks the bootstrap deadlock cycle: an epoch's fence
                # awaits every LOWER TxnId, and a txn reading from
                # still-bootstrapping new-epoch replicas can otherwise gate
                # the very bootstrap it waits on; the fresh id sits ABOVE
                # the fence, decoupling them.  Carry the executeAt as the
                # floor: the retry bumps its HLC/topology past it instead
                # of re-allocating in the stale epoch.
                self.result.set_failure(Rejected(self.txn_id,
                                                 floor=execute_at))
                return
            deps = Deps.merge([ok.deps for ok in oks])
            self.node.agent.events_listener().on_slow_path_taken(self.txn_id, deps)
            self.adapter.propose(self.node, Ballot.ZERO, self.txn_id, self.txn,
                                 self.route, execute_at, deps).begin(
                self._on_proposed)

    def _on_proposed(self, value, failure) -> None:
        if failure is not None:
            self.result.set_failure(failure)
            return
        execute_at, deps = value
        self.adapter.execute(self.node, self.txn_id, self.txn, self.route,
                             execute_at, deps).begin(self.result.settle)

    def _fail(self, exc: BaseException) -> None:
        if not self.done:
            self.done = True
            if self._spans is not None:
                self._spans.end(self._sp, outcome=type(exc).__name__)
            self.result.set_failure(exc)
