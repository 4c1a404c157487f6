"""The Accept (slow-path consensus) round.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/Propose.java:52-200.
"""

from __future__ import annotations

from typing import Dict

from .. import api
from ..messages.accept import Accept, AcceptReply
from ..primitives.deps import Deps
from ..primitives.keys import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..obs import spans_of
from ..primitives.txn import Txn
from ..utils import async_chain
from .errors import Exhausted, Preempted, Rejected, Timeout
from .tracking import QuorumTracker, RequestStatus


def propose(node, ballot: Ballot, txn_id: TxnId, txn: Txn, route: Route,
            execute_at: Timestamp, deps: Deps) -> async_chain.AsyncChain:
    """Returns chain of (execute_at, merged_deps) once a quorum of every
    shard accepts."""
    return _Propose(node, ballot, txn_id, txn, route, execute_at, deps)._start()


class _Propose(api.Callback):
    def __init__(self, node, ballot, txn_id, txn, route, execute_at, deps):
        self.node = node
        self.ballot = ballot
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.execute_at = execute_at
        self.deps = deps
        self.topologies = node.topology().with_unsynced_epochs(
            route.participants, txn_id.epoch(), execute_at.epoch())
        self.tracker = QuorumTracker(self.topologies)
        self.accept_deps = []
        self.result: async_chain.AsyncResult = async_chain.AsyncResult()
        self.done = False
        self._spans = spans_of(node)
        self._sp = None

    def _start(self) -> async_chain.AsyncChain:
        if self._spans is not None:
            self._sp = self._spans.begin(
                str(self.txn_id), "accept", node=self.node.node_id,
                ballot=str(self.ballot))
        request = Accept(self.txn_id, self.txn, self.route, self.ballot,
                         self.execute_at, self.deps,
                         self.topologies.oldest_epoch(),
                         self.execute_at.epoch())
        for to in sorted(self.tracker.nodes()):
            self.node.send(to, request, self)
        return self.result

    def _end_span(self, **attrs) -> None:
        if self._spans is not None:
            self._spans.end(self._sp, **attrs)

    def on_success(self, from_id: int, reply: AcceptReply) -> None:
        if self.done:
            return
        if not reply.is_ok():
            self.done = True
            if getattr(reply, "rejected", False):
                self._end_span(outcome="Rejected")
                self.result.set_failure(Rejected(
                    self.txn_id,
                    floor=getattr(reply, "reject_floor", None)))
            else:
                self._end_span(outcome="Preempted")
                self.result.set_failure(Preempted(self.txn_id))
            return
        if reply.deps is not None:
            self.accept_deps.append(reply.deps)
        status = self.tracker.record_success(from_id)
        if status is RequestStatus.Success:
            self.done = True
            self._end_span()     # duration = the Accept quorum RTT
            merged = Deps.merge([self.deps] + self.accept_deps)
            self.result.set_success((self.execute_at, merged))
        elif status is RequestStatus.Failed:
            self.done = True
            self._end_span(outcome="Exhausted")
            self.result.set_failure(Exhausted(self.txn_id))

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) is RequestStatus.Failed:
            self.done = True
            self._end_span(outcome="Timeout")
            self.result.set_failure(Timeout(self.txn_id))
