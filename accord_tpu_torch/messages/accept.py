"""Accept: ballot-guarded slow-path vote on executeAt.

Rebuild of ref: accord-core/src/main/java/accord/messages/Accept.java:50-178.
"""

from __future__ import annotations

from typing import Optional

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..primitives.deps import PartialDeps
from ..primitives.keys import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import Txn
from ..utils import async_chain
from .base import MessageType, Reply, TxnRequest
from .preaccept import (calculate_partial_deps,
                        calculate_partial_deps_async)


class AcceptReply(Reply):
    type = MessageType.ACCEPT_RSP

    def __init__(self, superseded_by: Optional[Ballot] = None,
                 deps: Optional[PartialDeps] = None,
                 redundant: bool = False, rejected: bool = False,
                 reject_floor=None):
        self.superseded_by = superseded_by
        self.deps = deps
        self.redundant = redundant
        self.rejected = rejected   # fenced by rejectBefore: retry w/ new id
        # the fence bound that rejected us: the coordinator bumps its HLC
        # past it so the retry's fresh id clears the fence (a drift-behind
        # node would otherwise re-issue doomed ids until its clock catches
        # up on its own)
        self.reject_floor = reject_floor

    def is_ok(self) -> bool:
        return self.superseded_by is None and not self.redundant \
            and not self.rejected

    def __repr__(self):
        if self.is_ok():
            return "AcceptOk"
        return (f"AcceptNack(superseded_by={self.superseded_by}, "
                f"redundant={self.redundant}, rejected={self.rejected})")


class Accept(TxnRequest):
    """(ref: messages/Accept.java)."""

    type = MessageType.ACCEPT_REQ

    def __init__(self, txn_id: TxnId, txn: Txn, route: Route, ballot: Ballot,
                 execute_at: Timestamp, deps, min_epoch: int, max_epoch: int):
        super().__init__(txn_id, route, max_epoch)
        self.txn = txn
        self.ballot = ballot
        self.execute_at = execute_at
        self.deps = deps            # full Deps; replicas slice
        self.min_epoch = min_epoch
        self.max_epoch = max_epoch

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, route = self.txn_id, self.route

        def map_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.all_between(
                self.min_epoch, self.max_epoch)
            partial_txn = self.txn.slice(owned, False)
            partial_deps = self.deps.slice(owned)
            progress_key = node.select_progress_key(txn_id, route)
            outcome, superseded = commands.accept(
                safe, txn_id, self.ballot, route, partial_txn.keys,
                progress_key, self.execute_at, partial_deps)
            if outcome is commands.AcceptOutcome.RejectedBallot:
                return async_chain.success(
                    AcceptReply(superseded_by=superseded))
            if outcome is commands.AcceptOutcome.Redundant:
                return async_chain.success(AcceptReply(redundant=True))
            if outcome is commands.AcceptOutcome.Rejected:
                return async_chain.success(
                    AcceptReply(rejected=True, reject_floor=superseded))
            # return deps witnessed up to executeAt for the coordinator's
            # final merge (ref: Accept.java AcceptReply.deps) — via the
            # store-level coalescer (same-quantum Accepts share a dispatch)
            out = async_chain.AsyncResult()

            def on_deps(deps, failure):
                if failure is not None:
                    out.set_failure(failure)
                else:
                    out.set_success(AcceptReply(deps=deps))

            calculate_partial_deps_async(safe, txn_id, partial_txn.keys,
                                         self.execute_at, owned, on_deps)
            return out

        def reduce_fn(a: AcceptReply, b: AcceptReply):
            if not a.is_ok():
                return a
            if not b.is_ok():
                return b
            return AcceptReply(deps=a.deps.with_partial(b.deps))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_id, reply_context, failure)
            elif result is None:
                node.reply(from_id, reply_context, AcceptReply(redundant=True))
            else:
                node.reply(from_id, reply_context, result)

        stores = node.command_stores.intersecting(
            route.participants, self.min_epoch, self.max_epoch)
        if not stores:
            consume(None, None)
            return
        ctx = PreLoadContext.for_txn(txn_id)
        chains = [s.execute(ctx, map_fn).flat_map(lambda inner: inner)
                  for s in stores]
        async_chain.reduce(chains, reduce_fn).begin(consume)


class AcceptInvalidate(TxnRequest):
    """Propose invalidation of an (un-committed) txn
    (ref: messages/BeginInvalidation.java proposeInvalidate leg)."""

    type = MessageType.ACCEPT_INVALIDATE_REQ

    def __init__(self, txn_id: TxnId, route: Route, ballot: Ballot):
        super().__init__(txn_id, route, txn_id.epoch())
        self.ballot = ballot

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id

        def map_fn(safe: SafeCommandStore):
            outcome, superseded = commands.accept_invalidate(safe, txn_id, self.ballot)
            if outcome is commands.AcceptOutcome.RejectedBallot:
                return AcceptReply(superseded_by=superseded)
            if outcome is commands.AcceptOutcome.Redundant:
                return AcceptReply(redundant=True)
            return AcceptReply()

        def reduce_fn(a, b):
            return a if not a.is_ok() else b

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_id, reply_context, failure)
            else:
                node.reply(from_id, reply_context, result or AcceptReply())

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), self.route.participants,
            txn_id.epoch(), txn_id.epoch(), map_fn, reduce_fn, consume)
