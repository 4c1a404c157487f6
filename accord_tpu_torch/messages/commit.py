"""Commit / Stable distribution, optionally fused with the read.

Rebuild of ref: accord-core/src/main/java/accord/messages/Commit.java:84-408
(Kinds CommitSlowPath / StableFastPath / StableSlowPath / *Maximal*;
``stableAndRead`` fusion :175) and CommitInvalidate.

A read-fused Commit sends a non-final CommitOk immediately (the stability
ack) and a final ReadOk once the execution drain releases the txn — one
message, two replies, mirroring the reference's fused flow.
"""

from __future__ import annotations

import enum
from typing import Optional

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..primitives.keys import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import Txn
from ..utils import async_chain
from .base import MessageType, Reply, TxnRequest
from .read_data import (ReadNack, ReadOk, ReadRedundant, ReadStale,
                        merge_datas, read_on_store)


class CommitKind(enum.Enum):
    Committed = 0      # slow-path Commit (executeAt durable, deps not stable)
    Stable = 1         # Stable: deps frozen, execution may begin


# reduction keeps the lowest rank (worst outcome wins the quorum verdict)
_COMMIT_RANK = {commands.CommitOutcome.Insufficient: 0,
                commands.CommitOutcome.Rejected: 1,
                commands.CommitOutcome.Redundant: 2,
                commands.CommitOutcome.Success: 3}


class CommitOk(Reply):
    type = MessageType.STABLE_FAST_PATH_REQ

    def __init__(self, final: bool = True):
        self._final = final

    def is_ok(self) -> bool:
        return True

    def is_final(self) -> bool:
        return self._final

    def __repr__(self):
        return "CommitOk"


class CommitNack(Reply):
    def __init__(self, reason: str):
        self.reason = reason

    def is_ok(self) -> bool:
        return False

    def __repr__(self):
        return f"CommitNack({self.reason})"


class Commit(TxnRequest):
    """(ref: messages/Commit.java)."""

    type = MessageType.STABLE_FAST_PATH_REQ

    def __init__(self, kind: CommitKind, txn_id: TxnId, txn: Optional[Txn],
                 route: Route, execute_at: Timestamp, deps,
                 read: bool = False, min_epoch: Optional[int] = None,
                 ballot: Ballot = Ballot.ZERO):
        super().__init__(txn_id, route, execute_at.epoch())
        self.kind = kind
        self.txn = txn                  # None => replica must already know it
        self.execute_at = execute_at
        self.deps = deps                # full Deps
        self.read = read
        self.is_slow_read = read      # fused read replies at execution time
        self.min_epoch = min_epoch if min_epoch is not None else txn_id.epoch()
        self.ballot = ballot

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, route = self.txn_id, self.route
        max_epoch = self.execute_at.epoch()

        def map_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.all_between(self.min_epoch, max_epoch)
            partial_txn = self.txn.slice(owned, False) if self.txn is not None else None
            partial_deps = self.deps.slice(owned) if self.deps is not None else None
            outcome = commands.commit(
                safe, txn_id, self.kind is CommitKind.Stable, self.ballot,
                route, partial_txn, self.execute_at, partial_deps,
                node.select_progress_key(txn_id, route))
            return outcome

        def reduce_fn(a, b):
            return a if _COMMIT_RANK[a] < _COMMIT_RANK[b] else b

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
                return
            if result is commands.CommitOutcome.Insufficient:
                node.reply(from_id, reply_context, CommitNack("Insufficient"))
                return
            if result is commands.CommitOutcome.Rejected:
                node.reply(from_id, reply_context, CommitNack("Rejected"))
                return
            if not self.read:
                node.reply(from_id, reply_context, CommitOk())
                return
            # fused read (ref: Commit.stableAndRead): ack stability now,
            # deliver data when the drain releases us
            node.reply(from_id, reply_context, CommitOk(final=False))
            self._begin_read(node, from_id, reply_context)

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), route.participants,
            self.min_epoch, max_epoch, map_fn, reduce_fn, consume)

    def _begin_read(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id

        def start():
            stores = node.command_stores.intersecting(
                self.route.participants, self.min_epoch,
                self.execute_at.epoch())
            chains = [s.execute(PreLoadContext.for_txn(txn_id),
                                lambda safe: read_on_store(safe, txn_id))
                      for s in stores]
            async_chain.all_of(chains).flat_map(async_chain.all_of).map(merge_datas).begin(
                lambda data, fail:
                node.reply(from_id, reply_context,
                           ReadNack("Redundant" if isinstance(fail, ReadRedundant)
                                    else "Unavailable"
                                    if isinstance(fail, ReadStale)
                                    else "Failed") if fail is not None
                           else ReadOk(data)))

        # bootstrap gate: defer until adopted ranges become readable; past
        # the deadline nack so the coordinator reads another replica
        node.command_stores.when_readable(
            self.route.participants, start,
            on_unavailable=lambda: node.reply(from_id, reply_context,
                                              ReadNack("Unavailable")))


class CommitInvalidate(TxnRequest):
    """(ref: messages/Commit.java Invalidate leg / commitInvalidate)."""

    type = MessageType.COMMIT_INVALIDATE_REQ

    def __init__(self, txn_id: TxnId, route: Route):
        super().__init__(txn_id, route, txn_id.epoch())

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id

        def map_fn(safe: SafeCommandStore):
            commands.commit_invalidate(safe, txn_id)
            return True

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), self.route.participants,
            txn_id.epoch(), txn_id.epoch(), map_fn,
            lambda a, b: a, lambda r, f: None)
