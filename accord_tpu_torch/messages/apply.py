"""Apply: deliver writes + result to replicas.

Rebuild of ref: accord-core/src/main/java/accord/messages/Apply.java:47-200
(Kind {Minimal, Maximal}; ApplyReply {Redundant/Applied/Insufficient}).
"""

from __future__ import annotations

import enum
from typing import Optional

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..primitives.keys import Route
from ..primitives.timestamp import Timestamp, TxnId
from ..primitives.txn import Txn
from ..primitives.writes import Writes
from .base import MessageType, Reply, TxnRequest


class ApplyReplyKind(enum.IntEnum):
    Applied = 0
    Redundant = 1
    Insufficient = 2


# per-store outcome -> reply kind; module-level so the hot map_fn does a
# single dict probe instead of rebuilding the literal per op
_APPLY_OUTCOME_KIND = {
    commands.ApplyOutcome.Success: ApplyReplyKind.Applied,
    commands.ApplyOutcome.Redundant: ApplyReplyKind.Redundant,
    commands.ApplyOutcome.Insufficient: ApplyReplyKind.Insufficient,
}


class ApplyReply(Reply):
    type = MessageType.APPLY_RSP

    def __init__(self, kind: ApplyReplyKind):
        self.kind = kind

    def is_ok(self) -> bool:
        return self.kind in (ApplyReplyKind.Applied, ApplyReplyKind.Redundant)

    def __repr__(self):
        return f"ApplyReply({self.kind.name})"


class Apply(TxnRequest):
    """(ref: messages/Apply.java).  kind='minimal' relies on the replica
    already having txn+deps; 'maximal' carries them for stragglers."""

    type = MessageType.APPLY_MINIMAL_REQ

    def __init__(self, kind: str, txn_id: TxnId, route: Route,
                 execute_at: Timestamp, deps, writes: Optional[Writes],
                 result, txn: Optional[Txn] = None):
        super().__init__(txn_id, route, execute_at.epoch())
        self.kind = kind
        self.execute_at = execute_at
        self.deps = deps
        self.writes = writes
        self.result = result
        self.txn = txn
        # NOTE: replicas process Apply over [txn_id.epoch, executeAt.epoch]
        # only.  Widening to the coordinator's dual-quorum window (so
        # dropped donors apply over lost ranges) was tried and produces
        # divergent stale copies: a replica that lost a range applies some
        # later txns there but is excluded from others' fan-outs once the
        # epoch syncs, leaving gap-ordered values that can resurface.  A
        # dropped donor that cannot witness the bootstrap fence simply
        # times out the joiner's fetch and another donor is used.
        self.min_epoch = txn_id.epoch()
        if kind == "maximal":
            self.type = MessageType.APPLY_MAXIMAL_REQ

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, route = self.txn_id, self.route
        min_epoch, max_epoch = self.min_epoch, self.execute_at.epoch()

        def map_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.all_between(min_epoch, max_epoch)
            partial_txn = self.txn.slice(owned, False) if self.txn is not None else None
            partial_deps = self.deps.slice(owned) if self.deps is not None else None
            outcome = commands.apply(safe, txn_id, route, self.execute_at,
                                     partial_deps, partial_txn, self.writes,
                                     self.result)
            return _APPLY_OUTCOME_KIND[outcome]

        def reduce_fn(a, b):
            return max(a, b)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
            else:
                node.reply(from_id, reply_context,
                           ApplyReply(result if result is not None
                                      else ApplyReplyKind.Redundant))

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), route.participants,
            min_epoch, max_epoch, map_fn, reduce_fn, consume)
