"""Standalone dependency / conflict probes.

Rebuild of ref: accord-core/src/main/java/accord/messages/GetDeps.java
(the CollectDeps leg: fetch a quorum's dependency sets for a txn at a given
executeAt without running consensus — recovery uses it to fill ranges its
Accept quorum never voted on) and GetMaxConflict.java (the highest conflict
timestamp a replica has witnessed for some keys — bootstrap's
FetchMaxConflict uses it to pick a safe-to-read bound).
"""

from __future__ import annotations

from ..local.command_store import PreLoadContext, SafeCommandStore
from ..primitives.keys import Ranges, Route
from ..primitives.timestamp import Timestamp, TxnId
from .base import MessageType, Reply, Request, TxnRequest


class GetDepsOk(Reply):
    type = MessageType.GET_DEPS_RSP

    def __init__(self, deps):
        self.deps = deps            # PartialDeps

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return "GetDepsOk"


class GetDeps(TxnRequest):
    """(ref: messages/GetDeps.java): the deps this replica would have
    witnessed for ``txn_id`` executing at ``execute_at``, over its owned
    slice of the selection."""

    type = MessageType.GET_DEPS_REQ

    def __init__(self, txn_id: TxnId, route: Route, keys,
                 execute_at: Timestamp):
        super().__init__(txn_id, route, execute_at.epoch())
        self.keys = keys
        self.execute_at = execute_at

    def process(self, node, from_id: int, reply_context) -> None:
        from .preaccept import calculate_partial_deps
        txn_id = self.txn_id

        def map_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.all_between(
                txn_id.epoch(), self.execute_at.epoch())
            keys = self.keys.slice(owned)
            return GetDepsOk(calculate_partial_deps(
                safe, txn_id, keys, self.execute_at, owned))

        def reduce_fn(a, b):
            return GetDepsOk(a.deps.with_partial(b.deps))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
            elif result is None:
                from .ephemeral import _empty_partial
                node.reply(from_id, reply_context, GetDepsOk(_empty_partial()))
            else:
                node.reply(from_id, reply_context, result)

        node.map_reduce_consume_local(
            PreLoadContext.empty(), self.route.participants,
            txn_id.epoch(), self.execute_at.epoch(), map_fn, reduce_fn,
            consume)


class GetMaxConflictOk(Reply):
    type = MessageType.GET_MAX_CONFLICT_RSP

    def __init__(self, max_conflict: Timestamp, latest_epoch: int):
        self.max_conflict = max_conflict
        self.latest_epoch = latest_epoch

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return f"GetMaxConflictOk({self.max_conflict})"


class GetMaxConflict(Request):
    """(ref: messages/GetMaxConflict.java): the maximum conflict timestamp
    this replica has witnessed for the selection, plus its latest epoch."""

    type = MessageType.GET_MAX_CONFLICT_REQ

    def __init__(self, participants, execution_epoch: int):
        self.participants = participants
        self.execution_epoch = execution_epoch
        self.wait_for_epoch = execution_epoch

    def process(self, node, from_id: int, reply_context) -> None:
        def map_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.all_between(
                1, self.execution_epoch)
            sliced = (self.participants.intersecting(owned)
                      if isinstance(self.participants, Ranges)
                      else self.participants.slice(owned))
            return GetMaxConflictOk(safe.max_conflict(sliced),
                                    max(node.epoch(), self.execution_epoch))

        def reduce_fn(a, b):
            return GetMaxConflictOk(max(a.max_conflict, b.max_conflict),
                                    max(a.latest_epoch, b.latest_epoch))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
            elif result is None:
                node.reply(from_id, reply_context,
                           GetMaxConflictOk(Timestamp.NONE, node.epoch()))
            else:
                node.reply(from_id, reply_context, result)

        node.map_reduce_consume_local(
            PreLoadContext.empty(), self.participants,
            self.execution_epoch, self.execution_epoch, map_fn, reduce_fn,
            consume)
