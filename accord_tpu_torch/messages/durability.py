"""Sync/durability verb family.

Rebuild of ref: accord-core/src/main/java/accord/messages/
WaitUntilApplied.java, SetShardDurable.java, SetGloballyDurable.java,
QueryDurableBefore.java — the verbs CoordinateShardDurable /
CoordinateGloballyDurable drive (coordinate/durability.py), which in turn
feed the Cleanup/truncation lifecycle (local/cleanup.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..local import cleanup
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import Status
from ..primitives.keys import Ranges, Route
from ..primitives.timestamp import TxnId
from .base import MessageType, Reply, Request, TxnRequest


class WaitUntilAppliedOk(Reply):
    type = MessageType.WAIT_UNTIL_APPLIED_REQ

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return "WaitUntilAppliedOk"


class WaitUntilApplied(TxnRequest):
    """Reply once txn_id has Applied (or been invalidated/truncated) on every
    intersecting local store (ref: messages/WaitUntilApplied.java)."""

    type = MessageType.WAIT_UNTIL_APPLIED_REQ
    is_slow_read = True   # replies only when the replica's drain releases it

    def __init__(self, txn_id: TxnId, participants: Ranges):
        super().__init__(txn_id, Route(None, participants, is_full=False),
                         txn_id.epoch())
        self.participants = participants
        self.max_epoch = txn_id.epoch()   # widened by the fused subclass

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id
        state = {"pending": 0, "scanned": False, "replied": False}

        def _maybe_reply():
            if state["scanned"] and state["pending"] == 0 \
                    and not state["replied"]:
                state["replied"] = True
                node.reply(from_id, reply_context, WaitUntilAppliedOk())

        def _is_done(cmd) -> bool:
            return (cmd.has_been(Status.Applied) or cmd.is_invalidated()
                    or cmd.is_truncated())

        def map_fn(safe: SafeCommandStore):
            cmd = safe.get(txn_id)
            if _is_done(cmd):
                return None
            state["pending"] += 1

            def on_change(s, updated):
                if _is_done(updated):
                    s.remove_transient_listener(txn_id, on_change)
                    state["pending"] -= 1
                    _maybe_reply()

            safe.add_transient_listener(txn_id, on_change)
            return None

        def consume(_result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
                return
            state["scanned"] = True
            _maybe_reply()

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), self.participants,
            txn_id.epoch(), self.max_epoch, map_fn, lambda a, b: None, consume)


class ApplyThenWaitUntilApplied(WaitUntilApplied):
    """The fused sync-point execution leg (ref: messages/
    ApplyThenWaitUntilApplied.java, sent by ExecuteSyncPoint): deliver the
    sync point's Apply and reply once it has applied on every intersecting
    local store.  A replica that missed earlier rounds gets the decided
    executeAt + deps directly instead of needing a fetch to unwedge the
    wait leg."""

    type = MessageType.APPLY_THEN_WAIT_UNTIL_APPLIED_REQ

    def __init__(self, txn_id: TxnId, route, execute_at, deps):
        TxnRequest.__init__(self, txn_id, route, execute_at.epoch())
        self.participants = route.participants
        self.max_epoch = max(txn_id.epoch(), execute_at.epoch())
        # mirror Apply's journaled-body surface (journal._outcome and
        # reconstruction read these fields from _APPLY_TYPES messages)
        self.kind = "minimal"
        self.execute_at = execute_at
        self.deps = deps
        self.writes = None
        self.result = None
        self.txn = None
        self.min_epoch = txn_id.epoch()

    def process(self, node, from_id: int, reply_context) -> None:
        from ..local import commands
        min_epoch, max_epoch = self.min_epoch, self.max_epoch

        def apply_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.all_between(min_epoch,
                                                            max_epoch)
            partial_deps = (self.deps.slice(owned)
                            if self.deps is not None else None)
            # Insufficient (store lacks the definition) is fine here: the
            # wait leg below keeps listening and the progress log fetches
            commands.apply(safe, self.txn_id, self.route, self.execute_at,
                           partial_deps, None, None, None)

        node.for_each_local(
            PreLoadContext.for_txn(self.txn_id), self.participants,
            min_epoch, max_epoch, apply_fn).begin(
                lambda _r, _f: WaitUntilApplied.process(
                    self, node, from_id, reply_context))


class SetShardDurable(TxnRequest):
    """The ExclusiveSyncPoint sync_id applied at EVERY replica of these
    ranges: advance the shard redundancy + durability watermarks and run
    cleanup (ref: messages/SetShardDurable.java -> markShardDurable)."""

    type = MessageType.SET_SHARD_DURABLE_REQ

    def __init__(self, sync_id: TxnId, ranges: Ranges):
        super().__init__(sync_id, Route(None, ranges, is_full=False),
                         sync_id.epoch())
        self.ranges = ranges

    def process(self, node, from_id: int, reply_context) -> None:
        sync_id, ranges = self.txn_id, self.ranges

        def apply_fn(safe: SafeCommandStore):
            cleanup.mark_shard_durable(safe, sync_id, ranges)

        node.for_each_local(PreLoadContext.empty(), ranges,
                            sync_id.epoch(), sync_id.epoch(), apply_fn)


class DurableBeforeReply(Reply):
    type = MessageType.QUERY_DURABLE_BEFORE_RSP

    def __init__(self, entries: List[Tuple[int, int, TxnId, TxnId]]):
        self.entries = entries   # (start, end, majority, universal)

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return f"DurableBeforeReply({len(self.entries)} segments)"


class QueryDurableBefore(Request):
    """Report this node's DurableBefore map
    (ref: messages/QueryDurableBefore.java)."""

    type = MessageType.QUERY_DURABLE_BEFORE_REQ

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.wait_for_epoch = epoch

    def process(self, node, from_id: int, reply_context) -> None:
        # entries are facts ("durable to S on [a,b)"), valid on any store;
        # concatenating per-store segments is a max-merge by construction
        entries: List[Tuple[int, int, TxnId, TxnId]] = []
        for store in node.command_stores.unsafe_all_stores():
            entries.extend(store.durable_before.entries())
        node.reply(from_id, reply_context, DurableBeforeReply(entries))


class SetGloballyDurable(Request):
    """Install gossiped DurableBefore facts
    (ref: messages/SetGloballyDurable.java)."""

    type = MessageType.SET_GLOBALLY_DURABLE_REQ

    def __init__(self, epoch: int,
                 entries: List[Tuple[int, int, TxnId, TxnId]]):
        self.epoch = epoch
        self.entries = entries
        self.wait_for_epoch = epoch

    def process(self, node, from_id: int, reply_context) -> None:
        entries = self.entries

        def apply_fn(safe: SafeCommandStore):
            safe.store.durable_before.merge_entries(entries)
            cleanup.on_durable_before_advance(safe)

        all_ranges = Ranges.of(*(r for s in
                                 node.command_stores.unsafe_all_stores()
                                 for r in s.ranges_for_epoch.all()))
        if all_ranges.is_empty():
            return
        node.for_each_local(PreLoadContext.empty(), all_ranges,
                            self.epoch, self.epoch, apply_fn)
