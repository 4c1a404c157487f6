"""Replica-side execution of reads: wait for ReadyToExecute, then read.

Rebuild of ref: accord-core/src/main/java/accord/messages/ReadData.java:52-300,
ReadTxnData.java.  A read registers a transient listener per store until the
command's SaveStatus reaches ReadyToExecute (deps with lower executeAt all
applied — the drain gate), then runs the SPI Read and merges Data across
stores.
"""

from __future__ import annotations

from typing import List, Optional

from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import SaveStatus
from ..obs import spans_of
from ..primitives.keys import Ranges, Route
from ..primitives.timestamp import Timestamp, TxnId
from ..utils import async_chain
from .base import MessageType, Reply, TxnRequest


class ReadOk(Reply):
    type = MessageType.READ_RSP

    def __init__(self, data, unavailable: Optional[Ranges] = None):
        self.data = data
        self.unavailable = unavailable

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return f"ReadOk({self.data})"


class ReadNack(Reply):
    type = MessageType.READ_RSP

    def __init__(self, reason: str = "NotCommitted"):
        self.reason = reason

    def is_ok(self) -> bool:
        return False

    def __repr__(self):
        return f"ReadNack({self.reason})"


def merge_datas(datas) -> object:
    """Merge per-store / per-replica Data payloads (None-tolerant)."""
    result = None
    for d in datas:
        if d is None:
            continue
        result = d if result is None else result.merge(d)
    return result


class ReadRedundant(RuntimeError):
    """The command was invalidated or truncated locally — nothing left to
    read; the coordinator must use a different replica or the persisted
    outcome."""


def read_on_store(safe: SafeCommandStore, txn_id: TxnId
                  ) -> async_chain.AsyncChain:
    """Wait (if needed) for txn_id to become ready on this store, then
    perform its reads over this store's owned keys.  Returns chain of Data
    or None (ref: ReadData waitUntil + beginRead :264).

    The read gate: deps with lower executeAt must have applied
    (ReadyToExecute, or PreApplied with an empty frontier).  The data store
    is versioned by executeAt, so a read arriving after the txn (or later
    txns) applied locally still serves the exact pre-state at its
    executeAt (ref: the Timestamped values in the reference's ListStore)."""
    out: async_chain.AsyncResult = async_chain.AsyncResult()

    def try_read(s: SafeCommandStore, cmd, via_listener: bool) -> bool:
        if cmd.is_invalidated() or cmd.is_truncated():
            out.set_failure(ReadRedundant(f"read of invalidated/truncated {txn_id}"))
            return True
        st = cmd.save_status
        if st is SaveStatus.ReadyToExecute or st is SaveStatus.Applying \
                or st is SaveStatus.Applied or (
                st is SaveStatus.PreApplied and not cmd.is_waiting()):
            _begin_read(s, cmd, out)
            return True
        return False

    cmd = safe.get(txn_id)
    if try_read(safe, cmd, via_listener=False):
        return out

    # the txn is not yet ReadyToExecute on this store: the read waits on
    # the local drain (deps with lower executeAt applying) — the
    # deps-wait leg of the txn's span tree, stamped on the REPLICA
    spans = spans_of(safe.store.node)
    sp_wait = None
    if spans is not None:
        sp_wait = spans.begin(
            str(txn_id), "deps_wait",
            node=getattr(safe.store.node, "node_id", None),
            store=getattr(safe.store, "store_id", None))

    def listener(s: SafeCommandStore, updated) -> None:
        if try_read(s, updated, via_listener=True):
            if spans is not None:    # the drain released the txn here
                spans.end(sp_wait)
            s.remove_transient_listeners(txn_id)

    safe.add_transient_listener(txn_id, listener)
    return out


class ReadStale(RuntimeError):
    """The store's data for a requested range is stale (the staleness
    escape hatch fired; a re-bootstrap is in flight) — the read must go to
    another replica (ref: CommandStore.safeToReadAt / markUnsafeToRead)."""


def _begin_read(safe: SafeCommandStore, cmd,
                out: async_chain.AsyncResult) -> None:
    node = safe.store.node
    partial_txn = cmd.partial_txn
    if partial_txn is None or partial_txn.read is None:
        out.set_success(None)
        return
    owned = safe.ranges(cmd.execute_at.epoch())
    stale = safe.store.redundant_before.stale_ranges(owned)
    if not stale.is_empty() and any(
            stale.contains_token(k.token())
            for k in partial_txn.read.keys().slice(owned)):
        out.set_failure(ReadStale(f"stale ranges {stale} for {cmd.txn_id}"))
        return
    keys = partial_txn.read.keys().slice(owned)
    chains = []
    for key in keys:
        chains.append(partial_txn.read.read(key, safe, cmd.execute_at,
                                            node.data_store))
    if not chains:
        out.set_success(None)
        return
    async_chain.all_of(chains).map(merge_datas).begin(out.settle)


class ReadTxnData(TxnRequest):
    """Standalone read verb (ref: messages/ReadTxnData.java)."""

    type = MessageType.READ_REQ
    is_slow_read = True   # replies when the drain releases the txn

    def __init__(self, txn_id: TxnId, route: Route, execute_at_epoch: int):
        super().__init__(txn_id, route, execute_at_epoch)
        self.execute_at_epoch = execute_at_epoch

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id
        stores = node.command_stores.intersecting(
            self.route.participants, txn_id.epoch(), self.execute_at_epoch)
        if not stores:
            node.reply(from_id, reply_context, ReadNack("NotOwned"))
            return

        def start():
            # bootstrap gate passed: adopted ranges are readable now
            chains = [s.execute(PreLoadContext.for_txn(txn_id),
                                lambda safe: read_on_store(safe, txn_id))
                      for s in stores]
            # each store task returns a chain; flatten then merge data
            async_chain.all_of(chains).flat_map(async_chain.all_of).map(merge_datas).begin(
                lambda data, fail:
                node.reply(from_id, reply_context,
                           ReadNack("Redundant" if isinstance(fail, ReadRedundant)
                                    else "Unavailable"
                                    if isinstance(fail, ReadStale)
                                    else "Failed") if fail is not None
                           else ReadOk(data)))

        node.command_stores.when_readable(
            self.route.participants, start,
            on_unavailable=lambda: node.reply(from_id, reply_context,
                                              ReadNack("Unavailable")))
