"""Ephemeral read verbs: deps fetch + gated read, no durable state.

Rebuild of ref: accord-core/src/main/java/accord/messages/
GetEphemeralReadDeps.java (deps over EVERYTHING started before Timestamp.MAX
plus the replica's latest epoch) and ReadEphemeralTxnData.java (read gated on
the coordinator-supplied deps having applied locally).  The txn itself is
never witnessed, accepted or committed anywhere — it leaves no protocol
state behind (TxnKind.EphemeralRead is not globally visible).
"""

from __future__ import annotations

from typing import List, Optional

from ..local.status import Status
from ..primitives.keys import Ranges, Route
from ..primitives.timestamp import Timestamp, TxnId
from ..utils import async_chain
from .base import MessageType, Reply, Request, TxnRequest
from .read_data import ReadNack, ReadOk, merge_datas


class GetEphemeralReadDepsOk(Reply):
    type = MessageType.GET_EPHEMERAL_READ_DEPS_RSP

    def __init__(self, deps, latest_epoch: int):
        self.deps = deps            # PartialDeps
        self.latest_epoch = latest_epoch

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return f"GetEphemeralReadDepsOk(epoch={self.latest_epoch})"


class GetEphemeralReadDeps(TxnRequest):
    """(ref: messages/GetEphemeralReadDeps.java).  Deps are computed with an
    unbounded started-before: anything that MIGHT have finished before the
    read began must be waited on."""

    type = MessageType.GET_EPHEMERAL_READ_DEPS_REQ

    def __init__(self, txn_id: TxnId, route: Route, keys,
                 execution_epoch: int):
        super().__init__(txn_id, route, execution_epoch)
        self.keys = keys
        self.execution_epoch = execution_epoch

    def process(self, node, from_id: int, reply_context) -> None:
        from ..local.command_store import PreLoadContext
        from .preaccept import calculate_partial_deps
        txn_id = self.txn_id

        def map_fn(safe):
            owned = safe.store.ranges_for_epoch.all_between(
                txn_id.epoch(), self.execution_epoch)
            keys = self.keys.slice(owned)
            deps = calculate_partial_deps(safe, txn_id, keys,
                                          Timestamp.MAX, owned)
            return GetEphemeralReadDepsOk(deps, max(node.epoch(),
                                                    self.execution_epoch))

        def reduce_fn(a, b):
            return GetEphemeralReadDepsOk(a.deps.with_partial(b.deps),
                                          max(a.latest_epoch, b.latest_epoch))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
            elif result is None:
                node.reply(from_id, reply_context,
                           GetEphemeralReadDepsOk(
                               _empty_partial(), node.epoch()))
            else:
                node.reply(from_id, reply_context, result)

        node.map_reduce_consume_local(
            PreLoadContext.empty(), self.route.participants,
            txn_id.epoch(), self.execution_epoch, map_fn, reduce_fn, consume)


def _empty_partial():
    from ..primitives.deps import DepsBuilder
    return DepsBuilder().build_partial(Ranges.empty())


def await_deps_applied(safe, deps) -> async_chain.AsyncChain:
    """Settle once every dep (sliced to this store) has applied locally, been
    invalidated/truncated, or is answered by the redundancy watermarks.
    Unknown deps are reported to the progress log for fetching — the
    ephemeral read must not wait forever on a dep whose Apply this replica
    missed (ref: ReadEphemeralTxnData's waitUntilApplied leg)."""
    owned = safe.store.ranges_for_epoch.all()
    dep_ids: List[TxnId] = []
    seen = set()
    for token in deps.key_deps.keys:
        if owned.contains_token(token):
            for d in deps.key_deps.txn_ids_for(token):
                if d not in seen:
                    seen.add(d)
                    dep_ids.append(d)
    for rng in deps.range_deps.ranges:
        if owned.intersects(Ranges.of(rng)):
            for d in deps.range_deps.intersecting_range(rng):
                if d not in seen:
                    seen.add(d)
                    dep_ids.append(d)

    chains = []
    for dep in dep_ids:
        chains.append(_await_one(safe, dep, deps))
    if not chains:
        done = async_chain.AsyncResult()
        done.set_success(None)
        return done
    return async_chain.all_of(chains).map(lambda _: None)


def _await_one(safe, dep: TxnId, deps) -> async_chain.AsyncChain:
    from ..local.commands import _resolve_dep_participants
    out: async_chain.AsyncResult = async_chain.AsyncResult()

    def is_done(cmd) -> bool:
        if cmd is not None and (cmd.has_been(Status.Applied)
                                or cmd.is_invalidated() or cmd.is_truncated()):
            return True
        participants = deps.participants(dep)
        if participants.is_empty() and cmd is not None and cmd.route is not None:
            participants = cmd.route.participants
        dep_exec = (cmd.execute_at_if_known() if cmd is not None else None)
        return safe.redundant_before().locally_settled(dep, participants,
                                                       dep_exec)

    if is_done(safe.if_present(dep)):
        out.set_success(None)
        return out

    def listener(s, updated) -> None:
        if is_done(updated):
            s.remove_transient_listener(dep, listener)
            out.set_success(None)

    safe.add_transient_listener(dep, listener)
    safe.progress_log().waiting(dep, 0, None,
                                _resolve_dep_participants(safe, dep, deps))
    return out


class ReadEphemeralTxnData(Request):
    """(ref: messages/ReadEphemeralTxnData.java).  Carries the deps the
    coordinator gathered; the replica waits for them to apply locally, then
    reads CURRENT data (Timestamp.MAX version — all deps applied makes that
    linearizable per key)."""

    type = MessageType.READ_EPHEMERAL_REQ
    is_slow_read = True

    def __init__(self, txn_id: TxnId, read, keys, deps, execution_epoch: int):
        self.txn_id = txn_id
        self.read = read            # SPI Read
        self.keys = keys
        self.deps = deps            # PartialDeps (full union from quorum)
        self.execution_epoch = execution_epoch
        self.wait_for_epoch = execution_epoch

    def process(self, node, from_id: int, reply_context) -> None:
        from ..local.command_store import PreLoadContext
        participants = self.keys.to_unseekables()
        stores = node.command_stores.intersecting(
            participants, self.txn_id.epoch(), self.execution_epoch)
        if not stores:
            node.reply(from_id, reply_context, ReadNack("NotOwned"))
            return

        def start():
            def on_store(safe):
                return await_deps_applied(safe, self.deps).map(
                    lambda _: self._read(safe, node))

            chains = [s.execute(PreLoadContext.empty(), on_store)
                      for s in stores]
            async_chain.all_of(chains).flat_map(async_chain.all_of) \
                .flat_map(async_chain.all_of).map(merge_datas).begin(
                    lambda data, fail:
                    node.reply(from_id, reply_context,
                               ReadNack("Failed") if fail is not None
                               else ReadOk(data)))

        node.command_stores.when_readable(
            participants, start,
            on_unavailable=lambda: node.reply(from_id, reply_context,
                                              ReadNack("Unavailable")))

    def _read(self, safe, node) -> async_chain.AsyncChain:
        owned = safe.store.ranges_for_epoch.all()
        keys = self.read.keys().slice(owned)
        chains = [self.read.read(key, safe, Timestamp.MAX, node.data_store)
                  for key in keys]
        if not chains:
            done = async_chain.AsyncResult()
            done.set_success(None)
            return done
        return async_chain.all_of(chains).map(merge_datas)

    def __repr__(self):
        return f"ReadEphemeralTxnData({self.txn_id})"
