"""PreAccept: witness a txn, propose witnessedAt, compute deps.

Rebuild of ref: accord-core/src/main/java/accord/messages/PreAccept.java:37-335.
The replica-side deps computation (calculate_partial_deps) is THE hot loop:
per key it is CommandsForKey.map_reduce_active (host path) and, batched, the
deps-scan kernel in accord_tpu.ops.deps_kernels (device path).
"""

from __future__ import annotations

from typing import List, Optional

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..primitives.deps import Deps, DepsBuilder, PartialDeps
from ..primitives.keys import Range, Ranges, Route
from ..primitives.timestamp import Timestamp, TxnId
from ..primitives.txn import Txn
from ..utils import async_chain, invariants
from .base import MessageType, Reply, TxnRequest


def calculate_partial_deps(safe: SafeCommandStore, txn_id: TxnId, keys,
                           started_before: Timestamp,
                           covering: Ranges) -> PartialDeps:
    """Scan this store's conflict indexes for dependencies of txn_id
    (ref: PreAccept.calculatePartialDeps :245-265): all active txns with
    lower id whose kind must be witnessed, floored by RedundantBefore."""
    builder = DepsBuilder()
    witnesses = txn_id.kind().witnesses()

    if safe.store.device is not None:
        # device path: one batched interval-overlap kernel answers the
        # KeyDeps scan and the RangeDeps stabbing query together
        # (accord_tpu.local.device_index + ops.deps_kernel)
        safe.store.device.deps_query(safe, txn_id, keys, started_before,
                                     witnesses, builder)
    else:
        def fold(key_or_ranges, dep_id: TxnId, acc):
            if dep_id == txn_id:
                return acc
            if isinstance(key_or_ranges, int):
                if dep_id >= safe.redundant_before().deps_floor(key_or_ranges):
                    acc.add_key(key_or_ranges, dep_id)
            else:
                for rng in key_or_ranges:
                    acc.add_range(rng, dep_id)
            return acc

        safe.map_reduce_active(keys, started_before, witnesses, fold, builder)

    add_boundary_deps(safe, txn_id, keys, started_before, builder)
    return builder.build_partial(covering)


def calculate_partial_deps_async(safe: SafeCommandStore, txn_id: TxnId,
                                 keys, started_before: Timestamp,
                                 covering: Ranges, done) -> None:
    """The COALESCED deps scan: enqueue into the store's device query
    queue and fire ``done(partial_deps, failure)`` after the shared flush
    (all PreAccepts landing in the same scheduler quantum ride one kernel
    dispatch).  Falls back to the synchronous path off-device."""
    dev = safe.store.device
    if dev is None:
        try:
            done(calculate_partial_deps(safe, txn_id, keys, started_before,
                                        covering), None)
        except BaseException as e:  # noqa: BLE001
            done(None, e)
        return
    builder = DepsBuilder()
    witnesses = txn_id.kind().witnesses()
    query = dev.build_query(safe, txn_id, keys, started_before, witnesses)
    store = safe.store

    def finish(failure, flush_safe) -> None:
        if failure is not None:
            done(None, failure)
            return
        try:
            add_boundary_deps(flush_safe, txn_id, keys, started_before,
                              builder)
            done(builder.build_partial(covering), None)
        except BaseException as e:  # noqa: BLE001
            done(None, e)

    if query is None:
        finish(None, safe)
        return
    dev.enqueue_query(query, builder, finish)


def add_boundary_deps(safe: SafeCommandStore, txn_id: TxnId, keys,
                      started_before: Timestamp, builder) -> None:
    """collectDeps boundary (ref: RedundantBefore.collectDeps consumed at
    PreAccept.java:245-264): where the floor pruned history, depend on the
    floor itself — the bootstrap fence RX, a real txn whose deps cover
    everything pruned — so merged deps never silently lose coverage."""
    rb = safe.redundant_before()
    if isinstance(keys, Ranges):
        for rng, boundary in rb.boundary_deps_in(keys):
            if boundary != txn_id and boundary < started_before:
                builder.add_range(rng, boundary)
    else:
        for key in keys:
            boundary = rb.boundary_dep(key.token())
            if boundary is not None and boundary != txn_id \
                    and boundary < started_before:
                builder.add_key(key.token(), boundary)


class PreAcceptOk(Reply):
    type = MessageType.PRE_ACCEPT_RSP

    def __init__(self, txn_id: TxnId, witnessed_at: Timestamp,
                 deps: PartialDeps):
        self.txn_id = txn_id
        self.witnessed_at = witnessed_at
        self.deps = deps

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return f"PreAcceptOk({self.txn_id}@{self.witnessed_at})"


class PreAcceptNack(Reply):
    type = MessageType.PRE_ACCEPT_RSP

    def __init__(self, reason: str = "Preempted", reject_floor=None):
        self.reason = reason   # "Preempted" | "Rejected" (fence) | "Truncated"
        # for "Rejected": the fence bound, so the coordinator's retry can
        # bump its HLC past it (see AcceptReply.reject_floor)
        self.reject_floor = reject_floor

    @property
    def rejected(self) -> bool:
        """Fenced by rejectBefore — the uniform flag coordinators test (the
        same attribute exists on AcceptReply) to retry with a fresh TxnId."""
        return self.reason == "Rejected"

    def is_ok(self) -> bool:
        return False

    def __repr__(self):
        return f"PreAcceptNack({self.reason})"


class PreAccept(TxnRequest):
    """(ref: messages/PreAccept.java)."""

    type = MessageType.PRE_ACCEPT_REQ

    def __init__(self, txn_id: TxnId, txn: Txn, route: Route, max_epoch: int,
                 min_epoch: Optional[int] = None):
        super().__init__(txn_id, route, max_epoch)
        self.txn = txn
        self.max_epoch = max_epoch
        # during reconfiguration the coordinator contacts prior-epoch
        # replicas too (dual quorum, ref: PreAccept.java:109-114); they only
        # intersect at their old-epoch ranges
        self.min_epoch = min_epoch if min_epoch is not None else txn_id.epoch()

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, txn, route = self.txn_id, self.txn, self.route
        min_epoch = self.min_epoch

        def map_fn(safe: SafeCommandStore):
            """Returns a CHAIN of the store's reply: the deps scan rides
            the store-level coalescer (one kernel dispatch per quantum
            across every same-instant PreAccept on this store)."""
            owned = safe.store.ranges_for_epoch.all_between(min_epoch, self.max_epoch)
            partial_txn = txn.slice(owned, route.home_key is not None)
            progress_key = node.select_progress_key(txn_id, route)
            outcome, witnessed_at = commands.preaccept(
                safe, txn_id, partial_txn, route, progress_key)
            if outcome is commands.AcceptOutcome.RejectedBallot:
                return async_chain.success(PreAcceptNack("Preempted"))
            if outcome is commands.AcceptOutcome.Truncated:
                return async_chain.success(PreAcceptNack("Truncated"))
            if outcome is commands.AcceptOutcome.Rejected:
                return async_chain.success(
                    PreAcceptNack("Rejected", reject_floor=witnessed_at))
            if outcome is commands.AcceptOutcome.Redundant:
                cmd = safe.get(txn_id)
                witnessed_at = cmd.execute_at
            out = async_chain.AsyncResult()

            def on_deps(deps, failure):
                if failure is not None:
                    out.set_failure(failure)
                else:
                    out.set_success(PreAcceptOk(txn_id, witnessed_at, deps))

            calculate_partial_deps_async(safe, txn_id, partial_txn.keys,
                                         txn_id, owned, on_deps)
            return out

        def reduce_fn(a, b):
            """(ref: PreAccept.java:140-156): max-merge witnessedAt, union deps."""
            if not a.is_ok():
                return a
            if not b.is_ok():
                return b
            witnessed = a.witnessed_at if a.witnessed_at >= b.witnessed_at else b.witnessed_at
            return PreAcceptOk(txn_id, witnessed,
                               a.deps.with_partial(b.deps))

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(from_id, reply_context, failure)
            elif result is None:
                node.reply(from_id, reply_context, PreAcceptNack())
            else:
                node.reply(from_id, reply_context, result)

        stores = node.command_stores.intersecting(
            route.participants, min_epoch, self.max_epoch)
        if not stores:
            consume(None, None)
            return
        ctx = PreLoadContext.for_txn(txn_id)
        chains = [s.execute(ctx, map_fn).flat_map(lambda inner: inner)
                  for s in stores]
        async_chain.reduce(chains, reduce_fn).begin(consume)
