"""CheckStatus: read-only quorum probe of a transaction's state.

Rebuild of ref: accord-core/src/main/java/accord/messages/CheckStatus.java
(911 LoC; replies merge through the Known lattice).  Used by MaybeRecover to
decide whether anyone is making progress before escalating to full recovery,
and by FetchData to pull missing knowledge.
"""

from __future__ import annotations

import enum
from typing import Optional

from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import Durability, Known, SaveStatus, Status
from ..primitives.keys import Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from .base import MessageType, Reply, Request


class IncludeInfo(enum.IntEnum):
    No = 0
    Route = 1
    All = 2


class CheckStatusOk(Reply):
    type = MessageType.CHECK_STATUS_RSP

    def __init__(self, save_status: SaveStatus, promised: Ballot,
                 accepted: Ballot, execute_at: Optional[Timestamp],
                 durability: Durability, route: Optional[Route],
                 home_key: Optional[int],
                 partial_txn=None, partial_deps=None, writes=None,
                 result=None, truncated_covering=None):
        self.save_status = save_status
        self.promised = promised
        self.accepted = accepted
        self.execute_at = execute_at
        self.durability = durability
        self.route = route
        self.home_key = home_key
        self.partial_txn = partial_txn
        self.partial_deps = partial_deps
        self.writes = writes
        self.result = result
        # the ranges over which a Truncated/Erased claim is PROVEN (the
        # replying store's durably-settled slice): durability itself merges
        # as a txn-global max, so a purge acting on truncation must check
        # its own slice against this, not the scalar (a one-shard erasure
        # must not purge another shard's unapplied copy)
        self.truncated_covering = truncated_covering

    def is_ok(self) -> bool:
        return True

    @property
    def known(self) -> Known:
        return self.save_status.known

    def merge(self, that: "CheckStatusOk") -> "CheckStatusOk":
        """Keep the reply with most knowledge per field
        (ref: CheckStatus.CheckStatusOk.merge)."""
        hi, lo = (self, that)
        if (that.save_status, that.accepted) > (self.save_status, self.accepted):
            hi, lo = (that, self)
        route = hi.route
        if route is None or (lo.route is not None and lo.route.is_full
                             and not route.is_full):
            route = lo.route if lo.route is not None else route
        return CheckStatusOk(
            hi.save_status,
            max(hi.promised, lo.promised),
            hi.accepted,
            hi.execute_at if hi.execute_at is not None else lo.execute_at,
            hi.durability.merge(lo.durability),
            route,
            hi.home_key if hi.home_key is not None else lo.home_key,
            _merge_partial_txn(hi.partial_txn, lo.partial_txn),
            _merge_partial_deps(hi, lo),
            hi.writes if hi.writes is not None else lo.writes,
            hi.result if hi.result is not None else lo.result,
            _union_coverings(hi.truncated_covering, lo.truncated_covering))

    def __repr__(self):
        return (f"CheckStatusOk({self.save_status.name}, promised={self.promised}, "
                f"durability={self.durability.name})")


def _union_coverings(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a.with_(b)


def _merge_partial_txn(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a.with_partial(b)


def _merge_partial_deps(hi: "CheckStatusOk", lo: "CheckStatusOk"):
    """Union deps coverage across replies, but only between replies whose
    deps are DECIDED (>= Committed): each such reply holds a slice of the
    same agreed dep set, so the union widens range coverage soundly.  An
    undecided reply's deps are a per-replica proposal and must never be
    unioned into decided deps (ref: CheckStatus merges via the Known
    lattice; see also LatestDeps covering in RecoverOk)."""
    def decided(ok):
        return (ok.partial_deps is not None
                and ok.save_status.status >= Status.Committed)
    if decided(hi) and decided(lo):
        return hi.partial_deps.with_partial(lo.partial_deps)
    if decided(hi):
        return hi.partial_deps
    if decided(lo):
        return lo.partial_deps
    # neither decided: keep the more-advanced reply's proposal, if any
    return hi.partial_deps if hi.partial_deps is not None else lo.partial_deps


class CheckStatusNack(Reply):
    type = MessageType.CHECK_STATUS_RSP

    def is_ok(self) -> bool:
        return False

    def __repr__(self):
        return "CheckStatusNack"


class CheckStatus(Request):
    """(ref: messages/CheckStatus.java).  Not a TxnRequest: it may be sent
    with only a routing hint, before the route is known."""

    type = MessageType.CHECK_STATUS_REQ

    def __init__(self, txn_id: TxnId, query, epoch: int,
                 include_info: IncludeInfo = IncludeInfo.No):
        self.txn_id = txn_id
        self.query = query            # Unseekables to probe
        self.epoch = epoch
        self.include_info = include_info
        self.wait_for_epoch = epoch

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id
        include = self.include_info

        def map_fn(safe: SafeCommandStore):
            cmd = safe.if_present(txn_id)
            if cmd is None or cmd.save_status is SaveStatus.Uninitialised:
                # the record may be GONE because cleanup erased it: if the
                # store's durability watermarks prove everything at/below
                # this id is durably settled on our slice, answer with the
                # inference instead of a Nack (ref: the ErasedOrInvalidated
                # inference, CheckStatus.java / Infer) — a straggler
                # replica fetching a truncated txn must be able to learn
                # "durably done everywhere" or it refetches forever
                from .propagate import _propagate_min_epoch
                owned = safe.store.ranges_for_epoch.all_between(
                    _propagate_min_epoch(txn_id), txn_id.epoch())
                if not owned.is_empty() and txn_id < \
                        safe.store.durable_before.min_universal_before(owned):
                    # min_universal_before is gap-aware (an uncovered
                    # segment yields NONE and fails the gate), so the
                    # universal-tier proof already spans the whole owned
                    # slice — advertise it all; narrowing further only
                    # costs the straggler's liveness
                    return CheckStatusOk(
                        SaveStatus.Erased, Ballot.ZERO, Ballot.ZERO, None,
                        Durability.UniversalOrInvalidated, None, None,
                        truncated_covering=owned)
                return CheckStatusNack()
            full = include is IncludeInfo.All
            covering = None
            if cmd.is_truncated():
                # the truncation claim is proven exactly for the shard-
                # redundant part of this store's slice of the txn
                from ..local.redundant import participant_slice
                owned = safe.store.ranges_for_epoch.all()
                covering = safe.redundant_before().shard_redundant_ranges(
                    txn_id, participant_slice(owned, cmd.participants()))
                if covering.is_empty():
                    covering = None
            return CheckStatusOk(
                cmd.save_status, cmd.promised, cmd.accepted, cmd.execute_at,
                cmd.durability,
                cmd.route if include >= IncludeInfo.Route else None,
                cmd.route.home_key if cmd.route is not None else None,
                cmd.partial_txn if full else None,
                cmd.partial_deps if full else None,
                cmd.writes if full else None,
                cmd.result if full else None,
                truncated_covering=covering)

        def reduce_fn(a, b):
            if not a.is_ok():
                return b
            if not b.is_ok():
                return a
            return a.merge(b)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
            elif result is None:
                node.reply(from_id, reply_context, CheckStatusNack())
            else:
                node.reply(from_id, reply_context, result)

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), self.query,
            self.epoch, self.epoch, map_fn, reduce_fn, consume)

    def __repr__(self):
        return f"CheckStatus({self.txn_id})"
