"""Propagate: apply remotely-learned knowledge to the local stores.

Rebuild of ref: accord-core/src/main/java/accord/messages/Propagate.java:63 —
the "local message" half of FetchData: a CheckStatus quorum's merged
knowledge (route, definition, executeAt, deps, outcome) is applied to this
node's own stores, only ever upgrading them.  As in the reference it is a
side-effecting LOCAL request (MessageType PROPAGATE_*): it flows through
Node._process so the journal persists it, and a restart reconstructs
commands learned this way exactly like commands learned from the wire.
"""

from __future__ import annotations

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import Status
from ..primitives.timestamp import Ballot, TxnId
from .base import MessageType, Request


def _propagate_min_epoch(txn_id: TxnId) -> int:
    """Sync points reach one epoch below their id (the dual-quorum
    handoff leg — see commands.apply_window_epochs)."""
    return commands.apply_window_epochs(txn_id, None)[0]


class Propagate(Request):
    """(ref: messages/Propagate.java)."""

    type = MessageType.PROPAGATE_OTHER_MSG

    def __init__(self, txn_id: TxnId, participants, ok):
        self.txn_id = txn_id
        self.participants = participants
        self.ok = ok                       # merged CheckStatusOk

    def process(self, node, from_id: int, reply_context) -> None:
        ok = self.ok
        txn_id = self.txn_id
        status = ok.save_status.status
        # The store-selection window must reach the EXECUTION epoch: a store
        # that witnessed the txn only through a later executeAt-epoch window
        # (its Commit/Apply fan-outs span [txnId.epoch, executeAt.epoch])
        # would otherwise never be selected here — fetched knowledge can't
        # land, and the progress log re-fetches forever (a CheckStatus storm
        # that wedged wide re-bootstraps).  Ref: Propagate.java:175-196
        # extends toEpoch to executeAt.epoch() once the executeAt is decided.
        to_epoch = txn_id.epoch()
        if ok.execute_at is not None and ok.execute_at.epoch() > to_epoch:
            if not node.topology().has_epoch(ok.execute_at.epoch()):
                # don't silently narrow the window while this node's
                # topology lags — defer until the execution epoch is known
                # (ref: Propagate.java runs under withEpoch(toEpoch))
                node.with_epoch(
                    ok.execute_at.epoch(),
                    lambda: self.process(node, from_id, reply_context))
                return
            to_epoch = ok.execute_at.epoch()

        def apply_fn(safe: SafeCommandStore):
            if status is Status.Invalidated:
                commands.commit_invalidate(safe, txn_id)
                return

            def _purge_eligible() -> bool:
                """The cluster durably truncated/erased this txn AT THE
                UNIVERSAL TIER over a proven covering that includes OUR
                slice (cleanup truncates only behind a shard-redundant
                watermark — an ExclusiveSyncPoint applied at EVERY replica
                — and replies advertise only their proven shard-redundant
                subranges).  Then a copy stuck here is a dual-window or
                pre-bootstrap straggler, not a current serving owner, and
                truncating it locally loses nothing while releasing this
                store's drain + progress log (ref: Propagate.java's purge
                of cluster-erased state).  Majority durability, or a
                covering from another shard alone, must NOT purge: neither
                proves THIS replica's copy is covered."""
                from ..local.status import Durability
                if status is not Status.Truncated \
                        or ok.durability < Durability.UniversalOrInvalidated:
                    return False
                cmd = safe.if_present(txn_id)
                if cmd is None or cmd.is_truncated():
                    return False
                from ..local.redundant import participant_slice
                my_slice = participant_slice(
                    safe.store.ranges_for_epoch.all(), cmd.participants())
                return ok.truncated_covering is not None and \
                    my_slice.without(ok.truncated_covering).is_empty()

            def do_purge() -> None:
                commands.set_durability(safe, txn_id, ok.durability)
                commands.set_truncated_apply(safe, txn_id)

            def _maybe_mark_stale() -> bool:
                """The staleness escape hatch (ref: Propagate.java:395-469):
                peers durably truncated this txn over a PROVEN covering that
                does NOT include our slice, we still expect to execute it
                (live ranges, not pre-bootstrap/redundant/stale), and the
                merged knowledge cannot reach PreApplied here — this
                replica has been left unrecoverably behind for those
                ranges.  Mark them stale (reads refuse, Agent notified,
                re-bootstrap begins) and truncate the local copy so the
                drain and progress log release it."""
                from ..local.status import Durability
                from ..local import cleanup
                if status is not Status.Truncated \
                        or ok.durability < Durability.Majority \
                        or ok.truncated_covering is None:
                    return False
                cmd = safe.if_present(txn_id)
                if cmd is None or cmd.is_truncated() \
                        or cmd.has_been(Status.PreApplied) \
                        or not txn_id.is_write():
                    return False
                from ..local.redundant import participant_slice
                my_slice = participant_slice(
                    safe.store.ranges_for_epoch.all(), cmd.participants())
                # the cluster-truncated portion of OUR slice that we still
                # expect to execute: knowledge for it is gone for good
                gone = my_slice.intersecting(ok.truncated_covering)
                live = safe.store.redundant_before.live_expect_ranges(
                    txn_id, gone)
                if live.is_empty():
                    return False
                if ok.execute_at is not None:
                    cleanup.mark_shard_stale(safe, ok.execute_at, live,
                                             precise=True)
                else:
                    # even the executeAt is erased: the conservative bound
                    cleanup.mark_shard_stale(safe, txn_id, live,
                                             precise=False)
                commands.set_truncated_apply(safe, txn_id)
                return True

            if ok.route is None or ok.partial_txn is None:
                if _purge_eligible():
                    do_purge()
                elif _maybe_mark_stale():
                    pass
                return
            # Sync points extend one epoch below: a dropped donor fetching a
            # bootstrap fence's outcome must be able to apply it over its
            # old ranges.  Data txns do NOT — processing them over lost
            # ranges would create gap-divergent stale copies (the fan-out no
            # longer includes this node for those ranges).
            owned = safe.store.ranges_for_epoch.all_between(
                _propagate_min_epoch(txn_id), to_epoch)
            partial_txn = ok.partial_txn.slice(owned, True)
            # Sync points (and plain reads) legitimately carry NO writes:
            # their apply must still run locally or a replica that lost the
            # Apply fan-out holds the fence at ReadyToExecute forever, and
            # every txn fenced behind it wedges with it (each fetch would
            # re-commit but never apply).  For WRITE txns a missing outcome
            # must NOT apply — marking Applied without the payload loses
            # the write; those keep waiting for a reply that carries it.
            # Either way the merged deps must COVER our owned slice (the
            # awaits-only-deps watermark invariant — an applied fence proves
            # everything below it applied — dies if a fence applies over an
            # under-covering frontier); uncovered falls through to the
            # commit/precommit upgrades below.
            no_outcome_kind = txn_id.is_sync_point() or txn_id.is_read()
            can_apply = (ok.writes is not None
                         or (no_outcome_kind and ok.partial_deps is not None
                             and _deps_cover(ok.partial_deps, ok.route,
                                             owned)))
            if status >= Status.PreApplied and ok.execute_at is not None \
                    and can_apply:
                deps = (ok.partial_deps.slice(owned)
                        if ok.partial_deps is not None else None)
                commands.apply(safe, txn_id, ok.route, ok.execute_at, deps,
                               partial_txn, ok.writes, ok.result)
                return
            # purge sits BETWEEN the apply rung and the commit/precommit
            # upgrades: fetched writes always drain in preference to a
            # purge, but when the cluster durably erased the outcome (no
            # reply can ever carry it) re-committing on every fetch would
            # wedge the copy at Stable forever — the purge must win over
            # the pointless upgrade
            if _purge_eligible():
                do_purge()
                return
            if _maybe_mark_stale():
                return
            if status >= Status.Committed and ok.execute_at is not None \
                    and ok.partial_deps is not None \
                    and _deps_cover(ok.partial_deps, ok.route, owned):
                commands.commit(safe, txn_id, status >= Status.Stable,
                                Ballot.MAX, ok.route, partial_txn,
                                ok.execute_at, ok.partial_deps.slice(owned))
                return
            if status >= Status.PreCommitted and ok.execute_at is not None:
                commands.precommit(safe, txn_id, ok.execute_at)

        node.for_each_local(PreLoadContext.for_txn(txn_id), self.participants,
                            _propagate_min_epoch(txn_id), to_epoch,
                            apply_fn)

    def __repr__(self):
        return f"Propagate({self.txn_id}, {self.ok.save_status.name})"


def _deps_cover(partial_deps, route, owned) -> bool:
    """Committing locally with deps that do not cover this store's owned
    slice of the route could let the txn execute before dependencies it
    should wait for (a single replica's CheckStatus reply need not cover our
    ranges).  Verify coverage; otherwise fall back to precommit and let the
    progress log fetch more."""
    from ..primitives.keys import Ranges
    p = route.participants
    if isinstance(p, Ranges):
        return partial_deps.covers(p.intersecting(owned))
    needed = [t for t in p.tokens() if owned.contains_token(t)]
    return all(partial_deps.covering.contains_token(t) for t in needed)
