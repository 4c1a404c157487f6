"""Cleanup: watermark-driven truncation and erasure of command state.

Rebuild of ref: accord-core/src/main/java/accord/local/Cleanup.java (the
NO/TRUNCATE/ERASE decision), CommandStore.java:516-532
(markExclusiveSyncPointLocallyApplied / markShardDurable), and the
truncation entry points Commands.java:879-975.

The lifecycle that makes state bounded:

 1. An ExclusiveSyncPoint S applies at EVERY replica of a shard (its kind
    awaits_only_deps, so S applied somewhere proves every TxnId < S applied
    there); CoordinateShardDurable observes this and broadcasts
    SetShardDurable(S) -> mark_shard_durable: advance
    RedundantBefore.redundant_before (the shard watermark), DurableBefore
    majority+universal, prune CommandsForKey below S, free device deps-index
    slots, and truncate/erase eligible commands.
 2. CoordinateGloballyDurable gossips merged DurableBefore maps so replicas
    that missed a SetShardDurable catch up.

After step 1 the deps floor (RedundantBefore.deps_floor) has risen, so
PreAccept dep sets stay O(live txns) and the conflict indexes stay bounded.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING

from ..primitives.keys import Ranges
from ..primitives.timestamp import TxnId
from .status import Durability, SaveStatus, Status

if TYPE_CHECKING:
    from .command_store import SafeCommandStore


class Cleanup(enum.IntEnum):
    """(ref: local/Cleanup.java)."""
    NO = 0
    TRUNCATE = 1   # drop txn/deps/writes, keep the Applied marker
    ERASE = 2      # drop the record entirely


def mark_shard_durable(safe: "SafeCommandStore", sync_id: TxnId,
                       ranges: Ranges) -> None:
    """(ref: CommandStore.markShardDurable :524-532).  ``sync_id`` is an
    ExclusiveSyncPoint applied at EVERY replica of these ranges."""
    store = safe.store
    owned = store.ranges_for_epoch.all().intersecting(ranges)
    if owned.is_empty():
        return
    safe.redundant_before().add_redundant(owned, sync_id)
    # applied at every replica => majority AND universal within the shard
    store.durable_before.add_majority(owned, sync_id)
    store.durable_before.add_universal(owned, sync_id)
    # the deps floor rose: prune per-key conflict indexes below it
    for token, cfk in store.commands_for_key.items():
        if owned.contains_token(token):
            cfk.set_prune_before(sync_id)
    cleanup_store(safe)


def mark_shard_stale(safe: "SafeCommandStore", stale_since, ranges: Ranges,
                     precise: bool) -> None:
    """The staleness escape hatch (ref: CommandStore.markShardStale
    :539-560 + api/Agent.java:65): this replica can no longer procure the
    history it needs for ``ranges`` — peers durably truncated it.  Mark the
    ranges stale (reads refuse, RedundantBefore treats ids below as
    pre-bootstrap-or-stale), tell the Agent, and re-bootstrap: the fence +
    snapshot fetch re-covers the data, and the bootstrap watermark rising
    to the fence clears the staleness (RedundantEntry.merge).

    ``precise``: stale_since is the known executeAt bound of the lost
    history (True) or just the txn's id when even the executeAt is gone
    (False, the conservative bound)."""
    store = safe.store
    owned = store.ranges_for_epoch.all().intersecting(ranges)
    # new staleness only: re-marking already-stale (or already
    # re-bootstrapping — the fence watermark clears the stale flag the
    # instant the bootstrap starts) ranges would re-trigger bootstraps on
    # every fetch of every lost txn
    already = store.redundant_before.stale_ranges(owned) \
        .with_(store.bootstrapping)
    fresh = owned.without(already)
    if fresh.is_empty():
        return
    store.n_stale_marks += 1
    store.redundant_before.add_stale(fresh, stale_since)
    node = store.node
    node.agent.on_stale(stale_since, fresh)
    # the escape: re-bootstrap the stale ranges (ref: Agent.onStale's
    # documented contract — the integrator re-bootstraps; here the store
    # drives it directly, like the journal's restart gap fill)
    from .bootstrap import Bootstrap
    Bootstrap(store, fresh, max(2, node.epoch())).start()


def on_durable_before_advance(safe: "SafeCommandStore") -> None:
    """A gossiped DurableBefore advance (SetGloballyDurable) may newly
    qualify commands for erasure."""
    cleanup_store(safe)


def decide(safe: "SafeCommandStore", cmd) -> Cleanup:
    """The Cleanup decision for one command (ref: local/Cleanup.java).
    Conservative: requires the shard watermark (everything below it applied
    at every replica) plus the matching durability tier."""
    txn_id = cmd.txn_id
    if cmd.save_status is SaveStatus.Uninitialised:
        return Cleanup.NO
    participants = cmd.participants()
    from .redundant import RedundantStatus
    if participants is None or participants.is_empty():
        # placeholder record (dep never witnessed with a definition): erase
        # once the watermarks over everything we own have passed it
        owned = safe.store.ranges_for_epoch.all()
        if not owned.is_empty() \
                and txn_id < safe.store.durable_before.min_universal_before(owned) \
                and safe.redundant_before().status(txn_id, owned) is \
                RedundantStatus.SHARD_REDUNDANT:
            return Cleanup.ERASE
        return Cleanup.NO
    if safe.redundant_before().status(txn_id, participants) is not \
            RedundantStatus.SHARD_REDUNDANT:
        return Cleanup.NO
    # never truncate an undrained local record: a committed-but-unapplied
    # command still owes its writes here (witnessed via a dual-quorum window
    # but applying elsewhere); erasing it is how writes get lost
    if cmd.has_been(Status.Committed) and not cmd.has_been(Status.Applied) \
            and not cmd.is_invalidated():
        return Cleanup.NO
    db = safe.store.durable_before
    from .redundant import _as_ranges
    ranges = _as_ranges(participants)
    if txn_id < db.min_universal_before(ranges):
        return Cleanup.ERASE
    if txn_id < db.min_majority_before(ranges):
        return Cleanup.TRUNCATE
    return Cleanup.NO


def cleanup_store(safe: "SafeCommandStore") -> int:
    """Sweep every command against the watermarks; truncate/erase the
    eligible ones and release their index state.  Returns #commands
    released (ref: the Cleanup hook in SafeCommandStore.get + the journal
    purger; ours sweeps eagerly at watermark advances)."""
    from . import commands as commands_mod
    store = safe.store
    journal = store.node.journal
    if journal is not None:
        # persist the advanced watermarks (latest-wins snapshot — the
        # journal's bounded substitute for replaying every durability verb)
        journal.record_watermarks(store.store_id,
                                  store.durable_before.entries(),
                                  store.redundant_before.redundant_entries())
    if store.paged_limit is not None and journal is not None:
        # paged-out commands must not escape erasure (their journal
        # registers/bodies and device slots would grow forever): page the
        # erasure-eligible ones — below the universal watermark — back in
        # so the sweep below retires them, dropping their registers too.
        # Only when the floor ADVANCED since the last attempt: candidates
        # decide() refuses (e.g. truncated cross-shard routes whose non-
        # owned ranges gap the watermark) must not be reconstructed again
        # on every durability round.
        owned = store.ranges_for_epoch.all()
        if not owned.is_empty():
            floor = store.durable_before.min_universal_before(owned)
            if floor != getattr(store, "_cleanup_paged_floor", None):
                store._cleanup_paged_floor = floor
                for tid in journal.registered_txns(store.store_id):
                    if tid < floor and tid not in store.commands:
                        store.page_in(tid)
    released = 0
    for txn_id in list(store.commands.keys()):
        cmd = store.commands.get(txn_id)
        if cmd is None:
            continue
        decision = decide(safe, cmd)
        if decision is Cleanup.NO:
            continue
        _release_indexes(store, cmd)
        if decision is Cleanup.ERASE:
            # drop the record entirely; RedundantBefore answers for it now
            commands_mod.set_erased(safe, txn_id)
            del store.commands[txn_id]
            store.transient_listeners.pop(txn_id, None)
        else:
            # decide() required SHARD_REDUNDANT — an ExclusiveSyncPoint at
            # or above this id applied at EVERY replica — so record the
            # UNIVERSAL durability tier the truncation proves: a straggler
            # fetching this record must be able to conclude "settled
            # everywhere" (Propagate's purge gate), which mere Majority
            # (set by InformDurable) does not license.  Pure Universal only
            # for genuinely APPLIED commands: has_been(Applied) alone is
            # also true for Invalidated (it ranks above Applied), which
            # never applied writes anywhere.
            applied = cmd.has_been(Status.Applied) \
                and not cmd.is_invalidated() and not cmd.is_truncated()
            commands_mod.set_durability(
                safe, txn_id,
                Durability.Universal if applied
                else Durability.UniversalOrInvalidated)
            commands_mod.set_truncated_apply(safe, txn_id)
        released += 1
    _prune_cfks(store)
    # the watermark rose: frontiers built before the rise may hold bits for
    # deps it now answers for — re-evaluate them (refresh applies the
    # watermark clearance; host mode re-checks via erase notifications)
    if store.device is not None:
        store.device.schedule_tick()
    return released


def _release_indexes(store, cmd) -> None:
    txn_id = cmd.txn_id
    store.drop_range_command(txn_id)
    if store.device is not None:
        store.device.free(txn_id)
    if cmd.partial_txn is not None and not isinstance(cmd.partial_txn.keys,
                                                     Ranges):
        for key in cmd.partial_txn.keys:
            cfk = store.commands_for_key.get(key.token())
            if cfk is not None:
                cfk.remove(txn_id)


def _prune_cfks(store) -> None:
    """Physically drop per-key entries below each CFK's prune watermark —
    everything below it has applied (or been invalidated) at every replica
    of the shard, so no dep set or recovery query needs it again."""
    for cfk in store.commands_for_key.values():
        cfk.prune()


