"""All protocol state transitions, as pure-ish functions over SafeCommandStore.

Rebuild of ref: accord-core/src/main/java/accord/local/Commands.java:98-1192 —
preaccept/accept/commit/precommit/apply/commitInvalidate (:131-527), the
execution drain maybeExecute (:656-733), initialiseWaitingOn/updateWaitingOn
(:735-830), updateDependencyAndMaybeExecute (:832) and listener fan-out.

The listener-DFS NotifyWaitingOn walker (:1011-1192) is replaced by (a) the
same-store deferred listener queue (SafeCommandStore.complete) and (b) the
batched device drain (accord_tpu.ops.drain) for the high-throughput path.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

from ..primitives.deps import PartialDeps
from ..primitives.keys import Ranges, Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId, TxnKind
from ..primitives.txn import PartialTxn
from ..primitives.writes import Writes
from ..utils import invariants
from .command import Command, WaitingOn
from .command_store import PreLoadContext, SafeCommandStore
from .commands_for_key import InternalStatus
from .redundant import RedundantStatus
from .status import Durability, SaveStatus, Status, save_status_for


class AcceptOutcome(enum.IntEnum):
    """(ref: Commands.AcceptOutcome)."""
    Success = 0
    Redundant = 1
    RejectedBallot = 2
    Insufficient = 3
    Truncated = 4
    Rejected = 5      # fenced by an ExclusiveSyncPoint (rejectBefore)


class CommitOutcome(enum.IntEnum):
    Success = 0
    Redundant = 1
    Insufficient = 2
    Rejected = 3


class ApplyOutcome(enum.IntEnum):
    Success = 0
    Redundant = 1
    Insufficient = 2


# ---------------------------------------------------------------------------
# PreAccept (ref: Commands.java:131-196)
# ---------------------------------------------------------------------------

def preaccept(safe: SafeCommandStore, txn_id: TxnId, partial_txn: PartialTxn,
              route: Route, progress_key: Optional[int],
              permit_fast_path: bool = True, ballot: Ballot = Ballot.ZERO
              ) -> Tuple[AcceptOutcome, Optional[Timestamp]]:
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreAccepted):
        return AcceptOutcome.Redundant, cmd.execute_at
    if cmd.promised > ballot:
        return AcceptOutcome.RejectedBallot, None
    if safe.redundant_before().status(txn_id, partial_txn.keys) in (
            RedundantStatus.SHARD_REDUNDANT,):
        return AcceptOutcome.Truncated, None
    if not txn_id.kind().is_sync_point():
        # An ExclusiveSyncPoint fence rejects NEW witnessing of lower TxnIds
        # at any ballot: they could otherwise (slow-path or via recovery
        # resurrection) decide past the fence and straddle a bootstrap
        # snapshot boundary (ref: Commands.preaccept rejectBefore check).
        # The original coordinator retries with a fresh TxnId; a recovery
        # coordinator receives this as a non-witness vote and the electorate
        # math (superseding rejects) decides the txn's fate.
        #
        # DELIBERATE DELTA: the reference applies the fold to sync points
        # too (the ESP early-return in CommandStore.java:326-336 sits after
        # the reject check) — but there a rejected PreAccept still witnesses
        # the txn, returning a rejected timestamp the coordinator then
        # invalidates.  Ours refuses to witness outright and the caller
        # re-picks a fresh id.  Applying THAT semantic to ESPs breaks the
        # fence-id-is-bootstrap-watermark invariant: concurrent bootstraps
        # race, the loser's pre-marked bootstrapped_at keeps pruning deps
        # with a boundary dep that never coordinates, and coverage holes
        # lose writes across snapshot handoffs (observed: burn seeds 3/7).
        # An old ESP witnessed behind a newer fence is harmless here — it
        # carries no payload and its fence marking max-merges to a no-op.
        floor = safe.store.reject_before_floor(partial_txn.keys)
        if floor is not None and txn_id < floor:
            # return the fence bound: the coordinator bumps its HLC past it
            # before retrying, or a drift-behind node re-issues doomed ids
            # until its clock catches up on its own
            return AcceptOutcome.Rejected, floor

    witnessed_at = _compute_witnessed_at(safe, txn_id, partial_txn, permit_fast_path)
    safe.update_max_conflicts(partial_txn.keys, witnessed_at)

    new_cmd = cmd.updated(
        save_status=SaveStatus.PreAccepted,
        route=route if cmd.route is None else cmd.route.with_(route),
        progress_key=progress_key,
        partial_txn=partial_txn if cmd.partial_txn is None
        else cmd.partial_txn.with_partial(partial_txn),
        execute_at=witnessed_at)
    safe.update(new_cmd)
    _register_txn(safe, txn_id, partial_txn, InternalStatus.PREACCEPTED)
    if txn_id.kind() is TxnKind.ExclusiveSyncPoint and \
            isinstance(partial_txn.keys, Ranges):
        safe.store.mark_reject_before(partial_txn.keys, txn_id)
    safe.progress_log().pre_accepted(safe, txn_id)
    return AcceptOutcome.Success, witnessed_at


def _compute_witnessed_at(safe: SafeCommandStore, txn_id: TxnId,
                          partial_txn: PartialTxn,
                          permit_fast_path: bool) -> Timestamp:
    """Propose the witnessed timestamp: the txn's own id if it still beats
    every conflict (fast path), else a fresh unique timestamp above the
    conflict floor (ref: CommandStore.preaccept logic)."""
    if txn_id.kind().is_sync_point():
        # sync points execute at their own id (ref: Txn.Kind.SyncPoint docs)
        return txn_id
    max_conflict = safe.max_conflict(partial_txn.keys)
    node = safe.node()
    if permit_fast_path and txn_id > max_conflict and txn_id.epoch() >= node.epoch():
        return txn_id
    return node.unique_now_at_least(max_conflict).with_epoch_at_least(txn_id.epoch())


def _per_key_deps(partial_deps: Optional[PartialDeps],
                  token: int) -> Optional[List[TxnId]]:
    """The command's dep ids on one key — what freezes into the CFK's
    missing[] divergence when the deps are fixed."""
    if partial_deps is None:
        return None
    ids = list(partial_deps.key_deps.txn_ids_for(token))
    ids.extend(partial_deps.range_deps.intersecting_token(token))
    return ids


def _register_txn(safe: SafeCommandStore, txn_id: TxnId,
                  partial_txn: PartialTxn, status: InternalStatus,
                  execute_at: Optional[Timestamp] = None,
                  partial_deps: Optional[PartialDeps] = None) -> None:
    if not txn_id.kind().is_globally_visible():
        return
    keys = partial_txn.keys if partial_txn is not None else None
    if keys is None:
        return
    if isinstance(keys, Ranges):
        existing = safe.store.range_commands.get(txn_id)
        safe.store.put_range_command(txn_id, keys if existing is None
                                     else existing.with_(keys))
    else:
        for key in keys:
            safe.cfk(key.token()).update(
                txn_id, status, execute_at,
                witnessed_deps=_per_key_deps(partial_deps, key.token()))
    if safe.store.device is not None:
        safe.store.device.register(txn_id, int(status), keys)
        if execute_at is not None and status.has_execute_at():
            safe.store.device.update_status(txn_id, int(status), execute_at)


def _update_cfk_status(safe: SafeCommandStore, cmd: Command,
                       status: InternalStatus,
                       execute_at: Optional[Timestamp] = None,
                       partial_deps: Optional[PartialDeps] = None) -> None:
    if not cmd.txn_id.kind().is_globally_visible():
        return
    if safe.store.device is not None:
        safe.store.device.update_status(cmd.txn_id, int(status), execute_at)
    if cmd.partial_txn is None:
        return
    keys = cmd.partial_txn.keys
    if isinstance(keys, Ranges):
        return  # range txns tracked via range_commands + command status
    for key in keys:
        safe.cfk(key.token()).update(
            cmd.txn_id, status, execute_at,
            witnessed_deps=_per_key_deps(partial_deps, key.token()))


def recover(safe: SafeCommandStore, txn_id: TxnId, partial_txn: PartialTxn,
            route: Route, progress_key: Optional[int],
            ballot: Ballot) -> Tuple[AcceptOutcome, Optional[Ballot]]:
    """BeginRecovery's local transition: promise the recovery ballot and
    witness the txn if unseen (ref: Commands.java recover + preacceptOrRecover).
    Never grants a fast-path vote — the witnessed timestamp for an unseen txn
    is computed with the fast path disabled."""
    cmd = safe.get(txn_id)
    if cmd.is_truncated():
        return AcceptOutcome.Truncated, None
    if cmd.promised > ballot:
        return AcceptOutcome.RejectedBallot, cmd.promised
    if not cmd.has_been(Status.PreAccepted):
        outcome, _ = preaccept(safe, txn_id, partial_txn, route, progress_key,
                               permit_fast_path=False, ballot=ballot)
        if outcome not in (AcceptOutcome.Success, AcceptOutcome.Redundant):
            return outcome, None
        cmd = safe.get(txn_id)
    safe.update(cmd.updated(promised=ballot), notify=False)
    return AcceptOutcome.Success, None


# ---------------------------------------------------------------------------
# Accept (ref: Commands.java:198-280)
# ---------------------------------------------------------------------------

def accept(safe: SafeCommandStore, txn_id: TxnId, ballot: Ballot, route: Route,
           keys, progress_key: Optional[int], execute_at: Timestamp,
           partial_deps: PartialDeps) -> Tuple[AcceptOutcome, Optional[Ballot]]:
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreCommitted):
        return AcceptOutcome.Redundant, None
    if cmd.promised > ballot:
        return AcceptOutcome.RejectedBallot, cmd.promised
    if not txn_id.kind().is_sync_point() and ballot == Ballot.ZERO \
            and not cmd.has_been(Status.PreAccepted):
        # Fence check also at Accept: an original-coordinator slow-path
        # Accept can arrive after the fence (see preaccept).  Guards:
        # already-witnessed commands pass (the fence witnessed them — their
        # executeAt-vs-fence ordering is handled by the executeAt-gated
        # apply), and recovery ballots pass (a recovered txn that reached
        # the Accept phase at a quorum must survive; invalidating it could
        # lose a committed write).
        floor = safe.store.reject_before_floor(keys)
        if floor is not None and txn_id < floor:
            return AcceptOutcome.Rejected, floor

    new_status = (SaveStatus.AcceptedWithDefinition if cmd.is_defined()
                  else SaveStatus.Accepted)
    new_cmd = cmd.updated(
        save_status=new_status,
        route=route if cmd.route is None else cmd.route.with_(route),
        progress_key=progress_key if cmd.progress_key is None else cmd.progress_key,
        promised=ballot, accepted=ballot,
        execute_at=execute_at,
        partial_deps=partial_deps)
    safe.update(new_cmd)
    safe.update_max_conflicts(keys, execute_at)
    _update_cfk_status(safe, new_cmd, InternalStatus.ACCEPTED, execute_at,
                       partial_deps=partial_deps)
    safe.progress_log().accepted(safe, txn_id)
    return AcceptOutcome.Success, None


def accept_invalidate(safe: SafeCommandStore, txn_id: TxnId,
                      ballot: Ballot) -> Tuple[AcceptOutcome, Optional[Ballot]]:
    """(ref: Commands.acceptInvalidate)."""
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreCommitted):
        return AcceptOutcome.Redundant, None
    if cmd.promised > ballot:
        return AcceptOutcome.RejectedBallot, cmd.promised
    new_status = (SaveStatus.AcceptedInvalidateWithDefinition if cmd.is_defined()
                  else SaveStatus.AcceptedInvalidate)
    safe.update(cmd.updated(save_status=new_status, promised=ballot,
                            accepted=ballot))
    return AcceptOutcome.Success, None


# ---------------------------------------------------------------------------
# Commit / Stable (ref: Commands.java:306-462)
# ---------------------------------------------------------------------------

def commit(safe: SafeCommandStore, txn_id: TxnId, target_stable: bool,
           ballot: Ballot, route: Route, partial_txn: Optional[PartialTxn],
           execute_at: Timestamp, partial_deps: Optional[PartialDeps],
           progress_key: Optional[int] = None) -> CommitOutcome:
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreCommitted):
        known_at = cmd.execute_at_if_known()
        if known_at is not None and known_at != execute_at:
            safe.agent().on_inconsistent_timestamp(cmd, known_at, execute_at)
    if target_stable:
        if cmd.is_stable() or cmd.is_invalidated() or cmd.is_truncated():
            return CommitOutcome.Redundant
    else:
        if cmd.has_been(Status.Committed):
            return CommitOutcome.Redundant
    if cmd.promised > ballot:
        return CommitOutcome.Rejected

    merged_txn = cmd.partial_txn
    if partial_txn is not None:
        merged_txn = (partial_txn if merged_txn is None
                      else merged_txn.with_partial(partial_txn))
    if merged_txn is None:
        return CommitOutcome.Insufficient
    if partial_deps is None and cmd.partial_deps is None:
        return CommitOutcome.Insufficient
    deps = partial_deps if partial_deps is not None else cmd.partial_deps

    new_cmd = cmd.updated(
        save_status=SaveStatus.Committed,
        route=route if cmd.route is None else cmd.route.with_(route),
        progress_key=progress_key if cmd.progress_key is None else cmd.progress_key,
        partial_txn=merged_txn,
        execute_at=execute_at,
        partial_deps=deps)
    new_cmd = safe.update(new_cmd)
    safe.update_max_conflicts(merged_txn.keys, execute_at)
    _register_txn(safe, txn_id, merged_txn, InternalStatus.COMMITTED,
                  execute_at, partial_deps=deps)
    safe.progress_log().precommitted(safe, txn_id)

    if target_stable:
        return stable(safe, txn_id)
    return CommitOutcome.Success


def stable(safe: SafeCommandStore, txn_id: TxnId) -> CommitOutcome:
    """Commit -> Stable: freeze deps, build the WaitingOn frontier, try to
    execute (ref: Commands.commit stable path + initialiseWaitingOn)."""
    cmd = safe.get(txn_id)
    if cmd.is_stable() or cmd.is_invalidated() or cmd.is_truncated():
        return CommitOutcome.Redundant
    invariants.check_state(cmd.has_been(Status.Committed),
                           "stable before committed: %s", cmd)
    waiting_on = initialise_waiting_on(safe, txn_id, cmd.execute_at,
                                       cmd.partial_deps)
    new_cmd = cmd.updated(save_status=SaveStatus.Stable, waiting_on=waiting_on)
    safe.update(new_cmd)
    _update_cfk_status(safe, new_cmd, InternalStatus.STABLE, new_cmd.execute_at)
    safe.progress_log().stable(safe, txn_id)
    if not maybe_execute(safe, txn_id) and safe.store.device is not None:
        # device drain mode: the remaining waiting set becomes an adjacency
        # row; ready_frontier ticks drive it instead of per-dep listeners
        safe.store.device.arm(safe, txn_id)
    return CommitOutcome.Success


def precommit(safe: SafeCommandStore, txn_id: TxnId,
              execute_at: Timestamp) -> CommitOutcome:
    """(ref: Commands.precommit)."""
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreCommitted):
        known_at = cmd.execute_at_if_known()
        if known_at is not None and known_at != execute_at:
            safe.agent().on_inconsistent_timestamp(cmd, known_at, execute_at)
        return CommitOutcome.Redundant
    new_cmd = safe.update(cmd.updated(
        save_status=save_status_for(Status.PreCommitted, cmd.known()),
        execute_at=execute_at))
    # surface the decided executeAt in the per-key index (as an accepted-
    # grade entry: deps not yet frozen) so recovery's accepted-no-witness
    # scan sees it even before the full Commit arrives
    _update_cfk_status(safe, new_cmd, InternalStatus.ACCEPTED, execute_at)
    safe.progress_log().precommitted(safe, txn_id)
    return CommitOutcome.Success


def commit_invalidate(safe: SafeCommandStore, txn_id: TxnId) -> None:
    """(ref: Commands.commitInvalidate)."""
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreCommitted) and cmd.known().execute_at.is_decided_and_known_to_execute():
        invariants.illegal_state("invalidating a pre-committed txn %s", txn_id)
    if cmd.is_invalidated():
        return
    new_cmd = cmd.updated(save_status=SaveStatus.Invalidated,
                          durability=Durability.UniversalOrInvalidated)
    safe.update(new_cmd)
    safe.notify_listeners(new_cmd)
    _update_cfk_status(safe, new_cmd, InternalStatus.INVALIDATED)
    safe.store.drop_range_command(txn_id)
    safe.progress_log().clear(txn_id)


# ---------------------------------------------------------------------------
# Apply (ref: Commands.java:464-527)
# ---------------------------------------------------------------------------

def apply(safe: SafeCommandStore, txn_id: TxnId, route: Route,
          execute_at: Timestamp, partial_deps: Optional[PartialDeps],
          partial_txn: Optional[PartialTxn], writes: Optional[Writes],
          result) -> ApplyOutcome:
    cmd = safe.get(txn_id)
    if cmd.has_been(Status.PreApplied):
        return ApplyOutcome.Redundant
    if not cmd.has_been(Status.Committed):
        outcome = commit(safe, txn_id, False, Ballot.MAX, route, partial_txn,
                         execute_at, partial_deps)
        if outcome is CommitOutcome.Insufficient:
            return ApplyOutcome.Insufficient
        cmd = safe.get(txn_id)
    known_at = cmd.execute_at_if_known()
    if known_at is not None and known_at != execute_at:
        safe.agent().on_inconsistent_timestamp(cmd, known_at, execute_at)

    waiting_on = cmd.waiting_on
    if waiting_on is None:
        waiting_on = initialise_waiting_on(safe, txn_id, execute_at,
                                           cmd.partial_deps)
    new_cmd = cmd.updated(save_status=SaveStatus.PreApplied,
                          waiting_on=waiting_on, writes=writes, result=result)
    safe.update(new_cmd)
    safe.progress_log().executed(safe, txn_id)
    if not maybe_execute(safe, txn_id) and safe.store.device is not None:
        safe.store.device.arm(safe, txn_id)
    return ApplyOutcome.Success


# ---------------------------------------------------------------------------
# WaitingOn construction + the execution drain
# (ref: Commands.java:656-857)
# ---------------------------------------------------------------------------

def initialise_waiting_on(safe: SafeCommandStore, txn_id: TxnId,
                          execute_at: Timestamp,
                          partial_deps: Optional[PartialDeps]) -> WaitingOn:
    """Build the execution frontier from the stable deps: one bit per dep we
    own locally; bits already satisfiable are cleared inline
    (ref: Commands.initialiseWaitingOn :735-830)."""
    if partial_deps is None:
        return WaitingOn.none()
    owned = safe.ranges(execute_at.epoch()).with_(safe.ranges(txn_id.epoch()))
    # The deps' covering records the window this store processed the commit
    # over — for a dual-quorum ESP (bootstrap/durability fence) that window
    # reaches BELOW txn_id.epoch to the store's prior-epoch ranges.  A donor
    # that lost the range in the new epoch must still wait on its old-range
    # deps before the fence applies locally (the snapshot-coverage gate), so
    # the waiting set is built over the union (ref: Commands.initialiseWaitingOn
    # uses safeStore.ranges().allBetween(minEpoch, executeAt.epoch())).
    covering = getattr(partial_deps, "covering", None)
    if covering is not None:
        owned = owned.with_(covering)
    dep_ids: List[TxnId] = []
    seen = set()
    for token in partial_deps.key_deps.keys:
        if owned.contains_token(token):
            for d in partial_deps.key_deps.txn_ids_for(token):
                if d not in seen and d != txn_id:
                    seen.add(d)
                    dep_ids.append(d)
    for rng in partial_deps.range_deps.ranges:
        if owned.intersects(Ranges.of(rng)):
            for d in partial_deps.range_deps.intersecting_range(rng):
                if d not in seen and d != txn_id:
                    seen.add(d)
                    dep_ids.append(d)
    dep_ids.sort()

    waiting_on = WaitingOn.all_of(dep_ids)
    for d in dep_ids:
        waiting_on = _maybe_clear_dep(safe, txn_id, execute_at, waiting_on, d,
                                      partial_deps)
    return waiting_on


def _maybe_clear_dep(safe: SafeCommandStore, txn_id: TxnId,
                     execute_at: Timestamp, waiting_on: WaitingOn,
                     dep: TxnId, partial_deps: PartialDeps) -> WaitingOn:
    dep_cmd = safe.if_present(dep)
    # the dep set itself records where the dep participates — essential for
    # deps we never witnessed locally (pre-bootstrap: the snapshot covers
    # them, so they must clear instantly, not trigger a fetch).  Clearance
    # is PER watermark entry (locally_settled): shard-redundant sub-ranges
    # clear unconditionally; pre-bootstrap sub-ranges clear unless the dep
    # has a KNOWN executeAt past that entry's fence (then it will apply
    # here directly and per-key order vs the snapshot must hold — the
    # cross-fence window is closed by reject_before; any residue fails
    # loudly in the versioned data store rather than losing a write).
    participants = _resolve_dep_participants(safe, dep, partial_deps)
    dep_exec = (dep_cmd.execute_at_if_known() if dep_cmd is not None else None)
    if safe.redundant_before().locally_settled(dep, participants, dep_exec):
        return waiting_on.with_done(dep, True)
    device = safe.store.device is not None
    if dep_cmd is None:
        # not yet witnessed locally: register a placeholder that will notify
        # us, and tell the progress log to fetch the blocker's state.  In
        # device mode the drain graph (not a listener) tracks the edge.
        placeholder = Command(dep)
        if not device:
            placeholder = placeholder.with_listener(txn_id)
        safe.update(placeholder, notify=False)
        _report_blocker(safe, dep, partial_deps)
        return waiting_on
    if dep_cmd.is_invalidated() or dep_cmd.is_truncated() or dep_cmd.save_status is SaveStatus.Applied:
        return waiting_on.with_done(dep, True)
    dep_execute_at = dep_cmd.execute_at_if_known()
    if dep_execute_at is not None and _never_applies_here(safe, dep_cmd,
                                                          dep_execute_at):
        # will never apply on this store (exec-epoch ownership moved):
        # see _dep_clearance
        return waiting_on.with_done(dep, True)
    if not txn_id.kind().awaits_only_deps():
        if dep_execute_at is not None and dep_execute_at > execute_at:
            # executes after us: not our dependency (ref: updateWaitingOn;
            # skipped for awaits-only-deps kinds, ref: Commands.java:804)
            return waiting_on.with_done(dep, False)
    if not device:
        safe.update(dep_cmd.with_listener(txn_id), notify=False)
    # Report the blocker whether it is undecided (we may have missed its
    # Commit) or decided-but-unapplied (we may have missed its Apply): both
    # can only be unblocked by fetching remote state if the originator is
    # gone (ref: NotifyWaitingOn walks to the deepest unapplied dep and
    # registers it with ProgressLog.waiting until HasOutcome).  Entries for
    # deps that apply promptly are retired before their first fetch.
    _report_blocker(safe, dep, partial_deps)
    return waiting_on


def _resolve_dep_participants(safe: SafeCommandStore, dep: TxnId,
                              partial_deps: PartialDeps):
    """Where does ``dep`` participate: from the dep set itself, else from
    its locally-known route."""
    participants = partial_deps.participants(dep)
    if participants.is_empty():
        participants = _dep_participants(safe, dep)
    return participants


def _report_blocker(safe: SafeCommandStore, dep: TxnId,
                    partial_deps: PartialDeps) -> None:
    safe.progress_log().waiting(
        dep, 0, None, _resolve_dep_participants(safe, dep, partial_deps))


def _dep_participants(safe: SafeCommandStore, dep: TxnId):
    cmd = safe.if_present(dep)
    if cmd is not None and cmd.route is not None:
        return cmd.route.participants
    return Ranges.empty()


def maybe_execute(safe: SafeCommandStore, txn_id: TxnId,
                  always_notify: bool = False) -> bool:
    """The executeAt-gated drain step for one txn
    (ref: Commands.maybeExecute :656-733)."""
    cmd = safe.get(txn_id)
    if cmd.save_status not in (SaveStatus.Stable, SaveStatus.PreApplied):
        if always_notify:
            safe.notify_listeners(cmd)
        return False
    if cmd.is_waiting():
        if always_notify:
            safe.notify_listeners(cmd)
        return False

    if safe.store.device is not None:
        safe.store.device.on_driven(txn_id)

    if cmd.save_status is SaveStatus.Stable:
        new_cmd = cmd.updated(save_status=SaveStatus.ReadyToExecute)
        safe.update(new_cmd)
        safe.notify_listeners(new_cmd)
        safe.notify_transient(new_cmd)
        safe.progress_log().ready_to_execute(safe, txn_id)
        return True

    # PreApplied: perform the writes then mark Applied.  Transient listeners
    # (pending reads) are notified synchronously BEFORE the writes apply so
    # they observe the pre-apply store state (the read gate contract in
    # messages/read_data.read_on_store).
    new_cmd = cmd.updated(save_status=SaveStatus.Applying)
    safe.update(new_cmd, notify=False)
    safe.notify_transient(new_cmd)
    _apply_writes(safe, new_cmd)
    return True


def _apply_writes(safe: SafeCommandStore, cmd: Command) -> None:
    store = safe.store
    # The write window is the ranges this store legitimately processed the
    # txn over — the covering of its sliced definition (which the message
    # layer computed from the coordinator's multi-epoch window, so dropped
    # prior-epoch donors still apply over their old ranges).
    if cmd.partial_txn is not None:
        owned = cmd.partial_txn.covering
    else:
        owned = safe.ranges(cmd.execute_at.epoch())
    # a write landing mid-bootstrap is deferred until the snapshot installs
    # (defer order == drain order); thereafter applying DIRECTLY is always
    # safe — the versioned data store inserts at the executeAt-sorted
    # position and dedups by TxnId, so snapshot and direct apply form a
    # monotone union whichever subset each delivered (the old
    # "snapshot-covered" skip assumed snapshot completeness and lost writes
    # whenever a donor legitimately served before a new-epoch-executing
    # txn applied at it)
    if not store.bootstrapping.is_empty() and cmd.writes is not None \
            and not cmd.writes.is_empty() \
            and cmd.writes.keys.intersects(store.bootstrapping):
        txn_id = cmd.txn_id
        store.defer_until_bootstrap(
            lambda: store.execute(PreLoadContext.for_txn(txn_id),
                                  lambda s: _apply_writes(s, s.get(txn_id))))
        return

    def on_done(_result, failure):
        if failure is not None:
            store.node.agent.on_uncaught_exception(failure)
            return
        store.execute(PreLoadContext.for_txn(cmd.txn_id),
                      lambda s: post_apply(s, cmd.txn_id))

    if cmd.writes is not None and not cmd.writes.is_empty():
        cmd.writes.apply_to(store.node.data_store, owned).begin(on_done)
    else:
        on_done(None, None)


def post_apply(safe: SafeCommandStore, txn_id: TxnId) -> None:
    """(ref: Commands.postApply :565-648)."""
    cmd = safe.get(txn_id)
    if cmd.save_status is not SaveStatus.Applying:
        return
    new_cmd = cmd.updated(save_status=SaveStatus.Applied)
    safe.update(new_cmd)
    _update_cfk_status(safe, new_cmd, InternalStatus.APPLIED, new_cmd.execute_at)
    if new_cmd.partial_txn is not None and new_cmd.execute_at is not None \
            and not isinstance(new_cmd.partial_txn.keys, Ranges):
        for key in new_cmd.partial_txn.keys:
            safe.store.timestamps_for_key.get(key.token()).on_executed(
                safe, txn_id, new_cmd.execute_at)
    safe.notify_listeners(new_cmd)
    safe.notify_transient(new_cmd)
    safe.progress_log().durable_local(safe, txn_id)


# ---------------------------------------------------------------------------
# Listener fan-out (ref: Commands.java listenerUpdate + :776-857)
# ---------------------------------------------------------------------------

def listener_update(safe: SafeCommandStore, listener_id: TxnId,
                    updated_id: TxnId) -> None:
    listener = safe.if_present(listener_id)
    if listener is None or listener.waiting_on is None:
        return
    if listener.save_status not in (SaveStatus.Stable, SaveStatus.PreApplied):
        return
    dep = safe.if_present(updated_id)
    if dep is None:
        # the dep's record was erased (Cleanup dropped it after the shard
        # watermark passed it): the watermark answers for it now — without
        # this leg the erase notification is a lost wakeup and the waiter
        # wedges forever (ref: Commands.removeRedundantDependencies)
        if not listener.waiting_on.is_waiting_on(updated_id):
            return
        cleared = _settle_absent_or_redundant_dep(safe, listener, updated_id,
                                                  None)
        if cleared is None:
            return
        safe.update(listener.updated(
            waiting_on=listener.waiting_on.with_done(updated_id, cleared)),
            notify=False)
        maybe_execute(safe, listener_id)
        return
    update_dependency_and_maybe_execute(safe, listener, dep)


def _settle_absent_or_redundant_dep(safe: SafeCommandStore, waiter: Command,
                                    dep_id: TxnId,
                                    dep_cmd: Optional[Command]
                                    ) -> Optional[bool]:
    """Clearance that needs no dep record: the redundancy/bootstrap
    watermarks answer for erased or never-witnessed dependencies (the same
    rules _maybe_clear_dep applies at WaitingOn construction, re-applied
    when the watermark advances under an already-built frontier).
    Returns True (clear as applied/invalidated) or None (still gating)."""
    participants = _resolve_dep_participants(safe, dep_id, waiter.partial_deps)
    dep_exec = (dep_cmd.execute_at_if_known() if dep_cmd is not None else None)
    if safe.redundant_before().locally_settled(dep_id, participants, dep_exec):
        return True
    return None


def _dep_clearance(safe: SafeCommandStore, dep: Command,
                   listener_txn_id: TxnId,
                   listener_execute_at) -> Optional[bool]:
    """The one clearing rule both drain mechanisms share
    (ref: Commands.updateWaitingOn): None = still gating; True = dep is
    applied/invalidated/truncated (or will never apply on this store);
    False = dep executes after us.  Waiters whose kind awaits_only_deps
    (ExclusiveSyncPoint/EphemeralRead) never drop executes-after deps
    (ref: Commands.java:804) — their local apply must prove every lower
    TxnId applied."""
    if dep.save_status is SaveStatus.Applied or dep.is_invalidated() \
            or dep.is_truncated():
        return True
    dep_execute_at = dep.execute_at_if_known()
    if dep_execute_at is not None and _never_applies_here(safe, dep,
                                                         dep_execute_at):
        # The dep executes in an epoch where this store owns none of its
        # participation: its Apply fan-out will never arrive here, so
        # waiting would deadlock the epoch handoff (e.g. a donor's fence
        # awaiting a new-epoch txn).  The joiner receives it directly and
        # the versioned data store's txn-id-keyed union keeps reads exact.
        return True
    if listener_txn_id.kind().awaits_only_deps():
        return None
    if (dep_execute_at is not None and listener_execute_at is not None
            and dep_execute_at > listener_execute_at):
        return False
    return None


def apply_window_epochs(txn_id: TxnId,
                        execute_at: Optional[Timestamp]) -> Tuple[int, int]:
    """The epoch window a txn's Commit/Apply distribution can reach on a
    store: [txn epoch .. executeAt epoch], extended ONE EPOCH BELOW for sync
    points — the dual-quorum handoff leg, where a dropped prior-epoch owner
    still receives and applies the fence over its old ranges (shared by the
    drain clearance, journal reconstruction, and fetch_data's propagate —
    keep in sync or reconstruction slices silently diverge from clearance)."""
    min_epoch = txn_id.epoch()
    if txn_id.kind().is_sync_point():
        min_epoch = max(1, min_epoch - 1)
    max_epoch = max(txn_id.epoch(),
                    execute_at.epoch() if execute_at is not None else 0)
    return min_epoch, max_epoch


def _never_applies_here(safe: SafeCommandStore, dep: Command,
                        dep_execute_at: Timestamp) -> bool:
    participants = dep.participants()
    if participants is None:
        return False   # unknown participation: stay conservative
    # Without the sync-point epoch extension a donor clears its waiting on a
    # joiner's bootstrap fence as "never applies here", applies its own
    # fence early, and serves a snapshot missing writes the fence was
    # supposed to gate on (lost write on the joiner).
    min_epoch, max_epoch = apply_window_epochs(dep.txn_id, dep_execute_at)
    window = safe.store.ranges_for_epoch.all_between(min_epoch, max_epoch)
    if isinstance(participants, Ranges):
        return not window.intersects(participants)
    return not participants.intersects(window)


def update_dependency_and_maybe_execute(safe: SafeCommandStore,
                                        listener: Command,
                                        dep: Command) -> None:
    """(ref: Commands.updateDependencyAndMaybeExecute :832)."""
    if not listener.waiting_on.is_waiting_on(dep.txn_id):
        return
    new_waiting = listener.waiting_on
    remove_listener = False
    cleared = _dep_clearance(safe, dep, listener.txn_id, listener.execute_at)
    if cleared is not None:
        new_waiting = new_waiting.with_done(dep.txn_id, cleared)
        remove_listener = True
    if new_waiting is listener.waiting_on:
        return
    updated = listener.updated(waiting_on=new_waiting)
    safe.update(updated, notify=False)
    if remove_listener:
        safe.update(dep.without_listener(listener.txn_id), notify=False)
    maybe_execute(safe, listener.txn_id)


def refresh_waiting_and_maybe_execute(safe: SafeCommandStore,
                                      txn_id: TxnId) -> bool:
    """Device-drain execution step: the kernel's ready_frontier proposed this
    txn as executable; re-validate every remaining WaitingOn bit against the
    authoritative host command records (same clearing rules as
    update_dependency_and_maybe_execute), then try to execute.  A mirror
    divergence degrades to a no-op — the bits stay set and the txn is
    re-proposed on a later tick."""
    cmd = safe.if_present(txn_id)
    if cmd is None or cmd.waiting_on is None:
        return False
    if cmd.save_status not in (SaveStatus.Stable, SaveStatus.PreApplied):
        return False
    w = cmd.waiting_on
    for dep in w.waiting_ids():
        dep_cmd = safe.if_present(dep)
        cleared = None
        if dep_cmd is not None:
            cleared = _dep_clearance(safe, dep_cmd, txn_id, cmd.execute_at)
        if cleared is None:
            # erased record or stale placeholder: the watermarks decide
            cleared = _settle_absent_or_redundant_dep(safe, cmd, dep, dep_cmd)
        if cleared is not None:
            w = w.with_done(dep, cleared)
    if w is not cmd.waiting_on:
        safe.update(cmd.updated(waiting_on=w), notify=False)
    return maybe_execute(safe, txn_id)


# ---------------------------------------------------------------------------
# Durability + truncation entry points (ref: Commands.java:879-975)
# ---------------------------------------------------------------------------

def set_durability(safe: SafeCommandStore, txn_id: TxnId,
                   durability: Durability) -> None:
    cmd = safe.get(txn_id)
    if durability <= cmd.durability:
        return
    safe.update(cmd.updated(durability=cmd.durability.merge(durability)),
                notify=False)
    if durability.is_durable():
        safe.progress_log().durable(safe, txn_id)


def set_truncated_apply(safe: SafeCommandStore, txn_id: TxnId) -> None:
    """Truncate a majority-durable applied command: drop txn/deps/waiting but
    KEEP the outcome (writes/result) — a recovery adopting this txn's result
    for a wedged client coordinator still needs it (ref: SaveStatus
    TruncatedApplyWithOutcome; outcome drops only at ERASE)."""
    cmd = safe.get(txn_id)
    if cmd.is_truncated():
        return
    new_cmd = cmd.updated(save_status=SaveStatus.TruncatedApply,
                          partial_txn=None, partial_deps=None,
                          waiting_on=None)
    safe.update(new_cmd)
    safe.notify_listeners(new_cmd)
    if safe.store.device is not None:
        safe.store.device.on_terminal(txn_id)


def set_erased(safe: SafeCommandStore, txn_id: TxnId) -> None:
    cmd = safe.get(txn_id)
    new_cmd = cmd.updated(save_status=SaveStatus.Erased,
                          partial_txn=None, partial_deps=None,
                          waiting_on=None, writes=None, result=None,
                          route=None)
    safe.update(new_cmd)
    safe.notify_listeners(new_cmd)
    if safe.store.device is not None:
        safe.store.device.on_terminal(txn_id)
