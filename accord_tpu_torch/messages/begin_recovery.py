"""BeginRecovery: the recovery vote, reconstructing in-flight decisions.

Rebuild of ref: accord-core/src/main/java/accord/messages/BeginRecovery.java
(:100-157 replica transition, :160-196 reduce, :329-380 the three scans).

A recovery coordinator with ballot b asks every replica of txnId.epoch to
promise b and report everything it knows: its status/acceptance for the txn,
its deps (coordinated if decided, locally-computed otherwise), and three
facts that let the coordinator reconstruct whether the original fast-path
decision can have been reached:

- rejects_fast_path: some txn STARTED AFTER ours was accepted/committed
  without us in its deps (so its PreAccept quorum had not witnessed us — our
  fast path cannot have succeeded), or some stable txn EXECUTES after us
  without witnessing us.
- earlier_committed_witness: stable txns started before us that DO witness us.
- earlier_accepted_no_witness: txns started before us, accepted with a
  proposed executeAt AFTER us, that do NOT witness us — these might commit
  either way; recovery must wait for them before deciding (Recover FSM).
"""

from __future__ import annotations

from typing import Optional

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import Status
from ..primitives.deps import Deps, DepsBuilder, PartialDeps
from ..primitives.keys import Range, Ranges, Route
from ..primitives.latest_deps import DECIDED, LOCAL, PROPOSED, LatestDeps
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import Txn
from .base import MessageType, Reply, TxnRequest
from .preaccept import calculate_partial_deps


class RecoverNack(Reply):
    type = MessageType.BEGIN_RECOVER_RSP

    def __init__(self, superseded_by: Optional[Ballot]):
        self.superseded_by = superseded_by

    def is_ok(self) -> bool:
        return False

    def __repr__(self):
        return f"RecoverNack({self.superseded_by})"


class RecoverOk(Reply):
    """Recovery vote.  Deps are reported as a per-range LatestDeps map
    (ref: LatestDeps.java) so the coordinator's merge is ballot-aware per
    range segment: decided ranges carry the agreed set; accepted ranges the
    proposal under its ballot; the rest the replica's local witness scan."""

    type = MessageType.BEGIN_RECOVER_RSP

    def __init__(self, txn_id: TxnId, status: Status, accepted: Ballot,
                 execute_at: Optional[Timestamp],
                 latest_deps,
                 earlier_committed_witness: Deps,
                 earlier_accepted_no_witness: Deps,
                 rejects_fast_path: bool, writes, result):
        self.txn_id = txn_id
        self.status = status
        self.accepted = accepted
        self.execute_at = execute_at
        self.latest_deps = latest_deps
        self.earlier_committed_witness = earlier_committed_witness
        self.earlier_accepted_no_witness = earlier_accepted_no_witness
        self.rejects_fast_path = rejects_fast_path
        self.writes = writes
        self.result = result

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return (f"RecoverOk({self.txn_id}, {self.status.name}, "
                f"accepted={self.accepted}, rejectsFP={self.rejects_fast_path})")


def _witnesses_us_cmd(cmd, txn_id: TxnId, token: int) -> bool:
    """Fallback witness query against the Command record (range txns and
    pre-missing[] states): does its (partial) dep set include txn_id?"""
    if cmd is None or cmd.partial_deps is None:
        return False
    if txn_id in cmd.partial_deps.key_deps.txn_ids_for(token):
        return True
    return txn_id in cmd.partial_deps.range_deps.intersecting_token(token)


def _recovery_scans(safe: SafeCommandStore, txn_id: TxnId, keys):
    """The three BeginRecovery scans (ref: BeginRecovery.java:329-380) in one
    pass over the store's full per-key history.  Witness membership comes
    from the CFK's missing[] divergence where frozen (self-contained even
    after the Command's deps are evicted/truncated, ref the missing[]
    design comment CommandsForKey.java:73-99), falling back to the Command
    record otherwise."""
    from ..local.commands_for_key import InternalStatus as IS
    witnessed_by = txn_id.kind().witnessed_by()
    rejects_fast_path = False
    ecw = DepsBuilder()   # earlier committed witness
    eanw = DepsBuilder()  # earlier accepted no witness

    def fold(token: int, info, acc):
        nonlocal rejects_fast_path
        other = info.txn_id
        if other == txn_id:
            return acc
        st = info.status
        if st in (IS.INVALIDATED, IS.TRANSITIVELY_KNOWN, IS.PREACCEPTED):
            # no decided/accepted state of its own to vote with
            return acc
        witnesses = info.witnesses_id(txn_id)
        if witnesses is None:
            witnesses = _witnesses_us_cmd(safe.if_present(other), txn_id, token)
        exec_at = info.execute_at
        if other > txn_id:
            # started after us: accepted/committed without witnessing us
            # proves our fast path cannot have been taken
            if st >= IS.ACCEPTED and not witnesses:
                rejects_fast_path = True
        else:
            # stable+ that executes after us without witnessing us also
            # rejects (ref: hasStableExecutesAfterWithoutWitnessing)
            if st >= IS.STABLE and not witnesses and exec_at > txn_id:
                rejects_fast_path = True
            if st >= IS.STABLE and witnesses:
                ecw.add_key(token, other)
            elif st in (IS.ACCEPTED, IS.COMMITTED) and not witnesses \
                    and exec_at > txn_id:
                eanw.add_key(token, other)
        return acc

    safe.map_reduce_full(keys, txn_id, witnessed_by, fold, None)
    return rejects_fast_path, ecw.build(), eanw.build()


class BeginRecovery(TxnRequest):
    """(ref: messages/BeginRecovery.java)."""

    type = MessageType.BEGIN_RECOVER_REQ

    def __init__(self, txn_id: TxnId, txn: Txn, route: Route, ballot: Ballot):
        super().__init__(txn_id, route, txn_id.epoch())
        self.txn = txn
        self.ballot = ballot

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, route, ballot = self.txn_id, self.route, self.ballot
        epoch = txn_id.epoch()

        def map_fn(safe: SafeCommandStore):
            owned = safe.store.ranges_for_epoch.at(epoch)
            partial_txn = self.txn.slice(owned, route.home_key is not None)
            progress_key = node.select_progress_key(txn_id, route)
            outcome, superseded = commands.recover(
                safe, txn_id, partial_txn, route, progress_key, ballot)
            if outcome is commands.AcceptOutcome.RejectedBallot:
                return RecoverNack(superseded)
            if outcome is commands.AcceptOutcome.Truncated:
                return RecoverNack(None)
            if outcome is commands.AcceptOutcome.Rejected:
                # Fenced (rejectBefore): this txn was never witnessed here
                # and never can be — a plain NON-witness vote (execute_at
                # None => no fast-path vote).  The coordinator's electorate
                # math (superseding rejects) decides between invalidation
                # and completing a possibly-fast-committed txn; forcing
                # rejects_fast_path here could invalidate a transaction
                # that fast-committed at a quorum that excludes us.
                return RecoverOk(txn_id, Status.NotDefined, Ballot.ZERO, None,
                                 LatestDeps.none(),
                                 Deps.none(), Deps.none(), False, None, None)

            cmd = safe.get(txn_id)
            deps_decided = (cmd.known().deps.has_decided_deps()
                            or cmd.status in (Status.Committed, Status.Stable,
                                              Status.PreApplied, Status.Applied)) \
                and cmd.partial_deps is not None
            if deps_decided:
                decided = Deps(cmd.partial_deps.key_deps,
                               cmd.partial_deps.range_deps)
                latest = LatestDeps.create(owned, DECIDED, Ballot.ZERO,
                                           decided, None)
            else:
                local = calculate_partial_deps(safe, txn_id, partial_txn.keys,
                                               txn_id, owned)
                local_deps = Deps(local.key_deps, local.range_deps)
                prior = cmd.partial_deps
                # ONLY a live Accept proposal ranks as PROPOSED:
                # AcceptedInvalidate retains the pre-invalidate partial_deps
                # but carries NO deps knowledge (Known.Nothing) — reporting
                # them under the (higher) invalidation ballot would let a
                # stale superseded proposal outrank a genuine Accept that
                # may have committed on a quorum excluding this replica
                if cmd.status is Status.Accepted and prior is not None:
                    # an Accept-phase proposal under cmd.accepted: the
                    # coordinator's per-range merge takes the HIGHEST ballot
                    # proposal, not the union (ref: DepsProposed entries)
                    latest = LatestDeps.create(
                        owned, PROPOSED, cmd.accepted,
                        Deps(prior.key_deps, prior.range_deps), local_deps)
                else:
                    latest = LatestDeps.create(owned, LOCAL, Ballot.ZERO,
                                               None, local_deps)

            if cmd.has_been(Status.PreCommitted):
                rejects, ecw, eanw = False, Deps.none(), Deps.none()
            else:
                rejects, ecw, eanw = _recovery_scans(safe, txn_id,
                                                     partial_txn.keys)
            return RecoverOk(txn_id, cmd.status, cmd.accepted, cmd.execute_at,
                             latest, ecw, eanw, rejects,
                             cmd.writes, cmd.result)

        def reduce_fn(a, b):
            """(ref: BeginRecovery.java:160-196).  Ranking must match the
            coordinator's (Status.max): phase first, then ballot within the
            Accept/Commit phases — so AcceptedInvalidate under a higher
            ballot is not hidden by a stale Accepted@ZERO on another store."""
            from ..local.status import recovery_rank
            if not a.is_ok():
                return a
            if not b.is_ok():
                return b
            hi, lo = (a, b)
            if recovery_rank(b.status, b.accepted) > \
                    recovery_rank(a.status, a.accepted):
                hi, lo = (b, a)
            ecw = hi.earlier_committed_witness.with_(lo.earlier_committed_witness)
            eanw = hi.earlier_accepted_no_witness.with_(
                lo.earlier_accepted_no_witness).without(ecw.contains)
            execute_at = hi.execute_at
            if hi.status is Status.PreAccepted and lo.execute_at is not None \
                    and (execute_at is None or lo.execute_at > execute_at):
                execute_at = lo.execute_at
            return RecoverOk(txn_id, hi.status, hi.accepted, execute_at,
                             hi.latest_deps.merge(lo.latest_deps),
                             ecw, eanw,
                             hi.rejects_fast_path or lo.rejects_fast_path,
                             hi.writes or lo.writes, hi.result or lo.result)

        def consume(result, failure):
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
            elif result is None:
                node.reply(from_id, reply_context, RecoverNack(None))
            else:
                node.reply(from_id, reply_context, result)

        node.map_reduce_consume_local(
            PreLoadContext.for_txn(txn_id), route.participants,
            epoch, epoch, map_fn, reduce_fn, consume)


class WaitOnCommitOk(Reply):
    type = MessageType.WAIT_ON_COMMIT_RSP

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return "WaitOnCommitOk"


class WaitOnCommit(TxnRequest):
    """Notify the sender once this replica has committed (or invalidated /
    truncated) txn_id on every intersecting store
    (ref: accord-core/src/main/java/accord/messages/WaitOnCommit.java).
    Used by recovery to wait out earlier_accepted_no_witness txns."""

    type = MessageType.WAIT_ON_COMMIT_REQ
    is_slow_read = True   # replies when the txn commits locally

    def __init__(self, txn_id: TxnId, participants):
        from ..primitives.keys import Route as _Route
        super().__init__(txn_id, _Route(None, participants, is_full=False),
                         txn_id.epoch())
        self.participants = participants

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id = self.txn_id
        state = {"pending": 0, "scanned": False, "replied": False}

        def _maybe_reply():
            if state["scanned"] and state["pending"] == 0 and not state["replied"]:
                state["replied"] = True
                node.reply(from_id, reply_context, WaitOnCommitOk())

        def _is_done(cmd) -> bool:
            return (cmd.has_been(Status.Committed) or cmd.is_invalidated()
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
            txn_id.epoch(), txn_id.epoch(), map_fn, lambda a, b: None, consume)
