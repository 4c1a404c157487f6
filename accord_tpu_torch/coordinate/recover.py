"""Recovery: reconstruct and complete (or invalidate) an in-flight txn.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/Recover.java:76-405
and MaybeRecover.java.  The decision procedure on a recovery quorum
(Recover.java:239-345):

1. Any reply with an Accept-phase-or-later decision -> adopt the most
   advanced one (ranked per Status.max: phase, then ballot, then status):
   Invalidated -> broadcast CommitInvalidate; Applied/PreApplied -> re-persist
   the known outcome; Stable/Committed/PreCommitted -> re-execute at the known
   executeAt; Accepted -> re-propose (executeAt, deps) under our ballot;
   AcceptedInvalidate -> complete the invalidation.
2. Otherwise (PreAccepted everywhere): decide whether the original fast-path
   commit can have happened.  If the recovery quorum proves it cannot
   (electorate rejects, or a later txn accepted/committed without witnessing
   us) -> invalidate.  If earlier txns were accepted to execute after us
   without witnessing us, their commit could go either way -> WaitOnCommit
   for them, then retry with a fresh ballot.  Otherwise the fast path may
   have committed -> re-propose executeAt = txnId with the merged deps.

The recovery result settles with (outcome_str, result) where outcome_str is
one of "applied"/"executed"/"invalidated"/"truncated".
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .. import api
from ..messages.begin_recovery import (BeginRecovery, RecoverNack, RecoverOk,
                                       WaitOnCommit)
from ..messages.check_status import (CheckStatus, CheckStatusOk, IncludeInfo)
from ..messages.commit import CommitInvalidate
from ..primitives.deps import Deps
from ..primitives.keys import Route
from ..primitives.timestamp import Ballot, TxnId
from ..primitives.txn import Txn
from ..primitives.writes import ProgressToken
from ..local.status import Status, recovery_rank
from ..obs import spans_of
from ..utils import async_chain
from .errors import Preempted, Timeout, Truncated
from .adapter import Adapters
from .tracking import QuorumTracker, RecoveryTracker, RequestStatus


class _QuorumRpc(api.Callback):
    """Send one request to every node of a quorum tracker, merge successful
    replies, and report once: on_done(merged_or_None, failure_or_None).
    A reply for which ``terminal(reply)`` returns True short-circuits the
    quorum and is passed to on_done immediately as (reply, None)."""

    def __init__(self, node, tracker: QuorumTracker, request,
                 merge: Callable, on_done: Callable,
                 terminal: Optional[Callable] = None):
        self.node = node
        self.tracker = tracker
        self.merge = merge
        self.on_done = on_done
        self.terminal = terminal
        self.merged = None
        self.done = False
        for to in sorted(tracker.nodes()):
            node.send(to, request, self)

    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if self.terminal is not None and self.terminal(reply):
            self.done = True
            self.on_done(reply, None)
            return
        self.merged = self.merge(self.merged, reply)
        if self.tracker.record_success(from_id) is RequestStatus.Success:
            self.done = True
            self.on_done(self.merged, None)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) is RequestStatus.Failed:
            self.done = True
            self.on_done(None, failure if failure is not None else Timeout())


def _check_status_quorum(node, txn_id: TxnId, select, epoch: int,
                         include: IncludeInfo, on_done: Callable) -> None:
    """CheckStatus a quorum; on_done(merged CheckStatusOk | None, failure)."""
    topologies = node.topology().for_epoch(select, epoch)

    def merge(acc, reply):
        if isinstance(reply, CheckStatusOk):
            return reply if acc is None else acc.merge(reply)
        return acc

    _QuorumRpc(node, QuorumTracker(topologies),
               CheckStatus(txn_id, select, epoch, include), merge, on_done)


def _commit_invalidate_broadcast(node, txn_id: TxnId, route: Route,
                                 nodes) -> None:
    request = CommitInvalidate(txn_id, route)
    for to in sorted(nodes):
        node.send(to, request)
    node.agent.events_listener().on_invalidated(txn_id)


def _propose_invalidate(node, txn_id: TxnId, route: Route, ballot: Ballot,
                        topologies, on_invalidated: Callable,
                        on_redundant: Callable,
                        on_failed: Callable) -> None:
    """AcceptInvalidate round then CommitInvalidate broadcast
    (ref: coordinate/Invalidate.java proposeAndCommitInvalidate)."""
    from ..messages.accept import AcceptInvalidate
    tracker = QuorumTracker(topologies)

    def terminal(reply):
        return not reply.is_ok()

    def on_done(reply_or_merged, failure):
        if failure is not None:
            on_failed(failure)
            return
        reply = reply_or_merged
        if reply is not None and hasattr(reply, "is_ok") and not reply.is_ok():
            if reply.redundant:
                # someone committed/invalidated meanwhile: caller re-recovers
                on_redundant()
            else:
                on_failed(Preempted(txn_id))
            return
        _commit_invalidate_broadcast(node, txn_id, route, tracker.nodes())
        on_invalidated()

    _QuorumRpc(node, tracker, AcceptInvalidate(txn_id, route, ballot),
               lambda acc, r: r, on_done, terminal=terminal)


class Recover(api.Callback):
    """(ref: coordinate/Recover.java)."""

    @staticmethod
    def recover(node, txn_id: TxnId, route: Route,
                txn: Optional[Txn] = None) -> async_chain.AsyncChain:
        result = async_chain.AsyncResult()
        if txn is not None:
            Recover(node, txn_id, txn, route, result)._start()
        else:
            _fetch_definition_then_recover(node, txn_id, route, result)
        return result

    def __init__(self, node, txn_id: TxnId, txn: Txn, route: Route,
                 result: async_chain.AsyncResult):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.result = result
        self.ballot = Ballot(*_next_ballot_bits(node))
        self.topologies = node.topology().for_epoch(route.participants,
                                                    txn_id.epoch())
        self.tracker = RecoveryTracker(self.topologies)
        self.oks: List[RecoverOk] = []
        self.done = False

    def _start(self) -> None:
        _count_recovery(self.node, "attempt")
        sp = spans_of(self.node)
        if sp is not None:
            # one recovery HOP on the txn's span tree (recovery may run on
            # a different node than the original coordinator — the sim
            # shares one recorder, so the hop lands on the same tree);
            # repeated hops record the grind a progress-log storm shows as
            sp.event(str(self.txn_id), "recover",
                     node=self.node.node_id, ballot=str(self.ballot))
        request = BeginRecovery(self.txn_id, self.txn, self.route, self.ballot)
        for to in sorted(self.tracker.nodes()):
            self.node.send(to, request, self)

    # -- Callback -----------------------------------------------------------
    def on_success(self, from_id: int, reply) -> None:
        if self.done:
            return
        if isinstance(reply, RecoverNack):
            self.done = True
            if reply.superseded_by is None:
                _count_recovery(self.node, "truncated")
                self.result.set_failure(Truncated(self.txn_id))
            else:
                _count_recovery(self.node, "preempted")
                self.result.set_failure(Preempted(self.txn_id))
            return
        ok: RecoverOk = reply
        self.oks.append(ok)
        accepts_fast_path = ok.execute_at == self.txn_id
        if self.tracker.record_success(from_id, not accepts_fast_path) \
                is RequestStatus.Success:
            self._recover()

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self.done:
            return
        if self.tracker.record_failure(from_id) is RequestStatus.Failed:
            self.done = True
            _count_recovery(self.node, "timeout")
            self.result.set_failure(Timeout(self.txn_id))

    # -- decision (ref: Recover.java:239-345) -------------------------------
    def _recover(self) -> None:
        self.done = True
        node, txn_id = self.node, self.txn_id

        max_ok = _max_accepted_or_later(self.oks)
        if max_ok is not None:
            status = max_ok.status
            if status is Status.Truncated:
                self.result.set_failure(Truncated(txn_id))
                return
            if status is Status.Invalidated:
                _commit_invalidate_broadcast(node, txn_id, self.route,
                                             self.tracker.nodes())
                _count_recovery(node, "invalidated")
                self.result.set_success(("invalidated", None))
                return
            if status in (Status.Applied, Status.PreApplied):
                node.with_epoch(max_ok.execute_at.epoch(), lambda: (
                    _merge_committed_deps(
                        node, txn_id, self.txn, self.route, self.oks,
                        max_ok.execute_at,
                        lambda deps, fail:
                        self.result.set_failure(fail) if fail is not None
                        else _repersist(node, txn_id, self.txn, self.route,
                                        max_ok, deps, self.result))))
                return
            if status in (Status.Stable, Status.Committed, Status.PreCommitted):
                node.with_epoch(max_ok.execute_at.epoch(), lambda: (
                    _merge_committed_deps(
                        node, txn_id, self.txn, self.route, self.oks,
                        max_ok.execute_at,
                        lambda deps, fail:
                        self.result.set_failure(fail) if fail is not None
                        else Adapters.recovery.execute(
                            node, txn_id, self.txn, self.route,
                            max_ok.execute_at, deps, ballot=self.ballot)
                        .begin(self._executed))))
                return
            if status is Status.Accepted:
                deps = _merge_proposal_deps(self.oks)
                Adapters.recovery.propose(node, self.ballot, txn_id, self.txn, self.route,
                        max_ok.execute_at, deps).begin(self._proposed)
                return
            if status is Status.AcceptedInvalidate:
                self._invalidate()
                return
            raise AssertionError(f"unexpected recovery status {status}")

        # all PreAccepted (or unwitnessed): fast-path reconstruction
        if self.tracker.superseding_rejects() or \
                any(ok.rejects_fast_path for ok in self.oks):
            self._invalidate()
            return

        ecw = Deps.merge([ok.earlier_committed_witness for ok in self.oks])
        eanw = Deps.merge([ok.earlier_accepted_no_witness for ok in self.oks]) \
            .without(ecw.contains)
        if not eanw.is_empty():
            # earlier txns proposed to execute after us without witnessing us:
            # their commits decide our fate — wait, then retry with a fresh
            # ballot (ref: Recover.java awaitCommits + retry)
            _await_commits(self.node, eanw, lambda failure: (
                self.result.set_failure(failure) if failure is not None
                else Recover(self.node, self.txn_id, self.txn, self.route,
                             self.result)._start()))
            return

        deps = _merge_proposal_deps(self.oks)
        Adapters.recovery.propose(node, self.ballot, txn_id, self.txn, self.route, txn_id,
                deps).begin(self._proposed)

    # -- continuations -------------------------------------------------------
    def _proposed(self, value, failure) -> None:
        if failure is not None:
            from .errors import Rejected as _Rejected
            if isinstance(failure, _Rejected):
                # fence-rejected at the Accept round: the txn can never
                # decide — invalidate it instead of retrying forever
                self._invalidate()
                return
            self.result.set_failure(failure)
            return
        execute_at, deps = value
        self.node.with_epoch(execute_at.epoch(), lambda: (
            Adapters.recovery.execute(self.node, self.txn_id, self.txn, self.route, execute_at,
                    deps, ballot=self.ballot).begin(self._executed)))

    def _executed(self, value, failure) -> None:
        if failure is not None:
            self.result.set_failure(failure)
        else:
            _count_recovery(self.node, "executed")
            self.result.set_success(("executed", value))

    def _invalidate(self) -> None:
        _propose_invalidate(
            self.node, self.txn_id, self.route, self.ballot, self.topologies,
            on_invalidated=lambda: (
                _count_recovery(self.node, "invalidated"),
                self.result.set_success(("invalidated", None))),
            on_redundant=lambda: Recover(self.node, self.txn_id, self.txn,
                                         self.route, self.result)._start(),
            on_failed=self.result.set_failure)


def _count_recovery(node, event: str) -> None:
    """Recovery lifecycle counters (r14): attempts and terminal outcomes,
    labeled per node, on the shared obs registry — the burn's
    recovery-under-chaos nemesis and the bench ``recovery_rate`` row read
    them back via ``counter_totals("recoveries", by="event")``.  Pure
    counting: no randomness, no protocol effect (one getattr when a node
    carries no registry)."""
    o = getattr(node, "obs", None)
    if o is not None:
        o.metrics.counter("recoveries", node=node.node_id,
                          event=event).inc()


def _next_ballot_bits(node):
    ts = node.unique_now()
    return ts.msb, ts.lsb, ts.node


def _max_accepted_or_later(oks: List[RecoverOk]) -> Optional[RecoverOk]:
    """Most advanced reply with at least an Accept-phase decision —
    including AcceptedInvalidate (ref: Recover.java maxAcceptedOrLater,
    ranked per Status.max)."""
    best = None
    for ok in oks:
        if ok.status.phase < Status.AcceptedInvalidate.phase:
            continue
        if best is None or recovery_rank(ok.status, ok.accepted) > \
                recovery_rank(best.status, best.accepted):
            best = ok
    return best


def _merge_committed_deps(node, txn_id: TxnId, txn, route,
                          oks: List[RecoverOk], execute_at,
                          cont) -> None:
    """LatestDeps.mergeCommit (ref: LatestDeps.java:40 + Recover.java:339-360):
    the ballot-aware per-range merge, then CollectDeps for any range the
    quorum's knowledge is NOT sufficient for (possible when executeAt moved
    past txnId and no reply holds decided deps for a shard) — local scans
    are only commit-equivalent when executeAt == txnId."""
    from ..primitives.latest_deps import LatestDeps
    merged = LatestDeps.merge_all([ok.latest_deps for ok in oks])
    deps, sufficient = merged.merge_commit(accept_local=(execute_at == txn_id))
    required = _required_ranges(route)
    missing = required.without(sufficient)
    if missing.is_empty():
        cont(deps, None)
        return
    from .collect_deps import collect_deps
    keys = txn.keys.slice(missing)

    def on_collected(extra, failure):
        if failure is not None:
            cont(None, failure)
            return
        extra_deps = (Deps(extra.key_deps, extra.range_deps)
                      if extra is not None else Deps.none())
        cont(deps.with_(extra_deps), None)

    # slice the route to the missing ranges: only their shards owe a
    # quorum (an unrelated shard without one must not fail the recovery,
    # and its replicas need not be asked at all — ref CollectDeps scopes
    # to the uncovered ranges)
    collect_deps(node, txn_id, route.slice(missing), keys,
                 execute_at).begin(on_collected)


def _required_ranges(route: Route):
    """The token coverage recovery's deps must span: the route participants
    as canonical ranges."""
    from ..primitives.keys import Ranges
    p = route.participants
    return p if isinstance(p, Ranges) else p.to_ranges()


def _merge_proposal_deps(oks: List[RecoverOk]) -> Deps:
    """LatestDeps.mergeProposal (ref: LatestDeps.java:40): per range the
    highest-ballot proposal wins outright; local witness scans fill only
    unproposed ranges.  (The round-3 union-superset approximation could
    over-constrain execution order after recovery under contention.)"""
    from ..primitives.latest_deps import LatestDeps
    return LatestDeps.merge_all(
        [ok.latest_deps for ok in oks]).merge_proposal()


def _repersist(node, txn_id, txn, route, max_ok: RecoverOk, deps: Deps,
               result: async_chain.AsyncResult) -> None:
    from .persist import persist
    persist(node, txn_id, txn, route, max_ok.execute_at, deps,
            max_ok.writes, max_ok.result)
    _count_recovery(node, "applied")
    result.set_success(("applied", max_ok.result))


def _await_commits(node, deps: Deps, done) -> None:
    """Wait for every txn in deps to commit at a quorum of its replicas
    (ref: Recover.java awaitCommits)."""
    txn_ids = deps.txn_ids()
    remaining = {"n": len(txn_ids), "failed": False}
    if remaining["n"] == 0:
        done(None)
        return

    def one_done(failure):
        if remaining["failed"]:
            return
        if failure is not None:
            remaining["failed"] = True
            done(failure)
            return
        remaining["n"] -= 1
        if remaining["n"] == 0:
            done(None)

    for tid in txn_ids:
        participants = deps.participants(tid)
        topologies = node.topology().for_epoch(participants, tid.epoch())

        def on_done(_merged, failure, tid=tid):
            one_done(Timeout(tid) if failure is not None else None)

        _QuorumRpc(node, QuorumTracker(topologies),
                   WaitOnCommit(tid, participants),
                   lambda acc, r: acc, on_done)


def _fetch_definition_then_recover(node, txn_id: TxnId, route: Route,
                                   result: async_chain.AsyncResult) -> None:
    """Recovery without the txn definition: CheckStatus(All) a quorum first
    (ref: RecoverWithRoute / FetchData)."""

    def on_done(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.set_failure(failure)
            return
        if merged is not None and merged.partial_txn is not None:
            txn = merged.partial_txn  # PartialTxn is a Txn; re-sliced per replica
            use_route = merged.route if merged.route is not None else route
            Recover(node, txn_id, txn, use_route, result)._start()
            return
        if merged is not None and merged.save_status.status is Status.Invalidated:
            result.set_success(("invalidated", None))
            return
        # nobody knows the definition: it cannot have been committed anywhere
        # (commit requires the definition at a quorum) — invalidate it so it
        # can never complete (ref: coordinate/Infer.java invalidate)
        ballot = Ballot(*_next_ballot_bits(node))
        topologies = node.topology().for_epoch(route.participants,
                                               txn_id.epoch())
        _propose_invalidate(
            node, txn_id, route, ballot, topologies,
            on_invalidated=lambda: (
                _count_recovery(node, "invalidated"),
                result.set_success(("invalidated", None))),
            on_redundant=lambda: _fetch_definition_then_recover(
                node, txn_id, route, result),
            on_failed=result.set_failure)

    _check_status_quorum(node, txn_id, route.participants, txn_id.epoch(),
                         IncludeInfo.All, on_done)


# ---------------------------------------------------------------------------
# MaybeRecover (ref: coordinate/MaybeRecover.java)
# ---------------------------------------------------------------------------

def maybe_recover(node, txn_id: TxnId, route: Route,
                  prev: ProgressToken,
                  txn: Optional[Txn] = None) -> async_chain.AsyncChain:
    """Cheap CheckStatus probe; escalate to Recover only if nothing has
    progressed past ``prev``.  Settles with ("progressed", token) or the
    Recover outcome."""
    result = async_chain.AsyncResult()

    def on_done(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.set_failure(failure)
            return
        if merged is None:
            token = ProgressToken.none()
        else:
            token = ProgressToken(int(merged.durability),
                                  int(merged.save_status.status.phase),
                                  merged.promised, merged.accepted)
        if merged is not None and token > prev:
            result.set_success(("progressed", token))
            return
        # no observable progress — including complete-but-never-durable txns,
        # whose recovery re-persists and re-sends InformDurable so the home
        # progress log can finally retire the entry
        Recover.recover(node, txn_id, route, txn).begin(result.settle)

    _check_status_quorum(node, txn_id, route.participants, txn_id.epoch(),
                         IncludeInfo.Route, on_done)
    return result
