"""CollectDeps / FetchMaxConflict: quorum probes without consensus rounds.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/
CollectDeps.java (a quorum of GetDeps — recovery fills ranges its Accept
quorum never voted on, ref Recover.java:353; historical-deps registration
uses it too, ref CommandStore.java:472) and FetchMaxConflict.java (a quorum
of GetMaxConflict — bootstrap's safe-to-read bound, ref Bootstrap.java:234).
"""

from __future__ import annotations

from ..messages.get_deps import (GetDeps, GetDepsOk, GetMaxConflict,
                                 GetMaxConflictOk)
from ..primitives.timestamp import Timestamp, TxnId
from ..utils import async_chain
from .tracking import QuorumTracker


def collect_deps(node, txn_id: TxnId, route, keys,
                 execute_at: Timestamp) -> async_chain.AsyncChain:
    """Quorum-merge the deps every shard would have witnessed for ``txn_id``
    executing at ``execute_at`` (ref: CollectDeps.withDeps)."""
    from .recover import _QuorumRpc
    result = async_chain.AsyncResult()
    topologies = node.topology().with_unsynced_epochs(
        route.participants, txn_id.epoch(), execute_at.epoch())

    def merge(acc, reply: GetDepsOk):
        return reply if acc is None else GetDepsOk(
            acc.deps.with_partial(reply.deps))

    def on_done(merged, failure):
        if failure is not None:
            result.set_failure(failure)
        else:
            result.set_success(merged.deps if merged is not None else None)

    _QuorumRpc(node, QuorumTracker(topologies),
               GetDeps(txn_id, route, keys, execute_at), merge, on_done)
    return result


def fetch_max_conflict(node, participants) -> async_chain.AsyncChain:
    """Quorum-merge the max conflict timestamp for ``participants``,
    re-running at a later epoch if any replica is ahead
    (ref: FetchMaxConflict.executeAtEpoch retry)."""
    result = async_chain.AsyncResult()

    def attempt(execution_epoch: int, retries: int) -> None:
        from .recover import _QuorumRpc
        topologies = node.topology().with_unsynced_epochs(
            participants, execution_epoch, execution_epoch)

        def merge(acc, reply: GetMaxConflictOk):
            return reply if acc is None else GetMaxConflictOk(
                max(acc.max_conflict, reply.max_conflict),
                max(acc.latest_epoch, reply.latest_epoch))

        def on_done(merged, failure):
            if failure is not None:
                result.set_failure(failure)
                return
            if merged is None:
                result.set_success(Timestamp.NONE)
                return
            if merged.latest_epoch > execution_epoch:
                if retries < 2:
                    node.with_epoch(
                        merged.latest_epoch,
                        lambda: attempt(merged.latest_epoch, retries + 1))
                    return
                # topology still moving: a bound that never consulted the
                # newest owners is NOT safe to serve reads from — fail and
                # let the caller retry rather than return a stale maximum
                from .errors import Exhausted
                result.set_failure(Exhausted(None))
                return
            result.set_success(merged.max_conflict)

        _QuorumRpc(node, QuorumTracker(topologies),
                   GetMaxConflict(participants, execution_epoch),
                   merge, on_done)

    attempt(node.epoch(), 0)
    return result
