"""CoordinationAdapter: the strategy seam over the coordination pipeline.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/
CoordinationAdapter.java:49-287 (Adapters.standard / recovery /
inclusiveSyncPoint / exclusiveSyncPoint, incl. the
Faults.TRANSACTION_INSTABILITY skip-stabilise hook at :173) — the
propose -> stabilise -> execute -> persist legs behind one object, so
recovery, sync points and tests can vary a leg without forking the FSMs.
"""

from __future__ import annotations

from typing import Optional

from ..primitives.timestamp import Ballot, Timestamp, TxnId, TxnKind
from ..utils import async_chain


class CoordinationAdapter:
    """The standard pipeline (ref: Adapters.standard)."""

    def propose(self, node, ballot: Ballot, txn_id: TxnId, txn, route,
                execute_at: Timestamp, deps) -> async_chain.AsyncChain:
        from .propose import propose
        return propose(node, ballot, txn_id, txn, route, execute_at, deps)

    def execute(self, node, txn_id: TxnId, txn, route,
                execute_at: Timestamp, deps,
                ballot: Optional[Ballot] = None) -> async_chain.AsyncChain:
        from .execute import execute
        return execute(node, txn_id, txn, route, execute_at, deps, ballot)

    def persist(self, node, txn_id: TxnId, txn, route,
                execute_at: Timestamp, deps, writes, result) -> None:
        from .persist import persist
        persist(node, txn_id, txn, route, execute_at, deps, writes, result)


class RecoveryAdapter(CoordinationAdapter):
    """Recovery runs the same legs under its ballot (ref: Adapters.recovery);
    the ballot threading happens at the call sites in coordinate/recover.py."""


class SyncPointAdapter(CoordinationAdapter):
    """Sync points settle at stable + persist-start and carry no read legs
    (ref: Adapters.(in|ex)clusiveSyncPoint); the read-less behavior lives in
    the execute leg, which skips read rounds for payload-less txns."""


class Adapters:
    standard = CoordinationAdapter()
    recovery = RecoveryAdapter()
    sync_point = SyncPointAdapter()

    @classmethod
    def for_kind(cls, kind: TxnKind) -> CoordinationAdapter:
        if kind.is_sync_point():
            return cls.sync_point
        return cls.standard
