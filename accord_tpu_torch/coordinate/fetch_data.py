"""FetchData: pull a txn's known state from peers and apply it locally.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/FetchData.java:42
+ messages/Propagate.java:63 — the fetch is a CheckStatus(All) quorum probe;
the "propagate" half applies whatever knowledge came back to the local
stores, upgrading them to the most advanced remote state (commit, or apply
with the outcome).  Used by the progress log to unblock local txns waiting
on dependencies whose Commit/Apply messages this node missed.
"""

from __future__ import annotations

from typing import Optional

from ..messages.check_status import CheckStatusOk, IncludeInfo
from ..primitives.timestamp import TxnId
from ..utils import async_chain


def fetch_data(node, txn_id: TxnId, participants, epoch: int
               ) -> async_chain.AsyncChain:
    """CheckStatus(All) a quorum, then propagate the merged knowledge into
    the local stores.  Settles with the merged CheckStatusOk (or None if the
    txn is unknown cluster-wide)."""
    from .recover import _check_status_quorum
    result = async_chain.AsyncResult()

    def on_done(merged: Optional[CheckStatusOk], failure):
        if failure is not None:
            result.set_failure(failure)
            return
        if merged is not None:
            propagate(node, txn_id, participants, merged)
        result.set_success(merged)

    _check_status_quorum(node, txn_id, participants, epoch,
                         IncludeInfo.All, on_done)
    return result


def propagate(node, txn_id: TxnId, participants, ok: CheckStatusOk) -> None:
    """Apply remotely-learned knowledge to the local stores, as the
    side-effecting LOCAL message the reference models it as
    (ref: messages/Propagate.java; PROPAGATE_* in MessageType.java) — it
    flows through Node._process so the journal persists it and restart
    reconstruction covers knowledge learned via fetches."""
    from ..messages.propagate import Propagate
    node._process(Propagate(txn_id, participants, ok), node.node_id, None)

