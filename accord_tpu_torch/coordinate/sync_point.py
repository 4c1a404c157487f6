"""Sync points: barrier pseudo-transactions over key ranges.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/
CoordinateSyncPoint.java:58, Barrier.java:58.  A sync point is a
range-domain transaction with no read/write payload; its dependency set
captures every earlier intersecting transaction, so its LOCAL apply at any
replica is proof that all of them have applied there.  The coordinator
settles at the stable quorum + persist-start (no read legs — sync points
have no read payload); callers needing "applied at a specific replica" must
gate on that replica's local apply of the sync point, as the bootstrap
snapshot fetch does (messages/fetch_snapshot.await_applied).
ExclusiveSyncPoint additionally fences: later PreAccepts witness it and
order after it.

Used by epoch reconfiguration (each node syncs its new-epoch ranges before
acking the epoch), bootstrap (fence before snapshot fetch), and durability
scheduling.
"""

from __future__ import annotations

from ..primitives.keys import Ranges
from ..primitives.timestamp import Domain, TxnKind
from ..primitives.txn import Txn
from ..primitives.writes import SyncPoint
from ..utils import async_chain


def coordinate_sync_point(node, ranges: Ranges,
                          exclusive: bool = True,
                          txn_id=None) -> async_chain.AsyncChain:
    """Coordinate an (Exclusive)SyncPoint over ``ranges`` through the normal
    consensus pipeline.  Settles with a SyncPoint handle once the barrier is
    stable at a quorum and its Apply distribution has begun: every earlier
    intersecting txn is decided, and each replica applies the barrier only
    after those txns have applied there."""
    kind = TxnKind.ExclusiveSyncPoint if exclusive else TxnKind.SyncPoint
    txn = Txn(kind, ranges, read=None)
    result = async_chain.AsyncResult()
    if txn_id is None:
        txn_id = node.next_txn_id(kind, Domain.Range)

    def on_done(value, failure):
        if failure is not None:
            result.set_failure(failure)
        elif isinstance(value, SyncPoint):
            result.set_success(value)
        else:
            # recovery completed the coordination on our behalf: the handle
            # carries no deps/executeAt (callers fall back to the plain
            # wait-until-applied leg)
            result.set_success(SyncPoint(txn_id, None, None))

    node.coordinate(txn, txn_id=txn_id).begin(on_done)
    return result
