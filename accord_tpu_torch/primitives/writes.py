"""Applied write-sets and sync-point handles
(ref: accord-core/src/main/java/accord/primitives/Writes.java,
SyncPoint.java, ProgressToken.java)."""

from __future__ import annotations

from typing import Optional

from ..utils import async_chain
from .keys import Ranges, Route, Seekables
from .timestamp import Ballot, Timestamp, TxnId


class Writes:
    """The writes of a transaction at its executeAt (ref: Writes.java)."""

    __slots__ = ("txn_id", "execute_at", "keys", "write")

    def __init__(self, txn_id: TxnId, execute_at: Timestamp,
                 keys: Seekables, write):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.keys = keys
        self.write = write  # api.Write or None (read-only txn)

    def is_empty(self) -> bool:
        return self.write is None

    def apply_to(self, store, ranges: Ranges) -> "async_chain.AsyncChain":
        """Apply to the local DataStore, restricted to owned ranges."""
        if self.write is None:
            return async_chain.success(None)
        chains = []
        for key in self.keys:
            owned = (ranges.contains_key(key) if hasattr(key, "token")
                     else ranges.intersects(Ranges.of(key)))
            if owned:
                chains.append(self.write.apply(key, self.txn_id, self.execute_at, store))
        if not chains:
            return async_chain.success(None)
        return async_chain.all_of(chains).map(lambda _: None)

    def __repr__(self):
        return f"Writes({self.txn_id}@{self.execute_at})"


class SyncPoint:
    """Handle for a coordinated (exclusive) sync point over some ranges
    (ref: SyncPoint.java): txnId + agreed deps + route + decided
    executeAt."""

    __slots__ = ("sync_id", "deps", "route", "execute_at")

    def __init__(self, sync_id: TxnId, deps, route: Route, execute_at=None):
        self.sync_id = sync_id
        self.deps = deps
        self.route = route
        self.execute_at = execute_at

    def __repr__(self):
        return f"SyncPoint({self.sync_id})"


class ProgressToken:
    """Monotonic summary of how far a transaction has progressed, used by
    recovery to dedupe/abandon work (ref: ProgressToken.java)."""

    __slots__ = ("durability", "status_phase", "promised", "accepted")

    def __init__(self, durability: int, status_phase: int,
                 promised: Ballot, accepted: Ballot):
        self.durability = durability
        self.status_phase = status_phase
        self.promised = promised
        self.accepted = accepted

    @classmethod
    def none(cls) -> "ProgressToken":
        return _NONE

    def merge(self, other: "ProgressToken") -> "ProgressToken":
        return ProgressToken(
            max(self.durability, other.durability),
            max(self.status_phase, other.status_phase),
            max(self.promised, other.promised),
            max(self.accepted, other.accepted))

    def __eq__(self, o):
        return (isinstance(o, ProgressToken)
                and self.durability == o.durability
                and self.status_phase == o.status_phase
                and self.promised == o.promised
                and self.accepted == o.accepted)

    def __ge__(self, o: "ProgressToken"):
        return (self.durability >= o.durability and self.status_phase >= o.status_phase
                and self.promised >= o.promised and self.accepted >= o.accepted)

    def __gt__(self, o: "ProgressToken"):
        """Strictly more progress on at least one axis, no regression."""
        return self >= o and not self == o


_NONE = ProgressToken(0, 0, Ballot.ZERO, Ballot.ZERO)
