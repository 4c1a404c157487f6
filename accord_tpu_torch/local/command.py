"""The per-transaction record and its execution frontier.

Rebuild of ref: accord-core/src/main/java/accord/local/Command.java:1741.
Instead of the reference's immutable class ladder
(NotDefined->PreAccepted->Accepted->Committed->Executed->Truncated) this is a
single immutable record whose populated fields are governed by SaveStatus —
the idiomatic form for a system whose data plane is a struct-of-arrays: each
field maps 1:1 onto a device array column in the TPU store.

WaitingOn (ref: Command.java:1295-1332) is the per-txn execution frontier:
the sorted dep TxnId vector plus two bitsets (waiting, appliedOrInvalidated)
whose word-views feed the drain kernel (accord_tpu.ops.drain).
"""

from __future__ import annotations

import bisect
from typing import FrozenSet, List, Optional, Tuple

from ..primitives.deps import PartialDeps
from ..primitives.keys import Range, Ranges, Route
from ..primitives.timestamp import Ballot, Timestamp, TxnId
from ..primitives.txn import PartialTxn
from ..primitives.writes import Writes
from ..utils import invariants
from ..utils.bitset import ImmutableBitSet, SimpleBitSet
from .fastpath import proto_fastpath_enabled
from .status import Durability, Known, SaveStatus, Status

_FASTPATH = proto_fastpath_enabled()


class WaitingOn:
    """(ref: Command.java:1295-1332)."""

    __slots__ = ("txn_ids", "waiting", "applied_or_invalidated")

    def __init__(self, txn_ids: List[TxnId], waiting: ImmutableBitSet,
                 applied_or_invalidated: ImmutableBitSet):
        self.txn_ids = txn_ids  # sorted unique
        self.waiting = waiting
        self.applied_or_invalidated = applied_or_invalidated

    @classmethod
    def none(cls) -> "WaitingOn":
        return cls([], ImmutableBitSet(0), ImmutableBitSet(0))

    @classmethod
    def all_of(cls, txn_ids: List[TxnId]) -> "WaitingOn":
        n = len(txn_ids)
        return cls(txn_ids, SimpleBitSet.full(n).freeze(), ImmutableBitSet(n))

    def is_waiting(self) -> bool:
        return not self.waiting.is_empty()

    def is_waiting_on(self, txn_id: TxnId) -> bool:
        i = self._index_of(txn_id)
        return i >= 0 and self.waiting.get(i)

    def _index_of(self, txn_id: TxnId) -> int:
        i = bisect.bisect_left(self.txn_ids, txn_id)
        if i < len(self.txn_ids) and self.txn_ids[i] == txn_id:
            return i
        return -1

    def waiting_ids(self) -> List[TxnId]:
        return [self.txn_ids[i] for i in self.waiting]

    def next_waiting(self) -> Optional[TxnId]:
        i = self.waiting.last_set()
        return self.txn_ids[i] if i >= 0 else None

    def with_done(self, txn_id: TxnId, applied_or_invalidated: bool) -> "WaitingOn":
        """Clear the bit for a completed dependency; optionally record it as
        applied/invalidated (vs merely executes-after)."""
        i = self._index_of(txn_id)
        if i < 0 or not self.waiting.get(i):
            return self
        w = self.waiting.with_unset(i)
        a = (self.applied_or_invalidated.with_set(i)
             if applied_or_invalidated else self.applied_or_invalidated)
        return WaitingOn(self.txn_ids, w, a)

    def __eq__(self, o):
        return (isinstance(o, WaitingOn) and self.txn_ids == o.txn_ids
                and self.waiting == o.waiting
                and self.applied_or_invalidated == o.applied_or_invalidated)

    def __repr__(self):
        return f"WaitingOn({self.waiting_ids()})"


class Command:
    """Immutable per-transaction record (ref: Command.java)."""

    __slots__ = ("txn_id", "save_status", "durability", "route", "progress_key",
                 "promised", "accepted", "partial_txn", "partial_deps",
                 "execute_at", "executes_at_least", "waiting_on", "writes",
                 "result", "listeners")

    def __init__(self, txn_id: TxnId,
                 save_status: SaveStatus = SaveStatus.Uninitialised,
                 durability: Durability = Durability.NotDurable,
                 route: Optional[Route] = None,
                 progress_key: Optional[int] = None,
                 promised: Ballot = Ballot.ZERO,
                 accepted: Ballot = Ballot.ZERO,
                 partial_txn: Optional[PartialTxn] = None,
                 partial_deps: Optional[PartialDeps] = None,
                 execute_at: Optional[Timestamp] = None,
                 executes_at_least: Optional[Timestamp] = None,
                 waiting_on: Optional[WaitingOn] = None,
                 writes: Optional[Writes] = None,
                 result=None,
                 listeners: FrozenSet[TxnId] = frozenset()):
        self.txn_id = txn_id
        self.save_status = save_status
        self.durability = durability
        self.route = route
        self.progress_key = progress_key
        self.promised = promised
        self.accepted = accepted          # acceptedOrCommitted ballot
        self.partial_txn = partial_txn
        self.partial_deps = partial_deps
        self.execute_at = execute_at
        self.executes_at_least = executes_at_least
        self.waiting_on = waiting_on
        self.writes = writes
        self.result = result
        self.listeners = listeners

    # -- derived ------------------------------------------------------------
    def participants(self):
        """Where this command participates, from the best local knowledge:
        the sliced definition if present, else the route, else None.  The
        one shared resolution used by the drain clearing rules and Cleanup
        (keep in sync — divergent copies silently skew cleanup vs drain)."""
        if self.partial_txn is not None:
            return self.partial_txn.keys
        if self.route is not None:
            return self.route.participants
        return None

    @property
    def status(self) -> Status:
        return self.save_status.status

    def known(self) -> Known:
        return self.save_status.known

    def is_defined(self) -> bool:
        return self.save_status.known.is_definition_known()

    def has_been(self, status: Status) -> bool:
        return self.status >= status

    def is_stable(self) -> bool:
        return (self.save_status >= SaveStatus.Stable
                and not self.save_status.is_truncated()
                and self.save_status is not SaveStatus.Invalidated)

    def is_truncated(self) -> bool:
        return self.save_status.is_truncated()

    def is_invalidated(self) -> bool:
        return self.save_status is SaveStatus.Invalidated

    def is_applied(self) -> bool:
        return self.save_status in (SaveStatus.Applied,) or (
            self.save_status.is_truncated()
            and self.save_status is not SaveStatus.ErasedOrInvalidated)

    def is_at_least_applying(self) -> bool:
        return self.save_status >= SaveStatus.Applying

    def execute_at_if_known(self) -> Optional[Timestamp]:
        if self.known().execute_at.is_decided_and_known_to_execute():
            return self.execute_at
        return None

    def is_waiting(self) -> bool:
        return self.waiting_on is not None and self.waiting_on.is_waiting()

    # -- evolution ----------------------------------------------------------
    def updated(self, **kwargs) -> "Command":
        if _FASTPATH:
            # slot-copy transition: the per-op hot loop runs this for
            # every state change, so skip the dict rebuild + __init__
            # re-entry; an unknown kwarg still raises (no spare slots)
            new = Command.__new__(Command)
            for s in Command.__slots__:
                setattr(new, s, getattr(self, s))
            for k, v in kwargs.items():
                setattr(new, k, v)
            return new
        fields = {s: getattr(self, s) for s in Command.__slots__}
        fields.update(kwargs)
        return Command(**fields)

    def with_listener(self, txn_id: TxnId) -> "Command":
        if txn_id in self.listeners:
            return self
        return self.updated(listeners=self.listeners | {txn_id})

    def without_listener(self, txn_id: TxnId) -> "Command":
        if txn_id not in self.listeners:
            return self
        return self.updated(listeners=self.listeners - {txn_id})

    def __repr__(self):
        return (f"Command({self.txn_id}, {self.save_status.name}"
                + (f", executeAt={self.execute_at}" if self.execute_at else "")
                + ")")
