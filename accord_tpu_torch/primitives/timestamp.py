"""Hybrid-logical-clock timestamps, transaction ids and ballots.

TPU-native rebuild of the reference's 128-bit timestamp primitives
(ref: accord-core/src/main/java/accord/primitives/Timestamp.java:27-165,
TxnId.java:32-140, Ballot.java).  The packed layout is kept bit-compatible
because it doubles as the device array format (2 x int64 + int32 node):

    msb = epoch(48 bits) << 16 | hlc >> 48      (high 16 bits of the hlc)
    lsb = (hlc & (2^48-1)) << 16 | flags(16)
    node = int32 replica id

Total order = (msb, lsb, node) compared as unsigned — epoch-major, then hlc,
then flags, then node; this is what makes TxnIds a global total order usable
directly as array sort keys on device.

TxnId packs Txn kind + routing domain into the flag bits:
    flags = kind.ordinal << 1 | domain.ordinal
(ref: accord-core/src/main/java/accord/primitives/TxnId.java:120-140).
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

from ..utils import invariants

MAX_EPOCH = (1 << 48) - 1
_MASK48 = (1 << 48) - 1
_MASK16 = 0xFFFF
_MASK64 = (1 << 64) - 1
MAX_FLAGS = _MASK16
REJECTED_FLAG = 0x8000
MERGE_FLAGS = 0x8000
NODE_NONE = 0
NODE_MAX = (1 << 31) - 1


def pack_msb(epoch: int, hlc: int) -> int:
    return ((epoch & _MASK48) << 16) | ((hlc >> 48) & _MASK16)


def pack_lsb(hlc: int, flags: int) -> int:
    return ((hlc & _MASK48) << 16) | (flags & _MASK16)


def unpack_epoch(msb: int) -> int:
    return (msb >> 16) & _MASK48


def unpack_hlc(msb: int, lsb: int) -> int:
    return ((msb & _MASK16) << 48) | ((lsb >> 16) & _MASK48)


def unpack_flags(lsb: int) -> int:
    return lsb & _MASK16


class Domain(enum.IntEnum):
    """Routing domain of a transaction: point keys or key ranges
    (ref: accord/primitives/Routable.java Domain)."""

    Key = 0
    Range = 1

    def is_key(self) -> bool:
        return self is Domain.Key

    def is_range(self) -> bool:
        return self is Domain.Range

    def short_name(self) -> str:
        return "K" if self is Domain.Key else "R"


class TxnKind(enum.IntEnum):
    """Transaction kinds (ref: accord/primitives/Txn.java:53-160).  Ordinals
    are part of the TxnId wire/array format — do not reorder."""

    Read = 0
    Write = 1
    EphemeralRead = 2
    SyncPoint = 3
    ExclusiveSyncPoint = 4
    LocalOnly = 5

    # -- witness predicates -------------------------------------------------
    def is_write(self) -> bool:
        return self is TxnKind.Write

    def is_read(self) -> bool:
        return self is TxnKind.Read

    def is_sync_point(self) -> bool:
        return self in (TxnKind.SyncPoint, TxnKind.ExclusiveSyncPoint)

    def is_globally_visible(self) -> bool:
        return self not in (TxnKind.EphemeralRead, TxnKind.LocalOnly)

    def awaits_only_deps(self) -> bool:
        """ExclusiveSyncPoint and EphemeralRead execute only after ALL their
        deps — including deps with a later executeAt — and have no logical
        executeAt of their own (ref: Txn.java:208-214).  This is what makes
        an applied ESP a redundancy watermark: everything below its TxnId has
        locally applied."""
        return self in (TxnKind.ExclusiveSyncPoint, TxnKind.EphemeralRead)

    def is_durable(self) -> bool:
        """Durable txns participate in recovery; EphemeralRead does not."""
        return self not in (TxnKind.EphemeralRead, TxnKind.LocalOnly)

    def witnesses(self) -> "Kinds":
        """What kinds of earlier transactions must this kind take dependencies
        on (ref: accord/primitives/Txn.java Kind.witnesses)."""
        if self in (TxnKind.Read, TxnKind.EphemeralRead):
            return Kinds.WsOrSyncPoints
        if self is TxnKind.Write:
            return Kinds.RsOrWs
        if self in (TxnKind.SyncPoint, TxnKind.ExclusiveSyncPoint):
            return Kinds.AnyGloballyVisible
        return Kinds.Nothing

    def witnessed_by(self) -> "Kinds":
        """Dual of witnesses(): which kinds witness THIS kind."""
        if self is TxnKind.Read:
            return Kinds.WsOrSyncPoints
        if self is TxnKind.Write:
            return Kinds.AnyGloballyVisible
        if self in (TxnKind.SyncPoint, TxnKind.ExclusiveSyncPoint):
            return Kinds.SyncPoints  # sync points witness each other; R/W don't wait on them directly
        return Kinds.Nothing

    def short_name(self) -> str:
        return {TxnKind.Read: "R", TxnKind.Write: "W", TxnKind.EphemeralRead: "E",
                TxnKind.SyncPoint: "S", TxnKind.ExclusiveSyncPoint: "X",
                TxnKind.LocalOnly: "L"}[self]


class Kinds(enum.IntEnum):
    """Predicates over TxnKind (ref: accord/primitives/Txn.java:125-160)."""

    Nothing = 0
    Ws = 1
    RsOrWs = 2
    WsOrSyncPoints = 3
    SyncPoints = 4
    AnyGloballyVisible = 5

    def test(self, kind: TxnKind) -> bool:
        if self is Kinds.AnyGloballyVisible:
            return kind.is_globally_visible()
        if self is Kinds.WsOrSyncPoints:
            return kind in (TxnKind.Write, TxnKind.SyncPoint, TxnKind.ExclusiveSyncPoint)
        if self is Kinds.SyncPoints:
            return kind in (TxnKind.SyncPoint, TxnKind.ExclusiveSyncPoint)
        if self is Kinds.RsOrWs:
            return kind in (TxnKind.Read, TxnKind.Write)
        if self is Kinds.Ws:
            return kind is TxnKind.Write
        return False

    def mask(self) -> int:
        """Bitmask over TxnKind ordinals — the device-kernel form of test().
        Memoized per predicate: the query packer calls this once per
        query, and the enum-iteration rebuild showed up at ~10% of the
        hot-128 host route's pack phase."""
        m = _KINDS_MASKS.get(self)
        if m is None:
            m = 0
            for k in TxnKind:
                if self.test(k):
                    m |= 1 << int(k)
            _KINDS_MASKS[self] = m
        return m


_KINDS_MASKS: dict = {}

# ordinal -> member tables for the TxnId flag decoders (an enum __call__
# costs a classmethod dispatch + value lookup; these are two of the most
# frequent calls on the serving path)
_TXNKIND_BY_ORDINAL = tuple(TxnKind(i) for i in range(len(TxnKind)))
_DOMAIN_BY_ORDINAL = (Domain.Key, Domain.Range)


class Timestamp:
    """Immutable HLC timestamp. Totally ordered by (msb, lsb, node)."""

    __slots__ = ("msb", "lsb", "node", "_hash")

    def __init__(self, msb: int, lsb: int, node: int):
        self.msb = msb & _MASK64
        self.lsb = lsb & _MASK64
        self.node = node

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_bits(cls, msb: int, lsb: int, node: int) -> "Timestamp":
        return cls(msb, lsb, node)

    @classmethod
    def from_values(cls, epoch: int, hlc: int, node: int, flags: int = 0) -> "Timestamp":
        invariants.check_argument(hlc >= 0, "hlc must be >= 0; given %d", hlc)
        invariants.check_argument(epoch <= MAX_EPOCH, "epoch %d > MAX_EPOCH", epoch)
        invariants.check_argument(flags <= MAX_FLAGS, "flags %d > MAX_FLAGS", flags)
        return cls(pack_msb(epoch, hlc), pack_lsb(hlc, flags), node)

    @classmethod
    def max_for_epoch(cls, epoch: int) -> "Timestamp":
        return cls(((epoch & _MASK48) << 16) | 0x7FFF, _MASK64, NODE_MAX)

    @classmethod
    def min_for_epoch(cls, epoch: int) -> "Timestamp":
        return cls((epoch & _MASK48) << 16, 0, NODE_NONE)

    # -- accessors ----------------------------------------------------------
    def epoch(self) -> int:
        return unpack_epoch(self.msb)

    def hlc(self) -> int:
        return unpack_hlc(self.msb, self.lsb)

    def flags(self) -> int:
        return unpack_flags(self.lsb)

    def is_rejected(self) -> bool:
        return bool(self.lsb & REJECTED_FLAG)

    # -- derivation ---------------------------------------------------------
    def _like(self, epoch: int, hlc: int, flags: int, node: int):
        return type(self).from_values(epoch, hlc, node, flags)

    def as_rejected(self) -> "Timestamp":
        return self.with_extra_flags(REJECTED_FLAG)

    def with_extra_flags(self, extra: int) -> "Timestamp":
        return self._like(self.epoch(), self.hlc(), self.flags() | extra, self.node)

    def with_next_hlc(self, hlc_at_least: int = 0) -> "Timestamp":
        return self._like(self.epoch(), max(hlc_at_least, self.hlc() + 1), self.flags(), self.node)

    def with_epoch(self, epoch: int) -> "Timestamp":
        if epoch == self.epoch():
            return self
        return self._like(epoch, self.hlc(), self.flags(), self.node)

    def with_epoch_at_least(self, min_epoch: int) -> "Timestamp":
        return self if min_epoch <= self.epoch() else self.with_epoch(min_epoch)

    def with_hlc_at_least(self, min_hlc: int) -> "Timestamp":
        if min_hlc <= self.hlc():
            return self
        return self._like(self.epoch(), min_hlc, self.flags(), self.node)

    def with_node(self, node: int) -> "Timestamp":
        return type(self)(self.msb, self.lsb, node)

    def merge(self, that: "Timestamp") -> "Timestamp":
        """max of the two, retaining MERGE_FLAGS of both
        (ref: Timestamp.java mergeMax semantics)."""
        big, small = (self, that) if self >= that else (that, self)
        extra = small.flags() & MERGE_FLAGS
        if extra and not (big.flags() & extra) == extra:
            return big.with_extra_flags(extra)
        return type(big)(big.msb, big.lsb, big.node)

    # -- ordering -----------------------------------------------------------
    # the comparison dunders are the hottest calls in the whole protocol
    # path (every sort, dict probe and watermark compare lands here), so
    # they compare fields directly instead of building _key() tuples
    def _key(self) -> Tuple[int, int, int]:
        return (self.msb, self.lsb, self.node)

    def __lt__(self, o):
        if self.msb != o.msb:
            return self.msb < o.msb
        if self.lsb != o.lsb:
            return self.lsb < o.lsb
        return self.node < o.node

    def __le__(self, o):
        if self.msb != o.msb:
            return self.msb < o.msb
        if self.lsb != o.lsb:
            return self.lsb < o.lsb
        return self.node <= o.node

    def __gt__(self, o):
        if self.msb != o.msb:
            return self.msb > o.msb
        if self.lsb != o.lsb:
            return self.lsb > o.lsb
        return self.node > o.node

    def __ge__(self, o):
        if self.msb != o.msb:
            return self.msb > o.msb
        if self.lsb != o.lsb:
            return self.lsb > o.lsb
        return self.node >= o.node

    def __eq__(self, o):
        return (self.msb == o.msb and self.lsb == o.lsb
                and self.node == o.node) if isinstance(o, Timestamp) \
            else NotImplemented

    def __hash__(self):
        # the single hottest call on the serving path (every dict/set
        # probe keyed by TxnId lands here); fields are init-only, so the
        # tuple hash — the SAME value, preserving set iteration order and
        # thus byte-determinism — is computed once and cached in a slot
        # left unset until first use (no per-construction cost)
        try:
            return self._hash
        except AttributeError:
            h = hash((self.msb, self.lsb, self.node))
            self._hash = h
            return h

    def compare_to(self, o: "Timestamp") -> int:
        if self.msb != o.msb:
            return -1 if self.msb < o.msb else 1
        if self.lsb != o.lsb:
            return -1 if self.lsb < o.lsb else 1
        n = self.node - o.node
        return -1 if n < 0 else (0 if n == 0 else 1)

    def equals_strict(self, o: "Timestamp") -> bool:
        return (self.msb == o.msb and self.lsb == o.lsb
                and self.node == o.node and type(self) is type(o))

    def __repr__(self):
        return f"[{self.epoch()},{self.hlc()},{self.flags()},{self.node}]"


Timestamp.NONE = Timestamp.from_values(0, 0, NODE_NONE)
Timestamp.MAX = Timestamp(_MASK64, _MASK64, NODE_MAX)


class TxnId(Timestamp):
    """Timestamp that additionally encodes TxnKind + Domain in its flags."""

    __slots__ = ()

    @classmethod
    def create(cls, epoch: int, hlc: int, kind: TxnKind, domain: Domain, node: int) -> "TxnId":
        return cls.from_values(epoch, hlc, node, (int(kind) << 1) | int(domain))

    @classmethod
    def from_timestamp(cls, ts: Timestamp, kind: TxnKind, domain: Domain) -> "TxnId":
        return cls.create(ts.epoch(), ts.hlc(), kind, domain, ts.node)

    def kind(self) -> TxnKind:
        # table lookup: the enum __call__ protocol is measurable on the
        # serving hot path (every witness predicate lands here)
        return _TXNKIND_BY_ORDINAL[(self.lsb >> 1) & 0x7]

    def domain(self) -> Domain:
        return _DOMAIN_BY_ORDINAL[self.lsb & 0x1]

    def is_write(self) -> bool:
        return self.kind() is TxnKind.Write

    def is_read(self) -> bool:
        return self.kind() is TxnKind.Read

    def is_visible(self) -> bool:
        return self.kind().is_globally_visible()

    def is_sync_point(self) -> bool:
        return self.kind().is_sync_point()

    def as_kind(self, kind: TxnKind) -> "TxnId":
        return TxnId.create(self.epoch(), self.hlc(), kind, self.domain(), self.node)

    def witnesses(self, other: "TxnId") -> bool:
        return self.kind().witnesses().test(other.kind())

    def __repr__(self):
        return (f"[{self.epoch()},{self.hlc()},{self.flags()}"
                f"({self.domain().short_name()}{self.kind().short_name()}),{self.node}]")


TxnId.NONE = TxnId(0, 0, NODE_NONE)
TxnId.MAX = TxnId(_MASK64, _MASK64, NODE_MAX)


class Ballot(Timestamp):
    """Recovery/Accept round ballot (ref: accord/primitives/Ballot.java)."""

    __slots__ = ()


Ballot.ZERO = Ballot(0, 0, NODE_NONE)
Ballot.MAX = Ballot(_MASK64, _MASK64, NODE_MAX)


def max_timestamp(a: Optional[Timestamp], b: Optional[Timestamp]) -> Optional[Timestamp]:
    if a is None:
        return b
    if b is None:
        return a
    return a if a >= b else b
