"""Key / Range / Route algebra over a 64-bit token space.

TPU-native rebuild of the reference's Routables hierarchy
(ref: accord-core/src/main/java/accord/primitives/AbstractKeys.java,
AbstractRanges.java, Routables.java, Range.java, RoutingKeys.java,
FullKeyRoute.java, PartialKeyRoute.java ...).

Design deltas from the reference (deliberate, TPU-first):
  * RoutingKey is a plain int token in [MIN_TOKEN, MAX_TOKEN]; sorted int
    vectors are the native device format (searchsorted / segment ops).
  * Range is canonically half-open [start, end) over tokens (the reference
    supports both inclusivities; one canonical form keeps all interval
    kernels branch-free).
  * The Seekable/Unseekable split survives as Keys (data addressing,
    workload Key objects) vs RoutingKeys (plain tokens) vs Ranges; a Route
    is participants + home_key, either full or partial-with-covering.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from ..local.fastpath import proto_fastpath_enabled
from ..utils import invariants
from .timestamp import Domain

_FASTPATH = proto_fastpath_enabled()

MIN_TOKEN = -(1 << 63)
MAX_TOKEN = (1 << 63) - 1


# ---------------------------------------------------------------------------
# Keys (data plane addressing: workload-defined Key objects)
# ---------------------------------------------------------------------------

class Key:
    """Workload-defined data key (ref: accord/api/Key.java). Concrete
    integrations subclass; ordering and routing are by token."""

    __slots__ = ()

    def token(self) -> int:
        raise NotImplementedError

    def to_routing_key(self) -> int:
        return self.token()

    def __lt__(self, o): return self.token() < o.token()
    def __le__(self, o): return self.token() <= o.token()
    def __gt__(self, o): return self.token() > o.token()
    def __ge__(self, o): return self.token() >= o.token()
    def __eq__(self, o): return isinstance(o, Key) and self.token() == o.token()
    def __hash__(self): return hash(self.token())


class IntKey(Key):
    """Simple integer key whose token is its value (test / maelstrom style,
    ref: accord-core/src/test/java/accord/impl/IntKey.java)."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value

    def token(self) -> int:
        return self.value

    def __repr__(self):
        return f"IntKey({self.value})"


class Keys:
    """Immutable sorted, de-duplicated set of Keys
    (ref: accord/primitives/Keys.java)."""

    __slots__ = ("_keys", "_tokens")

    domain = Domain.Key

    def __init__(self, keys: Iterable[Key], _presorted: bool = False):
        ks = list(keys)
        if not _presorted:
            ks = sorted(set(ks), key=lambda k: k.token())
        self._keys: Tuple[Key, ...] = tuple(ks)
        self._tokens: List[int] = [k.token() for k in self._keys]

    @classmethod
    def of(cls, *keys: Key) -> "Keys":
        return cls(keys)

    @classmethod
    def empty(cls) -> "Keys":
        return _EMPTY_KEYS

    def __len__(self): return len(self._keys)
    def __iter__(self) -> Iterator[Key]: return iter(self._keys)
    def __getitem__(self, i) -> Key: return self._keys[i]
    def __bool__(self): return bool(self._keys)

    def __eq__(self, o):
        return isinstance(o, Keys) and self._keys == o._keys

    def __hash__(self):
        return hash(self._keys)

    def is_empty(self) -> bool:
        return not self._keys

    def tokens(self) -> List[int]:
        return self._tokens

    def index_of(self, key: Key) -> int:
        i = bisect.bisect_left(self._tokens, key.token())
        if i < len(self._tokens) and self._tokens[i] == key.token():
            return i
        return -(i + 1)

    def contains(self, key: Key) -> bool:
        return self.index_of(key) >= 0

    def with_(self, other: "Keys") -> "Keys":
        if not other:
            return self
        if not self:
            return other
        return Keys(list(self._keys) + list(other._keys))

    def intersecting(self, other: "Keys") -> "Keys":
        a, b = (self, other) if len(self) <= len(other) else (other, self)
        return Keys([k for k in a if b.contains(k)], _presorted=True)

    def without(self, other: "Keys") -> "Keys":
        return Keys([k for k in self if not other.contains(k)], _presorted=True)

    def slice(self, ranges: "Ranges") -> "Keys":
        return Keys([k for k in self._keys if ranges.contains_token(k.token())],
                    _presorted=True)

    def intersects(self, ranges: "Ranges") -> bool:
        return any(ranges.contains_token(t) for t in self._tokens)

    def to_unseekables(self) -> "RoutingKeys":
        return RoutingKeys(self._tokens)

    def to_participants(self) -> "RoutingKeys":
        return RoutingKeys(self._tokens)

    def __repr__(self):
        return f"Keys{list(self._keys)}"


_EMPTY_KEYS = Keys(())


# ---------------------------------------------------------------------------
# RoutingKeys (routing plane: plain int tokens)
# ---------------------------------------------------------------------------

class RoutingKeys:
    """Immutable sorted set of routing tokens (ref: accord/primitives/RoutingKeys.java)."""

    __slots__ = ("_tokens",)

    domain = Domain.Key

    def __init__(self, tokens: Iterable[int], _presorted: bool = False):
        ts = list(tokens)
        if not _presorted:
            ts = sorted(set(ts))
        self._tokens: Tuple[int, ...] = tuple(ts)

    @classmethod
    def of(cls, *tokens: int) -> "RoutingKeys":
        return cls(tokens)

    @classmethod
    def empty(cls) -> "RoutingKeys":
        return _EMPTY_ROUTING_KEYS

    def __len__(self): return len(self._tokens)
    def __iter__(self) -> Iterator[int]: return iter(self._tokens)
    def __getitem__(self, i) -> int: return self._tokens[i]
    def __bool__(self): return bool(self._tokens)

    def __eq__(self, o):
        return isinstance(o, RoutingKeys) and self._tokens == o._tokens

    def __hash__(self):
        return hash(self._tokens)

    def is_empty(self) -> bool:
        return not self._tokens

    def tokens(self) -> Sequence[int]:
        return self._tokens

    def contains_token(self, token: int) -> bool:
        i = bisect.bisect_left(self._tokens, token)
        return i < len(self._tokens) and self._tokens[i] == token

    def with_(self, other: "RoutingKeys") -> "RoutingKeys":
        if not other:
            return self
        if not self:
            return other
        return RoutingKeys(list(self._tokens) + list(other._tokens))

    def slice(self, ranges: "Ranges") -> "RoutingKeys":
        return RoutingKeys([t for t in self._tokens if ranges.contains_token(t)],
                           _presorted=True)

    def intersects(self, ranges: "Ranges") -> bool:
        return any(ranges.contains_token(t) for t in self._tokens)

    def intersecting(self, other: "RoutingKeys") -> "RoutingKeys":
        a, b = (self, other) if len(self) <= len(other) else (other, self)
        return RoutingKeys([t for t in a if b.contains_token(t)], _presorted=True)

    def without(self, other: "RoutingKeys") -> "RoutingKeys":
        return RoutingKeys([t for t in self if not other.contains_token(t)],
                           _presorted=True)

    def to_ranges(self) -> "Ranges":
        """Cover each token with a width-1 range."""
        return Ranges([Range(t, t + 1) for t in self._tokens])

    def __repr__(self):
        return f"RoutingKeys{list(self._tokens)}"


_EMPTY_ROUTING_KEYS = RoutingKeys(())


# ---------------------------------------------------------------------------
# Ranges
# ---------------------------------------------------------------------------

class Range:
    """Half-open token range [start, end) (ref: accord/primitives/Range.java,
    collapsed to one canonical inclusivity)."""

    __slots__ = ("start", "end")

    domain = Domain.Range

    def __init__(self, start: int, end: int):
        invariants.check_argument(start < end, "empty/inverted range [%d,%d)", start, end)
        self.start = start
        self.end = end

    def contains_token(self, token: int) -> bool:
        return self.start <= token < self.end

    def contains_key(self, key: Key) -> bool:
        return self.contains_token(key.token())

    def contains_range(self, o: "Range") -> bool:
        return self.start <= o.start and o.end <= self.end

    def intersects(self, o: "Range") -> bool:
        return self.start < o.end and o.start < self.end

    def intersection(self, o: "Range") -> Optional["Range"]:
        s, e = max(self.start, o.start), min(self.end, o.end)
        return Range(s, e) if s < e else None

    def __eq__(self, o):
        return isinstance(o, Range) and self.start == o.start and self.end == o.end

    def __hash__(self):
        return hash((self.start, self.end))

    def __lt__(self, o: "Range"):
        return (self.start, self.end) < (o.start, o.end)

    def __repr__(self):
        return f"[{self.start},{self.end})"


class Ranges:
    """Immutable sorted set of ranges, normalised to non-overlapping merged
    form (ref: accord/primitives/Ranges.java, AbstractRanges.java)."""

    __slots__ = ("_ranges", "_starts_memo")

    domain = Domain.Range

    def __init__(self, ranges: Iterable[Range], _presorted: bool = False):
        rs = list(ranges)
        if not _presorted:
            rs = self._normalise(rs)
        self._ranges: Tuple[Range, ...] = tuple(rs)

    @staticmethod
    def _normalise(rs: List[Range]) -> List[Range]:
        if not rs:
            return []
        # already-normal fast path: each start strictly past the previous
        # end means sorted, disjoint and non-adjacent — the dominant
        # serving-path shape (slices/unions of already-normal Ranges);
        # the slow path below would return these same objects unchanged
        prev_end = rs[0].end
        for i in range(1, len(rs)):
            if rs[i].start <= prev_end:
                break
            prev_end = rs[i].end
        else:
            return rs
        rs = sorted(rs, key=lambda r: (r.start, r.end))
        out = [rs[0]]
        for r in rs[1:]:
            last = out[-1]
            if r.start <= last.end:
                if r.end > last.end:
                    out[-1] = Range(last.start, r.end)
            else:
                out.append(r)
        return out

    @classmethod
    def of(cls, *ranges: Range) -> "Ranges":
        return cls(ranges)

    @classmethod
    def single(cls, start: int, end: int) -> "Ranges":
        return cls((Range(start, end),), _presorted=True)

    @classmethod
    def empty(cls) -> "Ranges":
        return _EMPTY_RANGES

    @classmethod
    def full(cls) -> "Ranges":
        return _FULL_RANGES

    def __len__(self): return len(self._ranges)
    def __iter__(self) -> Iterator[Range]: return iter(self._ranges)
    def __getitem__(self, i) -> Range: return self._ranges[i]
    def __bool__(self): return bool(self._ranges)

    def __eq__(self, o):
        return isinstance(o, Ranges) and self._ranges == o._ranges

    def __hash__(self):
        return hash(self._ranges)

    def is_empty(self) -> bool:
        return not self._ranges

    def _starts(self) -> List[int]:
        return [r.start for r in self._ranges]

    def _sorted_starts(self):
        """Memoized starts tuple for the bisect probes (contains_token is
        the single most frequent Ranges call on the serving path and was
        rebuilding this list per probe).  _ranges is init-only, so the
        memo — gated on PROTO_FASTPATH like every r18 cache — can never
        go stale."""
        if not _FASTPATH:
            return [r.start for r in self._ranges]
        try:
            return self._starts_memo
        except AttributeError:
            st = tuple(r.start for r in self._ranges)
            self._starts_memo = st
            return st

    def index_containing(self, token: int) -> int:
        i = bisect.bisect_right(self._sorted_starts(), token) - 1
        if i >= 0 and self._ranges[i].contains_token(token):
            return i
        return -1

    def contains_token(self, token: int) -> bool:
        return self.index_containing(token) >= 0

    def contains_key(self, key: Key) -> bool:
        return self.contains_token(key.token())

    def contains_all_ranges(self, other: "Ranges") -> bool:
        return all(self._covers(r) for r in other)

    def _covers(self, r: Range) -> bool:
        i = bisect.bisect_right(self._sorted_starts(), r.start) - 1
        return i >= 0 and self._ranges[i].contains_range(r)

    def intersects(self, other: Union["Ranges", "Keys", "RoutingKeys"]) -> bool:
        if isinstance(other, (Keys, RoutingKeys)):
            return other.intersects(self)
        i = j = 0
        while i < len(self) and j < len(other):
            a, b = self._ranges[i], other[j]
            if a.intersects(b):
                return True
            if a.end <= b.start:
                i += 1
            else:
                j += 1
        return False

    def intersecting(self, other: "Ranges") -> "Ranges":
        out: List[Range] = []
        i = j = 0
        while i < len(self) and j < len(other):
            a, b = self._ranges[i], other[j]
            x = a.intersection(b)
            if x is not None:
                out.append(x)
            if a.end <= b.end:
                i += 1
            else:
                j += 1
        return Ranges(out, _presorted=True)

    # alias matching reference naming
    def slice(self, ranges: "Ranges") -> "Ranges":
        return self.intersecting(ranges)

    def with_(self, other: "Ranges") -> "Ranges":
        if not other:
            return self
        if not self:
            return other
        return Ranges(list(self._ranges) + list(other._ranges))

    def without(self, other: "Ranges") -> "Ranges":
        """Set difference."""
        out: List[Range] = []
        for r in self._ranges:
            pieces = [r]
            for o in other:
                nxt: List[Range] = []
                for p in pieces:
                    if not p.intersects(o):
                        nxt.append(p)
                        continue
                    if p.start < o.start:
                        nxt.append(Range(p.start, o.start))
                    if o.end < p.end:
                        nxt.append(Range(o.end, p.end))
                pieces = nxt
                if not pieces:
                    break
            out.extend(pieces)
        return Ranges(out)

    def to_unseekables(self) -> "Ranges":
        return self

    def to_participants(self) -> "Ranges":
        return self

    def __repr__(self):
        return f"Ranges{list(self._ranges)}"


_EMPTY_RANGES = Ranges((), _presorted=True)
_FULL_RANGES = Ranges((Range(MIN_TOKEN, MAX_TOKEN),), _presorted=True)


# Seekables: what a Txn addresses (Keys or Ranges).
Seekables = Union[Keys, Ranges]
# Unseekables: what routing/coordination addresses (RoutingKeys or Ranges).
Unseekables = Union[RoutingKeys, Ranges]
Participants = Unseekables


def unseekables_union(a: Unseekables, b: Unseekables) -> Unseekables:
    if a.domain != b.domain:
        # mixed domains route as ranges
        ar = a if isinstance(a, Ranges) else a.to_ranges()
        br = b if isinstance(b, Ranges) else b.to_ranges()
        return ar.with_(br)
    return a.with_(b)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# Route
# ---------------------------------------------------------------------------

class Route:
    """Participants + home key. A FullRoute covers the whole transaction; a
    PartialRoute is sliced to some covering ranges
    (ref: accord/primitives/Route.java, FullKeyRoute/PartialKeyRoute/
    FullRangeRoute/PartialRangeRoute)."""

    __slots__ = ("home_key", "participants", "covering", "is_full")

    def __init__(self, home_key: int, participants: Unseekables,
                 is_full: bool = True, covering: Optional[Ranges] = None):
        self.home_key = home_key
        self.participants = participants
        self.is_full = is_full
        self.covering = covering  # only for partial routes

    @classmethod
    def full(cls, home_key: int, participants: Unseekables) -> "Route":
        return cls(home_key, participants, is_full=True)

    def domain(self) -> Domain:
        return self.participants.domain

    def slice(self, ranges: Ranges) -> "Route":
        return Route(self.home_key, self.participants.slice(ranges),
                     is_full=False, covering=ranges)

    def intersects(self, ranges: Ranges) -> bool:
        return self.participants.intersects(ranges)

    def contains_token(self, token: int) -> bool:
        return self.participants.contains_token(token) if isinstance(
            self.participants, RoutingKeys) else self.participants.contains_token(token)

    def covers(self, ranges: Ranges) -> bool:
        if self.is_full:
            return True
        return self.covering is not None and self.covering.contains_all_ranges(ranges)

    def with_(self, other: "Route") -> "Route":
        invariants.check_argument(self.home_key == other.home_key,
                                  "mismatched home keys")
        if self.is_full:
            return self
        if other.is_full:
            return other
        cov = None
        if self.covering is not None and other.covering is not None:
            cov = self.covering.with_(other.covering)
        return Route(self.home_key, unseekables_union(self.participants, other.participants),
                     is_full=False, covering=cov)

    def home_as_range(self) -> Range:
        return Range(self.home_key, self.home_key + 1)

    def __eq__(self, o):
        return (isinstance(o, Route) and self.home_key == o.home_key
                and self.participants == o.participants and self.is_full == o.is_full)

    def __hash__(self):
        return hash((self.home_key, self.participants, self.is_full))

    def __repr__(self):
        kind = "Full" if self.is_full else "Partial"
        return f"{kind}Route(home={self.home_key}, {self.participants})"
