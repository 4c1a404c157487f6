"""Dependency sets: Key -> [TxnId] and Range -> [TxnId] multimaps in CSR form.

TPU-native rebuild of the reference's dependency primitives
(ref: accord-core/src/main/java/accord/primitives/KeyDeps.java:115-170,
RangeDeps.java:75-84, Deps.java:98-256, and the shared CSR machinery in
utils/RelationMultiMap.java:59).

The encoding is CSR (compressed sparse row) exactly as in the reference —
unique sorted keys, unique sorted TxnIds, and one int vector whose first
``len(keys)`` entries are end-offsets into the remainder, which holds indices
into the TxnId vector.  This is adopted deliberately as the *device* format:
a KeyDeps is literally a sparse adjacency matrix whose rows can be shipped to
the TPU unchanged (see accord_tpu.ops.deps_kernels).

Host-side, the objects are immutable, and built via DepsBuilder / merged via
set-union k-way merge.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from ..utils import invariants
from .keys import Range, Ranges, RoutingKeys
from .timestamp import TxnId


def _merge_sorted_unique(lists: Sequence[Sequence[TxnId]]) -> List[TxnId]:
    """k-way merge of sorted unique TxnId lists into one sorted unique list
    (host analogue of the reference's LinearMerger)."""
    non_empty = [l for l in lists if l]
    if not non_empty:
        return []
    if len(non_empty) == 1:
        return list(non_empty[0])
    out: List[TxnId] = []
    import heapq
    for t in heapq.merge(*non_empty):
        if not out or out[-1] != t:
            out.append(t)
    return out


class KeyDeps:
    """token -> sorted unique [TxnId], CSR encoded
    (ref: accord/primitives/KeyDeps.java:150-170)."""

    __slots__ = ("keys", "txn_ids", "_rows", "_cols")

    def __init__(self, keys: RoutingKeys, txn_ids: List[TxnId],
                 per_key: List[List[int]]):
        # per_key[i] = sorted indices into txn_ids for keys[i]
        self.keys = keys
        self.txn_ids = txn_ids          # sorted unique
        self._rows = per_key            # CSR rows (index lists)
        self._cols = None

    @classmethod
    def from_columns(cls, keys: RoutingKeys, txn_ids: List[TxnId],
                     row_ptr, dep_idx) -> "KeyDeps":
        """Columnar CSR constructor (the device batch path): ``row_ptr``
        int[K+1] offsets into ``dep_idx`` (indices into txn_ids) — exactly
        the reference's primitive-array keysToTxnIds layout
        (KeyDeps.java:150-170).  The Python list-of-lists rows materialize
        lazily for host consumers; the columns ARE the wire-complete
        relation set."""
        out = cls.__new__(cls)
        out.keys = keys
        out.txn_ids = txn_ids
        out._rows = None
        out._cols = (row_ptr, dep_idx)
        return out

    @property
    def _ranges_per_key(self) -> List[List[int]]:
        if self._rows is None:
            row_ptr, dep_idx = self._cols
            dep_l = dep_idx.tolist()
            rp = row_ptr.tolist()
            self._rows = [dep_l[rp[i]:rp[i + 1]] for i in range(len(rp) - 1)]
        return self._rows

    def relation_count(self) -> int:
        """Total (key, dep) relations — O(1) on columnar deps."""
        if self._cols is not None:
            return len(self._cols[1])
        return sum(len(r) for r in self._ranges_per_key)

    # -- construction -------------------------------------------------------
    @classmethod
    def none(cls) -> "KeyDeps":
        return _NONE_KEY_DEPS

    @classmethod
    def of(cls, mapping: Dict[int, Iterable[TxnId]]) -> "KeyDeps":
        b = KeyDepsBuilder()
        for token, txns in mapping.items():
            for t in txns:
                b.add(token, t)
        return b.build()

    # -- accessors ----------------------------------------------------------
    def is_empty(self) -> bool:
        return not self.txn_ids

    def __len__(self) -> int:
        return len(self.txn_ids)

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def key_count(self) -> int:
        return len(self.keys)

    def txn_ids_for(self, token: int) -> List[TxnId]:
        i = bisect.bisect_left(list(self.keys.tokens()), token)
        if i < len(self.keys) and self.keys[i] == token:
            return [self.txn_ids[j] for j in self._ranges_per_key[i]]
        return []

    def contains(self, txn_id: TxnId) -> bool:
        i = bisect.bisect_left(self.txn_ids, txn_id)
        return i < len(self.txn_ids) and self.txn_ids[i] == txn_id

    def participants(self, txn_id: TxnId) -> RoutingKeys:
        """Inverse map: keys on which txn_id is a dependency
        (ref: KeyDeps lazily-built inverse map)."""
        i = bisect.bisect_left(self.txn_ids, txn_id)
        if i >= len(self.txn_ids) or self.txn_ids[i] != txn_id:
            return RoutingKeys.empty()
        toks = [self.keys[k] for k, row in enumerate(self._ranges_per_key) if i in set(row)]
        return RoutingKeys(toks, _presorted=True)

    def for_each(self, fn: Callable[[int, TxnId], None]) -> None:
        for k, row in enumerate(self._ranges_per_key):
            token = self.keys[k]
            for j in row:
                fn(token, self.txn_ids[j])

    def max_txn_id(self) -> Optional[TxnId]:
        return self.txn_ids[-1] if self.txn_ids else None

    def __iter__(self) -> Iterator[TxnId]:
        return iter(self.txn_ids)

    # -- algebra ------------------------------------------------------------
    def with_(self, other: "KeyDeps") -> "KeyDeps":
        if other.is_empty():
            return self
        if self.is_empty():
            return other
        return KeyDeps.merge([self, other])

    @classmethod
    def merge(cls, deps: Sequence["KeyDeps"]) -> "KeyDeps":
        """Union across many KeyDeps (ref: KeyDeps.java:115-148)."""
        deps = [d for d in deps if not d.is_empty()]
        if not deps:
            return cls.none()
        if len(deps) == 1:
            return deps[0]
        acc: Dict[int, Set[TxnId]] = {}
        for d in deps:
            for k, row in enumerate(d._ranges_per_key):
                token = d.keys[k]
                s = acc.get(token)
                if s is None:
                    s = acc[token] = set()
                for j in row:
                    s.add(d.txn_ids[j])
        b = KeyDepsBuilder()
        b._map = acc
        return b.build()

    def slice(self, ranges: Ranges) -> "KeyDeps":
        if self.is_empty():
            return self
        keep = [k for k in range(len(self.keys)) if ranges.contains_token(self.keys[k])]
        if len(keep) == len(self.keys):
            return self
        b = KeyDepsBuilder()
        for k in keep:
            token = self.keys[k]
            for j in self._ranges_per_key[k]:
                b.add(token, self.txn_ids[j])
        return b.build()

    def without(self, pred: Callable[[TxnId], bool]) -> "KeyDeps":
        b = KeyDepsBuilder()
        for k, row in enumerate(self._ranges_per_key):
            token = self.keys[k]
            for j in row:
                t = self.txn_ids[j]
                if not pred(t):
                    b.add(token, t)
        return b.build()

    def without_ids(self, ids) -> "KeyDeps":
        idset = set(ids)
        return self.without(lambda t: t in idset)

    def without_covered(self, covering: Ranges) -> "KeyDeps":
        """Drop entries whose key lies inside ``covering`` (the complement of
        slice())."""
        if self.is_empty() or covering.is_empty():
            return self
        b = KeyDepsBuilder()
        for k, row in enumerate(self._ranges_per_key):
            token = self.keys[k]
            if covering.contains_token(token):
                continue
            for j in row:
                b.add(token, self.txn_ids[j])
        return b.build()

    # -- CSR export (device format) -----------------------------------------
    def to_csr(self) -> Tuple[List[int], List[int], List[int]]:
        """Returns (key_tokens, end_offsets, txn_index_list) — the reference's
        keysToTxnIds layout split into named vectors."""
        offsets: List[int] = []
        indices: List[int] = []
        for row in self._ranges_per_key:
            indices.extend(row)
            offsets.append(len(indices))
        return list(self.keys.tokens()), offsets, indices

    def __eq__(self, o):
        return (isinstance(o, KeyDeps) and self.keys == o.keys
                and self.txn_ids == o.txn_ids
                and self._ranges_per_key == o._ranges_per_key)

    def __repr__(self):
        parts = []
        for k, row in enumerate(self._ranges_per_key):
            parts.append(f"{self.keys[k]}:{[self.txn_ids[j] for j in row]}")
        return "KeyDeps{" + ", ".join(parts) + "}"


class KeyDepsBuilder:
    """Accumulates (token, TxnId) relations, freezes to CSR
    (ref: utils/RelationMultiMap.AbstractBuilder).

    Two ingestion paths: per-emit ``add`` (host protocol code) and
    ``set_prebuilt`` (the device batch attribution constructs whole batches
    of builders' KeyDeps in one vectorized pass); build() merges them."""

    def __init__(self):
        self._map: Dict[int, Set[TxnId]] = {}
        self._prebuilt: Optional[KeyDeps] = None

    def set_prebuilt(self, deps: "KeyDeps") -> None:
        """Attach a batch-finalized KeyDeps (the device attribution builds
        whole batches of builders in one vectorized pass); build() merges
        it with any per-emit additions."""
        self._prebuilt = deps if self._prebuilt is None \
            else self._prebuilt.with_(deps)

    def add(self, token: int, txn_id: TxnId) -> "KeyDepsBuilder":
        s = self._map.get(token)
        if s is None:
            s = self._map[token] = set()
        s.add(txn_id)
        return self

    def is_empty(self) -> bool:
        return not self._map \
            and (self._prebuilt is None or self._prebuilt.is_empty())

    def build(self) -> KeyDeps:
        if self._prebuilt is not None:
            if not self._map:
                return self._prebuilt
            inc = KeyDepsBuilder()
            inc._map = self._map
            return self._prebuilt.with_(inc.build())
        if not self._map:
            return KeyDeps.none()
        tokens = sorted(self._map)
        all_ids: Set[TxnId] = set()
        for s in self._map.values():
            all_ids.update(s)
        txn_ids = sorted(all_ids)
        index_of = {t: i for i, t in enumerate(txn_ids)}
        per_key = [sorted(index_of[t] for t in self._map[tok])
                   for tok in tokens]
        return KeyDeps(RoutingKeys(tokens, _presorted=True), txn_ids,
                       per_key)


_NONE_KEY_DEPS = KeyDeps(RoutingKeys.empty(), [], [])


class RangeDeps:
    """Range -> sorted unique [TxnId], ranges sorted by (start, end)
    (ref: accord/primitives/RangeDeps.java:75-84).  Stabbing queries are a
    linear/bisect scan host-side; the batched device analogue lives in
    accord_tpu.ops.interval (CINTIA-style checkpointed interval index,
    ref: utils/CheckpointIntervalArray.java)."""

    __slots__ = ("txn_ids", "_rngs", "_rows", "_cols")

    def __init__(self, ranges: List[Range], txn_ids: List[TxnId],
                 per_range: List[List[int]]):
        self._rngs = ranges         # sorted by (start, end); may overlap
        self.txn_ids = txn_ids      # sorted unique
        self._rows = per_range
        self._cols = None

    @classmethod
    def from_columns(cls, lo, hi, txn_ids: List[TxnId], row_ptr,
                     dep_idx) -> "RangeDeps":
        """Columnar CSR constructor (the device batch path): ranges as
        int64 bound arrays + offsets/indices — the reference's primitive
        long[]/int[] RangeDeps layout (RangeDeps.java:75-84).  Range
        objects and Python rows materialize lazily for host consumers."""
        out = cls.__new__(cls)
        out.txn_ids = txn_ids
        out._rngs = None
        out._rows = None
        out._cols = (lo, hi, row_ptr, dep_idx)
        return out

    @property
    def ranges(self) -> List[Range]:
        if self._rngs is None:
            lo, hi, _rp, _di = self._cols
            self._rngs = [Range(a, b) for a, b in zip(lo.tolist(),
                                                      hi.tolist())]
        return self._rngs

    @property
    def _per_range(self) -> List[List[int]]:
        if self._rows is None:
            _lo, _hi, row_ptr, dep_idx = self._cols
            dep_l = dep_idx.tolist()
            rp = row_ptr.tolist()
            self._rows = [dep_l[rp[i]:rp[i + 1]] for i in range(len(rp) - 1)]
        return self._rows

    def relation_count(self) -> int:
        if self._cols is not None:
            return len(self._cols[3])
        return sum(len(r) for r in self._per_range)

    @classmethod
    def none(cls) -> "RangeDeps":
        return _NONE_RANGE_DEPS

    def is_empty(self) -> bool:
        return not self.txn_ids

    def __len__(self) -> int:
        return len(self.txn_ids)

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def contains(self, txn_id: TxnId) -> bool:
        i = bisect.bisect_left(self.txn_ids, txn_id)
        return i < len(self.txn_ids) and self.txn_ids[i] == txn_id

    def intersecting_token(self, token: int) -> List[TxnId]:
        out: Set[TxnId] = set()
        for r, row in zip(self.ranges, self._per_range):
            if r.start > token:
                break
            if r.contains_token(token):
                out.update(self.txn_ids[j] for j in row)
        return sorted(out)

    def intersecting_range(self, rng: Range) -> List[TxnId]:
        out: Set[TxnId] = set()
        for r, row in zip(self.ranges, self._per_range):
            if r.start >= rng.end:
                break
            if r.intersects(rng):
                out.update(self.txn_ids[j] for j in row)
        return sorted(out)

    def participants(self, txn_id: TxnId) -> Ranges:
        i = bisect.bisect_left(self.txn_ids, txn_id)
        if i >= len(self.txn_ids) or self.txn_ids[i] != txn_id:
            return Ranges.empty()
        return Ranges([r for r, row in zip(self.ranges, self._per_range) if i in set(row)])

    def for_each(self, fn: Callable[[Range, TxnId], None]) -> None:
        for r, row in zip(self.ranges, self._per_range):
            for j in row:
                fn(r, self.txn_ids[j])

    def max_txn_id(self) -> Optional[TxnId]:
        return self.txn_ids[-1] if self.txn_ids else None

    def __iter__(self) -> Iterator[TxnId]:
        return iter(self.txn_ids)

    def with_(self, other: "RangeDeps") -> "RangeDeps":
        if other.is_empty():
            return self
        if self.is_empty():
            return other
        return RangeDeps.merge([self, other])

    @classmethod
    def merge(cls, deps: Sequence["RangeDeps"]) -> "RangeDeps":
        deps = [d for d in deps if not d.is_empty()]
        if not deps:
            return cls.none()
        if len(deps) == 1:
            return deps[0]
        b = RangeDepsBuilder()
        for d in deps:
            for r, row in zip(d.ranges, d._per_range):
                for j in row:
                    b.add(r, d.txn_ids[j])
        return b.build()

    def slice(self, ranges: Ranges) -> "RangeDeps":
        if self.is_empty():
            return self
        b = RangeDepsBuilder()
        for r, row in zip(self.ranges, self._per_range):
            for covering in ranges:
                x = r.intersection(covering)
                if x is not None:
                    for j in row:
                        b.add(x, self.txn_ids[j])
        return b.build()

    def without(self, pred: Callable[[TxnId], bool]) -> "RangeDeps":
        b = RangeDepsBuilder()
        for r, row in zip(self.ranges, self._per_range):
            for j in row:
                t = self.txn_ids[j]
                if not pred(t):
                    b.add(r, t)
        return b.build()

    def without_covered(self, covering: Ranges) -> "RangeDeps":
        """Keep only the parts of each range outside ``covering``."""
        if self.is_empty() or covering.is_empty():
            return self
        b = RangeDepsBuilder()
        for r, row in zip(self.ranges, self._per_range):
            for rest in Ranges.of(r).without(covering):
                for j in row:
                    b.add(rest, self.txn_ids[j])
        return b.build()

    def to_csr(self) -> Tuple[List[int], List[int], List[int], List[int]]:
        """(starts, ends, end_offsets, txn_index_list)."""
        starts = [r.start for r in self.ranges]
        ends = [r.end for r in self.ranges]
        offsets: List[int] = []
        indices: List[int] = []
        for row in self._per_range:
            indices.extend(row)
            offsets.append(len(indices))
        return starts, ends, offsets, indices

    def __eq__(self, o):
        return (isinstance(o, RangeDeps) and self.ranges == o.ranges
                and self.txn_ids == o.txn_ids and self._per_range == o._per_range)

    def __repr__(self):
        parts = []
        for r, row in zip(self.ranges, self._per_range):
            parts.append(f"{r}:{[self.txn_ids[j] for j in row]}")
        return "RangeDeps{" + ", ".join(parts) + "}"


class RangeDepsBuilder:
    """Same two ingestion paths as KeyDepsBuilder: per-emit ``add`` and
    ``set_prebuilt`` from the device batch attribution."""

    def __init__(self):
        self._map: Dict[Tuple[int, int], Set[TxnId]] = {}
        self._prebuilt: Optional[RangeDeps] = None

    def set_prebuilt(self, deps: "RangeDeps") -> None:
        self._prebuilt = deps if self._prebuilt is None \
            else self._prebuilt.with_(deps)

    def add(self, rng: Range, txn_id: TxnId) -> "RangeDepsBuilder":
        key = (rng.start, rng.end)
        s = self._map.get(key)
        if s is None:
            s = self._map[key] = set()
        s.add(txn_id)
        return self

    def is_empty(self) -> bool:
        return not self._map \
            and (self._prebuilt is None or self._prebuilt.is_empty())

    def build(self) -> RangeDeps:
        if self._prebuilt is not None:
            if not self._map:
                return self._prebuilt
            inc = RangeDepsBuilder()
            inc._map = self._map
            return self._prebuilt.with_(inc.build())
        if not self._map:
            return RangeDeps.none()
        keys = sorted(self._map)
        all_ids: Set[TxnId] = set()
        for s in self._map.values():
            all_ids.update(s)
        txn_ids = sorted(all_ids)
        index_of = {t: i for i, t in enumerate(txn_ids)}
        ranges = [Range(s, e) for (s, e) in keys]
        per_range = [sorted(index_of[t] for t in self._map[k])
                     for k in keys]
        return RangeDeps(ranges, txn_ids, per_range)


_NONE_RANGE_DEPS = RangeDeps([], [], [])


class Deps:
    """{KeyDeps, RangeDeps} (ref: accord/primitives/Deps.java:98-99)."""

    __slots__ = ("key_deps", "range_deps")

    def __init__(self, key_deps: KeyDeps, range_deps: RangeDeps):
        self.key_deps = key_deps
        self.range_deps = range_deps

    @classmethod
    def none(cls) -> "Deps":
        return _NONE_DEPS

    def is_empty(self) -> bool:
        return self.key_deps.is_empty() and self.range_deps.is_empty()

    def txn_id_count(self) -> int:
        return len(self.key_deps) + len(self.range_deps)

    def txn_ids(self) -> List[TxnId]:
        return _merge_sorted_unique([self.key_deps.txn_ids, self.range_deps.txn_ids])

    def contains(self, txn_id: TxnId) -> bool:
        return self.key_deps.contains(txn_id) or self.range_deps.contains(txn_id)

    def max_txn_id(self) -> Optional[TxnId]:
        a, b = self.key_deps.max_txn_id(), self.range_deps.max_txn_id()
        if a is None:
            return b
        if b is None:
            return a
        return max(a, b)

    def with_(self, other: "Deps") -> "Deps":
        """Union (ref: Deps.java:117)."""
        return Deps(self.key_deps.with_(other.key_deps),
                    self.range_deps.with_(other.range_deps))

    @classmethod
    def merge(cls, many: Sequence["Deps"]) -> "Deps":
        """Union across PreAccept replies (ref: Deps.java:256)."""
        many = [d for d in many if d is not None]
        if not many:
            return cls.none()
        return Deps(KeyDeps.merge([d.key_deps for d in many]),
                    RangeDeps.merge([d.range_deps for d in many]))

    def slice(self, ranges: Ranges) -> "PartialDeps":
        return PartialDeps(ranges, self.key_deps.slice(ranges),
                           self.range_deps.slice(ranges))

    def without(self, pred: Callable[[TxnId], bool]) -> "Deps":
        return Deps(self.key_deps.without(pred), self.range_deps.without(pred))

    def without_covered(self, covering: Ranges) -> "Deps":
        """Drop the parts of this dep set that lie inside ``covering`` —
        used to fill uncovered ranges with proposals when merging recovery
        replies (decided deps win where they exist)."""
        return Deps(self.key_deps.without_covered(covering),
                    self.range_deps.without_covered(covering))

    def participants(self, txn_id: TxnId):
        """All participants (tokens + ranges) on which txn_id is a dep."""
        toks = self.key_deps.participants(txn_id)
        rngs = self.range_deps.participants(txn_id)
        if rngs.is_empty():
            return toks
        if toks.is_empty():
            return rngs
        return toks.to_ranges().with_(rngs)

    def __eq__(self, o):
        return (isinstance(o, Deps) and self.key_deps == o.key_deps
                and self.range_deps == o.range_deps)

    def __repr__(self):
        return f"Deps({self.key_deps}, {self.range_deps})"


_NONE_DEPS = Deps(KeyDeps.none(), RangeDeps.none())


class PartialDeps(Deps):
    """Deps sliced to covering ranges (ref: accord/primitives/PartialDeps.java)."""

    __slots__ = ("covering",)

    def __init__(self, covering: Ranges, key_deps: KeyDeps, range_deps: RangeDeps):
        super().__init__(key_deps, range_deps)
        self.covering = covering

    @classmethod
    def none_covering(cls, covering: Ranges) -> "PartialDeps":
        return cls(covering, KeyDeps.none(), RangeDeps.none())

    def covers(self, participants) -> bool:
        if isinstance(participants, Ranges):
            return self.covering.contains_all_ranges(participants)
        return all(self.covering.contains_token(t) for t in participants)

    def with_partial(self, other: "PartialDeps") -> "PartialDeps":
        return PartialDeps(self.covering.with_(other.covering),
                           self.key_deps.with_(other.key_deps),
                           self.range_deps.with_(other.range_deps))

    def reconstitute(self, route) -> Deps:
        invariants.check_state(self.covers(route.participants), "incomplete deps for route")
        return Deps(self.key_deps, self.range_deps)

    def __repr__(self):
        return f"PartialDeps(covering={self.covering}, {self.key_deps}, {self.range_deps})"


class DepsBuilder:
    """Combined builder over both domains."""

    def __init__(self):
        self.key = KeyDepsBuilder()
        self.range = RangeDepsBuilder()

    def add_key(self, token: int, txn_id: TxnId) -> "DepsBuilder":
        self.key.add(token, txn_id)
        return self

    def add_range(self, rng: Range, txn_id: TxnId) -> "DepsBuilder":
        self.range.add(rng, txn_id)
        return self

    def build(self) -> Deps:
        return Deps(self.key.build(), self.range.build())

    def build_partial(self, covering: Ranges) -> PartialDeps:
        return PartialDeps(covering, self.key.build(), self.range.build())
