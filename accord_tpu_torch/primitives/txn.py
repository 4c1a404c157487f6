"""Client transactions (ref: accord-core/src/main/java/accord/primitives/Txn.java).

A Txn bundles the addressed Seekables with the workload-defined SPI pieces
(Read / Update / Query from accord_tpu.api).  ``slice()`` produces the
per-shard PartialTxn; ``execute()`` / ``query()`` are the data-plane glue.
"""

from __future__ import annotations

from typing import Optional

from ..utils import invariants
from .keys import Ranges, Route, Seekables
from .timestamp import Domain, Timestamp, TxnId, TxnKind


class Txn:
    """Immutable client transaction (ref: Txn.java InMemory)."""

    __slots__ = ("kind", "keys", "read", "update", "query")

    def __init__(self, kind: TxnKind, keys: Seekables, read, update=None, query=None):
        self.kind = kind
        self.keys = keys
        self.read = read        # api.Read or None (sync points carry none)
        self.update = update    # api.Update or None
        self.query = query      # api.Query or None

    def domain(self) -> Domain:
        return self.keys.domain

    def slice(self, ranges: Ranges, include_query: bool) -> "PartialTxn":
        return PartialTxn(
            ranges, self.kind, self.keys.slice(ranges),
            self.read.slice(ranges) if self.read is not None else None,
            self.update.slice(ranges) if self.update is not None else None,
            self.query if include_query else None)

    def execute(self, txn_id: TxnId, execute_at: Timestamp, data):
        """Apply update to read data -> Writes (ref: Txn.java execute())."""
        from .writes import Writes
        if self.update is None:
            return Writes(txn_id, execute_at, self.keys, None)
        return Writes(txn_id, execute_at, self.update.keys(),
                      self.update.apply(execute_at, data))

    def result(self, txn_id: TxnId, execute_at: Timestamp, data):
        invariants.non_null(self.query, "txn has no query")
        return self.query.compute(txn_id, execute_at, self.keys, data,
                                  self.read, self.update)


class PartialTxn(Txn):
    """Txn sliced to covering ranges (ref: accord/primitives/PartialTxn.java)."""

    __slots__ = ("covering",)

    def __init__(self, covering: Ranges, kind: TxnKind, keys: Seekables,
                 read, update=None, query=None):
        super().__init__(kind, keys, read, update, query)
        self.covering = covering

    def covers(self, ranges: Ranges) -> bool:
        return self.covering.contains_all_ranges(ranges)

    def with_partial(self, other: Optional["PartialTxn"]) -> "PartialTxn":
        if other is None:
            return self
        if other.covering == self.covering:
            return self
        covering = self.covering.with_(other.covering)
        keys = self.keys.with_(other.keys)  # type: ignore[arg-type]
        read = self.read.merge(other.read) if self.read is not None else other.read
        update = self.update
        if update is None:
            update = other.update
        elif other.update is not None:
            update = update.merge(other.update)
        query = self.query if self.query is not None else other.query
        return PartialTxn(covering, self.kind, keys, read, update, query)

    def reconstitute(self, route: Route) -> Txn:
        invariants.check_state(self.covers_route(route), "incomplete txn for route")
        return Txn(self.kind, self.keys, self.read, self.update, self.query)

    def covers_route(self, route: Route) -> bool:
        parts = route.participants
        if isinstance(parts, Ranges):
            return self.covering.contains_all_ranges(parts)
        return all(self.covering.contains_token(t) for t in parts)
