"""Per-key last-executed timestamp witnesses.

Rebuild of ref: accord-core/src/main/java/accord/impl/TimestampsForKey.java —
tracks, per key, the latest executed timestamp and the latest executed WRITE
timestamp.  Its load-bearing role here is the executeAt-uniqueness invariant
at apply time: two distinct transactions must never execute at the same
timestamp on one key (the total order is unique), so a collision is
surfaced through Agent.on_inconsistent_timestamp rather than silently
reordering data.  (The reference plans to merge this structure into
CommandsForKey — its own "merge with TimestampsForKey" TODO — which already
tracks decided executeAts for the elision pivot here.)
"""

from __future__ import annotations

from typing import Dict, Optional

from ..primitives.timestamp import Timestamp, TxnId


class TimestampsForKey:
    """(ref: impl/TimestampsForKey.java)."""

    __slots__ = ("token", "last_executed_at", "last_executed_txn",
                 "last_write_at")

    def __init__(self, token: int):
        self.token = token
        self.last_executed_at: Optional[Timestamp] = None
        self.last_executed_txn: Optional[TxnId] = None
        self.last_write_at: Optional[Timestamp] = None

    def on_executed(self, safe, txn_id: TxnId,
                    execute_at: Timestamp) -> None:
        if self.last_executed_at is not None \
                and execute_at == self.last_executed_at \
                and txn_id != self.last_executed_txn:
            safe.agent().on_inconsistent_timestamp(
                txn_id, self.last_executed_at, execute_at)
        if self.last_executed_at is None or execute_at > self.last_executed_at:
            self.last_executed_at = execute_at
            self.last_executed_txn = txn_id
        if txn_id.kind().is_write() and (
                self.last_write_at is None or execute_at > self.last_write_at):
            self.last_write_at = execute_at

    def __repr__(self):
        return (f"TimestampsForKey({self.token}, "
                f"lastExec={self.last_executed_at})")


class TimestampsForKeys:
    """The per-store map (ref: impl/TimestampsForKeys.java)."""

    __slots__ = ("_by_token",)

    def __init__(self):
        self._by_token: Dict[int, TimestampsForKey] = {}

    def get(self, token: int) -> TimestampsForKey:
        t = self._by_token.get(token)
        if t is None:
            t = self._by_token[token] = TimestampsForKey(token)
        return t

    def if_present(self, token: int) -> Optional[TimestampsForKey]:
        return self._by_token.get(token)
