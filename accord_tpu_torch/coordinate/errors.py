"""Coordination failure hierarchy
(ref: accord-core/src/main/java/accord/coordinate/CoordinationFailed.java,
Timeout.java, Preempted.java, Invalidated.java, Truncated.java,
Exhausted.java, TopologyMismatch.java)."""

from __future__ import annotations

from ..primitives.timestamp import TxnId


class CoordinationFailed(RuntimeError):
    def __init__(self, txn_id: TxnId = None, msg: str = ""):
        super().__init__(msg or type(self).__name__)
        self.txn_id = txn_id


class Timeout(CoordinationFailed):
    pass


class Preempted(CoordinationFailed):
    pass


class Invalidated(CoordinationFailed):
    pass


class Truncated(CoordinationFailed):
    pass


class Rejected(CoordinationFailed):
    """Fenced by an ExclusiveSyncPoint (rejectBefore): this TxnId can never
    decide; retry the transaction with a fresh, higher TxnId.  ``floor`` is
    the rejecting fence's bound when known — the retry bumps the local HLC
    past it so the fresh id clears the fence (a drift-behind coordinator
    would otherwise re-issue doomed ids until its clock caught up)."""

    def __init__(self, txn_id: TxnId = None, msg: str = "", floor=None):
        super().__init__(txn_id, msg)
        self.floor = floor


class Exhausted(CoordinationFailed):
    pass


class StaleTopology(CoordinationFailed):
    pass


class TopologyMismatch(CoordinationFailed):
    pass


class RangeUnavailable(CoordinationFailed):
    pass
