"""Per-shard vote accumulators over Topologies.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/tracking/ —
AbstractTracker.java:37, QuorumTracker.java:27, FastPathTracker.java:34-90,
ReadTracker.java:40, RecoveryTracker.java, InvalidationTracker.java,
AppliedTracker.java.  A tracker owns one ShardTracker per (epoch, shard) and
folds responses from each node into all shards containing it; the aggregate
answers Success / Failed / NoChange.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..topology.shard import Shard
from ..topology.topology import Topologies
from ..utils import invariants


class RequestStatus(enum.Enum):
    NoChange = 0
    Success = 1
    Failed = 2


class ShardTracker:
    __slots__ = ("shard", "successes", "failures", "done", "failed")

    def __init__(self, shard: Shard):
        self.shard = shard
        self.successes: Set[int] = set()
        self.failures: Set[int] = set()
        self.done = False
        self.failed = False

    def has_reached_quorum(self) -> bool:
        return len(self.successes) >= self.shard.slow_path_quorum_size

    def has_failed(self) -> bool:
        return len(self.failures) > self.shard.max_failures


class AbstractTracker:
    """(ref: tracking/AbstractTracker.java:37)."""

    shard_tracker_cls = ShardTracker

    def __init__(self, topologies: Topologies):
        self.topologies = topologies
        self.trackers: List[ShardTracker] = []
        for topology in topologies:
            for shard in topology:
                self.trackers.append(self.shard_tracker_cls(shard))
        self.waiting_on_shards = len(self.trackers)
        self._status = RequestStatus.NoChange

    def nodes(self) -> Set[int]:
        return self.topologies.nodes()

    def _record(self, node: int,
                fn: Callable[[ShardTracker, int], RequestStatus]) -> RequestStatus:
        if self._status is not RequestStatus.NoChange:
            return RequestStatus.NoChange  # already terminal; report once only
        for t in self.trackers:
            if not t.shard.contains_node(node):
                continue
            # NB: decided shards still TALLY (ref AbstractTracker applies
            # the function unconditionally; exactly-once completion is the
            # done flag below) — RecoveryTracker's fast-path-reject count
            # must keep growing from replies landing after the shard's
            # quorum, or superseding_rejects() under-counts and recovery
            # completes a fast path that provably never happened
            outcome = fn(t, node)
            if outcome is RequestStatus.Failed and not t.done:
                self._status = RequestStatus.Failed
                return self._status
            if outcome is RequestStatus.Success and not t.done:
                t.done = True
                self.waiting_on_shards -= 1
        if self.waiting_on_shards == 0 and self._status is RequestStatus.NoChange:
            self._status = RequestStatus.Success
        return self._status if self.waiting_on_shards == 0 else RequestStatus.NoChange

    def status(self) -> RequestStatus:
        return self._status

    def all_shards(self, pred: Callable[[ShardTracker], bool]) -> bool:
        return all(pred(t) for t in self.trackers)

    def any_shard(self, pred: Callable[[ShardTracker], bool]) -> bool:
        return any(pred(t) for t in self.trackers)


class QuorumTracker(AbstractTracker):
    """(ref: tracking/QuorumTracker.java)."""

    def record_success(self, node: int) -> RequestStatus:
        def fn(t: ShardTracker, n: int) -> RequestStatus:
            t.successes.add(n)
            return (RequestStatus.Success if t.has_reached_quorum()
                    else RequestStatus.NoChange)
        return self._record(node, fn)

    def record_failure(self, node: int) -> RequestStatus:
        def fn(t: ShardTracker, n: int) -> RequestStatus:
            t.failures.add(n)
            return (RequestStatus.Failed if t.has_failed()
                    else RequestStatus.NoChange)
        return self._record(node, fn)


class FastPathShardTracker(ShardTracker):
    __slots__ = ("fast_path_accepts", "fast_path_rejects")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.fast_path_accepts: Set[int] = set()
        self.fast_path_rejects: Set[int] = set()

    def has_met_fast_path_criteria(self) -> bool:
        return len(self.fast_path_accepts) >= self.shard.fast_path_quorum_size

    def has_rejected_fast_path(self) -> bool:
        return self.shard.rejects_fast_path(len(self.fast_path_rejects))

    def is_decided(self) -> bool:
        """Fast path achieved, or rejected with a slow quorum in hand."""
        if self.has_met_fast_path_criteria():
            return True
        return self.has_rejected_fast_path() and self.has_reached_quorum()


class FastPathTracker(AbstractTracker):
    """(ref: tracking/FastPathTracker.java:34-90).  A shard completes when the
    fast-path decision is settled: fast quorum achieved, or fast path
    rejected and a slow-path quorum reached."""

    shard_tracker_cls = FastPathShardTracker

    def record_success(self, node: int, fast_path_vote: bool) -> RequestStatus:
        def fn(t: FastPathShardTracker, n: int) -> RequestStatus:
            t.successes.add(n)
            if n in t.shard.fast_path_electorate:
                if fast_path_vote:
                    t.fast_path_accepts.add(n)
                else:
                    t.fast_path_rejects.add(n)
            return RequestStatus.Success if t.is_decided() else RequestStatus.NoChange
        return self._record(node, fn)

    def record_failure(self, node: int) -> RequestStatus:
        def fn(t: FastPathShardTracker, n: int) -> RequestStatus:
            t.failures.add(n)
            if t.has_failed():
                return RequestStatus.Failed
            if n in t.shard.fast_path_electorate:
                t.fast_path_rejects.add(n)
            # the failure may be what settles the fast-path decision
            # (reject + existing slow quorum) — must report it or we hang
            return RequestStatus.Success if t.is_decided() else RequestStatus.NoChange
        return self._record(node, fn)

    def has_fast_path_accepted(self) -> bool:
        return self.all_shards(
            lambda t: t.has_met_fast_path_criteria())  # type: ignore[attr-defined]


class ReadShardTracker(ShardTracker):
    __slots__ = ("has_data", "inflight", "contacted")

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.has_data = False
        self.inflight: Set[int] = set()
        self.contacted: Set[int] = set()

    def candidates(self) -> List[int]:
        return [n for n in self.shard.nodes if n not in self.contacted]

    def has_failed_read(self) -> bool:
        return (not self.has_data and not self.inflight
                and not self.candidates())


class ReadTracker(AbstractTracker):
    """One-success-per-shard with alternatives on failure
    (ref: tracking/ReadTracker.java:40)."""

    shard_tracker_cls = ReadShardTracker

    def record_in_flight(self, node: int) -> None:
        for t in self.trackers:
            if t.shard.contains_node(node):
                t.inflight.add(node)      # type: ignore[attr-defined]
                t.contacted.add(node)     # type: ignore[attr-defined]

    def record_read_success(self, node: int) -> RequestStatus:
        def fn(t: ReadShardTracker, n: int) -> RequestStatus:
            t.inflight.discard(n)
            t.has_data = True
            return RequestStatus.Success
        return self._record(node, fn)

    def record_read_failure(self, node: int) -> Tuple[RequestStatus, List[int]]:
        """Returns (status, additional nodes to contact)."""
        to_contact: Set[int] = set()

        def fn(t: ReadShardTracker, n: int) -> RequestStatus:
            t.inflight.discard(n)
            t.failures.add(n)
            if t.has_data:
                return RequestStatus.Success
            cands = t.candidates()
            if not t.inflight and not cands:
                return RequestStatus.Failed
            if not t.inflight and cands:
                to_contact.add(cands[0])
            return RequestStatus.NoChange
        status = self._record(node, fn)
        return status, sorted(to_contact)


class RecoveryShardTracker(FastPathShardTracker):
    __slots__ = ("rejects_fast_path_votes",)

    def __init__(self, shard: Shard):
        super().__init__(shard)
        # replies claiming a later conflicting txn rejects our fast path
        self.rejects_fast_path_votes: Set[int] = set()


class RecoveryTracker(AbstractTracker):
    """(ref: tracking/RecoveryTracker.java).  Quorum per shard; additionally
    tallies whether enough electorate members reject the fast path that the
    original coordinator cannot have taken it."""

    shard_tracker_cls = RecoveryShardTracker

    def record_success(self, node: int, rejects_fast_path: bool) -> RequestStatus:
        def fn(t: RecoveryShardTracker, n: int) -> RequestStatus:
            t.successes.add(n)
            if rejects_fast_path and n in t.shard.fast_path_electorate:
                t.rejects_fast_path_votes.add(n)
            return (RequestStatus.Success if t.has_reached_quorum()
                    else RequestStatus.NoChange)
        return self._record(node, fn)

    def record_failure(self, node: int) -> RequestStatus:
        def fn(t: RecoveryShardTracker, n: int) -> RequestStatus:
            t.failures.add(n)
            return RequestStatus.Failed if t.has_failed() else RequestStatus.NoChange
        return self._record(node, fn)

    def superseding_rejects(self) -> bool:
        """True if some shard has enough electorate rejects that the original
        fast-path quorum cannot have existed (ref:
        tracking/RecoveryTracker.java rejectsFastPath: rejects >
        electorate - fastPathQuorumSize)."""
        for t in self.trackers:
            votes = len(t.rejects_fast_path_votes)  # type: ignore[attr-defined]
            if t.shard.rejects_fast_path(votes):
                return True
        return False


class InvalidationShardTracker(ShardTracker):
    __slots__ = ("promised",)

    def __init__(self, shard: Shard):
        super().__init__(shard)
        self.promised: Set[int] = set()


class InvalidationTracker(AbstractTracker):
    """(ref: tracking/InvalidationTracker.java): needs a promise quorum on
    ANY single shard to proceed with invalidation."""

    shard_tracker_cls = InvalidationShardTracker

    def record_promise(self, node: int) -> RequestStatus:
        def fn(t: InvalidationShardTracker, n: int) -> RequestStatus:
            t.successes.add(n)
            t.promised.add(n)
            return (RequestStatus.Success if t.has_reached_quorum()
                    else RequestStatus.NoChange)
        status = self._record(node, fn)
        # invalidation succeeds on first shard quorum
        if status is RequestStatus.NoChange and self.any_shard(
                lambda t: t.has_reached_quorum()):
            self._status = RequestStatus.Success
            return RequestStatus.Success
        return status

    def record_failure(self, node: int) -> RequestStatus:
        def fn(t: InvalidationShardTracker, n: int) -> RequestStatus:
            t.failures.add(n)
            return RequestStatus.Failed if t.has_failed() else RequestStatus.NoChange
        return self._record(node, fn)


class AllShardTracker(ShardTracker):
    """Success only when EVERY replica of the shard has responded."""

    def has_all(self) -> bool:
        return len(self.successes) >= len(self.shard.nodes)


class AllTracker(AbstractTracker):
    """Waits for every replica of every shard — any failure is terminal
    (ref: the reference AppliedTracker used by CoordinateShardDurable, which
    requires ALL replicas applied before declaring the shard durable)."""

    shard_tracker_cls = AllShardTracker

    def record_success(self, node: int) -> RequestStatus:
        def fn(t: AllShardTracker, n: int) -> RequestStatus:
            t.successes.add(n)
            return (RequestStatus.Success if t.has_all()
                    else RequestStatus.NoChange)
        return self._record(node, fn)

    def record_failure(self, node: int) -> RequestStatus:
        def fn(t: ShardTracker, n: int) -> RequestStatus:
            t.failures.add(n)
            return RequestStatus.Failed
        return self._record(node, fn)


class AppliedTracker(QuorumTracker):
    """Tracks Apply acknowledgements reaching a quorum per shard
    (ref: tracking/AppliedTracker.java)."""
