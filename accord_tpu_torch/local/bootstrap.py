"""Bootstrap: adoption of newly-owned ranges after reconfiguration.

Rebuild of ref: accord-core/src/main/java/accord/local/Bootstrap.java:81
(design comment :30-60).  When an epoch grants this node ranges it did not
previously replicate:

1. Mark ``bootstrapped_at`` in RedundantBefore for the ranges — transactions
   below the watermark are pre-bootstrap: excluded from deps, and their
   writes are NOT applied locally (the snapshot covers them).
2. Fence with an ExclusiveSyncPoint over the ranges: every earlier txn is
   decided, and each replica applies the fence only after they applied
   locally.
3. Fetch a DataStore snapshot from a donor replica of the previous epoch
   and install it.  The donor serves only after IT has locally applied the
   fence (messages/fetch_snapshot.py), so the snapshot contains every write
   executing below the fence.
4. Mark the ranges safe to read; until then reads are Nacked so the
   coordinator uses another replica (ref: safeToRead smearing,
   local/CommandStore.java:159-176).

Each attempt retries with the next donor on failure
(ref: Bootstrap.Attempt + Agent.onFailedBootstrap).
"""

from __future__ import annotations

from typing import List

from .. import api
from ..primitives.keys import Ranges
from ..primitives.timestamp import Domain, TxnId, TxnKind


class Bootstrap:
    """One bootstrap attempt set for one store's added ranges."""

    def __init__(self, store, ranges: Ranges, epoch: int):
        self.store = store
        self.node = store.node
        self.ranges = ranges
        self.epoch = epoch
        self.done = False

    def start(self) -> None:
        node = self.node
        if not getattr(node, "alive", True):
            # dead incarnation (restart): a surviving retry timer must not
            # write phantom bootstrap records into the shared journal — a
            # fresh fence recorded here would never coordinate (the dead
            # sink drops sends) yet would raise the restored pre-bootstrap
            # watermark past writes the real snapshot never covered
            return
        # don't waste a cluster-wide consensus round on the fence if the
        # prior epoch's topology (our donor source) is not yet known
        prev_epoch = self.epoch - 1
        if prev_epoch >= 1 and not node.topology().has_epoch(prev_epoch):
            node.with_epoch(prev_epoch, self.start)
            return
        # 1. watermark == the fence's own TxnId (ref: Bootstrap.java creates
        # the ExclusiveSyncPoint id first and uses IT as bootstrappedAt).
        # This identity matters: the deps floor prunes entries below
        # bootstrapped_at from PreAccept replies, and collectDeps adds the
        # boundary itself as a dependency — which must therefore be a REAL
        # coordinated txn whose deps transitively cover everything pruned.
        bootstrapped_at = node.next_txn_id(TxnKind.ExclusiveSyncPoint,
                                           Domain.Range)
        self._current_fence = bootstrapped_at
        self.store.redundant_before.add_bootstrapped(self.ranges, bootstrapped_at)
        self.store.bootstrapping = self.store.bootstrapping.with_(self.ranges)
        if node.journal is not None:
            # the watermark + in-progress marker are per-store persisted
            # fields (the reference stores RedundantBefore via its
            # integration's storage, not the message log)
            node.journal.record_bootstrap(self.store.store_id, self.ranges,
                                          self.epoch)
            node.journal.record_bootstrapped_at(self.store.store_id,
                                                self.ranges, bootstrapped_at)
        # 2. fence, coordinated AT the watermark id
        from ..coordinate.sync_point import coordinate_sync_point
        coordinate_sync_point(node, self.ranges, exclusive=True,
                              txn_id=bootstrapped_at) \
            .begin(self._on_fenced)

    def _on_fenced(self, sync_point, failure) -> None:
        if failure is not None:
            # invalidate the abandoned fence id before retrying with a fresh
            # one: replicas that witnessed it hold an undecided zombie dep
            # otherwise (see Node.invalidate_abandoned)
            self.node.invalidate_abandoned(self._current_fence, self.ranges)
            self.node.agent.on_failed_bootstrap("fence", self.ranges,
                                                self._retry, failure)
            return
        prev_epoch = self.epoch - 1
        if prev_epoch >= 1 and not self.node.topology().has_epoch(prev_epoch):
            # unknown prior-epoch topology is a retryable condition, NOT a
            # trivially-complete bootstrap: completing here would mark empty
            # ranges safe-to-read.  Wait for the epoch, then retry.
            self.node.agent.on_failed_bootstrap(
                "unknown-prev-epoch", self.ranges, self._retry,
                RuntimeError(f"topology for epoch {prev_epoch} not yet known"))
            return
        donors = self._donors()
        if not donors:
            # no prior-epoch replicas exist (fresh keyspace): trivially done
            self._complete()
            return
        fence = sync_point.sync_id if sync_point is not None else None
        self._fetch(donors, self.ranges, fence)

    def _donors(self) -> List[int]:
        """Replicas of these ranges in any epoch from the adoption epoch's
        predecessor up to the current predecessor, most recent first.  A
        single-epoch donor set wedges after further churn: a retry's fresh
        fence (current-epoch TxnId) never reaches a donor that no longer
        owns the ranges, so it can never serve — while recent owners both
        witness the fence and hold the data (their own bootstraps completed
        or they Nack via the unavailable-for-read gate and we move on)."""
        from ..impl.sorter import SizeOfIntersectionSorter
        manager = self.node.topology()
        donors: List[int] = []
        newest = max(self.epoch, self.node.epoch())
        for epoch in range(newest - 1, self.epoch - 2, -1):
            if epoch < 1 or not manager.has_epoch(epoch):
                continue
            prev = manager.get_topology_for_epoch(epoch)
            epoch_donors = {n for shard in prev.for_selection(self.ranges)
                            for n in shard.nodes if n != self.node.node_id}
            # within an epoch, widest-covering donors first: one snapshot
            # fetch can then cover the whole request
            for n in SizeOfIntersectionSorter.preferred(prev, epoch_donors,
                                                        self.ranges):
                if n not in donors:
                    donors.append(n)
        return donors

    def _fetch(self, donors: List[int], remaining: Ranges, fence,
               cycle: int = 0) -> None:
        """Fetch ``remaining`` from donors in turn; each donor may cover only
        part, so iterate until nothing remains.  Exhausting the donor list
        with data still missing re-polls the SAME fence after a short
        backoff (donors defer while the fence is unapplied locally; a fresh
        consensus round for a new fence is only needed if the fence itself
        died — the full-restart fallback after several dry cycles).
        ``fence`` is the ExclusiveSyncPoint TxnId the donor must have
        locally applied before serving (see messages/fetch_snapshot.py)."""
        from ..messages.fetch_snapshot import FetchSnapshot, FetchSnapshotOk
        node = self.node
        if not getattr(node, "alive", True):
            return
        if remaining.is_empty():
            self._complete()
            return
        if not donors:
            if cycle < 6:
                delay = 700_000 + node.random.next_int(600_000)
                node.scheduler.once(delay, lambda: self._fetch(
                    self._donors(), remaining, fence, cycle + 1))
                return
            self.node.agent.on_failed_bootstrap(
                "fetch", remaining, self._retry,
                RuntimeError(f"all donors exhausted with {remaining} missing"))
            return
        donor, rest = donors[0], donors[1:]
        outer = self

        class Cb(api.Callback):
            def on_success(self, from_id: int, reply) -> None:
                if outer.done:
                    return
                if isinstance(reply, FetchSnapshotOk):
                    node.data_store.install_snapshot(reply.snapshot)
                    outer._fetch(rest, remaining.without(reply.covered),
                                 fence, cycle)
                else:
                    outer._fetch(rest, remaining, fence, cycle)

            def on_failure(self, from_id: int, failure: BaseException) -> None:
                if outer.done:
                    return
                node.agent.on_handled_exception(failure)
                outer._fetch(rest, remaining, fence, cycle)

        node.send(donor, FetchSnapshot(remaining, self.epoch - 1, fence), Cb())

    def _complete(self) -> None:
        if not getattr(self.node, "alive", True):
            return
        self.done = True
        self.store.bootstrapping = self.store.bootstrapping.without(self.ranges)
        if self.node.journal is not None:
            self.node.journal.record_bootstrap_done(self.store.store_id,
                                                    self.ranges, self.epoch)
        if self.store.bootstrapping.is_empty():
            self.store.bootstrap_complete()

    def _retry(self) -> None:
        if not self.done:
            self.node.scheduler.once(500_000, self.start)
