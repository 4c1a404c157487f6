"""Bootstrap snapshot transfer.

Rebuild of ref: accord-core/src/main/java/accord/impl/
AbstractFetchCoordinator.java:59 (FetchRequest/FetchResponse) — the data
plane of bootstrap: a joining replica asks a donor for its DataStore content
over the adopted ranges.  The control-plane fence (ExclusiveSyncPoint before
the fetch) lives in local/bootstrap.py.

The donor does NOT serve the snapshot from whatever state it happens to
hold: the reference's FetchRequest extends ReadData with
``ReadType.waitUntilApplied`` — the reply is gated until the donor has
locally applied everything ordered below the fence.  We implement the same
gate by shipping the fence sync point's TxnId with the request and waiting
until that txn has Applied on every intersecting local store (its WaitingOn
drain guarantees all earlier intersecting txns applied first).  Without this
the fence only guarantees application at its read quorum, which need not
include this donor, and any write missing from the snapshot would be lost on
the joiner forever (pre-bootstrap writes are never applied there).
"""

from __future__ import annotations

from typing import Optional

from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import Status
from ..primitives.keys import Ranges
from ..primitives.timestamp import TxnId
from ..utils import async_chain
from .base import MessageType, Reply, Request


class FetchSnapshotOk(Reply):
    type = MessageType.FETCH_DATA_RSP

    def __init__(self, snapshot, covered: Ranges):
        self.snapshot = snapshot
        self.covered = covered   # the sub-ranges this donor actually holds

    def is_ok(self) -> bool:
        return True

    def __repr__(self):
        return f"FetchSnapshotOk(covered={self.covered})"


class FetchSnapshotNack(Reply):
    type = MessageType.FETCH_DATA_RSP

    def is_ok(self) -> bool:
        return False

    def __repr__(self):
        return "FetchSnapshotNack"


def await_applied(safe: SafeCommandStore, txn_id: TxnId,
                  participants=None) -> async_chain.AsyncChain:
    """Settle once ``txn_id`` has Applied (or been invalidated/truncated) on
    this store.  If the txn has not arrived yet a transient listener waits
    for it AND the store's progress log is told to fetch it — a donor that
    was dropped from the fence's epoch window would otherwise never witness
    it and hang every snapshot request forever.  The requester's callback
    timeout bounds the joiner-side wait either way."""
    out: async_chain.AsyncResult = async_chain.AsyncResult()

    def is_done(cmd) -> bool:
        return cmd is not None and (
            cmd.is_invalidated() or cmd.is_truncated()
            or cmd.has_been(Status.Applied))

    if is_done(safe.if_present(txn_id)):
        out.set_success(None)
        return out

    def listener(s: SafeCommandStore, updated) -> None:
        if is_done(updated):
            s.remove_transient_listener(txn_id, listener)
            out.set_success(None)

    safe.add_transient_listener(txn_id, listener)
    if participants is not None:
        # actively pull the fence's outcome (commit/apply) from its replicas
        safe.progress_log().waiting(txn_id, 0, None, participants)
    return out


class FetchSnapshot(Request):
    """(ref: AbstractFetchCoordinator.FetchRequest)."""

    type = MessageType.FETCH_DATA_REQ
    # deliberately NOT a slow read: the donor defers its reply until the
    # fence applies locally, which can be arbitrarily late — the joiner
    # polls on a short timeout instead of hanging a whole slow-read window
    # on one donor (Bootstrap._fetch re-asks; a late donor reply to a dead
    # callback is harmless)
    is_slow_read = False

    def __init__(self, ranges: Ranges, epoch: int,
                 fence_txn_id: Optional[TxnId] = None):
        self.ranges = ranges
        self.epoch = epoch
        self.fence_txn_id = fence_txn_id
        self.wait_for_epoch = epoch

    def process(self, node, from_id: int, reply_context) -> None:
        owned = node.topology().get_topology_for_epoch(self.epoch) \
            .ranges_for_node(node.node_id)
        covered = self.ranges.intersecting(owned)
        if covered.is_empty():
            node.reply(from_id, reply_context, FetchSnapshotNack())
            return
        # A donor that is ITSELF still bootstrapping these ranges would
        # serve an empty/incomplete DataStore (its own fence clears
        # pre-bootstrap deps, so fence-applied does not imply data present).
        # Same gate as reads: Nack so the joiner uses a settled donor.
        if node.command_stores.unavailable_for_read(covered):
            node.reply(from_id, reply_context, FetchSnapshotNack())
            return

        def snapshot_and_reply(_value=None, failure=None) -> None:
            if failure is not None:
                node.message_sink.reply_with_unknown_failure(
                    from_id, reply_context, failure)
                return
            # a donor may hold only part of the request: it reports exactly
            # what it covered so the joiner fetches the remainder elsewhere
            snapshot = node.data_store.snapshot(covered)
            node.reply(from_id, reply_context,
                       FetchSnapshotOk(snapshot, covered))

        fence = self.fence_txn_id
        if fence is None:
            snapshot_and_reply()
            return
        stores = node.command_stores.intersecting(
            covered, self.epoch, max(self.epoch, fence.epoch()))
        if not stores:
            snapshot_and_reply()
            return
        # Note: a donor dropped from the fence's epoch still converges — the
        # sync-point propagate window in coordinate/fetch_data.py extends one
        # epoch below the fence's, and await_applied's progress-log fetch
        # pulls the fence if the direct Apply was lost (Apply itself is NOT
        # widened; see the window note in messages/apply.py).  The joiner's
        # callback timeout bounds the wait either way; it moves to the next
        # donor on timeout.
        chains = [s.execute(PreLoadContext.for_txn(fence),
                            lambda safe: await_applied(safe, fence, covered))
                  for s in stores]
        async_chain.all_of(chains).flat_map(async_chain.all_of) \
            .begin(snapshot_and_reply)

    def __repr__(self):
        return f"FetchSnapshot({self.ranges}@{self.epoch}, fence={self.fence_txn_id})"
