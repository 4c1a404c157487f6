"""Per-key conflict index — the PreAccept hot structure.

Rebuild of ref: accord-core/src/main/java/accord/local/CommandsForKey.java:132
(TxnInfo ladder :293-410, mapReduceActive :614-650, mapReduceFull :553-612,
the missing[]/transitive-elision design comment :73-131).

This is the host (correctness) implementation: a sorted vector of TxnInfo per
key with the scan API.  The batched device analogue — the same scan as a
masked searchsorted/prefix kernel over the CSR key->txn adjacency, vmapped
over keys and in-flight txns — lives in accord_tpu.ops.deps_kernels and is
validated against this implementation.

Two compressions keep dep sets O(active) instead of O(history), both from
the reference's design comment (CommandsForKey.java:73-131):

- **missing[] encoding.**  The collection implies the deps of every command
  in it ("deps = every lower TxnId here"); each command stores only its
  DIVERGENCE — the lower TxnIds it did NOT witness — in ``TxnInfo.missing``.
  The invariant making later inserts cheap: when a command's deps freeze,
  every per-key dep id is ensured present in the collection (transitively
  witnessed if unseen), so any id inserted AFTER the freeze is guaranteed
  unwitnessed and is appended to the frozen command's missing.  Ids that
  reach Committed+ (or Invalidated) are elided from every missing array —
  recovery of a decided id never deciphers fast-path votes, which is the
  missing collection's only consumer.

- **Transitive-dependency elision.**  mapReduceActive skips any decided
  (Committed+) txn whose executeAt is below the latest committed WRITE
  executing before the query bound: depending on that later write reaches
  them transitively through its stable deps.  Recovery stays exact (see the
  reference's argument: any recovery quorum either reports the later write
  Stable — recovering its deps — or witnesses the earlier txn directly).
"""

from __future__ import annotations

import bisect
import enum
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..primitives.timestamp import Kinds, Timestamp, TxnId
from ..utils import invariants


class InternalStatus(enum.IntEnum):
    """Compressed per-key view of a txn's protocol state
    (ref: CommandsForKey.java InternalStatus)."""
    TRANSITIVELY_KNOWN = 0   # witnessed only via another txn's deps
    PREACCEPTED = 1
    ACCEPTED = 2
    COMMITTED = 3            # executeAt decided
    STABLE = 4
    APPLIED = 5
    INVALIDATED = 6

    def has_execute_at(self) -> bool:
        """ACCEPTED carries the proposed executeAt (recovery's accepted-
        no-witness reasoning needs it); COMMITTED+ the decided one."""
        return InternalStatus.ACCEPTED <= self <= InternalStatus.APPLIED


class TxnInfo:
    """(ref: CommandsForKey.java:293-410) — TxnId + per-key status +
    executeAt + the missing divergence (None until deps freeze)."""

    __slots__ = ("txn_id", "status", "execute_at", "missing")

    def __init__(self, txn_id: TxnId, status: InternalStatus,
                 execute_at: Optional[Timestamp] = None,
                 missing: Optional[List[TxnId]] = None):
        self.txn_id = txn_id
        self.status = status
        self.execute_at = execute_at if execute_at is not None else txn_id
        # sorted lower TxnIds this command did NOT witness; None = deps not
        # yet known here (witness queries must fall back to the Command)
        self.missing = missing

    def deps_known(self) -> bool:
        return self.missing is not None

    def witnesses_id(self, txn_id: TxnId) -> Optional[bool]:
        """Whether this command's per-key deps include txn_id; None if the
        collection cannot answer.  missing[] only records LOWER unwitnessed
        ids (the implied-deps convention covers only ids below this one), so
        membership of HIGHER ids — possible via accept-phase deps collected
        up to a later executeAt — must fall back to the Command record."""
        if self.missing is None or txn_id > self.txn_id:
            return None
        i = bisect.bisect_left(self.missing, txn_id)
        present_in_missing = i < len(self.missing) and self.missing[i] == txn_id
        return not present_in_missing

    def __repr__(self):
        return f"TxnInfo({self.txn_id}, {self.status.name})"


class CommandsForKey:
    """All (globally visible) transactions witnessed on one key, ordered by
    TxnId, with a parallel executeAt-ordered view of committed txns."""

    __slots__ = ("token", "_ids", "_infos", "prune_before",
                 "_committed_write_execs", "_n_unwitnessable",
                 "_elide_version", "_packed_cw")

    def __init__(self, token: int):
        self.token = token
        self._ids: List[TxnId] = []        # sorted
        self._infos: Dict[TxnId, TxnInfo] = {}
        # txns with txnId < prune_before are redundant (covered by
        # RedundantBefore) and excluded from deps
        self.prune_before: Optional[TxnId] = None
        # executeAts of decided (Committed+) writes, sorted — the elision
        # pivot lookup must not rescan the whole history on the hot path
        # (ref: the committed[] executeAt-ordered array, CommandsForKey.java)
        self._committed_write_execs: List[Timestamp] = []
        # count of TRANSITIVELY_KNOWN/INVALIDATED entries: when 0 AND no
        # committed-write pivot exists below the bound, NOTHING on this key
        # can elide — the batched device attribution skips per-dep elision
        # lookups wholesale (see can_elide)
        self._n_unwitnessable = 0
        # monotone counter of _committed_write_execs CONTENT mutations —
        # keys the packed-pivot-array cache the device/host batch elision
        # consumes.  A length-based key is NOT sound: a decided write's
        # executeAt moving (r14 find) keeps the length while changing the
        # pivot content
        self._elide_version = 0
        self._packed_cw = None   # (_elide_version, (msb, lsb, node) i64/i32)

    def _cw_mutated(self) -> None:
        self._elide_version += 1
        self._packed_cw = None

    def packed_committed_execs(self):
        """The elision pivot list as three numpy columns (msb, lsb int64;
        node int32), ascending in the SAME order the Timestamp objects
        sort (unsigned on the packed words) — the per-key building block
        of the batched elision index (device_index._attr_elide_index).
        Cached per _elide_version; rebuild is O(n) over a per-key list."""
        import numpy as np

        from ..ops.packing import to_i64
        hit = self._packed_cw
        if hit is not None and hit[0] == self._elide_version:
            return hit[1]
        n = len(self._committed_write_execs)
        m = np.empty(n, np.int64)
        l = np.empty(n, np.int64)
        nd = np.empty(n, np.int32)
        for i, ts in enumerate(self._committed_write_execs):
            m[i] = to_i64(ts.msb)
            l[i] = to_i64(ts.lsb)
            nd[i] = ts.node
        packed = (m, l, nd)
        self._packed_cw = (self._elide_version, packed)
        return packed

    # -- update path --------------------------------------------------------
    def update(self, txn_id: TxnId, status: InternalStatus,
               execute_at: Optional[Timestamp] = None,
               witnessed_deps: Optional[List[TxnId]] = None) -> None:
        """Witness or advance a txn on this key
        (ref: CommandsForKey insert/update :652+).  ``witnessed_deps`` is
        the command's per-key dep ids when its deps freeze (accept/commit):
        it drives the missing[] maintenance."""
        if not txn_id.kind().is_globally_visible():
            return
        info = self._infos.get(txn_id)
        if info is None:
            info = TxnInfo(txn_id, status, execute_at)
            self._infos[txn_id] = info
            bisect.insort(self._ids, txn_id)
            self._on_inserted(txn_id, status)
            if status in (InternalStatus.TRANSITIVELY_KNOWN,
                          InternalStatus.INVALIDATED):
                self._n_unwitnessable += 1
            if InternalStatus.COMMITTED <= status <= InternalStatus.APPLIED \
                    and txn_id.kind().is_write():
                bisect.insort(self._committed_write_execs, info.execute_at)
                self._cw_mutated()
        else:
            prev = info.status
            info.status = max(info.status, status)   # never regress
            was_un = prev in (InternalStatus.TRANSITIVELY_KNOWN,
                              InternalStatus.INVALIDATED)
            now_un = info.status in (InternalStatus.TRANSITIVELY_KNOWN,
                                     InternalStatus.INVALIDATED)
            if was_un != now_un:
                self._n_unwitnessable += 1 if now_un else -1
            # the executeAt may only advance with the status grade: a late
            # ACCEPTED-grade update carrying a *proposed* executeAt must not
            # regress the decided executeAt of a COMMITTED+ entry (it would
            # skew the elision pivot and recovery scans) — guard here rather
            # than relying on every caller's ordering guards
            if execute_at is not None and status.has_execute_at() \
                    and (status >= prev or prev < InternalStatus.COMMITTED) \
                    and execute_at != info.execute_at:
                if InternalStatus.COMMITTED <= prev <= InternalStatus.APPLIED \
                        and txn_id.kind().is_write():
                    # r14 torture-rig find: a decided-grade update moving an
                    # already-indexed write's executeAt left the OLD value in
                    # _committed_write_execs and never inserted the new one —
                    # elision then pivots on a ghost timestamp.  Keep the
                    # pivot list in lockstep with the executeAt it indexes.
                    i = bisect.bisect_left(self._committed_write_execs,
                                           info.execute_at)
                    if i < len(self._committed_write_execs) \
                            and self._committed_write_execs[i] == info.execute_at:
                        del self._committed_write_execs[i]
                    bisect.insort(self._committed_write_execs, execute_at)
                    self._cw_mutated()
                info.execute_at = execute_at
            if info.status is InternalStatus.INVALIDATED \
                    and InternalStatus.COMMITTED <= prev <= InternalStatus.APPLIED \
                    and txn_id.kind().is_write():
                # illegal in a healthy run (commit_invalidate guards it) but
                # a stale pivot from an invalidated write must never elide
                # genuinely-live deps
                i = bisect.bisect_left(self._committed_write_execs,
                                       info.execute_at)
                if i < len(self._committed_write_execs) \
                        and self._committed_write_execs[i] == info.execute_at:
                    del self._committed_write_execs[i]
                    self._cw_mutated()
            if prev < InternalStatus.COMMITTED and (
                    info.status >= InternalStatus.COMMITTED):
                # decided: elide from every missing array — recovery of a
                # decided id never needs fast-path witness info
                # (ref: the missing-elision rule, CommandsForKey.java:82-88)
                self._elide_from_missing(txn_id)
                if info.status is not InternalStatus.INVALIDATED \
                        and txn_id.kind().is_write():
                    bisect.insort(self._committed_write_execs, info.execute_at)
                    self._cw_mutated()
        if witnessed_deps is not None:
            # (re)freeze: a higher-ballot accept or the commit may carry a
            # different proposal — last-wins, recomputed vs the collection
            self._freeze_deps(info, witnessed_deps)

    def _freeze_deps(self, info: TxnInfo, witnessed_deps: List[TxnId]) -> None:
        """The command's per-key deps are now fixed: ensure every dep id is
        present (transitively witnessed) so later inserts are provably
        unwitnessed, then record the divergence."""
        witnessed = set()
        for d in witnessed_deps:
            if d == info.txn_id:
                continue
            witnessed.add(d)
            # sync points are range-domain: they never enter a per-key index
            # (ref: the CommandsForKey invariant that key deps on
            # (Exclusive)SyncPoints are not added) — without this, every
            # boundary fence dep lands in EVERY key's collection as a
            # transitive entry and the index grows with fence history
            if not d.kind().is_sync_point():
                self.witness_transitive(d)
        kinds = info.txn_id.kind().witnesses()
        hi = bisect.bisect_left(self._ids, info.txn_id)
        missing = []
        for i in range(hi):
            tid = self._ids[i]
            if tid in witnessed or not kinds.test(tid.kind()):
                continue
            other = self._infos[tid]
            if other.status >= InternalStatus.COMMITTED:
                continue   # decided (or invalidated): elided
            missing.append(tid)
        info.missing = missing

    def _on_inserted(self, txn_id: TxnId, status: InternalStatus) -> None:
        """A new id entered the collection: every LATER command whose deps
        are already frozen is guaranteed not to have witnessed it (its dep
        ids were all ensured present at freeze time)."""
        if status >= InternalStatus.COMMITTED:
            return   # decided on arrival: elided everywhere
        lo = bisect.bisect_right(self._ids, txn_id)
        for i in range(lo, len(self._ids)):
            info = self._infos[self._ids[i]]
            if info.missing is None:
                continue
            if not info.txn_id.kind().witnesses().test(txn_id.kind()):
                continue
            j = bisect.bisect_left(info.missing, txn_id)
            if j >= len(info.missing) or info.missing[j] != txn_id:
                info.missing.insert(j, txn_id)

    def _elide_from_missing(self, txn_id: TxnId) -> None:
        lo = bisect.bisect_right(self._ids, txn_id)
        for i in range(lo, len(self._ids)):
            info = self._infos[self._ids[i]]
            if not info.missing:
                continue
            j = bisect.bisect_left(info.missing, txn_id)
            if j < len(info.missing) and info.missing[j] == txn_id:
                del info.missing[j]

    def witness_transitive(self, txn_id: TxnId) -> None:
        if self.prune_before is not None and txn_id < self.prune_before:
            return   # decided+applied everywhere: never re-enters the index
        if txn_id.kind().is_globally_visible() and txn_id not in self._infos:
            self._infos[txn_id] = TxnInfo(txn_id,
                                          InternalStatus.TRANSITIVELY_KNOWN)
            bisect.insort(self._ids, txn_id)
            self._on_inserted(txn_id, InternalStatus.TRANSITIVELY_KNOWN)
            self._n_unwitnessable += 1

    def remove(self, txn_id: TxnId) -> None:
        info = self._infos.get(txn_id)
        if info is not None:
            if info.status in (InternalStatus.TRANSITIVELY_KNOWN,
                               InternalStatus.INVALIDATED):
                self._n_unwitnessable -= 1
            if InternalStatus.COMMITTED <= info.status <= InternalStatus.APPLIED \
                    and txn_id.kind().is_write():
                # r14 torture-rig find: the pivot followed the entry out of
                # the index only when a LATER prune happened to drop
                # something (the cut==0 early return skipped the rebuild) —
                # until then elision pivoted on a write no scan can return.
                # Retract it with the entry: conservative (more deps
                # scanned), and the pivot list's invariant becomes simply
                # "the decided writes present in the index".
                i = bisect.bisect_left(self._committed_write_execs,
                                       info.execute_at)
                if i < len(self._committed_write_execs) \
                        and self._committed_write_execs[i] == info.execute_at:
                    del self._committed_write_execs[i]
                    self._cw_mutated()
            del self._infos[txn_id]
            i = bisect.bisect_left(self._ids, txn_id)
            if i < len(self._ids) and self._ids[i] == txn_id:
                del self._ids[i]

    def set_prune_before(self, txn_id: TxnId) -> None:
        if self.prune_before is None or txn_id > self.prune_before:
            self.prune_before = txn_id

    def prune(self) -> int:
        """Physically drop entries below the prune watermark — the shard
        watermark guarantees everything below it has applied (or been
        invalidated) at every replica, so no dep set or recovery query needs
        them (ref: CommandsForKey.java prune vs RedundantBefore).  Returns
        #entries dropped."""
        if self.prune_before is None:
            return 0
        cut = bisect.bisect_left(self._ids, self.prune_before)
        if cut == 0:
            return 0
        dropped = self._ids[:cut]
        for tid in dropped:
            del self._infos[tid]
        del self._ids[:cut]
        # their missing entries are dead weight now
        for tid in dropped:
            self._elide_from_missing(tid)
        # rebuild the pivot list (prune is rare; the hot path stays O(log n))
        self._committed_write_execs = sorted(
            info.execute_at for info in self._infos.values()
            if InternalStatus.COMMITTED <= info.status <= InternalStatus.APPLIED
            and info.txn_id.kind().is_write())
        self._cw_mutated()
        self._n_unwitnessable = sum(
            1 for info in self._infos.values()
            if info.status in (InternalStatus.TRANSITIVELY_KNOWN,
                               InternalStatus.INVALIDATED))
        return cut

    def may_elide_any(self) -> bool:
        """Monotone pre-filter for the batch attribution: False when no
        entry on this key can be elided for ANY bound (no committed writes
        recorded, no unwitnessable entries) — the common key skips the
        per-bound pivot lookup entirely."""
        return bool(self._committed_write_execs) or self._n_unwitnessable > 0

    def can_elide(self, bound: Timestamp):
        """Batch fast-path for the device attribution: returns None when NO
        entry on this key can be elided for ``bound`` (no unwitnessable
        entries and no committed-write pivot below the bound), else the
        pivot to pass to is_elided."""
        pivot = self.max_committed_write_before(bound)
        if pivot is None and self._n_unwitnessable == 0:
            return None
        return pivot if pivot is not None else Timestamp.NONE

    # -- scan API -----------------------------------------------------------
    def max_committed_write_before(self, bound: Timestamp) -> Optional[Timestamp]:
        """The latest executeAt of a decided (Committed+) WRITE executing
        before ``bound`` — the transitive-elision pivot, answered from the
        incrementally-maintained executeAt-sorted list in O(log n)
        (ref: mapReduceActive's maxCommittedBefore over the committed[]
        array, CommandsForKey.java:614)."""
        i = bisect.bisect_left(self._committed_write_execs, bound)
        return self._committed_write_execs[i - 1] if i > 0 else None

    def is_elided(self, info: TxnInfo, bound: Timestamp,
                  pivot: Optional[Timestamp] = None) -> bool:
        """The one active-scan skip rule, shared by the host fold and the
        device query attribution (keep them in lockstep): transitively-known
        and invalidated entries never appear; decided entries executing
        below the latest decided write before ``bound`` are reached through
        that write's stable deps."""
        if info.status in (InternalStatus.INVALIDATED,
                           InternalStatus.TRANSITIVELY_KNOWN):
            return True
        if InternalStatus.COMMITTED <= info.status <= InternalStatus.APPLIED:
            if pivot is None:
                pivot = self.max_committed_write_before(bound)
            return pivot is not None and info.execute_at < pivot
        return False

    def map_reduce_active(self, started_before: Timestamp, witnesses: Kinds,
                          fn: Callable[[TxnId, "object"], "object"], acc):
        """Fold over active txns with txnId < started_before whose kind the
        querying txn must witness (ref: CommandsForKey.java:614-650).
        Skips invalidated and transitively-known txns, anything below the
        prune watermark, and — the transitive elision — decided txns whose
        executeAt is below the latest committed write before the bound."""
        hi = bisect.bisect_left(self._ids, started_before)
        lo = 0
        if self.prune_before is not None:
            lo = bisect.bisect_left(self._ids, self.prune_before)
        pivot = self.max_committed_write_before(started_before)
        for i in range(lo, hi):
            tid = self._ids[i]
            info = self._infos[tid]
            if self.is_elided(info, started_before, pivot):
                continue
            if not witnesses.test(tid.kind()):
                continue
            acc = fn(tid, acc)
        return acc

    def map_reduce_full(self, test_txn_id: TxnId, witnesses: Kinds,
                        fn: Callable[[TxnInfo, "object"], "object"], acc):
        """Fold over ALL txns (any bound, any status) for recovery queries
        (ref: CommandsForKey.java:553-612)."""
        for tid in list(self._ids):
            info = self._infos[tid]
            if not witnesses.test(tid.kind()):
                continue
            acc = fn(info, acc)
        return acc

    # -- queries ------------------------------------------------------------
    def get(self, txn_id: TxnId) -> Optional[TxnInfo]:
        return self._infos.get(txn_id)

    def size(self) -> int:
        return len(self._ids)

    def txn_ids(self) -> List[TxnId]:
        return list(self._ids)

    def max_committed_execute_at(self) -> Optional[Timestamp]:
        best: Optional[Timestamp] = None
        for info in self._infos.values():
            if info.status.has_execute_at() or info.status is InternalStatus.APPLIED:
                if best is None or info.execute_at > best:
                    best = info.execute_at
        return best

    def max_applied_before(self, bound: Timestamp) -> Optional[Timestamp]:
        best: Optional[Timestamp] = None
        for info in self._infos.values():
            if info.status is InternalStatus.APPLIED and info.execute_at < bound:
                if best is None or info.execute_at > best:
                    best = info.execute_at
        return best

    def last_witnessed(self) -> Optional[TxnId]:
        return self._ids[-1] if self._ids else None

    def __repr__(self):
        return f"CommandsForKey({self.token}, n={len(self._ids)})"
