"""Device-backed conflict index + execution drain for a CommandStore, on
PyTorch and CUDA.

The port of ``accord_tpu/local/device_index.py``, on one device and on a
mesh of slices (below): every globally-visible transaction a store
witnesses is registered in a struct-of-arrays DepsTable slot kept
incrementally in sync with the host command state;
PreAccept/Accept/BeginRecovery dependency scans run as batched kernel
launches (ops.kernels: deps_bucketed / deps_dense, then attr_post); the
executeAt-gated execution drain is driven by the frontier sweep
(frontier_dense / frontier_ell) over a live adjacency graph instead of
per-dependency listener fan-out.

Ref semantics preserved:
 - deps scan: accord-core/src/main/java/accord/local/CommandsForKey.java:614-650
   (mapReduceActive) + InMemoryCommandStore.java:863-877 (range scan) +
   messages/PreAccept.java:245-265 (calculatePartialDeps)
 - drain: local/Commands.java:656-857 (maybeExecute /
   updateDependencyAndMaybeExecute / NotifyWaitingOn)

Host numpy mirrors are the source of truth (the sim mutates them in place,
deterministically, under the store's single-threaded task queue).  The
device tables are refreshed by scatter-updating only dirty rows (the
scatter_rows kernel), so they stay resident between queries.  The scatter
writes IN PLACE (JAX's scatter is functional): a pipelined query, which may
re-read its table on an escalated re-launch after later registrations, holds
a lease on it until it is collected, and a scatter into a leased table
copies it first (copy on write), so a re-launch answers for the table as it
was at begin.  The host command records remain authoritative
for execution: the kernel proposes the ready frontier, and each candidate
is re-validated against its WaitingOn bitset before executing.

Every batched deps scan is routed per flush to the cheapest of three
routes, all bit-identical by construction:

 - **host**: a vectorized numpy interval scan over the live-above-floor
   tail (the same code as the reference);
 - **bucketed** (device): the bucket index, O(candidates) per query;
 - **dense** (device): the exact O(N) scan, for wide queries and when the
   straggler list defeats bucketing.

The device kernels answer with exact overlap-triple CSRs, pre-attributed
(floors, elision, key dedupe) by the attribution kernel; the download is
two-stage (header, then only the live entry prefix).  The crossover is
priced from a once-per-process probe of the port's own kernels on the
store's device (``_measure_route_calibration``); ``route_override`` pins a
route.

Device-fault tolerance: every type in ``utils.faults.DEVICE_EXCEPTIONS``
quarantines the device routes and fails the flush over to the host route,
with the same bytes:

    device route -> quarantine -> host route -> compaction -> backpressure

Those are the injected device-fault family, MemoryError, and the real
CUDA errors a process survives: a launch the runtime refuses for want of
resources (``faults.CudaLaunchError`` from ``ops.kernels._launch``) and
device memory exhausted (``torch.OutOfMemoryError``, e.g. from a kernel
wrapper's ``torch.empty``).  Any other return code of the kernel library
(an invalid argument, no image for this card) is a build or wrapper fault
and propagates; so do errors that only show at synchronisation (a
kernel's illegal address, a device-side assert: ``torch.AcceleratorError``
from the download in ``_host``), which poison the CUDA context, so no
fail-over inside the process could survive them.

Fused multi-store launches (driven by ``local.dispatch``'s per-node
DeviceDispatcher): ``fused_eligible`` / ``fused_commit`` prepare a store's
pending flush for one store-tagged attributed launch over S stores,
``fused_harvest`` parses this store's block in its own store task; a
launched member leases its device table and attribution columns until its
harvest, so an escalated re-launch reads them as of dispatch.  The drain
tick serves a dispatcher-fused frontier sweep when handed one, and widens
its candidate set to the next W executeAt levels (the log-depth level
pass) while whole candidate sets apply synchronously; ``ACCORD_TPU_DRAIN=
fixpoint`` keeps W at 1.

Under a mesh (``parallel.sharded.Mesh``: the largest power of two of the
visible CUDA devices, or one pinned by the ``mesh`` argument, e.g. d
slices of one card) the slot table is sharded by slot and the bucket
index by row: the ``sharded`` and ``sharded_bucketed`` kinds run each
slice's kernels and merge the attributed blocks on device (K12), and a
store whose table outgrows the per-device budget spills to the
store-sharded residency (``parallel.store_shard``) with a per-slice
quarantine ladder whose ``host_slice`` twin answers for a sick slice's
slots.  The drain tick row-shards its frontier sweep when the mesh is
priced cheaper (mode ``mesh``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..obs import devprof
from ..ops import deps_kernel as dk
from ..ops import drain_kernel as drk
from ..ops import kernels
from ..ops.packing import to_i64
from ..primitives.keys import Range, Ranges
from ..primitives.timestamp import Domain, Kinds, Timestamp, TxnId
from ..utils import faults
from ..utils.random_source import RandomSource

_MIN_CAPACITY = 64
_MIN_INTERVALS = 4


def _pow2_at_least(n: int, floor: int = _MIN_INTERVALS) -> int:
    out = floor
    while out < n:
        out *= 2
    return out



def _grow(arr: np.ndarray, new_len: int, fill) -> np.ndarray:
    out = np.full((new_len,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


_FETCH_POOL = None


def _fetch_pool():
    """Shared two-worker pool for the two-stage download prefetch: the
    pipelined path keeps at most two flushes in flight, and spawning a
    fresh thread per flush measured ~2ms/batch of pure start_new_thread
    on the 2-core box — a fifth of the whole headline batch budget."""
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _FETCH_POOL = ThreadPoolExecutor(max_workers=2,
                                         thread_name_prefix="accord-fetch")
    return _FETCH_POOL


def _prefix_len(maxtot: int, s: int) -> int:
    """Length of the live entry prefix to transfer, rounded up to a coarse
    granularity so the device-side slice compiles a bounded number of
    shapes (at most ~16 per learned ``s``) instead of one per total."""
    gran = max(128, s >> 4)
    return min(s, -(-maxtot // gran) * gran)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host column onto the store's device (a copy, never a view)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _upload_sharded(a: np.ndarray, mesh) -> tuple:
    """One host column as a sharded array: its row slices, slice i
    uploaded to mesh device i."""
    d = mesh.size
    n = a.shape[0] // d
    return tuple(_upload(a[i * n:(i + 1) * n], dev)
                 for i, dev in enumerate(mesh.devices))


def _host(t: torch.Tensor) -> np.ndarray:
    """Download one device tensor (synchronises with its stream)."""
    return t.cpu().numpy()


def _host_written(t: torch.Tensor, device: torch.device) -> np.ndarray:
    """A view of pinned host tensor ``t`` once the kernel that writes it
    on ``device`` has run: one synchronisation of the device's current
    stream, no copy."""
    torch.cuda.current_stream(device).synchronize()
    return t.numpy()


def _fetch_entry_prefix(ent_dev, d: int, s: int, maxtot: int) -> np.ndarray:
    """Stage-2 of the compacted download: transfer ONLY the live prefix of
    the entry block (the pow2-padded tail never crosses the wire).
    Returns host [d, L]."""
    length = _prefix_len(maxtot, s)
    if length == 0:
        return np.zeros((d, 0), _host(ent_dev[:0]).dtype)
    if d == 1:
        return _host(ent_dev[:length]).reshape(1, length)
    return _host(ent_dev.reshape(d, s)[:, :length])


def _decode_triples(hdr: np.ndarray, ent: np.ndarray, nq: int,
                    shard_n: int, global_ids: bool, mq: int, q_m: int,
                    hoff: int = 2):
    """Vectorized parse of a (possibly multi-shard) exact CSR download:
    one concatenate/gather over the stacked shard headers replaces the
    per-shard Python parse loop.  Returns per-TRIPLE arrays
    (b, slot, dep_col, q_col); slot indices are shard-local for the
    slot-sharded kernels (offset by the shard's slice here) and GLOBAL
    for the bucket-indexed kernels (codes embed global slot ids).
    ``hoff`` is the header's scalar prefix length (2 raw, 5 attributed)."""
    d = hdr.shape[0]
    counts = np.diff(hdr[:, hoff:].astype(np.int64), prepend=0, axis=1)
    totals = hdr[:, 0].astype(np.int64)
    b = np.repeat(np.tile(np.arange(nq, dtype=np.int64), d),
                  counts.reshape(-1))
    live = np.arange(ent.shape[1])[None, :] < totals[:, None]
    j, m_i, q_i = dk.decode_triples(ent[live], mq // q_m, q_m)
    if not global_ids and d > 1:
        j = j + np.repeat(np.arange(d, dtype=np.int64) * shard_n, totals)
    return b, j, m_i, q_i


def _tri_pairs(tb: np.ndarray, tj: np.ndarray):
    """Derive the exact (query, slot) pair list from triple arrays whose
    (b, j) runs are contiguous (true per shard block by the kernels' code
    sort, and preserved by concatenation because shard/part pair sets are
    disjoint).  Returns (b_idx, j_idx, p_i) with p_i mapping each triple
    to its pair row — the shape attribution consumes."""
    n = len(tb)
    first = np.ones(n, bool)
    if n:
        first[1:] = (tb[1:] != tb[:-1]) | (tj[1:] != tj[:-1])
    p_i = np.cumsum(first) - 1
    return tb[first], tj[first], p_i


def _host_index_of(status, lo_a, hi_a, msb, lsb, node, fkey):
    """Build the host-route index (see _DepsMirror.host_index) from
    explicit arrays — shared by the live cached path and the snapshot-based
    fused fallback/shadow path.  ``fkey`` is the normalized floor (None =
    no floor)."""
    live = (status >= 0) & (status != dk.SLOT_INVALIDATED)
    if fkey is not None:
        from ..ops.packing import to_u64
        fm = np.uint64(to_u64(to_i64(fkey.msb)))
        fl = np.uint64(to_u64(to_i64(fkey.lsb)))
        fn = np.int32(fkey.node)
        um = msb.astype(np.uint64)
        ul = lsb.astype(np.uint64)
        live &= ((um > fm) | ((um == fm)
                             & ((ul > fl) | ((ul == fl) & (node >= fn)))))
    j = np.nonzero(live)[0]
    lo, hi = lo_a[j], hi_a[j]
    used = lo <= hi
    pt = used & (lo == hi)
    rr, cc = np.nonzero(pt)
    ptok = lo[rr, cc]
    order = np.argsort(ptok, kind="stable")
    rr2, cc2 = np.nonzero(used & ~pt)
    return (ptok[order], j[rr][order], cc[order],
            lo[rr2, cc2], hi[rr2, cc2], j[rr2], cc2)


class _DepsMirror:
    """Host mirror of one store's DepsTable, with dirty-row tracking, plus
    the host half of the bucketed interval index (the CINTIA-analogue in
    ops.deps_kernel.bucketed_flat): per-bucket (lo, hi, slot) entry lists
    kept incrementally, wide/overflow entries in a straggler set, dirty
    buckets scatter-updated to the device alongside the slot table."""

    # bucket width = 2^BSHIFT tokens; intervals (and query probes) touching
    # more than SPAN buckets go to the wide/straggler path
    BSHIFT = 6
    SPAN = 4
    BUCKET_K = 128        # entries per bucket before spilling wide
    WIDE_MAX = 4096       # beyond this many stragglers the dense scan wins

    def __init__(self, capacity: int = _MIN_CAPACITY,
                 max_intervals: int = _MIN_INTERVALS, device="cuda"):
        self.device = torch.device(device)
        self.capacity = capacity
        self.max_intervals = max_intervals
        # owning DeviceState (set by DeviceState.__init__): consulted before
        # any capacity grow so the HBM budget can compact-instead-of-double
        # (see DeviceState._approve_grow)
        self.owner = None
        self.msb = np.zeros(capacity, np.int64)
        self.lsb = np.zeros(capacity, np.int64)
        self.node = np.zeros(capacity, np.int32)
        self.kind = np.zeros(capacity, np.int32)
        self.domain = np.zeros(capacity, np.int8)   # Domain enum value
        self.status = np.full(capacity, dk.SLOT_FREE, np.int32)
        self.lo = np.full((capacity, max_intervals), dk.PAD_LO, np.int64)
        self.hi = np.full((capacity, max_intervals), dk.PAD_HI, np.int64)
        # decided executeAt per slot (host-only; drives the VECTORIZED
        # transitive-elision check in attribution)
        self.emsb = np.zeros(capacity, np.int64)
        self.elsb = np.zeros(capacity, np.int64)
        self.enode = np.zeros(capacity, np.int32)
        self.eknown = np.zeros(capacity, bool)
        self.slot_of: Dict[TxnId, int] = {}
        self.id_of: Dict[int, TxnId] = {}
        # parallel object column: obj[slot] is the TxnId living in the slot
        # (None when free) — snapshot with the packed columns at batch
        # begin, so result attribution is a pure C-level take instead of a
        # per-slot dict lookup + verification
        self.obj = np.full(capacity, None, object)
        self.free_slots: List[int] = list(range(capacity - 1, -1, -1))
        self._dirty: Set[int] = set()
        self._device: Optional[dk.DepsTable] = None
        # copy on write (module docstring): id of the first tensor of each
        # cached device column set (table, attribution columns, bucket
        # rows) that a launched, not yet collected query holds for an
        # escalated re-launch -> number of such queries.  The next
        # dirty-row scatter into a held set copies it first, so the
        # launched query keeps the table as of begin
        self._leases: Dict[int, int] = {}
        # store-shard residency (parallel.store_shard.StoreShards, set by
        # the owner's spill rung): while active, the sharded table / attr
        # uploads route through per-slice resident buffers with their OWN
        # dirty sets — device_table() consumes and clears ``_dirty``, so
        # the sliced consumer must not share it
        self.shards = None
        self._dirty_sh: Set[int] = set()
        self._attr_dirty_sh: Set[int] = set()
        # the mesh-sharded slot-table copy, cached SEPARATELY from the
        # single-device one (the router may alternate the single-device
        # and mesh routes between flushes) and keyed on the mutation
        # version: the dep mask reads only liveness from the status
        # column, and every mutation it can observe bumps ``version``
        self._device_sh: Optional[dk.DepsTable] = None
        self._device_sh_key = None
        # -- bucket index (host truth); entries are (lo, hi, slot, col)
        # where col is the interval's column in its slot row — the third
        # leg of the exact overlap triple the kernels emit --
        self.bucket_row: Dict[int, int] = {}     # bucket id -> dense row
        self.bucket_entries: List[List[Tuple[int, int, int, int]]] = []
        self.bucket_dirty: Set[int] = set()
        self.wide_entries: Set[Tuple[int, int, int, int]] = set()
        # live-occupancy high-water across bucket rows (monotonic, like
        # capacity): the kernels slice the entry axis to its pow2 — the
        # [G, BUCKET_K] rows are ~95% padding on spread keyspaces and the
        # candidate matrix (and kernel wall) shrinks proportionally
        self.bucket_max_len = 0
        self._bhost = None                        # 8 host row arrays
        self._bdev = None                         # 8 device tensors
        self._bdev_pending: Set[int] = set()      # rows _bdev hasn't seen
        self._g_cap = 0
        # wide/straggler host arrays cached per padded width, keyed on the
        # wide version counter (the single-device path asks for width 16,
        # bucket_device_sharded for max(16, d))
        self._whost_cache: Dict[int, tuple] = {}  # w -> (wide_version, arrs)
        self._wdev = None                         # (wlo, whi, wslot...)
        self._btable = None                       # planned BucketTable
        self._btable_src = None                   # its (_bdev, _wdev)
        self._bsh = None                          # mesh-sharded BucketTable
        self._bsh_key = None
        self._wdev_key = None
        self._sorted_bids = np.zeros(0, np.int64)
        self._row_of_sorted = np.zeros(0, np.int32)
        self._bids_stale = False
        # -- routing state (see module docstring): incremental mutation /
        # liveness counters + the cached floor stats and host-route index.
        # ``version`` bumps on every slot mutation, ``bucket_version`` /
        # ``wide_version`` on bucket-index mutations (they key the wide
        # list upload), ``n_live`` counts non-free non-invalidated slots
        # exactly — together they make the live-above-floor estimate O(1)
        # amortized per dispatch.
        self.version = 0
        self.bucket_version = 0
        self.wide_version = 0
        self.n_live = 0
        # ``mut_version`` bumps on EVERY column write (unlike ``version``,
        # which skips live->live status moves the kernels cannot observe):
        # it keys the deferred-collect snapshot cache, whose columns the
        # host attribution DOES read in full
        self.mut_version = 0
        self._snap = None
        self._fstats = None                       # cached floor stats
        self._hidx = None                         # cached host-route index
        self._hidx_key = None
        # -- device attribution columns (r15): domain / fresh status /
        # decided executeAt, scatter-updated alongside the slot table so
        # the ATTRIBUTED kernels can apply elision in-kernel.  They get
        # their own dirty set and version: unlike the dep mask, the
        # attribution pass DOES observe live->live status moves and
        # executeAt writes
        self.attr_version = 0
        self._attr_dirty: Set[int] = set()
        self._attr_dev = None                     # dk.AttrCols
        self._attr_repl = None                    # replicated under a mesh
        self._attr_repl_key = None
        self._attr_sh = None                      # slot-sharded under a mesh
        self._attr_sh_key = None

    # -- bucket index maintenance -------------------------------------------
    def bucket_keff(self) -> int:
        """Static entry-axis slice for the bucketed kernels: the pow2 of
        the live-occupancy high-water (floor 8, cap BUCKET_K)."""
        return min(self.BUCKET_K,
                   _pow2_at_least(max(self.bucket_max_len, 1), 8))

    def _bucket_add(self, slot: int, lo: int, hi: int, col: int) -> None:
        if self.status[slot] == dk.SLOT_INVALIDATED:
            return   # structurally excluded (de-indexed on invalidation)
        self.bucket_version += 1
        blo, bhi = lo >> self.BSHIFT, hi >> self.BSHIFT
        if bhi - blo + 1 > self.SPAN:
            self.wide_entries.add((lo, hi, slot, col))
            self.wide_version += 1
            return
        for bid in range(blo, bhi + 1):
            row = self.bucket_row.get(bid)
            if row is None:
                row = len(self.bucket_entries)
                self.bucket_row[bid] = row
                self.bucket_entries.append([])
                self._bids_stale = True
            ents = self.bucket_entries[row]
            if len(ents) >= self.BUCKET_K:
                # overflow spill: the straggler list absorbs hot buckets
                self.wide_entries.add((lo, hi, slot, col))
                self.wide_version += 1
            else:
                ents.append((lo, hi, slot, col))
                self.bucket_dirty.add(row)
                if len(ents) > self.bucket_max_len:
                    self.bucket_max_len = len(ents)

    def _bucket_remove(self, slot: int) -> None:
        """De-index every interval of ``slot`` (called before the row's
        lo/hi are cleared on free)."""
        self.bucket_version += 1
        row_lo, row_hi = self.lo[slot], self.hi[slot]
        for m in range(self.max_intervals):
            lo, hi = int(row_lo[m]), int(row_hi[m])
            if lo > hi:
                continue
            ent = (lo, hi, slot, m)
            blo, bhi = lo >> self.BSHIFT, hi >> self.BSHIFT
            if bhi - blo + 1 > self.SPAN:
                if ent in self.wide_entries:
                    self.wide_entries.discard(ent)
                    self.wide_version += 1
                continue
            spilled = False
            for bid in range(blo, bhi + 1):
                r = self.bucket_row.get(bid)
                if r is not None:
                    try:
                        self.bucket_entries[r].remove(ent)
                        self.bucket_dirty.add(r)
                        continue
                    except ValueError:
                        pass
                spilled = True
            if spilled and ent in self.wide_entries:
                self.wide_entries.discard(ent)
                self.wide_version += 1

    def bid_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted bucket ids, dense row per id) for vectorized query->row
        mapping via searchsorted."""
        if self._bids_stale or len(self._sorted_bids) != len(self.bucket_row):
            n = len(self.bucket_row)
            bids = np.fromiter(self.bucket_row.keys(), np.int64, n)
            rows = np.fromiter(self.bucket_row.values(), np.int32, n)
            order = np.argsort(bids)
            self._sorted_bids = bids[order]
            self._row_of_sorted = rows[order]
            self._bids_stale = False
        return self._sorted_bids, self._row_of_sorted

    def _fill_bucket_row(self, arrs, r, ents) -> None:
        """Write one bucket's entries into the 8 host row arrays, with the
        immutable id/kind columns read from the mirror (entries are live,
        so the mirror columns are current for their slots)."""
        blo, bhi, bslot, bcol, bmsb, blsb, bnode, bkind = arrs
        blo[r] = dk.PAD_LO
        bhi[r] = dk.PAD_HI
        bslot[r] = -1
        bcol[r] = 0
        for i, (lo, hi, s, col) in enumerate(ents):
            blo[r, i] = lo
            bhi[r, i] = hi
            bslot[r, i] = s
            bcol[r, i] = col
            bmsb[r, i] = self.msb[s]
            blsb[r, i] = self.lsb[s]
            bnode[r, i] = self.node[s]
            bkind[r, i] = self.kind[s]

    def _sync_bucket_host(self) -> None:
        """Bring the 8 host bucket-row arrays (``_bhost``) up to date with
        ``bucket_entries`` — the single source the device copy is
        scatter-updated from."""
        k = self.BUCKET_K
        g_cap = _pow2_at_least(max(len(self.bucket_entries), 1), 64)
        if self._bhost is None or g_cap != self._g_cap:
            blo = np.full((g_cap, k), dk.PAD_LO, np.int64)
            bhi = np.full((g_cap, k), dk.PAD_HI, np.int64)
            bslot = np.full((g_cap, k), -1, np.int32)
            bcol = np.zeros((g_cap, k), np.int32)
            bmsb = np.zeros((g_cap, k), np.int64)
            blsb = np.zeros((g_cap, k), np.int64)
            bnode = np.zeros((g_cap, k), np.int32)
            bkind = np.zeros((g_cap, k), np.int32)
            self._bhost = (blo, bhi, bslot, bcol, bmsb, blsb, bnode, bkind)
            for r, ents in enumerate(self.bucket_entries):
                if ents:
                    self._fill_bucket_row(self._bhost, r, ents)
            self._g_cap = g_cap
            self.bucket_dirty.clear()
            self._bdev = None          # shape changed: full re-upload
            self._bdev_pending.clear()
        elif self.bucket_dirty:
            rows = sorted(self.bucket_dirty)
            for r in rows:
                self._fill_bucket_row(self._bhost, r, self.bucket_entries[r])
            self._bdev_pending.update(rows)
            self.bucket_dirty.clear()

    def _sync_wide_host(self, floor: int):
        """Host arrays for the wide/straggler entries, padded to a pow2 of
        at least ``floor``.  Cached per padded width and keyed on the wide
        version counter."""
        w = _pow2_at_least(max(len(self.wide_entries), 1), floor)
        hit = self._whost_cache.get(w)
        if hit is None or hit[0] != self.wide_version:
            wlo = np.full(w, dk.PAD_LO, np.int64)
            whi = np.full(w, dk.PAD_HI, np.int64)
            wslot = np.full(w, -1, np.int32)
            wcol = np.zeros(w, np.int32)
            wmsb = np.zeros(w, np.int64)
            wlsb = np.zeros(w, np.int64)
            wnode = np.zeros(w, np.int32)
            wkind = np.zeros(w, np.int32)
            for i, (lo, hi, s, col) in enumerate(self.wide_entries):
                wlo[i] = lo
                whi[i] = hi
                wslot[i] = s
                wcol[i] = col
                wmsb[i] = self.msb[s]
                wlsb[i] = self.lsb[s]
                wnode[i] = self.node[s]
                wkind[i] = self.kind[s]
            hit = (self.wide_version,
                   (wlo, whi, wslot, wcol, wmsb, wlsb, wnode, wkind))
            self._whost_cache[w] = hit
            if len(self._whost_cache) > 4:   # widths only grow; drop stale
                for stale_w in sorted(self._whost_cache)[:-4]:
                    del self._whost_cache[stale_w]
        return hit[1]

    def share_device(self, held) -> tuple:
        """Lease the device column sets ``held`` (a table, attribution
        columns, bucket table) to a launched query that may re-read them
        on an escalated re-launch; the lease holds their first tensors,
        so those ids stay unique until ``release_device``."""
        lease = tuple(c[0] for c in held)
        for t in lease:
            self._leases[id(t)] = self._leases.get(id(t), 0) + 1
        return lease

    def release_device(self, lease: tuple) -> None:
        for t in lease:
            left = self._leases.pop(id(t)) - 1
            if left:
                self._leases[id(t)] = left

    def _own(self, cols):
        """Copy-on-write gate for the in-place scatter kernel: private
        copies of ``cols`` while a launched query holds them."""
        if id(cols[0]) not in self._leases:
            return cols
        copies = [c.clone() for c in cols]
        return type(cols)(*copies) if hasattr(cols, "_fields") \
            else tuple(copies)

    def bucket_device(self) -> "dk.BucketTable":
        """Sync the bucket index to the device — dirty-row scatter, like
        the slot table — and return the BucketTable."""
        self._sync_bucket_host()
        if self._bdev is None or self._bdev_pending:
            faults.check("transfer", "bucket upload")
        if self._bdev is None:
            self._bdev = tuple(_upload(a, self.device) for a in self._bhost)
            self._bdev_pending.clear()
        elif self._bdev_pending:
            rows = sorted(self._bdev_pending)
            padded = _pow2_at_least(len(rows), 8)
            idx = np.concatenate([np.array(rows, np.int32),
                                  np.full(padded - len(rows), rows[-1],
                                          np.int32)])
            self._bdev = self._own(self._bdev)
            kernels.scatter_rows(list(self._bdev), idx,
                                 [a[idx] for a in self._bhost])
            self._bdev_pending.clear()
        whost = self._sync_wide_host(16)
        wkey = (self.wide_version, whost[0].shape[0])
        if self._wdev is None or self._wdev_key != wkey:
            faults.check("transfer", "wide upload")
            self._wdev = tuple(_upload(a, self.device) for a in whost)
            self._wdev_key = wkey
        # the table a kernel reads, planned once while its columns stay the
        # same tensors (a scatter writes them in place)
        src = self._btable_src
        if src is None or src[0] is not self._bdev or src[1] is not self._wdev:
            self._btable = kernels.checked_cols(
                dk.BucketTable(*self._bdev, *self._wdev))
            self._btable_src = (self._bdev, self._wdev)
        return self._btable

    def bucket_device_sharded(self, mesh) -> "dk.BucketTable":
        """Mesh placement of the bucket index: bucket ROWS and the wide
        list row-sharded across the mesh (the per-slice tables feed
        parallel.sharded.sharded_bucketed_*).  Any mutation re-uploads
        every slice, keyed on the bucket/wide version counters, as
        device_table_sharded does."""
        self._sync_bucket_host()
        d = mesh.size
        whost = self._sync_wide_host(max(16, d))
        key = (self.bucket_version, self.wide_version, self._g_cap,
               whost[0].shape[0], mesh.key())
        if self._bsh is not None and self._bsh_key == key:
            return self._bsh
        faults.check("transfer", "shard_bucket_table upload")
        self._bsh = dk.BucketTable(*(_upload_sharded(a, mesh)
                                     for a in (*self._bhost, *whost)))
        self._bsh_key = key
        return self._bsh

    def alloc(self, txn_id: TxnId) -> int:
        slot = self.slot_of.get(txn_id)
        if slot is not None:
            return slot
        if not self.free_slots:
            self._grow_capacity()
        slot = self.free_slots.pop()
        self.slot_of[txn_id] = slot
        self.id_of[slot] = txn_id
        self.obj[slot] = txn_id
        self.eknown[slot] = False
        self.msb[slot] = to_i64(txn_id.msb)
        self.lsb[slot] = to_i64(txn_id.lsb)
        self.node[slot] = txn_id.node
        self.kind[slot] = int(txn_id.kind())
        self.domain[slot] = int(txn_id.domain())
        self.status[slot] = dk.SLOT_TRANSITIVE
        self.lo[slot] = dk.PAD_LO
        self.hi[slot] = dk.PAD_HI
        self._dirty.add(slot)
        if self.shards is not None:
            self._dirty_sh.add(slot)
        self._mark_attr(slot)
        self.version += 1
        self.mut_version += 1
        self.n_live += 1
        return slot

    def free(self, txn_id: TxnId) -> None:
        slot = self.slot_of.pop(txn_id, None)
        if slot is None:
            return
        self.id_of.pop(slot, None)
        self.obj[slot] = None
        self.eknown[slot] = False
        self._bucket_remove(slot)
        if self.status[slot] != dk.SLOT_INVALIDATED:
            self.n_live -= 1
        self.status[slot] = dk.SLOT_FREE
        self.lo[slot] = dk.PAD_LO
        self.hi[slot] = dk.PAD_HI
        self.free_slots.append(slot)
        self._dirty.add(slot)
        if self.shards is not None:
            self._dirty_sh.add(slot)
        self._mark_attr(slot)
        self.version += 1
        self.mut_version += 1

    def _grow_capacity(self) -> None:
        if self.owner is not None and not self.owner._approve_grow(self):
            # HBM backpressure: compaction made room under the budget —
            # the caller's free_slots.pop() proceeds without doubling
            return
        old = self.capacity
        new = old * 2
        self.msb = _grow(self.msb, new, 0)
        self.lsb = _grow(self.lsb, new, 0)
        self.node = _grow(self.node, new, 0)
        self.kind = _grow(self.kind, new, 0)
        self.domain = _grow(self.domain, new, 0)
        self.status = _grow(self.status, new, dk.SLOT_FREE)
        self.lo = _grow(self.lo, new, dk.PAD_LO)
        self.hi = _grow(self.hi, new, dk.PAD_HI)
        self.obj = _grow(self.obj, new, None)
        self.emsb = _grow(self.emsb, new, 0)
        self.elsb = _grow(self.elsb, new, 0)
        self.enode = _grow(self.enode, new, 0)
        self.eknown = _grow(self.eknown, new, False)
        self.free_slots.extend(range(new - 1, old - 1, -1))
        self.capacity = new
        self.mut_version += 1
        self._snap = None
        self._device = None  # shape changed: full re-upload
        self._device_sh = None
        self._attr_dev = None
        self._attr_repl = None
        self._attr_sh = None
        self.attr_version += 1

    def _grow_intervals(self) -> None:
        new_m = self.max_intervals * 2
        lo = np.full((self.capacity, new_m), dk.PAD_LO, np.int64)
        hi = np.full((self.capacity, new_m), dk.PAD_HI, np.int64)
        lo[:, : self.max_intervals] = self.lo
        hi[:, : self.max_intervals] = self.hi
        self.lo, self.hi = lo, hi
        self.max_intervals = new_m
        self.mut_version += 1
        self._snap = None
        self._device = None
        self._device_sh = None

    def add_intervals(self, slot: int, tokens: Sequence[int],
                      ranges: Sequence[Range]) -> None:
        """Union new intervals into the slot's footprint (idempotent)."""
        row_lo, row_hi = self.lo[slot], self.hi[slot]
        used = int(np.sum(row_lo <= row_hi))
        new: List[Tuple[int, int]] = []
        for t in tokens:
            new.append((t, t))
        for r in ranges:
            new.append((r.start, r.end - 1))
        for lo_v, hi_v in new:
            present = False
            for m in range(used):
                if row_lo[m] <= lo_v and hi_v <= row_hi[m]:
                    present = True
                    break
            if present:
                continue
            while used >= self.max_intervals:
                self._grow_intervals()
                row_lo, row_hi = self.lo[slot], self.hi[slot]
            row_lo[used] = lo_v
            row_hi[used] = hi_v
            self._dirty.add(slot)
            if self.shards is not None:
                self._dirty_sh.add(slot)
            self.version += 1
            self.mut_version += 1
            self._bucket_add(slot, lo_v, hi_v, used)
            used += 1

    def set_status(self, slot: int, status: int) -> None:
        cur = int(self.status[slot])
        if cur != status:
            if status == dk.SLOT_INVALIDATED and cur != dk.SLOT_FREE:
                self.n_live -= 1
                # liveness changed: the host-route index (which excludes
                # dead slots STRUCTURALLY) is stale.  Live->live status
                # moves deliberately do NOT bump: the index carries only
                # geometry + liveness, and commit/apply churn between
                # flushes would otherwise rebuild it every flush in
                # exactly the hot regime the host route serves
                self.version += 1
            self.status[slot] = status
            self._dirty.add(slot)
            if self.shards is not None:
                self._dirty_sh.add(slot)
            self._mark_attr(slot)
            self.mut_version += 1

    # -- device attribution columns (r15) -----------------------------------
    def _mark_attr(self, slot: int) -> None:
        self._attr_dirty.add(slot)
        if self.shards is not None:
            self._attr_dirty_sh.add(slot)
        self.attr_version += 1

    def mark_exec(self, slot: int) -> None:
        """An executeAt landed on ``slot`` (emsb/elsb/enode/eknown written
        by DeviceState._advance_status): the device attribution columns
        must see it before the next attributed launch."""
        self._attr_dirty.add(slot)
        if self.shards is not None:
            self._attr_dirty_sh.add(slot)
        self.attr_version += 1
        self.mut_version += 1   # snapshot columns changed too

    def _attr_host_cols(self):
        return (self.domain.astype(np.int32), self.status,
                self.msb, self.lsb, self.node,
                self.emsb, self.elsb, self.enode, self.eknown)

    def device_attr_cols_replicated(self, mesh) -> "dk.AttrCols":
        """Replicated attribution columns for the mesh-sharded BUCKETED
        kernels (entries carry global slot ids, so every slice grades
        every slot): one copy on mesh device 0, which each slice's launch
        reads on its own device (a no-op copy on a shared card).  Keyed on
        attr_version: any status/executeAt write re-uploads."""
        key = (self.attr_version, self.capacity, mesh.key())
        if self._attr_repl is not None and self._attr_repl_key == key:
            return self._attr_repl
        faults.check("transfer", "attr replicated upload")
        self._attr_repl = kernels.checked_cols(dk.AttrCols(
            *(_upload(a, mesh.dev0) for a in self._attr_host_cols())))
        self._attr_repl_key = key
        return self._attr_repl

    def device_attr_cols_sharded(self, mesh) -> "dk.AttrCols":
        """Slot-sharded attribution columns for the mesh-sharded DENSE
        kernels (each slice grades only its own slots), keyed on
        attr_version (elision observes live->live status moves and
        executeAt writes the dep mask never reads)."""
        if self.shards is not None and self.shards.active:
            return self.shards.attr_cols()
        key = (self.attr_version, self.capacity, mesh.key())
        if self._attr_sh is not None and self._attr_sh_key == key:
            return self._attr_sh
        faults.check("transfer", "attr sharded upload")
        self._attr_sh = dk.AttrCols(
            *(_upload_sharded(a, mesh) for a in self._attr_host_cols()))
        self._attr_sh_key = key
        return self._attr_sh

    def device_attr_cols(self) -> "dk.AttrCols":
        """Device attribution columns, dirty-row scatter-updated in
        lockstep with device_table()."""
        if self._attr_dev is None or self._attr_dirty:
            faults.check("transfer", "attr column upload")
        if self._attr_dev is None:
            self._attr_dev = kernels.checked_cols(dk.AttrCols(
                *(_upload(a, self.device) for a in self._attr_host_cols())))
            self._attr_dirty.clear()
        elif self._attr_dirty:
            rows = np.array(sorted(self._attr_dirty), np.int32)
            if len(rows) * 2 >= self.capacity:
                self._attr_dev = None
                return self.device_attr_cols()
            padded = _pow2_at_least(len(rows), 8)
            rows = np.concatenate([rows, np.full(padded - len(rows),
                                                 rows[-1], np.int32)])
            host = self._attr_host_cols()
            self._attr_dev = kernels.checked_cols(self._own(self._attr_dev))
            kernels.scatter_rows(list(self._attr_dev), rows,
                                 [a[rows] for a in host])
            self._attr_dirty.clear()
        return self._attr_dev

    def _above_floor_mask(self, floor_id) -> np.ndarray:
        """bool[capacity]: packed id >= floor, under EXACTLY the kernel's
        ts_lt order (unsigned on the two int64 words, then signed node)."""
        from ..ops.packing import to_u64
        fm = np.uint64(to_u64(to_i64(floor_id.msb)))
        fl = np.uint64(to_u64(to_i64(floor_id.lsb)))
        fn = np.int32(floor_id.node)
        um = self.msb.astype(np.uint64)
        ul = self.lsb.astype(np.uint64)
        return ((um > fm) | ((um == fm)
                            & ((ul > fl) | ((ul == fl) & (self.node >= fn)))))

    def floor_stats(self, floor_id) -> Dict[str, float]:
        """Estimated shape of the LIVE-above-floor working set: slot count,
        point/range interval-entry counts and the point-token span.  Cached;
        recomputed (one vectorized pass) only when the floor changes or the
        mutation version drifts past 1/8 of the live set — between
        recomputes the slot-count delta (``n_live`` is exact) scales the
        entry estimates, so the router's read is O(1) per dispatch."""
        fkey = floor_id if floor_id is not None and floor_id > TxnId.NONE \
            else None
        st = self._fstats
        if st is None or st["floor"] != fkey or \
                self.version - st["version"] > max(64, st["n_at"] >> 3):
            live = (self.status >= 0) & (self.status != dk.SLOT_INVALIDATED)
            if fkey is not None:
                live &= self._above_floor_mask(fkey)
            j = np.nonzero(live)[0]
            lo, hi = self.lo[j], self.hi[j]
            used = lo <= hi
            pt = used & (lo == hi)
            n_pt = int(pt.sum())
            toks = lo[pt]
            st = self._fstats = {
                "floor": fkey, "version": self.version, "n_at": self.n_live,
                "n_above": len(j), "n_pt": n_pt,
                "n_rng": int(used.sum()) - n_pt,
                "tok_lo": int(toks.min()) if n_pt else 0,
                "tok_hi": int(toks.max()) if n_pt else 0}
        grown = max(self.n_live - st["n_at"], 0)
        per = (st["n_pt"] + st["n_rng"]) / max(st["n_at"], 1)
        frac_pt = st["n_pt"] / max(st["n_pt"] + st["n_rng"], 1)
        return {"n_above": st["n_above"] + grown,
                "n_pt": st["n_pt"] + grown * per * frac_pt,
                "n_rng": st["n_rng"] + grown * per * (1.0 - frac_pt),
                "tok_lo": st["tok_lo"], "tok_hi": st["tok_hi"]}

    def host_index(self, floor_id):
        """(ptok, pslot, pcol, rlo, rhi, rslot, rcol): the live-above-floor
        tail as a token-SORTED point-entry array plus a flat range-entry
        table — the reference's own scan shape (CommandsForKey sorted
        arrays + rangeCommands, ref: local/CommandsForKey.java:614-650),
        rebuilt from the mirror whenever a mutation lands and cached
        between flushes.  ``pcol``/``rcol`` record each entry's interval
        column in its slot row, so probes yield exact emit triples and the
        collect pass never rebuilds the overlap geometry."""
        fkey = floor_id if floor_id is not None and floor_id > TxnId.NONE \
            else None
        key = (fkey, self.version)
        if self._hidx is not None and self._hidx_key == key:
            return self._hidx
        self._hidx = _host_index_of(self.status, self.lo, self.hi,
                                    self.msb, self.lsb, self.node, fkey)
        self._hidx_key = key
        return self._hidx

    def host_pairs(self, qnp: np.ndarray, q_m: int, floor_id,
                   snapshot=None, entries: bool = False):
        """The host route's candidate generation: (b_idx, j_idx) pairs
        satisfying the EXACT kernel predicate (liveness + floor structurally
        via the index; witness / earlier / not-self as vectorized compares
        identical to the device ts_lt), deduped per (query, slot), plus the
        exact emit triples (pair row, entry interval column, query interval
        column) the probes discovered — the same set np.nonzero over the
        device routes' overlap matrix yields, so attribution sees identical
        inputs and results are bit-identical by construction.

        ``snapshot`` = (msb, lsb, node, kind, status, lo, hi) scans a
        dispatch-time copy of the mirror instead of the live arrays (no
        caching): a fused member's host failover and shadow verify run in
        its harvest task, after mutations may have landed, and must answer
        for what the kernel scanned."""
        if snapshot is not None:
            s_msb, s_lsb, s_node, s_kind, s_status, s_lo, s_hi = snapshot
            fkey = floor_id if floor_id is not None \
                and floor_id > TxnId.NONE else None
            idx = _host_index_of(s_status, s_lo, s_hi, s_msb, s_lsb,
                                 s_node, fkey)
            cap = len(s_msb)
        else:
            s_msb, s_lsb, s_node, s_kind = (self.msb, self.lsb, self.node,
                                            self.kind)
            idx = self.host_index(floor_id)
            cap = self.capacity
        ptok, pslot, pcol, rlo, rhi, rslot, rcol = idx
        lo = qnp[:, 7:7 + q_m]
        hi = qnp[:, 7 + q_m:7 + 2 * q_m]
        used = lo <= hi
        # duplicate query intervals (same (lo, hi) as an earlier column of
        # the same row) probe identical slices and emit identical entries
        # the finalize would dedupe anyway — drop them at the probe (the
        # kernels' first-q dedupe is the device analogue)
        for m_i_ in range(1, q_m):
            dup = np.zeros(qnp.shape[0], bool)
            for m_j_ in range(m_i_):
                dup |= ((lo[:, m_i_] == lo[:, m_j_])
                        & (hi[:, m_i_] == hi[:, m_j_]) & used[:, m_j_])
            used[:, m_i_] &= ~dup
        qi, mi = np.nonzero(used)
        flo = lo[qi, mi]
        fhi = hi[qi, mi]
        parts_b: List[np.ndarray] = []
        parts_j: List[np.ndarray] = []
        parts_m: List[np.ndarray] = []
        parts_q: List[np.ndarray] = []
        if len(ptok):
            # token-sorted probe: every query interval (point OR range)
            # selects the contiguous token slice it covers
            l = np.searchsorted(ptok, flo, side="left")
            r = np.searchsorted(ptok, fhi, side="right")
            cnt = r - l
            tot = int(cnt.sum())
            if tot:
                owner = np.repeat(np.arange(len(qi)), cnt)
                # pos = per-probe slice start + within-slice offset, with
                # ONE repeat: arange(tot) already walks each slice 0..cnt
                # after subtracting the repeated running base
                pos = np.arange(tot) + np.repeat(l - (np.cumsum(cnt) - cnt),
                                                 cnt)
                parts_b.append(qi[owner])
                parts_j.append(pslot[pos])
                parts_m.append(pcol[pos])
                parts_q.append(mi[owner])
        if len(rlo) and len(qi):
            ov = (rlo[None, :] <= fhi[:, None]) & (flo[:, None] <= rhi[None, :])
            ii, jj = np.nonzero(ov)
            parts_b.append(qi[ii])
            parts_j.append(rslot[jj])
            parts_m.append(rcol[jj])
            parts_q.append(mi[ii])
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if not parts_b:
            if entries:
                return (np.zeros(0, np.int64),) * 4
            return empty + ((np.zeros(0, np.int64),) * 3,)
        cb = np.concatenate(parts_b).astype(np.int64)
        cj = np.concatenate(parts_j).astype(np.int64)
        cm = np.concatenate(parts_m).astype(np.int64)
        cq = np.concatenate(parts_q).astype(np.int64)
        em, el, en = s_msb[cj], s_lsb[cj], s_node[cj]
        keep = (qnp[cb, 3] >> s_kind[cj]) & 1 > 0
        uem, ubm = em.view(np.uint64), qnp[cb, 0].view(np.uint64)
        uel, ubl = el.view(np.uint64), qnp[cb, 1].view(np.uint64)
        bn = qnp[cb, 2]
        keep &= ((uem < ubm) | ((uem == ubm)
                               & ((uel < ubl) | ((uel == ubl) & (en < bn)))))
        keep &= ~((em == qnp[cb, 4]) & (el == qnp[cb, 5])
                  & (en == qnp[cb, 6]))
        if not keep.all():
            cb, cj, cm, cq = cb[keep], cj[keep], cm[keep], cq[keep]
        if entries:
            # the attributed paths consume per-ENTRY arrays directly —
            # skip the (query, slot) pair compression (one 1-D sort of
            # the whole emit set) the legacy pair API pays
            return cb, cj, cm, cq
        pair, p_i = np.unique(cb * np.int64(cap) + cj,
                              return_inverse=True)
        return pair // cap, pair % cap, (p_i, cm, cq)

    def snapshot_cols(self):
        """(ids 9-tuple, ivs 3-tuple, kind) copies of every column the
        deferred collect + attribution path reads, cached on
        ``mut_version`` — back-to-back deferred flushes (pipelined bench
        batches, fused-harvest members) over an unmutated mirror share ONE
        copy instead of re-copying O(capacity x intervals) bytes per
        flush.  Consumers must treat the arrays as frozen."""
        s = self._snap
        if s is None or s[0] != self.mut_version:
            ids = (self.msb.copy(), self.lsb.copy(), self.node.copy(),
                   self.obj.copy(), self.status.copy(), self.emsb.copy(),
                   self.elsb.copy(), self.enode.copy(),
                   self.eknown.copy())
            ivs = (self.lo.copy(), self.hi.copy(), self.domain.copy())
            s = self._snap = (self.mut_version, ids, ivs,
                              self.kind.copy())
        return s[1], s[2], s[3]

    # -- device sync --------------------------------------------------------
    def device_table(self) -> dk.DepsTable:
        if self._device is None or self._dirty:
            faults.check("transfer", "slot upload")
        if self._device is None:
            self._device = kernels.checked_cols(dk.DepsTable(
                *(_upload(a, self.device) for a in
                  (self.msb, self.lsb, self.node, self.kind, self.status,
                   self.lo, self.hi))))
            self._dirty.clear()
        elif self._dirty:
            rows = np.array(sorted(self._dirty), np.int32)
            if len(rows) * 2 >= self.capacity:
                # mostly dirty: a full upload is cheaper than a scatter
                self._device = None
                return self.device_table()
            # pad to a power-of-two bucket, repeating the last row (a
            # scatter of identical bytes is idempotent)
            padded = _pow2_at_least(len(rows), 8)
            rows = np.concatenate([rows, np.full(padded - len(rows),
                                                 rows[-1], np.int32)])
            self._device = kernels.checked_cols(self._own(self._device))
            kernels.scatter_rows(
                list(self._device), rows,
                [self.msb[rows], self.lsb[rows], self.node[rows],
                 self.kind[rows], self.status[rows], self.lo[rows],
                 self.hi[rows]])
            self._dirty.clear()
        return self._device

    def device_table_sharded(self, mesh) -> dk.DepsTable:
        """Mesh placement: the slot dimension sharded across the mesh (a
        DepsTable of per-slice tuples), cached SEPARATELY from the
        single-device copy and keyed on the mutation version; any version
        drift re-uploads every slice.  Live->live status moves don't bump
        the version: the dep mask reads only liveness from the status
        column.  While the store-shard residency is active, its per-slice
        scatter sync and zero-copy assembly (with quarantined slices'
        status masked) serve instead."""
        if self.shards is not None and self.shards.active:
            return self.shards.table()
        key = (self.version, self.capacity, self.max_intervals, mesh.key())
        if self._device_sh is not None and self._device_sh_key == key:
            return self._device_sh
        faults.check("transfer", "sharded slot upload")
        self._device_sh = dk.DepsTable(
            *(_upload_sharded(a, mesh) for a in
              (self.msb, self.lsb, self.node, self.kind, self.status,
               self.lo, self.hi)))
        self._device_sh_key = key
        return self._device_sh


class _DrainMirror:
    """Host mirror of the execution drain graph: SPARSE adjacency over the
    store's in-flight (stable-but-unapplied) txns and their direct
    dependencies — per-slot dep/waiter sets, the host analogue of the
    reference's WaitingOn bitset-over-txnIds (ref: local/Command.java:
    1295-1332).  The r04 dense bool[capacity, capacity] matrix needed
    O(N^2) host memory (10^10 entries at the 100k-in-flight spec); edge
    count here is bounded by the live waiting sets.

    r08 delta uploads: the compacted device state is CACHED between ticks.
    ``version`` bumps on any device-visible mutation, ``membership_version``
    on alloc/free (the live set — and therefore the compaction mapping —
    changed), ``edge_version`` on adjacency changes; status/executeAt moves
    land in ``_dirty_scalars``.  A tick whose membership and edges are
    unchanged scatter-updates only the dirty scalar rows of the cached
    device state instead of rebuilding and re-uploading the whole graph —
    exactly the dirty-row policy the deps table already uses."""

    def __init__(self, capacity: int = _MIN_CAPACITY, device="cuda"):
        self.device = torch.device(device)
        self.capacity = capacity
        self.deps_of: List[Set[int]] = [set() for _ in range(capacity)]
        self.waiters_of: List[Set[int]] = [set() for _ in range(capacity)]
        self.status = np.full(capacity, dk.SLOT_FREE, np.int32)
        self.exec_msb = np.zeros(capacity, np.int64)
        self.exec_lsb = np.zeros(capacity, np.int64)
        self.exec_node = np.zeros(capacity, np.int32)
        self.awaits_all = np.zeros(capacity, bool)
        self.active = np.zeros(capacity, bool)   # rows being driven to execution
        self.slot_of: Dict[TxnId, int] = {}
        self.id_of: Dict[int, TxnId] = {}
        self.free_slots: List[int] = list(range(capacity - 1, -1, -1))
        self.version = 0
        self.membership_version = 0
        self.edge_version = 0
        self._dirty_scalars: Set[int] = set()
        self._state_cache: Optional[Dict[str, object]] = None
        self._ready: Optional[torch.Tensor] = None   # ready_buffer's

    # -- edge maintenance ---------------------------------------------------
    def add_edge(self, waiter: int, dep: int) -> None:
        self.deps_of[waiter].add(dep)
        self.waiters_of[dep].add(waiter)
        self.edge_version += 1
        self.version += 1

    def clear_deps(self, slot: int) -> None:
        if self.deps_of[slot]:
            self.edge_version += 1
            self.version += 1
        for dep in self.deps_of[slot]:
            self.waiters_of[dep].discard(slot)
        self.deps_of[slot].clear()

    def _clear_edges(self, slot: int) -> None:
        self.clear_deps(slot)
        if self.waiters_of[slot]:
            self.edge_version += 1
            self.version += 1
        for w in self.waiters_of[slot]:
            self.deps_of[w].discard(slot)
        self.waiters_of[slot].clear()

    def alloc(self, txn_id: TxnId) -> int:
        slot = self.slot_of.get(txn_id)
        if slot is not None:
            return slot
        if not self.free_slots:
            self._grow_capacity()
        slot = self.free_slots.pop()
        self.slot_of[txn_id] = slot
        self.id_of[slot] = txn_id
        self.status[slot] = dk.SLOT_TRANSITIVE
        self.exec_msb[slot] = 0
        self.exec_lsb[slot] = 0
        self.exec_node[slot] = 0
        self.awaits_all[slot] = txn_id.kind().awaits_only_deps()
        self._clear_edges(slot)
        self.active[slot] = False
        self.membership_version += 1
        self.version += 1
        return slot

    def free(self, slot: int) -> None:
        txn_id = self.id_of.pop(slot, None)
        if txn_id is not None:
            del self.slot_of[txn_id]
        self.status[slot] = dk.SLOT_FREE
        self._clear_edges(slot)
        self.active[slot] = False
        self.free_slots.append(slot)
        self.membership_version += 1
        self.version += 1

    def _grow_capacity(self) -> None:
        old = self.capacity
        new = old * 2
        self.deps_of.extend(set() for _ in range(new - old))
        self.waiters_of.extend(set() for _ in range(new - old))
        self.status = _grow(self.status, new, dk.SLOT_FREE)
        self.exec_msb = _grow(self.exec_msb, new, 0)
        self.exec_lsb = _grow(self.exec_lsb, new, 0)
        self.exec_node = _grow(self.exec_node, new, 0)
        self.awaits_all = _grow(self.awaits_all, new, False)
        self.active = _grow(self.active, new, False)
        self.free_slots.extend(range(new - 1, old - 1, -1))
        self.capacity = new

    def set_status(self, slot: int, status: int,
                   execute_at: Optional[Timestamp]) -> None:
        changed = int(self.status[slot]) != status
        self.status[slot] = status
        if execute_at is not None:
            em, el = to_i64(execute_at.msb), to_i64(execute_at.lsb)
            en = execute_at.node
            changed |= (int(self.exec_msb[slot]) != em
                        or int(self.exec_lsb[slot]) != el
                        or int(self.exec_node[slot]) != en)
            self.exec_msb[slot] = em
            self.exec_lsb[slot] = el
            self.exec_node[slot] = en
        if changed:
            self.version += 1
            self._dirty_scalars.add(slot)

    # above this live count the drain ships the ELL (padded row-index)
    # adjacency instead of the dense matrix: dense [n, n] at 100k in-flight
    # is 10GB of bools; ELL is n x max_degree
    DENSE_MAX = 8192

    def state(self):
        """Compacted drain state over LIVE slots only (padded to a power-of-
        two bucket so jit caches per bucket): the kernel cost scales with the
        in-flight set, not the high-water capacity.  Returns (state,
        live_slot_index); ``state`` is a dense DrainState below DENSE_MAX
        live slots (MXU matvec fixpoint) and an EllDrainState above it
        (gather fixpoint — no O(N^2) anywhere).

        The device state is cached between ticks (r08): an unchanged
        mirror re-ticks with ZERO upload; membership- and edge-stable
        mutations (status / executeAt moves — the common tick-to-tick
        churn) scatter only the dirty rows of the scalar columns into the
        cached state; only a changed live set or adjacency rebuilds."""
        c = self._state_cache
        if c is not None and c["version"] == self.version:
            return c["state"], c["live"]
        if (c is not None and c["membership"] == self.membership_version
                and c["edges"] == self.edge_version):
            # scalar delta: the live set and adjacency are exactly the
            # cached upload's — scatter the dirty status/executeAt rows
            rows = np.array(sorted(self._dirty_scalars), np.int64)
            li = c["local"][rows]
            ok = li >= 0
            rows, li = rows[ok], li[ok].astype(np.int32)
            st = c["state"]
            if len(li):
                padded = _pow2_at_least(len(li), 8)
                idx = np.concatenate(
                    [li, np.full(padded - len(li), li[-1], np.int32)])
                rws = np.concatenate(
                    [rows, np.full(padded - len(rows), rows[-1], np.int64)])
                kernels.scatter_rows(
                    [st.status, st.exec_msb, st.exec_lsb, st.exec_node], idx,
                    [self.status[rws].astype(np.int32), self.exec_msb[rws],
                     self.exec_lsb[rws],
                     self.exec_node[rws].astype(np.int32)])
            c["version"] = self.version
            self._dirty_scalars.clear()
            return st, c["live"]
        live = np.nonzero(self.status != dk.SLOT_FREE)[0]
        n = _pow2_at_least(len(live), 16)
        local = np.full(self.capacity, -1, np.int32)
        local[live] = np.arange(len(live), dtype=np.int32)
        status = np.full(n, dk.SLOT_FREE, np.int32)
        status[: len(live)] = self.status[live]
        em = np.zeros(n, np.int64)
        el = np.zeros(n, np.int64)
        en = np.zeros(n, np.int32)
        aw = np.zeros(n, bool)
        em[: len(live)] = self.exec_msb[live]
        el[: len(live)] = self.exec_lsb[live]
        en[: len(live)] = self.exec_node[live]
        aw[: len(live)] = self.awaits_all[live]
        if n <= self.DENSE_MAX:
            adj = np.zeros((n, n), bool)
            ris, rjs = [], []
            for i in live:
                row = self.deps_of[int(i)]
                if row:
                    ris.extend([int(local[i])] * len(row))
                    rjs.extend(row)
            if ris:
                li = np.array(ris, np.int64)
                lj = local[np.array(rjs, np.int64)]
                ok = lj >= 0
                adj[li[ok], lj[ok]] = True
            state = drk.DrainState(*(_upload(a, self.device)
                                     for a in (adj, status, em, el, en, aw)))
            return self._cache_state(state, live, local)
        max_deg = max((len(self.deps_of[int(i)]) for i in live), default=0)
        d = _pow2_at_least(max(max_deg, 1), 4)
        adj_idx = np.full((n, d), -1, np.int32)
        for i in live:
            row = self.deps_of[int(i)]
            if row:
                li = local[i]
                cols = local[np.fromiter(row, np.int64, len(row))]
                cols = cols[cols >= 0]
                adj_idx[li, : len(cols)] = cols
        state = drk.EllDrainState(*(_upload(a, self.device)
                                    for a in (adj_idx, status, em, el, en,
                                              aw)))
        return self._cache_state(state, live, local)

    def _cache_state(self, state, live, local):
        self._state_cache = {"state": state, "live": live, "local": local,
                             "version": self.version,
                             "membership": self.membership_version,
                             "edges": self.edge_version}
        self._dirty_scalars.clear()
        return state, live

    def ready_buffer(self, state):
        """The first N bytes of the mirror's pinned host buffer, which a
        solo tick's frontier kernel (dense or ELL) writes over the bus
        (None off the card).  One buffer serves every tick, read before
        the next writes it; it grows to a power of two."""
        if not state.status.is_cuda:
            return None
        n = state.status.shape[0]
        if self._ready is None or self._ready.shape[0] < n:
            self._ready = torch.empty(_pow2_at_least(n, 64),
                                      dtype=torch.bool, pin_memory=True)
        return self._ready[:n]

    def sweep_free(self) -> None:
        """Release slots that can no longer gate anything: terminal status,
        not being driven, and no waiter edge pointing at them."""
        terminal = (self.status == dk.SLOT_APPLIED) | \
                   (self.status == dk.SLOT_INVALIDATED)
        for slot in np.nonzero(terminal & ~self.active)[0]:
            s = int(slot)
            if not self.waiters_of[s] and self.id_of.get(s) is not None:
                self.free(s)


def _group_dedupe(cols):
    """lexsort by ``cols`` (last array = primary key) + shift-compare
    dedupe; returns (order, first_mask) — the tiny-array-friendly
    replacement for np.unique(axis=0), whose void-view machinery costs
    ~0.2ms per call."""
    order = np.lexsort(cols)
    first = np.ones(len(order), bool)
    acc = None
    for c in cols:
        cs = c[order]
        d = cs[1:] != cs[:-1]
        acc = d if acc is None else (acc | d)
    first[1:] = acc
    return order, first


def _finalize_key_batch(builders, bb, tt, trank, ntok, dkey, ndep,
                        objs) -> None:
    """Construct every builder's KeyDeps in ONE vectorized pass over the
    batch's key emits — integer-composite-key sorts + shift-compares;
    per-builder Python touches only group boundaries (the CSR freeze the
    reference does per reply in KeyDeps.Builder, done batch-wide).

    ``trank``/``dkey`` are dense ranks of the token and of the dep's packed
    id (caller-computed over the batch's unique tokens/slots), so the
    (builder, token, dep) dedupe and the per-builder dep ordering are
    single int64 argsorts instead of 5-column lexsorts — the r05 profile
    put ~40% of hot-regime attribution in those lexsorts."""
    from ..primitives.deps import KeyDeps
    from ..primitives.keys import RoutingKeys
    nb = int(bb.max()) + 1 if len(bb) else 1
    if nb * ntok * ndep >= (1 << 62):    # composite would overflow int64
        key1 = None                      # fall back to column lexsort
    else:
        key1 = (bb * ntok + trank) * np.int64(ndep) + dkey
    if key1 is None:
        o = np.lexsort((dkey, tt, bb))
        first = np.ones(len(o), bool)
        first[1:] = _changed((dkey, tt, bb), o)[1:]
    else:
        o = np.argsort(key1, kind="stable")
        k1 = key1[o]
        first = np.ones(len(o), bool)
        first[1:] = k1[1:] != k1[:-1]
    if not first.all():
        o = o[first]
    bb, tt, dkey, objs = bb[o], tt[o], dkey[o], objs[o]
    n = len(bb)
    # per-builder unique deps, ordered by packed id (== TxnId order; dkey
    # ranks preserve it)
    key2 = bb * np.int64(ndep) + dkey
    o2 = np.argsort(key2, kind="stable")
    k2 = key2[o2]
    b2 = bb[o2]
    newb = np.ones(n, bool)
    newb[1:] = b2[1:] != b2[:-1]
    newd = np.ones(n, bool)
    newd[1:] = k2[1:] != k2[:-1]
    gid = np.cumsum(newd) - 1
    base = np.maximum.accumulate(np.where(newb, gid, 0))
    inv = np.empty(n, np.int64)
    inv[o2] = gid - base
    dep_rows = o2[newd]
    dep_bs = bb[dep_rows]
    dep_objs = objs[dep_rows]
    dstart = np.nonzero(newb[newd])[0]
    dbounds = np.append(dstart, len(dep_rows))
    txn_lists = {int(b): dep_objs[dbounds[i]:dbounds[i + 1]].tolist()
                 for i, b in enumerate(dep_bs[dstart].tolist())}
    # (b, token) groups over the (b, tok, dep)-ordered arrays
    # (b, token) groups over the (b, tok, dep)-ordered rows, then one
    # COLUMNAR KeyDeps per builder: np slices only, no per-group Python
    newg = np.ones(n, bool)
    newg[1:] = (bb[1:] != bb[:-1]) | (tt[1:] != tt[:-1])
    gstart = np.nonzero(newg)[0]
    g_b = bb[gstart]
    g_t = tt[gstart]
    gbounds = np.append(gstart, n)
    newb_g = np.ones(len(gstart), bool)
    newb_g[1:] = g_b[1:] != g_b[:-1]
    bstart_g = np.nonzero(newb_g)[0]
    bbounds_g = np.append(bstart_g, len(gstart))
    for k_i in range(len(bstart_g)):
        s0, s1 = bstart_g[k_i], bbounds_g[k_i + 1]
        b = int(g_b[s0])
        row_ptr = gbounds[s0:s1 + 1] - gbounds[s0]
        dep_idx = inv[gbounds[s0]:gbounds[s1]]
        builders[b].key.set_prebuilt(KeyDeps.from_columns(
            RoutingKeys(g_t[s0:s1].tolist(), _presorted=True),
            txn_lists[b], row_ptr, dep_idx))


def _finalize_range_batch(builders, bb, lo, hi, dm, dl, dn, objs) -> None:
    """Range-domain analogue of _finalize_key_batch: the group key is the
    (lo, hi) clip instead of the token."""
    from ..primitives.deps import RangeDeps
    o, first = _group_dedupe((dn, dl, dm, hi, lo, bb))
    o = o[first]
    bb, lo, hi, dm, dl, dn, objs = (bb[o], lo[o], hi[o], dm[o], dl[o],
                                    dn[o], objs[o])
    n = len(bb)
    o2 = np.lexsort((dn, dl, dm, bb))
    b2 = bb[o2]
    newb = np.ones(n, bool)
    newb[1:] = b2[1:] != b2[:-1]
    newd = newb | _changed((dm, dl, dn), o2)
    gid = np.cumsum(newd) - 1
    base = np.maximum.accumulate(np.where(newb, gid, 0))
    inv = np.empty(n, np.int64)
    inv[o2] = gid - base
    dep_rows = o2[newd]
    dep_bs = bb[dep_rows]
    dep_objs = objs[dep_rows]
    dstart = np.nonzero(newb[newd])[0]
    dbounds = np.append(dstart, len(dep_rows))
    txn_lists = {int(b): dep_objs[dbounds[i]:dbounds[i + 1]].tolist()
                 for i, b in enumerate(dep_bs[dstart].tolist())}
    newg = np.ones(n, bool)
    newg[1:] = ((bb[1:] != bb[:-1]) | (lo[1:] != lo[:-1])
                | (hi[1:] != hi[:-1]))
    gstart = np.nonzero(newg)[0]
    g_b = bb[gstart]
    gbounds = np.append(gstart, n)
    newb_g = np.ones(len(gstart), bool)
    newb_g[1:] = g_b[1:] != g_b[:-1]
    bstart_g = np.nonzero(newb_g)[0]
    bbounds_g = np.append(bstart_g, len(gstart))
    for k_i in range(len(bstart_g)):
        s0, s1 = bstart_g[k_i], bbounds_g[k_i + 1]
        b = int(g_b[s0])
        row_ptr = gbounds[s0:s1 + 1] - gbounds[s0]
        dep_idx = inv[gbounds[s0]:gbounds[s1]]
        builders[b].range.set_prebuilt(RangeDeps.from_columns(
            lo[gstart[s0:s1]], hi[gstart[s0:s1]], txn_lists[b],
            row_ptr, dep_idx))


def _changed(cols, order) -> np.ndarray:
    """Shift-compare over reordered columns: True where any column differs
    from the previous row (first row excluded — callers OR with their own
    leading mask)."""
    acc = None
    for c in cols:
        cs = c[order]
        d = cs[1:] != cs[:-1]
        acc = d if acc is None else (acc | d)
    out = np.zeros(len(order), bool)
    out[1:] = acc
    return out


# -- device-resident attribution index (r15) ----------------------------------

def _ts_byte_keys(msb, lsb, node) -> np.ndarray:
    """Pack (msb int64, lsb int64, node int32) columns into V20 byte keys
    whose memcmp order IS the unsigned timestamp order (ts_lt): sign bits
    flipped, big-endian.  One np.searchsorted over these keys replaces a
    three-level lexicographic refinement — the host half of the in-kernel
    rank trick (the device compares precomputed integer RANKS instead)."""
    n = len(msb)
    out = np.empty((n, 20), np.uint8)
    out[:, 0:8] = (np.asarray(msb, np.int64).astype(np.uint64)
                   ^ np.uint64(1 << 63)).astype(">u8")[:, None] \
        .view(np.uint8).reshape(n, 8)
    out[:, 8:16] = (np.asarray(lsb, np.int64).astype(np.uint64)
                    ^ np.uint64(1 << 63)).astype(">u8")[:, None] \
        .view(np.uint8).reshape(n, 8)
    out[:, 16:20] = (np.asarray(node, np.int64).astype(np.int64)
                     .astype(np.uint32, casting="unsafe")
                     ^ np.uint32(1 << 31)).astype(">u4")[:, None] \
        .view(np.uint8).reshape(n, 4)
    return np.ascontiguousarray(out).view("V20").ravel()


_I64_INF = np.int64(np.iinfo(np.int64).max)


def _exact_ranks(sorted_unique: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Ranks of ``keys`` within ``sorted_unique`` when every key IS a
    member: a scatter-map + gather (O(span) memory, one pass) replaces the
    n-log-n searchsorted whenever the value span is modest — the hot-key
    regime's tokens and the snapshot's slot ids are both dense."""
    n = len(sorted_unique)
    if n == 0:
        return np.zeros(len(keys), np.int64)
    lo = int(sorted_unique[0])
    span = int(sorted_unique[-1]) - lo + 1
    if span > max(4 * n, 1 << 16):
        return np.searchsorted(sorted_unique, keys)
    rmap = np.zeros(span, np.int64)
    rmap[sorted_unique - lo] = np.arange(n, dtype=np.int64)
    return rmap[keys - lo]


class _AttrIndexHost:
    """One store's floor + elision index, host side: the numpy arrays the
    host route's vectorized attribution reads directly, plus pow2-padded
    copies that upload as ops.deps_kernel.AttrIndex (padding bounds the
    jit shape count).  Built by DeviceState._attr_index from the
    RedundantBefore segment map and the CFK committed-write pivot lists of
    every registry token; cached until either source's version moves."""

    __slots__ = ("fbnd", "fmsb", "flsb", "fnode", "etok", "eptr",
                 "erank", "exm", "exl", "exn", "uqkeys", "u",
                 "pad", "_dev", "_repl", "seq")

    _SEQ = [0]

    def __init__(self, floors, etok, eptr, exm, exl, exn):
        # monotone build id: cache keys over index IDENTITY must never
        # use id() (a rebuilt index can reuse a freed predecessor's
        # address and alias a stale cache entry)
        _AttrIndexHost._SEQ[0] += 1
        self.seq = _AttrIndexHost._SEQ[0]
        self.fbnd, self.fmsb, self.flsb, self.fnode = floors
        self.etok = etok
        self.eptr = eptr
        self.exm, self.exl, self.exn = exm, exl, exn
        # dense ranks over the UNIQUE exec triples: exec < bound compares
        # become integer rank compares on device
        keys = _ts_byte_keys(exm, exl, exn)
        self.uqkeys = np.unique(keys)
        self.u = len(self.uqkeys)
        rank = np.searchsorted(self.uqkeys, keys).astype(np.int64)
        seg = np.repeat(np.arange(len(etok), dtype=np.int64),
                        np.diff(eptr))
        self.erank = seg * np.int64(self.u + 1) + rank
        # pow2-padded device images (floors pad +INF / zero rows; elidable
        # tokens pad +INF; padded eptr segments are empty)
        fp = _pow2_at_least(max(len(self.fbnd), 1), 1)
        tp = _pow2_at_least(max(len(etok), 1), 1)
        lp = _pow2_at_least(max(len(self.erank), 1), 1)
        l_real = len(self.erank)

        def tail(a, n, fill, dtype):
            out = np.full(n, fill, dtype)
            out[: len(a)] = a
            return out

        self.pad = (
            tail(self.fbnd, fp, _I64_INF, np.int64),
            tail(self.fmsb, fp + 1, 0, np.int64),
            tail(self.flsb, fp + 1, 0, np.int64),
            tail(self.fnode, fp + 1, 0, np.int32),
            tail(etok, tp, _I64_INF, np.int64),
            tail(eptr, tp + 1, l_real, np.int32),
            tail(self.erank, lp, _I64_INF, np.int64),
            tail(exm, lp, 0, np.int64),
            tail(exl, lp, 0, np.int64),
            tail(exn, lp, 0, np.int32),
            np.int64(self.u + 1))
        self._dev = None
        self._repl = None

    def rank_bounds(self, qnp: np.ndarray) -> np.ndarray:
        """Per-query rank of the started-before bound among the index's
        unique committed-write executeAts — the ``rankb`` column the
        kernels (and the host route) compare in place of 128-bit
        timestamps."""
        if self.u == 0:
            return np.zeros(qnp.shape[0], np.int64)
        keys = _ts_byte_keys(qnp[:, 0], qnp[:, 1], qnp[:, 2])
        return np.searchsorted(self.uqkeys, keys).astype(np.int64)

    def device(self, device) -> "dk.AttrIndex":
        if self._dev is None or self._dev[0] != device:
            faults.check("transfer", "attr index upload")
            self._dev = (device, kernels.checked_cols(dk.AttrIndex(
                *(_upload(np.asarray(a), device) for a in self.pad))))
        return self._dev[1]

    def device_replicated(self, mesh) -> "dk.AttrIndex":
        """The index replicated for a mesh: one copy on mesh device 0,
        which each slice's launch reads on its own device."""
        if self._repl is None or self._repl[0] != mesh.key():
            faults.check("transfer", "attr index upload")
            self._repl = (mesh.key(), kernels.checked_cols(dk.AttrIndex(
                *(_upload(np.asarray(a), mesh.dev0) for a in self.pad))))
        return self._repl[1]

    def keep_floor(self, tok, dmsb, dlsb, dnode) -> np.ndarray:
        """Per-entry exact-floor keep mask: dep >= deps_floor(token), the
        numpy twin of the kernel's floor leg."""
        fi = np.searchsorted(self.fbnd, tok, side="right")
        fm, fl, fn = self.fmsb[fi], self.flsb[fi], self.fnode[fi]
        um, ufm = dmsb.view(np.uint64), fm.view(np.uint64)
        ul, ufl = dlsb.view(np.uint64), fl.view(np.uint64)
        return ((um > ufm) | ((um == ufm)
                             & ((ul > ufl)
                                | ((ul == ufl) & (dnode >= fn)))))

    def floors_match(self, qnp: np.ndarray, q_m: int, floor_id) -> bool:
        """True when every floor segment the batch window touches equals
        the batch-global floor the host index already applied
        STRUCTURALLY — the per-entry floor leg is then a no-op the host
        route skips wholesale (the hot-key regime: one watermark over the
        hot range)."""
        from ..ops.packing import to_i64 as _ti
        lo = qnp[:, 7:7 + q_m]
        hi = qnp[:, 7 + q_m:7 + 2 * q_m]
        used = lo <= hi
        if not used.any():
            return True
        i0 = int(np.searchsorted(self.fbnd, int(lo[used].min()),
                                 side="right"))
        i1 = int(np.searchsorted(self.fbnd, int(hi[used].max()),
                                 side="right"))
        fm = self.fmsb[i0:i1 + 1]
        fl = self.flsb[i0:i1 + 1]
        fn = self.fnode[i0:i1 + 1]
        if floor_id is not None and floor_id > TxnId.NONE:
            t = (_ti(floor_id.msb), _ti(floor_id.lsb), floor_id.node)
        else:
            t = (0, 0, 0)
        return bool((fm == t[0]).all() and (fl == t[1]).all()
                    and (fn == t[2]).all())

    def elide_decided(self, tok, emsb, elsb, enode, rankb_b) -> np.ndarray:
        """Per-entry decided-elision mask for candidates ALREADY known to
        be decided (Committed..Applied with executeAt): does a committed
        write on the token execute strictly between the dep and the
        bound?  The pivot search collapses to the UNIQUE (segment, bound
        rank) composites — the hot regime has a handful of hot tokens and
        bounds against tens of thousands of entries."""
        t = len(self.etok)
        seg = np.searchsorted(self.etok, tok)
        seg_c = np.minimum(seg, t - 1)
        seg_ok = self.etok[seg_c] == tok
        c = seg_c.astype(np.int64) * np.int64(self.u + 1) + rankb_b
        uc, inv = np.unique(c, return_inverse=True)
        base_u = self.eptr[np.minimum(uc // np.int64(self.u + 1),
                                      t - 1)].astype(np.int64)
        cnt_u = np.searchsorted(self.erank, uc) - base_u
        pidx_u = np.clip(base_u + cnt_u - 1, 0, max(len(self.exm) - 1, 0))
        pm = self.exm[pidx_u][inv]
        pl = self.exl[pidx_u][inv]
        pn = self.exn[pidx_u][inv]
        uem, upm = emsb.view(np.uint64), pm.view(np.uint64)
        uel, upl = elsb.view(np.uint64), pl.view(np.uint64)
        below = ((uem < upm) | ((uem == upm)
                               & ((uel < upl)
                                  | ((uel == upl) & (enode < pn)))))
        return seg_ok & (cnt_u[inv] > 0) & below


class DeviceState:
    """Per-CommandStore device wiring: the deps index + drain graph, kept in
    sync by the Commands transition functions."""

    def __init__(self, store, device=None, mesh="auto"):
        self.store = store
        if device is None:
            device = getattr(getattr(store, "node", None), "device",
                             None) or "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceState on cuda, but CUDA is not "
                               "available (pass device='cpu' for the CPU)")
        self.deps = _DepsMirror(device=self.device)
        self.deps.owner = self
        self.drain = _DrainMirror(device=self.device)
        self._tick_scheduled = False
        # mesh mode: with more than one visible CUDA device the deps
        # table's slot dimension is sharded across the largest power of
        # two of them, and every scan runs its slices' kernels and merges
        # on device (ref: the CommandStores scatter-gather,
        # CommandStores.java:575-643; cross-shard Deps.merge,
        # Deps.java:256).  ``mesh`` pins one (a parallel.sharded.Mesh, or
        # None for the single-device path)
        self.mesh = None
        if mesh == "auto":
            n_dev = (torch.cuda.device_count()
                     if self.device.type == "cuda" else 0)
            if n_dev > 1:
                d = 1
                while d * 2 <= n_dev:
                    d *= 2
                from ..parallel.sharded import make_mesh
                self.mesh = make_mesh(d)
        else:
            self.mesh = mesh
        # learned compaction width for batched queries (sticky across
        # batches; see deps_query_batch)
        self._batch_k = 64
        # learned flat-compaction capacity (coarse pairs per batch)
        self._batch_flat = 4096
        # counters surfaced through sim stats / bench
        self.n_queries = 0
        self.n_ticks = 0
        self.n_kernel_deps = 0
        self.n_mesh_queries = 0
        self.n_bucketed_queries = 0
        self.n_dense_queries = 0
        self.n_host_queries = 0
        self.n_mesh_bucketed_queries = 0
        self.n_dispatches = 0       # kernel dispatches: n_queries /
        #                             n_dispatches = mean lived batch size
        # fused cross-store launches this store took part in (flushes /
        # queries harvested from a fused launch, ticks served by a fused
        # sweep)
        self.n_fused_flushes = 0
        self.n_fused_queries = 0
        self.n_fused_ticks = 0
        # routing controls (see module docstring): None = adaptive;
        # "host" / "dense" pin a route; "device" = adaptive kernels but
        # never the host route (the pre-routing behavior, used by kernel
        # equivalence tests).  on_route(route, nq) observes every decision
        # (utils.trace.Trace.record_route is the sim-side consumer).
        self.route_override: Optional[str] = None
        self.on_route = None
        # store-level coalescing queue (enqueue_query/_flush_queries)
        self._q_pending: List[tuple] = []
        # batch-floor memo keyed on (RedundantBefore.version, window):
        # repeated flushes over a stable watermark map resolve the prune
        # floor with one dict hit instead of a segment walk
        self._floor_memo: Optional[tuple] = None
        # token -> (cfk version, may_elide_any) memo for attribution
        self._elidable_cache: Dict[int, tuple] = {}
        # -- device-resident attribution (r15) --
        # elision registry: tokens that ever carried a decided key-domain
        # write (maintained by _advance_status); the batched elision index
        # is built over exactly these tokens from the CFK truth
        self._elide_pending: Set[int] = set()
        self._elide_tokens = np.zeros(0, np.int64)
        # cached elision/floor index: (signature, _AttrIndexHost)
        self._aidx_cache = None
        # attributed-path counters (bench ``# index:`` line)
        self.n_elided_transitive = 0
        self.n_elided_decided = 0
        self.attr_download_bytes = 0
        # per-kernel wall timing (SURVEY §5: structured per-kernel timing):
        # kind -> [calls, seconds]; dispatch_* covers host pack + upload +
        # enqueue, wait_* the download join, host_* the host-side passes
        self.kernel_times: Dict[str, List[float]] = {}
        # -- device-fault tolerance (module docstring: degradation ladder) --
        # shadow-verify every device flush against the host route when True
        # (or when utils.faults.PARANOIA is set process-wide)
        self.paranoia = False
        # OOM backpressure terminal state: all flushes/ticks pinned to host
        self.host_pinned = False
        # device-memory budget in table slots (None = unbounded); at the
        # budget _grow_capacity compacts below the RedundantBefore floor
        # instead of doubling, then degrades to host_pinned if still full
        import os as _os
        self.device_budget_slots: Optional[int] = (
            int(_os.environ.get("ACCORD_TPU_DEVICE_BUDGET_SLOTS", "0"))
            or None)
        # quarantine state machine: consecutive device-boundary failures
        # (the backoff exponent) and remaining quarantined flushes; jitter
        # is seeded from (node, store) so the backoff schedule is
        # deterministic yet desynchronized across the replicas of a shard
        # — a cluster-wide device fault must not re-probe in lockstep
        self._dev_backoff = 0
        self._dev_quar_flushes = 0
        node_id = getattr(getattr(store, "node", None), "node_id", 0)
        self._jitter = RandomSource(
            0xFA17 ^ (node_id << 16) ^ getattr(store, "store_id", 0))
        # fault observability: on_fault(event, detail) if set, else the
        # node-level observer the sim cluster wires (node.fault_observer)
        self.on_fault = None
        self.n_device_faults = 0
        self.n_quarantines = 0
        self.n_fallback_queries = 0    # queries served by host fallback/pin
        self.n_reprobes = 0
        self.n_restores = 0
        self.n_shadow_checks = 0
        self.n_shadow_mismatches = 0
        self.n_compactions = 0
        self.n_compacted_slots = 0
        self.n_oom_degraded = 0
        self.n_host_ticks = 0          # drain ticks swept on host fallback
        self.n_device_ticks = 0        # drain ticks swept by a kernel
        # store-sharded residency (parallel.store_shard): the spill rung's
        # StoreShards instance (None until the ladder activates it), the
        # flush/byte counters and the per-slice quarantine tallies
        self.store_shards = None
        self.n_store_sharded_flushes = 0
        self.n_slice_quarantines = 0
        self.n_slice_restores = 0
        self.n_shard_merge_bytes = 0
        # adaptive drain wavefront: W=1 ticks run the plain frontier sweep;
        # W doubles only when a tick's ENTIRE candidate set synchronously
        # reached Applied (the cascade regime, where a serial chain would
        # otherwise pay one tick per link), letting the level pass harvest
        # the next W executeAt antichains in one launch.  Any candidate
        # that does not execute resets W to 1
        self._drain_wavefront = 1
        self.n_wavefront_ticks = 0     # ticks swept with W > 1
        # host-pin recovery: ``_pin_recheck`` pinned flushes between
        # compaction-and-re-check attempts (doubling to a cap)
        self.n_oom_recovered = 0
        self._pin_flushes = 0
        self._pin_recheck = 64
        # two-stage compacted downloads (r10): bytes actually transferred
        # (headers + live entry prefixes) vs what the old full padded
        # flat-buffer download would have moved — the compaction ratio on
        # every bench ``# index:`` line
        self.download_bytes = 0
        self.download_bytes_padded = 0

    # ------------------------------------------------------------------
    # registration hooks (called from local.commands transitions)
    # ------------------------------------------------------------------
    def register(self, txn_id: TxnId, status: int, keys) -> None:
        """Witness/advance a txn in the deps index.  ``keys`` is the txn's
        sliced participation (Keys or Ranges) — its conflict footprint."""
        slot = self.deps.alloc(txn_id)
        if keys is not None:
            if isinstance(keys, Ranges):
                self.deps.add_intervals(slot, (), list(keys))
            else:
                self.deps.add_intervals(slot, [k.token() for k in keys], ())
        self._advance_status(txn_id, slot, status, None)

    def update_status(self, txn_id: TxnId, status: int,
                      execute_at: Optional[Timestamp] = None) -> None:
        slot = self.deps.slot_of.get(txn_id)
        if slot is None:
            slot = self.deps.alloc(txn_id)
        self._advance_status(txn_id, slot, status, execute_at)

    def _advance_status(self, txn_id: TxnId, slot: int, status: int,
                        execute_at: Optional[Timestamp]) -> None:
        cur = int(self.deps.status[slot])
        if status == dk.SLOT_INVALIDATED:
            new = dk.SLOT_INVALIDATED
        else:
            new = max(cur, status)
        self.deps.set_status(slot, new)
        if execute_at is not None:
            self.deps.emsb[slot] = to_i64(execute_at.msb)
            self.deps.elsb[slot] = to_i64(execute_at.lsb)
            self.deps.enode[slot] = execute_at.node
            self.deps.eknown[slot] = True
            self.deps.mark_exec(slot)    # device attr columns + snapshot
        # elision registry (r15): a decided (executeAt-known) key-domain
        # WRITE is a potential elision pivot on each of its footprint
        # points — record the tokens so the batched elision index knows
        # which CommandsForKey pivot lists to include.  Superset semantics:
        # the index build reads the CFK truth per token; a token registered
        # here whose CFK has no committed writes simply contributes nothing
        if dk.SLOT_COMMITTED <= new <= dk.SLOT_APPLIED \
                and self.deps.eknown[slot] and txn_id.kind().is_write() \
                and txn_id.domain() == Domain.Key:
            row_lo, row_hi = self.deps.lo[slot], self.deps.hi[slot]
            pts = row_lo[(row_lo <= row_hi) & (row_lo == row_hi)]
            if len(pts):
                self._elide_pending.update(int(t) for t in pts)
        if new == dk.SLOT_INVALIDATED and cur != dk.SLOT_INVALIDATED:
            # de-index: the bucket path excludes invalidated entries
            # structurally (the dense path excludes them by status)
            self.deps._bucket_remove(slot)
        dslot = self.drain.slot_of.get(txn_id)
        if dslot is not None:
            self.drain.set_status(dslot, new, execute_at)
        # a dependency becoming decided (executeAt known) or terminal can
        # unblock waiters: re-evaluate the frontier
        if new >= dk.SLOT_COMMITTED and self.drain.active.any():
            self.schedule_tick()

    def free(self, txn_id: TxnId) -> None:
        """Truncation/erasure: drop the txn from the deps index (its effect
        is covered by the RedundantBefore watermark from now on)."""
        self.deps.free(txn_id)

    def index_size(self) -> int:
        return len(self.deps.slot_of)

    # ------------------------------------------------------------------
    # device-fault tolerance: quarantine state machine + HBM backpressure
    # (module docstring: the degradation ladder)
    # ------------------------------------------------------------------
    _BACKOFF_BASE = 4      # flushes quarantined after the first failure
    _BACKOFF_MAX = 256     # quarantine ceiling (flushes)

    def _paranoid(self) -> bool:
        return self.paranoia or faults.PARANOIA

    def _fault_event(self, event: str, detail: str = "") -> None:
        obs = self.on_fault
        if obs is None:
            obs = getattr(getattr(self.store, "node", None),
                          "fault_observer", None)
        if obs is not None:
            obs(self.store, event, detail)

    def _device_fault(self, exc_or_kind, detail: str = "",
                      sliced: bool = False) -> None:
        """Record one device-boundary failure and quarantine the device
        routes: exponential backoff in FLUSHES (deterministic per-store
        jitter so co-faulted stores don't re-probe in lockstep).

        ``sliced=True`` (the flush dispatch/collect call sites) composes
        the ladder per slice when the store-sharded residency is active:
        the failure quarantines the SLICE it touched — its slots answer
        from the host twin while healthy slices stay on device — instead
        of the whole node.  Drain-tick faults keep the whole-device
        quarantine (the drain state is not sliced)."""
        kind = exc_or_kind if isinstance(exc_or_kind, str) \
            else faults.kind_of(exc_or_kind)
        self.n_device_faults += 1
        self._fault_event("fault." + kind, detail)
        sh = self.store_shards
        if sliced and sh is not None and sh.active:
            sh.slice_fault(kind, detail)
            return
        self.n_quarantines += 1
        self._dev_backoff = min(self._dev_backoff + 1, 8)
        base = min(self._BACKOFF_BASE << (self._dev_backoff - 1),
                   self._BACKOFF_MAX)
        self._dev_quar_flushes = base + self._jitter.next_int(
            max(base // 2, 1))
        self._fault_event(
            "quarantine", f"{kind} backoff={self._dev_quar_flushes}")

    def _restore_device(self) -> None:
        """A probe flush succeeded end-to-end: the device routes are
        healthy again."""
        self._dev_backoff = 0
        self._dev_quar_flushes = 0
        self.n_restores += 1
        self._fault_event("restore")

    def _flush_gate(self, nq: int):
        """The degradation-ladder gate of every flush: (forced,
        may_probe).  ``forced`` pins this flush to the host
        route ("host-pinned" / "host-fallback", consuming one quarantined
        flush); ``may_probe`` marks that a device-bound flush would be the
        quarantine probe (the caller records the probe only if it actually
        takes a device route)."""
        if self.host_pinned:
            # r21: the OOM degrade is no longer terminal — every
            # _pin_recheck pinned flushes, compact and re-check whether
            # the table fits the device (or the sharded mesh) again; on
            # success the NEXT flush is the recovery probe
            self._pin_flushes += 1
            if self._pin_flushes >= self._pin_recheck:
                self._pin_flushes = 0
                self._pin_recheck = min(self._pin_recheck * 2, 1024)
                if self._try_oom_recover():
                    return None, True
            self.n_fallback_queries += nq
            return "host-pinned", False
        if self._dev_quar_flushes > 0:
            self._dev_quar_flushes -= 1
            self.n_fallback_queries += nq
            return "host-fallback", False
        return None, self._dev_backoff > 0

    def _approve_grow(self, mirror: _DepsMirror) -> bool:
        """Device-memory capacity backpressure: called by
        _DepsMirror._grow_capacity before doubling.  True = grow as usual;
        False = compaction made room under the budget (free_slots is
        non-empty), don't grow.

        The ladder: breach -> compact -> SPILL TO SHARDED (when a mesh is
        available and the grown table fits d x the per-device budget — one
        store's slots split across d slices) -> host-pinned.  When every
        rung fails the store degrades PINNED-TO-HOST (loud one-shot event)
        and the HOST arrays still grow — the protocol stays live, the
        device stops receiving uploads."""
        new = mirror.capacity * 2
        budget = self.device_budget_slots
        sh = self.store_shards
        sharded = sh is not None and sh.active
        # while sharded, the effective budget is the MESH's: d slices
        eff = None if budget is None else (budget * sh.d if sharded
                                           else budget)
        breach = eff is not None and new > eff
        if not breach and faults.should_fire("hbm_oom"):
            self.n_device_faults += 1
            self._fault_event("fault.hbm_oom", f"grow to {new}")
            breach = True
        if not breach:
            return True
        freed = self._compact_below_floor()
        self.n_compactions += 1
        self.n_compacted_slots += freed
        self._fault_event("oom.compact",
                          f"freed={freed} capacity={mirror.capacity}")
        if mirror.free_slots:
            return False
        if not self.host_pinned and not sharded and self.mesh is not None:
            from ..parallel.store_shard import store_shard_enabled
            d = self.mesh.size
            if store_shard_enabled() and (budget is None
                                          or new <= budget * d):
                self._activate_store_shards(f"capacity={mirror.capacity}"
                                            f" -> {new}")
                return True
        if not self.host_pinned:
            # the one-shot loud degrade: host route only from here on
            self.host_pinned = True
            self.n_oom_degraded += 1
            self._fault_event("oom.degrade",
                              f"capacity={mirror.capacity} -> {new}")
        return True

    def _activate_store_shards(self, detail: str = "") -> None:
        """Turn on the sliced residency for this store (the spill rung and
        the sharded leg of OOM recovery): from here the sharded table and
        attr uploads route through per-slice resident buffers."""
        if self.store_shards is None:
            from ..parallel.store_shard import StoreShards
            self.store_shards = StoreShards(self, self.deps, self.mesh)
        self.store_shards.activate()
        self._fault_event("oom.spill", detail)

    def _try_oom_recover(self) -> bool:
        """Un-terminal the OOM degrade: compact, then re-check the budget —
        a raised budget (or a mesh whose d slices now cover the table) lets
        a host-pinned store re-probe the device route.  Loud
        one-shot recovery, counted in ``oom_recovered``; mirrors the
        quarantine -> probe -> restore cycle of the device ladder."""
        mirror = self.deps
        freed = self._compact_below_floor()
        if freed:
            self.n_compactions += 1
            self.n_compacted_slots += freed
            self._fault_event("oom.compact",
                              f"freed={freed} capacity={mirror.capacity}")
        budget = self.device_budget_slots
        cap = mirror.capacity
        if budget is not None and cap > budget:
            from ..parallel.store_shard import store_shard_enabled
            sh_ok = (self.mesh is not None and store_shard_enabled())
            d = self.mesh.size if sh_ok else 1
            if not sh_ok or cap > budget * d:
                return False
            self._activate_store_shards(f"recover capacity={cap}")
        self.host_pinned = False
        self.n_oom_recovered += 1
        self._fault_event("oom.recover",
                          f"capacity={cap} budget={budget}")
        return True

    def _compact_below_floor(self) -> int:
        """Floor-driven compaction: free every live slot whose TxnId sits
        below the RedundantBefore floor over EVERY interval of its own
        footprint.  Safe by the same contract as free(): the attributed
        scan drops a dep below the floor of every token it could emit at,
        on every route — its effect is covered by the watermark.  A Python
        sweep: this is the rare emergency path (budget breach / OOM), not
        a hot path."""
        rb = getattr(self.store, "redundant_before", None)
        if rb is None:
            return 0
        d = self.deps
        freed = 0
        for s in np.nonzero(d.status != dk.SLOT_FREE)[0].tolist():
            tid = d.id_of.get(s)
            if tid is None:
                continue
            row_lo, row_hi = d.lo[s], d.hi[s]
            covered = False
            for m in range(d.max_intervals):
                lo_v, hi_v = int(row_lo[m]), int(row_hi[m])
                if lo_v > hi_v:
                    continue
                if tid < rb.min_floor_over(lo_v, hi_v):
                    covered = True
                else:
                    covered = False
                    break
            if covered:
                d.free(tid)
                freed += 1
        return freed

    def _host_ready_slots(self) -> np.ndarray:
        """Host replacement of the drain frontier sweep (the bottom rung of
        the degradation ladder) — EXACTLY drain_kernel.ready_frontier's
        rule over the drain mirror's sparse adjacency: a Stable row is
        ready unless some dep is live, non-applied, and gating (undecided,
        executing earlier, or the row awaits all deps).  Python-loop over
        the in-flight set: this path runs only quarantined/degraded."""
        dr = self.drain
        m64 = (1 << 64) - 1
        out = []
        for i in np.nonzero((dr.status == dk.SLOT_STABLE) & dr.active)[0]:
            i = int(i)
            ei = (int(dr.exec_msb[i]) & m64, int(dr.exec_lsb[i]) & m64,
                  int(dr.exec_node[i]))
            awaits = bool(dr.awaits_all[i])
            blocked = False
            for j in dr.deps_of[i]:
                stj = int(dr.status[j])
                if stj in (dk.SLOT_FREE, dk.SLOT_INVALIDATED,
                           dk.SLOT_APPLIED):
                    continue
                if stj < dk.SLOT_COMMITTED or awaits:
                    blocked = True      # undecided always gates
                    break
                ej = (int(dr.exec_msb[j]) & m64, int(dr.exec_lsb[j]) & m64,
                      int(dr.exec_node[j]))
                if ej < ei:             # executes before i: gates
                    blocked = True
                    break
            if not blocked:
                out.append(i)
        return np.array(out, np.int64)

    # ------------------------------------------------------------------
    # the deps query (device replacement of map_reduce_active fold)
    # ------------------------------------------------------------------
    def deps_query(self, safe, txn_id: TxnId, keys, started_before: Timestamp,
                   witnesses: Kinds, builder) -> None:
        """Run the PreAccept/Accept/Recover dependency scan on device and
        fold the result into ``builder`` with the same per-key semantics as
        the host CommandsForKey path (full ownership history, matching
        SafeCommandStore.map_reduce_active — a dual-quorum scan at a
        dropped prior-epoch owner must still see its old-range witnesses).

        This is the batch path with B=1: the per-message and batched code
        are ONE path (same kernel dispatch, same floors/elision/attribution)
        so the benched path is exactly the path the protocol runs."""
        query = self.build_query(safe, txn_id, keys, started_before,
                                 witnesses)
        if query is None:
            return
        handle = self.deps_query_batch_begin([query], immediate=True,
                                             prune_floors=True,
                                             attributed=True)
        self.deps_query_batch_end_attributed(safe, handle, [builder])

    def build_query(self, safe, txn_id: TxnId, keys,
                    started_before: Timestamp, witnesses: Kinds):
        """Slice a scan's keys to the store's full ownership history and
        package them as one batch-query tuple (None if nothing owned)."""
        owned = safe.store.ranges_for_epoch.all()
        if isinstance(keys, Ranges):
            q_toks: List[int] = []
            q_rngs = list(keys.slice(owned))
        else:
            q_toks = [k.token() for k in keys
                      if owned.contains_token(k.token())]
            q_rngs = []
        if not q_toks and not q_rngs:
            return None
        return (txn_id, started_before, witnesses, q_toks, q_rngs)

    def _attribute_batch(self, safe, b_idx, j_idx, pmq, ids, ivs, qnp,
                         queries, builders) -> None:
        """Fold a whole batch's kernel answer into the builders with the
        floors, elision and key/range attribution of the host path: the
        kernel answers "who", the mirror snapshot answers "where",
        RedundantBefore floors and the CFK elision rule decide "whether".

        The geometry runs ONCE, vectorized over all (pair, dep-interval,
        query-interval) triples — no per-query Python overhead.  The
        unification that makes this possible: a key-domain dep's footprint
        is a point, so its emitted key is its own token whether the query
        interval was a key or a range; a range-domain dep emits the
        dep∩query interval clip, which for a point query degenerates to the
        width-1 range.  Python touches only the deduplicated surviving
        emits."""
        if len(j_idx) == 0:
            return
        lo, hi, dom = ivs
        rb = safe.redundant_before()
        _MISSING = object()
        cfks: Dict[int, object] = {}

        def elide_ctx(t: int, bound):
            """(cfk, pivot) when elision is possible on this key for this
            bound, else None — ONE lookup per (token, bound) instead of one
            per (dep, token) pair (the common key has nothing elidable)."""
            key = (t, bound)
            ctx = cfks.get(key, _MISSING)
            if ctx is not _MISSING:
                return ctx
            cfk = self.store.commands_for_key.get(t)
            ctx = None
            if cfk is not None:
                pivot = cfk.can_elide(bound)
                if pivot is not None:
                    ctx = (cfk, pivot)
            cfks[key] = ctx
            return ctx

        q_m = (qnp.shape[1] - 7) // 2
        # the exact (pair row, dep-interval col, query-interval col) emit
        # triples arrive precomputed from the collect pass (host probes or
        # np.nonzero over the kernel parts' overlap geometry)
        p_i, m_i, q_i = pmq
        key_dep = (dom[j_idx] == int(Domain.Key))[p_i]

        # key-domain deps: emitted at the dep's own footprint point,
        # deduped per (pair, token); floors + elision decide survival.
        # Emits reach the builders through the batch finalize (whole-batch
        # vectorized dedupe/CSR, set_prebuilt per builder) — per-emit
        # Python runs only for the rare keys with elidable state
        kp, km = p_i[key_dep], m_i[key_dep]
        (msb_a, lsb_a, node_a, obj_a, status_a, xm_a, xl_a, xn_a,
         xk_a) = ids
        if len(kp):
            jj, bb = j_idx[kp], b_idx[kp]
            tt = lo[jj, km]                   # key-domain footprint = point
            # vectorized RedundantBefore floor: dep >= floor(token),
            # lexicographic over the packed (msb, lsb, node) triples (the
            # same int64 ordering the kernel's ts_lt assumes)
            fmsb, flsb, fnode = rb.deps_floor_batch(tt)
            dmsb, dlsb, dnode = msb_a[jj], lsb_a[jj], node_a[jj]
            keep = ((dmsb > fmsb)
                    | ((dmsb == fmsb)
                       & ((dlsb > flsb)
                          | ((dlsb == flsb) & (dnode >= fnode)))))
            jj_k, bb_k, tt_k = jj[keep], bb[keep], tt[keep]
            # object resolution: pure take from the snapshot object column
            deps_k = obj_a[jj_k]
            # VECTORIZED transitive elision (the per-key skip rule,
            # CommandsForKey.is_elided): transitively-known deps never
            # emit; decided deps executing below the key's latest
            # committed-write pivot (for this query's bound) are reached
            # through that write's stable deps.  The pivot is looked up
            # once per unique (token, query) on keys with anything
            # elidable; the per-emit judgement is pure array compares over
            # the mirror's status/executeAt snapshot — no per-emit Python
            uniq_t2, inv_t2 = np.unique(tt_k, return_inverse=True)
            tok_maybe = np.zeros(len(uniq_t2), bool)
            cfk_map = self.store.commands_for_key
            ecache = self._elidable_cache
            for i, t in enumerate(uniq_t2.tolist()):
                cfk = cfk_map.get(t)
                if cfk is None:
                    continue
                # version-keyed memo: may_elide_any flips only when a
                # committed write or unwitnessable lands on the key, both
                # monotone counters — the common spread key resolves to a
                # single dict hit instead of the CFK probe
                ver = (len(cfk._committed_write_execs),
                       cfk._n_unwitnessable)
                hit = ecache.get(t)
                if hit is not None and hit[0] == ver:
                    tok_maybe[i] = hit[1]
                else:
                    m = cfk.may_elide_any()
                    ecache[t] = (ver, m)
                    tok_maybe[i] = m
            status_k = status_a[jj_k]
            elide = status_k == dk.SLOT_TRANSITIVE
            flagged = tok_maybe[inv_t2]
            if flagged.any():
                f_idx = np.nonzero(flagged)[0]
                # (builder, token) pairs as ONE int64 composite key over
                # the token RANKS (np.unique(axis=0) on the raw 2-column
                # stack cost ~250ms/1k queries in the hot regime — the
                # void-dtype argsort dominated attribution)
                ntok2 = len(uniq_t2)
                key_bt = bb_k[f_idx] * np.int64(ntok2) + inv_t2[f_idx]
                ubt_key, inv_bt = np.unique(key_bt, return_inverse=True)
                pv = np.zeros((len(ubt_key), 3), np.int64)
                pv_ok = np.zeros(len(ubt_key), bool)
                ub_list = (ubt_key // ntok2).tolist()
                ut_list = uniq_t2[ubt_key % ntok2].tolist()
                for i, (b, t) in enumerate(zip(ub_list, ut_list)):
                    ctx = elide_ctx(int(t), queries[b][1])
                    if ctx is not None and ctx[1] is not Timestamp.NONE \
                            and ctx[1] is not None:
                        pv[i] = (to_i64(ctx[1].msb), to_i64(ctx[1].lsb),
                                 ctx[1].node)
                        pv_ok[i] = True
                pm, pl, pn = (pv[inv_bt, 0], pv[inv_bt, 1], pv[inv_bt, 2])
                jf = jj_k[f_idx]
                sf = status_k[f_idx]
                xm, xl, xn = xm_a[jf], xl_a[jf], xn_a[jf]
                below = ((xm < pm) | ((xm == pm)
                                      & ((xl < pl)
                                         | ((xl == pl) & (xn < pn)))))
                decided = ((sf >= dk.SLOT_COMMITTED)
                           & (sf <= dk.SLOT_APPLIED) & xk_a[jf])
                elide[f_idx] |= pv_ok[inv_bt] & decided & below
            keep2 = ~elide
            if keep2.any():
                jj_f = jj_k[keep2]
                # dense dep ranks over the batch's unique slots, ordered by
                # the packed id (same signed lexicographic order the old
                # 5-column lexsort used) — the finalize sorts become single
                # int64 argsorts
                u_slots, slot_inv = np.unique(jj_f, return_inverse=True)
                ordr = np.lexsort((node_a[u_slots], lsb_a[u_slots],
                                   msb_a[u_slots]))
                rank = np.empty(len(u_slots), np.int64)
                rank[ordr] = np.arange(len(u_slots))
                _finalize_key_batch(builders, bb_k[keep2], tt_k[keep2],
                                    inv_t2[keep2], len(uniq_t2),
                                    rank[slot_inv], len(u_slots),
                                    deps_k[keep2])

        # range-domain deps: emit the dep∩query interval clip per pair —
        # batch-finalized (dedupe/sort/CSR in one vectorized pass; Range
        # objects materialize once per unique clip)
        rp, rm, rq = p_i[~key_dep], m_i[~key_dep], q_i[~key_dep]
        if len(rp):
            jj_r = j_idx[rp]
            bb_r = b_idx[rp]
            ilo = np.maximum(lo[jj_r, rm], qnp[bb_r, 7 + rq])
            ihi = np.minimum(hi[jj_r, rm], qnp[bb_r, 7 + q_m + rq]) + 1
            dmsb_r, dlsb_r, dnode_r = msb_a[jj_r], lsb_a[jj_r], node_a[jj_r]
            # batch-global RedundantBefore floor on range-domain deps (the
            # host analogue of the device prune, applied on EVERY attributed
            # path so pruned and unpruned kernels agree; the pruned history
            # is covered by the boundary fence dep, messages/preaccept.py:
            # add_boundary_deps)
            m_all = qnp[:, 7:7 + q_m]
            h_all = qnp[:, 7 + q_m:7 + 2 * q_m]
            u_all = m_all <= h_all
            if u_all.any():
                fl = rb.min_floor_over(int(m_all[u_all].min()),
                                       int(h_all[u_all].max()))
                if fl > TxnId.NONE:
                    fm, fls, fn = (to_i64(fl.msb), to_i64(fl.lsb), fl.node)
                    keep_r = ((dmsb_r > fm)
                              | ((dmsb_r == fm)
                                 & ((dlsb_r > fls)
                                    | ((dlsb_r == fls) & (dnode_r >= fn)))))
                    rp, ilo, ihi, jj_r = (rp[keep_r], ilo[keep_r],
                                          ihi[keep_r], jj_r[keep_r])
                    dmsb_r, dlsb_r, dnode_r = (dmsb_r[keep_r],
                                               dlsb_r[keep_r],
                                               dnode_r[keep_r])
            if len(rp):
                _finalize_range_batch(builders, b_idx[rp], ilo, ihi,
                                      dmsb_r, dlsb_r, dnode_r, obj_a[jj_r])

    # ------------------------------------------------------------------
    # store-level coalescing (the lived batched path): queries arriving
    # within one scheduler quantum fold into ONE kernel dispatch
    # ------------------------------------------------------------------
    def enqueue_query(self, query, builder, done) -> None:
        """Queue one deps query for the next flush; ``done(failure, safe)``
        fires after the builder is filled (``safe`` is the flush task's
        exclusive store handle, live only within the callback).  All queries enqueued before the flush
        task runs (i.e. during the same scheduler quantum — message bursts
        land as same-timestamp tasks) share one kernel dispatch, so the
        benched batched shape IS the lived shape (mean batch size =
        n_queries / n_dispatches)."""
        self._q_pending.append((query, builder, done))
        if len(self._q_pending) == 1:
            node = self.store.node
            # node-level dispatch scheduler (r08): all stores of this node
            # whose flushes become runnable in the same event-loop step
            # register with ONE dispatcher event, which coalesces their
            # device launches when the cost model says fusion wins
            disp = getattr(node, "dispatcher", None)
            if disp is not None:
                disp.register_flush(self)
                return
            from .command_store import PreLoadContext
            # one scheduler hop (zero sim-time) so every same-instant
            # message's store task enqueues BEFORE the flush runs
            node.scheduler.now(lambda: self.store.execute(
                PreLoadContext.empty(), self._flush_queries))

    def _flush_queries(self, safe) -> None:
        batch = self._q_pending
        self._q_pending = []
        self._flush_batch(safe, batch)

    def _flush_batch(self, safe, batch) -> None:
        """Serve one claimed batch of enqueued queries solo: the classic
        atomic begin+collect+attribute within this store task (the
        dispatcher routes a store here when fusion does not pay)."""
        if not batch:
            return
        try:
            handle = self.deps_query_batch_begin(
                [q for q, _b, _d in batch], immediate=True,
                prune_floors=True, attributed=True)
            self.deps_query_batch_end_attributed(
                safe, handle, [b for _q, b, _d in batch])
        except BaseException as e:  # noqa: BLE001
            for _q, _b, d in batch:
                d(e, None)
            return
        for _q, _b, d in batch:
            d(None, safe)

    def deps_query_batch(self, queries):
        """Batched deps scan: ONE kernel call for B concurrent queries (the
        server-side batching a pipelined deployment uses).

        ``queries`` = [(txn_id, started_before, witnesses, tokens, ranges)].
        Returns the dep sets in the device-native packed-CSR layout —
        ``(row_ptr int64[B+1], msb int64[D], lsb int64[D], node int32[D])``
        — the same encoding KeyDeps/RangeDeps use (ref: KeyDeps.java:150-156
        CSR layout); consumers materialise TxnId objects lazily."""
        if not queries:
            return (np.zeros(1, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), np.zeros(0, np.int32))
        return self.deps_query_batch_end(self.deps_query_batch_begin(queries))

    def deps_query_batch_attributed(self, safe, queries, builders):
        """The correctness-complete batched scan: one kernel dispatch for B
        queries, then the full host-path semantics (floors, elision,
        key/range attribution) folded into each query's builder.  This is
        the exact code deps_query runs (B=1) — and what the bench times."""
        if not queries:
            return
        handle = self.deps_query_batch_begin(queries, prune_floors=True,
                                             attributed=True)
        self.deps_query_batch_end_attributed(safe, handle, builders)

    # below this many stragglers the bucketed path is used for narrow
    # queries on a single device; above it (hot/adversarial footprints) the
    # dense scan is the better kernel anyway
    BUCKETED = True

    # test knob: force the global triple-dedupe pass even for single-part
    # exact kernels (whose CSRs are unique by construction, so the pass is
    # skipped in production) — test_routing asserts results are
    # byte-identical either way
    FORCE_TRIPLE_DEDUPE = False

    # process-wide route calibration: {"rtt": s, "c_dev": s/elem,
    # "c_host": s/elem}, measured once by a micro-probe (or injected by
    # tests via set_route_calibration)
    _CALIB = None

    @classmethod
    def set_route_calibration(cls, rtt: float, c_host: float,
                              c_dev: float,
                              rtt_mesh: Optional[float] = None,
                              c_xfer: float = 0.0, c_attr: float = 0.0,
                              c_shard: float = 0.0) -> None:
        cls._CALIB = {"rtt": rtt, "c_host": c_host, "c_dev": c_dev,
                      "rtt_mesh": rtt_mesh if rtt_mesh is not None else rtt,
                      "c_xfer": c_xfer, "c_attr": c_attr,
                      "c_shard": c_shard}

    @staticmethod
    def _measure_route_calibration(device):
        """The once-per-process micro-probe behind the routing crossover,
        measured on ``device`` with the port's own kernels: (a) the device
        round-trip cost (a tiny op + download), (b) the device per-element
        cost of the dense deps kernel (a mid-size scan minus the round
        trip), (c) the host per-element cost of the vectorized numpy
        predicate the host route runs, plus the transfer and attribution
        coefficients.  No hard-coded thresholds: the crossover IS these
        numbers."""
        import statistics as _st
        import time as _time
        device = torch.device(device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        x = torch.arange(256, dtype=torch.int64, device=device)
        _host(x + 1)                             # warm
        rtts = []
        for _ in range(5):
            t0 = _time.perf_counter()
            _host(x + 1)
            rtts.append(_time.perf_counter() - t0)
        rtt = _st.median(rtts)
        # device per-element: dense flat kernel over a 8192x4 table, B=16
        cap, b, m = 8192, 16, 4
        table = dk.empty_table(cap, m, device)
        qmat = torch.zeros((b, 7 + 2 * m), dtype=torch.int64, device=device)
        dk.calculate_deps_flat(table, qmat, m, 256, 64)
        sync()
        runs = []
        for _ in range(3):
            t0 = _time.perf_counter()
            dk.calculate_deps_flat(table, qmat, m, 256, 64)
            sync()
            runs.append(_time.perf_counter() - t0)
        elems = b * cap * m * m
        c_dev = max(_st.median(runs) - rtt, 1e-9) / elems
        # host per-element: the predicate compare chain over 64k entries
        n = 1 << 16
        a = np.arange(n, dtype=np.int64)
        c = a[::-1].copy()
        _ = ((a < c) | ((a == c) & (c < a))).sum()   # warm
        t0 = _time.perf_counter()
        reps = 4
        for _ in range(reps):
            _ = ((a < c) | ((a == c) & (c < a))).sum()
        c_host = max((_time.perf_counter() - t0) / (reps * n), 1e-11)
        # host per-element column-copy cost
        _ = a.copy()
        t0 = _time.perf_counter()
        for _ in range(8):
            _ = a.copy()
        c_copy = max((_time.perf_counter() - t0) / (8 * n), 1e-12)
        # device->host transfer cost per BYTE (the prefix-fetch model),
        # each timed download from a fresh buffer
        bufs = [torch.zeros(1 << 16, dtype=torch.int64, device=device) + i
                for i in range(4)]
        sync()
        _host(bufs[0])
        xfers = []
        for buf in bufs[1:]:
            t0 = _time.perf_counter()
            _host(buf)
            xfers.append(_time.perf_counter() - t0)
        c_xfer = max((_st.median(xfers) - rtt) / float(8 << 16), 1e-13)
        # the attribution stage's per-entry-slot cost: attributed minus raw
        # dense kernel at a wide s (the stage is O(s))
        s_probe = 4096
        attr = dk.AttrCols(
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.full((cap,), dk.SLOT_FREE, dtype=torch.int32,
                       device=device),
            torch.zeros(cap, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.bool, device=device))
        inf64 = int(np.iinfo(np.int64).max)

        def col(vals, dt):
            return torch.tensor(vals, dtype=dt, device=device)

        aidx = dk.AttrIndex(col([inf64], torch.int64), col([0, 0], torch.int64),
                            col([0, 0], torch.int64), col([0, 0], torch.int32),
                            col([inf64], torch.int64), col([0, 0], torch.int32),
                            col([inf64], torch.int64), col([0], torch.int64),
                            col([0], torch.int64), col([0], torch.int32),
                            torch.tensor(1, dtype=torch.int64, device=device))
        rb0 = torch.zeros(b, dtype=torch.int64, device=device)
        zeros3 = (0, 0, 0)
        dk.calculate_deps_flat(table, qmat, m, s_probe, 64)
        dk.calculate_deps_flat_attr(table, attr, aidx, qmat, rb0, zeros3, m,
                                    s_probe, 64)
        sync()
        t0 = _time.perf_counter()
        for _ in range(3):
            dk.calculate_deps_flat(table, qmat, m, s_probe, 64)
        sync()
        t_raw = (_time.perf_counter() - t0) / 3
        t0 = _time.perf_counter()
        for _ in range(3):
            dk.calculate_deps_flat_attr(table, attr, aidx, qmat, rb0, zeros3,
                                        m, s_probe, 64)
        sync()
        t_attr = (_time.perf_counter() - t0) / 3
        c_attr = max(t_attr - t_raw, 0.0) / s_probe
        return {"rtt": rtt, "c_dev": c_dev, "c_host": c_host,
                "c_copy": c_copy, "c_xfer": c_xfer, "c_attr": c_attr}


    @staticmethod
    def _sync_mesh(mesh) -> None:
        for dev in set(mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @staticmethod
    def _measure_mesh_rtt(mesh) -> float:
        """Round-trip cost of ONE tiny mesh program — the mesh analogue of
        the single-device rtt probe: the port's sharded calculate_deps
        (its per-device K11 launch and the cross-slice K11 reduce) over a
        table of 8 slots a slice, and the download of its result."""
        import statistics as _st
        import time as _time
        from ..parallel.sharded import shard_table, sharded_calculate_deps
        d = mesh.size
        table = dk.empty_table(8 * d, 1, mesh.dev0)
        q = dk.query_from_qmat(torch.zeros((1, 9), dtype=torch.int64,
                                           device=mesh.dev0), 1)
        fn = sharded_calculate_deps(mesh)
        st = shard_table(mesh, table)
        _host(fn(st, q)[1][0])                   # warm (and build)
        rtts = []
        for _ in range(3):
            t0 = _time.perf_counter()
            _host(fn(st, q)[1][0])
            rtts.append(_time.perf_counter() - t0)
        return _st.median(rtts)

    @staticmethod
    def _measure_shard_coeff(mesh) -> float:
        """Per-element cost of the cross-slice merge the sharded routes add
        (the K12 merge over d gathered blocks): an A/B slope over two
        block sizes, so the fixed launch overhead cancels and what remains
        is the merge's marginal cost.  A COEFFICIENT, never a device-count
        threshold — the router prices the sharded route with it like every
        other term."""
        import statistics as _st
        import time as _time
        d = mesh.size
        dev = mesh.dev0

        def timed(n):
            hdr = torch.tensor([n, n, n, 0, 0, n], dtype=torch.int32,
                               device=dev)
            ent = torch.arange(n, dtype=torch.int32, device=dev)
            blocks = [[(hdr, ent, i * n) for i in range(d)]]
            kernels.merge_blocks(blocks, 1, n, d * n)
            DeviceState._sync_mesh(mesh)
            runs = []
            for _ in range(3):
                t0 = _time.perf_counter()
                kernels.merge_blocks(blocks, 1, n, d * n)
                DeviceState._sync_mesh(mesh)
                runs.append(_time.perf_counter() - t0)
            return _st.median(runs)

        n1, n2 = 1024, 8192
        t1, t2 = timed(n1), timed(n2)
        return max(t2 - t1, 0.0) / ((n2 - n1) * d) + 1e-12

    def _calibration(self):
        if DeviceState._CALIB is None:
            DeviceState._CALIB = self._measure_route_calibration(self.device)
        calib = DeviceState._CALIB
        if self.mesh is not None and "rtt_mesh" not in calib:
            calib["rtt_mesh"] = self._measure_mesh_rtt(self.mesh)
        if self.mesh is not None and "c_shard" not in calib:
            calib["c_shard"] = self._measure_shard_coeff(self.mesh)
        return calib

    def _choose_route(self, qnp: np.ndarray, q_m: int, floor_id) -> str:
        """Pick "host" or "device" for this flush by comparing the modeled
        host-scan cost (live-above-floor working set from the mirror's
        incremental stats) against the modeled device cost (round trips +
        the cheaper kernel's element count).  Models, not thresholds: both
        sides are priced in seconds from the calibration probe."""
        calib = self._calibration()
        st = self.deps.floor_stats(floor_id)
        lo = qnp[:, 7:7 + q_m]
        hi = qnp[:, 7 + q_m:7 + 2 * q_m]
        used = lo <= hi
        n_iv = int(used.sum())
        nq = qnp.shape[0]
        # host model: point candidates ~ covered-token-width x density,
        # plus the [query-interval x range-entry] stab broadcast
        span = max(st["tok_hi"] - st["tok_lo"] + 1, 1)
        density = st["n_pt"] / span
        w = np.where(used,
                     np.minimum(hi, st["tok_hi"])
                     - np.maximum(lo, st["tok_lo"]) + 1, 0)
        est_pt = float(np.clip(w, 0, None).sum()) * density + n_iv * 8.0
        est_host = est_pt + float(n_iv) * st["n_rng"]
        # ~5 vectorized passes per candidate (probe + attr filter + the
        # thin finalize — r15 replaced the attribute re-sort), plus a
        # fixed per-flush overhead (probe setup, index builds, snapshots)
        host_cost = calib["c_host"] * (5.0 * est_host + 40_000.0)
        if self.deps._hidx_key != ((floor_id if floor_id is not None
                                    and floor_id > TxnId.NONE else None),
                                   self.deps.version):
            # index rebuild: one vectorized pass over the live tail
            host_cost += calib["c_host"] * 4.0 * (st["n_above"]
                                                  + st["n_pt"] + st["n_rng"])
        # device model: the cheaper kernel's PER-SLICE element count (the
        # wall clock of a parallel launch is the per-slice work).  The slot
        # table row-shards, so dense work divides by d; the bucket probe
        # matrix does NOT — every slice evaluates all nq x (q_m*span*K)
        # bucket candidates against its row slice, only the wide list
        # splits
        rtt = calib["rtt"]
        d = 1
        if self.mesh is not None:
            d = self.mesh.size
            rtt = calib.get("rtt_mesh", rtt)
        dense_elems = nq * self.deps.capacity * q_m \
            * self.deps.max_intervals // d
        if self.BUCKETED and \
                len(self.deps.wide_entries) <= self.deps.WIDE_MAX:
            # the candidate matrix is sliced to the live bucket-occupancy
            # high-water and the wide list crosses every query interval
            buck_elems = nq * (q_m * self.deps.SPAN
                               * self.deps.bucket_keff()
                               + q_m * len(self.deps.wide_entries) // d)
            dev_elems = min(dense_elems, buck_elems)
        else:
            dev_elems = dense_elems
        # the attributed launch additionally runs the attribution stage
        # over the learned [s] entry buffer
        s_attr = min(self._batch_flat, dev_elems)
        dev_cost = 2.0 * rtt + calib["c_dev"] * dev_elems \
            + calib.get("c_attr", 0.0) * s_attr
        if d > 1:
            # the mesh routes pay the cross-slice merge over the (up to)
            # d x s merged entry block — priced from its own A/B probe
            # slope, never a device-count threshold
            dev_cost += calib.get("c_shard", 0.0) * d * s_attr
        return "host" if host_cost < dev_cost else "device"

    def _batch_floor(self, qnp: np.ndarray, q_m: int):
        """(floor_id, np prune triple) for a batch: the conservative
        batch-global RedundantBefore floor with the (rb.version, window)
        memo — shared by the solo begin path and the fused dispatcher
        prep.  (None, None) when no floor applies."""
        rb = getattr(self.store, "redundant_before", None)
        if rb is None:
            return None, None
        lo_cols = qnp[:, 7:7 + q_m]
        hi_cols = qnp[:, 7 + q_m:7 + 2 * q_m]
        used = lo_cols <= hi_cols
        if not used.any():
            return None, None
        window = (rb.version, int(lo_cols[used].min()),
                  int(hi_cols[used].max()))
        if self._floor_memo is not None and self._floor_memo[0] == window:
            f = self._floor_memo[1]
        else:
            f = rb.min_floor_over(window[1], window[2])
            self._floor_memo = (window, f)
        if f > TxnId.NONE:
            return f, (to_i64(f.msb), to_i64(f.lsb), np.int32(f.node))
        return None, None

    # ------------------------------------------------------------------
    # device-resident attribution (r15): the per-store floor + elision
    # index every attributed route (kernels AND host) applies
    # ------------------------------------------------------------------
    def _attr_index(self) -> _AttrIndexHost:
        """Build (or reuse) the store's attribution index: the packed
        RedundantBefore segment floors plus, per elision-registry token,
        the CFK committed-write pivot list.  The signature folds the
        RedundantBefore version, the registry size and the SUM of the
        touched CFKs' monotone _elide_versions — any pivot mutation moves
        the sum, so staleness detection is one pass of dict hits, no
        content hashing."""
        d = self.deps
        if self._elide_pending:
            new = np.fromiter(self._elide_pending, np.int64,
                              len(self._elide_pending))
            self._elide_pending.clear()
            self._elide_tokens = np.union1d(self._elide_tokens, new)
        rb = getattr(self.store, "redundant_before", None)
        cfk_map = getattr(self.store, "commands_for_key", None) or {}
        toks = self._elide_tokens
        cfks = [cfk_map.get(int(t)) for t in toks]
        vsum = 0
        for c in cfks:
            if c is not None:
                vsum += c._elide_version
        sig = (rb.version if rb is not None else -1, len(toks), vsum)
        if self._aidx_cache is not None and self._aidx_cache[0] == sig:
            return self._aidx_cache[1]
        if rb is not None:
            floors = rb.packed_floor_index()
        else:
            floors = (np.zeros(0, np.int64), np.zeros(1, np.int64),
                      np.zeros(1, np.int64), np.zeros(1, np.int32))
        packs = []
        keep_toks = []
        for t, c in zip(toks.tolist(), cfks):
            if c is None:
                continue
            p = c.packed_committed_execs()
            if len(p[0]):
                packs.append(p)
                keep_toks.append(t)
        if packs:
            etok = np.asarray(keep_toks, np.int64)
            lens = np.array([len(p[0]) for p in packs], np.int64)
            eptr = np.zeros(len(packs) + 1, np.int32)
            np.cumsum(lens, out=eptr[1:])
            exm = np.concatenate([p[0] for p in packs])
            exl = np.concatenate([p[1] for p in packs])
            exn = np.concatenate([p[2] for p in packs])
        else:
            etok = np.zeros(0, np.int64)
            eptr = np.zeros(1, np.int32)
            exm = np.zeros(0, np.int64)
            exl = np.zeros(0, np.int64)
            exn = np.zeros(0, np.int32)
        aidx = _AttrIndexHost(floors, etok, eptr, exm, exl, exn)
        self._aidx_cache = (sig, aidx)
        return aidx

    def _attr_filter_entries(self, tb, tj, tm, tq, ids, ivs, aidx,
                             rankb, floor_skip: bool = False) -> tuple:
        """Apply the attributed kernels' in-kernel drops to a HOST-derived
        entry set (host route, fault fallback, shadow verify): per-token
        floors + elision on key-domain entries, over the flush's snapshot
        columns.  Duplicate (row, token, dep) emits survive — the shared
        finalize dedupes, so bytes match the kernel routes that dropped
        them in-kernel.  ``floor_skip`` (precomputed per flush by
        floors_match) elides the whole floor leg when the exact per-token
        floors equal the structurally-applied batch floor; the decided-
        elision pivot search runs only over the decided subset."""
        if len(tj) == 0:
            return tb, tj, tm, tq, 0, 0
        (msb_a, lsb_a, node_a, _obj, status_a, xm_a, xl_a, xn_a,
         xk_a) = ids
        lo, _hi, dom = ivs
        key_dep = dom[tj] == int(Domain.Key)
        if not key_dep.any():
            return tb, tj, tm, tq, 0, 0
        status = status_a[tj]
        el_trans = key_dep & (status == dk.SLOT_TRANSITIVE)
        tok = None
        keep_floor = None
        if not floor_skip:
            tok = lo[tj, tm]
            keep_floor = aidx.keep_floor(tok, msb_a[tj], lsb_a[tj],
                                         node_a[tj])
        el_dec = np.zeros(len(tj), bool)
        if aidx.u:
            dec = (key_dep & (status >= dk.SLOT_COMMITTED)
                   & (status <= dk.SLOT_APPLIED) & xk_a[tj])
            di = np.nonzero(dec)[0]
            if len(di):
                tji = tj[di]
                tok_d = tok[di] if tok is not None else lo[tji, tm[di]]
                el_dec[di] = aidx.elide_decided(
                    tok_d, xm_a[tji], xl_a[tji], xn_a[tji], rankb[tb[di]])
        if keep_floor is None:
            keep = ~(el_trans | el_dec)
            n_trans = int(el_trans.sum())
            n_dec = int(el_dec.sum())
        else:
            keep = ~key_dep | (keep_floor & ~el_trans & ~el_dec)
            n_trans = int(np.sum(keep_floor & el_trans))
            n_dec = int(np.sum(keep_floor & ~el_trans & el_dec))
        if keep.all():
            return tb, tj, tm, tq, n_trans, n_dec
        return tb[keep], tj[keep], tm[keep], tq[keep], n_trans, n_dec

    def deps_query_batch_begin(self, queries, immediate: bool = False,
                               prune_floors: bool = False,
                               attributed: bool = False):
        """Dispatch a batched deps scan WITHOUT waiting: one query upload per
        kernel part + enqueue; returns an opaque handle for
        deps_query_batch_end / deps_query_batch_end_attributed.

        ``attributed=True`` (every protocol path) launches the attribution
        kernel after the scan: per-token RedundantBefore floors, elision and
        the key dedupe run on the device against the attribution columns +
        the packed floor/elision index, and the CSR that comes back holds
        exactly the entries the builders keep.  Callers may overlap the
        next batch's dispatch with the previous batch's download.

        Dispatch is adaptive: queries whose intervals are narrow probe the
        bucketed index (O(candidates) instead of O(N)); wide queries — and
        everything, when the straggler list says the footprint
        distribution defeats bucketing — take the dense kernel.  All parts
        share one mirror snapshot and one attribution/finalize pass, so
        every route yields identical protocol results."""
        q_m = _pow2_at_least(max(len(t[3]) + len(t[4]) for t in queries))
        packed = [(sb, wit, toks, rngs, tid)
                  for (tid, sb, wit, toks, rngs) in queries]
        nq = len(queries)
        qnp = dk.pack_query_matrix(packed, q_m)
        parts: List[Dict[str, object]] = []
        # conservative batch-global RedundantBefore floor, applied in the
        # kernels (the exact floors still run in attribution); opt-in: the
        # attributed (protocol) paths enable it
        prune = None
        floor_id = None
        if prune_floors:
            floor_id, prune_np = self._batch_floor(qnp, q_m)
            if floor_id is not None:
                prune = tuple(int(x) for x in prune_np)
        aidx = rankb_np = None
        floor_skip = False
        if attributed:
            aidx = self._attr_index()
            rankb_np = aidx.rank_bounds(qnp)
            # when the exact per-token floors equal the batch floor
            # everywhere the batch reaches, the per-entry floor leg is a
            # no-op; an empty elision index drops the pivot leg (static
            # switches of the attribution kernel)
            floor_skip = aidx.floors_match(qnp, q_m, floor_id)
            k_floors = not floor_skip
            k_elide = aidx.u > 0
        dev = self.device

        def dispatch(kind, rows, qcols=None):
            """rows: np int64 query indices of this part, padded to a pow2
            batch by repeating the last row (pads map to -1)."""
            import time as _time
            _t0 = _time.perf_counter()
            kname = ("attr_" + kind) if attributed else kind
            if kind == "host":
                # the host route computes its (query, slot) pairs AND the
                # exact emit triples right here; under ``attributed`` the
                # floor/elision drops run at collect over the same snapshot
                # the builders read
                if attributed:
                    ent4 = self.deps.host_pairs(qnp, q_m, floor_id,
                                                entries=True)
                    parts.append({"kind": "host", "ent": ent4})
                else:
                    b_h, j_h, pmq = self.deps.host_pairs(qnp, q_m,
                                                         floor_id)
                    parts.append({"kind": "host", "b": b_h, "j": j_h,
                                  "pmq": pmq})
                self.n_host_queries += len(rows)
                self.n_dispatches += 1
                self._ktime("dispatch_host", _t0)
                return
            if kind == "host_slice":
                # hybrid twin part: while slices are quarantined the
                # assembled sharded table masks their slots to SLOT_FREE,
                # and this part answers for EXACTLY those slots from the
                # host mirror — disjoint from the device part's slot set
                # by construction, so the concatenated entries finalize
                # byte-identically to an all-device answer
                cb, cj, cm, cq = self.deps.host_pairs(qnp, q_m, floor_id,
                                                      entries=True)
                keep = self.store_shards.quarantined_slot_mask(cj)
                parts.append({"kind": "host_slice",
                              "ent": (cb[keep], cj[keep], cm[keep],
                                      cq[keep])})
                self.n_dispatches += 1
                self._ktime("dispatch_host_slice", _t0)
                return
            dk.launch_check(kind)
            b_pad = _pow2_at_least(len(rows), 1)
            rows_p = np.concatenate(
                [rows, np.full(b_pad - len(rows), rows[-1], np.int64)])
            gmap = np.concatenate(
                [rows, np.full(b_pad - len(rows), -1, np.int64)])
            m_t = self.deps.max_intervals
            part: Dict[str, object] = {"kind": kname, "gmap": gmap,
                                       "nq": b_pad, "q_m": q_m,
                                       "mq": m_t * q_m, "hoff": 2,
                                       "d": 1, "d_ent": 1,
                                       "immediate": immediate}
            mesh = self.mesh
            udev = mesh.dev0 if kind.startswith("sharded") else dev
            rankb = _upload(rankb_np[rows_p], udev) if attributed else None
            if kind == "sharded":
                from ..parallel.sharded import slice_of
                table = self.deps.device_table_sharded(mesh)
                d = mesh.size
                n = self.deps.capacity
                s = min(self._batch_flat, b_pad * (n // d) * m_t * q_m)
                k = min(self._batch_k, (n // d) * m_t * q_m)
                qmat = _upload(qnp[rows_p], udev)
                held = tuple(slice_of(table, i) for i in range(d))
                if attributed:
                    # merged block with GLOBAL slot codes: the cross-slice
                    # Deps.merge happens on device
                    wide = dk.wide_codes(n, m_t, q_m)
                    from ..parallel.sharded import sharded_flat_attr
                    acols = self.deps.device_attr_cols_sharded(mesh)
                    ai = aidx.device_replicated(mesh)
                    pz = prune or (0, 0, 0)
                    held += tuple(slice_of(acols, i) for i in range(d))

                    def relaunch(s2, k2, _m=mesh, _t=table, _q=qmat,
                                 _a=acols, _i=ai, _r=rankb, _p=pz):
                        return sharded_flat_attr(
                            _m, q_m, s2, k2, wide, k_floors,
                            k_elide)(_t, _a, _i, _q, _r, *_p)

                    part.update(d=1, d_ent=d, shard_n=n, s=s, k=k,
                                wide=wide, hoff=5, global_ids=True,
                                s_cap=b_pad * (n // d) * m_t * q_m,
                                k_cap=(n // d) * m_t * q_m)
                else:
                    wide = dk.wide_codes(n // d, m_t, q_m)
                    from ..parallel.sharded import (
                        sharded_calculate_deps_flat,
                        sharded_calculate_deps_flat_pruned)

                    def relaunch(s2, k2, _m=mesh, _t=table, _q=qmat,
                                 _p=prune):
                        if _p is not None:
                            return sharded_calculate_deps_flat_pruned(
                                _m, q_m, s2, k2, wide)(_t, _q, *_p)
                        return sharded_calculate_deps_flat(
                            _m, q_m, s2, k2, wide)(_t, _q)

                    part.update(d=d, shard_n=n // d, s=s, k=k, wide=wide,
                                s_cap=b_pad * (n // d) * m_t * q_m,
                                k_cap=(n // d) * m_t * q_m)
                self.n_mesh_queries += len(rows)
            elif kind == "sharded_bucketed":
                from ..parallel.sharded import slice_of
                btable = self.deps.bucket_device_sharded(mesh)
                d = mesh.size
                span = self.deps.SPAN
                keff = self.deps.bucket_keff()
                wide = dk.wide_codes(self.deps.capacity, m_t, q_m)
                # per-slice candidate ceiling: every touched bucket's live
                # entry slice plus this slice's part of the wide list
                # crossed with the query intervals (exact triples)
                c = (q_m * span * keff
                     + q_m * (sum(w.shape[0] for w in btable.wlo) // d))
                s = min(self._batch_flat, b_pad * c)
                k = min(self._batch_k, c)
                qb = qcols[rows_p].reshape(b_pad, q_m * span)
                qmat = _upload(np.concatenate([qnp[rows_p], qb], axis=1),
                               udev)
                pz = prune or (0, 0, 0)
                if attributed:
                    from ..parallel.sharded import sharded_bucketed_attr
                    acols = self.deps.device_attr_cols_replicated(mesh)
                    ai = aidx.device_replicated(mesh)
                    tsh = self.deps.device_table_sharded(mesh)
                    held = tuple(slice_of(tsh, i) for i in range(d))

                    def relaunch(s2, k2, _m=mesh, _b=btable, _t=tsh,
                                 _q=qmat, _a=acols, _i=ai, _r=rankb,
                                 _p=pz):
                        return sharded_bucketed_attr(
                            _m, q_m, span, s2, k2, m_t, keff, wide,
                            k_floors, k_elide)(_b, _t, _a, _i, _q, _r,
                                               *_p)

                    part.update(d=1, d_ent=d, shard_n=c, s=s, k=k, c=c,
                                wide=wide, hoff=5, global_ids=True,
                                s_cap=b_pad * c, k_cap=c)
                else:
                    from ..parallel.sharded import sharded_bucketed_flat
                    held = ()

                    def relaunch(s2, k2, _m=mesh, _b=btable, _q=qmat,
                                 _p=pz):
                        return sharded_bucketed_flat(
                            _m, q_m, span, s2, k2, m_t, keff,
                            wide)(_b, _q, *_p)

                    part.update(d=d, shard_n=c, s=s, k=k, c=c, wide=wide,
                                global_ids=True, s_cap=b_pad * c, k_cap=c)
                self.n_mesh_queries += len(rows)
                self.n_mesh_bucketed_queries += len(rows)
            elif kind == "dense":
                table = self.deps.device_table()
                n = table.capacity
                wide = dk.wide_codes(n, m_t, q_m)
                s = min(self._batch_flat, b_pad * n * m_t * q_m)
                k = min(self._batch_k, n * m_t * q_m)
                qmat = _upload(qnp[rows_p], udev)
                if attributed:
                    acols = self.deps.device_attr_cols()
                    ai = aidx.device(udev)

                    def relaunch(s2, k2, _t=table, _q=qmat, _a=acols,
                                 _i=ai, _r=rankb, _p=prune):
                        return dk.calculate_deps_flat_attr(
                            _t, _a, _i, _q, _r, _p, q_m, s2, k2, wide,
                            k_floors, k_elide)
                    part.update(hoff=5)
                    held = (table, acols)
                else:

                    def relaunch(s2, k2, _t=table, _q=qmat, _p=prune):
                        return dk.calculate_deps_flat(_t, _q, q_m, s2, k2,
                                                      wide, prune=_p)
                    held = (table,)
                self.n_dense_queries += len(rows)
                part.update(shard_n=n, s=s, k=k, wide=wide,
                            s_cap=b_pad * n * m_t * q_m,
                            k_cap=n * m_t * q_m)
            else:   # bucketed
                table = self.deps.device_table()
                btable = self.deps.bucket_device()
                span = self.deps.SPAN
                keff = self.deps.bucket_keff()
                wide = dk.wide_codes(table.capacity, m_t, q_m)
                c = (q_m * span * keff + q_m * btable.wlo.shape[0])
                s = min(self._batch_flat, b_pad * c)
                k = min(self._batch_k, c)
                qb = qcols[rows_p].reshape(b_pad, q_m * span)
                qmat = _upload(np.concatenate([qnp[rows_p], qb], axis=1),
                               udev)
                if attributed:
                    acols = self.deps.device_attr_cols()
                    ai = aidx.device(udev)

                    def relaunch(s2, k2, _t=table, _b=btable, _q=qmat,
                                 _a=acols, _i=ai, _r=rankb, _p=prune):
                        return dk.bucketed_attr(
                            _t, _a, _i, _b, _q, _r, q_m, span, s2, k2, _p,
                            keff=keff, wide=wide, floors=k_floors,
                            elide=k_elide)
                    part.update(hoff=5)
                    held = (table, btable, acols)
                else:

                    def relaunch(s2, k2, _t=table, _b=btable, _q=qmat,
                                 _p=prune):
                        return dk.bucketed_flat(_t, _b, _q, q_m, span, s2,
                                                k2, _p, keff=keff,
                                                wide=wide)
                    held = (table, btable)
                self.n_bucketed_queries += len(rows)
                part.update(shard_n=table.capacity, s=s, k=k, c=c,
                            wide=wide, global_ids=True, s_cap=b_pad * c,
                            k_cap=c)
            hdr_dev, ent_dev = relaunch(s, k)
            part["relaunch"] = relaunch
            if not immediate:
                # the relaunch closure holds these device columns until
                # the part is collected, and registrations may interleave:
                # the next in-place scatter copies first.  An immediate
                # flush is collected before any mutation, so needs none
                part["lease"] = self.deps.share_device(held)
            self.n_dispatches += 1
            self._ktime("dispatch_" + kname, _t0)
            box: Dict[str, object] = {"hdr": hdr_dev, "ent": ent_dev}
            part["box"] = box
            if not immediate:
                # two-stage prefetch on a worker thread: the header join
                # waits for the kernels, then ONLY the live entry prefix
                # is copied — a pipelined caller attributes batch i while
                # batch i+1 computes and downloads.  No faults.check here:
                # injection draws stay on the deterministic store-task
                # thread (_collect_part re-checks before each stage)
                d_, nq_, s_, k_ = part["d"], b_pad, s, k
                hoff_, de_ = part["hoff"], part["d_ent"]

                def _fetch():
                    import time as _time
                    try:
                        t0 = _time.perf_counter()
                        hdr = _host(hdr_dev).reshape(d_, hoff_ + nq_)
                        box["hdr_np"] = hdr
                        box["t_hdr"] = (t0, _time.perf_counter())
                        ovf_s = int(hdr[:, 1 if hoff_ == 5 else 0].max())
                        ovf_k = int(hdr[:, 2 if hoff_ == 5 else 1].max())
                        if ovf_s > s_ or ovf_k > k_:
                            return    # overflowed: collector re-runs
                        t1 = _time.perf_counter()
                        box["ent_np"] = _fetch_entry_prefix(
                            ent_dev, d_, de_ * s_, int(hdr[:, 0].max()))
                        box["t_ent"] = (t1, _time.perf_counter())
                    except BaseException as e:     # surfaced after join
                        box["err"] = e

                part["th"] = _fetch_pool().submit(_fetch)
            parts.append(part)

        all_rows = np.arange(nq, dtype=np.int64)
        # -- route health gating (module docstring: degradation ladder) --
        # while OOM-degraded or quarantined, every flush is pinned to the
        # host route; when a quarantine expires, the next device-bound
        # flush is the PROBE — its success restores the device routes, its
        # failure re-quarantines deeper
        probing = False
        forced, may_probe = self._flush_gate(nq)
        if forced is not None:
            route = "host"
        else:
            route = self.route_override
            if route is None:
                route = self._choose_route(qnp, q_m,
                                           floor_id if prune_floors
                                           else None)
            if route != "host" and may_probe:
                probing = True
                self.n_reprobes += 1
                self._fault_event("reprobe", f"route={route}")
        # -- store-sharded residency gating --
        sh = self.store_shards
        hybrid = False
        if (sh is not None and sh.active and self.mesh is not None
                and forced is None and route != "host"):
            sh.tick_flush()
            if sh.any_quarantined():
                if attributed:
                    # hybrid: healthy slices answer on device, the sick
                    # slices' slots from the host twin (a host_slice part)
                    hybrid = True
                else:
                    # the raw-CSR path consumes whole per-part CSRs (no
                    # per-entry merge point for a twin to join at): serve
                    # the whole flush from host while any slice is sick
                    route = "host"
                    self.n_fallback_queries += nq
                    probing = False
            if route != "host":
                self.n_store_sharded_flushes += 1
        observed = forced or route
        if self.on_route is not None:
            self.on_route(observed, nq)
        else:
            obs = getattr(self.store.node, "route_observer", None)
            if obs is not None:
                obs(self.store, observed, nq, [q[0] for q in queries])
        degenerate = not self.BUCKETED or \
            len(self.deps.wide_entries) > self.deps.WIDE_MAX
        try:
            if route == "host":
                dispatch("host", all_rows)
            elif self.mesh is not None:
                if hybrid:
                    # quarantined slices pin the flush to the DENSE
                    # sharded kind: the bucketed kernels read entries
                    # structurally (no status column), so only the dense
                    # mask can exclude a masked slice
                    dispatch("sharded", all_rows)
                    dispatch("host_slice", all_rows)
                elif route == "dense" or degenerate:
                    dispatch("sharded", all_rows)
                else:
                    qcols, wide_q = self._bucket_query_cols(qnp, q_m)
                    narrow = np.nonzero(~wide_q)[0].astype(np.int64)
                    wide = np.nonzero(wide_q)[0].astype(np.int64)
                    if len(narrow):
                        dispatch("sharded_bucketed", narrow, qcols)
                    if len(wide):
                        dispatch("sharded", wide)
            elif route == "dense" or degenerate:
                dispatch("dense", all_rows)
            else:
                qcols, wide_q = self._bucket_query_cols(qnp, q_m)
                narrow = np.nonzero(~wide_q)[0].astype(np.int64)
                wide = np.nonzero(wide_q)[0].astype(np.int64)
                if len(narrow):
                    dispatch("bucketed", narrow, qcols)
                if len(wide):
                    dispatch("dense", wide)
        except faults.DEVICE_EXCEPTIONS as e:
            # an injected device-boundary failure at dispatch: quarantine
            # (the slice it touched, under store-shards; else the device)
            # and fail the WHOLE flush over to the always-correct host route
            self._release_leases(parts)
            parts.clear()
            self._device_fault(e, f"dispatch: {e}", sliced=True)
            self.n_fallback_queries += nq
            probing = False
            dispatch("host", all_rows)
        if immediate:
            # synchronous caller: collect follows with no interleaved
            # mutation, so the live mirror IS the snapshot
            ids = (self.deps.msb, self.deps.lsb, self.deps.node,
                   self.deps.obj, self.deps.status, self.deps.emsb,
                   self.deps.elsb, self.deps.enode, self.deps.eknown)
            ivs = (self.deps.lo, self.deps.hi, self.deps.domain)
        elif len(parts) == 1 and parts[0]["kind"] == "host":
            # host route: snapshot ONLY the referenced slots and remap the
            # pair/slot indices onto the compact snapshot (np.unique is
            # sorted, so the remap is monotonic and every downstream byte
            # is unchanged)
            part = parts[0]
            d = self.deps
            if "ent" in part:
                cb, cj, cm, cq = part["ent"]
                flag = np.zeros(d.capacity, bool)
                flag[cj] = True
                u = np.nonzero(flag)[0]
                remap = np.empty(d.capacity, np.int64)
                remap[u] = np.arange(len(u), dtype=np.int64)
                part["ent"] = (cb, remap[cj], cm, cq)
            else:
                u = np.unique(part["j"])
                part["j"] = np.searchsorted(u, part["j"])
            ids = (d.msb[u], d.lsb[u], d.node[u], d.obj[u], d.status[u],
                   d.emsb[u], d.elsb[u], d.enode[u], d.eknown[u])
            ivs = (d.lo[u], d.hi[u], d.domain[u])
        else:
            # snapshot the mirror's id + interval columns: the mirror
            # mutates in place, and a slot freed+reallocated between begin
            # and end would otherwise resolve this batch's indices to the
            # WRONG TxnId (version-cached across unmutated flushes)
            ids, ivs, _kind = self.deps.snapshot_cols()
        fmeta = {"floor_id": floor_id, "probing": probing,
                 "immediate": immediate, "attributed": attributed,
                 "aidx": aidx, "rankb": rankb_np,
                 "floor_skip": floor_skip}
        return (parts, ids, ivs, qnp, q_m, list(queries), fmeta)

    def _bucket_query_cols(self, qnp: np.ndarray, q_m: int):
        """Vectorized query->bucket-row mapping: int64[NQ, q_m, SPAN] dense
        rows (-1 = no/empty bucket) and the wide-query mask (any interval
        spanning more than SPAN buckets — those take the dense kernel)."""
        shift = self.deps.BSHIFT
        span = self.deps.SPAN
        lo = qnp[:, 7:7 + q_m]
        hi = qnp[:, 7 + q_m:7 + 2 * q_m]
        used = lo <= hi
        blo = lo >> shift
        bhi = hi >> shift
        wide_q = np.any(used & (bhi - blo + 1 > span), axis=1)
        sorted_bids, row_of = self.deps.bid_rows()
        cols = np.full((qnp.shape[0], q_m, span), -1, np.int64)
        if len(sorted_bids):
            for off in range(span):
                bid = blo + off
                ok = used & (bid <= bhi)
                idx = np.searchsorted(sorted_bids, bid)
                idxc = np.minimum(idx, len(sorted_bids) - 1)
                found = ok & (sorted_bids[idxc] == bid)
                cols[:, :, off] = np.where(found, row_of[idxc], -1)
        return cols, wide_q

    def _ktime(self, kind: str, t0: float) -> None:
        import time as _time
        self._ktime_span(kind, t0, _time.perf_counter())

    def _ktime_span(self, kind: str, t0: float, t1: float) -> None:
        """One finished launch-boundary slice with explicit endpoints —
        the two-stage downloads measure their header/entry fetches where
        they actually happened (possibly on the prefetch thread) and
        report them here (dispatch_* = host pack + upload + enqueue,
        wait_header_* = header join, wait_entries_* = entry-prefix
        transfer, host_* = host passes)."""
        cell = self.kernel_times.get(kind)
        if cell is None:
            cell = self.kernel_times[kind] = [0, 0.0]
        cell[0] += 1
        cell[1] += t1 - t0
        prof = devprof.PROFILER
        if prof is not None:
            # every launch boundary timed here becomes a Chrome-trace
            # slice: pid = node, tid = store — the launch timeline, not
            # just a counter
            prof.complete(
                kind, t0, t1,
                pid=getattr(getattr(self.store, "node", None),
                            "node_id", 0) or 0,
                tid=getattr(self.store, "store_id", 0) or 0)

    def _overflow_resize(self, total: int, maxc: int, s: int, k: int,
                         s_cap: int, k_cap: int, runs: int):
        """ONE overflow re-sizing policy for the solo and fused re-run
        loops: size the flat capacity to the exact observed total (+25%
        headroom, 16k granularity) and the row width with 2x headroom
        (every distinct (s, k) is a fresh jit compilation; a mid-run
        recompile costs seconds on TPU); after the first re-run escalate
        geometrically — a truncated-past-k dense row under-counts its
        triples in the header (flat_csr_local docstring) — so the loop
        terminates at the caps; sticky-learn the result so subsequent
        batches dispatch right-sized."""
        s2 = -(-int(total * 1.25) // 16384) * 16384
        k2 = _pow2_at_least(2 * maxc)
        if runs:
            s2, k2 = max(s2, 2 * s), max(k2, 2 * k)
        s = min(max(s2, s), s_cap)
        k = min(max(k2, k), k_cap)
        self._batch_flat = max(self._batch_flat, s)
        self._batch_k = max(self._batch_k, k)
        return s, k

    def _prefix_pays(self, d: int, s: int, maxtot: int,
                     itemsize: int) -> bool:
        """Stage-2 transfer model for a SYNCHRONOUS fetch: slicing the
        live prefix costs one extra device dispatch (~an rtt) and saves
        the padded tail's bytes — a model over the calibrated per-byte
        transfer cost, not a threshold.  On a local CPU device bytes are
        ~free and the single full fetch wins; on a tunneled MB/s link the
        prefix wins from ~100KB of tail."""
        saved = d * (s - _prefix_len(maxtot, s)) * itemsize
        if saved <= 0:
            return False
        calib = self._calibration()
        return saved * calib.get("c_xfer", 0.0) > calib["rtt"]

    def _release_leases(self, parts) -> None:
        """Return the device-column leases of a batch's kernel parts (no
        re-launch can follow once the batch is collected or failed)."""
        for part in parts:
            lease = part.pop("lease", None)
            if lease is not None:
                self.deps.release_device(lease)

    def _collect_part(self, part):
        """Two-stage download + decode of one kernel part's exact CSR.
        Stage 1 fetches the scalar header (totals / max row width /
        row_end) — a few hundred int32s whose join also absorbs the kernel
        wait; stage 2 transfers ONLY the live prefix of the entry buffer.
        When the learned flat capacity or row width overflowed, the re-run
        is sized from the exact header already downloaded and rides the
        same compacted transfer — the full pow2-padded buffer is never
        materialized on the host.  Returns per-triple (b, j, m, q) global
        arrays (codes decoded, pad rows dropped)."""
        import time as _time
        box = part["box"]
        th = part.get("th")
        nq, d = part["nq"], part["d"]
        s, k = part["s"], part["k"]
        hoff, d_ent = part.get("hoff", 2), part.get("d_ent", 1)
        attr = hoff == 5
        itemsize = 8 if part["wide"] else 4
        faults.check("transfer", "header download")
        _t0 = _time.perf_counter()
        if th is not None:
            th.result()
            err = box.get("err")
            if err is not None:
                raise err           # the real device/transfer failure
            hdr = box["hdr_np"]
            t_h = box.get("t_hdr")
        else:
            hdr = _host(box["hdr"]).reshape(d, hoff + nq)
            t_h = None
        self._ktime_span("wait_header_" + part["kind"],
                         *(t_h or (_t0, _time.perf_counter())))
        self.download_bytes += hdr.nbytes
        self.download_bytes_padded += hdr.nbytes + d * d_ent * s * itemsize
        runs = 0
        while int(hdr[:, 1 if attr else 0].max()) > s \
                or int(hdr[:, 2 if attr else 1].max()) > k:
            # overflow: re-size from the exact header (shared policy,
            # _overflow_resize), then re-dispatch against the same
            # snapshot tables via the part's relaunch closure —
            # registrations interleaved between begin and end must not
            # shift the queried snapshot
            s, k = self._overflow_resize(
                int(hdr[:, 1 if attr else 0].max()),
                int(hdr[:, 2 if attr else 1].max()), s, k,
                part["s_cap"], part["k_cap"], runs)
            dk.launch_check(part["kind"])
            hdr_dev, ent_dev = part["relaunch"](s, k)
            box = {"hdr": hdr_dev, "ent": ent_dev}
            th = None
            faults.check("transfer", "header download")
            _t0 = _time.perf_counter()
            hdr = _host(hdr_dev).reshape(d, hoff + nq)
            self._ktime("wait_header_" + part["kind"], _t0)
            self.download_bytes += hdr.nbytes
            self.download_bytes_padded += hdr.nbytes \
                + d * d_ent * s * itemsize
            runs += 1
        faults.check("transfer", "entry download")
        _t1 = _time.perf_counter()
        if th is not None and "ent_np" in box:
            ent = box["ent_np"]
            t_e = box.get("t_ent")
        else:
            # synchronous fetch (immediate flush or post-overflow): slice
            # the live prefix only when the modeled byte saving beats the
            # extra slice dispatch — on the pipelined path the prefix
            # fetch rides the prefetch thread and overlaps compute, so it
            # never asks
            maxtot = int(hdr[:, 0].max())
            if self._prefix_pays(d, d_ent * s, maxtot, itemsize):
                ent = _fetch_entry_prefix(box["ent"], d, d_ent * s, maxtot)
            else:
                ent = _host(box["ent"]).reshape(d, d_ent * s)
            t_e = None
        self._ktime_span("wait_entries_" + part["kind"],
                         *(t_e or (_t1, _time.perf_counter())))
        self.download_bytes += ent.nbytes
        if self.store_shards is not None and self.store_shards.active \
                and "sharded" in part["kind"]:
            # bytes the sharded-store merge shipped home (header + merged
            # entry block) — the ``shard_merge_bytes`` index counter
            self.n_shard_merge_bytes += hdr.nbytes + ent.nbytes
        if attr:
            # the attributed header carries the in-kernel elision tallies
            # (eknown-graded transitive rows vs decided-below-pivot rows)
            # and the download is the post-attribution entry set
            self.n_elided_transitive += int(hdr[:, 3].sum())
            self.n_elided_decided += int(hdr[:, 4].sum())
            self.attr_download_bytes += hdr.nbytes + ent.nbytes
        tb, tj, tm, tq = _decode_triples(hdr, ent, nq, part["shard_n"],
                                         bool(part.get("global_ids")),
                                         part["mq"], part["q_m"],
                                         hoff=hoff)
        # stale/corrupted-result injection: perturb the slot indices the
        # kernel answered with.  Only where the detector actually runs —
        # paranoia shadow-verify on an IMMEDIATE flush (the protocol path);
        # injecting silent corruption with no detector would just be
        # breaking the program, not testing it.
        if part.get("immediate") and self._paranoid() and len(tj) \
                and faults.should_fire("stale_result"):
            tj = (tj + np.int64(1)) % np.int64(self.deps.capacity)
        gmap = part["gmap"]
        b_global = gmap[tb]
        keep = b_global >= 0                      # drop pad rows
        return b_global[keep], tj[keep], tm[keep], tq[keep]

    def _batch_collect(self, handle):
        """Collect a dispatched batch: one two-stage compacted download per
        part (plus an exact-header-sized re-run on overflow), then a pure
        DECODE — the kernels answer with exact overlap triples, so no
        false-positive pair exists to re-filter and the old host geometry
        pass (``_exact_geometry``) has nothing to do on any device route.
        The host route's probes were always exact, so its pairs and
        triples arrive precomputed either way.  Re-runs use the table
        snapshot captured at begin — registrations interleaved between
        begin and end must not shift the queried snapshot.

        Device-boundary failures here (transfer/download, injected or real)
        quarantine the device routes and fail the flush over to the host
        route; in paranoia mode the surviving device answer is additionally
        shadow-verified against the host route and any mismatch is treated
        as a device fault (both correctness-preserving: all routes are
        bit-identical by construction).  The host fallback/shadow scan runs
        against the live mirror — exact under the immediate (protocol)
        path, where no mutation can interleave between begin and end."""
        (parts, ids, ivs, qnp, q_m, queries, fmeta) = handle
        import time as _time
        nq = len(queries)
        if len(parts) == 1 and parts[0]["kind"] == "host":
            part = parts[0]
            b_idx, j_idx = part["b"], part["j"]
            self.n_queries += nq
            self.n_kernel_deps += len(j_idx)
            return b_idx, j_idx, part["pmq"], ids, ivs, qnp, queries
        try:
            outs = [self._collect_part(p) for p in parts]
        except faults.DEVICE_EXCEPTIONS as e:
            self._device_fault(e, f"collect: {e}", sliced=True)
            return self._host_fallback_collect(handle)
        finally:
            self._release_leases(parts)
        _tg = _time.perf_counter()
        if len(outs) == 1:
            tb, tj, tm, tq = outs[0]
        else:
            tb = np.concatenate([o[0] for o in outs])
            tj = np.concatenate([o[1] for o in outs])
            tm = np.concatenate([o[2] for o in outs])
            tq = np.concatenate([o[3] for o in outs])
        # global triple dedupe: the in-kernel dedupe is per-part only —
        # under the row-sharded bucket index one triple can surface from
        # several shards.  The (b-major, code-ascending) dedupe order
        # matches the per-part CSR order, so results are byte-identical
        # with or without this pass; single-part exact kernels skip it
        # (slot-sharded and single-device CSRs are unique by construction)
        if len(tj) and (self.FORCE_TRIPLE_DEDUPE or len(parts) > 1
                        or parts[0]["kind"] == "sharded_bucketed"):
            order, first = _group_dedupe((tq, tm, tj, tb))
            order = order[first]
            tb, tj, tm, tq = tb[order], tj[order], tm[order], tq[order]
        b_idx, j_idx, p_i = _tri_pairs(tb, tj)
        if self._paranoid() and fmeta["immediate"]:
            # shadow-verify: the exact (query, slot) pair set must match
            # the host route's byte-for-byte; a mismatch means the device
            # answered wrong (stale/corrupted result) — quarantine it and
            # serve the host answer
            self.n_shadow_checks += 1
            b_h, j_h, pmq_h = self.deps.host_pairs(qnp, q_m,
                                                   fmeta["floor_id"])
            cap = np.int64(self.deps.capacity)
            if not np.array_equal(np.unique(b_idx * cap + j_idx),
                                  np.unique(b_h * cap + j_h)):
                self.n_shadow_mismatches += 1
                self._device_fault("stale_result", "shadow mismatch",
                                   sliced=True)
                self.n_fallback_queries += nq
                self.n_queries += nq
                self.n_kernel_deps += len(j_h)
                return b_h, j_h, pmq_h, ids, ivs, qnp, queries
        sh = self.store_shards
        if sh is not None and sh.active:
            sh.note_success()   # probing suspect slices are healthy again
        if fmeta["probing"]:
            self._restore_device()   # the probe flush succeeded end-to-end
        self.n_queries += nq
        self.n_kernel_deps += len(j_idx)
        self._ktime("host_decode", _tg)
        return b_idx, j_idx, (p_i, tm, tq), ids, ivs, qnp, queries

    def _exact_geometry(self, b_idx, j_idx, ivs, qnp, q_m):
        """REFERENCE implementation of the exact overlap geometry over a
        (query, slot) pair list, yielding the (pair, dep-interval,
        query-interval) emit triples.  r10 pushed this into every device
        kernel (the CSR entries ARE the triples, as sorted composite
        codes), so no production route calls it anymore — it remains as
        the oracle the exact-kernel property tests compare against
        (tests/test_exact_collect.py) and as the executable spec of the
        emit-triple order (np.nonzero over [P, M, Q] = pair-major,
        dep-column, query-column — exactly the kernels' code sort)."""
        lo, hi, _dom = ivs
        lo_p, hi_p = lo[j_idx], hi[j_idx]                       # [P, M]
        used = lo_p <= hi_p
        qlo_p = qnp[b_idx, 7:7 + q_m]                           # [P, Q]
        qhi_p = qnp[b_idx, 7 + q_m:7 + 2 * q_m]
        overlap = (used[:, :, None]
                   & (lo_p[:, :, None] <= qhi_p[:, None, :])
                   & (qlo_p[:, None, :] <= hi_p[:, :, None]))   # [P, M, Q]
        p_i, m_i, q_i = np.nonzero(overlap)
        # drop pairs with no exact overlap (bounding-box false positives)
        present = np.zeros(len(j_idx), bool)
        present[p_i] = True
        if not present.all():
            new_pos = np.cumsum(present) - 1
            b_idx, j_idx = b_idx[present], j_idx[present]
            p_i = new_pos[p_i]
        return b_idx, j_idx, (p_i, m_i, q_i)

    def _host_fallback_collect(self, handle):
        """Serve a flush whose device parts failed mid-collect from the
        host route (identical bytes by the routing invariant)."""
        (_parts, ids, ivs, qnp, q_m, queries, fmeta) = handle
        nq = len(queries)
        b_h, j_h, pmq_h = self.deps.host_pairs(qnp, q_m, fmeta["floor_id"])
        self.n_host_queries += nq
        self.n_fallback_queries += nq
        self.n_dispatches += 1
        self.n_queries += nq
        self.n_kernel_deps += len(j_h)
        return b_h, j_h, pmq_h, ids, ivs, qnp, queries

    def deps_query_batch_end(self, handle):
        """Raw packed-CSR collection (no floors/attribution) — the transport
        layout replicas exchange; deps_query_batch_end_attributed is the
        protocol-complete variant."""
        b_idx, j_idx, _ov, ids, _ivs, _qnp, queries = \
            self._batch_collect(handle)
        order = np.argsort(b_idx, kind="stable")
        b_idx, j_idx = b_idx[order], j_idx[order]
        counts = np.bincount(b_idx, minlength=len(queries))
        row_ptr = np.zeros(len(queries) + 1, np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        msb, lsb, node = ids[0], ids[1], ids[2]
        return (row_ptr, msb[j_idx], lsb[j_idx], node[j_idx])

    def _host_attr_triples(self, handle, part=None):
        """Entry-level host answer for an ATTRIBUTED flush: the host
        route's exact probes + the same floor/elision drops the kernels
        fold in, over the flush's snapshot columns.  Serves the host
        route itself, the device-fault failover and the paranoia shadow.
        Returns (tb, tj, tm, tq)."""
        (_parts, ids, ivs, qnp, q_m, _queries, fmeta) = handle
        if part is not None:
            tb, tj, cm, cq = part["ent"]
        else:
            tb, tj, cm, cq = self.deps.host_pairs(
                qnp, q_m, fmeta["floor_id"], entries=True)
        tb, tj, tm, tq, n_t, n_d = self._attr_filter_entries(
            tb, tj, cm, cq, ids, ivs, fmeta["aidx"], fmeta["rankb"],
            fmeta["floor_skip"])
        self.n_elided_transitive += n_t
        self.n_elided_decided += n_d
        return tb, tj, tm, tq

    def _batch_collect_attr(self, handle):
        """Collect an ATTRIBUTED dispatched batch: the kernels already
        applied floors/elision/dedupe, so the download IS the final entry
        set and this is a pure decode.  The host route (and any device
        failover / paranoia shadow) applies the identical drops through
        _attr_filter_entries over the same snapshot — every route hands
        the shared finalize the same entries.  Returns (tb, tj, tm, tq,
        ids, ivs, qnp, q_m, queries)."""
        (parts, ids, ivs, qnp, q_m, queries, fmeta) = handle
        import time as _time
        nq = len(queries)
        if len(parts) == 1 and parts[0]["kind"] == "host":
            _th = _time.perf_counter()
            tb, tj, tm, tq = self._host_attr_triples(handle,
                                                     part=parts[0])
            self.n_queries += nq
            self.n_kernel_deps += len(tj)
            self._ktime("host_attr_filter", _th)
            return tb, tj, tm, tq, ids, ivs, qnp, q_m, queries
        try:
            # host_slice twin parts (the hybrid) answer from the host
            # mirror through the same attr filter the host route uses;
            # device parts download as usual
            outs = [self._host_attr_triples(handle, part=p)
                    if p["kind"] == "host_slice" else self._collect_part(p)
                    for p in parts]
        except faults.DEVICE_EXCEPTIONS as e:
            self._device_fault(e, f"collect: {e}", sliced=True)
            self.n_host_queries += nq
            self.n_fallback_queries += nq
            self.n_dispatches += 1
            self.n_queries += nq
            tb, tj, tm, tq = self._host_attr_triples(handle)
            self.n_kernel_deps += len(tj)
            return tb, tj, tm, tq, ids, ivs, qnp, q_m, queries
        finally:
            self._release_leases(parts)
        _tg = _time.perf_counter()
        if len(outs) == 1:
            tb, tj, tm, tq = outs[0]
        else:
            tb = np.concatenate([o[0] for o in outs])
            tj = np.concatenate([o[1] for o in outs])
            tm = np.concatenate([o[2] for o in outs])
            tq = np.concatenate([o[3] for o in outs])
        if self._paranoid() and fmeta["immediate"]:
            # shadow-verify the ATTRIBUTED answer: the surviving
            # (query, slot) pair set must equal the host route's answer
            # run through the same floor/elision drops
            self.n_shadow_checks += 1
            hb, hj, hm, hq = self._host_attr_triples(handle)
            cap = np.int64(max(self.deps.capacity, 1))
            if not np.array_equal(np.unique(tb * cap + tj),
                                  np.unique(hb * cap + hj)):
                self.n_shadow_mismatches += 1
                self._device_fault("stale_result", "attr shadow mismatch",
                                   sliced=True)
                self.n_fallback_queries += nq
                self.n_queries += nq
                self.n_kernel_deps += len(hj)
                return hb, hj, hm, hq, ids, ivs, qnp, q_m, queries
        sh = self.store_shards
        if sh is not None and sh.active:
            sh.note_success()   # probing suspect slices are healthy again
        if fmeta["probing"]:
            self._restore_device()   # the probe flush succeeded end-to-end
        self.n_queries += nq
        self.n_kernel_deps += len(tj)
        self._ktime("host_decode", _tg)
        return tb, tj, tm, tq, ids, ivs, qnp, q_m, queries

    def _finalize_attr_entries(self, tb, tj, tm, tq, ids, ivs, qnp, q_m,
                               builders) -> None:
        """The thin shared finalize: attributed entries -> builder CSRs.
        Every floor/elision decision already happened (in-kernel on device
        routes, _attr_filter_entries on the host route), so what remains
        is pure shaping: token gathers, dense id ranks, and the two
        columnar batch finalizes.  The (query, token, dep) dedupe built
        into _finalize_key_batch covers the duplicate emits host probes
        keep (the kernels drop them in-kernel only to shrink the wire)."""
        (msb_a, lsb_a, node_a, obj_a, _status, _xm, _xl, _xn, _xk) = ids
        lo, hi, dom = ivs
        if len(tj) == 0:
            return
        key_dep = dom[tj] == int(Domain.Key)
        all_key = key_dep.all()              # the hot-key regime: skip the
        if all_key:                          # split gathers wholesale
            kp = None
        else:
            kp = np.nonzero(key_dep)[0]
        if all_key or len(kp):
            if all_key:
                bb, jj, km = tb, tj, tm
            else:
                bb, jj, km = tb[kp], tj[kp], tm[kp]
            tt = lo[jj, km]                  # key-domain footprint = point
            # token ranks: when every used query interval is a POINT the
            # emitted tokens are a subset of the query tokens — rank
            # against that tiny sorted set instead of sorting the emits
            # (extra never-emitted ranks only stretch the composite)
            q_lo = qnp[:, 7:7 + q_m]
            q_hi = qnp[:, 7 + q_m:7 + 2 * q_m]
            used = q_lo <= q_hi
            if (q_lo[used] == q_hi[used]).all():
                uniq_t2 = np.unique(q_lo[used])
                inv_t2 = _exact_ranks(uniq_t2, tt)
            else:
                uniq_t2, inv_t2 = np.unique(tt, return_inverse=True)
            # unique dep slots: presence flags + an inverse-map gather
            # beat a sort once the emit set outgrows the snapshot's slot
            # space (slot ids are dense by construction)
            cap_s = len(msb_a)
            if len(jj) > cap_s // 4:
                flag = np.zeros(cap_s, bool)
                flag[jj] = True
                u_slots = np.nonzero(flag)[0]
                remap = np.empty(cap_s, np.int64)
                remap[u_slots] = np.arange(len(u_slots), dtype=np.int64)
                slot_inv = remap[jj]
            else:
                u_slots, slot_inv = np.unique(jj, return_inverse=True)
            ordr = np.lexsort((node_a[u_slots],
                               lsb_a[u_slots].astype(np.uint64),
                               msb_a[u_slots].astype(np.uint64)))
            rank = np.empty(len(u_slots), np.int64)
            rank[ordr] = np.arange(len(u_slots))
            _finalize_key_batch(builders, bb, tt, inv_t2, len(uniq_t2),
                                rank[slot_inv], len(u_slots), obj_a[jj])
        rp = np.zeros(0, np.int64) if all_key else np.nonzero(~key_dep)[0]
        if len(rp):
            jj_r, bb_r, rm, rq = tj[rp], tb[rp], tm[rp], tq[rp]
            ilo = np.maximum(lo[jj_r, rm], qnp[bb_r, 7 + rq])
            ihi = np.minimum(hi[jj_r, rm], qnp[bb_r, 7 + q_m + rq]) + 1
            _finalize_range_batch(builders, bb_r, ilo, ihi,
                                  msb_a[jj_r], lsb_a[jj_r],
                                  node_a[jj_r], obj_a[jj_r])

    def deps_query_batch_end_attributed(self, safe, handle, builders) -> None:
        """Collect a dispatched batch and fold each query's deps into its
        builder with full host-path semantics.  Attributed handles (every
        protocol path since r15) arrive pre-floored/pre-elided from the
        kernels and take the thin shared finalize; raw handles keep the
        legacy host _attribute_batch pass (the property-test oracle)."""
        import time as _time
        if handle[6].get("attributed"):
            tb, tj, tm, tq, ids, ivs, qnp, q_m, _queries = \
                self._batch_collect_attr(handle)
            _ta = _time.perf_counter()
            self._finalize_attr_entries(tb, tj, tm, tq, ids, ivs, qnp,
                                        q_m, builders)
            self._ktime("host_attr_finalize", _ta)
            return
        b_idx, j_idx, overlap, ids, ivs, qnp, queries = \
            self._batch_collect(handle)
        _ta = _time.perf_counter()
        self._attribute_batch(safe, b_idx, j_idx, overlap, ids, ivs, qnp,
                              queries, builders)
        self._ktime("host_attribute", _ta)


    # ------------------------------------------------------------------
    # fused cross-store dispatch (driven by local.dispatch's per-node
    # DeviceDispatcher)
    # ------------------------------------------------------------------
    def fused_eligible(self, queries):
        """Dispatcher phase A (pure: mutates nothing): can this store's
        pending flush join a fused device launch?  None when the flush
        must (or would) run the host route; else a hint dict carrying the
        packed queries and the modeled solo device element count the
        dispatcher's fused-vs-solo pricing consumes.  A store that ends up
        not fused runs the classic solo flush, which applies the gate /
        probe / route bookkeeping itself."""
        if self.host_pinned or self._dev_quar_flushes > 0 \
                or self.route_override == "host":
            return None
        sh = self.store_shards
        if sh is not None and sh.active and sh.any_quarantined():
            # hybrid (device + host-twin) flushes run solo: a fused
            # member's block is all-device, with no twin part to graft
            return None
        q_m = _pow2_at_least(max(len(t[3]) + len(t[4]) for t in queries))
        packed = [(sb, wit, toks, rngs, tid)
                  for (tid, sb, wit, toks, rngs) in queries]
        qnp = dk.pack_query_matrix(packed, q_m)
        floor_id, prune_np = self._batch_floor(qnp, q_m)
        route = self.route_override
        if route is None:
            route = self._choose_route(qnp, q_m, floor_id)
        if route == "host":
            return None
        nq = qnp.shape[0]
        b_pad = _pow2_at_least(nq, 1)
        cap = self.deps.capacity
        d = 1 if self.mesh is None else self.mesh.size
        solo_elems = b_pad * cap * q_m * self.deps.max_intervals // d
        degenerate = not self.BUCKETED or \
            len(self.deps.wide_entries) > self.deps.WIDE_MAX
        if route != "dense" and not degenerate:
            # the adaptive solo dispatch would probe the bucket index for
            # narrow queries: price solo with the cheaper kernel
            buck = b_pad * (q_m * self.deps.SPAN * self.deps.bucket_keff()
                            + q_m * len(self.deps.wide_entries) // d)
            solo_elems = min(solo_elems, buck)
        # snapshot cost the fused pricing charges: zero when the cached
        # copy is still fresh, one full-column memcpy's worth otherwise
        dm = self.deps
        snap_stale = dm._snap is None or dm._snap[0] != dm.mut_version
        snap_elems = cap * (2 * dm.max_intervals + 10) if snap_stale else 0
        # fused launches run the attributed kernels: build (or reuse) this
        # store's floor/elision index and the per-query bound ranks now,
        # while the mirror is the dispatch-time state
        aidx = self._attr_index()
        return {"dev": self, "queries": list(queries), "qnp": qnp,
                "q_m": q_m, "floor_id": floor_id, "prune": prune_np,
                "nq": nq, "b_pad": b_pad, "cap": cap,
                "m_iv": self.deps.max_intervals, "solo_elems": solo_elems,
                "snap_elems": snap_elems, "aidx": aidx,
                "rankb_np": aidx.rank_bounds(qnp),
                "floor_skip": aidx.floors_match(qnp, q_m, floor_id)}

    def fused_table(self):
        """The (cached, device-resident) table the fused launch reads —
        mesh-sharded under a mesh, single-device otherwise."""
        if self.mesh is not None:
            return self.deps.device_table_sharded(self.mesh)
        return self.deps.device_table()

    def fused_commit(self, hint) -> None:
        """Dispatcher phase B for a chosen fused member: apply the flush-
        gate bookkeeping the solo path would have applied (probe
        accounting), snapshot the mirror columns the deferred harvest
        needs (mutations may land between dispatch and the harvest task),
        and surface the routing decision."""
        probing = False
        if self._dev_backoff > 0:
            probing = True
            self.n_reprobes += 1
            self._fault_event("reprobe", "route=fused")
        hint["ids"], hint["ivs"], hint["kind_col"] = \
            self.deps.snapshot_cols()
        hint["probing"] = probing
        if self.on_route is not None:
            self.on_route("fused", hint["nq"])
        else:
            obs = getattr(self.store.node, "route_observer", None)
            if obs is not None:
                batch = hint.get("batch") or ()
                obs(self.store, "fused", hint["nq"],
                    [q[0] for q, _b, _d in batch])

    def fused_fail_to_host(self, hint, exc) -> None:
        """A device fault inside the fused launch fails the whole batch
        over to the host route: quarantine this member and compute its
        host pairs right now (still inside the dispatcher event, so the
        live mirror IS the dispatch-time state)."""
        self._release_fused_lease(hint)
        self._device_fault(exc, f"fused dispatch: {exc}", sliced=True)
        self.n_fallback_queries += hint["nq"]
        hint["probing"] = False
        hint["host"] = self.deps.host_pairs(hint["qnp"], hint["q_m"],
                                            hint["floor_id"], entries=True)

    def _release_fused_lease(self, hint) -> None:
        lease = hint.pop("lease", None)
        if lease is not None:
            self.deps.release_device(lease)

    def _hint_attr_entries(self, hint, ent4) -> tuple:
        """A fused hint's host-route per-entry answer as the attributed
        entry set: the same floor/elision drops the fused kernel applies,
        over the hint's dispatch-time snapshot columns."""
        cb, cj, cm, cq = ent4
        tb, tj, tm, tq, n_t, n_d = self._attr_filter_entries(
            cb, cj, cm, cq, hint["ids"], hint["ivs"],
            hint["aidx"], hint["rankb_np"], hint.get("floor_skip", False))
        self.n_elided_transitive += n_t
        self.n_elided_decided += n_d
        return tb, tj, tm, tq

    def _fused_snapshot(self, hint):
        return (hint["ids"][0], hint["ids"][1], hint["ids"][2],
                hint["kind_col"], hint["ids"][4], hint["ivs"][0],
                hint["ivs"][1])

    def _fused_collect(self, hint, launch):
        """Download + decode of this store's block of the fused attributed
        result, with the solo path's full semantics: overflow re-run (solo
        attributed, escalated s/k from the exact header, over the leased
        dispatch-time table and attribution columns), the stale-result
        injection point, paranoia shadow-verify against the attr-filtered
        snapshot host scan, probe restore, and whole-batch host failover on
        any device-boundary failure.  Returns attributed entry arrays
        (tb, tj, tm, tq)."""
        import time as _time
        _t0 = _time.perf_counter()
        nq = hint["nq"]
        if "host" in hint:           # launch already failed over to host
            self.n_host_queries += nq
            self.n_dispatches += 1
            return self._hint_attr_entries(hint, hint["host"])
        qnp, q_m = hint["qnp"], hint["q_m"]
        b_pad = hint["b_pad_c"]
        mq, qmc = hint["mq"], hint["q_m_c"]
        pad_stride = hint.get("pad_shard_n")   # mesh: padded slice stride
        try:
            hdr_all, ent_all = launch.materialize()
            hdr = hdr_all[hint["row"]].reshape(1, 5 + b_pad)
            ent = ent_all[hint["row"]].reshape(1, -1)
            s_, k_ = launch.s, launch.k
            runs = 0
            while int(hdr[:, 1].max()) > s_ or int(hdr[:, 2].max()) > k_:
                # overflow: escalate exactly like the solo path — re-run
                # this store alone against the same (leased) table and
                # attribution columns, sized from the exact header
                cap_k = hint["shard_n"] * hint["m_iv"] * qmc
                s_, k_ = self._overflow_resize(
                    int(hdr[:, 1].max()), int(hdr[:, 2].max()), s_, k_,
                    b_pad * cap_k, cap_k, runs)
                dk.launch_check("fused re-run")
                mesh = self.mesh
                udev = self.device if mesh is None else mesh.dev0
                qmat = _upload(hint["qmat_np"], udev)
                rankb = _upload(hint["rankb_pad"], udev)
                pnp = hint["prune"]
                prune = None if pnp is None else tuple(int(x) for x in pnp)
                wide = hint["wide"]
                fl_, el_ = (not hint.get("floor_skip", False),
                            hint["aidx"].u > 0)
                if mesh is not None:
                    from ..parallel.sharded import sharded_flat_attr
                    hdr_dev, ent_dev = sharded_flat_attr(
                        mesh, qmc, s_, k_, wide, fl_, el_)(
                        hint["table"], hint["attr"],
                        hint["aidx"].device_replicated(mesh), qmat, rankb,
                        *(prune or (0, 0, 0)))
                    d_ent = mesh.size
                else:
                    hdr_dev, ent_dev = dk.calculate_deps_flat_attr(
                        hint["table"], hint["attr"],
                        hint["aidx"].device(self.device), qmat, rankb,
                        prune, qmc, s_, k_, wide, fl_, el_)
                    d_ent = 1
                faults.check("transfer", "header download")
                hdr = _host(hdr_dev).reshape(1, 5 + b_pad)
                itemsize = 8 if wide else 4
                self.download_bytes += hdr.nbytes
                self.download_bytes_padded += hdr.nbytes \
                    + d_ent * s_ * itemsize
                if int(hdr[:, 1].max()) <= s_ \
                        and int(hdr[:, 2].max()) <= k_:
                    faults.check("transfer", "entry download")
                    ent = _fetch_entry_prefix(ent_dev, 1, d_ent * s_,
                                              int(hdr[:, 0].max()))
                    self.download_bytes += ent.nbytes
                runs += 1
            if runs:
                # the re-run scanned the store's own table solo, so its
                # codes scale on the store's own interval width and its
                # slot ids are contiguous-global (no fused pad stride)
                mq = hint["m_iv"] * qmc
                pad_stride = None
        except faults.DEVICE_EXCEPTIONS as e:
            # whole-batch failover: quarantine every member, serve this
            # flush from the snapshot host scan (dispatch-time bytes)
            launch.poison(e)
            self.n_fallback_queries += nq
            self.n_host_queries += nq
            self.n_dispatches += 1
            return self._hint_attr_entries(
                hint, self.deps.host_pairs(
                    qnp, q_m, hint["floor_id"],
                    snapshot=self._fused_snapshot(hint), entries=True))
        finally:
            self._release_fused_lease(hint)
        self.n_elided_transitive += int(hdr[:, 3].sum())
        self.n_elided_decided += int(hdr[:, 4].sum())
        self.attr_download_bytes += hdr.nbytes + ent.nbytes
        tb, tj, tm, tq = _decode_triples(hdr, ent, b_pad, hint["cap"],
                                         True, mq, qmc, hoff=5)
        if pad_stride is not None:
            # mesh fused codes number slots on the PADDED per-slice stride
            # (every member padded to the group's largest slice): fold
            # back onto this store's contiguous slot ids
            tj = (tj // pad_stride) * np.int64(hint["cap"]
                                               // hint["d_mesh"]) \
                + tj % pad_stride
        if self._paranoid() and len(tj) \
                and faults.should_fire("stale_result"):
            tj = (tj + np.int64(1)) % np.int64(len(hint["ids"][0]))
        gmap = hint["gmap"]
        b_global = gmap[tb]
        keep = b_global >= 0
        tb, tj, tm, tq = b_global[keep], tj[keep], tm[keep], tq[keep]
        if self._paranoid():
            self.n_shadow_checks += 1
            hb, hj, hm, hq = self._hint_attr_entries(
                hint, self.deps.host_pairs(
                    qnp, q_m, hint["floor_id"],
                    snapshot=self._fused_snapshot(hint), entries=True))
            cap = np.int64(len(hint["ids"][0]))
            if not np.array_equal(np.unique(tb * cap + tj),
                                  np.unique(hb * cap + hj)):
                self.n_shadow_mismatches += 1
                self._device_fault("stale_result", "fused shadow mismatch")
                self.n_fallback_queries += nq
                self.n_dispatches += 1
                return hb, hj, hm, hq
        sh = self.store_shards
        if sh is not None and sh.active:
            sh.note_success()
        if hint.get("probing"):
            self._restore_device()
        self.n_dispatches += 1
        self.n_fused_flushes += 1
        self.n_fused_queries += nq
        if self.mesh is not None:
            self.n_mesh_queries += nq
        else:
            self.n_dense_queries += nq
        self._ktime("wait_attr_fused", _t0)
        return tb, tj, tm, tq

    def fused_harvest(self, safe, hint, launch) -> None:
        """Store-task leg of a fused flush: parse this store's block of
        the fused attributed result (the shared download happens at the
        first member's harvest) and hand the pre-attributed entries to the
        shared finalize over the dispatch-time snapshot — the same bytes
        the solo launch would have produced, harvested at the next
        event-loop boundary in deterministic store order."""
        batch = hint["batch"]
        try:
            tb, tj, tm, tq = self._fused_collect(hint, launch)
            self.n_queries += hint["nq"]
            self.n_kernel_deps += len(tj)
            self._finalize_attr_entries(tb, tj, tm, tq, hint["ids"],
                                        hint["ivs"], hint["qnp"],
                                        hint["q_m"],
                                        [b for _q, b, _d in batch])
        except BaseException as e:  # noqa: BLE001
            for _q, _b, done in batch:
                done(e, None)
            return
        for _q, _b, done in batch:
            done(None, safe)

    # ------------------------------------------------------------------
    # the drain (device replacement of listener fan-out)
    # ------------------------------------------------------------------
    def arm(self, safe, txn_id: TxnId) -> None:
        """Register a Stable/PreApplied txn's remaining waiting set as a
        drain row; the next tick will re-evaluate it."""
        cmd = safe.if_present(txn_id)
        if cmd is None or cmd.waiting_on is None:
            return
        slot = self.drain.alloc(txn_id)
        self.drain.set_status(slot, dk.SLOT_STABLE, cmd.execute_at)
        self.drain.clear_deps(slot)
        for dep in cmd.waiting_on.waiting_ids():
            dslot = self._dep_drain_slot(safe, dep)
            self.drain.add_edge(slot, dslot)
        self.drain.active[slot] = True
        self.schedule_tick()

    def _dep_drain_slot(self, safe, dep: TxnId) -> int:
        slot = self.drain.slot_of.get(dep)
        if slot is not None:
            return slot
        slot = self.drain.alloc(dep)
        cmd = safe.if_present(dep)
        status, exec_at = _drain_status_of(cmd)
        self.drain.set_status(slot, status, exec_at)
        return slot

    def on_terminal(self, txn_id: TxnId) -> None:
        """Truncation/erasure: the txn can never gate execution again
        (ref: _dep_clearance treats truncated as done).  Mark its drain row
        terminal and re-evaluate waiters — without this, truncating a dep
        whose record Cleanup then drops is a lost wakeup in device mode
        (no listeners exist to carry the erase notification)."""
        dslot = self.drain.slot_of.get(txn_id)
        if dslot is not None:
            self.drain.set_status(dslot, dk.SLOT_INVALIDATED, None)
            if self.drain.active.any():
                self.schedule_tick()

    def on_driven(self, txn_id: TxnId) -> None:
        """The txn reached ReadyToExecute/Applying — stop driving it (its
        slot lives on as a dependency of others until terminal + unreferenced)."""
        slot = self.drain.slot_of.get(txn_id)
        if slot is not None:
            self.drain.active[slot] = False
            self.drain.clear_deps(slot)


    def _mesh_tick_pays(self, n: int) -> bool:
        """Regime-adaptive drain tick: row-shard the frontier sweep only
        when the modeled per-slice matvec saving (n^2 work split d ways)
        beats the extra mesh launch cost — the same calibration the deps
        router uses."""
        calib = self._calibration()
        d = self.mesh.size
        single = 2.0 * calib["rtt"] + calib["c_dev"] * float(n) * n
        mesh = 2.0 * calib.get("rtt_mesh", calib["rtt"]) \
            + calib["c_dev"] * float(n) * n / d
        return mesh < single

    # Coalescing quantum for drain ticks (simulated/real micros): many dep
    # transitions land per tick, so the per-tick adjacency upload + kernel
    # sweep amortizes across a whole antichain instead of firing per event.
    TICK_DELAY_MICROS = 2_000

    def schedule_tick(self) -> None:
        if self._tick_scheduled:
            return
        self._tick_scheduled = True
        disp = getattr(self.store.node, "dispatcher", None)
        if disp is not None:
            # node-level coalescing (r08): ticks landing in the same
            # window share one dispatcher event — and, when the cost model
            # says it pays, one fused frontier launch
            disp.register_tick(self)
            return
        from .command_store import PreLoadContext

        def run():
            self.store.execute(PreLoadContext.empty(), self._tick)

        self.store.node.scheduler.once(self.TICK_DELAY_MICROS, run)


    def _tick(self, safe, fused=None) -> None:
        from . import commands
        self._tick_scheduled = False
        self.n_ticks += 1
        sweep_due = self.n_ticks % 8 == 0
        if not self.drain.active.any():
            if sweep_due:
                self.drain.sweep_free()
            return
        # the drain is a device boundary too: while quarantined/degraded
        # the frontier sweeps on host, and an injected device fault mid-
        # tick quarantines + falls back to the host sweep (same rule, same
        # candidates — the per-candidate WaitingOn re-validation below
        # makes any residual divergence a no-op, never a wrong execution).
        # A fused sweep (dispatcher-launched, shared with sibling stores)
        # serves the same candidates; a device failure harvesting it
        # quarantines the whole fused batch, and every member's sweep
        # fails over to host.
        cand_slots = None
        used_fused = False
        mode = None
        if not (self.host_pinned or self._dev_quar_flushes > 0):
            if fused is not None and fused.serves(self):
                try:
                    cand_slots = fused.result_for(self)
                    self.n_fused_ticks += 1
                    self.n_device_ticks += 1
                    used_fused = True
                    mode = "fused"
                except faults.DEVICE_EXCEPTIONS as e:
                    fused.poison(e)
            else:
                try:
                    import time as _time
                    _t0 = _time.perf_counter()
                    dk.launch_check("drain")
                    state, live = self.drain.state()
                    faults.check("transfer", "drain download")
                    wave = self._drain_wavefront
                    fut = pinned = None
                    if wave > 1 and drk.drain_logdepth_enabled():
                        # widened sweep: the level pass proposes the next
                        # ``wave`` executeAt antichains in one launch.
                        # Candidates beyond the true frontier are safe —
                        # the per-candidate host re-validation below makes
                        # a not-actually-ready candidate a no-op — and any
                        # that fail to execute reset the wavefront
                        try:
                            if isinstance(state, drk.EllDrainState):
                                mode = "ell-wave"
                                lv, _r = drk.level_assign_ell(state)
                            else:
                                mode = "wave"
                                lv, _r = drk.level_assign_dense(state)
                            fut = (lv >= 1) & (lv <= wave)
                            self.n_wavefront_ticks += 1
                        except faults.DEVICE_EXCEPTIONS:
                            # fail the widened launch over to the plain
                            # frontier route (the W=1 candidate set); the
                            # outer handler covers the frontier's faults
                            self._drain_wavefront = wave = 1
                            mode = None
                            fut = None
                    if wave > 1 and fut is not None:
                        pass
                    elif isinstance(state, drk.EllDrainState):
                        # large in-flight set: sparse gather sweep, its
                        # flags written into the mirror's pinned buffer
                        mode = "ell"
                        pinned = self.drain.ready_buffer(state)
                        fut = drk.ready_frontier_ell(state, out=pinned)
                    elif self.mesh is not None and \
                            state.status.shape[0] % self.mesh.size == 0 \
                            and self._mesh_tick_pays(state.status.shape[0]):
                        # live mesh path: the frontier sweep row-shards
                        # across the slices (fixpoint analogue:
                        # parallel.sharded.sharded_drain)
                        from ..parallel.sharded import sharded_ready_frontier
                        mode = "mesh"
                        fut = sharded_ready_frontier(self.mesh)(state)
                    else:
                        # the kernel writes the flags straight into the
                        # mirror's pinned host buffer
                        mode = "device"
                        pinned = self.drain.ready_buffer(state)
                        fut = drk.ready_frontier(state, out=pinned)
                    # drain forensics: split the sweep at the dispatch
                    # boundary — upload+enqueue vs the result join
                    _t1 = _time.perf_counter()
                    ready = (_host(fut) if pinned is None else
                             _host_written(fut, state.status.device)
                             )[: len(live)]
                    self._ktime_span("drain_tick_dispatch", _t0, _t1)
                    self._ktime("drain_tick_wait", _t1)
                    self.n_device_ticks += 1
                    cand_slots = live[ready & self.drain.active[live]]
                except faults.DEVICE_EXCEPTIONS as e:
                    self._device_fault(e, f"drain tick: {e}")
        if cand_slots is None:
            self.n_host_ticks += 1
            cand_slots = self._host_ready_slots()
            mode = "host"
        obs = getattr(getattr(self.store, "node", None),
                      "drain_observer", None)
        if obs is not None:
            obs(self.store, mode, int(len(cand_slots)))
        if len(cand_slots) != 0:
            cands = sorted(
                (self.drain.id_of[int(s)] for s in cand_slots
                 if int(s) in self.drain.id_of),
                key=_exec_order_key(safe))
            for txn_id in cands:
                commands.refresh_waiting_and_maybe_execute(safe, txn_id)
        # adaptive wavefront control: widen only in the synchronous-
        # cascade regime — every candidate this tick reached Applied
        # before the tick returned (a serial chain drains in O(log depth)
        # ticks instead of one tick per link).  Anything else (async
        # execution, host or fused route, empty sweep, escape hatch) pins
        # W back to 1, so protocol-flow ticks run the plain frontier sweep
        if mode in ("device", "ell", "wave", "ell-wave") \
                and len(cand_slots) != 0 and drk.drain_logdepth_enabled() \
                and all(int(self.drain.status[int(s)]) == dk.SLOT_APPLIED
                        for s in cand_slots):
            self._drain_wavefront = min(self._drain_wavefront * 2, 8192)
        else:
            self._drain_wavefront = 1
        if sweep_due:
            self.drain.sweep_free()
        if used_fused and self.drain.version != fused.version_for(self) \
                and self.drain.active.any():
            # the fused sweep was computed at dispatch time; mutations that
            # landed between dispatch and this harvest (earlier tasks in
            # this store's queue) could otherwise be a lost wakeup —
            # re-evaluate with a fresh tick
            self.schedule_tick()


def _exec_order_key(safe):
    def key(txn_id: TxnId):
        cmd = safe.if_present(txn_id)
        exec_at = cmd.execute_at if cmd is not None and cmd.execute_at \
            is not None else txn_id
        return (exec_at, txn_id)
    return key


def _drain_status_of(cmd) -> Tuple[int, Optional[Timestamp]]:
    from .status import Status
    if cmd is None:
        return dk.SLOT_TRANSITIVE, None
    if cmd.is_invalidated():
        return dk.SLOT_INVALIDATED, None
    if cmd.is_truncated():
        # truncated == locally done; never gates execution
        return dk.SLOT_INVALIDATED, None
    exec_at = cmd.execute_at_if_known()
    if cmd.has_been(Status.Applied):
        return dk.SLOT_APPLIED, exec_at
    if cmd.has_been(Status.Stable):
        return dk.SLOT_STABLE, exec_at
    if cmd.has_been(Status.Committed):
        return dk.SLOT_COMMITTED, exec_at
    if cmd.has_been(Status.Accepted):
        return dk.SLOT_ACCEPTED, exec_at
    return dk.SLOT_PREACCEPTED, None
