"""Store-sharded device tables: ONE store's slot table partitioned across
the mesh, each slice owning a contiguous slot range.

The port of ``accord_tpu/parallel/store_shard.py``:

- Per-slice buffers.  Slice ``i`` owns slots ``[i*slice_n, (i+1)*slice_n)``
  and keeps its own ``DepsTable`` / ``AttrCols`` on mesh device ``i``.
  Registrations scatter to the OWNING slice only (the scatter_rows kernel,
  in place, on the slice's device), so steady-state sync cost is
  O(dirty rows), not O(capacity).
- Zero-copy assembly.  The sharded kernels consume the tuple of the
  resident slices (``sharded.assemble_slices``): no bytes move.
- Per-slice fault ladder.  A device-boundary failure during a sliced flush
  quarantines the SLICE it touched (exponential backoff in flushes, seeded
  jitter, one instance per slice).  While a slice is quarantined its status
  slice is replaced by a SLOT_FREE column in the assembled table, so healthy
  slices keep answering on device and the sick slice's slots answer from
  the host twin, byte-identically.

The slices are updated in place, so an escalated re-launch of a pipelined
query must read them as of its begin: the mirror's lease (``share_device``)
holds the assembled table's first slice of each column, and a scatter into
a leased slice copies it first.

Activation is a budget-ladder rung (DeviceState._approve_grow): breach ->
compact -> SPILL TO SHARDED (when a mesh is available) -> host-pinned.
``ACCORD_TPU_STORE_SHARD=off`` disables the rung.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..ops import deps_kernel as dk
from ..ops import kernels
from ..utils import faults
from ..utils.random_source import RandomSource

# flushes a slice stays quarantined after its first failure / ceiling —
# the same ladder constants the whole-device quarantine uses
_BACKOFF_BASE = 4
_BACKOFF_MAX = 256


def store_shard_enabled() -> bool:
    """The escape hatch: ``ACCORD_TPU_STORE_SHARD=off`` (or 0/false/no)
    removes the spill-to-sharded rung — the ladder degrades straight to
    host-pinned."""
    return os.environ.get("ACCORD_TPU_STORE_SHARD", "").lower() \
        not in ("off", "0", "false", "no")


def _pow2_at_least(n: int, floor: int) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


class StoreShards:
    """Sliced device residency for one store's ``_DepsMirror`` plus the
    per-slice quarantine ladder.  Owned by a DeviceState (which holds the
    counters and fault-event plumbing); the mirror routes
    ``device_table_sharded`` / ``device_attr_cols_sharded`` through here
    while ``active``."""

    def __init__(self, owner, mirror, mesh):
        self.owner = owner          # DeviceState (counters + fault events)
        self.mirror = mirror
        self.mesh = mesh
        self.devices = list(mesh.devices)
        self.d = len(self.devices)
        self.active = False
        # per-slice residency
        self._tables: List[Optional[dk.DepsTable]] = [None] * self.d
        self._attrs: List[Optional[dk.AttrCols]] = [None] * self.d
        self._shape = None          # (capacity, max_intervals) slices match
        self._attr_cap = None
        self._gen = 0               # bumps on any slice table upload
        self._attr_gen = 0
        self._asm = None            # cached assembled DepsTable
        self._asm_key = None
        self._attr_asm = None
        self._attr_asm_key = None
        self._free_masks = {}       # slice_n -> per-device SLOT_FREE slice
        # per-slice quarantine ladder; jitter seeded from the owner's so
        # schedules are deterministic yet distinct per (node, store, slice)
        self.quar = [0] * self.d            # remaining quarantined flushes
        self.backoff = [0] * self.d
        self.suspect = [False] * self.d     # countdown expired: probing
        node_id = getattr(getattr(owner.store, "node", None), "node_id", 0)
        self._jitter = RandomSource(
            0x5117CE ^ (node_id << 16)
            ^ getattr(owner.store, "store_id", 0))
        # the slice a device-boundary failure should be attributed to: set
        # before every per-slice upload, read by slice_fault
        self.last_slice_touched: Optional[int] = None

    # -- activation ------------------------------------------------------
    def activate(self) -> None:
        if self.active:
            return
        self.active = True
        self.mirror.shards = self
        self._shape = None          # full per-slice build on next table()
        self._attr_cap = None
        self.mirror._dirty_sh.clear()
        self.mirror._attr_dirty_sh.clear()

    def deactivate(self) -> None:
        self.active = False
        if self.mirror.shards is self:
            self.mirror.shards = None
        self._tables = [None] * self.d
        self._attrs = [None] * self.d
        self._asm = self._attr_asm = None
        self._shape = self._attr_cap = None

    # -- slot-slice geometry ---------------------------------------------
    def slice_n(self) -> int:
        # capacity and d are both powers of two with capacity >= d
        return self.mirror.capacity // self.d

    def slice_of(self, slot: int) -> int:
        return min(slot // self.slice_n(), self.d - 1)

    # -- per-slice sync --------------------------------------------------
    def _full_slice(self, i: int) -> None:
        m = self.mirror
        sn = m.capacity // self.d
        lo, hi = i * sn, (i + 1) * sn
        dev = self.devices[i]
        self.last_slice_touched = i
        faults.check("transfer", f"slice {i} slot upload")
        self._tables[i] = dk.DepsTable(
            *(_upload(a[lo:hi], dev) for a in
              (m.msb, m.lsb, m.node, m.kind, m.status, m.lo, m.hi)))

    def _scatter_slice(self, i: int, rows: np.ndarray) -> None:
        """Dirty-row sync of slice ``i`` (rows are GLOBAL slot indices all
        owned by the slice), in place on the slice's device; >= half-dirty
        re-uploads whole."""
        m = self.mirror
        sn = m.capacity // self.d
        if self._tables[i] is None or len(rows) * 2 >= sn:
            self._full_slice(i)
            return
        self.last_slice_touched = i
        faults.check("transfer", f"slice {i} slot upload")
        padded = _pow2_at_least(len(rows), 8)
        rows_p = np.concatenate(
            [rows, np.full(padded - len(rows), rows[-1], np.int64)])
        local = rows_p - i * sn
        self._tables[i] = m._own(self._tables[i])
        kernels.scatter_rows(
            list(self._tables[i]), local,
            [m.msb[rows_p], m.lsb[rows_p], m.node[rows_p], m.kind[rows_p],
             m.status[rows_p], m.lo[rows_p], m.hi[rows_p]])

    def _sync_tables(self) -> None:
        m = self.mirror
        shape = (m.capacity, m.max_intervals)
        if shape != self._shape:
            # capacity / interval growth redistributes slots across slices
            # (slot // slice_n changes wholesale): full per-slice rebuild
            m._dirty_sh.clear()
            for i in range(self.d):
                self._full_slice(i)
            self._shape = shape
            self._gen += 1
            return
        if not m._dirty_sh:
            return
        rows = np.array(sorted(m._dirty_sh), np.int64)
        m._dirty_sh.clear()
        sn = m.capacity // self.d
        sl = rows // sn
        for i in range(self.d):
            ri = rows[sl == i]
            if len(ri):
                self._scatter_slice(i, ri)
        self._gen += 1

    def _attr_slice_cols(self, i: int):
        m = self.mirror
        sn = m.capacity // self.d
        lo, hi = i * sn, (i + 1) * sn
        return (m.domain[lo:hi].astype(np.int32), m.status[lo:hi],
                m.msb[lo:hi], m.lsb[lo:hi], m.node[lo:hi],
                m.emsb[lo:hi], m.elsb[lo:hi], m.enode[lo:hi],
                m.eknown[lo:hi])

    def _full_attr_slice(self, i: int) -> None:
        dev = self.devices[i]
        self.last_slice_touched = i
        faults.check("transfer", f"slice {i} attr upload")
        self._attrs[i] = kernels.checked_cols(dk.AttrCols(
            *(_upload(a, dev) for a in self._attr_slice_cols(i))))

    def _sync_attrs(self) -> None:
        m = self.mirror
        if m.capacity != self._attr_cap:
            m._attr_dirty_sh.clear()
            for i in range(self.d):
                self._full_attr_slice(i)
            self._attr_cap = m.capacity
            self._attr_gen += 1
            return
        if not m._attr_dirty_sh:
            return
        rows = np.array(sorted(m._attr_dirty_sh), np.int64)
        m._attr_dirty_sh.clear()
        sn = m.capacity // self.d
        sl = rows // sn
        for i in range(self.d):
            ri = rows[sl == i]
            if not len(ri):
                continue
            if self._attrs[i] is None or len(ri) * 2 >= sn:
                self._full_attr_slice(i)
                continue
            self.last_slice_touched = i
            faults.check("transfer", f"slice {i} attr upload")
            padded = _pow2_at_least(len(ri), 8)
            rows_p = np.concatenate(
                [ri, np.full(padded - len(ri), ri[-1], np.int64)])
            local = rows_p - i * sn
            self._attrs[i] = m._own(self._attrs[i])
            kernels.scatter_rows(
                list(self._attrs[i]), local,
                [m.domain[rows_p].astype(np.int32), m.status[rows_p],
                 m.msb[rows_p], m.lsb[rows_p], m.node[rows_p],
                 m.emsb[rows_p], m.elsb[rows_p], m.enode[rows_p],
                 m.eknown[rows_p]])
        self._attr_gen += 1

    # -- assembled (sharded) views -----------------------------------------
    def _free_status(self, i: int, sn: int) -> torch.Tensor:
        """Cached SLOT_FREE status slice for a quarantined slice: masked
        slots emit nothing from the dep mask, so the host twin is the sole
        authority for them — byte-identity by construction."""
        per = self._free_masks.get(sn)
        if per is None:
            # capacity grew: masks for the old slice width are useless
            self._free_masks = {sn: [None] * self.d}
            per = self._free_masks[sn]
        if per[i] is None:
            per[i] = torch.full((sn,), dk.SLOT_FREE, dtype=torch.int32,
                                device=self.devices[i])
        return per[i]

    def table(self) -> dk.DepsTable:
        """The sharded DepsTable the mesh kernels consume, with quarantined
        slices' status replaced by SLOT_FREE.  Assembly is zero-copy over
        the resident slices; the cache keys on the upload generation and
        the quarantine mask."""
        self._sync_tables()
        m = self.mirror
        qmask = tuple(q > 0 for q in self.quar)
        key = (self._gen, self._shape, qmask,
               tuple(id(t.msb) for t in self._tables))
        if self._asm is not None and self._asm_key == key:
            return self._asm
        from .sharded import assemble_slices
        sn = m.capacity // self.d
        tabs = self._tables
        status = [self._free_status(i, sn) if qmask[i] else tabs[i].status
                  for i in range(self.d)]
        cap, m_iv = m.capacity, m.max_intervals
        self._asm = dk.DepsTable(
            assemble_slices(self.mesh, [t.msb for t in tabs], (cap,)),
            assemble_slices(self.mesh, [t.lsb for t in tabs], (cap,)),
            assemble_slices(self.mesh, [t.node for t in tabs], (cap,)),
            assemble_slices(self.mesh, [t.kind for t in tabs], (cap,)),
            assemble_slices(self.mesh, status, (cap,)),
            assemble_slices(self.mesh, [t.lo for t in tabs], (cap, m_iv),
                            two_d=True),
            assemble_slices(self.mesh, [t.hi for t in tabs], (cap, m_iv),
                            two_d=True))
        self._asm_key = key
        return self._asm

    def attr_cols(self) -> dk.AttrCols:
        """The slot-sharded AttrCols twin of table().  No masking needed:
        attribution only grades entries the dep mask emitted, and masked
        slots emit nothing."""
        self._sync_attrs()
        key = (self._attr_gen, self._attr_cap,
               tuple(id(a.dom) for a in self._attrs))
        if self._attr_asm is not None and self._attr_asm_key == key:
            return self._attr_asm
        from .sharded import assemble_slices
        cap = self._attr_cap
        self._attr_asm = dk.AttrCols(
            *(assemble_slices(self.mesh, [a[f] for a in self._attrs],
                              (cap,))
              for f in range(9)))
        self._attr_asm_key = key
        return self._attr_asm

    # -- per-slice quarantine ladder -------------------------------------
    def tick_flush(self) -> None:
        """One sharded flush is passing the gate: quarantined slices count
        it down; a slice whose countdown expires becomes a SUSPECT — it
        rejoins the device mask, and the flush that includes it is its
        probe (note_success restores, a failure re-quarantines deeper)."""
        for i in range(self.d):
            if self.quar[i] > 0:
                self.quar[i] -= 1
                if self.quar[i] == 0:
                    self.suspect[i] = True
                    self.owner._fault_event("slice.reprobe", f"slice={i}")

    def any_quarantined(self) -> bool:
        return any(q > 0 for q in self.quar)

    def quarantined_slices(self) -> List[int]:
        return [i for i in range(self.d) if self.quar[i] > 0]

    def quarantined_slot_mask(self, cj: np.ndarray) -> np.ndarray:
        """bool mask over GLOBAL slot indices: True where the owning slice
        is quarantined (those entries come from the host twin)."""
        sn = self.mirror.capacity // self.d
        q = np.array([qq > 0 for qq in self.quar], bool)
        return q[np.clip(cj // sn, 0, self.d - 1)]

    def slice_fault(self, kind: str, detail: str = "") -> None:
        """Attribute one device-boundary failure to a slice and quarantine
        it: the slice whose upload was in flight when the failure fired,
        else a probing suspect (its probe failed), else a deterministic
        jitter pick (collects after a merged download can't localize)."""
        i = self.last_slice_touched
        if i is None:
            sus = [s for s in range(self.d) if self.suspect[s]]
            i = sus[0] if sus else self._jitter.next_int(self.d)
        self.last_slice_touched = None
        self.suspect[i] = False
        self.backoff[i] = min(self.backoff[i] + 1, 8)
        base = min(_BACKOFF_BASE << (self.backoff[i] - 1), _BACKOFF_MAX)
        self.quar[i] = base + self._jitter.next_int(max(base // 2, 1))
        self.owner.n_slice_quarantines += 1
        self.owner._fault_event(
            "slice.quarantine",
            f"slice={i} {kind} backoff={self.quar[i]}")

    def note_success(self) -> None:
        """A sharded flush completed end-to-end on device: every probing
        suspect slice is healthy again."""
        for i in range(self.d):
            if self.suspect[i]:
                self.suspect[i] = False
                self.backoff[i] = 0
                self.owner.n_slice_restores += 1
                self.owner._fault_event("slice.restore", f"slice={i}")
        self.last_slice_touched = None
