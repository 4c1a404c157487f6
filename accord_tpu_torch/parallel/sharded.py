"""Shard parallelism over a mesh of slices, in PyTorch.

The port of ``accord_tpu/parallel/sharded.py``.  The reference shards a
conflict-index slot table (and a drain's adjacency rows) across the devices
of a ``jax.sharding.Mesh`` and runs ``shard_map`` programs whose shards
combine through all-gathers and sums.  Here a :class:`Mesh` is an ordered
tuple of ``torch.device``s under the axis name ``STORE_AXIS``; the same
device may repeat, so that d slices can share one card (or the CPU), as the
reference's tests run 8 virtual CPU devices.

- A sharded array is the tuple of its per-slice tensors, slice i on mesh
  device i (a sharded table is a DepsTable whose columns are such tuples).
  ``shard_table`` and ``assemble_slices`` build that tuple: row views of
  one tensor, or the resident slices themselves, so no bytes move when the
  slices share a device.
- Each program runs its shards' local bodies with the port's kernels
  (``ops.kernels``): the slot slices of one device go to one launch where
  the kernel reads them through a pointer table (K11 ``calc_deps``, the
  token gather ``attr_tok``) or its parameter (K13 ``sharded_frontier``,
  ``sharded_drain`` and the one-launch fixpoint ``sharded_drain_fix``),
  and per slice where the local body is one of the
  single-table kernels (K1a, K1b, K2) or the fused K5.  A kernel never
  reads another device's memory.
- The reference's all-gathers and sums become copies outside the kernels
  (``.to(device)``), which are no-ops when the slices share one card; the
  cross-shard merge of attributed blocks is K12 ``merge_blocks`` on mesh
  device 0, and the cross-shard max is K11 ``ts_max``.

Block order is the mesh order (JAX's all_gather puts shard i at index i).
The functions named ``*_plain`` are the plain versions K12, K13 and the
token gather are held against.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops import deps_kernel as dk
from ..ops import kernels
from ..ops.packing import ts_lt

STORE_AXIS = "store"


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` -> the current card, as the
    tensors placed there report it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ordered tuple of devices under the one axis ``STORE_AXIS``."""

    def __init__(self, devices):
        self.devices = tuple(_indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {STORE_AXIS: len(self.devices)}

    def groups(self) -> Dict[torch.device, List[int]]:
        """Slice indices by device, each list ascending (mesh order)."""
        out: Dict[torch.device, List[int]] = {}
        for i, dev in enumerate(self.devices):
            out.setdefault(dev, []).append(i)
        return out

    @property
    def dev0(self) -> torch.device:
        return self.devices[0]

    def key(self) -> tuple:
        return tuple(str(d) for d in self.devices)


def make_mesh(n_devices: int, device=None) -> Mesh:
    """A mesh of ``n_devices`` slices: all on ``device`` when given (the
    same device repeated), else on the first ``n_devices`` CUDA devices."""
    if device is not None:
        return Mesh([device] * n_devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(f"make_mesh({n_devices}): {have} CUDA devices "
                           "visible (pass device= to share one)")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)])


# -- placement ----------------------------------------------------------------

def _split_rows(mesh: Mesh, a: torch.Tensor) -> tuple:
    d = mesh.size
    if a.shape[0] % d:
        raise ValueError(f"{a.shape[0]} rows do not divide over {d} slices")
    return tuple(c.to(dev) for c, dev in zip(torch.chunk(a, d, dim=0),
                                             mesh.devices))


def shard_table(mesh: Mesh, table: dk.DepsTable) -> dk.DepsTable:
    """Place the slot dimension across the mesh; capacity must divide
    evenly."""
    from ..utils import faults
    faults.check("transfer", "shard_table upload")
    return dk.DepsTable(*(_split_rows(mesh, c) for c in table))


def shard_bucket_table(mesh: Mesh, buckets: dk.BucketTable) -> dk.BucketTable:
    """Place a BucketTable's bucket rows and its wide list across the mesh
    (both must divide the slice count evenly)."""
    from ..utils import faults
    faults.check("transfer", "shard_bucket_table upload")
    return dk.BucketTable(*(_split_rows(mesh, c) for c in buckets))


def assemble_slices(mesh: Mesh, shards, shape, two_d: bool = False) -> tuple:
    """The sharded array of per-slice buffers already resident on their
    mesh devices: the tuple of them, checked against the global ``shape``
    (``two_d``: a (slot, interval) layout whose second axis is whole).
    No bytes move."""
    shards = tuple(shards)
    d = mesh.size
    if len(shards) != d or shape[0] % d:
        raise ValueError(f"{len(shards)} slices for a {d}-slice mesh over "
                         f"{shape[0]} rows")
    want = (shape[0] // d,) + (tuple(shape[1:]) if two_d else ())
    for s, dev in zip(shards, mesh.devices):
        if tuple(s.shape) != want or s.device != dev:
            raise ValueError(f"slice {tuple(s.shape)} on {s.device} is not "
                             f"{want} on {dev}")
    return shards


def slice_of(nt, i: int):
    """Slice ``i`` of a sharded NamedTuple (each field a tuple)."""
    return type(nt)(*(c[i] for c in nt))


def gather(mesh: Mesh, shards, dim: int = 0) -> torch.Tensor:
    """All-gather onto mesh device 0: the slices concatenated in mesh
    order."""
    return torch.cat([s.to(mesh.dev0) for s in shards], dim=dim)


def _on(x, dev: torch.device):
    """A tensor or NamedTuple of tensors on ``dev`` (a no-op copy when it
    is there already): the replicated operand of a shard body."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(dev)
    return type(x)(*(c.to(dev) for c in x))


def _prune_of(pm, pl, pn):
    if pm is None:
        return None
    return (int(pm), int(pl), int(pn))


def _sharded_rows(mesh: Mesh, state):
    """A drain state's row slices: (adj, status, emsb, elsb, enode,
    awaits) per slice, from a sharded state (tuples) or a whole one
    (split by rows)."""
    if isinstance(state.status, tuple):
        return [slice_of(state, i) for i in range(mesh.size)]
    cols = [_split_rows(mesh, c) for c in state]
    return [type(state)(*(c[i] for c in cols)) for i in range(mesh.size)]


# -- K11: slot-sharded calculate_deps -----------------------------------------

def sharded_calculate_deps(mesh: Mesh):
    """fn(table, query, prune_msb, prune_lsb, prune_node) -> (dep_mask,
    max_conflict): the mask column-sharded (the tuple of the slices'
    bool[B, n_i]), max_conflict (msb, lsb, node)[B] on mesh device 0 — the
    per-shard candidates gathered and reduced lexicographically (a
    candidate counts when any field is non-zero)."""
    def call(table, query, prune_msb=None, prune_lsb=None, prune_node=None):
        prune = _prune_of(prune_msb, prune_lsb, prune_node)
        d = mesh.size
        masks = [None] * d
        cand = [None] * d
        groups = mesh.groups()
        for dev, idx in groups.items():
            tabs = [slice_of(table, i) for i in idx]
            mk, (cm, cl, cn) = kernels.calc_deps(tabs, _on(query, dev), prune)
            for r, i in enumerate(idx):
                masks[i] = mk[r]
                cand[i] = (cm, cl, cn, r)
        if len(groups) == 1:
            cm, cl, cn, _r = cand[0]
        else:
            cm, cl, cn = (torch.stack([c[f][c[3]].to(mesh.dev0)
                                       for c in cand]) for f in range(3))
        return tuple(masks), kernels.ts_max(cm, cl, cn)

    return call


# -- K13: the row-sharded frontier and fixpoint drain --------------------------

def _cols_on(dev, slices, applied=None):
    return [(s.status.to(dev), s.exec_msb.to(dev), s.exec_lsb.to(dev),
             s.exec_node.to(dev),
             None if applied is None else applied[j].to(dev))
            for j, s in enumerate(slices)]


def sharded_ready_frontier(mesh: Mesh):
    """Row-sharded single frontier sweep — the live ``DeviceState._tick``
    path under a mesh.  fn(state) -> ready bool[N] on mesh device 0."""
    def call(state):
        slices = _sharded_rows(mesh, state)
        n_l = slices[0].status.shape[0]
        n = n_l * mesh.size
        outs = [torch.empty(n_l, dtype=torch.bool, device=dev)
                for dev in mesh.devices]
        for dev, idx in mesh.groups().items():
            cols = _cols_on(dev, slices)
            rows = [(*slices[i], None, outs[i], i) for i in idx]
            kernels.sharded_frontier(rows, cols, n_l, n)
        return gather(mesh, outs)

    return call


def sharded_drain(mesh: Mesh):
    """Row-sharded fixpoint drain: fn(state) -> (applied[N], newly[N]) on
    mesh device 0.  When every slice lies on one device, one cooperative
    launch runs the whole fixpoint (K13 ``sharded_drain_fix``); otherwise
    ``drain_by_sweeps``."""
    def call(state):
        if len(mesh.groups()) > 1:
            return drain_by_sweeps(mesh, state)
        slices = _sharded_rows(mesh, state)
        n_l = slices[0].status.shape[0]
        dev = mesh.dev0
        outs = [torch.empty(n_l, dtype=torch.bool, device=dev)
                for _ in slices]
        kernels.sharded_drain_fix(
            [(*s, None, outs[i], i) for i, s in enumerate(slices)],
            _cols_on(dev, slices), n_l, n_l * mesh.size)
        full = gather(mesh, outs)
        return full, full & ~gather(mesh, [s.status == dk.SLOT_APPLIED
                                           for s in slices])

    return call


def drain_by_sweeps(mesh: Mesh, state):
    """``sharded_drain`` of a mesh whose slices span devices: one launch
    a device a sweep (K13 ``sharded_drain``); after each the host reads
    the changed flags and gathers the applied slices for the next sweep,
    until no slice changed.  (applied[N], newly[N]) on mesh device 0."""
    slices = _sharded_rows(mesh, state)
    n_l = slices[0].status.shape[0]
    n = n_l * mesh.size
    applied0 = [s.status == dk.SLOT_APPLIED for s in slices]
    applied = applied0
    groups = mesh.groups()
    static = {dev: _cols_on(dev, slices) for dev in groups}
    while True:
        nxt = [torch.empty(n_l, dtype=torch.bool, device=dev)
               for dev in mesh.devices]
        flags = []
        for dev, idx in groups.items():
            cols = [c[:4] + (applied[j].to(dev),)
                    for j, c in enumerate(static[dev])]
            rows = [(*slices[i], cols[i][4], nxt[i], i) for i in idx]
            flags.append(kernels.sharded_drain(rows, cols, n_l, n))
        applied = nxt
        if not any(int(f.item()) for f in flags):
            break
    full = gather(mesh, applied)
    return full, full & ~gather(mesh, applied0)


def drain_fix_plain(rows, cols, n_l: int) -> torch.Tensor:
    """The plain version of ``ops.kernels.sharded_drain_fix``: the K13
    sweep repeated to its fixpoint, each sweep reading the previous one's
    applied set.  Writes each slice's applied flags to its out; returns
    the sweep count (int32[1], the final empty sweep included)."""
    applied = [c[0] == dk.SLOT_APPLIED for c in cols]
    sweeps = 0
    while True:
        nxt = [torch.empty_like(a) for a in applied]
        cs = [c[:4] + (applied[j],) for j, c in enumerate(cols)]
        rs = [(*r[:6], applied[r[8]], nxt[r[8]], r[8]) for r in rows]
        changed = sweep_plain(rs, cs, n_l, drain=True)
        applied = nxt
        sweeps += 1
        if not int(changed[0]):
            break
    for r in rows:
        r[7].copy_(applied[r[8]])
    return torch.tensor([sweeps], dtype=torch.int32, device=rows[0][1].device)


def sweep_plain(rows, cols, n_l: int, drain: bool):
    """The plain version of the K13 sweep over ``rows`` (see
    ``ops.kernels.sharded_frontier`` / ``sharded_drain``): the reference's
    blocking relation with the row's exec local and the columns' gathered.
    Returns the changed flag (int32[1]) of a drain sweep."""
    status = torch.cat([c[0] for c in cols])
    em = torch.cat([c[1] for c in cols])
    el = torch.cat([c[2] for c in cols])
    en = torch.cat([c[3] for c in cols])
    undecided = (status >= 0) & (status < dk.SLOT_COMMITTED)
    dead = (status == dk.SLOT_INVALIDATED) | (status == dk.SLOT_FREE)
    if drain:
        col_applied = torch.cat([c[4] for c in cols])
    else:
        col_applied = status == dk.SLOT_APPLIED
    changed = False
    dev = rows[0][1].device
    for adj, st, rm, rl, rn, aw, applied, out, _i in rows:
        exec_before = ts_lt(em[None, :], el[None, :], en[None, :],
                            rm[:, None], rl[:, None], rn[:, None])
        blocking = adj & (undecided[None, :] | exec_before | aw[:, None]) \
            & ~dead[None, :]
        waiting = (blocking & ~col_applied[None, :]).any(dim=1)
        if drain:
            ready = (st == dk.SLOT_STABLE) & ~applied & ~waiting
            out.copy_(applied | ready)
            changed = changed or bool(ready.any())
        else:
            out.copy_((st == dk.SLOT_STABLE) & ~waiting)
    return torch.tensor([int(changed)], dtype=torch.int32, device=dev)


# -- per-slice launches of the single-table kernels ----------------------------

def _stack_blocks(mesh: Mesh, hdrs, ents):
    """The d shard blocks gathered on mesh device 0 in mesh order:
    (header int32[d * (2+B)], entries [d * s])."""
    return (torch.cat([h.to(mesh.dev0) for h in hdrs]),
            torch.cat([e.to(mesh.dev0) for e in ents]))


def sharded_calculate_deps_flat(mesh: Mesh, m: int, s: int, k: int,
                                wide: bool = False):
    """Slot-sharded calculate_deps_flat: each slice scans and compacts its
    own slots (K1b), the blocks concatenate in mesh order.  Returns
    fn(table, qmat) -> (header int32[d*(2+B)], entries [d*s]) with
    SHARD-LOCAL triple codes."""
    def call(table, qmat):
        outs = [kernels.deps_dense(slice_of(table, i), qmat.to(dev), m, s, k,
                                   None, wide)
                for i, dev in enumerate(mesh.devices)]
        return _stack_blocks(mesh, [h for h, _e in outs],
                             [e for _h, e in outs])

    return call


def sharded_calculate_deps_flat_pruned(mesh: Mesh, m: int, s: int, k: int,
                                       wide: bool = False):
    """sharded_calculate_deps_flat with the replicated prune floor:
    fn(table, qmat, pm, pl, pn)."""
    def call(table, qmat, pm, pl, pn):
        prune = _prune_of(pm, pl, pn)
        outs = [kernels.deps_dense(slice_of(table, i), qmat.to(dev), m, s, k,
                                   prune, wide)
                for i, dev in enumerate(mesh.devices)]
        return _stack_blocks(mesh, [h for h, _e in outs],
                             [e for _h, e in outs])

    return call


def sharded_bucketed_flat(mesh: Mesh, m: int, span: int, s: int, k: int,
                          m_t: int = None, keff: int = None,
                          wide: bool = False):
    """Row-sharded bucketed_flat: each slice probes only the bucket rows
    it owns (K1a with ``row_offset``), entries carry GLOBAL slot ids, and
    a triple may surface in several shard blocks (the host dedupes).
    fn(buckets, qmat, pm, pl, pn) -> (header int32[d*(2+B)],
    entries [d*s])."""
    def call(buckets, qmat, pm, pl, pn):
        prune = _prune_of(pm, pl, pn)
        outs = []
        for i, dev in enumerate(mesh.devices):
            bt = slice_of(buckets, i)
            outs.append(kernels.deps_bucketed(
                m_t, bt, qmat.to(dev), m, span, s, k, prune, keff, wide,
                row_offset=i * bt.blo.shape[0]))
        return _stack_blocks(mesh, [h for h, _e in outs],
                             [e for _h, e in outs])

    return call


def _fused_prunes(pm, pl, pn):
    return tuple(np.asarray(torch.as_tensor(p).cpu(), np.int64)
                 for p in (pm, pl, pn))


def sharded_fused_flat(mesh: Mesh, n_stores: int, m: int, s: int, k: int,
                       wide: bool = False):
    """Batched-over-stores sharded_calculate_deps_flat: per slice one K5
    launch over the S stores' slices, each padded to the group's largest
    slice.  fn(*tables, qmats, pm, pl, pn) -> (header int32[S, d*(2+B)],
    entries [S, d*s]), SHARD-LOCAL codes on the group interval width."""
    def call(*args):
        tables = args[:n_stores]
        qmats, pm, pl, pn = args[n_stores:]
        prunes = _fused_prunes(pm, pl, pn)
        hs, es = [], []
        for i, dev in enumerate(mesh.devices):
            h, e = kernels.fused_deps_dense(
                [slice_of(t, i) for t in tables], qmats.to(dev), prunes, m,
                s, k, wide)
            hs.append(h.to(mesh.dev0))
            es.append(e.to(mesh.dev0))
        return (torch.stack(hs, dim=1).reshape(n_stores, -1),
                torch.stack(es, dim=1).reshape(n_stores, -1))

    return call


def sharded_protocol_step(mesh: Mesh):
    """The multi-slice step: deps for a query batch + the execution drain.
    step(table, query, state) -> (dep_mask, max_conflict, applied, newly)."""
    deps_fn = sharded_calculate_deps(mesh)
    drain_fn = sharded_drain(mesh)

    def step(table, query, state):
        dep_mask, max_conflict = deps_fn(table, query)
        applied, newly = drain_fn(state)
        return dep_mask, max_conflict, applied, newly

    return step


# -- K12: the attributed kernels' cross-shard merge ----------------------------

def merge_shard_blocks_plain(hdrs, ents, b: int, s: int, codespace: int,
                             dedupe_key_m: int, dom=None, mq: int = None):
    """The reference's ``_merge_shard_blocks``: ``hdrs`` int32[d, 5+B],
    ``ents`` [d, s] GLOBAL codes -> (header int32[5+B], entries [d*s]):
    one flat sort of the (row, code) composites, in the bucketed form
    (``dedupe_key_m`` > 0) the dedupe of identical codes and of
    key-domain (row, slot, col) repeats, and a recompacted row_end."""
    d = hdrs.shape[0]
    dev = ents.device
    totals = hdrs[:, 0].to(torch.int64)
    row_end = hdrs[:, 5:].to(torch.int64).contiguous()
    pos = torch.arange(s, dtype=torch.int64, device=dev)
    row_of = torch.searchsorted(row_end, pos.expand(d, s).contiguous(),
                                right=True)
    live = pos[None, :] < totals[:, None]
    inf = int(np.iinfo(np.int64).max)
    code = ents.to(torch.int64)
    comp = torch.where(live, row_of * codespace + code,
                       torch.full_like(code, inf))
    comp = torch.sort(comp.reshape(-1)).values
    keep = comp != inf
    one = torch.ones(1, dtype=torch.bool, device=dev)
    if dedupe_key_m:
        first = torch.cat([one, comp[1:] != comp[:-1]])
        pair = torch.div(comp, dedupe_key_m, rounding_mode="floor")
        firstp = torch.cat([one, pair[1:] != pair[:-1]])
        mcode = torch.remainder(comp, codespace)
        di = torch.clamp(torch.div(mcode, mq, rounding_mode="floor"), 0,
                         dom.shape[0] - 1)
        is_key = dom[di] == 0
        keep = keep & first & (~is_key | firstp)
    n = d * s
    out_pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    merged_row = torch.where(keep, torch.div(comp, codespace,
                                             rounding_mode="floor"),
                             torch.zeros_like(comp))
    merged_row = torch.where(merged_row < 0, merged_row + b, merged_row)
    ok = keep & (merged_row >= 0) & (merged_row < b)
    counts = torch.zeros(b + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, torch.where(ok, merged_row,
                                     torch.full_like(merged_row, b)),
                      ok.to(torch.int64))
    m_end = torch.cumsum(counts[:b], 0)
    out = torch.full((n + 1,), -1, dtype=ents.dtype, device=dev)
    out.index_put_((torch.where(keep, out_pos, torch.full_like(out_pos, n)),),
                   torch.remainder(comp, codespace).to(ents.dtype))
    h = hdrs.to(torch.int64)
    head = torch.stack([m_end[-1], h[:, 1].max(), h[:, 2].max(),
                        h[:, 3].sum(), h[:, 4].sum()]).to(torch.int32)
    return torch.cat([head, m_end.to(torch.int32)]), out[:n]


def merge_blocks_plain(blocks, b: int, s: int, codespace: int,
                       dedupe_key_m: int = 0, dom=None, mq: int = None):
    """The plain version of ``ops.kernels.merge_blocks``: per store, the
    shard blocks' codes globalized by their offsets and stacked, then the
    reference's merge."""
    outs = []
    for blk in blocks:
        hdrs = torch.stack([h for h, _e, _o in blk])
        ents = torch.stack([torch.where(e >= 0, e + o, e) if o else e
                            for _h, e, o in blk])
        outs.append(merge_shard_blocks_plain(hdrs, ents, b, s, codespace,
                                             dedupe_key_m, dom, mq))
    return (torch.stack([h for h, _e in outs]),
            torch.stack([e for _h, e in outs]))


def attr_tok_plain(ents, los, sn: int, m_t: int, m: int) -> torch.Tensor:
    """The plain version of ``ops.kernels.attr_tok``: int64[d, s]."""
    code = torch.stack(list(ents)).to(torch.int64)
    mq = m_t * m
    slot = torch.clamp(torch.div(code, mq, rounding_mode="floor"), min=0)
    col = torch.clamp(torch.div(torch.remainder(code, mq), m,
                                rounding_mode="floor"), 0, m_t - 1)
    tok = torch.zeros_like(code)
    for o, lo in enumerate(los):
        if lo is None:
            continue
        mine = (slot >= o * sn) & (slot < (o + 1) * sn) & (code >= 0)
        lslot = torch.clamp(slot - o * sn, 0, sn - 1)
        tok = tok + torch.where(mine, lo[lslot, col], torch.zeros_like(tok))
    return tok


def _merge_on_dev0(mesh: Mesh, blocks, b, s, codespace, dedupe_key_m=0,
                   dom=None, mq=None):
    moved = [[(h.to(mesh.dev0), e.to(mesh.dev0), off) for h, e, off in blk]
             for blk in blocks]
    return kernels.merge_blocks(moved, b, s, codespace, dedupe_key_m,
                                _on(dom, mesh.dev0), mq)


def sharded_flat_attr(mesh: Mesh, m: int, s: int, k: int,
                      wide: bool = False, floors: bool = True,
                      elide: bool = True):
    """Slot-sharded calculate_deps_flat_attr: each slice scans (K1b) and
    attributes (K2) its own slots against its slice of the attribution
    columns; the blocks' codes are globalized by the slice offset and
    merged on mesh device 0 (K12).  fn(table, attr, aidx, qmat, rankb, pm,
    pl, pn) -> (header int32[5+B], entries [d*s])."""
    def call(table, attr, aidx, qmat, rankb, pm, pl, pn):
        prune = _prune_of(pm, pl, pn)
        d = mesh.size
        t0 = slice_of(table, 0)
        shard_n, m_t = t0.lo.shape
        blocks = []
        for i, dev in enumerate(mesh.devices):
            t = slice_of(table, i)
            hdr_raw, ent = kernels.deps_dense(t, qmat.to(dev), m, s, k,
                                              prune, wide)
            hdr, ent = kernels.attr_post(t.lo, slice_of(attr, i),
                                         _on(aidx, dev), rankb.to(dev),
                                         hdr_raw, ent, m_t, m, floors,
                                         elide)
            blocks.append((hdr, ent, i * shard_n * m_t * m))
        hdr, out = _merge_on_dev0(mesh, [blocks], qmat.shape[0], s,
                                  d * shard_n * m_t * m)
        return hdr[0], out[0]

    return call


def sharded_bucketed_attr(mesh: Mesh, m: int, span: int, s: int, k: int,
                          m_t: int, keff: int, wide: bool = False,
                          floors: bool = True, elide: bool = True):
    """Row-sharded bucketed_attr: each slice probes its bucket rows (K1a);
    every entry's token is read from the slice that owns its slot (the
    reference's psum: each device's ``attr_tok`` terms, summed); each slice
    attributes its block (K2 with ``tok``) against the replicated
    attribution columns; the merge (K12) drops cross-shard duplicates and
    key-domain repeats.  fn(buckets, table, attr, aidx, qmat, rankb, pm,
    pl, pn) -> (header int32[5+B], entries [d*s])."""
    def call(buckets, table, attr, aidx, qmat, rankb, pm, pl, pn):
        prune = _prune_of(pm, pl, pn)
        raw = []
        for i, dev in enumerate(mesh.devices):
            bt = slice_of(buckets, i)
            raw.append(kernels.deps_bucketed(
                m_t, bt, qmat.to(dev), m, span, s, k, prune, keff, wide,
                row_offset=i * bt.blo.shape[0]))
        sn = table.lo[0].shape[0]
        groups = mesh.groups()
        tok = None
        for dev, idx in groups.items():
            los = [table.lo[j] if j in idx else None
                   for j in range(mesh.size)]
            part = kernels.attr_tok([e.to(dev) for _h, e in raw], los, sn,
                                    m_t, m)
            tok = part if tok is None else tok + part.to(tok.device)
        blocks = []
        for i, dev in enumerate(mesh.devices):
            hdr, ent = kernels.attr_post(
                None, _on(attr, dev), _on(aidx, dev), rankb.to(dev),
                raw[i][0], raw[i][1], m_t, m, floors, elide,
                tok=tok[i].to(dev))
            blocks.append((hdr, ent, 0))
        a0 = _on(attr, mesh.dev0)
        hdr, out = _merge_on_dev0(mesh, [blocks], qmat.shape[0], s,
                                  a0.dom.shape[0] * m_t * m, m, a0.dom,
                                  m_t * m)
        return hdr[0], out[0]

    return call


def sharded_fused_attr(mesh: Mesh, n_stores: int, m: int, s: int, k: int,
                       wide: bool = False, floors: bool = True,
                       elide: bool = True):
    """Batched-over-stores sharded_flat_attr: per slice one K5 launch (raw
    scan + attribution) over the S stores' slices padded to the group's
    largest slice and interval width; each store's blocks merge on mesh
    device 0 in one batched K12 launch, codes globalized on the padded
    slice stride.  fn(*tables, *attrs, *aidxs, qmats, rankbs, pm, pl, pn)
    -> (header int32[S, 5+B], entries [S, d*s])."""
    def call(*args):
        tables = args[:n_stores]
        attrs = args[n_stores:2 * n_stores]
        aidxs = args[2 * n_stores:3 * n_stores]
        qmats, rankbs, pm, pl, pn = args[3 * n_stores:]
        prunes = _fused_prunes(pm, pl, pn)
        d = mesh.size
        n_max = max(t.lo[0].shape[0] for t in tables)
        m_max = max(t.lo[0].shape[1] for t in tables)
        per = []
        for i, dev in enumerate(mesh.devices):
            ts = [slice_of(t, i) for t in tables]
            hdr_raw, ent = kernels.fused_deps_dense(ts, qmats.to(dev), prunes,
                                                    m, s, k, wide)
            per.append(kernels.fused_attr_post(
                ts, [slice_of(a, i) for a in attrs],
                [_on(a, dev) for a in aidxs], rankbs.to(dev), hdr_raw, ent,
                m, floors, elide))
        blocks = [[(per[i][0][st], per[i][1][st], i * n_max * m_max * m)
                   for i in range(d)] for st in range(n_stores)]
        return _merge_on_dev0(mesh, blocks, qmats.shape[1], s,
                              d * n_max * m_max * m)

    return call
