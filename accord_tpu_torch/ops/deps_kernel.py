"""Batched PreAccept dependency calculation: types, host packers, and the
plain PyTorch versions of the deps kernels.

Rebuild of ref: accord-core/src/main/java/accord/local/CommandsForKey.java:614-650
(mapReduceActive) + messages/PreAccept.java:245-265 (calculatePartialDeps) +
utils/CheckpointIntervalArray.java (range stabbing).  The JAX package's
``accord_tpu/ops/deps_kernel.py`` is the reference: every function here
computes the same bytes from the same inputs.

A command store's conflict index is a struct-of-arrays table of up to N
in-flight transactions: the packed TxnId, its kind, its status and up to M
touched intervals ``[lo, hi]`` (inclusive; a key token t is [t, t], a range
[s, e) is [s, e-1]).  A batch of B queries is answered as an exact-geometry
CSR of sorted composite codes::

    code = slot * (M_t * Q) + dep_interval_col * Q + query_interval_col

shipped as two buffers: a header ``(total, maxc, row_end[B])`` and the
entry buffer ``entries[s]`` (int32 unless ``capacity * M_t * Q`` exceeds
``INT32_CODE_MAX``, int64 past it).  The attributed variants prepend three
more header words: ``(total, raw total, raw maxc, n_trans, n_dec,
row_end[B])``.  Overflow reads as ``hdr[1] > s or hdr[2] > k`` (attributed)
and triggers an escalated re-launch.

The fused forms answer S stores' flushes in one launch: each store's table
is padded to the group's (n_max, m_max) — FREE slots, PAD intervals — so
block i of the stacked output is store i's solo answer with codes on
m_max.

The functions named ``*_plain`` mirror the JAX bodies with ``torch.sort``,
``cumsum``, ``searchsorted`` and ``index_put_``; they serve the CPU route
and are what the CUDA kernels (``ops/csrc``) are held against.  The entry
points without the suffix go through ``ops.kernels``, which picks the CUDA
kernel for a CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..primitives.timestamp import TxnId
from .packing import masked_ts_max, to_i64, ts_eq, ts_lt, unpack_txn_id


def launch_check(what: str = "") -> None:
    """Device-boundary fault hook for every kernel dispatch wrapper: raises
    utils.faults.KernelLaunchFault when a kernel-launch fault is armed."""
    from ..utils import faults
    faults.check("kernel_launch", what)


PAD_LO = np.int64(np.iinfo(np.int64).max)   # empty interval: lo > hi
PAD_HI = np.int64(np.iinfo(np.int64).min)

# widest triple code an int32 entry buffer can carry; a module attribute so
# tests can lower it and hold both widths against each other
INT32_CODE_MAX = 2**31 - 1


def wide_codes(capacity: int, m_t: int, q_m: int) -> bool:
    """True when triple codes for this (table, query) shape need int64."""
    return capacity * m_t * q_m > INT32_CODE_MAX


def code_dtype(wide: bool) -> torch.dtype:
    return torch.int64 if wide else torch.int32


def _code_sentinel(wide: bool) -> int:
    return int(np.iinfo(np.int64).max) if wide else int(np.iinfo(np.int32).max)


# slot liveness/status codes (device view of CommandsForKey.InternalStatus)
SLOT_FREE = -1
SLOT_TRANSITIVE = 0
SLOT_PREACCEPTED = 1
SLOT_ACCEPTED = 2
SLOT_COMMITTED = 3
SLOT_STABLE = 4
SLOT_APPLIED = 5
SLOT_INVALIDATED = 6


class DepsTable(NamedTuple):
    """SoA conflict index: N slots x M intervals."""

    msb: torch.Tensor        # int64[N]  packed TxnId
    lsb: torch.Tensor        # int64[N]
    node: torch.Tensor       # int32[N]
    kind: torch.Tensor       # int32[N]  TxnKind ordinal
    status: torch.Tensor     # int32[N]  SLOT_*
    lo: torch.Tensor         # int64[N, M]  inclusive starts (PAD_LO unused)
    hi: torch.Tensor         # int64[N, M]  inclusive ends   (PAD_HI unused)

    @property
    def capacity(self) -> int:
        return self.msb.shape[0]


class DepsQuery(NamedTuple):
    """Batch of B dependency queries (one per PreAccept-ing txn)."""

    msb: torch.Tensor          # int64[B]  started-before bound
    lsb: torch.Tensor          # int64[B]
    node: torch.Tensor         # int32[B]
    witness_mask: torch.Tensor  # int32[B]  bitmask over TxnKind ordinals
    lo: torch.Tensor           # int64[B, M]
    hi: torch.Tensor           # int64[B, M]
    self_msb: torch.Tensor     # int64[B]  the querying TxnId itself
    self_lsb: torch.Tensor     # int64[B]
    self_node: torch.Tensor    # int32[B]


class BucketTable(NamedTuple):
    """Device half of the bucket index: G buckets x K interval entries plus
    the wide/straggler entries (-1 slot = empty).  Each entry embeds the
    immutable columns of its owning slot (packed TxnId, kind) and its
    interval column in that slot's row."""

    blo: torch.Tensor     # int64[G, K]
    bhi: torch.Tensor     # int64[G, K]
    bslot: torch.Tensor   # int32[G, K]
    bcol: torch.Tensor    # int32[G, K]
    bmsb: torch.Tensor    # int64[G, K]
    blsb: torch.Tensor    # int64[G, K]
    bnode: torch.Tensor   # int32[G, K]
    bkind: torch.Tensor   # int32[G, K]
    wlo: torch.Tensor     # int64[W]
    whi: torch.Tensor     # int64[W]
    wslot: torch.Tensor   # int32[W]
    wcol: torch.Tensor    # int32[W]
    wmsb: torch.Tensor    # int64[W]
    wlsb: torch.Tensor    # int64[W]
    wnode: torch.Tensor   # int32[W]
    wkind: torch.Tensor   # int32[W]


class AttrCols(NamedTuple):
    """Per-slot attribution columns, scatter-updated with the DepsTable."""

    dom: torch.Tensor      # int32[N]  Domain ordinal (Key == 0)
    status: torch.Tensor   # int32[N]  fresh SLOT_*
    dmsb: torch.Tensor     # int64[N]  packed TxnId
    dlsb: torch.Tensor     # int64[N]
    dnode: torch.Tensor    # int32[N]
    emsb: torch.Tensor     # int64[N]  decided executeAt (valid iff eknown)
    elsb: torch.Tensor     # int64[N]
    enode: torch.Tensor    # int32[N]
    eknown: torch.Tensor   # bool[N]


class AttrIndex(NamedTuple):
    """Per-store floor + elision index (host-built, pow2-padded)."""

    fbnd: torch.Tensor     # int64[F]   floor segment boundaries (pad +INF)
    fmsb: torch.Tensor     # int64[F+1] per-segment deps_floor triples
    flsb: torch.Tensor     # int64[F+1]
    fnode: torch.Tensor    # int32[F+1]
    etok: torch.Tensor     # int64[T]   elidable tokens, sorted (pad +INF)
    eptr: torch.Tensor     # int32[T+1] CSR into the exec arrays (pad L)
    erank: torch.Tensor    # int64[L]   seg*estride+rank composites, asc
    exm: torch.Tensor      # int64[L]   the pivot executeAt triples
    exl: torch.Tensor      # int64[L]
    exn: torch.Tensor      # int32[L]
    estride: torch.Tensor  # int64[]    U+1, the composite stride


def query_from_qmat(qmat: torch.Tensor, m: int) -> DepsQuery:
    return DepsQuery(
        qmat[:, 0], qmat[:, 1], qmat[:, 2].to(torch.int32),
        qmat[:, 3].to(torch.int32),
        qmat[:, 7:7 + m], qmat[:, 7 + m:7 + 2 * m],
        qmat[:, 4], qmat[:, 5], qmat[:, 6].to(torch.int32))


def _prune_tensors(prune, device):
    """(msb, lsb, node) host scalars -> 0-d tensors; None prunes nothing
    (under the unsigned order nothing sorts below the zero triple)."""
    if prune is None:
        prune = (0, 0, 0)
    pm, pl, pn = prune
    return (torch.tensor(int(pm), dtype=torch.int64, device=device),
            torch.tensor(int(pl), dtype=torch.int64, device=device),
            torch.tensor(int(pn), dtype=torch.int32, device=device))


# -- plain versions ----------------------------------------------------------

def compact_rows_plain(valid: torch.Tensor, codes: torch.Tensor, s: int,
                       k: int):
    """Row compaction (the reference's ``_compact_rows``): pack each row's
    valid ``codes`` (already in final per-row order) into the first
    ``counts[b]`` cells, at most ``k`` per row, of a flat entry buffer
    truncated at ``s``.  Returns (counts int32[B], row_end int64[B],
    ent[s])."""
    b, c = codes.shape
    counts = valid.sum(dim=1, dtype=torch.int32)
    row_end = torch.cumsum(counts.to(torch.int64), 0)
    starts = row_end - counts
    k = min(k, c)
    col = torch.arange(c, dtype=torch.int32, device=codes.device)
    cols = torch.where(valid, col, torch.full_like(col, c))
    cols = torch.sort(cols, dim=1).values[:, :k]
    vals = torch.gather(codes, 1, torch.clamp(cols, max=c - 1).to(torch.int64))
    ok = cols < c
    pos = starts[:, None] + torch.arange(k, dtype=torch.int64,
                                         device=codes.device)[None, :]
    pos = torch.where(ok & (pos < s), pos, torch.full_like(pos, s))
    ent = torch.full((s + 1,), -1, dtype=codes.dtype, device=codes.device)
    ent.index_put_((pos.reshape(-1),), vals.reshape(-1))
    return counts, row_end, ent[:s]


def _header(row_end: torch.Tensor, maxc) -> torch.Tensor:
    total = row_end[-1:] if row_end.numel() else row_end.new_zeros(1)
    return torch.cat([total.to(torch.int32),
                      maxc.reshape(1).to(torch.int32),
                      row_end.to(torch.int32)])


def dep_mask_plain(table: DepsTable, query: DepsQuery, prune=None):
    """The exact [B, N] dep mask of the dense route."""
    return _dep_mask_and_conflict(table, query, prune)[0]


def calculate_deps_plain(table: DepsTable, query: DepsQuery, prune=None):
    """(dep_mask bool[B, N], max_conflict (msb, lsb, node)[B]): the
    reference's ``calculate_deps``.  max_conflict covers every live
    overlapping slot whatever its TxnId order or kind (the executeAt
    floor, not the dep set)."""
    mask, conflict = _dep_mask_and_conflict(table, query, prune)
    return mask, masked_ts_max(table.msb[None, :], table.lsb[None, :],
                               table.node[None, :], conflict)


def calc_deps_plain(tables: Sequence[DepsTable], query: DepsQuery,
                    prune=None):
    """The plain version of ``ops.kernels.calc_deps``: each slice's mask
    and its max-conflict candidates stacked [S, B]."""
    outs = [calculate_deps_plain(t, query, prune) for t in tables]
    return ([o[0] for o in outs],
            tuple(torch.stack([o[1][f] for o in outs]) for f in range(3)))


def ts_max_plain(msb, lsb, node):
    """The plain version of ``ops.kernels.ts_max``: the lexicographic max
    over the first axis of [C, R] candidates, a candidate counting when any
    field is non-zero (the cross-shard max of sharded calculate_deps)."""
    nz = (msb != 0) | (lsb != 0) | (node != 0)
    return masked_ts_max(msb.T, lsb.T, node.T, nz.T)


def _dep_mask_and_conflict(table: DepsTable, query: DepsQuery, prune=None):
    pm, pl, pn = _prune_tensors(prune, table.msb.device)
    live = table.status >= SLOT_TRANSITIVE
    not_invalidated = table.status != SLOT_INVALIDATED
    qlo = query.lo[:, None, :, None]
    qhi = query.hi[:, None, :, None]
    tlo = table.lo[None, :, None, :]
    thi = table.hi[None, :, None, :]
    overlap = ((qlo <= thi) & (tlo <= qhi)).any(dim=3).any(dim=2)
    conflict = overlap & (live & not_invalidated)[None, :]
    witnessed = ((query.witness_mask[:, None] >> table.kind[None, :]) & 1) > 0
    earlier = ts_lt(table.msb[None, :], table.lsb[None, :], table.node[None, :],
                    query.msb[:, None], query.lsb[:, None], query.node[:, None])
    not_self = ~ts_eq(table.msb[None, :], table.lsb[None, :],
                      table.node[None, :], query.self_msb[:, None],
                      query.self_lsb[:, None], query.self_node[:, None])
    above_floor = ~ts_lt(table.msb, table.lsb, table.node, pm, pl, pn)
    return (conflict & witnessed & earlier & not_self & above_floor[None, :],
            conflict)


def _compact_topk_plain(mask: torch.Tensor, k: int):
    """Mask -> (idx int32[B, k] ascending set columns padded with -1,
    counts int32[B])."""
    n = mask.shape[1]
    col = torch.arange(n, dtype=torch.int32, device=mask.device)
    counts = mask.sum(dim=1, dtype=torch.int32)
    cols = torch.where(mask, col, torch.full_like(col, n))
    cols = torch.sort(cols, dim=1).values[:, :min(k, n)]
    idx = torch.where(cols < n, cols, torch.full_like(cols, -1))
    return idx, counts


def flat_csr_plain(table: DepsTable, qmat: torch.Tensor, m: int, s: int,
                   k: int, prune=None, wide: bool = False):
    """Dense route (the reference's ``flat_csr_local``): exact mask over the
    whole table, per-row compaction to <= k slots, triple expansion of the
    selected slots' intervals, row compaction.  Returns (header int32[2+B],
    entries[s])."""
    query = query_from_qmat(qmat, m)
    mask = dep_mask_plain(table, query, prune)
    n = mask.shape[1]
    kp = min(k, n)
    idx, pair_counts = _compact_topk_plain(mask, kp)
    sel = torch.clamp(idx, min=0).to(torch.int64)
    tlo = table.lo[sel]                                        # [B,kp,M]
    thi = table.hi[sel]
    qlo = query.lo[:, None, None, :]
    qhi = query.hi[:, None, None, :]
    ov = (qlo <= thi[:, :, :, None]) & (tlo[:, :, :, None] <= qhi)
    valid = ov & (idx >= 0)[:, :, None, None]                  # [B,kp,M,Q]
    m_t = table.lo.shape[1]
    dt = code_dtype(wide)
    dev = qmat.device
    codes = (sel.to(dt)[:, :, None, None] * (m_t * m)
             + torch.arange(m_t, dtype=dt, device=dev)[None, None, :, None] * m
             + torch.arange(m, dtype=dt, device=dev)[None, None, None, :])
    b = valid.shape[0]
    counts, row_end, ent = compact_rows_plain(valid.reshape(b, -1),
                                              codes.reshape(b, -1), s, k)
    maxc = torch.maximum(counts.max(), pair_counts.max())
    return _header(row_end, maxc), ent


def _entry_pred(query: DepsQuery, ov, slot, emsb, elsb, enode, ekind):
    """Exact per-entry predicate; entry columns broadcast as [B?, X, Y]."""
    qm = query.msb[:, None, None]
    ql = query.lsb[:, None, None]
    qn = query.node[:, None, None]
    valid = slot >= 0
    witnessed = ((query.witness_mask[:, None, None] >> ekind) & 1) > 0
    earlier = ts_lt(emsb, elsb, enode, qm, ql, qn)
    not_self = ~ts_eq(emsb, elsb, enode, query.self_msb[:, None, None],
                      query.self_lsb[:, None, None],
                      query.self_node[:, None, None])
    return valid & ov & witnessed & earlier & not_self


def bucket_candidates(m_t: int, buckets: BucketTable, qmat: torch.Tensor,
                      m: int, span: int, prune=None, keff: int = None,
                      wide: bool = False, row_offset: int = None):
    """The bucketed route's candidates of each query row, in the order the
    reference lays them out: (pred bool[B, C], code [B, C]) with C =
    m*span*keff bucket entries (probe p = c // keff probes query interval
    p // span) then m*W wide entries (query interval (c - m*span*keff) //
    W).  ``pred`` is the exact predicate, ``code`` the triple code."""
    query = query_from_qmat(qmat, m)
    b = qmat.shape[0]
    dev = qmat.device
    mq = m_t * m
    dt = code_dtype(wide)
    kb = buckets.blo.shape[1]
    keff = kb if keff is None else min(keff, kb)
    blo, bhi = buckets.blo[:, :keff], buckets.bhi[:, :keff]
    bslot, bcol = buckets.bslot[:, :keff], buckets.bcol[:, :keff]
    bmsb, blsb = buckets.bmsb[:, :keff], buckets.blsb[:, :keff]
    bnode, bkind = buckets.bnode[:, :keff], buckets.bkind[:, :keff]
    qbuck = qmat[:, 7 + 2 * m:].to(torch.int32)              # [B, m*span]
    if row_offset is not None:
        local = qbuck - int(row_offset)
        qbuck = torch.where((qbuck >= 0) & (local >= 0)
                            & (local < blo.shape[0]), local,
                            torch.full_like(local, -1))
    g = torch.clamp(qbuck, min=0).to(torch.int64)
    has = qbuck >= 0
    elo, ehi = blo[g], bhi[g]                                # [B, m*span, K]
    qlo = torch.repeat_interleave(query.lo, span, dim=1)[:, :, None]
    qhi = torch.repeat_interleave(query.hi, span, dim=1)[:, :, None]
    ov = (elo <= qhi) & (qlo <= ehi) & has[:, :, None]
    es, ec = bslot[g], bcol[g]
    em, el, en = bmsb[g], blsb[g], bnode[g]
    pred_b = _entry_pred(query, ov, es, em, el, en, bkind[g])
    q_of = torch.repeat_interleave(torch.arange(m, dtype=dt, device=dev),
                                   span)[None, :, None]
    cand = (es.to(dt) * mq + ec.to(dt) * m + q_of).reshape(b, -1)
    pred_b = pred_b.reshape(b, -1)
    w = buckets.wlo.shape[0]
    ov_w = ((buckets.wlo[None, None, :] <= query.hi[:, :, None])
            & (query.lo[:, :, None] <= buckets.whi[None, None, :]))
    pred_w = _entry_pred(query, ov_w, buckets.wslot[None, None, :],
                         buckets.wmsb[None, None, :],
                         buckets.wlsb[None, None, :],
                         buckets.wnode[None, None, :],
                         buckets.wkind[None, None, :])        # [B, Q, W]
    cand_w = (buckets.wslot[None, None, :].to(dt) * mq
              + buckets.wcol[None, None, :].to(dt) * m
              + torch.arange(m, dtype=dt, device=dev)[None, :, None])
    cand = torch.cat([cand, cand_w.expand(b, m, w).reshape(b, -1)], dim=1)
    pred = torch.cat([pred_b, pred_w.reshape(b, -1)], dim=1)
    pm, pl, pn = _prune_tensors(prune, dev)
    above_b = ~ts_lt(em, el, en, pm, pl, pn).reshape(b, -1)
    above_w = ~ts_lt(buckets.wmsb, buckets.wlsb, buckets.wnode, pm, pl, pn)
    pred = pred & torch.cat(
        [above_b, above_w[None, None, :].expand(b, m, w).reshape(b, -1)],
        dim=1)
    return pred, cand


def bucketed_flat_plain(m_t: int, buckets: BucketTable, qmat: torch.Tensor,
                        m: int, span: int, s: int, k: int, prune=None,
                        keff: int = None, wide: bool = False,
                        row_offset: int = None):
    """Bucketed route (the reference's ``bucketed_flat``): candidates are the
    ``keff`` entries of each touched bucket plus the wide list crossed with
    every query interval; the exact predicate, a per-row sort with adjacent
    dedupe, then the row compaction.  ``qmat`` carries the m*span bucket-row
    columns after the standard 7+2m query columns.  ``row_offset``
    translates global bucket rows to the rows of a row-sharded slice: rows
    outside the slice become -1 (no bucket here)."""
    pred, cand = bucket_candidates(m_t, buckets, qmat, m, span, prune, keff,
                                   wide, row_offset)
    b = qmat.shape[0]
    dev = qmat.device
    sent = _code_sentinel(wide)
    hit = torch.where(pred, cand, torch.full_like(cand, sent))
    hit = torch.sort(hit, dim=1).values
    uniq = (hit != sent) & torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=dev),
         hit[:, 1:] != hit[:, :-1]], dim=1)
    counts, row_end, ent = compact_rows_plain(uniq, hit, s, k)
    return _header(row_end, counts.max()), ent


def _attr_key_masks(tok, dmsb, dlsb, dnode, status, emsb, elsb, enode,
                    eknown, rankb_b, aidx: AttrIndex, floors: bool,
                    elide: bool):
    """(keep_floor, elide_trans, elide_dec) for key-domain entries."""
    if floors:
        fi = torch.searchsorted(aidx.fbnd, tok, right=True)
        keep_floor = ~ts_lt(dmsb, dlsb, dnode,
                            aidx.fmsb[fi], aidx.flsb[fi], aidx.fnode[fi])
    else:
        keep_floor = torch.ones_like(tok, dtype=torch.bool)
    elide_trans = status == SLOT_TRANSITIVE
    if not elide:
        return keep_floor, elide_trans, torch.zeros_like(keep_floor)
    t = aidx.etok.shape[0]
    seg = torch.searchsorted(aidx.etok, tok)
    seg_c = torch.clamp(seg, max=max(t - 1, 0))
    seg_ok = aidx.etok[seg_c] == tok
    base = aidx.eptr[seg_c].to(torch.int64)
    cnt = torch.searchsorted(aidx.erank, seg_c * aidx.estride + rankb_b) - base
    has_pivot = seg_ok & (cnt > 0)
    pidx = torch.clamp(base + cnt - 1, min=0)
    below = ts_lt(emsb, elsb, enode, aidx.exm[pidx], aidx.exl[pidx],
                  aidx.exn[pidx])
    decided = (status >= SLOT_COMMITTED) & (status <= SLOT_APPLIED) & eknown
    return keep_floor, elide_trans, decided & has_pivot & below


def _attr_keep_plain(tlo, attr: AttrCols, aidx: AttrIndex, rankb, hdr_raw,
                     ent, m_t: int, m: int, floors: bool, elide: bool, tok):
    """The keep flag of every entry position and the two elision tallies
    (the per-entry half of ``_attr_post``): (keep bool[s], live bool[s],
    row_of int64[s], n_trans, n_dec)."""
    s = ent.shape[0]
    dev = ent.device
    total = hdr_raw[0].to(torch.int64)
    row_end = hdr_raw[2:].to(torch.int64)
    b = row_end.shape[0]
    pos = torch.arange(s, dtype=torch.int64, device=dev)
    live = pos < total
    code = ent.to(torch.int64)
    mq = m_t * m
    slot = torch.clamp(code // mq, min=0)
    col = torch.clamp(code % mq // m, 0, m_t - 1)
    row_of = torch.clamp(torch.searchsorted(row_end, pos, right=True),
                         max=b - 1)
    key_dep = attr.dom[slot] == 0
    status = attr.status[slot]
    if tok is None:
        tok = tlo[slot, col]
    keep_floor, el_trans, el_dec = _attr_key_masks(
        tok, attr.dmsb[slot], attr.dlsb[slot], attr.dnode[slot], status,
        attr.emsb[slot], attr.elsb[slot], attr.enode[slot],
        attr.eknown[slot], rankb[row_of], aidx, floors, elide)
    pairkey = row_of * (1 << 40) + code // m
    firstp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        pairkey[1:] != pairkey[:-1]])
    drop_key = ~keep_floor | el_trans | el_dec | ~firstp
    keep = live & (~key_dep | ~drop_key)
    n_trans = (live & key_dep & firstp & keep_floor & el_trans).sum()
    n_dec = (live & key_dep & firstp & keep_floor & ~el_trans & el_dec).sum()
    return keep, live, row_of, n_trans, n_dec


def attr_post_plain(tlo: torch.Tensor, attr: AttrCols, aidx: AttrIndex,
                    rankb: torch.Tensor, hdr_raw: torch.Tensor,
                    ent: torch.Tensor, m_t: int, m: int, floors: bool = True,
                    elide: bool = True, tok: torch.Tensor = None):
    """Post-compaction attribution (the reference's ``_attr_post``) over the
    compacted entry buffer: per-token RedundantBefore floors, elision of
    TRANSITIVE and decided-below-pivot key entries, the key-domain
    (row, slot, col) dedupe, and a cumsum-scatter recompaction.  ``tok``
    (int64[s]) replaces the token gather from ``tlo``: a mesh-bucketed
    caller assembles it across the slices.  Returns the attributed
    (header int32[5+B], entries[s])."""
    s = ent.shape[0]
    dev = ent.device
    keep, live, row_of, n_trans, n_dec = _attr_keep_plain(
        tlo, attr, aidx, rankb, hdr_raw, ent, m_t, m, floors, elide, tok)
    row_end = hdr_raw[2:].to(torch.int64)
    b = row_end.shape[0]
    out_pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    out = torch.full((s + 1,), -1, dtype=ent.dtype, device=dev)
    out.index_put_((torch.where(keep, out_pos, torch.full_like(out_pos, s)),),
                   ent)
    drops = torch.zeros(b + 1, dtype=torch.int64, device=dev)
    drops.index_add_(0, torch.where(live & ~keep, row_of,
                                    torch.full_like(row_of, b)),
                     torch.ones_like(row_of))
    new_end = row_end - torch.cumsum(drops[:b], 0)
    head = torch.stack([new_end[-1], hdr_raw[0].to(torch.int64),
                        hdr_raw[1].to(torch.int64), n_trans,
                        n_dec]).to(torch.int32)
    return torch.cat([head, new_end.to(torch.int32)]), out[:s]


def scatter_rows_plain(cols: Sequence[torch.Tensor], idx: torch.Tensor,
                       rows: Sequence[torch.Tensor]) -> None:
    """In-place dirty-row set: ``cols[c][idx] = rows[c]`` for every column
    (pads repeat the last row with identical values)."""
    ii = idx.to(torch.int64)
    for col, row in zip(cols, rows):
        col[ii] = row


# K3's packed host layout: one staging buffer a scatter, uploaded in one
# copy.  The index (int64[P]) lies at byte 0 and each column's P source
# rows follow, cast to the column's dtype, each at a PACK_ALIGN boundary
PACK_ALIGN = 16

_NP_DTYPES = {torch.int64: np.int64, torch.int32: np.int32,
              torch.bool: np.bool_}


def row_bytes(col: torch.Tensor) -> int:
    """Bytes of one row of a scatter column (a scalar or a whole row)."""
    n = col.element_size()
    for x in col.shape[1:]:
        n *= x
    return n


def pack_layout(cols: Sequence[torch.Tensor], p: int):
    """(byte offset of each column's source rows, total bytes) of the
    packed staging buffer of a P-row scatter into ``cols``."""
    off = -(-8 * p // PACK_ALIGN) * PACK_ALIGN
    offs = []
    for col in cols:
        offs.append(off)
        off = -(-(off + p * row_bytes(col)) // PACK_ALIGN) * PACK_ALIGN
    return offs, off


def pack_rows(buf: np.ndarray, cols: Sequence[torch.Tensor], idx, rows,
              offs, pool=None, workers: int = 1) -> None:
    """Write ``idx`` and each column's source rows (array-likes of shape
    [P, *row]) into the uint8 buffer ``buf`` at ``offs``; with ``pool``
    (an executor of ``workers`` threads) the copies run there as about two
    row ranges a worker."""
    p = len(idx)
    buf[:8 * p].view(np.int64)[:] = idx
    pairs = []
    for col, row, off in zip(cols, rows, offs):
        shape = (p,) + tuple(col.shape[1:])
        row = np.asarray(row)
        if row.shape != shape:
            raise ValueError(f"scatter rows {row.shape} do not fit column "
                             f"{tuple(col.shape)}")
        dst = buf[off:off + p * row_bytes(col)].view(_NP_DTYPES[col.dtype])
        pairs.append((dst.reshape(shape), row, row_bytes(col)))
    if pool is None:
        for dst, row, _rb in pairs:
            dst[...] = row
        return
    share = max(1, sum(p * rb for _d, _r, rb in pairs) // (2 * workers))
    parts = []
    for dst, row, rb in pairs:
        step = max(1, share // max(rb, 1))
        parts += [(dst[a:a + step], row[a:a + step])
                  for a in range(0, p, step)]
    for f in [pool.submit(np.copyto, d, r, "unsafe") for d, r in parts]:
        f.result()


def scatter_rows_packed_plain(cols: Sequence[torch.Tensor],
                              buf: torch.Tensor, p: int, offs) -> None:
    """The plain version of K3 on the packed layout: ``cols[c][idx] =
    rows[c]``, with idx and the rows read from ``buf`` (uint8) at
    ``offs``."""
    idx = buf[:8 * p].view(torch.int64)
    for col, off in zip(cols, offs):
        src = buf[off:off + p * row_bytes(col)].view(col.dtype)
        col[idx] = src.reshape((p,) + tuple(col.shape[1:]))


# -- fused (batched-over-stores) plain versions -------------------------------
#
# One launch answers the deps flushes of several CommandStores: each
# store's table is padded to the group maxima (FREE slots, PAD intervals:
# structurally out of the mask) and scanned alone, so row i of the stacked
# output is exactly store i's solo answer, with codes on the group's
# interval width m_max.  The attribution stage pads the attribution
# columns and the floor/elision index the same way.

def _pad1(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    if a.shape[0] >= n:
        return a
    return torch.cat([a, a.new_full((n - a.shape[0],) + tuple(a.shape[1:]),
                                    fill)])


def _pad_table_cols(table: DepsTable, n: int, m: int) -> DepsTable:
    """One store's table padded to (n, m): appended slots are FREE and
    appended interval columns PAD (lo > hi)."""
    def pad2(a, fill):
        out = a.new_full((n, m), fill)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    return DepsTable(_pad1(table.msb, n, 0), _pad1(table.lsb, n, 0),
                     _pad1(table.node, n, 0), _pad1(table.kind, n, 0),
                     _pad1(table.status, n, SLOT_FREE),
                     pad2(table.lo, int(PAD_LO)), pad2(table.hi, int(PAD_HI)))


def _pad_attr_cols(attr: AttrCols, n: int) -> AttrCols:
    """One store's attribution columns padded to ``n`` slots (FREE, so
    never read through the mask)."""
    fills = (1, SLOT_FREE, 0, 0, 0, 0, 0, 0, False)
    return AttrCols(*(_pad1(a, n, f) for a, f in zip(attr, fills)))


def _pad_attr_index(aidx: AttrIndex, f: int, t: int, l: int) -> AttrIndex:
    """One store's AttrIndex padded to the group's (F, T, L): floor
    boundaries, elidable tokens and exec composites pad +INF, their
    triples 0, and eptr with the store's live length (empty segments)."""
    inf = int(np.iinfo(np.int64).max)
    return AttrIndex(
        _pad1(aidx.fbnd, f, inf), _pad1(aidx.fmsb, f + 1, 0),
        _pad1(aidx.flsb, f + 1, 0), _pad1(aidx.fnode, f + 1, 0),
        _pad1(aidx.etok, t, inf), _pad1(aidx.eptr, t + 1, int(aidx.eptr[-1])),
        _pad1(aidx.erank, l, inf), _pad1(aidx.exm, l, 0),
        _pad1(aidx.exl, l, 0), _pad1(aidx.exn, l, 0), aidx.estride)


def group_shape(tables: Sequence[DepsTable]) -> Tuple[int, int]:
    """(n_max, m_max) of a fused group."""
    return (max(t.capacity for t in tables),
            max(t.lo.shape[1] for t in tables))


def attr_group_shape(aidxs: Sequence[AttrIndex]) -> Tuple[int, int, int]:
    """(F, T, L) of a fused group's attribution indexes."""
    return (max(a.fbnd.shape[0] for a in aidxs),
            max(a.etok.shape[0] for a in aidxs),
            max(a.erank.shape[0] for a in aidxs))


def _prune_of(prunes, i: int):
    return (int(prunes[0][i]), int(prunes[1][i]), int(prunes[2][i]))


def fused_flat_csr_plain(tables: Sequence[DepsTable], qmats: torch.Tensor,
                         prunes, m: int, s: int, k: int, wide: bool = False):
    """The reference's ``fused_flat_csr``: ``qmats`` int64[S, B, 7+2m],
    ``prunes`` per-store floor triples (zeros prune nothing).  Returns
    (header int32[S, 2+B], entries [S, s]); row i is the solo
    flat_csr_plain answer for store i, padded to the group."""
    n_max, m_max = group_shape(tables)
    outs = [flat_csr_plain(_pad_table_cols(t, n_max, m_max), qmats[i], m,
                           s, k, _prune_of(prunes, i), wide)
            for i, t in enumerate(tables)]
    return (torch.stack([h for h, _e in outs]),
            torch.stack([e for _h, e in outs]))


def fused_attr_post_plain(tables: Sequence[DepsTable],
                          attrs: Sequence[AttrCols],
                          aidxs: Sequence[AttrIndex], rankbs: torch.Tensor,
                          hdr_raw: torch.Tensor, ent: torch.Tensor, m: int,
                          floors: bool = True, elide: bool = True):
    """Per-store attribution of a fused raw CSR (``hdr_raw`` [S, 2+B],
    ``ent`` [S, s]) over the padded group: (header int32[S, 5+B],
    entries [S, s])."""
    n_max, m_max = group_shape(tables)
    f, t, l = attr_group_shape(aidxs)
    outs = []
    for i, tab in enumerate(tables):
        tlo = _pad_table_cols(tab, n_max, m_max).lo
        outs.append(attr_post_plain(
            tlo, _pad_attr_cols(attrs[i], n_max),
            _pad_attr_index(aidxs[i], f, t, l), rankbs[i], hdr_raw[i],
            ent[i], m_max, m, floors, elide))
    return (torch.stack([h for h, _e in outs]),
            torch.stack([e for _h, e in outs]))


# -- entry points (device-selected in ops.kernels) ---------------------------

def calculate_deps(table: DepsTable, query: DepsQuery, prune=None):
    """(dep_mask bool[B, N], max_conflict (msb, lsb, node)[B]); ``prune``
    is the RedundantBefore floor triple (None prunes nothing)."""
    from . import kernels
    mask, (mm, ml, mn) = kernels.calc_deps([table], query, prune)
    return mask[0], (mm[0], ml[0], mn[0])


def calculate_deps_flat(table: DepsTable, qmat, m: int, s: int, k: int,
                        wide: bool = False, prune=None):
    """Dense exact CSR: (header int32[2+B], entries[s])."""
    from . import kernels
    return kernels.deps_dense(table, qmat, m, s, k, prune, wide)


def calculate_deps_flat_attr(table: DepsTable, attr: AttrCols,
                             aidx: AttrIndex, qmat, rankb, prune,
                             m: int, s: int, k: int, wide: bool = False,
                             floors: bool = True, elide: bool = True):
    """Dense route with the attribution stage: (header int32[5+B], ent)."""
    from . import kernels
    hdr, ent = kernels.deps_dense(table, qmat, m, s, k, prune, wide)
    return kernels.attr_post(table.lo, attr, aidx, rankb, hdr, ent,
                             table.lo.shape[1], m, floors, elide)


def bucketed_flat(table: DepsTable, buckets: BucketTable, qmat, m: int,
                  span: int, s: int, k: int, prune=None, keff: int = None,
                  wide: bool = False, row_offset: int = None,
                  m_t: int = None):
    """Bucketed exact CSR: (header int32[2+B], entries[s]).  ``table`` is
    read only for its interval width; a mesh slice passes ``m_t`` (and
    ``table=None``) and its ``row_offset``."""
    from . import kernels
    if m_t is None:
        m_t = table.lo.shape[1]
    return kernels.deps_bucketed(m_t, buckets, qmat, m, span, s, k, prune,
                                 keff, wide, row_offset)


def bucketed_attr(table: DepsTable, attr: AttrCols, aidx: AttrIndex,
                  buckets: BucketTable, qmat, rankb, m: int, span: int,
                  s: int, k: int, prune=None, keff: int = None,
                  wide: bool = False, floors: bool = True,
                  elide: bool = True):
    """Bucketed route with the attribution stage: (header int32[5+B], ent)."""
    from . import kernels
    m_t = table.lo.shape[1]
    hdr, ent = kernels.deps_bucketed(m_t, buckets, qmat, m, span, s, k,
                                     prune, keff, wide)
    return kernels.attr_post(table.lo, attr, aidx, rankb, hdr, ent, m_t, m,
                             floors, elide)


def fused_flat_csr(tables: Sequence[DepsTable], qmats, prunes, m: int,
                   s: int, k: int, wide: bool = False):
    """Fused dense exact CSR for S stores in one launch: (header
    int32[S, 2+B], entries [S, s]), codes on the group interval width."""
    from . import kernels
    return kernels.fused_deps_dense(tables, qmats, prunes, m, s, k, wide)


def fused_flat_attr(tables: Sequence[DepsTable], attrs: Sequence[AttrCols],
                    aidxs: Sequence[AttrIndex], qmats, rankbs, prunes,
                    m: int, s: int, k: int, wide: bool = False,
                    floors: bool = True, elide: bool = True):
    """Fused dense route with the attribution stage, S stores per launch:
    (header int32[S, 5+B], entries [S, s]).  Each store's table, columns
    and index are read where they lie (no stacked copy); row i equals
    store i's solo calculate_deps_flat_attr over its table padded to the
    group (n_max, m_max)."""
    from . import kernels
    hdr, ent = kernels.fused_deps_dense(tables, qmats, prunes, m, s, k,
                                        wide)
    return kernels.fused_attr_post(tables, attrs, aidxs, rankbs, hdr, ent,
                                   m, floors, elide)


def scatter_table_rows(table: DepsTable, idx, msb, lsb, node, kind, status,
                       lo, hi) -> DepsTable:
    """Dirty-row update of the seven table columns, in place."""
    from . import kernels
    kernels.scatter_rows(list(table), idx, [msb, lsb, node, kind, status,
                                            lo, hi])
    return table


def scatter_attr_cols(attr: AttrCols, idx, *rows) -> AttrCols:
    """Dirty-row update of the nine attribution columns, in place."""
    from . import kernels
    kernels.scatter_rows(list(attr), idx, list(rows))
    return attr


# -- host helpers ------------------------------------------------------------

def decode_triples(codes: np.ndarray, m_t: int, q_m: int):
    """Host decode of composite overlap codes -> (slot, dep_col, q_col)
    int64 triples (the inverse of the kernel-side encoding)."""
    codes = codes.astype(np.int64)
    mq = np.int64(m_t * q_m)
    j = codes // mq
    rem = codes - j * mq
    m_i = rem // q_m
    return j, m_i, rem - m_i * q_m


def pack_query_matrix(queries: Sequence[tuple], max_intervals: int) -> np.ndarray:
    """Host packer: one int64 matrix [B, 7 + 2m] per batch (bound msb, lsb,
    node, witness mask, self msb, lsb, node, then m lo and m hi columns).
    ``queries`` as in build_query."""
    b = len(queries)
    m = max_intervals
    q = np.empty((b, 7 + 2 * m), np.int64)
    q[:, 7:7 + m] = PAD_LO
    q[:, 7 + m:] = PAD_HI
    cols = ([], [], [], [], [], [], [])
    for i, item in enumerate(queries):
        (bound, witnesses, toks, rngs), self_id = \
            item[:4], (item[4] if len(item) > 4 else item[0])
        cols[0].append(to_i64(bound.msb))
        cols[1].append(to_i64(bound.lsb))
        cols[2].append(bound.node)
        cols[3].append(witnesses.mask())
        cols[4].append(to_i64(self_id.msb))
        cols[5].append(to_i64(self_id.lsb))
        cols[6].append(self_id.node)
        if len(toks) + len(rngs) > m:
            raise ValueError(f"txn touches > {m} intervals")
        j = 0
        for t in toks:
            q[i, 7 + j] = t
            q[i, 7 + m + j] = t
            j += 1
        for r in rngs:
            q[i, 7 + j] = r.start
            q[i, 7 + m + j] = r.end - 1
            j += 1
    for c in range(7):
        q[:, c] = cols[c]
    return q


def _intervals_of(txn_keys, txn_ranges, max_intervals: int):
    """(tokens, ranges) -> padded [lo...], [hi...] rows."""
    lo = [PAD_LO] * max_intervals
    hi = [PAD_HI] * max_intervals
    i = 0
    for t in txn_keys:
        if i >= max_intervals:
            raise ValueError(f"txn touches > {max_intervals} intervals")
        lo[i], hi[i] = t, t
        i += 1
    for r in txn_ranges:
        if i >= max_intervals:
            raise ValueError(f"txn touches > {max_intervals} intervals")
        lo[i], hi[i] = r.start, r.end - 1
        i += 1
    return lo, hi


def build_table(entries: Sequence[Tuple[TxnId, int, list, list]],
                capacity: int, max_intervals: int,
                device="cuda") -> DepsTable:
    """Host packer: entries = [(txn_id, status, key_tokens, ranges)]."""
    n = len(entries)
    if n > capacity:
        raise ValueError(f"{n} entries > capacity {capacity}")
    msb = np.zeros(capacity, np.int64)
    lsb = np.zeros(capacity, np.int64)
    node = np.zeros(capacity, np.int32)
    kind = np.zeros(capacity, np.int32)
    status = np.full(capacity, SLOT_FREE, np.int32)
    lo = np.full((capacity, max_intervals), PAD_LO, np.int64)
    hi = np.full((capacity, max_intervals), PAD_HI, np.int64)
    for i, (tid, st, toks, rngs) in enumerate(entries):
        msb[i] = to_i64(tid.msb)
        lsb[i] = to_i64(tid.lsb)
        node[i] = tid.node
        kind[i] = int(tid.kind())
        status[i] = st
        row_lo, row_hi = _intervals_of(toks, rngs, max_intervals)
        lo[i] = row_lo
        hi[i] = row_hi
    return DepsTable(*(torch.from_numpy(a).to(device)
                       for a in (msb, lsb, node, kind, status, lo, hi)))


def build_query(queries: Sequence[tuple], max_intervals: int,
                device="cuda") -> DepsQuery:
    """queries = [(started_before, witnesses, key_tokens, ranges)] or
    [(started_before, witnesses, key_tokens, ranges, self_txn_id)]."""
    q = torch.from_numpy(pack_query_matrix(queries, max_intervals)).to(device)
    return query_from_qmat(q, max_intervals)


def extract_deps(table: DepsTable, dep_mask) -> List[List[TxnId]]:
    """dep_mask bool[B, N] -> per-query sorted TxnId lists (host)."""
    mask = np.asarray(torch.as_tensor(dep_mask).cpu())
    msb, lsb, node = (table.msb.cpu().numpy(), table.lsb.cpu().numpy(),
                      table.node.cpu().numpy())
    out: List[List[TxnId]] = []
    for b in range(mask.shape[0]):
        idx = np.nonzero(mask[b])[0]
        out.append(sorted(unpack_txn_id(msb[j], lsb[j], node[j]) for j in idx))
    return out


def empty_table(capacity: int, max_intervals: int,
                device="cuda") -> DepsTable:
    """A table of ``capacity`` FREE slots with PAD intervals."""
    return DepsTable(
        torch.zeros(capacity, dtype=torch.int64, device=device),
        torch.zeros(capacity, dtype=torch.int64, device=device),
        torch.zeros(capacity, dtype=torch.int32, device=device),
        torch.zeros(capacity, dtype=torch.int32, device=device),
        torch.full((capacity,), SLOT_FREE, dtype=torch.int32, device=device),
        torch.full((capacity, max_intervals), int(PAD_LO), dtype=torch.int64,
                   device=device),
        torch.full((capacity, max_intervals), int(PAD_HI), dtype=torch.int64,
                   device=device))
