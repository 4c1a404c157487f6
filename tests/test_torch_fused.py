"""The port's fused multi-store kernels against the JAX package's.

K5: ``fused_flat_csr`` and ``fused_flat_attr`` on seeded groups of three
stores with unequal capacities, interval widths and attribution indexes
(the reference pads and stacks inside its jitted program; the port reads
each store where it lies and pads by rule).  Floors and elision each on
and off, one case with int64 codes, one that overflows s and k.  Each
store's block also decodes to the port's own solo answer for that store.

K5's work split on the card (ops/csrc/fused_scan.cu), modelled step by
step in numpy and held against the reference on groups at its edges:
members of 300 slots (not a whole number of 256-slot tiles), 40 (less than
a tile) and 96 with every slot FREE (rows that select nothing), unequal
interval widths with a query interval over the whole line (so the PAD
columns of the narrower members overlap it), B = 1 and 33, int64 codes,
a kp cut inside a mask word, and s and k both overflowing.

K6: ``fused_ready_frontier`` / ``fused_ready_frontier_ell`` on unequal
drain states; each row's live prefix is the store's solo frontier; also
members whose n is not a multiple of 16 (the dense kernel's 16-byte
chunks) and a member of one row.  K6 dense's launch plan
(``kernels.fused_frontier_launches``): 130 members split into launches of
at most ``FUSED_MAX_STORES``, each member's output row and CTAs, and a
model of the kernel's CTA-to-member search covering every row once.
K6 ELL's plan (the same function at ``FRONTIER_ELL_ROWS`` rows a CTA)
against one written here, and the flat grid run through the walk model
of ``tests/test_torch_drain_kernel.py`` (each CTA's member by the
kernel's search, each member's own degree, its last CTA writing its pad
rows) against the reference on members of unequal n and d, and on 130
members (two launches).

CPU only: the port takes its plain versions here; tolerance zero (every
output is integer or boolean)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.ops import deps_kernel as rdk
from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu_torch.ops import _build
from accord_tpu_torch.ops import convert
from accord_tpu_torch.ops import deps_kernel as pdk
from accord_tpu_torch.ops import drain_kernel as pdrk
from accord_tpu_torch.ops import kernels as pkern
from tests.test_torch_deps_kernel import _inputs, _low_set_bits
from tests.test_torch_drain_kernel import _ell_case, ell_walk_model

# three stores: (capacity, interval width)
GROUP = ((64, 4), (40, 2), (96, 8))
M = 4          # query interval width, shared by the group


def _group(seed):
    stores = [_inputs(seed * 10 + i, n=n, m_t=m_t, m=M, b=8)
              for i, (n, m_t) in enumerate(GROUP)]
    qmats = np.stack([s["qmat"] for s in stores])
    rankbs = np.stack([s["rankb"] for s in stores])
    prunes = tuple(np.array([s["prune"][c] for s in stores],
                            np.int32 if c == 2 else np.int64)
                   for c in range(3))
    return stores, qmats, rankbs, prunes


def _ref_cols(kind, cols):
    nt = {"table": rdk.DepsTable, "attr": rdk.AttrCols,
          "aidx": rdk.AttrIndex}[kind]
    return nt(*(jnp.asarray(a) for a in cols))


def _port_cols(kind, cols):
    return convert.tables_from_numpy({kind: cols}, "cpu")[kind]


def _eq(ref, port):
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())
        assert np.asarray(r).dtype == p.numpy().dtype


def _ref_fused_attr(stores, qmats, rankbs, prunes, s, k, wide, floors,
                    elide):
    """The reference dispatcher's call: attribution columns and indexes
    padded to the group and pre-stacked on a leading store axis."""
    tables = [_ref_cols("table", st["table"]) for st in stores]
    n_max = max(t.capacity for t in tables)
    attrs = [rdk._pad_attr_cols(_ref_cols("attr", st["attr"]), n_max)
             for st in stores]
    aidxs = [_ref_cols("aidx", st["aidx"]) for st in stores]
    f = max(a.fbnd.shape[0] for a in aidxs)
    t = max(a.etok.shape[0] for a in aidxs)
    l = max(a.erank.shape[0] for a in aidxs)
    padded = [rdk._pad_attr_index(a, f, t, l) for a in aidxs]
    sa = rdk.AttrCols(*(jnp.stack(c) for c in zip(*attrs)))
    si = rdk.AttrIndex(*(jnp.stack(c) for c in zip(*padded)))
    return rdk.fused_flat_attr(tables, sa, si, qmats, rankbs, prunes, M, s,
                               k, wide, floors, elide)


def _port_fused_attr(stores, qmats, rankbs, prunes, s, k, wide, floors,
                     elide):
    return pdk.fused_flat_attr(
        [_port_cols("table", st["table"]) for st in stores],
        [_port_cols("attr", st["attr"]) for st in stores],
        [_port_cols("aidx", st["aidx"]) for st in stores],
        torch.from_numpy(qmats), torch.from_numpy(rankbs), prunes, M, s, k,
        wide, floors, elide)


def _triples(hdr, ent, hoff, m_t):
    """Per-row sorted (slot, col, q) triples of one store's block."""
    row_end = hdr[hoff:].astype(np.int64)
    starts = np.concatenate([[0], row_end[:-1]])
    j, c, q = rdk.decode_triples(ent[: row_end[-1]], m_t, M)
    return [list(zip(j[a:b], c[a:b], q[a:b])) for a, b in zip(starts,
                                                              row_end)]


@pytest.mark.parametrize("seed,wide,floors,elide", [
    (1, False, True, True), (2, False, False, False), (3, True, True, False),
    (4, False, False, True)])
def test_fused_flat_attr_equal(seed, wide, floors, elide):
    stores, qmats, rankbs, prunes = _group(seed)
    s, k = 8192, 256
    ref = _ref_fused_attr(stores, qmats, rankbs, prunes, s, k, wide, floors,
                          elide)
    port = _port_fused_attr(stores, qmats, rankbs, prunes, s, k, wide,
                            floors, elide)
    _eq(ref, port)
    _models_eq(stores, qmats, rankbs, prunes, s, k, wide, floors, elide,
               None, ref)
    hdr, ent = port[0].numpy(), port[1].numpy()
    assert hdr.shape == (3, 5 + 8) and (hdr[:, 0] > 0).all()
    # each block is the store's own solo answer (codes on its own width)
    m_max = max(m_t for _n, m_t in GROUP)
    for i, (st, (_n, m_t)) in enumerate(zip(stores, GROUP)):
        sh, se = pdk.calculate_deps_flat_attr(
            _port_cols("table", st["table"]), _port_cols("attr", st["attr"]),
            _port_cols("aidx", st["aidx"]), torch.from_numpy(st["qmat"]),
            torch.from_numpy(st["rankb"]), st["prune"], M, s, k, wide,
            floors, elide)
        np.testing.assert_array_equal(sh.numpy(), hdr[i])
        assert _triples(sh.numpy(), se.numpy(), 5, m_t) == \
            _triples(hdr[i], ent[i], 5, m_max)


def test_fused_flat_attr_overflow_equal():
    """Learned budgets too small: -1 holes inside the live prefix and the
    overflow header, byte-equal too."""
    stores, qmats, rankbs, prunes = _group(5)
    args = (stores, qmats, rankbs, prunes, 24, 3, False, True, True)
    ref = _ref_fused_attr(*args)
    port = _port_fused_attr(*args)
    _eq(ref, port)
    _models_eq(*args, None, ref)
    hdr = port[0].numpy()
    assert (hdr[:, 1] > 24).any() or (hdr[:, 2] > 3).any()


def test_fused_flat_csr_equal():
    """The raw fused stage alone (the reference's ``fused_flat_csr``)."""
    stores, qmats, _rankbs, prunes = _group(6)
    tables = [_ref_cols("table", st["table"]) for st in stores]
    ref = rdk.fused_flat_csr(tables, qmats, prunes, M, 4096, 64)
    port = pdk.fused_flat_csr(
        [_port_cols("table", st["table"]) for st in stores],
        torch.from_numpy(qmats), prunes, M, 4096, 64)
    _eq(ref, port)
    _eq(ref, _fused_csr_model([st["table"] for st in stores], qmats, prunes,
                              M, 4096, 64))
    assert port[0].shape == (3, 2 + 8)


# -- K5's work split, in plain arithmetic --------------------------------------
#
# ops/csrc/fused_scan.cu ``fused_csr``: (1) items of (member, 256-slot tile
# of that member, group of query rows) write each member's mask words and
# word triple sums, the PAD columns' pairs counted by rule; (2) per
# (member, row) the word where the mask rank crosses kp = min(k, n_max)
# keeps only its first bits (each thread of the CTA walks its segment of
# words from its prefix), and each selected word gets its triple offset;
# (3) each member's header and row starts; (4) a warp a word of a
# (member, row), a lane a slot, writes the selected slots' triples in
# (col, q) order over the group's m_max x m pairs after the word's offset
# and the triples of the slots before it, up to kk = min(k, kp m_max m),
# then -1 past each member's total and a row's kk.  ``fused_attr``: chunks of
# CHUNK_WORDS words a member, keep words only up to its live entries, a
# member-local scan of the chunks' sums, kept entries placed at their
# chunk's offset, -1 past the member's kept total, and each row's new end
# read off the kept prefix.  The launch geometry is the kernels'
# (ops/_build.py GEOMETRY).

NT = _build.GEOMETRY["ACCORD_DEPS_THREADS"]
CW = _build.GEOMETRY["ACCORD_FUSED_CHUNK_WORDS"]
I64 = np.iinfo(np.int64)
UNSET = 0x5A5A5A5A      # a value no step writes: an unwritten cell shows


def _ts_lt(am, al, an, bm, bl, bn):
    """The 128-bit timestamp order: msb and lsb unsigned, then node."""
    am, al, bm, bl = (np.asarray(x).astype(np.uint64)
                      for x in (am, al, bm, bl))
    return (am < bm) | ((am == bm) & ((al < bl) | ((al == bl) & (an < bn))))


def _member_pairs(table, qmat, m, m_max, prune):
    """(admitted [B, n], overlapping pairs [B, n, m_max, m]) of one member
    over its own table, its columns past m_t PAD (lo > hi) by rule."""
    msb, lsb, node, kind, status, lo, hi = table
    n, m_t = lo.shape
    lo_p = np.full((n, m_max), rdk.PAD_LO, np.int64)
    hi_p = np.full((n, m_max), rdk.PAD_HI, np.int64)
    lo_p[:, :m_t], hi_p[:, :m_t] = lo, hi
    q = qmat.astype(np.int64)
    qlo, qhi = q[:, 7:7 + m], q[:, 7 + m:7 + 2 * m]
    ok = ((status >= 0) & (status != rdk.SLOT_INVALIDATED)
          & ~_ts_lt(msb, lsb, node, np.int64(prune[0]), np.int64(prune[1]),
                    np.int32(prune[2])))
    adm = (ok[None, :] & (((q[:, 3:4] >> kind[None, :]) & 1) > 0)
           & _ts_lt(msb[None, :], lsb[None, :], node[None, :], q[:, 0:1],
                    q[:, 1:2], q[:, 2:3].astype(np.int32))
           & ~((msb[None, :] == q[:, 4:5]) & (lsb[None, :] == q[:, 5:6])
               & (node[None, :] == q[:, 6:7])))
    ov = ((qlo[:, None, None, :] <= hi_p[None, :, :, None])
          & (lo_p[None, :, :, None] <= qhi[:, None, None, :]))
    return adm, ov


def _fused_csr_model(tables, qmats, prunes, m: int, s: int, k: int,
                     wide: bool = False):
    """K5's raw stage as the kernel splits it; ``tables`` numpy column
    tuples.  Returns (header int32[S, 2+B], entries [S, s]), equal to the
    reference's ``fused_flat_csr``."""
    n_s, b = qmats.shape[:2]
    ns = [t[5].shape[0] for t in tables]
    n_max, m_max = max(ns), max(t[5].shape[1] for t in tables)
    kp = min(k, n_max)
    kk = min(k, kp * m_max * m)
    tri, ovs = [], []
    for i, t in enumerate(tables):
        adm, ov = _member_pairs(t, qmats[i], m, m_max,
                                [p[i] for p in prunes])
        ovs.append(ov)
        tri.append(np.where(adm, ov.sum(axis=(2, 3)), 0))
    # 1. (member, tile, row group) items: each member's words written once
    rows = min(32, 1024 // max(m, 1))
    tiles = [-(-n // NT) for n in ns]
    tile0 = np.concatenate([[0], np.cumsum(tiles)])
    nw = [-(-n // 32) for n in ns]
    words = [np.full((b, w), -1, np.int64) for w in nw]
    tsum = [np.zeros((b, w), np.int64) for w in nw]
    for item in range(int(tile0[-1]) * -(-b // rows)):
        tile = item % int(tile0[-1])
        b0 = item // int(tile0[-1]) * rows
        i = int(np.searchsorted(tile0, tile, side="right")) - 1
        for r in range(b0, min(b0 + rows, b)):
            for j0 in range((tile - tile0[i]) * NT,
                            (tile - tile0[i] + 1) * NT, 32):
                w = j0 // 32
                if w >= nw[i]:
                    continue
                assert words[i][r, w] == -1
                t = tri[i][r, j0:j0 + 32]
                words[i][r, w] = sum(1 << l for l in range(len(t))
                                     if t[l] > 0)
                tsum[i][r, w] = t.sum()
    assert all((w >= 0).all() for w in words)
    # 2.-3. the kp cut, word offsets, header and starts, member by member
    hdr = np.zeros((n_s, 2 + b), np.int32)
    dt = np.int64 if wide else np.int32
    ent = np.full((n_s, s), UNSET, dt)
    wg = -(-n_max // 32)                  # phase-4 words a row, uniform
    mq = m_max * m
    for i in range(n_s):
        w_i = nw[i]
        per = -(-w_i // NT)
        counts = np.zeros(b, np.int64)
        nsel = np.zeros(b, np.int64)
        tpre = np.zeros((b, w_i), np.int64)
        sel = [list(x) for x in words[i]]
        for r in range(b):
            pcs = [bin(int(x)).count("1") for x in sel[r]]
            cut, cword, pex = w_i, 0, 0
            for th in range(NT):
                run = pex
                for w in range(min(th * per, w_i), min(th * per + per, w_i)):
                    p = pcs[w]
                    if p == 0:
                        continue
                    if run >= kp:
                        cut = min(cut, w)
                        break
                    if run + p > kp:
                        cword = _low_set_bits(int(sel[r][w]), kp - run)
                        cut = min(cut, w + 1)
                        break
                    run += p
                pex += sum(pcs[th * per:th * per + per])
            full = cut - 1 if cword else cut
            csum = sum(int(tri[i][r, (cut - 1) * 32 + l]) for l in range(32)
                       if cword >> l & 1)
            off = 0
            for w in range(cut):
                tpre[r, w] = off
                off += int(tsum[i][r, w]) if w < full else csum
            if cword:
                sel[r][cut - 1] = cword
            counts[r], nsel[r] = off, cut
        row_end = np.cumsum(counts)
        starts = row_end - counts
        total = int(row_end[-1])
        # 4. a warp a word, in any order: a lane a slot, each slot's
        # triples after the word's offset and the triples of the slots
        # before it in the word
        for r in range(b):
            for w in range(min(wg, int(nsel[r]))):
                tri_w = [int(ovs[i][r, w * 32 + l].sum())
                         if sel[r][w] >> l & 1 else 0 for l in range(32)]
                for l in range(32):
                    if not sel[r][w] >> l & 1:
                        continue
                    j = w * 32 + l
                    off = int(tpre[r, w]) + sum(tri_w[:l])
                    for p in np.flatnonzero(ovs[i][r, j].reshape(-1)):
                        pos = int(starts[r]) + off
                        if off < kk and pos < s:
                            assert ent[i, pos] == UNSET
                            ent[i, pos] = j * mq + p
                        off += 1
        ent[i, min(total, s):] = -1
        for r in range(b):
            if counts[r] > kk:
                ent[i, int(starts[r]) + kk:min(int(row_end[r]), s)] = -1
        pairc = max(sum(bin(int(x)).count("1") for x in words[i][r])
                    for r in range(b))
        hdr[i] = np.concatenate([[total, max(int(counts.max()), pairc)],
                                 row_end])
    return torch.from_numpy(hdr), torch.from_numpy(ent)


def _fused_attr_model(tables, attrs, aidxs, rankbs, hdr_raw, ent, m: int,
                      floors: bool = True, elide: bool = True):
    """K5's attribution as the kernel splits it (port column sets on the
    CPU): per member, chunks of CW words with keep words only below its
    live entries, a member-local scan of the chunks' kept entries, each
    chunk's kept entries placed at its offset and -1 in its positions past
    the member's kept total, and the new row ends off the kept prefix
    (X(b) = s in the member's first chunk).  Returns (header int32[S,
    5+B], entries [S, s]), equal to the reference's ``fused_flat_attr``
    stage."""
    n_max, m_max = pdk.group_shape(tables)
    f, t, l = pdk.attr_group_shape(aidxs)
    n_s, s = ent.shape
    nw = -(-s // 32)
    cpm = max(1, -(-nw // CW))
    hdrs, outs = [], []
    for i, tab in enumerate(tables):
        keep, _live, _row, n_trans, n_dec = pdk._attr_keep_plain(
            pdk._pad_table_cols(tab, n_max, m_max).lo,
            pdk._pad_attr_cols(attrs[i], n_max),
            pdk._pad_attr_index(aidxs[i], f, t, l), rankbs[i], hdr_raw[i],
            ent[i], m_max, m, floors, elide, None)
        keep = keep.numpy()
        e = ent[i].numpy()
        h = hdr_raw[i].numpy().astype(np.int64)
        row_end = h[2:]
        b = row_end.shape[0]
        live_end = min(max(int(h[0]), 0), s)
        chunk = [(c * CW, min(c * CW + CW, nw)) for c in range(cpm)]
        csum = [int(sum(keep[w * 32:min(w * 32 + 32, s)].sum()
                        for w in range(w0, w1) if w * 32 < live_end))
                for w0, w1 in chunk]
        kept_all = sum(csum)
        out = np.full(s, UNSET, e.dtype)
        new_end = np.full(b, UNSET, np.int64)
        x = np.minimum(row_end, live_end)
        x[-1] = live_end
        for c, (w0, w1) in enumerate(chunk):
            base = sum(csum[:c])
            for p in range(w0 * 32, min(w1 * 32, s)):
                for r in np.flatnonzero(x == p):
                    new_end[r] = row_end[r] - (p - base)
                if p < live_end and keep[p]:
                    assert out[base] == UNSET
                    out[base] = e[p]
                    base += 1
            lo_ = max(w0 * 32, kept_all)
            out[lo_:min(w1 * 32, s)] = -1
        for r in np.flatnonzero(x == s):
            new_end[r] = row_end[r] - (s - kept_all)
        head = [new_end[-1], h[0], h[1], int(n_trans), int(n_dec)]
        hdrs.append(np.concatenate([head, new_end]).astype(np.int32))
        outs.append(out)
    return torch.from_numpy(np.stack(hdrs)), torch.from_numpy(np.stack(outs))


def _models_eq(stores, qmats, rankbs, prunes, s, k, wide, floors, elide,
               ref_raw, ref_attr):
    """Both models against the reference: the raw stage's, and the
    attribution's over the port's raw CSR."""
    if ref_raw is not None:
        _eq(ref_raw, _fused_csr_model([st["table"] for st in stores],
                                      qmats, prunes, M, s, k, wide))
    raw = pdk.fused_flat_csr(
        [_port_cols("table", st["table"]) for st in stores],
        torch.from_numpy(qmats), prunes, M, s, k, wide)
    _eq(ref_attr, _fused_attr_model(
        [_port_cols("table", st["table"]) for st in stores],
        [_port_cols("attr", st["attr"]) for st in stores],
        [_port_cols("aidx", st["aidx"]) for st in stores],
        torch.from_numpy(rankbs), *raw, M, floors, elide))


# members of 300 slots (not a whole number of tiles), 40 (less than a
# tile) and 96 whose slots are all FREE; interval widths 4, 2, 8
EDGE = ((300, 4), (40, 2), (96, 8))


def _edge_group(seed, b):
    stores = [_inputs(seed * 10 + i, n=n, m_t=m_t, m=M, b=b)
              for i, (n, m_t) in enumerate(EDGE)]
    stores[2]["table"][4][:] = -1         # the attribution's status too
    qmats = np.stack([st["qmat"] for st in stores])
    r = min(2, b - 1)                     # a query interval over the line:
    qmats[0, r, 7], qmats[0, r, 7 + M] = I64.min, I64.max   # PAD pairs
    rankbs = np.stack([st["rankb"] for st in stores])
    prunes = tuple(np.array([st["prune"][c] for st in stores],
                            np.int32 if c == 2 else np.int64)
                   for c in range(3))
    return stores, qmats, rankbs, prunes


SPLIT_CASES = [
    pytest.param(30, 33, 8192, 256, False, True, True, id="b33"),
    pytest.param(34, 1, 8192, 5, True, False, True, id="b1_kp_in_word_i64"),
    pytest.param(32, 8, 24, 3, False, True, False, id="s_and_k_overflow")]


@pytest.mark.parametrize("seed,b,s,k,wide,floors,elide", SPLIT_CASES)
def test_fused_split_edges_equal(seed, b, s, k, wide, floors, elide):
    """K5's work split at its edges: the port and both models equal the
    reference's raw stage and attribution."""
    stores, qmats, rankbs, prunes = _edge_group(seed, b)
    tables = [_ref_cols("table", st["table"]) for st in stores]
    ref_raw = rdk.fused_flat_csr(tables, qmats, prunes, M, s, k, wide)
    _eq(ref_raw, pdk.fused_flat_csr(
        [_port_cols("table", st["table"]) for st in stores],
        torch.from_numpy(qmats), prunes, M, s, k, wide))
    ref = _ref_fused_attr(stores, qmats, rankbs, prunes, s, k, wide, floors,
                          elide)
    _eq(ref, _port_fused_attr(stores, qmats, rankbs, prunes, s, k, wide,
                              floors, elide))
    _models_eq(stores, qmats, rankbs, prunes, s, k, wide, floors, elide,
               ref_raw, ref)
    hdr = np.asarray(ref_raw[0])
    assert (hdr[2, 2:] == 0).all()        # the FREE member selects nothing
    assert (hdr[:2, 0] > 0).all()
    if k == 5:                            # a mask count passes kp
        assert hdr[:, 1].max() > k
    if s == 24:                           # both budgets overflow
        assert (hdr[:, 0] > s).any() and (hdr[:, 1] > k).any()


def _drain(seed, n, d):
    """A seeded drain graph (dense and ELL forms) of ``n`` rows with
    undecided, invalidated, free and awaits_all rows and executeAt ties."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    for i in range(1, n):
        for _ in range(int(rng.integers(0, 3))):
            adj[i, int(rng.integers(0, i))] = True
    for _ in range(3):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a != b:
            adj[a, b] = True
    status = rng.choice(np.array([-1, 0, 1, 3, 4, 4, 4, 5, 5, 6], np.int32), n)
    msb = rng.integers(0, 6, n).astype(np.int64)
    lsb = np.zeros(n, np.int64)
    node = rng.integers(1, 3, n).astype(np.int32)
    aw = rng.random(n) < 0.15
    idx = np.full((n, d), -1, np.int32)
    for i in range(n):
        cols = np.nonzero(adj[i])[0][:d]
        idx[i, :len(cols)] = cols
    return (adj, status, msb, lsb, node, aw), (idx, status, msb, lsb, node,
                                               aw)


def test_fused_frontiers_equal():
    """Unequal rows and degrees; each row's live prefix is the solo
    frontier, pad rows are never ready."""
    _frontiers_equal(((16, 4), (40, 8), (24, 4)))


@pytest.mark.parametrize("shapes", [((1, 2), (37, 8), (100, 4), (17, 4)),
                                    ((50, 8), (1, 1))])
def test_fused_frontiers_odd_sizes_equal(shapes):
    """Members whose n is not a multiple of 16 (the dense kernel's
    16-byte chunks) and a member of one row."""
    _frontiers_equal(shapes)


def _frontiers_equal(shapes):
    cases = [_drain(30 + i, n, d) for i, (n, d) in enumerate(shapes)]
    ref_d = rdrk.fused_ready_frontier(
        [rdrk.DrainState(*map(jnp.asarray, c[0])) for c in cases])
    ref_e = rdrk.fused_ready_frontier_ell(
        [rdrk.EllDrainState(*map(jnp.asarray, c[1])) for c in cases])
    sts = [convert.tables_from_numpy({"drain": c[0], "ell": c[1]}, "cpu")
           for c in cases]
    port_d = pdrk.fused_ready_frontier([s["drain"] for s in sts])
    port_e = pdrk.fused_ready_frontier_ell([s["ell"] for s in sts])
    np.testing.assert_array_equal(np.asarray(ref_d), port_d.numpy())
    np.testing.assert_array_equal(np.asarray(ref_e), port_e.numpy())
    assert port_d.shape == port_e.shape == (len(shapes),
                                            max(n for n, _d in shapes))
    for i, ((n, _d), st) in enumerate(zip(shapes, sts)):
        np.testing.assert_array_equal(
            port_d[i, :n].numpy(), pdrk.ready_frontier(st["drain"]).numpy())
        np.testing.assert_array_equal(
            port_e[i, :n].numpy(),
            pdrk.ready_frontier_ell(st["ell"]).numpy())
        assert not port_e[i, n:].any()


@pytest.mark.parametrize("ns", [[1] * 130, list(range(1, 131)),
                                [64, 7, 0, 129], [8] * 128 + [9]])
def test_fused_frontier_launch_plan(ns):
    """Members split into launches of at most FUSED_MAX_STORES in order;
    each member's flags start at its row of the group's [S, n_max] output
    (a launch's output at its first member's row), its CTAs follow the
    members' before it in the launch, max(1, ceil(n / 8)) of them; the
    kernel's search (the last member whose first CTA is at or before a
    CTA) gives every row below n to exactly one (CTA, warp), and each
    member's pad rows to its last CTA."""
    n_max = max(ns)
    plan = pkern.fused_frontier_launches(tuple(ns), n_max)
    cap = _build.LIMITS["ACCORD_FUSED_MAX_STORES"]
    assert [(i0, i1) for i0, i1, _c, _r in plan] == [
        (i, min(i + cap, len(ns))) for i in range(0, len(ns), cap)]
    if len(ns) == 130:
        assert [i1 - i0 for i0, i1, _c, _r in plan] == [128, 2]
    written = np.zeros((len(ns), n_max), np.int64)
    walked = np.zeros((len(ns), n_max), np.int64)
    for i0, i1, ctas, rows in plan:
        assert len(rows) == i1 - i0
        g0s = [g0 for _row, g0 in rows]
        assert g0s[0] == 0 and ctas == g0s[-1] + max(1, -(-ns[i1 - 1] // 8))
        for k, (row, _g0) in enumerate(rows):
            assert i0 * n_max + row == (i0 + k) * n_max
        for g in range(ctas):
            m = int(np.searchsorted(g0s, g, side="right")) - 1
            n, first = ns[i0 + m], (g - g0s[m]) * pkern.FRONTIER_ROWS
            # a warp a row; the CTA's flags stored from its first row
            for w in range(pkern.FRONTIER_ROWS):
                walked[i0 + m, first + w:first + w + 1] += first + w < n
            written[i0 + m, first:first + pkern.FRONTIER_ROWS] += 1
            if g + 1 == (g0s[m + 1] if m + 1 < len(g0s) else ctas):
                written[i0 + m, first + pkern.FRONTIER_ROWS:] += 1
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_array_equal(
        walked, np.arange(n_max)[None, :] < np.array(ns)[:, None])


def _ell_member_shapes(seed, count):
    rng = np.random.default_rng(seed)
    return [(int(n), int(d)) for n, d in zip(
        rng.integers(1, 600, count),
        rng.choice([1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64], count))]


@pytest.mark.parametrize("ns", [[0, 1, 255, 256, 257, 300, 513],
                                [n for n, _d in _ell_member_shapes(36, 130)]])
def test_fused_frontier_ell_launch_plan(ns):
    """K6 ELL's plan (``fused_frontier_launches`` at FRONTIER_ELL_ROWS rows
    a CTA, the GEOMETRY value nvcc gets) equals one written here: members
    in launches of FUSED_MAX_STORES in order (130 split 128 + 2), a
    member's flags at its row of the group's output, its CTAs after the
    launch's earlier members', max(1, ceil(n / rows)) of them."""
    n_max = max(ns)
    cap = _build.LIMITS["ACCORD_FUSED_MAX_STORES"]
    rows = _build.GEOMETRY["ACCORD_FRONTIER_ELL_ROWS"]
    assert pkern.FRONTIER_ELL_ROWS == rows
    want = []
    for i0 in range(0, len(ns), cap):
        g, plan = 0, []
        for k, n in enumerate(ns[i0:i0 + cap]):
            plan.append((k * n_max, g))
            g += max(1, -(-n // rows))
        want.append((i0, min(i0 + cap, len(ns)), g, plan))
    assert pkern.fused_frontier_launches(tuple(ns), n_max, rows) == want
    assert [i1 - i0 for i0, i1, _c, _r in want] == (
        [128, 2] if len(ns) == 130 else [len(ns)])


def _fused_ell_model(states):
    """K6 ELL's flat grid on the CPU: each launch of the plan, each CTA's
    member by the kernel's search (the last member whose first CTA is at
    or before it), the member's CTAs run by the walk model at its own
    degree, its last CTA writing its pad rows up to n_max."""
    ns = tuple(st.adj_idx.shape[0] for st in states)
    n_max = max(ns)
    out = torch.zeros((len(states), n_max), dtype=torch.bool)
    writes = torch.zeros((len(states), n_max), dtype=torch.int64)
    for i0, i1, ctas, rows in pkern.fused_frontier_launches(
            ns, n_max, pkern.FRONTIER_ELL_ROWS):
        g0s = np.array([g0 for _row, g0 in rows])
        member = np.searchsorted(g0s, np.arange(ctas), side="right") - 1
        for k in range(i1 - i0):
            mine = np.nonzero(member == k)[0]
            assert list(mine) == list(range(g0s[k], g0s[k] + len(mine)))
            assert rows[k][0] == k * n_max
            flags, w, *_ = ell_walk_model(states[i0 + k], len(mine), n_max,
                                          True)
            out[i0 + k] = flags
            writes[i0 + k] = w
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("shapes", [
    ((37, 3), (300, 64), (1, 1), (100, 8), (45, 33), (0, 4), (257, 17)),
    tuple(_ell_member_shapes(37, 130))])
def test_fused_ell_model_equals_reference(shapes):
    """Members of unequal n and d (the reference pads rows with FREE and
    edges with -1; the kernel walks each member's own), and 130 members
    in two launches: the model, the plain version and the reference
    agree."""
    cases = [_ell_case(5000 + k, n, d) for k, (n, d) in enumerate(shapes)]
    ref = np.asarray(rdrk.fused_ready_frontier_ell(
        [rdrk.EllDrainState(*map(jnp.asarray, c)) for c in cases]))
    states = [convert.tables_from_numpy({"ell": c}, "cpu")["ell"]
              for c in cases]
    np.testing.assert_array_equal(ref, _fused_ell_model(states).numpy())
    np.testing.assert_array_equal(
        ref, pdrk.fused_ready_frontier_ell(states).numpy())
    assert ref.any()
