"""The port's deps kernels (K1 bucketed / dense scan, K2 attribution, K3 row
scatter) against the JAX package on the same seeded numpy inputs.

Everything runs on the CPU, where the port's entry points take their plain
PyTorch versions; the CUDA kernels are held against those same plain
versions on the card by ``chip_smoke.py``.  Tolerance is zero: every output
is integer and must be byte-equal, header and entries."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.local.device_index import _AttrIndexHost
from accord_tpu.ops import deps_kernel as rdk
from accord_tpu_torch.ops import _build, convert, kernels
from accord_tpu_torch.ops import deps_kernel as pdk

I64 = np.iinfo(np.int64)
# timestamp words at the protocol's boundaries: epoch < 2^48 (msb), hlc
# < 2^63, flags < 2^16 (lsb carries hlc_lo48 << 16 | flags, so its top bit
# is live), negative int64 bit patterns included
WORDS = np.array([0, 1, (1 << 16) - 1, (1 << 47), (1 << 48) - 1,
                  (1 << 62), I64.max, I64.min, -1, -(1 << 48)], np.int64)


def _ids(rng, n):
    msb = np.where(rng.random(n) < 0.3, rng.choice(WORDS, n),
                   rng.integers(0, 8, n)).astype(np.int64)
    lsb = np.where(rng.random(n) < 0.3, rng.choice(WORDS, n),
                   rng.integers(0, 8, n)).astype(np.int64)
    node = rng.integers(-1, 4, n).astype(np.int32)
    return msb, lsb, node


def _intervals(rng, n, m, space, fill):
    lo = np.full((n, m), rdk.PAD_LO, np.int64)
    hi = np.full((n, m), rdk.PAD_HI, np.int64)
    for i in range(n):
        for c in range(int(rng.integers(0 if fill else 1, m + 1))):
            a = int(rng.integers(0, space))
            w = 0 if rng.random() < 0.6 else int(rng.integers(1, 40))
            lo[i, c], hi[i, c] = a, a + w
    return lo, hi


def _inputs(seed, n=64, m_t=4, m=4, b=8, g=16, kb=16, w=16, space=150):
    """Seeded table, bucket index, query matrix and attribution inputs."""
    rng = np.random.default_rng(seed)
    msb, lsb, node = _ids(rng, n)
    kind = rng.integers(0, 6, n).astype(np.int32)
    status = rng.integers(-1, 7, n).astype(np.int32)
    lo, hi = _intervals(rng, n, m_t, space, fill=False)
    table = (msb, lsb, node, kind, status, lo, hi)
    # bucket entries reference real slots (some several times: dedupe)
    used = (lo <= hi).sum(axis=1)

    def entries(shape):
        slot = rng.integers(-1, n, shape).astype(np.int32)
        s = np.clip(slot, 0, None)
        col = (rng.random(shape) * used[s]).astype(np.int32)
        elo = lo[s, col]
        ehi = hi[s, col]
        pad = (slot < 0) | (elo > ehi)
        slot = np.where(pad, -1, slot).astype(np.int32)
        return (np.where(pad, rdk.PAD_LO, elo), np.where(pad, rdk.PAD_HI, ehi),
                slot, np.where(pad, 0, col).astype(np.int32), msb[s], lsb[s],
                node[s], kind[s])
    bk = entries((g, kb))
    wd = entries((w,))
    buckets = bk + wd
    # queries: bounds and self ids sometimes equal to table ids
    qmat = np.zeros((b, 7 + 2 * m), np.int64)
    bm, bl, bn = _ids(rng, b)
    pick = rng.integers(0, n, b)
    same = rng.random(b) < 0.4
    qmat[:, 0] = np.where(same, msb[pick], bm)
    qmat[:, 1] = np.where(same, lsb[pick], bl)
    qmat[:, 2] = np.where(same, node[pick], bn)
    qmat[:, 3] = rng.integers(0, 1 << 6, b)
    qmat[:, 4] = msb[pick]
    qmat[:, 5] = lsb[pick]
    qmat[:, 6] = node[pick]
    qlo, qhi = _intervals(rng, b, m, space, fill=True)
    qmat[:, 7:7 + m] = qlo
    qmat[:, 7 + m:] = qhi
    if b > 2:
        qmat[b - 1, 7:] = qmat[b - 2, 7:]      # a pad-like repeated row
        qmat[0, 7:7 + m] = rdk.PAD_LO          # an empty query row
        qmat[0, 7 + m:] = rdk.PAD_HI
    qb = rng.integers(-1, g, (b, m * 4)).astype(np.int64)
    qmat_b = np.concatenate([qmat, qb], axis=1)
    # attribution: per-slot columns and a floor + elision index
    dom = rng.integers(0, 2, n).astype(np.int32)
    em, el, en = _ids(rng, n)
    eknown = rng.random(n) < 0.7
    attr = (dom, status, msb, lsb, node, em, el, en, eknown)
    nf = int(rng.integers(0, 6))
    fbnd = np.unique(rng.integers(0, space, nf)).astype(np.int64)
    # low per-segment floors, so most key entries survive to the elision legs
    fm = rng.integers(0, 2, len(fbnd) + 1).astype(np.int64)
    fl = rng.integers(0, 4, len(fbnd) + 1).astype(np.int64)
    fn = np.ones(len(fbnd) + 1, np.int32)
    toks = np.unique(rng.choice(lo[lo != rdk.PAD_LO], 24)).astype(np.int64)
    lens = rng.integers(1, 4, len(toks))
    eptr = np.zeros(len(toks) + 1, np.int32)
    np.cumsum(lens, out=eptr[1:])
    xm, xl, xn = _ids(rng, int(lens.sum()))
    # each token's committed-write execs sorted ascending (the CFK order)
    for t in range(len(toks)):
        sl_ = slice(eptr[t], eptr[t + 1])
        keys = list(zip(xm[sl_].astype(np.uint64), xl[sl_].astype(np.uint64),
                        xn[sl_]))
        o = sorted(range(len(keys)), key=lambda i: keys[i])
        xm[sl_], xl[sl_], xn[sl_] = xm[sl_][o], xl[sl_][o], xn[sl_][o]
    host = _AttrIndexHost((fbnd, fm, fl, fn), toks, eptr, xm, xl, xn)
    aidx = host.pad
    rankb = host.rank_bounds(qmat)
    # a low batch floor: it prunes some entries and keeps most (the ids'
    # boundary words exercise the unsigned compare against it)
    prune = (int(rng.integers(0, 3)), int(rng.integers(0, 4)), 1)
    return dict(table=table, buckets=buckets, qmat=qmat, qmat_b=qmat_b,
                attr=attr, aidx=aidx, rankb=rankb, prune=prune, m=m,
                m_t=m_t, g=g, kb=kb)


def _ref(kind, cols):
    return getattr(rdk, {"table": "DepsTable", "buckets": "BucketTable",
                         "attr": "AttrCols", "aidx": "AttrIndex"}[kind])(
        *(jnp.asarray(a) for a in cols))


def _port(inp, kind):
    return convert.tables_from_numpy({kind: inp[kind]}, "cpu")[kind]


def _eq(ref, port):
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())
        assert np.asarray(r).dtype == p.numpy().dtype


def _prune_ref(prune):
    return (jnp.asarray(np.int64(prune[0])), jnp.asarray(np.int64(prune[1])),
            jnp.asarray(np.int32(prune[2])))


# -- K1a's decomposition, in plain arithmetic ----------------------------------
#
# ops/csrc/deps_scan.cu ``bucketed_csr``: a CTA a query row.  Each warp
# takes 32 x EU candidates at a time and ballots place the valid codes, in
# candidate order, at an offset that one shared atomic claims (so the
# warps' chunks land in any order).  A row of at most 32 codes is sorted by
# one warp's shuffle network; a longer row as warp-sorted runs of 32 (the
# last padded with the sentinel) merged pairwise, each code placed by its
# rank in the partner run.  The first of each run of equal codes is kept
# up to kk = min(k, C); the header and row starts are a scan of the
# counts; each row is written at its start, -1 in its positions past kk
# and after the total, truncated at s.  Rows of more than SMEM_CODES
# candidates sort in global scratch, by the same steps.


EU = 2   # candidates a lane evaluates at once (csrc/deps_scan.cu EU)


def _warp_sort32(x):
    """``warp_sort32``'s bitonic network of shuffles over 32 lanes."""
    lane = np.arange(32)
    k = 2
    while k <= 32:
        j = k // 2
        while j:
            y = x[lane ^ j]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            x = np.where(keep_min, np.minimum(x, y), np.maximum(x, y))
            j //= 2
        k *= 2
    return x


def _merge_sort(a, sent):
    """``block_merge_sort``: sorted runs of 32, then pairwise merges, each
    code of a left run placed after the partner's codes below it, each of
    a right run after the partner's codes not above it; every position of
    a round is written exactly once."""
    n = len(a)
    n32 = -(-n // 32) * 32
    a = np.concatenate([a, np.full(n32 - n, sent, a.dtype)])
    for r in range(0, n32, 32):
        a[r:r + 32] = _warp_sort32(a[r:r + 32])
    w = 32
    while w < n32:
        b = np.zeros(n32, a.dtype)
        hits = np.zeros(n32, np.int64)
        for base in range(0, n32, 2 * w):
            left, right = a[base:base + w], a[base + w:base + 2 * w]
            pos_l = np.arange(len(left)) + np.searchsorted(right, left, "left")
            pos_r = np.arange(len(right)) + np.searchsorted(left, right,
                                                            "right")
            for pos, vals in ((pos_l, left), (pos_r, right)):
                b[base + pos] = vals
                np.add.at(hits, base + pos, 1)
        assert (hits == 1).all()
        a, w = b, 2 * w
    return a[:n]


def _bucketed_csr_model(m_t, buckets, qmat, m, span, s, k, prune, keff,
                        wide, row_offset, rng):
    """K1a's steps: ((header int32[2+B], entries[s]), nv a row, path)."""
    pred, cand = pdk.bucket_candidates(m_t, buckets, qmat, m, span, prune,
                                       keff, wide, row_offset)
    pred, cand = pred.numpy(), cand.numpy()
    b, c = pred.shape
    kk = min(k, c)
    sent = np.iinfo(cand.dtype).max
    counts, kept, nvs = [], [], []
    for r in range(b):
        chunks = [cand[r, c0:c0 + 32 * EU][pred[r, c0:c0 + 32 * EU]]
                  for c0 in range(0, c, 32 * EU)]
        buf = np.concatenate([cand[r, :0]]
                             + [chunks[i] for i in rng.permutation(len(chunks))])
        nvs.append(len(buf))
        if len(buf) <= 32:
            srt = _warp_sort32(np.concatenate(
                [buf, np.full(32 - len(buf), sent, buf.dtype)]))[:len(buf)]
        else:
            srt = _merge_sort(buf, sent)
        uniq = srt[np.concatenate([[True], srt[1:] != srt[:-1]])[:len(srt)]]
        counts.append(len(uniq))
        kept.append(uniq[:kk])
    ends = np.cumsum(counts)
    hdr = np.concatenate([[ends[-1], max(counts)], ends]).astype(np.int32)
    ent = np.full(s, -7, cand.dtype)      # a value no step writes
    for r in range(b):
        st = int(ends[r]) - counts[r]
        for p in range(st, min(st + counts[r], s)):
            ent[p] = kept[r][p - st] if p - st < kk else -1
    ent[min(int(ends[-1]), s):] = -1
    return (hdr, ent), nvs, ("shared" if c <= kernels.SMEM_CODES
                             else "global")


BUCKET_CASES = ([pytest.param(seed, s, k, None, id=f"{s}-{k}-{seed}")
                 for s, k in ((4096, 64), (24, 3)) for seed in (0, 3, 7)]
                + [pytest.param(seed, s, k, edge, id=edge) for seed, s, k, edge
                   in ((1, 4096, 64, "nv0"), (9, 4096, 64, "merge"),
                       (2, 8192, 512, "past_smem"),
                       (4, 4096, 2, "kk_in_dup_run"), (5, 0, 64, "s_in_row"),
                       (6, 4096, 64, "row_offset"), (8, 4096, 64, "wide"))])


@pytest.mark.parametrize("seed,s,k,edge", BUCKET_CASES)
def test_bucketed_flat_equal(seed, s, k, edge):
    """K1a: keys and ranges, wide-list spill, duplicate bucket entries,
    empty rows; (24, 3) overflows both s and k.  The model of the kernel's
    steps gives the same bytes, also at its edges: no valid candidate
    (nv0), rows of more than 32 codes merge-sorted in shared memory
    (merge) and past SMEM_CODES in global scratch (past_smem), kk
    cutting a run of equal codes, s inside a row, a row-sharded slice of
    the table, int64 codes."""
    past = edge == "past_smem"
    many = past or edge == "merge"         # rows of more than 32 codes
    inp = (_inputs(seed, m=8, kb=128 if past else 32, space=40) if many
           else _inputs(seed))
    m, keff = inp["m"], 128 if past else 32 if many else 8
    buckets, qmat_b = inp["buckets"], inp["qmat_b"].copy()
    prune, wide, row_offset = inp["prune"], edge == "wide", None
    if edge == "nv0":                      # every entry below the floor
        prune = (-1, -1, 3)
    if edge == "kk_in_dup_run":
        # row 1 becomes the (query, bucket line) pair with the most unique
        # codes when every probe of the query hits that one line: each
        # code then comes 4 times (one a probe of its interval)
        g = inp["g"]
        tries = np.repeat(inp["qmat_b"], g, axis=0)
        tries[:, 7 + 2 * m:] = np.tile(np.arange(g), len(qmat_b))[:, None]
        pred, cand = pdk.bucket_candidates(
            inp["m_t"], _port(inp, "buckets"), torch.from_numpy(tries), m,
            4, prune, keff)
        uniq = [len(set(c[p].tolist())) for p, c in zip(pred, cand)]
        qmat_b[1] = tries[int(np.argmax(uniq))]
    if edge == "row_offset":               # the upper half of the rows
        g = inp["g"] // 2
        buckets = tuple(c[g:] for c in buckets[:8]) + buckets[8:]
        row_offset = g
    if edge == "s_in_row":
        hdr = pdk.bucketed_flat(_port(inp, "table"), _port(inp, "buckets"),
                                torch.from_numpy(qmat_b), m, 4, 4096, k,
                                prune, keff=keff)[0]
        ends = hdr[2:].numpy().astype(np.int64)
        sizes = np.diff(ends, prepend=0)
        r = int(np.argmax(sizes >= 2))     # one entry into a row of 2+
        s = int(ends[r] - sizes[r]) + 1
    port_b = convert.tables_from_numpy({"buckets": buckets}, "cpu")[
        "buckets"]
    ref = rdk.bucketed_flat_jit(_ref("table", inp["table"]),
                                _ref("buckets", buckets),
                                jnp.asarray(qmat_b), m, 4, s, k,
                                _prune_ref(prune), row_offset=row_offset,
                                keff=keff, wide=wide)
    port = pdk.bucketed_flat(_port(inp, "table"), port_b,
                             torch.from_numpy(qmat_b), m, 4, s, k, prune,
                             keff=keff, wide=wide, row_offset=row_offset)
    _eq(ref, port)
    got, nvs, path = _bucketed_csr_model(
        inp["m_t"], port_b, torch.from_numpy(qmat_b), m, 4, s, k, prune,
        keff, wide, row_offset, np.random.default_rng(seed))
    _eq(ref, tuple(torch.from_numpy(x) for x in got))
    counts = np.diff(got[0][2:], prepend=0)
    assert (path == "global") == past
    if edge == "nv0":
        assert max(nvs) == 0 and int(port[0][0]) == 0
        return
    assert int(port[0][0]) > 0
    if past:
        assert max(nvs) > 32
    if edge == "kk_in_dup_run":
        assert nvs[1] >= 2 * counts[1] and counts[1] > k
    if edge == "s_in_row":
        assert ends[r] - sizes[r] < s < ends[r] <= int(got[0][0])
    if edge == "merge":
        assert min(nvs) <= 32 and max(nvs) > 64


# -- K1b's and K2's decompositions, in plain arithmetic -----------------------
#
# The CUDA kernels split the work in a way the port's plain versions do
# not: mask words, a cut inside a word, offsets per word, CTA ranges.
# These models follow ops/csrc/deps_scan.cu ``dense_csr`` and
# ops/csrc/attr_post.cu ``attr_post`` step by step, with the launch
# geometry the kernels are built with (ops/_build.py GEOMETRY), so that
# the split itself is held against the reference at its edges.


def _low_set_bits(x: int, n: int) -> int:
    """The n lowest set bits of x."""
    r = 0
    while n > 0 and x:
        low = x & -x
        r |= low
        x ^= low
        n -= 1
    return r


def _dense_csr_words(table, qmat: torch.Tensor, m: int, s: int, k: int,
                     prune=None, wide: bool = False):
    """K1b's decomposition: (1) the mask as 32-slot words with each word's
    triple sum; (2) per row, the word where the mask rank crosses kp =
    min(k, N) keeps its first bits only, the words up to it are the
    selection, and each gets its triple offset in the row (each thread of
    the kernel's CTA walks its own segment of words from its prefix); (3)
    the header and row starts; (4) each selected slot's triples written at its word's
    offset plus the triples of the slots before it in the word, up to kk a
    row and s in all, then -1 after the total and in a row's positions
    past kk.  The entries start as a value no step writes, so a position
    left unwritten shows.  Returns (header int32[2+B], entries[s]), equal
    to ``flat_csr_plain``."""
    query = pdk.query_from_qmat(qmat, m)
    mask = pdk.dep_mask_plain(table, query, prune).cpu().numpy()
    qlo, qhi = query.lo.cpu().numpy(), query.hi.cpu().numpy()
    tlo, thi = table.lo.cpu().numpy(), table.hi.cpu().numpy()
    b, n = mask.shape
    m_t = tlo.shape[1]
    # [B, N, m_t, m]: the overlapping pairs in (col, q) order
    ov = ((qlo[:, None, None, :] <= thi[None, :, :, None])
          & (tlo[None, :, :, None] <= qhi[:, None, None, :]))
    tri = np.where(mask, ov.sum(axis=(2, 3)), 0)
    nw = (n + 31) // 32
    bits = np.zeros((b, nw * 32), bool)
    bits[:, :n] = mask
    words = [[int(sum(1 << l for l in range(32) if bits[r, w * 32 + l]))
              for w in range(nw)] for r in range(b)]
    tsum = np.zeros((b, nw * 32), np.int64)
    tsum[:, :n] = tri
    tsum = tsum.reshape(b, nw, 32).sum(axis=2)
    kp = min(k, n)
    kk = min(k, kp * m_t * m)
    counts = np.zeros(b, np.int64)
    pairc = bits.sum(axis=1)
    nsel = np.zeros(b, np.int64)
    tpre = np.zeros((b, nw), np.int64)
    nt = _build.GEOMETRY["ACCORD_DEPS_THREADS"]   # a CTA's threads
    per = -(-nw // nt)              # words a thread walks in phase 2
    for r in range(b):
        pcs = [bin(x).count("1") for x in words[r]]
        cut, cword, pex = nw, 0, 0
        for t in range(nt):         # thread t's segment, from its prefix
            run = pex
            for w in range(min(t * per, nw), min(t * per + per, nw)):
                p = pcs[w]
                if p == 0:
                    continue
                if run >= kp:
                    cut = min(cut, w)
                    break
                if run + p > kp:
                    cword = _low_set_bits(words[r][w], kp - run)
                    cut = min(cut, w + 1)
                    break
                run += p
            pex += sum(pcs[t * per:t * per + per])
        full = cut - 1 if cword else cut
        csum = sum(int(tri[r, (cut - 1) * 32 + l]) for l in range(32)
                   if cword >> l & 1)
        off = 0
        for w in range(cut):
            tpre[r, w] = off
            off += int(tsum[r, w]) if w < full else csum
        if cword:
            words[r][cut - 1] = cword
        counts[r], nsel[r] = off, cut
    row_end = np.cumsum(counts)
    starts = row_end - counts
    total = int(row_end[-1])
    dt = np.int64 if wide else np.int32
    ent = np.full(s, 0x5A5A5A5A, dt)
    mq = m_t * m
    for r in range(b):
        for w in range(int(nsel[r])):
            off = int(tpre[r, w])
            for l in range(32):
                if not words[r][w] >> l & 1:
                    continue
                j = w * 32 + l
                for t in np.flatnonzero(ov[r, j].reshape(-1)):
                    pos = int(starts[r]) + off
                    if off < kk and pos < s:
                        ent[pos] = j * mq + t
                    off += 1
    ent[min(total, s):] = -1
    for r in range(b):
        if counts[r] > kk:
            ent[int(starts[r]) + kk:min(int(row_end[r]), s)] = -1
    maxc = max(int(counts.max()), int(pairc.max()))
    hdr = np.concatenate([[total, maxc], row_end]).astype(np.int32)
    return torch.from_numpy(hdr), torch.from_numpy(ent)


def _attr_post_ctas(tlo, attr, aidx, rankb, hdr_raw, ent, m_t: int, m: int,
                    floors: bool = True, elide: bool = True, tok=None,
                    ctas: int = 1):
    """K2's decomposition over ``ctas`` CTAs: the keep flags as 32-entry
    words, each CTA a contiguous range of words; each CTA's kept entries
    placed after the kept entries of the CTAs before it; and each row's
    new end read off the kept prefix, row_end[b] - (X(b) - kept(X(b)))
    with X(b) = min(row_end[b], total, s) (min(total, s) for the last row)
    and kept(x) the kept entries below position x, in place of a cumsum of
    per-row drops.  The kernel's CTA count is its cooperative grid's, set
    by occupancy, so a test sweeps it.  Returns (header int32[5+B], entries[s]), equal to
    ``attr_post_plain``."""
    keep, _live, _row, n_trans, n_dec = pdk._attr_keep_plain(
        tlo, attr, aidx, rankb, hdr_raw, ent, m_t, m, floors, elide, tok)
    keep = keep.cpu().numpy()
    e = ent.cpu().numpy()
    h = hdr_raw.cpu().numpy().astype(np.int64)
    s = e.shape[0]
    row_end = h[2:]
    b = row_end.shape[0]
    live_end = min(max(int(h[0]), 0), s)
    nw = (s + 31) // 32
    wpc = -(-nw // ctas)
    ranges = [(min(c * wpc, nw), min(c * wpc + wpc, nw))
              for c in range(ctas)]
    csum = [int(keep[w0 * 32:w1 * 32].sum()) for w0, w1 in ranges]
    out = np.full(s, 0x5A5A5A5A, e.dtype)
    new_end = np.full(b, 0x5A5A5A5A, np.int64)
    x = np.minimum(row_end, live_end)
    x[-1] = live_end
    for c, (w0, w1) in enumerate(ranges):
        base = sum(csum[:c])
        for p in range(w0 * 32, min(w1 * 32, s)):
            for r in np.flatnonzero(x == p):
                new_end[r] = row_end[r] - (p - base)
            if keep[p]:
                out[base] = e[p]
                base += 1
    kept_all = sum(csum)
    for r in np.flatnonzero(x == s):
        new_end[r] = row_end[r] - (s - kept_all)
    out[kept_all:] = -1
    head = [new_end[-1], h[0], h[1], int(n_trans), int(n_dec)]
    hdr = np.concatenate([head, new_end]).astype(np.int32)
    return torch.from_numpy(hdr), torch.from_numpy(out)


# K1b's tiling: 256-slot tiles, 32-slot mask words, 32-row groups
DENSE_CASES = [pytest.param(seed, s, k, {}, id=f"{s}-{k}-{seed}")
               for s, k in ((4096, 64), (20, 2)) for seed in (0, 8)]
DENSE_CASES += [pytest.param(seed, 4096, 64, shape, id=tag)
                for seed, shape, tag in (
                    (1, dict(n=1), "n1"), (2, dict(n=31), "n31"),
                    (3, dict(n=32), "n32"), (4, dict(n=33), "n33"),
                    (5, dict(n=255, space=600), "n255"),
                    (6, dict(n=257, space=600), "n257"),
                    (9, dict(m_t=1), "mt1"),
                    (10, dict(m=8, m_t=8), "m8_mt8"),
                    (13, dict(b=1), "b1"),
                    (12, dict(b=33, n=96), "b33"))]
# k = 5 cuts kp inside a word; s = 7 cuts inside a row; over 256 x 32
# slots, each phase-2 thread walks several words, and the thread after the
# crossing one may start on empty words
DENSE_CASES += [pytest.param(13, 4096, 5, dict(b=8), id="kp_in_word"),
                pytest.param(14, 7, 64, dict(b=8), id="s_in_row"),
                pytest.param(16, 1 << 14, 300,
                             dict(n=20_000, b=4, space=3000),
                             id="kp_past_one_thread")]


@pytest.mark.parametrize("seed,s,k,shape", DENSE_CASES)
def test_dense_flat_equal(seed, s, k, shape):
    """K1b: dense mask, per-row slot compaction, triple expansion; and its
    decomposition (mask words, the kp cut inside a word, word offsets) at
    the edges of its tiles and words."""
    inp = _inputs(seed, **shape)
    m = inp["m"]
    table = _ref("table", inp["table"])
    ref = rdk.calculate_deps_flat_pruned(table, jnp.asarray(inp["qmat"]),
                                         *_prune_ref(inp["prune"]), m, s, k)
    args = (_port(inp, "table"), torch.from_numpy(inp["qmat"]), m, s, k)
    port = pdk.calculate_deps_flat(*args, prune=inp["prune"])
    _eq(ref, port)
    _eq(ref, _dense_csr_words(*args, prune=inp["prune"]))
    if shape.get("n", 64) > 1:
        assert int(port[0][0]) > 0
    if k in (5, 300):  # some row's mask count passes kp: the cut is live
        assert int(port[0][1]) > k
    if s == 7:       # a row starts below s and ends above it
        ends = port[0][2:].numpy()
        assert ((ends - np.diff(ends, prepend=0) < s) & (ends > s)).any()
    if shape:
        return
    # no prune: the reference's unpruned kernel
    ref = rdk.calculate_deps_flat(table, jnp.asarray(inp["qmat"]), m, s, k)
    port = pdk.calculate_deps_flat(_port(inp, "table"),
                                   torch.from_numpy(inp["qmat"]), m, s, k)
    _eq(ref, port)


def _attr_args(inp):
    return ((_ref("table", inp["table"]), _ref("attr", inp["attr"]),
             _ref("aidx", inp["aidx"])),
            (_port(inp, "table"), _port(inp, "attr"), _port(inp, "aidx")))


def _attr_ctas_eq(ref, inp, raw, m, floors=True, elide=True):
    """K2's decomposition over 1 to 9 CTA ranges equals the reference."""
    table, attr, aidx = _attr_args(inp)[1]
    for ctas in (1, 2, 3, (raw[1].shape[0] + 31) // 32):
        _eq(ref, _attr_post_ctas(
            table.lo, attr, aidx, torch.from_numpy(inp["rankb"]), *raw,
            inp["m_t"], m, floors, elide, ctas=ctas))


ATTR_CASES = [pytest.param(seed, floors, elide, None,
                           id=f"{seed}-{floors}-{elide}")
              for seed in (7, 12)
              for floors, elide in ((True, True), (False, True),
                                    (True, False), (False, False))]
ATTR_CASES += [pytest.param(7, True, True, case, id=case)
               for case in ("row_all_dropped", "total_lt_s", "total_eq_s",
                            "total_gt_s", "run_across_ctas")]


@pytest.mark.parametrize("seed,floors,elide,case", ATTR_CASES)
def test_attributed_equal(seed, floors, elide, case):
    """K1 + K2: both attributed compositions, every static leg switch; and
    K2's decomposition (CTA ranges, row ends off the kept prefix) on a row
    whose every entry is dropped, on a dedupe run across a CTA range and
    with the raw total below, at and above s."""
    if case is not None:
        return _attr_edge(case)
    inp = _inputs(seed)
    m = inp["m"]
    args_ref, args_port = _attr_args(inp)
    rankb = inp["rankb"]
    ref = rdk.bucketed_attr_jit(*args_ref, _ref("buckets", inp["buckets"]),
                                jnp.asarray(inp["qmat_b"]),
                                jnp.asarray(rankb), m, 4, 4096, 64,
                                _prune_ref(inp["prune"]), keff=16,
                                floors=floors, elide=elide)
    port = pdk.bucketed_attr(*args_port, _port(inp, "buckets"),
                             torch.from_numpy(inp["qmat_b"]),
                             torch.from_numpy(rankb), m, 4, 4096, 64,
                             inp["prune"], keff=16, floors=floors,
                             elide=elide)
    _eq(ref, port)
    ref = rdk.calculate_deps_flat_attr(*args_ref, jnp.asarray(inp["qmat"]),
                                       jnp.asarray(rankb),
                                       *_prune_ref(inp["prune"]), m, 4096, 64,
                                       floors=floors, elide=elide)
    port = pdk.calculate_deps_flat_attr(*args_port,
                                        torch.from_numpy(inp["qmat"]),
                                        torch.from_numpy(rankb),
                                        inp["prune"], m, 4096, 64,
                                        floors=floors, elide=elide)
    _eq(ref, port)
    raw = pdk.calculate_deps_flat(args_port[0],
                                  torch.from_numpy(inp["qmat"]), m, 4096, 64,
                                  prune=inp["prune"])
    _attr_ctas_eq(ref, inp, raw, m, floors, elide)
    # live entries, some elided as transitive (and, for seed 12, some
    # below a decided pivot) when the legs are on
    assert int(port[0][0]) > 0
    if elide:
        assert int(port[0][3]) + int(port[0][4]) > 0


def _attr_edge(case):
    """One K2 edge: the dense attributed composition against the
    reference, and K2's decomposition on the same raw CSR."""
    run = case == "run_across_ctas"
    inp = _inputs(27, m=8, space=60) if run else _inputs(21)
    m = inp["m"]
    qmat = torch.from_numpy(inp["qmat"])
    if case == "row_all_dropped":
        # every slot the fullest row finds is a TRANSITIVE key dep: elided
        raw = pdk.flat_csr_plain(_port(inp, "table"), qmat, m, 4096, 64,
                                 inp["prune"])
        hdr, ent = raw[0].numpy(), raw[1].numpy()
        row = int(np.argmax(np.diff(hdr[2:], prepend=0)))
        start = hdr[2 + row - 1] if row else 0
        slots = ent[start:hdr[2 + row]] // (inp["m_t"] * m)
        slots = slots[slots >= 0]
        dom, status = inp["attr"][0].copy(), inp["attr"][1].copy()
        dom[slots], status[slots] = 0, rdk.SLOT_TRANSITIVE
        inp["attr"] = (dom, status) + inp["attr"][2:]
    s = 4096
    if case.startswith("total_"):
        full = pdk.flat_csr_plain(_port(inp, "table"), qmat, m, 4096, 64,
                                  inp["prune"])
        total = int(full[0][0])
        s = {"total_lt_s": total + 37, "total_eq_s": total,
             "total_gt_s": total * 2 // 3}[case]
    args_ref, args_port = _attr_args(inp)
    ref = rdk.calculate_deps_flat_attr(
        *args_ref, jnp.asarray(inp["qmat"]), jnp.asarray(inp["rankb"]),
        *_prune_ref(inp["prune"]), m, s, 64)
    port = pdk.calculate_deps_flat_attr(
        *args_port, qmat, torch.from_numpy(inp["rankb"]), inp["prune"], m,
        s, 64)
    _eq(ref, port)
    raw = pdk.calculate_deps_flat(args_port[0], qmat, m, s, 64,
                                  prune=inp["prune"])
    _attr_ctas_eq(ref, inp, raw, m)
    h = port[0].numpy()
    if case == "row_all_dropped":
        ends = np.concatenate([[0], h[5:]])
        assert ends[row + 1] == ends[row]
        assert np.diff(raw[0].numpy()[2:], prepend=0)[row] > 0
    if run:
        # a key-domain (row, slot, col) run crosses a 32-entry word, and so
        # the boundary of some CTA range above
        e = raw[1].numpy().astype(np.int64)
        ends = raw[0].numpy()[2:]
        pos = np.arange(len(e))
        key = np.searchsorted(ends, pos, side="right") * (1 << 40) + e // m
        dom = inp["attr"][0][np.clip(e // (inp["m_t"] * m), 0, None)]
        cross = [p for p in range(32, int(raw[0][0]), 32)
                 if key[p] == key[p - 1] and dom[p] == 0]
        assert cross


def test_attributed_overflow_equal():
    """The attribution stage over an overflowed raw buffer (holes of -1
    inside the live prefix) still matches byte for byte."""
    inp = _inputs(0)
    m = inp["m"]
    ref = rdk.calculate_deps_flat_attr(
        _ref("table", inp["table"]), _ref("attr", inp["attr"]),
        _ref("aidx", inp["aidx"]), jnp.asarray(inp["qmat"]),
        jnp.asarray(inp["rankb"]), *_prune_ref((0, 0, 0)), m, 16, 2)
    port = pdk.calculate_deps_flat_attr(
        _port(inp, "table"), _port(inp, "attr"), _port(inp, "aidx"),
        torch.from_numpy(inp["qmat"]), torch.from_numpy(inp["rankb"]),
        (0, 0, 0), m, 16, 2)
    _eq(ref, port)
    assert int(port[0][1]) > 16 or int(port[0][2]) > 2


def test_int64_codes_equal(monkeypatch):
    """INT32_CODE_MAX lowered in both modules: entries switch to int64 and
    stay byte-equal (the width is a transport detail)."""
    monkeypatch.setattr(rdk, "INT32_CODE_MAX", 0)
    monkeypatch.setattr(pdk, "INT32_CODE_MAX", 0)
    inp = _inputs(7)
    m, m_t = inp["m"], inp["m_t"]
    wide = pdk.wide_codes(64, m_t, m)
    assert wide and rdk.wide_codes(64, m_t, m)
    ref = rdk.bucketed_attr_jit(
        _ref("table", inp["table"]), _ref("attr", inp["attr"]),
        _ref("aidx", inp["aidx"]), _ref("buckets", inp["buckets"]),
        jnp.asarray(inp["qmat_b"]), jnp.asarray(inp["rankb"]), m, 4, 4096,
        64, _prune_ref(inp["prune"]), keff=16, wide=True)
    port = pdk.bucketed_attr(
        _port(inp, "table"), _port(inp, "attr"), _port(inp, "aidx"),
        _port(inp, "buckets"), torch.from_numpy(inp["qmat_b"]),
        torch.from_numpy(inp["rankb"]), m, 4, 4096, 64, inp["prune"],
        keff=16, wide=True)
    _eq(ref, port)
    assert port[1].dtype == torch.int64
    ref = rdk.calculate_deps_flat(_ref("table", inp["table"]),
                                  jnp.asarray(inp["qmat"]), m, 4096, 64, True)
    port = pdk.calculate_deps_flat(_port(inp, "table"),
                                   torch.from_numpy(inp["qmat"]), m, 4096,
                                   64, True)
    _eq(ref, port)


def _scatter_ref(kind, cols, idx, src):
    from accord_tpu.local import device_index as rdi
    if kind in ("table", "table_m3"):
        return rdk.scatter_table_rows(_ref("table", cols), idx, *src)
    if kind == "attr":
        return rdk.scatter_attr_cols(_ref("attr", cols), idx, *src)
    if kind == "bucket":
        return rdi._scatter_bucket_rows(tuple(jnp.asarray(c) for c in cols),
                                        idx, tuple(jnp.asarray(r)
                                                   for r in src))
    return rdi._scatter_drain_scalars(*(jnp.asarray(c) for c in cols), idx,
                                      *src)


def _scatter_port(kind, cols, idx, src):
    if kind in ("table", "table_m3"):
        return pdk.scatter_table_rows(_port({"table": cols}, "table"), idx,
                                      *src)
    if kind == "attr":
        return pdk.scatter_attr_cols(_port({"attr": cols}, "attr"), idx,
                                     *src)
    dev = [torch.from_numpy(c.copy()) for c in cols]
    kernels.scatter_rows(dev, idx, src)
    return dev


@pytest.mark.parametrize("kind", ["table", "table_m3", "attr", "bucket",
                                  "drain"])
@pytest.mark.parametrize("p", [1, 7, 8, 4097])
def test_scatter_rows_equal(kind, p):
    """K3 against each of the four reference scatters, through the packed
    staging layout (numpy in), on the columns ``chip_smoke.py`` holds the
    kernel on: P dirty rows, the pad rows repeating the last one's bytes
    as the mirrors pad them, every column dtype (bool included) and rows
    of 12, 24 and 32 bytes."""
    import chip_smoke as cs
    rng = np.random.default_rng(p * 10 + len(kind))
    n = 5000 if p > 8 else 64
    cols = cs.scatter_cols(rng, kind, n)
    distinct = {1: 1, 7: 7, 8: 5, 4097: 4000}[p]
    rows = np.sort(rng.choice(n, distinct, replace=False)).astype(np.int32)
    idx = np.concatenate([rows, np.full(p - distinct, rows[-1], np.int32)])
    new = cs.scatter_cols(rng, kind, n)
    src = [a[idx] for a in new]
    _eq(_scatter_ref(kind, cols, jnp.asarray(idx), src),
        _scatter_port(kind, cols, idx, src))


def test_packed_layout_offsets():
    """Every column's source rows start at a 16-byte boundary after the
    int64 index, the buffer holds exactly the rows it packs, and packing
    by several threads gives the same bytes."""
    cols = [torch.zeros((9, 3), dtype=torch.int32),
            torch.zeros(9, dtype=torch.bool),
            torch.zeros((9, 4), dtype=torch.int64)]
    offs, total = pdk.pack_layout(cols, 5)
    assert offs == [48, 112, 128] and total == 288
    buf = np.zeros(total, np.uint8)
    idx = np.array([0, 2, 4, 4, 4])
    rows = [np.arange(15).reshape(5, 3), np.array([1, 0, 1, 1, 1]),
            np.full((5, 4), -7)]
    pdk.pack_rows(buf, cols, idx, rows, offs)
    pdk.scatter_rows_packed_plain(cols, torch.from_numpy(buf), 5, offs)
    assert cols[0][4].tolist() == [12, 13, 14]
    assert cols[1].tolist() == [1, 0, 0, 0, 1, 0, 0, 0, 0]
    assert int(cols[2].sum()) == -7 * 12
    with pytest.raises(ValueError):
        pdk.pack_rows(buf, cols, idx, [rows[0][:, :2]] + rows[1:], offs)
    # packed by a pool of threads in row ranges: the same bytes
    from concurrent.futures import ThreadPoolExecutor
    threaded = np.zeros(total, np.uint8)
    with ThreadPoolExecutor(3) as pool:
        pdk.pack_rows(threaded, cols, idx, rows, offs, pool, 3)
    np.testing.assert_array_equal(threaded, buf)


class _Mark:
    """A stand-in for a CUDA event: pending until synchronized."""

    def __init__(self):
        self.pending = False
        self.waits = 0

    def record(self, stream=None):
        self.pending = True

    def synchronize(self):
        self.waits += 1
        self.pending = False


def test_staging_ring_waits_for_its_last_copy():
    """A staging buffer is written again only once the copy out of it has
    completed: taking a slot whose copy is pending waits on its event
    first, and a slot is never handed out twice while pending."""
    from accord_tpu_torch.ops.kernels import StagingRing
    ring = StagingRing(slots=2, pin=False, event=_Mark)
    s0, b0 = ring.take(100)
    b0[:4] = 7
    ring.copied(s0)
    mark0 = ring.marks[s0]
    assert mark0.pending and mark0.waits == 0
    s1, b1 = ring.take(5000)
    assert s1 != s0 and b1.numel() >= 5000 and mark0.pending
    ring.copied(s1)
    s2, b2 = ring.take(100)             # slot 0 again: its copy must end
    assert s2 == s0 and b2 is b0
    assert mark0.waits == 1 and not mark0.pending
    assert ring.marks[s1].pending        # slot 1's copy still in flight
    s3, b3 = ring.take(100000)           # grows slot 1 after its wait
    assert s3 == s1 and ring.marks[s1].waits == 1 and b3.numel() >= 100000
    s4, _b4 = ring.take(10)              # slot 0 was not copied again
    assert s4 == s0 and mark0.waits == 1


def test_staging_ring_gives_back_an_oversized_buffer():
    """A buffer grown past ``keep`` for one large call is replaced by one
    of the size asked for when its slot is next taken for less, after the
    wait on its copy; buffers up to ``keep`` are reused as they are."""
    from accord_tpu_torch.ops.kernels import StagingRing
    ring = StagingRing(slots=2, pin=False, event=_Mark, keep=1 << 16)
    s0, big = ring.take(1 << 20)
    ring.copied(s0)
    s1, small = ring.take(5000)
    ring.copied(s1)
    s2, b2 = ring.take(100)              # slot 0: the large one goes
    assert s2 == s0 and b2 is not big and b2.numel() == 4096
    assert ring.marks[s0].waits == 1 and ring.bufs[s0] is b2
    s3, b3 = ring.take(100)              # slot 1: under keep, reused
    assert s3 == s1 and b3 is small
    s4, b4 = ring.take(1 << 20)          # slot 0 grows again for a large one
    assert s4 == s0 and b4.numel() == 1 << 20
    s5, b5 = ring.take(40000)            # under keep but more than held
    assert s5 == s1 and b5.numel() == 1 << 16


@pytest.mark.parametrize("seed", [21, 22])
def test_reference_store_tables_carry_across(seed):
    """A live reference store's device columns (JAX NamedTuples) carried
    across with ``convert.fields`` give the same attributed CSR on both
    packages — real bucket structure, floors and elision index."""
    from tests.test_routing import _build
    _store, dev, _safe, _entries, _floor, qs = _build(seed)
    q_m = 4
    packed = [(sb, wit, toks, rngs, tid) for (tid, sb, wit, toks, rngs) in qs]
    qnp = rdk.pack_query_matrix(packed, q_m)
    qcols, wide_q = dev._bucket_query_cols(qnp, q_m)
    rows = np.nonzero(~wide_q)[0]
    b_pad = 1 << int(np.ceil(np.log2(len(rows))))
    rows = np.concatenate([rows, np.full(b_pad - len(rows), rows[-1])])
    qmat_b = np.concatenate([qnp[rows], qcols[rows].reshape(b_pad, -1)],
                            axis=1)
    aidx_host = dev._attr_index()
    rankb = aidx_host.rank_bounds(qnp)[rows]
    refs = {"table": dev.deps.device_table(),
            "buckets": dev.deps.bucket_device(),
            "attr": dev.deps.device_attr_cols(),
            "aidx": aidx_host.device()}
    ported = convert.tables_from_numpy(
        {k: convert.fields(v) for k, v in refs.items()}, "cpu")
    keff = dev.deps.bucket_keff()
    floor_id, prune = dev._batch_floor(qnp, q_m)
    prune = prune if prune is not None else (0, 0, 0)
    for s, k in ((1 << 14, 256), (64, 4)):
        ref = rdk.bucketed_attr_jit(
            refs["table"], refs["attr"], refs["aidx"], refs["buckets"],
            jnp.asarray(qmat_b), jnp.asarray(rankb), q_m, 4, s, k,
            _prune_ref(prune), keff=keff)
        port = pdk.bucketed_attr(
            ported["table"], ported["attr"], ported["aidx"],
            ported["buckets"], torch.from_numpy(qmat_b),
            torch.from_numpy(rankb), q_m, 4, s, k, prune, keff=keff)
        _eq(ref, port)
    assert int(port[0][0]) > 0


def test_checked_cols_by_identity():
    """A column set is checked once for its lifetime: the mirrors' copy
    carries its plan (device, data pointers, lengths), a set with a
    replaced column is a new tuple and is checked anew, and a set handed
    without a plan is checked on every call."""
    attr = _port(_inputs(0), "attr")
    planned = kernels.checked_cols(attr)
    assert isinstance(planned, pdk.AttrCols) and tuple(planned) == attr
    assert kernels.checked_cols(planned) is planned
    again = kernels.checked_cols(type(planned)(*planned))
    assert type(again) is type(planned) and again is not planned
    assert type(planned).__name__ == "AttrCols"
    cpu = torch.device("cpu")
    plan = ([c.data_ptr() for c in attr], [c.shape[0] for c in attr])
    assert kernels._cols_on(planned, cpu) == plan
    assert kernels._cols_on(attr, cpu) == plan
    for bad in (attr._replace(dom=attr.dom.to(torch.int64)),
                planned._replace(dom=planned.dom.to(torch.int64))):
        assert getattr(bad, "_plan", None) is None
        with pytest.raises(TypeError, match="AttrCols.dom"):
            kernels._cols_on(bad, cpu)
        with pytest.raises(TypeError, match="AttrCols.dom"):
            kernels.checked_cols(bad)
    with pytest.raises(ValueError, match="not all contiguous"):
        kernels._cols_on(attr._replace(
            dmsb=torch.stack([attr.dmsb, attr.dmsb], 1)[:, 0]), cpu)


def test_checked_cols_keep_no_dropped_set_alive():
    """The plan lives on the tuple the mirror keeps: once the mirror drops
    a set, nothing in the kernels module holds its columns."""
    import gc
    import weakref

    attr = kernels.checked_cols(_port(_inputs(0), "attr"))
    aidx = kernels.checked_cols(_port(_inputs(0), "aidx"))
    buckets = kernels.checked_cols(_port(_inputs(0), "buckets"))
    kernels._cols_on(attr, torch.device("cpu"))
    kernels._cols_on(buckets, torch.device("cpu"))
    gone = [weakref.ref(c) for c in (*attr, *aidx, *buckets)]
    del attr, aidx, buckets
    gc.collect()
    assert all(w() is None for w in gone)
