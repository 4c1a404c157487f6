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
from accord_tpu_torch.ops import convert
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


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("s,k", [(4096, 64), (24, 3)])
def test_bucketed_flat_equal(seed, s, k):
    """K1a: keys and ranges, wide-list spill, duplicate bucket entries,
    empty rows; (24, 3) overflows both s and k."""
    inp = _inputs(seed)
    m, keff = inp["m"], 8
    ref = rdk.bucketed_flat_jit(_ref("table", inp["table"]),
                                _ref("buckets", inp["buckets"]),
                                jnp.asarray(inp["qmat_b"]), m, 4, s, k,
                                _prune_ref(inp["prune"]), keff=keff)
    port = pdk.bucketed_flat(_port(inp, "table"), _port(inp, "buckets"),
                             torch.from_numpy(inp["qmat_b"]), m, 4, s, k,
                             inp["prune"], keff=keff)
    _eq(ref, port)
    assert int(port[0][0]) > 0


@pytest.mark.parametrize("seed", [0, 8])
@pytest.mark.parametrize("s,k", [(4096, 64), (20, 2)])
def test_dense_flat_equal(seed, s, k):
    """K1b: dense mask, per-row slot compaction, triple expansion."""
    inp = _inputs(seed)
    m = inp["m"]
    table = _ref("table", inp["table"])
    ref = rdk.calculate_deps_flat_pruned(table, jnp.asarray(inp["qmat"]),
                                         *_prune_ref(inp["prune"]), m, s, k)
    port = pdk.calculate_deps_flat(_port(inp, "table"),
                                   torch.from_numpy(inp["qmat"]), m, s, k,
                                   prune=inp["prune"])
    _eq(ref, port)
    assert int(port[0][0]) > 0
    # no prune: the reference's unpruned kernel
    ref = rdk.calculate_deps_flat(table, jnp.asarray(inp["qmat"]), m, s, k)
    port = pdk.calculate_deps_flat(_port(inp, "table"),
                                   torch.from_numpy(inp["qmat"]), m, s, k)
    _eq(ref, port)


@pytest.mark.parametrize("floors,elide", [(True, True), (False, True),
                                          (True, False), (False, False)])
@pytest.mark.parametrize("seed", [7, 12])
def test_attributed_equal(seed, floors, elide):
    """K1 + K2: both attributed compositions, every static leg switch."""
    inp = _inputs(seed)
    m = inp["m"]
    args_ref = (_ref("table", inp["table"]), _ref("attr", inp["attr"]),
                _ref("aidx", inp["aidx"]))
    args_port = (_port(inp, "table"), _port(inp, "attr"), _port(inp, "aidx"))
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
    # live entries, some elided as transitive (and, for seed 12, some
    # below a decided pivot) when the legs are on
    assert int(port[0][0]) > 0
    if elide:
        assert int(port[0][3]) + int(port[0][4]) > 0


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
    from accord_tpu_torch.ops import kernels
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
