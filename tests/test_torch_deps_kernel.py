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


def test_scatter_rows_equal():
    """K3 against scatter_table_rows / scatter_attr_cols, with the pad rows
    repeating the last dirty row."""
    inp = _inputs(8)
    rows = np.array([3, 17, 40, 40, 40], np.int32)     # last row repeated
    tnew = _inputs(9)["table"]
    src = [a[rows] for a in tnew]
    ref = rdk.scatter_table_rows(_ref("table", inp["table"]),
                                 jnp.asarray(rows), *src)
    port = pdk.scatter_table_rows(_port(inp, "table"), rows, *src)
    _eq(ref, port)
    anew = _inputs(10)["attr"]
    src = [a[rows] for a in anew]
    ref = rdk.scatter_attr_cols(_ref("attr", inp["attr"]), jnp.asarray(rows),
                                *src)
    port = pdk.scatter_attr_cols(_port(inp, "attr"), rows, *src)
    _eq(ref, port)


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
