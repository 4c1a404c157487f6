"""The port's mesh programs (``accord_tpu_torch/parallel/sharded.py``)
against the JAX package's on the same seeded numpy inputs.

The reference runs its ``shard_map`` programs on the 8 virtual CPU devices
of the test conftest; the port runs the same functions over an 8-slice CPU
mesh (``make_mesh(8, "cpu")``), where every kernel wrapper takes its plain
version: K11 ``calculate_deps`` and ``masked_ts_max``, K12 the cross-shard
merge, K13 the row-sharded frontier and fixpoint sweep, and the
mesh-bucketed token gather.  Tolerance is zero: every output is integer
or boolean and must be byte-equal.  The last tests are the reference's
own mesh cases (``tests/test_parallel.py``) run on the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accord_tpu.ops import deps_kernel as rdk
from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu.ops import packing as rpk
from accord_tpu.parallel import sharded as rsh
from accord_tpu_torch.ops import convert
from accord_tpu_torch.ops import kernels
from accord_tpu_torch.ops import deps_kernel as pdk
from accord_tpu_torch.ops import drain_kernel as pdrk
from accord_tpu_torch.ops import packing as ppk
from accord_tpu_torch.parallel import sharded as psh
from tests.test_torch_deps_kernel import WORDS, _ids, _inputs
from tests.test_torch_drain_routes import HANDOVER, K8_GRAPHS

D = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == D, "conftest must provide 8 virtual devices"
    return rsh.make_mesh(D), psh.make_mesh(D, "cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(ref, port):
    r, p = _np(ref), _np(port)
    assert r.dtype == p.dtype and r.shape == p.shape, (r.dtype, p.dtype,
                                                       r.shape, p.shape)
    np.testing.assert_array_equal(r, p)


def _ref_nt(kind, cols):
    nt = {"table": rdk.DepsTable, "buckets": rdk.BucketTable,
          "attr": rdk.AttrCols, "aidx": rdk.AttrIndex,
          "drain": rdrk.DrainState}[kind]
    return nt(*(jnp.asarray(a) for a in cols))


def _port_nt(kind, cols):
    return convert.tables_from_numpy({kind: cols}, "cpu")[kind]


def _prunes(prune):
    return (jnp.asarray(np.int64(prune[0])), jnp.asarray(np.int64(prune[1])),
            jnp.asarray(np.int32(prune[2])))


def _cat(mask_slices):
    return torch.cat(list(mask_slices), dim=1)


def _drain_cols(seed, n):
    rng = np.random.default_rng(seed)
    status = rng.choice(np.array([-1, 1, 2, 3, 4, 4, 4, 5, 5, 6], np.int32),
                        n).astype(np.int32)
    em, el, en = _ids(rng, n)
    adj = rng.random((n, n)) < 0.08
    np.fill_diagonal(adj, False)
    aw = rng.random(n) < 0.1
    return (adj, status, em, el, en, aw)


# -- K11 plain versions: calculate_deps and masked_ts_max --------------------

@pytest.mark.parametrize("seed", [0, 5, 9])
@pytest.mark.parametrize("pruned", [False, True])
def test_calculate_deps_plain_equals_reference(seed, pruned):
    inp = _inputs(seed)
    m = inp["m"]
    rt = _ref_nt("table", inp["table"])
    rq = rdk.query_from_qmat(jnp.asarray(inp["qmat"]), m)
    pt = _port_nt("table", inp["table"])
    pq = pdk.query_from_qmat(torch.from_numpy(inp["qmat"]), m)
    prune = inp["prune"] if pruned else None
    if pruned:
        want_mask, want = rdk.calculate_deps(rt, rq, *_prunes(prune))
    else:
        want_mask, want = rdk.calculate_deps(rt, rq)
    got_mask, got = pdk.calculate_deps(pt, pq, prune)
    _eq(want_mask, got_mask)
    for w, g in zip(want, got):
        _eq(w, g)


@pytest.mark.parametrize("seed", [1, 2])
def test_masked_ts_max_equals_reference(seed):
    rng = np.random.default_rng(seed)
    msb = rng.choice(WORDS, (12, 9)).astype(np.int64)
    lsb = rng.choice(WORDS, (12, 9)).astype(np.int64)
    node = rng.integers(-2, 3, (12, 9)).astype(np.int32)
    mask = rng.random((12, 9)) < 0.4
    mask[3] = False                                   # an empty row
    want = rpk.masked_ts_max(jnp.asarray(msb), jnp.asarray(lsb),
                             jnp.asarray(node), jnp.asarray(mask))
    got = ppk.masked_ts_max(*(torch.from_numpy(a)
                              for a in (msb, lsb, node, mask)))
    for w, g in zip(want, got):
        _eq(w, g)


# -- placement ---------------------------------------------------------------

def test_mesh_and_placement(meshes):
    _rm, pm = meshes
    assert pm.size == D and pm.shape == {psh.STORE_AXIS: D}
    assert list(pm.groups()) == [torch.device("cpu")]
    inp = _inputs(4)
    pt = _port_nt("table", inp["table"])
    st = psh.shard_table(pm, pt)
    for col, sh in zip(pt, st):
        assert len(sh) == D
        torch.testing.assert_close(torch.cat(list(sh)), col, rtol=0, atol=0)
        # row views of the one tensor: no bytes moved
        assert sh[1].data_ptr() == col[col.shape[0] // D:].data_ptr()
    bt = psh.shard_bucket_table(pm, _port_nt("buckets", inp["buckets"]))
    assert all(len(c) == D for c in bt)
    again = psh.assemble_slices(pm, st.lo, pt.lo.shape, two_d=True)
    assert again == st.lo
    with pytest.raises(ValueError):
        psh.assemble_slices(pm, st.lo, pt.lo.shape)


# -- slot-sharded deps ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 6])
def test_sharded_calculate_deps_equals_reference(meshes, seed):
    rm, pm = meshes
    inp = _inputs(seed)
    m = inp["m"]
    rt = rsh.shard_table(rm, _ref_nt("table", inp["table"]))
    rq = rdk.query_from_qmat(jnp.asarray(inp["qmat"]), m)
    pt = psh.shard_table(pm, _port_nt("table", inp["table"]))
    pq = pdk.query_from_qmat(torch.from_numpy(inp["qmat"]), m)
    for prune in (None, inp["prune"]):
        if prune is None:
            want_mask, want = rsh.sharded_calculate_deps(rm)(rt, rq)
            got_mask, got = psh.sharded_calculate_deps(pm)(pt, pq)
        else:
            want_mask, want = rsh.sharded_calculate_deps(rm)(
                rt, rq, *_prunes(prune))
            got_mask, got = psh.sharded_calculate_deps(pm)(pt, pq, *prune)
        _eq(want_mask, _cat(got_mask))
        for w, g in zip(want, got):
            _eq(w, g)


@pytest.mark.parametrize("case", ["ragged", "B1", "dead slice"])
def test_sharded_calculate_deps_ragged_equals_reference(meshes, case):
    """The sharded scan over slices of unequal capacity (some empty), one
    query, and a slice whose every slot is dead: the slices' masks side
    by side and the max-conflict equal the reference's calculate_deps over
    the whole table, with and without the prune floor."""
    _rm, pm = meshes
    caps = {"ragged": [17, 0, 5, 30, 1, 0, 9, 2],
            "B1": [8] * D, "dead slice": [10, 6, 12, 8, 4, 8, 8, 8]}[case]
    inp = _inputs(40 + len(case), n=sum(caps), b=1 if case == "B1" else 8)
    m = inp["m"]
    cols = [c.copy() for c in inp["table"]]
    if case == "dead slice":
        dead = slice(caps[0], caps[0] + caps[1])
        cols[4][dead] = np.where(np.arange(caps[1]) % 2, -1, 6)
    rt = _ref_nt("table", cols)
    rq = rdk.query_from_qmat(jnp.asarray(inp["qmat"]), m)
    whole = _port_nt("table", cols)
    cuts = np.cumsum([0] + caps)
    pt = pdk.DepsTable(*(tuple(c[a:b] for a, b in zip(cuts, cuts[1:]))
                         for c in whole))
    pq = pdk.query_from_qmat(torch.from_numpy(inp["qmat"]), m)
    for prune in (None, inp["prune"]):
        if prune is None:
            want_mask, want = rdk.calculate_deps(rt, rq)
            got_mask, got = psh.sharded_calculate_deps(pm)(pt, pq)
        else:
            want_mask, want = rdk.calculate_deps(rt, rq, *_prunes(prune))
            got_mask, got = psh.sharded_calculate_deps(pm)(pt, pq, *prune)
        assert [g.shape[1] for g in got_mask] == caps
        _eq(want_mask, _cat(got_mask))
        for w, g in zip(want, got):
            _eq(w, g)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("pruned", [False, True])
def test_sharded_flat_equals_reference(meshes, seed, pruned):
    rm, pm = meshes
    inp = _inputs(seed)
    m = inp["m"]
    rt = rsh.shard_table(rm, _ref_nt("table", inp["table"]))
    pt = psh.shard_table(pm, _port_nt("table", inp["table"]))
    qmat = inp["qmat"]
    for s, k in ((256, 32), (12, 3)):
        if pruned:
            want = rsh.sharded_calculate_deps_flat_pruned(rm, m, s, k)(
                rt, jnp.asarray(qmat), *_prunes(inp["prune"]))
            got = psh.sharded_calculate_deps_flat_pruned(pm, m, s, k)(
                pt, torch.from_numpy(qmat), *inp["prune"])
        else:
            want = rsh.sharded_calculate_deps_flat(rm, m, s, k)(
                rt, jnp.asarray(qmat))
            got = psh.sharded_calculate_deps_flat(pm, m, s, k)(
                pt, torch.from_numpy(qmat))
        _eq(want[0], got[0])
        _eq(want[1], got[1])


@pytest.mark.parametrize("seed", [1, 7])
def test_sharded_bucketed_flat_equals_reference(meshes, seed):
    rm, pm = meshes
    inp = _inputs(seed)
    m, m_t = inp["m"], inp["m_t"]
    rb = rsh.shard_bucket_table(rm, _ref_nt("buckets", inp["buckets"]))
    pb = psh.shard_bucket_table(pm, _port_nt("buckets", inp["buckets"]))
    qmat = inp["qmat_b"]
    for s, k, keff in ((512, 64, None), (20, 3, 9)):
        want = rsh.sharded_bucketed_flat(rm, m, 4, s, k, m_t, keff)(
            rb, jnp.asarray(qmat), *_prunes(inp["prune"]))
        got = psh.sharded_bucketed_flat(pm, m, 4, s, k, m_t, keff)(
            pb, torch.from_numpy(qmat), *inp["prune"])
        _eq(want[0], got[0])
        _eq(want[1], got[1])


def _fused_group(seed, caps=((64, 4), (32, 2), (128, 4))):
    stores = [_inputs(seed * 10 + i, n=n, m_t=m_t)
              for i, (n, m_t) in enumerate(caps)]
    qmats = np.stack([s["qmat"] for s in stores])
    rankbs = np.stack([s["rankb"] for s in stores])
    prunes = tuple(np.array([s["prune"][c] for s in stores],
                            np.int32 if c == 2 else np.int64)
                   for c in range(3))
    return stores, qmats, rankbs, prunes


def test_sharded_fused_flat_equals_reference(meshes):
    rm, pm = meshes
    stores, qmats, _rankbs, prunes = _fused_group(2)
    s, k = 256, 32
    rts = [rsh.shard_table(rm, _ref_nt("table", st["table"]))
           for st in stores]
    pts = [psh.shard_table(pm, _port_nt("table", st["table"]))
           for st in stores]
    want = rsh.sharded_fused_flat(rm, len(stores), 4, s, k)(
        *rts, jnp.asarray(qmats), *(jnp.asarray(p) for p in prunes))
    got = psh.sharded_fused_flat(pm, len(stores), 4, s, k)(
        *pts, torch.from_numpy(qmats), *(torch.from_numpy(p) for p in prunes))
    _eq(want[0], got[0])
    _eq(want[1], got[1])


# -- K12: the cross-shard merge ------------------------------------------------

def _blocks(seed, b=6, s=24, codespace=4096, dup=False, holes=False):
    """d attributed shard blocks: ascending codes per row, some rows
    empty, one overflowed shard header; ``dup`` repeats codes across
    shards and within (row, slot, col) runs (the bucketed form);
    ``holes``: every block overflowed, with -1 holes inside its rows as
    an overflowed attribution leaves them (the first entry of row 0
    among them in block 0)."""
    rng = np.random.default_rng(seed)
    hdrs = np.zeros((D, 5 + b), np.int32)
    ents = np.full((D, s), -1, np.int32)
    pool = rng.integers(0, codespace, 12)
    for i in range(D):
        counts = rng.integers(0, 5, b)
        counts[rng.integers(0, b)] = 0
        while counts.sum() > s:
            counts[np.argmax(counts)] -= 1
        row_end = np.cumsum(counts)
        pos = 0
        for r in range(b):
            src = pool if dup else rng.integers(0, codespace, 40)
            codes = np.sort(rng.choice(src, counts[r], replace=not dup
                                       or counts[r] > len(src)))
            if not dup:
                codes = np.sort(rng.choice(codespace, counts[r],
                                           replace=False))
            ents[i, pos:pos + counts[r]] = codes
            pos += counts[r]
        hdrs[i, 0] = row_end[-1]
        hdrs[i, 1] = row_end[-1] + rng.integers(0, 3)
        hdrs[i, 2] = counts.max() + rng.integers(0, 2)
        hdrs[i, 3] = rng.integers(0, 4)
        hdrs[i, 4] = rng.integers(0, 4)
        hdrs[i, 5:] = row_end
    if holes:
        hr = np.random.default_rng(seed + 1000)
        for i in range(D):
            live = int(hdrs[i, 0])
            at = hr.choice(live, min(live, 3), replace=False)
            ents[i, at] = -1
            hdrs[i, 1] = s + 1 + hr.integers(0, 5)
        ents[0, 0] = -1
    return hdrs, ents


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_flat_equals_reference(seed):
    hdrs, ents = _blocks(seed)
    want = rsh._merge_shard_blocks(jnp.asarray(hdrs), jnp.asarray(ents), 6,
                                   24, 4096, 0)
    got = psh.merge_shard_blocks_plain(torch.from_numpy(hdrs),
                                       torch.from_numpy(ents), 6, 24, 4096, 0)
    _eq(want[0], got[0])
    _eq(want[1], got[1])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_merge_bucketed_dedupe_equals_reference(seed):
    m_t, m = 2, 4
    mq = m_t * m
    n = 4096 // mq
    hdrs, ents = _blocks(seed, dup=True)
    dom = np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)
    want = rsh._merge_shard_blocks(jnp.asarray(hdrs), jnp.asarray(ents), 6,
                                   24, n * mq, m, dom=jnp.asarray(dom),
                                   mq=mq)
    got = psh.merge_shard_blocks_plain(torch.from_numpy(hdrs),
                                       torch.from_numpy(ents), 6, 24,
                                       n * mq, m, torch.from_numpy(dom), mq)
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    # the merge dropped something: duplicates existed across shards
    assert int(got[0][0]) < int(hdrs[:, 0].sum())


def _descends(hdrs, ents, s=24, codespace=4096):
    """Whether some block's live (row, code) composites descend."""
    for h, e in zip(hdrs, ents):
        pos = np.arange(min(int(h[0]), s))
        comp = np.searchsorted(h[5:], pos, side="right") * codespace + e[pos]
        if (np.diff(comp) < 0).any():
            return True
    return False


@pytest.mark.parametrize("seed,dup", [(20, False), (21, False), (22, True),
                                      (23, True)])
def test_merge_overflowed_with_holes_equals_reference(seed, dup):
    """An overflowed merge (-1 holes inside the blocks' rows, so their
    composites are not ascending): the plain K12 and the port's merge
    entry on the CPU give the reference's header and entries."""
    m_t, m = 2, 4
    mq = m_t * m
    n = 4096 // mq
    cs = n * mq if dup else 4096
    hdrs, ents = _blocks(seed, dup=dup, holes=True)
    assert (hdrs[:, 1] > 24).all() and _descends(hdrs, ents, codespace=cs)
    dom = np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)
    key_m = m if dup else 0
    want = rsh._merge_shard_blocks(
        jnp.asarray(hdrs), jnp.asarray(ents), 6, 24, cs, key_m,
        dom=jnp.asarray(dom) if dup else None, mq=mq if dup else None)
    tdom = torch.from_numpy(dom) if dup else None
    got = psh.merge_shard_blocks_plain(
        torch.from_numpy(hdrs), torch.from_numpy(ents), 6, 24, cs, key_m,
        tdom, mq if dup else None)
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    blocks = [[(torch.from_numpy(h), torch.from_numpy(e), 0)
               for h, e in zip(hdrs, ents)]]
    hdr, out = kernels.merge_blocks(blocks, 6, 24, cs, key_m, tdom,
                                    mq if dup else None)
    _eq(want[0], hdr[0])
    _eq(want[1], out[0])


@pytest.mark.parametrize("n_s,dup,holes", [(3, False, False),
                                            (3, True, True),
                                            (17, False, True),
                                            (17, True, False)])
def test_merge_batched_equals_reference(n_s, dup, holes):
    """K12 over S stores in one call, as sharded_fused_attr batches it, on
    slot-sharded blocks (code offsets) and bucketed ones (dedupe), with and
    without overflowed blocks; 17 stores x 8 blocks is above the 128
    blocks a launch takes by value (the table upload path on the card).
    Each store's merge equals the reference's on its globalized codes."""
    m_t, m = 2, 4
    mq = m_t * m
    n = 4096 // mq
    cs = n * mq if dup else D * 4096
    dom = np.random.default_rng(n_s).integers(0, 2, n).astype(np.int32)
    key_m = m if dup else 0
    blocks, want = [], []
    for st in range(n_s):
        hdrs, ents = _blocks(40 + st, dup=dup, holes=holes)
        offs = [0 if dup else i * 4096 for i in range(D)]
        glob = np.where(ents >= 0, ents + np.array(offs)[:, None], ents)
        want.append(rsh._merge_shard_blocks(
            jnp.asarray(hdrs), jnp.asarray(glob.astype(np.int32)), 6, 24,
            cs, key_m, dom=jnp.asarray(dom) if dup else None,
            mq=mq if dup else None))
        blocks.append([(torch.from_numpy(h), torch.from_numpy(e), o)
                       for h, e, o in zip(hdrs, ents, offs)])
    assert (n_s * D > kernels.MERGE_MAX_REFS) == (n_s == 17)
    hdr, out = kernels.merge_blocks(blocks, 6, 24, cs, key_m,
                                    torch.from_numpy(dom) if dup else None,
                                    mq if dup else None)
    assert hdr.shape == (n_s, 11) and out.shape == (n_s, D * 24)
    for st, (wh, we) in enumerate(want):
        _eq(wh, hdr[st])
        _eq(we, out[st])


# -- the attributed mesh kernels (K1 + K2 per slice, then K12) ------------------

@pytest.mark.parametrize("seed", [7, 12])
@pytest.mark.parametrize("floors,elide", [(True, True), (False, False)])
def test_sharded_flat_attr_equals_reference(meshes, seed, floors, elide):
    rm, pm = meshes
    inp = _inputs(seed)
    m = inp["m"]
    rt = rsh.shard_table(rm, _ref_nt("table", inp["table"]))
    pt = psh.shard_table(pm, _port_nt("table", inp["table"]))
    ra = _ref_nt("attr", inp["attr"])
    pa = _port_nt("attr", inp["attr"])
    pa_sh = type(pa)(*(psh._split_rows(pm, c) for c in pa))
    ri, pi = _ref_nt("aidx", inp["aidx"]), _port_nt("aidx", inp["aidx"])
    for s, k in ((512, 64), (16, 3)):
        want = rsh.sharded_flat_attr(rm, m, s, k, False, floors, elide)(
            rt, ra, ri, jnp.asarray(inp["qmat"]), jnp.asarray(inp["rankb"]),
            *_prunes(inp["prune"]))
        got = psh.sharded_flat_attr(pm, m, s, k, False, floors, elide)(
            pt, pa_sh, pi, torch.from_numpy(inp["qmat"]),
            torch.from_numpy(inp["rankb"]), *inp["prune"])
        _eq(want[0], got[0])
        _eq(want[1], got[1])


@pytest.mark.parametrize("seed", [7, 13])
def test_sharded_bucketed_attr_equals_reference(meshes, seed):
    rm, pm = meshes
    inp = _inputs(seed)
    m, m_t = inp["m"], inp["m_t"]
    rb = rsh.shard_bucket_table(rm, _ref_nt("buckets", inp["buckets"]))
    pb = psh.shard_bucket_table(pm, _port_nt("buckets", inp["buckets"]))
    rt = rsh.shard_table(rm, _ref_nt("table", inp["table"]))
    pt = psh.shard_table(pm, _port_nt("table", inp["table"]))
    ra, pa = _ref_nt("attr", inp["attr"]), _port_nt("attr", inp["attr"])
    ri, pi = _ref_nt("aidx", inp["aidx"]), _port_nt("aidx", inp["aidx"])
    for s, k, keff in ((512, 64, None), (24, 4, 12)):
        want = rsh.sharded_bucketed_attr(rm, m, 4, s, k, m_t, keff or 16)(
            rb, rt, ra, ri, jnp.asarray(inp["qmat_b"]),
            jnp.asarray(inp["rankb"]), *_prunes(inp["prune"]))
        got = psh.sharded_bucketed_attr(pm, m, 4, s, k, m_t, keff or 16)(
            pb, pt, pa, pi, torch.from_numpy(inp["qmat_b"]),
            torch.from_numpy(inp["rankb"]), *inp["prune"])
        _eq(want[0], got[0])
        _eq(want[1], got[1])


def test_attr_tok_plain_matches_whole_table_gather(meshes):
    """Each slice contributes the tokens of the slots it owns; the terms
    sum to the single-table gather lo[slot, col] (0 for code < 0)."""
    _rm, pm = meshes
    inp = _inputs(3)
    m, m_t = inp["m"], inp["m_t"]
    pt = _port_nt("table", inp["table"])
    st = psh.shard_table(pm, pt)
    rng = np.random.default_rng(3)
    ents = [torch.from_numpy(rng.integers(-1, 64 * m_t * m, 20)
                             .astype(np.int32)) for _ in range(D)]
    tok = psh.attr_tok_plain(ents, list(st.lo), 64 // D, m_t, m)
    code = torch.stack(ents).to(torch.int64)
    slot = torch.clamp(code // (m_t * m), min=0)
    col = torch.clamp(code % (m_t * m) // m, 0, m_t - 1)
    want = torch.where(code >= 0, pt.lo[slot, col], torch.zeros_like(code))
    torch.testing.assert_close(tok, want, rtol=0, atol=0)


def _ref_tok(rm, table, codes, m_t, m):
    """The reference's token (``accord_tpu/parallel/sharded.py:566-576``):
    each slice's terms for the slots it owns, summed by ``lax.psum``
    over the JAX mesh, on the all-gathered codes [d, s]."""
    from jax import lax
    from jax.sharding import PartitionSpec as P
    rt = rsh.shard_table(rm, _ref_nt("table", table))

    def local(lo, ents_all):
        n_local = lo.shape[0]
        soff = lax.axis_index(rsh.STORE_AXIS).astype(jnp.int64) * n_local
        code = ents_all.astype(jnp.int64)
        mq = m_t * m
        slot = jnp.clip(code // mq, 0)
        col = jnp.clip(code % mq // m, 0, m_t - 1)
        mine = (slot >= soff) & (slot < soff + n_local) & (code >= 0)
        lslot = jnp.clip(slot - soff, 0, n_local - 1)
        return lax.psum(jnp.where(mine, lo[lslot, col], 0), rsh.STORE_AXIS)

    fn = jax.jit(rsh._shard_map(local, rm, (P(rsh.STORE_AXIS, None), P()),
                                P()))
    return np.asarray(fn(rt.lo, jnp.asarray(codes)))


@pytest.mark.parametrize("wide", [False, True])
def test_attr_tok_plain_equals_reference_psum(meshes, wide):
    """The port's token terms of two device groups (slices 0-2 on one,
    3-7 on the other; a slice elsewhere is None) sum to the reference's
    psum, byte-equal, on int32 and int64 (wide) codes with -1 holes,
    negative codes whose floor division and modulo differ from C's, and
    codes past the last slice."""
    rm, pm = meshes
    inp = _inputs(3)
    m, m_t = inp["m"], inp["m_t"]
    st = psh.shard_table(pm, _port_nt("table", inp["table"]))
    sn = st.lo[0].shape[0]
    mq = m_t * m
    rng = np.random.default_rng(40 + wide)
    codes = rng.integers(-3 * mq, (D * sn + 2) * mq, (D, 48))
    codes[:, :4] = [-1, -mq - 1, -(1 << 40) - 3 if wide else -(1 << 31),
                    D * sn * mq + 1]
    codes = codes.astype(np.int64 if wide else np.int32)
    want = _ref_tok(rm, inp["table"], codes, m_t, m)
    ents = [torch.from_numpy(c) for c in codes]
    tok = sum(psh.attr_tok_plain(
        ents, [st.lo[o] if o in grp else None for o in range(D)], sn, m_t, m)
        for grp in (range(0, 3), range(3, D)))
    assert tok.dtype == torch.int64
    np.testing.assert_array_equal(tok.numpy(), want)


def test_sharded_fused_attr_equals_reference(meshes):
    rm, pm = meshes
    stores, qmats, rankbs, prunes = _fused_group(4)
    s, k = 512, 64
    rts = [rsh.shard_table(rm, _ref_nt("table", st["table"]))
           for st in stores]
    pts = [psh.shard_table(pm, _port_nt("table", st["table"]))
           for st in stores]
    ras = [_ref_nt("attr", st["attr"]) for st in stores]
    pas = []
    for st in stores:
        pa = _port_nt("attr", st["attr"])
        pas.append(type(pa)(*(psh._split_rows(pm, c) for c in pa)))
    ris = [_ref_nt("aidx", st["aidx"]) for st in stores]
    pis = [_port_nt("aidx", st["aidx"]) for st in stores]
    want = rsh.sharded_fused_attr(rm, len(stores), 4, s, k)(
        *rts, *ras, *ris, jnp.asarray(qmats), jnp.asarray(rankbs),
        *(jnp.asarray(p) for p in prunes))
    got = psh.sharded_fused_attr(pm, len(stores), 4, s, k)(
        *pts, *pas, *pis, torch.from_numpy(qmats), torch.from_numpy(rankbs),
        *(torch.from_numpy(p) for p in prunes))
    _eq(want[0], got[0])
    _eq(want[1], got[1])


# -- K13: the row-sharded frontier and drain -----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_frontier_and_drain_equal_reference(meshes, seed):
    rm, pm = meshes
    cols = _drain_cols(seed, 64)
    rs = _ref_nt("drain", cols)
    ps = _port_nt("drain", cols)
    _eq(rsh.sharded_ready_frontier(rm)(rs), psh.sharded_ready_frontier(pm)(ps))
    want = rsh.sharded_drain(rm)(rs)
    got = psh.sharded_drain(pm)(ps)
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    # the per-sweep loop that a mesh across devices takes
    by_sweeps = psh.drain_by_sweeps(pm, ps)
    _eq(want[0], by_sweeps[0])
    _eq(want[1], by_sweeps[1])
    # and the port's single-device K8 oracle agrees
    _eq(got[0], pdrk.drain(ps)[0])


def _drain_edge_cases(seed, n):
    """_drain_cols with a gating cycle between two Stable rows, a Stable
    row on an undecided dep, and one on an invalidated and a free
    column."""
    adj, status, em, el, en, aw = _drain_cols(seed, n)
    status[[3, 10, 5, 7]] = 4
    adj[3, 10] = adj[10, 3] = True
    aw[[3, 10]] = True
    status[20], adj[5, 20] = 1, True
    status[30], status[31] = 6, -1
    adj[7, [30, 31]] = True
    return (adj, status, em, el, en, aw)


@pytest.mark.parametrize("seed,n", [
    (3, 64), (4, 72), (5, 200),
    ("handover_below", 4 * HANDOVER), ("handover_at", 4 * HANDOVER),
    ("handover_above", 4 * HANDOVER), ("handover_later", 4 * HANDOVER)])
def test_sharded_drain_one_launch_equals_reference(meshes, seed, n):
    """sharded_drain through the one-launch entry's plain path (every
    slice on one device) against the reference on its 8 devices, at N
    not a multiple of the 32-bit words too, and on K8's handover graphs
    (a first level either side of the frontier form's handover, and a
    wide level after it) sliced 8 ways; the entry's sweep count is the
    single-device fixpoint's."""
    rm, pm = meshes
    edge = not isinstance(seed, str)
    cols = _drain_edge_cases(seed, n) if edge else K8_GRAPHS[seed]()
    assert cols[0].shape == (n, n)
    rs = _ref_nt("drain", cols)
    ps = _port_nt("drain", cols)
    assert len(pm.groups()) == 1
    want = rsh.sharded_drain(rm)(rs)
    got = psh.sharded_drain(pm)(ps)
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    if edge:   # the cycle and the undecided dep stay unapplied
        assert not got[0][[3, 10, 5]].any()
    by_sweeps = psh.drain_by_sweeps(pm, ps)
    _eq(want[0], by_sweeps[0])
    _eq(want[1], by_sweeps[1])
    slices = psh._sharded_rows(pm, ps)
    n_l = n // D
    outs = [torch.empty(n_l, dtype=torch.bool) for _ in slices]
    sweeps = kernels.sharded_drain_fix(
        [(*sl, None, outs[i], i) for i, sl in enumerate(slices)],
        psh._cols_on(pm.dev0, slices), n_l, n)
    _eq(got[0], torch.cat(outs))
    assert int(sweeps[0]) == int(pdrk._drain_fix_plain(ps)[2])


def test_sharded_protocol_step_equals_reference(meshes):
    rm, pm = meshes
    inp = _inputs(11)
    cols = _drain_cols(11, 64)
    rq = rdk.query_from_qmat(jnp.asarray(inp["qmat"]), inp["m"])
    pq = pdk.query_from_qmat(torch.from_numpy(inp["qmat"]), inp["m"])
    want = rsh.sharded_protocol_step(rm)(
        rsh.shard_table(rm, _ref_nt("table", inp["table"])), rq,
        _ref_nt("drain", cols))
    got = psh.sharded_protocol_step(pm)(
        psh.shard_table(pm, _port_nt("table", inp["table"])), pq,
        _port_nt("drain", cols))
    _eq(want[0], _cat(got[0]))
    for w, g in zip(want[1], got[1]):
        _eq(w, g)
    _eq(want[2], got[2])
    _eq(want[3], got[3])


# -- the reference's own mesh cases (tests/test_parallel.py:27-200) -----------

def _rs_entries(seed, n):
    from accord_tpu_torch.primitives.keys import Range
    from accord_tpu_torch.primitives.timestamp import Domain, TxnId, TxnKind
    from accord_tpu_torch.utils.random_source import RandomSource
    rs = RandomSource(seed)
    kinds = [TxnKind.Write, TxnKind.Read]

    def tid(hlc):
        return TxnId.create(1, hlc, rs.pick(kinds), Domain.Key,
                            rs.next_int(4))

    entries = []
    for _ in range(n):
        toks = [rs.next_int(12) for _ in range(rs.next_int(3) + 1)]
        rngs = [Range(2, 5)] if rs.next_int(4) == 0 else []
        entries.append((tid(rs.next_int(10_000) + 1),
                        rs.pick([pdk.SLOT_PREACCEPTED, pdk.SLOT_COMMITTED,
                                 pdk.SLOT_STABLE, pdk.SLOT_APPLIED,
                                 pdk.SLOT_INVALIDATED, pdk.SLOT_TRANSITIVE]),
                        toks, rngs))
    return rs, tid, entries


def test_port_sharded_deps_matches_unsharded(meshes):
    _rm, pm = meshes
    rs, tid, entries = _rs_entries(17, 50)
    table = pdk.build_table(entries, capacity=64, max_intervals=6,
                            device="cpu")
    queries = []
    for _ in range(8):
        bound = tid(rs.next_int(12_000) + 1)
        queries.append((bound, bound.kind().witnesses(),
                        [rs.next_int(12) for _ in range(2)], []))
    q = pdk.build_query(queries, max_intervals=6, device="cpu")
    want_mask, want = pdk.calculate_deps(table, q)
    got_mask, got = psh.sharded_calculate_deps(pm)(psh.shard_table(pm, table),
                                                   q)
    _eq(want_mask, _cat(got_mask))
    for w, g in zip(want, got):
        _eq(w, g)
    assert bool(want_mask.any())


def test_live_protocol_uses_mesh_sharded_scan(meshes):
    """With the device route pinned, EVERY live deps scan of a device-mode
    sim cluster on the 8-slice mesh goes through the sharded kernels."""
    _rm, pm = meshes
    from accord_tpu_torch.sim.cluster import Cluster
    from accord_tpu_torch.sim.kvstore import KVDataStore, kv_txn
    from accord_tpu_torch.sim.topology_factory import build_topology
    cluster = Cluster(topology=build_topology(1, (1, 2, 3), 3, 4), seed=9,
                      data_store_factory=KVDataStore, device_mode=True,
                      device="cpu", mesh=pm)
    for node in cluster.nodes.values():
        for s in node.command_stores.stores:
            s.device.route_override = "device"
    out = []
    for i in range(8):
        cluster.nodes[1 + (i % 3)].coordinate(
            kv_txn([i * 10], {i * 10: (f"v{i}",)})).begin(
            lambda r, f: out.append((r, f)))
        cluster.run_until_quiescent()
    assert all(f is None for _r, f in out)
    total = mesh = 0
    for node in cluster.nodes.values():
        for s in node.command_stores.stores:
            total += s.device.n_queries
            mesh += s.device.n_mesh_queries
    assert total > 0 and mesh == total, (mesh, total)


@pytest.mark.parametrize("hatch", [None, "fixpoint"])
def test_mesh_tick_drains_like_the_single_device_tick(meshes, monkeypatch,
                                                      hatch):
    """A store with the mesh on, its tick priced to the mesh: every drain
    tick row-shards its frontier sweep (mode "mesh"; a mesh tick keeps
    the wavefront at W=1, as the reference's does) and the chain applies
    in the order it applies on one device."""
    import chip_smoke as cs
    _rm, pm = meshes
    if hatch is None:
        monkeypatch.delenv("ACCORD_TPU_DRAIN", raising=False)
    else:
        monkeypatch.setenv("ACCORD_TPU_DRAIN", hatch)
    cs.P.load()
    runs = {}
    for mesh in (None, pm):
        store, ds, ids = cs.chain_store(24, "cpu", mesh=mesh)
        if mesh is not None:
            ds._mesh_tick_pays = lambda _n: True
        store.apply = True
        while store.due:
            store.run_ticks()
        assert store.applied == ids
        runs[mesh is None] = (store.applied, [m for m, _n in store.ticks],
                              ds._drain_wavefront)
    assert runs[True][0] == runs[False][0]
    assert set(runs[False][1]) == {"mesh"} and runs[False][2] == 1
    assert len(runs[False][1]) >= 24
    assert "mesh" not in runs[True][1]
