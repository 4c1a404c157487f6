"""The port's fused multi-store kernels against the JAX package's.

K5: ``fused_flat_csr`` and ``fused_flat_attr`` on seeded groups of three
stores with unequal capacities, interval widths and attribution indexes
(the reference pads and stacks inside its jitted program; the port reads
each store where it lies and pads by rule).  Floors and elision each on
and off, one case with int64 codes, one that overflows s and k.  Each
store's block also decodes to the port's own solo answer for that store.

K6: ``fused_ready_frontier`` / ``fused_ready_frontier_ell`` on unequal
drain states; each row's live prefix is the store's solo frontier.

CPU only: the port takes its plain versions here; tolerance zero (every
output is integer or boolean)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.ops import deps_kernel as rdk
from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu_torch.ops import convert
from accord_tpu_torch.ops import deps_kernel as pdk
from accord_tpu_torch.ops import drain_kernel as pdrk
from tests.test_torch_deps_kernel import _inputs

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
    assert port[0].shape == (3, 2 + 8)


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
    shapes = ((16, 4), (40, 8), (24, 4))
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
    assert port_d.shape == port_e.shape == (3, 40)
    for i, ((n, _d), st) in enumerate(zip(shapes, sts)):
        np.testing.assert_array_equal(
            port_d[i, :n].numpy(), pdrk.ready_frontier(st["drain"]).numpy())
        np.testing.assert_array_equal(
            port_e[i, :n].numpy(),
            pdrk.ready_frontier_ell(st["ell"]).numpy())
        assert not port_e[i, n:].any()
