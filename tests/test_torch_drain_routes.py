"""The port's routed drains and their kernels (the fixpoint oracles, the
log-depth and watermark drains, log-squaring, dense -> ELL) against the JAX
package's, byte for byte, counts included.

Inputs are made with numpy from seeds and handed to both packages: the
``tests/test_drain_logdepth.py`` generator's drain graphs (undecided deps,
invalidated and free slots, executeAt ties, awaits_all cycles), and bench
config 3's hot-key store and drain legs scaled down (``bench.py:183-238``,
``:427-502``).  The router is held to the reference by injecting one
calibration into both packages.  The reference runs on its single-device
path (``ACCORD_TPU_STORE_SHARD=off``, ``dev.mesh = None``).  CPU only: the
port takes its plain versions here; tolerance zero (bools and integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accord_tpu
import accord_tpu_torch
from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu.utils import faults as rfaults
from accord_tpu.utils.random_source import RandomSource as RRandom
from accord_tpu_torch.ops import _build, convert
from accord_tpu_torch.ops import drain_kernel as pdrk
from accord_tpu_torch.utils import faults as pfaults
from accord_tpu_torch.utils.random_source import RandomSource as PRandom
from tests.test_torch_level_assign import (APPLIED, COMMITTED, D_PAD, FREE,
                                           INVALIDATED, N_PAD, STABLE,
                                           STATUSES, _arrays, chain_case,
                                           make_case)


@pytest.fixture(autouse=True)
def _routing(monkeypatch):
    """Both routers start from no learned stats and are left with their
    calibration as found."""
    monkeypatch.delenv("ACCORD_TPU_DRAIN", raising=False)
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")
    saved = (rdrk._DRAIN_CALIB, pdrk._DRAIN_CALIB)
    rdrk.reset_drain_routing()
    pdrk.reset_drain_routing()
    yield
    rdrk._DRAIN_CALIB, pdrk._DRAIN_CALIB = saved
    rdrk.reset_drain_routing()
    pdrk.reset_drain_routing()


def _states(dense, ell):
    ref = (rdrk.DrainState(*map(jnp.asarray, dense)),
           rdrk.EllDrainState(*map(jnp.asarray, ell)))
    st = convert.tables_from_numpy({"drain": dense, "ell": ell}, "cpu")
    return ref, (st["drain"], st["ell"])


def _eq(ref, port):
    """Tuples of arrays / tensors / ints equal, dtypes of arrays too."""
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        if isinstance(p, (int, str)):
            assert (int(r) if isinstance(p, int) else r) == p
            continue
        r = np.asarray(r)
        p = p.numpy()
        assert r.dtype == p.dtype and r.shape == p.shape
        np.testing.assert_array_equal(r, p)


def _check_case(ref, port, n):
    (rd, re), (pd, pe) = ref, port
    _eq(rdrk.drain_levels(rd), pdrk.drain_levels(pd))
    _eq(rdrk.drain_ell_levels(re), pdrk.drain_ell_levels(pe))
    _eq(rdrk.drain(rd), pdrk.drain(pd))
    _eq(rdrk.drain_ell(re), pdrk.drain_ell(pe))
    _eq(rdrk._drain_ell_logdepth_full(re), pdrk._drain_ell_logdepth_full(pe))
    _eq(rdrk._drain_dense_logdepth_full(rd),
        pdrk._drain_dense_logdepth_full(pd))
    _eq(rdrk.drain_ell_logdepth(re), pdrk.drain_ell_logdepth(pe))
    _eq(rdrk.drain_logdepth(rd), pdrk.drain_logdepth(pd))
    for w in (0, 1, 2, n):
        _eq(rdrk.drain_ell_watermark(re, w), pdrk.drain_ell_watermark(pe, w))
        _eq(rdrk.drain_dense_watermark(rd, w),
            pdrk.drain_dense_watermark(pd, torch.tensor(w)))
    _eq(rdrk.drain_dense_logsq(rd), pdrk.drain_dense_logsq(pd))
    # the reference's degree is int64 under JAX's x64 mode: compare values
    assert int(rdrk._dense_degree(rd.adj)) == int(pdrk._dense_degree(pd.adj))
    for md in (None, 1):
        _eq((rdrk.dense_to_ell(rd, md).adj_idx,),
            (pdrk.dense_to_ell(pd, md).adj_idx,))
    # every route agrees with the oracle
    applied, newly, _ = pdrk.drain_levels(pd)
    for got in (pdrk.drain_ell_levels(pe), pdrk.drain_ell_logdepth(pe),
                pdrk.drain_logdepth(pd), pdrk.drain_dense_logsq(pd)):
        assert torch.equal(got[0], applied) and torch.equal(got[1], newly)


@pytest.mark.parametrize("seed", range(10))
def test_drains_equal_reference(seed):
    """Three seeded cases a seed, each padded to one shape (pad rows FREE,
    pad edges -1), so each package runs every function at one shape."""
    rng = np.random.default_rng(9100 + seed)
    for _ in range(3):
        case = make_case(rng)
        ref, port = _states(*_arrays(case, N_PAD, D_PAD))
        _check_case(ref, port, case["n"])


def test_drains_equal_reference_unpadded():
    """One case at its own shape, ELL width from ``dense_to_ell``."""
    case = make_case(np.random.default_rng(9200))
    n = case["n"]
    dense, _ell = _arrays(case, n, D_PAD)
    ell = (np.asarray(rdrk.dense_to_ell(
        rdrk.DrainState(*map(jnp.asarray, dense))).adj_idx),) + dense[1:]
    ref, port = _states(dense, ell)
    _check_case(ref, port, n)


def test_chain_counts():
    """A 64-row chain behind an applied head: 64 fixpoint sweeps (63
    antichains and the empty one), logarithmic rounds, and the reference's
    squarings."""
    ref, port = _states(*_arrays(chain_case(64), 64, 4))
    _check_case(ref, port, 64)
    assert int(pdrk.drain_levels(port[0])[2]) == 64
    assert int(pdrk.drain_ell_logdepth(port[1])[2]) <= 2 * 6 + 4


def _logsq_case(rng, n):
    """make_case's distribution at ``n`` rows, plus (n >= 3) a gating
    cycle between two Stable rows that await all, and a Stable row on an
    undecided dep."""
    case = make_case(rng)
    edges = set()
    for i in range(1, n):
        for _ in range(int(rng.integers(0, 4))):
            edges.add((i, int(rng.integers(0, i))))
    for _ in range(3):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a != b:
            edges.add((a, b))
    status = [STATUSES[int(i)] for i in rng.integers(0, len(STATUSES), n)]
    awaits = [bool(x) for x in rng.random(n) < 0.15]
    if n >= 3:
        edges |= {(n - 1, n - 2), (n - 2, n - 1), (n - 3, 0)}
        status[n - 1] = status[n - 2] = status[n - 3] = STABLE
        status[0] = 1                       # undecided
        awaits[n - 1] = awaits[n - 2] = True
    case.update(n=n, edges=sorted(edges), status=status, awaits=awaits,
                msb=[int(x) for x in rng.integers(0, 6, n)],
                node=[int(x) for x in rng.integers(1, 3, n)])
    return case


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 211])
def test_logsq_equals_reference_at_tile_edges(n):
    """K9's plain version at the sizes around its kernel's tiling (one
    row, either side of a 32-bit word and of a 128-row tile, a prime)
    against the reference's drain_dense_logsq, squarings included."""
    case = _logsq_case(np.random.default_rng(9300 + n), n)
    (rd, _re), (pd, _pe) = _states(*_arrays(case, n, 8))
    want = rdrk.drain_dense_logsq(rd)
    got = pdrk.drain_dense_logsq(pd)
    _eq(want, got)
    if n >= 3:   # the cycle and the row behind the undecided dep wait
        assert not got[0][[n - 1, n - 2, n - 3]].any()


# -- K8 dense's frontier form, in plain arithmetic ------------------------------
#
# csrc/drain_frontier.cuh ``frontier_kernel`` with its tile loader (K8
# dense, and K13 on slices) does not sweep every row: it counts each
# Stable row's gating deps not applied at the start, and each
# level decrements the counts of the Stable rows that the level's rows
# gate (the transposed words); a row whose count reaches 0 joins the next
# level, in whatever order the atomics leave it.  The grid works on a
# level that holds more than HANDOVER rows (ops/_build.py GEOMETRY, which
# the kernel is built with), the first CTA alone on one that holds fewer,
# handing a wider level back to the grid.  This model follows those steps
# and is held to the reference's drain_levels, sweeps included.

HANDOVER = _build.GEOMETRY["ACCORD_DRAIN_HANDOVER"]


def _frontier_drain_model(dense, rng):
    """((applied, newly, sweeps), [(mode, level size), ...])."""
    adj, status, msb, lsb, node, awaits = dense
    # drain_gates: exec(j) < exec(i) in the unsigned 128-bit order, the
    # node id signed; undecided deps and awaits_all rows always gate
    um, ul = msb.view(np.uint64), lsb.view(np.uint64)
    before = ((um[None, :] < um[:, None])
              | ((um[None, :] == um[:, None])
                 & ((ul[None, :] < ul[:, None])
                    | ((ul[None, :] == ul[:, None])
                       & (node[None, :] < node[:, None])))))
    dead = (status == INVALIDATED) | (status == FREE)
    undecided = (status >= 0) & (status < COMMITTED)
    blk = adj & ~dead[None, :] & (undecided[None, :] | awaits[:, None]
                                  | before)
    stable, app0 = status == STABLE, status == APPLIED
    blk_t = (blk & stable[:, None]).T     # dep j -> the Stable rows it gates
    cnt = np.where(stable, (blk & ~app0[None, :]).sum(axis=1), -1)
    level = [int(i) for i in np.nonzero(stable & (cnt == 0))[0]]
    modes = []
    while level:
        modes.append(("block" if len(level) <= HANDOVER else "grid",
                      len(level)))
        nxt = []
        for j in rng.permutation(level):
            for i in np.nonzero(blk_t[j])[0]:
                cnt[i] -= 1
                if cnt[i] == 0:
                    nxt.append(int(i))
        level = nxt
    newly = stable & (cnt == 0)
    return (app0 | newly, newly, np.int32(len(modes) + 1)), modes


def _levels_graph(sizes, n_pad, seed, deg=3):
    """Stable rows in antichains of ``sizes`` rows, scattered over
    ``n_pad`` slots (the rest FREE): a row of antichain l > 0 waits on 1 to
    ``deg`` rows of antichain l - 1, executeAt ascending by antichain."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(n_pad)[:sum(sizes)]
    adj = np.zeros((n_pad, n_pad), bool)
    status = np.full(n_pad, FREE, np.int32)
    msb = np.zeros(n_pad, np.int64)
    ends = np.cumsum(sizes)
    for lv, (a, b) in enumerate(zip(ends - sizes, ends)):
        status[slots[a:b]] = STABLE
        msb[slots[a:b]] = lv
        if lv:
            prev = slots[a - sizes[lv - 1]:a]
            for i in slots[a:b]:
                adj[i, rng.choice(prev, int(rng.integers(1, deg + 1)))] = True
    return (adj, status, msb, np.zeros(n_pad, np.int64),
            np.ones(n_pad, np.int32), np.zeros(n_pad, bool))


def _edges_graph(n, edges, status, n_pad=64, awaits=()):
    """A hand-made case: executeAt ascending by slot."""
    case = {"n": n, "edges": edges, "status": status,
            "msb": list(range(n)), "node": [1] * n,
            "awaits": [i in awaits for i in range(n)]}
    return _arrays(case, n_pad, 8)[0]


H = HANDOVER
K8_GRAPHS = {
    "empty": lambda: _edges_graph(8, [], [STABLE] * 8),
    "n0": lambda: tuple(np.zeros((0, 0) if i == 0 else 0, d) for i, d in
                        enumerate((bool, np.int32, np.int64, np.int64,
                                   np.int32, bool))),
    "n1": lambda: _edges_graph(1, [], [STABLE], n_pad=1),
    "n31": lambda: _arrays(_logsq_case(np.random.default_rng(31), 31), 31,
                           8)[0],
    "n33": lambda: _arrays(_logsq_case(np.random.default_rng(33), 33), 33,
                           8)[0],
    "n4097": lambda: _levels_graph((1800, 1500, 797), 4097, 7),
    # two Stable rows that await all gate each other; a third waits on both
    "cycle": lambda: _edges_graph(
        4, [(1, 2), (2, 1), (3, 1), (3, 2)], [APPLIED] + [STABLE] * 3,
        awaits=(1, 2)),
    "self_gating": lambda: _edges_graph(3, [(1, 1), (2, 1), (2, 0)],
                                        [STABLE] * 3),
    # a Stable row behind an unapplied Committed row, and one behind it
    "behind_non_stable": lambda: _edges_graph(
        4, [(1, 0), (2, 1), (3, 2)], [STABLE, COMMITTED, STABLE, STABLE]),
    "applied_at_start": lambda: _edges_graph(
        6, [(1, 0), (2, 0), (3, 1), (4, 3), (5, 2)],
        [APPLIED, APPLIED, STABLE, STABLE, STABLE, APPLIED]),
    "handover_below": lambda: _levels_graph((H - 1, 3, 3), 4 * H, 11),
    "handover_at": lambda: _levels_graph((H, 3, 3), 4 * H, 12),
    "handover_above": lambda: _levels_graph((H + 1, 3, 3), 4 * H, 13),
    "handover_later": lambda: _levels_graph((H + 1, H, H + 1, 2), 4 * H,
                                            14),
}


@pytest.mark.parametrize("name", list(K8_GRAPHS))
def test_frontier_drain_model_equals_reference(name):
    """The model of K8 dense's frontier form equals the reference's
    drain_levels (applied, newly, sweeps), as does the port's plain
    version, at the edges named; a level of at most HANDOVER rows is the
    first CTA's, a wider one the grid's (handover_later: grid, first CTA,
    grid again, first CTA)."""
    dense = K8_GRAPHS[name]()
    ref = rdrk.drain_levels(rdrk.DrainState(*map(jnp.asarray, dense)))
    got, modes = _frontier_drain_model(dense, np.random.default_rng(5))
    _eq(ref, tuple(torch.from_numpy(np.asarray(x)) for x in got))
    port = convert.tables_from_numpy({"drain": dense}, "cpu")["drain"]
    _eq(ref, pdrk.drain_levels(port))
    sizes = [m[1] for m in modes]
    assert [m[0] for m in modes] == ["grid" if x > H else "block"
                                     for x in sizes]
    if name.startswith("handover"):
        assert sizes[0] == {"below": H - 1, "at": H, "above": H + 1,
                            "later": H + 1}[name.split("_")[1]]
    if name == "handover_later":
        assert [m[0] for m in modes] == ["grid", "block", "grid", "block"]
    if name in ("cycle", "self_gating", "behind_non_stable"):
        assert not got[0].all()


def test_frontier_drain_model_on_seeded_graphs():
    """The model against the reference on the generator's seeded graphs
    (undecided, invalidated and free deps, executeAt ties, awaits_all
    cycles) and a deep chain."""
    rng = np.random.default_rng(9400)
    for _ in range(12):
        dense = _arrays(make_case(rng), N_PAD, D_PAD)[0]
        ref = rdrk.drain_levels(rdrk.DrainState(*map(jnp.asarray, dense)))
        got, _modes = _frontier_drain_model(dense, rng)
        _eq(ref, tuple(torch.from_numpy(np.asarray(x)) for x in got))
    dense = _arrays(chain_case(64), 64, 4)[0]
    got, modes = _frontier_drain_model(dense, rng)
    assert int(got[2]) == 64 and {m for m, _n in modes} == {"block"}


# -- K8 ELL's frontier form (the edge loader), in plain arithmetic -------------
#
# csrc/drain_fix.cu ``EdgeLoader`` counts, per Stable row, its edges that
# gate (the reference's _ell_blocking) and whose dep is not applied at the
# start: per edge, so a dep listed twice counts twice.  The lists are those
# edges transposed into CSR (a length per dep, offsets by a scan, each edge
# placed in whatever order the atomics leave it), and a row listed twice in
# a dep's list is decremented twice.  A level entry of the kernel is a row
# of at most ITEM dependents or an item of ITEM dependents of a heavier
# row (its list padded with -1, which moves no count): a level's size is
# the sum of max(1, ceil(dependents / ITEM)) over its rows.
# The engine then walks the levels as for the dense form, with the ELL
# handover (ops/_build.py GEOMETRY, which the kernel is built with) in
# items; the counts fit the byte a row the first CTA keeps them in while
# D <= 255.

HANDOVER_ELL = _build.GEOMETRY["ACCORD_DRAIN_HANDOVER_ELL"]
ITEM = _build.GEOMETRY["ACCORD_DRAIN_ELL_ITEM"]


def _ell_frontier_model(ell, rng):
    """((applied, newly, sweeps), [(mode, level size in items), ...])."""
    adj_idx, status, msb, lsb, node, awaits = ell
    n, d = adj_idx.shape
    j = np.clip(adj_idx, 0, None).astype(np.int64)
    um, ul = msb.view(np.uint64), lsb.view(np.uint64)
    before = ((um[j] < um[:, None])
              | ((um[j] == um[:, None])
                 & ((ul[j] < ul[:, None])
                    | ((ul[j] == ul[:, None]) & (node[j] < node[:, None])))))
    st_j = status[j]
    dead = (st_j == INVALIDATED) | (st_j == FREE)
    undecided = (st_j >= 0) & (st_j < COMMITTED)
    stable, app0 = status == STABLE, status == APPLIED
    counted = ((adj_idx >= 0) & ~dead & (undecided | awaits[:, None] | before)
               & ~app0[j] & stable[:, None])
    cnt = counted.sum(axis=1)
    if d <= 255:
        assert cnt.max(initial=0) <= 255
    rows, cols = np.nonzero(counted)
    deps = j[rows, cols]
    deg = np.bincount(deps, minlength=n)
    off = np.cumsum(deg) - deg
    dep = np.empty(len(deps), np.int64)
    fill = np.zeros(n, np.int64)
    for e in rng.permutation(len(deps)):
        dep[off[deps[e]] + fill[deps[e]]] = rows[e]
        fill[deps[e]] += 1
    items = np.maximum(1, -(-deg // ITEM))
    level = [int(i) for i in np.nonzero(stable & (cnt == 0))[0]]
    modes = []
    while level:
        size = int(items[level].sum())
        modes.append(("block" if size <= HANDOVER_ELL else "grid", size))
        nxt = []
        for jj in rng.permutation(level):
            for i in dep[off[jj]:off[jj] + deg[jj]]:
                cnt[i] -= 1
                if cnt[i] == 0:
                    nxt.append(int(i))
        level = nxt
    newly = stable & (cnt == 0)
    return (app0 | newly, newly, np.int32(len(modes) + 1)), modes


def _ell_of(dense):
    """The ELL form of a dense case: a row's deps in slot order, -1 padded
    to the widest row (at least one column)."""
    adj = dense[0]
    width = max(1, int(adj.sum(axis=1).max(initial=0)))
    idx = np.full((adj.shape[0], width), -1, np.int32)
    for i in range(adj.shape[0]):
        e = np.nonzero(adj[i])[0]
        idx[i, :len(e)] = e
    return (idx,) + tuple(dense[1:])


def _ell_graph(n, rows, status, msb=None, node=None, awaits=()):
    """A hand-made ELL case: ``rows`` {i: its adj_idx row (-1 holes kept,
    duplicates kept)}, padded with -1 to the widest; executeAt ascending by
    slot unless ``msb`` / ``node`` say otherwise."""
    width = max(len(r) for r in rows.values())
    idx = np.full((n, width), -1, np.int32)
    for i, r in rows.items():
        idx[i, :len(r)] = r
    return (idx, np.asarray(status, np.int32),
            np.asarray(range(n) if msb is None else msb, np.int64),
            np.zeros(n, np.int64),
            np.asarray([1] * n if node is None else node, np.int32),
            np.asarray([i in awaits for i in range(n)], bool))


def _hot_legs_ell(n=4096, chains=32, d=8, seed=41):
    """``chip_smoke.hot_drain_legs``'s ELL drain at a small size: every
    row Stable in ``chains`` hot chains, with 1 to d - 1 more deps among
    the 3 x ``chains`` rows before it (duplicates possible), executeAt
    ascending by slot."""
    rng = np.random.default_rng(seed)
    idx = np.full((n, d), -1, np.int32)
    for i in range(chains, n):
        idx[i, 0] = i - chains
        extra = rng.integers(1, d, 1)[0]
        lo = max(0, i - 3 * chains)
        if lo < i - 1:
            idx[i, 1:1 + extra] = rng.integers(lo, i - 1, extra)
    return (idx, np.full(n, STABLE, np.int32), np.arange(n, dtype=np.int64),
            np.zeros(n, np.int64), np.ones(n, np.int32), np.zeros(n, bool))


HE = HANDOVER_ELL
ELL_GRAPHS = {
    **{f"dense_{k}": (lambda g=g: _ell_of(g())) for k, g in K8_GRAPHS.items()},
    "handover_below": lambda: _ell_of(_levels_graph((HE - 1, 3, 3), 4 * HE,
                                                    21)),
    "handover_at": lambda: _ell_of(_levels_graph((HE, 3, 3), 4 * HE, 22)),
    "handover_above": lambda: _ell_of(_levels_graph((HE + 1, 3, 3), 4 * HE,
                                                    23)),
    "handover_later": lambda: _ell_of(_levels_graph((HE + 1, HE, HE + 1, 2),
                                                    4 * HE, 24)),
    # row 3 lists dep 1 twice (both decrements come), row 4 lists dep 0
    # (applied) twice and dep 3 twice, row 5 lists itself twice
    "duplicates": lambda: _ell_graph(
        6, {2: [1], 3: [1, 2, 1], 4: [0, 3, 0, 3], 5: [5, 4, 5]},
        [APPLIED, STABLE, STABLE, STABLE, STABLE, STABLE], awaits=(5,)),
    "holes": lambda: _ell_graph(
        6, {1: [-1, 0, -1], 2: [-1, -1, 1], 3: [1, -1, 2, -1], 5: [-1, 3]},
        [STABLE] * 6),
    # deps on FREE (1) and INVALIDATED (2) rows never gate; row 5 also
    # waits on an undecided row 3, which never applies
    "free_invalidated": lambda: _ell_graph(
        6, {0: [1, 2], 4: [2, 0, 1], 5: [1, 3]},
        [STABLE, FREE, INVALIDATED, 1, STABLE, STABLE]),
    # one executeAt (msb 3), the node breaking the tie: a dep gates a row
    # whose node is larger, not one whose node is smaller
    "ties": lambda: _ell_graph(
        5, {1: [0], 2: [0, 1], 3: [2], 4: [3, 1]}, [STABLE] * 5,
        msb=[3] * 5, node=[1, 2, 3, 1, 4]),
    "hot_legs": _hot_legs_ell,
    # two rows that 6,400 rows wait on: a level of 2 rows and 1,068 items
    "hubs": lambda: _ell_graph(6402, {i: [0, 1] for i in range(2, 6402)},
                               [STABLE] * 6402),
    # 300 edges a row, 260 to one dep: a count past a byte
    "wide_rows": lambda: _ell_graph(
        4, {1: [0] * 260 + [-1] * 40, 2: [1] * 300, 3: [2, 0]},
        [STABLE] * 4),
    **{f"seeded{s}": (lambda s=s: _arrays(
        make_case(np.random.default_rng(9500 + s)), N_PAD, D_PAD)[1])
       for s in range(6)},
}


@pytest.mark.parametrize("name", list(ELL_GRAPHS))
def test_ell_frontier_model_equals_reference(name):
    """The model of K8 ELL's frontier form equals the reference's
    drain_ell_levels (applied, newly, sweeps), as does the port's plain
    version, on the ELL forms of every dense K8 case, the ELL handover's
    edges, duplicate deps, -1 holes, FREE and INVALIDATED deps, executeAt
    ties, a count past a byte, config 3's hot chains, two rows that
    thousands wait on and seeded cases; a level of at most HANDOVER_ELL
    items is the first CTA's, a wider one the grid's."""
    ell = ELL_GRAPHS[name]()
    ref = rdrk.drain_ell_levels(rdrk.EllDrainState(*map(jnp.asarray, ell)))
    got, modes = _ell_frontier_model(ell, np.random.default_rng(6))
    _eq(ref, tuple(torch.from_numpy(np.asarray(x)) for x in got))
    port = convert.tables_from_numpy({"ell": ell}, "cpu")["ell"]
    _eq(ref, pdrk.drain_ell_levels(port))
    sizes = [m[1] for m in modes]
    assert [m[0] for m in modes] == ["grid" if x > HE else "block"
                                     for x in sizes]
    if name.startswith("handover"):
        assert sizes[0] == {"below": HE - 1, "at": HE, "above": HE + 1,
                            "later": HE + 1}[name.split("_")[1]]
    if name == "handover_later":
        assert [m[0] for m in modes] == ["grid", "block", "grid", "block"]
    applied = got[0]
    if name in ("dense_cycle", "dense_self_gating", "dense_behind_non_stable"):
        assert not applied.all()
    if name == "duplicates":
        assert applied.tolist() == [True] * 5 + [False]
    if name == "free_invalidated":
        assert applied.tolist() == [True, False, False, False, True, False]
    if name == "ties":     # levels {0, 3}, {1}, {2, 4}: row 3's dep 2
        # has the larger node, so it gates nothing
        assert int(got[2]) == 4 and applied.all()
    if name == "wide_rows":
        assert int(got[2]) == 5 and applied.all()
    if name == "hot_legs":
        assert applied.all()
    if name == "hubs":
        assert modes == [("grid", 2 * -(-6400 // ITEM)), ("grid", 6400)]
        assert applied.all()


# -- the routed drains ----------------------------------------------------------

CAL = (1e-9, 2e-9, 3e-9, 4e-12, 5e-9)


def _calibrate(*c):
    rdrk.set_drain_calibration(*c)
    pdrk.set_drain_calibration(*c)


def _routed(ref, port, fn="drain_auto"):
    r = getattr(rdrk, fn)(ref)
    p = getattr(pdrk, fn)(port)
    _eq(r, p)
    return p[3]


def _same_routing_state():
    assert rdrk._ROUTE_STATS == pdrk._ROUTE_STATS
    assert rdrk.drain_counters() == pdrk.drain_counters()


def test_routes_stats_and_counters_equal():
    """A sequence of routed calls over three shapes and two calibrations:
    every route, result, learned stat and counter equals the reference's."""
    rng = np.random.default_rng(9300)
    cases = [_states(*_arrays(make_case(rng), N_PAD, D_PAD)),
             _states(*_arrays(chain_case(64), 64, 4))]
    routes = []
    for cal in (CAL, (5e-9, 1e-10, 1e-12, 1e-9, 1e-12)):
        _calibrate(*cal)
        for (rd, re), (pd, pe) in cases:
            for _ in range(2):
                routes.append(_routed(re, pe, "drain_ell_auto"))
                routes.append(_routed(rd, pd))
                routes.append(_routed(re, pe))
                _same_routing_state()
    assert {"ell-logdepth", "ell-fixpoint", "dense-to-ell-logdepth"} \
        <= set(routes)


@pytest.mark.parametrize("route,cal", [
    ("dense-fixpoint", (1, 1, 1e-15, 1, 1)),
    ("dense-logsq", (1, 1, 1, 1e-15, 1)),
    ("dense-to-ell-logdepth", (1e-15, 1e-15, 1, 1, 1e-15))])
def test_dense_routes_forced(route, cal):
    """Each of drain_auto's three dense routes, made the cheapest in turn,
    after the unseen shape's first (log-depth) call."""
    _calibrate(*cal)
    (rd, _re), (pd, _pe) = _states(*_arrays(chain_case(64), 64, 4))
    assert _routed(rd, pd) == "dense-to-ell-logdepth"
    assert _routed(rd, pd) == route
    _same_routing_state()


def test_fixpoint_hatch(monkeypatch):
    """ACCORD_TPU_DRAIN=fixpoint pins the oracle in both routed drains; unset,
    an unseen shape runs the log-depth pass."""
    _calibrate(*CAL)
    (rd, re), (pd, pe) = _states(*_arrays(chain_case(64), 64, 4))
    monkeypatch.setenv("ACCORD_TPU_DRAIN", "fixpoint")
    assert _routed(re, pe, "drain_ell_auto") == "ell-fixpoint"
    assert _routed(rd, pd) == "dense-fixpoint"
    _same_routing_state()
    monkeypatch.delenv("ACCORD_TPU_DRAIN")
    pdrk.reset_drain_routing()
    rdrk.reset_drain_routing()
    assert _routed(re, pe, "drain_ell_auto") == "ell-logdepth"
    assert _routed(rd, pd) == "dense-to-ell-logdepth"
    _same_routing_state()


@pytest.mark.parametrize("kind,cal", [
    ("kernel_launch", CAL), ("transfer", CAL),
    ("kernel_launch", (1, 1, 1, 1e-15, 1))])
def test_failover_same_bytes(kind, cal):
    """An injected device fault inside a log-depth launch fails the call
    over to the fixpoint: the same bytes, the same route name and one
    failover tick in both packages (ELL, dense-to-ELL and, with the third
    calibration, log-squaring)."""
    _calibrate(*cal)
    (rd, re), (pd, pe) = _states(*_arrays(chain_case(64), 64, 4))
    if cal[3] < 1:                      # learn the shape, then log-squaring
        _routed(rd, pd)
    with rfaults.device_fault(kind, 1.0, RRandom(5)), \
            pfaults.device_fault(kind, 1.0, PRandom(5)):
        assert _routed(re, pe, "drain_ell_auto") == "ell-fixpoint-failover"
        assert _routed(rd, pd) == "dense-fixpoint-failover"
    _same_routing_state()
    assert pdrk.drain_counters()["drain_logdepth_failovers"] == 2


# -- bench config 3, scaled down -------------------------------------------------

class _Store:
    def __init__(self, pkg):
        from importlib import import_module
        rb = import_module(pkg.__name__ + ".local.redundant")
        self.commands_for_key = {}
        self.redundant_before = rb.RedundantBefore()

    class node:
        scheduler = None


class _Safe:
    def __init__(self, store):
        self.store = store

    def redundant_before(self):
        return self.store.redundant_before


def _hot_store(pkg, n3=2000, hot=16, nq=64):
    """bench.build_hot128_store at a smaller N, key count and query count,
    drawing from ``default_rng(9)`` in the same order; returns (dev, safe,
    queries, rng continuation)."""
    from importlib import import_module
    di = import_module(pkg.__name__ + ".local.device_index")
    cfk_m = import_module(pkg.__name__ + ".local.commands_for_key")
    keys = import_module(pkg.__name__ + ".primitives.keys")
    ts = import_module(pkg.__name__ + ".primitives.timestamp")
    IS, CFK = cfk_m.InternalStatus, cfk_m.CommandsForKey
    TxnId, TxnKind, Domain = ts.TxnId, ts.TxnKind, ts.Domain
    rng = np.random.default_rng(9)
    store = _Store(pkg)
    if pkg is accord_tpu:
        dev = di.DeviceState(store)
        dev.mesh = None
    else:
        dev = di.DeviceState(store, device="cpu")
    hlcs = np.sort(rng.choice(np.arange(1, 2_000_000), size=n3,
                              replace=False))
    floor_hlc = int(hlcs[int(n3 * 0.9)])
    floor_id = TxnId.create(1, floor_hlc, TxnKind.ExclusiveSyncPoint,
                            Domain.Range, 1)
    entries = []
    for i in range(n3):
        hlc = int(hlcs[i])
        if hlc < floor_hlc:
            status = IS.APPLIED
        else:
            status = (IS.COMMITTED if rng.random() < 0.3
                      else IS.PREACCEPTED)
        kind = TxnKind.Write if rng.random() < 0.7 else TxnKind.Read
        tid = TxnId.create(1, hlc, kind, Domain.Key, 1 + i % 5)
        toks = [int(t) for t in rng.integers(0, hot, rng.integers(1, 4))]
        entries.append((tid, status, toks))
    for tid, status, toks in entries:
        dev.register(tid, int(status),
                     keys.Keys([keys.IntKey(t) for t in toks]))
        if status >= IS.COMMITTED:
            dev.update_status(tid, int(status), execute_at=tid)
        for t in toks:
            cfk = store.commands_for_key.get(t)
            if cfk is None:
                cfk = store.commands_for_key[t] = CFK(t)
            cfk.update(tid, status,
                       execute_at=tid if status >= IS.COMMITTED else None)
    store.redundant_before.add_redundant(
        keys.Ranges.of(keys.Range(0, hot)), floor_id)
    queries = []
    for _ in range(nq):
        bound = TxnId.create(1, int(rng.integers(2_000_000, 3_000_000)),
                             TxnKind.Write, Domain.Key, 1)
        toks = [int(t) for t in rng.integers(0, hot, rng.integers(1, 4))]
        queries.append((bound, bound, bound.kind().witnesses(), toks, []))
    return dev, _Safe(store), queries, rng


def _deps(pkg, dev, safe, queries):
    """The bench's timed form: begin(prune_floors, attributed), end."""
    from importlib import import_module
    DepsBuilder = import_module(pkg.__name__ + ".primitives.deps").DepsBuilder
    dev.deps_query_batch_attributed(safe, queries,
                                    [DepsBuilder() for _ in queries])
    handle = dev.deps_query_batch_begin(queries, prune_floors=True,
                                        attributed=True)
    builders = [DepsBuilder() for _ in queries]
    dev.deps_query_batch_end_attributed(safe, handle, builders)
    out = []
    for b in builders:
        d = b.build()
        out.append((d.key_deps.relation_count(),
                    [(k, [(t.msb, t.lsb, t.node)
                          for t in d.key_deps.txn_ids_for(k)])
                     for k in d.key_deps.keys.tokens()]))
    return out


def _drain_legs(pkg, rng, nd=2000, chains=32, ndd=256, d=8):
    """bench.py's config-3 drain legs from the rng continuation: the ELL
    drain of ``nd`` Stable txns in ``chains`` hot chains, and an
    ``ndd``-deep chain with local fan-in (dense and its ELL form)."""
    adj_idx = np.full((nd, d), -1, np.int32)
    for i in range(chains, nd):
        adj_idx[i, 0] = i - chains
        extra = rng.integers(1, d, 1)[0]
        lo = max(0, i - 3 * chains)
        if lo < i - 1:
            adj_idx[i, 1:1 + extra] = rng.integers(lo, i - 1, extra)
    adj = np.zeros((ndd, ndd), bool)
    for i in range(1, ndd):
        adj[i, i - 1] = True
        for j in range(max(0, i - 8), i - 1):
            adj[i, j] = rng.random() < 0.5
    deg = max(1, int(adj.sum(axis=1).max()))
    dd = 4
    while dd < deg:
        dd *= 2
    adj_idx_d = np.full((ndd, dd), -1, np.int32)
    for i in range(ndd):
        e = np.nonzero(adj[i])[0]
        adj_idx_d[i, :len(e)] = e

    from importlib import import_module
    ts = import_module(pkg.__name__ + ".primitives.timestamp")
    pack = import_module(pkg.__name__ + ".ops.packing").pack_timestamps
    ids = [ts.TxnId.create(1, 10 + i, ts.TxnKind.Write, ts.Domain.Key, 1)
           for i in range(nd)]

    def cols(n):        # executeAt = the ids; every row Stable
        em, el, en = (np.asarray(x) for x in pack(ids[:n]))
        return (np.full(n, STABLE, np.int32), em, el, en,
                np.zeros(n, bool))
    return ((adj_idx,) + cols(nd), (adj,) + cols(ndd),
            (adj_idx_d,) + cols(ndd))


def test_hot_keys_config_scaled():
    """Bench config 3 at N=2,000 over 16 hot keys: one 64-query batch's
    Deps, then the drain legs drawn from the same rng continuation — the
    routed ELL drain over 2,000 txns in 32 chains and a 256-deep chain's
    oracle, routed drain and log-depth rounds — equal the reference's."""
    got = {}
    for pkg in (accord_tpu, accord_tpu_torch):
        dev, safe, queries, rng = _hot_store(pkg)
        got[pkg] = (_deps(pkg, dev, safe, queries), _drain_legs(pkg, rng))
    assert got[accord_tpu][0] == got[accord_tpu_torch][0]
    assert sum(c for c, _ in got[accord_tpu_torch][0]) > 0
    for a, b in zip(got[accord_tpu][1], got[accord_tpu_torch][1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ell, dense, ell_d = got[accord_tpu_torch][1]
    _calibrate(*CAL)
    r_ell = rdrk.EllDrainState(*map(jnp.asarray, ell))
    p_ell = convert.tables_from_numpy({"ell": ell}, "cpu")["ell"]
    for _ in range(2):
        assert _routed(r_ell, p_ell, "drain_ell_auto") in (
            "ell-logdepth", "ell-fixpoint")
    _eq(rdrk.drain_ell_levels(r_ell), pdrk.drain_ell_levels(p_ell))
    assert int(pdrk.drain_ell_levels(p_ell)[1].sum()) == 2000
    (rd, re), (pd, pe) = _states(dense, ell_d)
    oracle = pdrk.drain_levels(pd)
    _eq(rdrk.drain_levels(rd), oracle)
    assert int(oracle[2]) == 257
    for _ in range(2):
        _routed(re, pe, "drain_ell_auto")
    _eq(rdrk.drain_ell_logdepth(re), pdrk.drain_ell_logdepth(pe))
    assert torch.equal(pdrk.drain_ell_logdepth(pe)[1], oracle[1])
    _same_routing_state()
