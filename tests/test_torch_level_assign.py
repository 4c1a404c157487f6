"""The port's log-depth level pass (K7: ``level_assign_ell`` /
``level_assign_dense``) against the JAX package's, levels and rounds, on
seeded drain graphs built like the ``tests/test_drain_logdepth.py``
generators: a DAG backbone with a few arbitrary edges (cycles, which gate
only through ``awaits_all`` rows), undecided deps, invalidated and free
slots, Committed-but-not-Stable deps and executeAt ties; plus deep chains,
where the pointer jumps make the round count logarithmic.  Then the
shapes at the edges of K7 dense's design on the card (its 16-byte row
walk, its lists, its first-CTA and grid forms): a Stable row with more
than 32 blocking deps, N not a multiple of 16, a 300-row chain closed by
an ``awaits_all`` cycle at its tail, and a graph of Stable rows all
blocked; each also through a numpy model of the kernel's list form
(count, keep, scan, fill, a list capacity, the rounds on the lists) held
against the reference.  Last, K7 ELL's compacted form through a PyTorch
model (the edges gated once, the Stable rows compacted with two constant
rows for the inactive deps, the rounds with one grid barrier or two) on
the same edge cases, D = 1 and 33, awaits cycles, a self-dep, no Stable
row, -1 holes and repeated deps.  CPU only: the port takes its plain
versions here; tolerance zero (integers): levels and rounds byte-equal."""

import numpy as np
import pytest

import jax.numpy as jnp

from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu_torch.ops import convert
from accord_tpu_torch.ops import drain_kernel as pdrk

FREE, TRANSITIVE, PREACCEPTED, ACCEPTED, COMMITTED, STABLE, APPLIED, \
    INVALIDATED = -1, 0, 1, 2, 3, 4, 5, 6
STATUSES = [FREE, TRANSITIVE, PREACCEPTED, ACCEPTED, COMMITTED, STABLE,
            STABLE, STABLE, APPLIED, APPLIED, INVALIDATED]
# every case is padded to these shapes, so each side compiles / runs one
# shape: pad rows are FREE, pad edges -1
N_PAD, D_PAD = 32, 8


def make_case(rng):
    """The reference generator's distribution, drawn with numpy."""
    n = int(rng.integers(2, 21))
    edges = set()
    for i in range(1, n):
        for _ in range(int(rng.integers(0, 4))):
            edges.add((i, int(rng.integers(0, i))))   # DAG backbone
    for _ in range(int(rng.integers(0, 3))):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a != b:
            edges.add((a, b))                          # possible cycle
    return {"n": n, "edges": sorted(edges),
            "status": [STATUSES[int(i)] for i in
                       rng.integers(0, len(STATUSES), n)],
            # a small msb range forces executeAt ties; node breaks some
            "msb": [int(x) for x in rng.integers(0, 6, n)],
            "node": [int(x) for x in rng.integers(1, 3, n)],
            "awaits": [bool(x) for x in rng.random(n) < 0.15]}


def chain_case(n, applied_head=True):
    """A serial chain: slot i waits on i-1, executeAt ascending."""
    return {"n": n, "edges": [(i, i - 1) for i in range(1, n)],
            "status": [APPLIED if applied_head and i == 0 else STABLE
                       for i in range(n)],
            "msb": list(range(n)), "node": [1] * n, "awaits": [False] * n}


def _arrays(case, n_pad, d_pad):
    n = case["n"]
    adj = np.zeros((n_pad, n_pad), bool)
    for i, j in case["edges"]:
        adj[i, j] = True
    status = np.full(n_pad, FREE, np.int32)
    status[:n] = case["status"]
    msb = np.zeros(n_pad, np.int64)
    msb[:n] = case["msb"]
    node = np.zeros(n_pad, np.int32)
    node[:n] = case["node"]
    aw = np.zeros(n_pad, bool)
    aw[:n] = case["awaits"]
    idx = np.full((n_pad, d_pad), -1, np.int32)
    for i in range(n_pad):
        cols = np.nonzero(adj[i])[0]
        idx[i, :len(cols)] = cols
    scal = (status, msb, np.zeros(n_pad, np.int64), node, aw)
    return (adj,) + scal, (idx,) + scal


def _both(case, n_pad=N_PAD, d_pad=D_PAD):
    dense, ell = _arrays(case, n_pad, d_pad)
    ref_d = rdrk.level_assign_dense(rdrk.DrainState(*map(jnp.asarray,
                                                          dense)))
    ref_e = rdrk.level_assign_ell(rdrk.EllDrainState(*map(jnp.asarray, ell)))
    st = convert.tables_from_numpy({"drain": dense, "ell": ell}, "cpu")
    port_d = pdrk.level_assign_dense(st["drain"])
    port_e = pdrk.level_assign_ell(st["ell"])
    return ref_d, ref_e, port_d, port_e


def _eq(ref, port):
    lv, rounds = port
    np.testing.assert_array_equal(np.asarray(ref[0]), lv.numpy())
    assert int(ref[1]) == int(rounds)
    assert lv.dtype == pdrk.torch.int32


@pytest.mark.parametrize("seed", range(8))
def test_levels_and_rounds_equal(seed):
    rng = np.random.default_rng(7000 + seed)
    for _ in range(3):
        case = make_case(rng)
        ref_d, ref_e, port_d, port_e = _both(case)
        _eq(ref_d, port_d)
        _eq(ref_e, port_e)
        # the two forms agree with each other too
        np.testing.assert_array_equal(port_d[0].numpy(), port_e[0].numpy())


@pytest.mark.parametrize("n,applied_head", [(32, True), (32, False),
                                            (128, True)])
def test_chain_levels_are_logarithmic(n, applied_head):
    ref_d, ref_e, port_d, port_e = _both(chain_case(n, applied_head),
                                         n_pad=n, d_pad=4)
    _eq(ref_d, port_d)
    _eq(ref_e, port_e)
    lv = port_e[0].numpy()
    first = 0 if applied_head else 1
    np.testing.assert_array_equal(lv, np.arange(first, n + first))
    assert int(port_e[1]) <= 2 * int(np.log2(n)) + 4


def test_awaits_cycle_blocks_forever():
    """A blocking cycle exists only through awaits_all rows: both rows on
    it, and everything downstream, stay at LEVEL_INF."""
    case = {"n": 4, "edges": [(1, 2), (2, 1), (3, 2)],
            "status": [APPLIED, STABLE, STABLE, STABLE],
            "msb": [0, 1, 2, 3], "node": [1, 1, 1, 1],
            "awaits": [False, True, False, False]}
    ref_d, ref_e, port_d, port_e = _both(case)
    _eq(ref_d, port_d)
    _eq(ref_e, port_e)
    lv = port_e[0].numpy()
    assert lv[0] == 0 and (lv[1:4] == pdrk.LEVEL_INF).all()


# -- K7 dense's list form, at its edges ----------------------------------------

def fanin_case(n=80, fan=40):
    """Stable rows each waiting on the ``fan`` rows before them (more than
    a warp's 32 lanes), executeAt ascending; the first ``fan`` applied."""
    return {"n": n, "edges": [(i, j) for i in range(fan, n)
                              for j in range(i - fan, i)],
            "status": [APPLIED] * fan + [STABLE] * (n - fan),
            "msb": list(range(n)), "node": [1] * n, "awaits": [False] * n}


def cycle_tail_case(n=300):
    """A serial chain whose last two rows wait on each other, the later
    one awaiting all its deps: a blocking cycle at the tail."""
    case = chain_case(n)
    case["edges"] = case["edges"] + [(n - 2, n - 1)]
    case["awaits"] = [False] * (n - 2) + [True, False]
    return case


def all_blocked_case(n=64):
    """Every row Stable and blocked: each waits on the one before, and
    row 0 on row 1, awaiting all (a cycle at the head gates them all)."""
    return {"n": n, "edges": [(i, i - 1) for i in range(1, n)] + [(0, 1)],
            "status": [STABLE] * n, "msb": list(range(n)),
            "node": [1] * n, "awaits": [True] + [False] * (n - 1)}


def random_case(seed, n):
    """``make_case``'s distribution at ``n`` rows."""
    rng = np.random.default_rng(seed)
    edges = {(i, int(rng.integers(0, i))) for i in range(1, n)
             for _ in range(int(rng.integers(0, 4)))}
    edges |= {(int(a), int(b)) for a, b in rng.integers(0, n, (4, 2))
              if a != b}
    return {"n": n, "edges": sorted(edges),
            "status": [STATUSES[int(i)] for i in
                       rng.integers(0, len(STATUSES), n)],
            "msb": [int(x) for x in rng.integers(0, 6, n)],
            "node": [int(x) for x in rng.integers(1, 3, n)],
            "awaits": [bool(x) for x in rng.random(n) < 0.15]}


EDGE_CASES = {"fanin": fanin_case(), "n48": random_case(1, 48),
              "n100": random_case(2, 100), "chain300_cycle": cycle_tail_case(),
              "all_blocked": all_blocked_case()}


def _gates(adj, status, msb, lsb, node, aw, i):
    """Row i's gating deps in column order (common.cuh drain_gates: the
    reference's blocking_matrix row, applied deps included)."""
    out = []
    for j in np.nonzero(adj[i])[0]:
        sj = status[j]
        if sj in (INVALIDATED, FREE):
            continue
        before = (np.uint64(msb[j]), np.uint64(lsb[j]), node[j]) < \
            (np.uint64(msb[i]), np.uint64(lsb[i]), node[i])
        if 0 <= sj < COMMITTED or aw[i] or before:
            out.append(int(j))
    return out


def k7_list_model(dense, cap=None, keep=4):
    """K7 dense (ops/csrc/levels.cu) step by step: the count pass (a
    Stable row's gating deps, its first ``keep``, its critical parent by
    the level0 * N + slot key), the scan into list starts, the fill (rows
    of at most ``keep`` copy, heavier rows walk again; a list past ``cap``
    entries is not written and its row walks its bytes in every round),
    then the rounds on the lists, a row below INF other than level 0 taken
    for a Stable row.  Returns (levels, rounds)."""
    adj, status, msb, lsb, node, aw = dense
    n = len(status)
    inf = pdrk.LEVEL_INF
    base = np.where(status == APPLIED, 0,
                    np.where(status == STABLE, 1, inf)).astype(np.int64)
    cnt = np.zeros(n, np.int64)
    kept = {}
    ptr = np.arange(n)
    for i in range(n):
        if status[i] != STABLE:
            continue
        deps = _gates(adj, status, msb, lsb, node, aw, i)
        cnt[i], kept[i] = len(deps), deps[:keep]
        if deps:
            ptr[i] = max(base[j] * n + j for j in deps) % n
    start = np.concatenate([[0], np.cumsum(cnt)])
    cap = start[-1] if cap is None else cap
    lists = {}
    for i in range(n):
        if cnt[i] and start[i + 1] <= cap:
            lists[i] = (kept[i] if cnt[i] <= keep else
                        _gates(adj, status, msb, lsb, node, aw, i))
    lv, off = base.copy(), (ptr != np.arange(n)).astype(np.int64)
    r, changed = 0, True
    while changed and r < n + 3:
        mid = lv.copy()
        for i in range(n):
            if 1 <= lv[i] < inf:
                deps = lists.get(i) if start[i + 1] <= cap else \
                    _gates(adj, status, msb, lsb, node, aw, i)
                m = max([lv[j] for j in deps or ()], default=0)
                mid[i] = max(min(1 + m, inf), lv[i])
        new = np.where(off > 0, np.maximum(mid, np.minimum(off + mid[ptr],
                                                           inf)), mid)
        new = np.where(new > n, inf, new)
        off, ptr = np.minimum(off + off[ptr], inf), ptr[ptr]
        changed, lv, r = bool((new != lv).any()), new, r + 1
    return lv, r


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_level_edge_cases_equal(name):
    """The port's plain versions against the reference, dense and ELL."""
    case = EDGE_CASES[name]
    n = case["n"]
    ref_d, ref_e, port_d, port_e = _both(case, n_pad=n, d_pad=40)
    _eq(ref_d, port_d)
    _eq(ref_e, port_e)
    if name == "all_blocked":
        assert (port_d[0].numpy() == pdrk.LEVEL_INF).all()
    if name == "chain300_cycle":
        lv = port_d[0].numpy()
        np.testing.assert_array_equal(lv[:n - 2], np.arange(n - 2))
        assert (lv[n - 2:] == pdrk.LEVEL_INF).all()


@pytest.mark.parametrize("cap", [None, 16])
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_level_list_model_equal(name, cap):
    """K7 dense's list form, with every list written and with a capacity
    of 16 entries (the rows past it walk their bytes), against the
    reference's levels and rounds."""
    case = EDGE_CASES[name]
    dense, _ell = _arrays(case, case["n"], 40)
    ref = rdrk.level_assign_dense(rdrk.DrainState(*map(jnp.asarray, dense)))
    lv, rounds = k7_list_model(dense, cap)
    np.testing.assert_array_equal(np.asarray(ref[0]), lv)
    assert int(ref[1]) == rounds


# -- K7 ELL's compacted form --------------------------------------------------

def k7_ell_model(state, ctas=1, one_barrier=False):
    """K7 ELL (ops/csrc/levels.cu) step by step, in PyTorch.  The
    prologue gates each edge once (``_ell_blocking``), takes each row's
    base level and its critical parent by the level0 * N + slot key, and
    lists a Stable row's Stable gating deps; a row with a gating dep
    that is neither Stable nor applied (a constant INF) lists only that
    row.  The A Stable rows are compacted in row order: a CTA of
    ``ctas`` takes a run of rows, ranks its Stable rows, and a row's
    index is its CTA's base (a scan of the CTAs' counts) plus its rank.
    Two constant rows follow them: Z = A at level 0 (every applied dep)
    and I = A + 1 at INF (every other inactive dep); both point at
    themselves with off 0, so a parent that is inactive jumps by a
    constant.  Then the rounds of the shared engine over the A + 2 rows,
    the clamp and the round cap on the padded N; with ``one_barrier``
    each row computes its parent's relax itself.  Returns (levels,
    rounds, A, E)."""
    torch = pdrk.torch
    inf = pdrk.LEVEL_INF
    blocking, j = pdrk._ell_blocking(state)
    st = state.status.long()
    n, d = j.shape
    stable = st == STABLE
    sj = st[j]
    lv0 = torch.where(sj == STABLE, 1, torch.where(sj == APPLIED, 0, inf))
    best = torch.where(blocking, lv0 * n + j, -1).max(dim=1).values
    act = blocking & (sj == STABLE)
    has_inf = (blocking & (lv0 == inf)).any(dim=1)
    # the compaction: a CTA's run of rb rows, its ranks, the bases
    rb = -(-n // ctas)
    blk = torch.arange(n) // rb
    total = torch.bincount(blk[stable], minlength=ctas)
    base = torch.cumsum(total, 0) - total
    before = torch.cumsum(stable.long(), 0) - stable.long()
    lrank = before - before[torch.clamp(blk * rb, max=n - 1)]
    cidx = base[blk] + lrank
    a = int(total.sum())
    z, i_inf, r = a, a + 1, a + 2
    rows = torch.nonzero(stable)[:, 0]
    # the lists (compacted indices, -1 padded) and the walks
    lists = torch.where(act, cidx[j], -1)[rows]
    lists = torch.where(has_inf[rows, None],
                        torch.where(torch.arange(d) == 0, i_inf, -1), lists)
    e_total = int((lists >= 0).sum())
    cls = torch.div(best, n, rounding_mode="floor")
    par = torch.where(best < 0, cidx, torch.where(
        cls == 0, z, torch.where(cls == 1, cidx[best % n], i_inf)))[rows]
    lists = torch.cat([lists, torch.full((2, d), -1)])
    ptr = torch.cat([par, torch.tensor([z, i_inf])])
    off = (ptr != torch.arange(r)).long()
    lv = torch.cat([torch.ones(a, dtype=torch.long),
                    torch.tensor([0, inf])])

    def relax(lv, k):
        """Row k's relax from levels ``lv``: rows at 0 or INF keep theirs."""
        got = torch.where(lists[k] >= 0, lv[torch.clamp(lists[k], min=0)], 0)
        nw = torch.maximum(torch.clamp(1 + got.max(dim=1).values, max=inf),
                           lv[k])
        return torch.where((lv[k] >= 1) & (lv[k] < inf), nw, lv[k])

    rounds, changed, every = 0, True, torch.arange(r)
    while changed and rounds < n + 3:
        mid = relax(lv, every)
        mid_p = relax(lv, ptr) if one_barrier else mid[ptr]
        new = torch.where(off > 0, torch.maximum(
            mid, torch.clamp(off + mid_p, max=inf)), mid)
        new = torch.where(new > n, inf, new)
        off, ptr = torch.clamp(off + off[ptr], max=inf), ptr[ptr]
        changed, lv, rounds = bool((new != lv).any()), new, rounds + 1
    out = torch.where(st == APPLIED, 0, inf)
    out[rows] = lv[:a]
    return out, rounds, a, e_total


def _holes_and_duplicates(ell, seed):
    """``ell`` with -1 holes between a row's deps and some deps repeated:
    the same gating set, another layout (the reference reads either)."""
    idx = ell[0]
    rng = np.random.default_rng(seed)
    n, d = idx.shape
    out = np.full((n, 2 * d), -1, np.int32)
    for i in range(n):
        deps = [int(x) for x in idx[i] if x >= 0]
        row = []
        for x in deps:
            row += [x] * int(rng.integers(1, 3))
            if rng.random() < 0.5:
                row.append(-1)
        out[i, :len(row)] = row[:2 * d]
    return (out,) + tuple(ell[1:])


ELL_MODEL_CASES = {
    **{name: (case, case["n"], 40) for name, case in EDGE_CASES.items()},
    "fanin33_d33": (fanin_case(n=70, fan=33), 70, 33),
    "chain_d1": (chain_case(45), 45, 1),
    "chain_d1_unapplied_head": (chain_case(40, applied_head=False), 40, 1),
    "awaits_cycle": ({"n": 4, "edges": [(1, 2), (2, 1), (3, 2)],
                      "status": [APPLIED, STABLE, STABLE, STABLE],
                      "msb": [0, 1, 2, 3], "node": [1, 1, 1, 1],
                      "awaits": [False, True, False, False]}, 37, 8),
    "self_dep_awaits": ({"n": 3, "edges": [(1, 1), (2, 1)],
                         "status": [APPLIED, STABLE, STABLE],
                         "msb": [0, 1, 2], "node": [1, 1, 1],
                         "awaits": [False, True, False]}, 33, 4),
    "no_stable": ({"n": 5, "edges": [(1, 0), (2, 1)],
                   "status": [APPLIED, COMMITTED, TRANSITIVE, FREE,
                              INVALIDATED],
                   "msb": [0, 1, 2, 3, 4], "node": [1] * 5,
                   "awaits": [False] * 5}, 5, 2),
    **{f"random{s}": (make_case(np.random.default_rng(9100 + s)), N_PAD,
                      D_PAD) for s in range(6)},
}


@pytest.mark.parametrize("ctas,one_barrier", [(1, False), (3, True)])
@pytest.mark.parametrize("name", sorted(ELL_MODEL_CASES))
def test_level_ell_compacted_model_equal(name, ctas, one_barrier):
    """K7 ELL's compacted form (gate once, fold the inactive deps, the
    Stable rows and two constant rows, the shared rounds) against the
    reference's ``level_assign_ell``: levels and the round count
    byte-equal (tolerance zero), on the edge cases (fan-in past 32, D = 1
    and 33, awaits cycles, a self-dep, all blocked, no Stable row, N not
    a multiple of 32): one CTA with the engine's two barriers a round (the
    first CTA's and K7 dense's grid form), three CTAs with one (K7 ELL's
    grid form)."""
    case, n_pad, d_pad = ELL_MODEL_CASES[name]
    _dense, ell = _arrays(case, n_pad, d_pad)
    ref = rdrk.level_assign_ell(rdrk.EllDrainState(*map(jnp.asarray, ell)))
    st = convert.tables_from_numpy({"ell": ell}, "cpu")["ell"]
    lv, rounds, a, e = k7_ell_model(st, ctas, one_barrier)
    np.testing.assert_array_equal(np.asarray(ref[0]), lv.numpy())
    assert int(ref[1]) == rounds
    assert a == int((st.status == STABLE).sum())
    assert e <= a * d_pad


@pytest.mark.parametrize("seed", range(4))
def test_level_ell_holes_and_duplicates_equal(seed):
    """-1 holes inside a row and repeated deps: the reference, the port's
    plain version and the compacted model agree, byte-equal."""
    case = make_case(np.random.default_rng(9300 + seed))
    _dense, ell = _arrays(case, N_PAD, D_PAD)
    ell = _holes_and_duplicates(ell, seed)
    ref = rdrk.level_assign_ell(rdrk.EllDrainState(*map(jnp.asarray, ell)))
    st = convert.tables_from_numpy({"ell": ell}, "cpu")["ell"]
    _eq(ref, pdrk.level_assign_ell(st))
    lv, rounds, _a, _e = k7_ell_model(st, 3, True)
    np.testing.assert_array_equal(np.asarray(ref[0]), lv.numpy())
    assert int(ref[1]) == rounds
