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
against the reference.  CPU only: the port takes its plain versions
here; tolerance zero (integers)."""

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
