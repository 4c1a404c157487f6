"""The port's frontier sweeps (K4 dense / ELL) against the JAX package's
``ready_frontier`` / ``ready_frontier_ell`` on seeded DAGs shaped like the
``tests/test_drain_logdepth.py`` generators: undecided deps, invalidated
and free slots, Committed-but-not-Stable deps, ``awaits_all`` rows (the
only way blocking cycles exist) and executeAt ties.

K4a's walk (``csrc/frontier.cu`` ``ell_cta`` / ``ell_row_ready``),
modelled in PyTorch: a thread a row, ``ACCORD_FRONTIER_ELL_ROWS`` rows a
CTA; a Stable row's edges in chunks of ``ACCORD_FRONTIER_ELL_CHUNK``, each
chunk's dependency statuses read together, then the executeAt of the
first live decided one alone, then of the others only where it did not
settle the row; the walk stops at the first chunk with a gating
dependency unapplied; each CTA stores its rows' flags.  Held to the
reference at D = 1, 3, 4, 8, 32, 33 and 64 on 300 rows (a whole number
of no CTA's rows), with rows of every status, ``awaits_all`` rows and -1
edges mid-row.  The CPU wrappers' ``out``: checked, filled and returned.

CPU only: the port takes its plain versions here; tolerance zero (bool
masks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu_torch.ops import _build, convert
from accord_tpu_torch.ops import drain_kernel as pdrk
from accord_tpu_torch.ops import kernels

STATUSES = np.array([-1, 0, 1, 2, 3, 4, 4, 4, 5, 5, 6], np.int32)
WORDS = np.array([0, 1, 5, (1 << 48) - 1, np.iinfo(np.int64).max,
                  np.iinfo(np.int64).min, -1], np.int64)


def _case(seed, n):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    for i in range(1, n):
        for _ in range(int(rng.integers(0, 4))):
            adj[i, int(rng.integers(0, i))] = True      # DAG backbone
    for _ in range(int(rng.integers(0, 4))):
        a, b = rng.integers(0, n, 2)
        if a != b:
            adj[a, b] = True                            # possible cycle
    status = rng.choice(STATUSES, n).astype(np.int32)
    # a small msb range forces executeAt ties; boundary words test the
    # unsigned order; node breaks some ties
    msb = np.where(rng.random(n) < 0.2, rng.choice(WORDS, n),
                   rng.integers(0, 6, n)).astype(np.int64)
    lsb = np.where(rng.random(n) < 0.2, rng.choice(WORDS, n),
                   rng.integers(0, 2, n)).astype(np.int64)
    node = rng.integers(1, 3, n).astype(np.int32)
    awaits = rng.random(n) < 0.15
    return adj, status, msb, lsb, node, awaits


def _ell(adj):
    n = adj.shape[0]
    deg = int(adj.sum(axis=1).max(initial=0))
    d = 4
    while d < max(deg, 1):
        d *= 2
    idx = np.full((n, d), -1, np.int32)
    for i in range(n):
        cols = np.nonzero(adj[i])[0]
        idx[i, :len(cols)] = cols
    return idx


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [16, 48])
def test_frontier_dense_and_ell_equal(seed, n):
    adj, status, msb, lsb, node, awaits = _case(seed * 101 + n, n)
    dense = (adj, status, msb, lsb, node, awaits)
    ref = rdrk.ready_frontier(rdrk.DrainState(*map(jnp.asarray, dense)))
    port = pdrk.ready_frontier(
        convert.tables_from_numpy({"drain": dense}, "cpu")["drain"])
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
    ell = (_ell(adj), status, msb, lsb, node, awaits)
    ref_e = rdrk.ready_frontier_ell(
        rdrk.EllDrainState(*map(jnp.asarray, ell)))
    port_e = pdrk.ready_frontier_ell(
        convert.tables_from_numpy({"ell": ell}, "cpu")["ell"])
    np.testing.assert_array_equal(np.asarray(ref_e), port_e.numpy())
    # the two forms agree with each other too
    np.testing.assert_array_equal(port.numpy(), port_e.numpy())
    assert port.dtype == torch.bool


def _ref_frontier(dense):
    return np.asarray(rdrk.ready_frontier(
        rdrk.DrainState(*map(jnp.asarray, dense))))


@pytest.mark.parametrize("n", [16, 64, 200])
def test_frontier_dense_into_out_equal(n):
    """The drain tick's form, ``ready_frontier(state, out=buf)``: the
    flags land in ``buf`` (the mirror keeps one for the tick), equal to
    ``ready_frontier(state)`` and to the reference's."""
    dense = _case(n * 7 + 3, n)
    st = convert.tables_from_numpy({"drain": dense}, "cpu")["drain"]
    buf = torch.ones(n, dtype=torch.bool)
    assert pdrk.ready_frontier(st, out=buf) is buf
    np.testing.assert_array_equal(_ref_frontier(dense), buf.numpy())
    np.testing.assert_array_equal(pdrk.ready_frontier(st).numpy(),
                                  buf.numpy())


def test_planned_state_after_scalar_scatter():
    """A planned DrainState (``kernels.checked_cols``) gives the
    reference's frontier, and again after the drain mirror's in-place
    scatter of status and executeAt rows: its plan (the columns'
    pointers) still holds."""
    n = 48
    dense = [a.copy() for a in _case(5, n)]
    st = kernels.checked_cols(
        convert.tables_from_numpy({"drain": dense}, "cpu")["drain"])
    plan = st._plan
    np.testing.assert_array_equal(_ref_frontier(dense),
                                  pdrk.ready_frontier(st).numpy())
    rng = np.random.default_rng(77)
    rows = np.sort(rng.choice(n, 9, replace=False)).astype(np.int32)
    new = [rng.choice(STATUSES, 9).astype(np.int32),
           rng.integers(0, 6, 9).astype(np.int64),
           rng.choice(WORDS, 9).astype(np.int64),
           rng.integers(1, 3, 9).astype(np.int32)]
    kernels.scatter_rows([st.status, st.exec_msb, st.exec_lsb,
                          st.exec_node], rows, new)
    for c, a in zip((1, 2, 3, 4), new):
        dense[c][rows] = a
    assert st._plan is plan and plan[1] == [c.data_ptr() for c in st]
    np.testing.assert_array_equal(_ref_frontier(dense),
                                  pdrk.ready_frontier(st).numpy())


# -- K4a / K6 ELL: the kernel's walk -----------------------------------------

STABLE, APPLIED = 4, 5
ROWS = kernels.FRONTIER_ELL_ROWS
CHUNK = _build.GEOMETRY["ACCORD_FRONTIER_ELL_CHUNK"]


def _u(x):
    return x ^ (-1 << 63)       # the unsigned order of an int64 word


def ell_walk_model(state, ctas: int, n_out: int, last: bool):
    """K4a's CTAs 0 .. ctas - 1 on ``state`` (an EllDrainState of n rows
    and degree D), a thread a row: a Stable row walks its edges CHUNK at
    a time, reading the chunk's dependency statuses, then the executeAt
    of its first live decided dependency (none where an undecided one or
    awaits_all already gates), then the others' where that did not gate,
    and stops at the first chunk that gates; each CTA stores its first
    min(ROWS, n_out - i0) flags and, ``last``, its rows past its own up
    to n_out false.  Returns (flags bool[n_out], writes per row
    int[n_out], dependency status reads, executeAt reads, the live
    decided dependencies of the walked chunks, chunks walked per row)."""
    adj, status = state.adj_idx, state.status
    n, d = adj.shape
    steps = max(1, -(-d // CHUNK))
    # one padding row (FREE, no edges) for the threads past n
    pad = torch.full((n + 1, steps * CHUNK), -1, dtype=torch.int32)
    pad[:n, :d] = adj
    cols = [torch.cat([c, torch.zeros(1, dtype=c.dtype)])
            for c in (status, state.exec_msb, state.exec_lsb,
                      state.exec_node, state.awaits_all)]
    cols[0][n] = -1
    stat, msb, lsb, node, aw = cols
    i = torch.arange(ctas * ROWS)
    ic = torch.where(i < n, i, n)
    stable = stat[ic] == STABLE
    walking, blocked = stable.clone(), torch.zeros_like(stable)
    walked = torch.zeros(len(i), dtype=torch.int64)
    status_reads = exec_reads = needed = 0
    for k in range(steps):
        walked += walking
        j = pad[ic, k * CHUNK:(k + 1) * CHUNK]
        go = walking[:, None] & (j >= 0)
        jc = torch.where(go, j.long(), n)
        sj = stat[jc]
        live = go & (sj != 6) & (sj != -1) & (sj != APPLIED)
        undecided = (sj >= 0) & (sj < 3)
        w = (live & (undecided | aw[ic][:, None])).any(dim=1)
        need = live & ~undecided & ~aw[ic][:, None]
        first = need & (torch.cumsum(need.long(), dim=1) == 1)
        rest = need & ~first
        am, bm = msb[jc], msb[ic][:, None]
        al, bl = lsb[jc], lsb[ic][:, None]
        lt = (_u(am) < _u(bm)) | ((am == bm) & (
            (_u(al) < _u(bl)) | ((al == bl) & (node[jc] < node[ic][:, None]))))
        w1 = ~w & (first & lt).any(dim=1)
        w2 = ~w & ~w1 & (rest & lt).any(dim=1)
        status_reads += int(go.sum())
        needed += int(need.sum())
        exec_reads += int((first & ~w[:, None]).sum()) + int(
            (rest & (~w & ~w1)[:, None]).sum())
        gate = w | w1 | w2
        blocked |= walking & gate
        walking = walking & ~gate & ((k + 1) * CHUNK < d)
    ready = stable & ~blocked
    out = torch.zeros(n_out, dtype=torch.bool)
    writes = torch.zeros(n_out, dtype=torch.int64)
    put = i < n_out
    out[i[put]] = ready[put]
    writes[i[put]] += 1
    if last:
        writes[ctas * ROWS:] += 1
    return out, writes, status_reads, exec_reads, needed, walked


def _ell_case(seed, n, d):
    """An ELL drain state of every status, ``awaits_all`` rows, executeAt
    ties and -1 edges anywhere in a row; a third of the rows depend only
    on applied, invalidated or free slots, and a third also on decided
    slots that execute after them, so that rows of every degree are
    ready."""
    rng = np.random.default_rng(seed)
    status = rng.choice(STATUSES, n).astype(np.int32)
    msb = rng.integers(0, 4, n).astype(np.int64)
    lsb = np.where(rng.random(n) < 0.1, rng.choice(WORDS, n),
                   rng.integers(0, 2, n)).astype(np.int64)
    node = rng.integers(1, 3, n).astype(np.int32)
    awaits = rng.random(n) < 0.15
    done = np.nonzero(np.isin(status, (-1, 5, 6)))[0]
    idx = rng.integers(0, n, (n, d)).astype(np.int32)
    for i in range(n):
        kind = i % 3
        if kind and len(done):
            idx[i] = rng.choice(done, d)
        if kind == 2:
            later = np.nonzero((status >= 3) & (status <= 4)
                               & (msb > msb[i]))[0]
            if len(later):
                k = rng.integers(0, d + 1)
                idx[i, :k] = rng.choice(later, k)
                rng.shuffle(idx[i])
    idx[rng.random((n, d)) < 0.2] = -1
    return idx, status, msb, lsb, node, awaits


@pytest.mark.parametrize("d", [1, 3, 4, 8, 32, 33, 64])
def test_ell_walk_model_equals_reference(d):
    """The walk model's flags equal the reference's at degree d on 300
    rows (every row written once, by its CTA); the first live decided
    dependency's executeAt saves reads of the others; past one chunk
    some rows stop at their first and some walk every chunk."""
    n = 300
    ell = _ell_case(4400 + d, n, d)
    ref = np.asarray(rdrk.ready_frontier_ell(
        rdrk.EllDrainState(*map(jnp.asarray, ell))))
    st = convert.tables_from_numpy({"ell": ell}, "cpu")["ell"]
    assert n % ROWS != 0
    got, writes, reads, exec_reads, needed, walked = ell_walk_model(
        st, -(-n // ROWS), n, False)
    np.testing.assert_array_equal(ref, got.numpy())
    np.testing.assert_array_equal(pdrk.ready_frontier_ell(st).numpy(), ref)
    assert (writes == 1).all()
    assert 0 < ref.sum() < (ell[1] == STABLE).sum()
    assert 0 < exec_reads <= needed and reads <= int((ell[0] >= 0).sum())
    if d >= 8:
        assert exec_reads < needed
    if d > CHUNK:
        stable = torch.from_numpy(ell[1][:n] == STABLE)
        w = walked[:n][stable]
        assert (w == 1).any() and (w == -(-d // CHUNK)).any()
    else:
        assert walked.max() == 1


@pytest.mark.parametrize("kind", ["ell", "dense", "fused_ell",
                                  "fused_dense"])
def test_frontier_out_on_cpu(kind):
    """``out=`` on the CPU wrappers: the flags land in ``out``, which is
    returned; a tensor of another dtype or shape, or on no CPU, raises."""
    cases = [_case(900 + k, n) for k, n in enumerate((40, 17))]
    sts = [convert.tables_from_numpy({"drain": c, "ell": (_ell(c[0]),)
                                      + c[1:]}, "cpu") for c in cases]
    form = "ell" if kind.endswith("ell") else "drain"
    fn = {"ell": kernels.frontier_ell, "dense": kernels.frontier_dense,
          "fused_ell": kernels.fused_frontier_ell,
          "fused_dense": kernels.fused_frontier_dense}[kind]
    arg = [st[form] for st in sts] if kind.startswith("fused") \
        else sts[0][form]
    want = fn(arg)
    buf = torch.ones(want.shape, dtype=torch.bool)
    assert fn(arg, out=buf) is buf
    assert torch.equal(buf, want)
    for bad in (torch.zeros(want.shape, dtype=torch.uint8),
                torch.zeros(want.numel() + 1, dtype=torch.bool),
                torch.zeros(want.shape, dtype=torch.bool,
                            device="meta")):
        with pytest.raises(ValueError):
            fn(arg, out=bad)
