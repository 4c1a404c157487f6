"""The port's frontier sweeps (K4 dense / ELL) against the JAX package's
``ready_frontier`` / ``ready_frontier_ell`` on seeded DAGs shaped like the
``tests/test_drain_logdepth.py`` generators: undecided deps, invalidated
and free slots, Committed-but-not-Stable deps, ``awaits_all`` rows (the
only way blocking cycles exist) and executeAt ties.  CPU only: the port
takes its plain versions here; tolerance zero (bool masks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu_torch.ops import convert
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
