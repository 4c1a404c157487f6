"""The port's log-depth level pass (K7: ``level_assign_ell`` /
``level_assign_dense``) against the JAX package's, levels and rounds, on
seeded drain graphs built like the ``tests/test_drain_logdepth.py``
generators: a DAG backbone with a few arbitrary edges (cycles, which gate
only through ``awaits_all`` rows), undecided deps, invalidated and free
slots, Committed-but-not-Stable deps and executeAt ties; plus deep chains,
where the pointer jumps make the round count logarithmic.  CPU only: the
port takes its plain versions here; tolerance zero (integers)."""

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
