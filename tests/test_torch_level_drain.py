"""The port's log-depth drains as one launch each (K7 with K9's level-drain
epilogue: ``kernels.level_drain_ell`` / ``level_drain_dense``) and K10's
dense -> ELL row walk, against the JAX package's.

The fused drains are held, flags, rounds and depth, to the reference's
``_drain_ell_logdepth_full``, ``_drain_dense_logdepth_full``,
``drain_ell_watermark`` and ``drain_dense_watermark`` on seeded drain
graphs (``tests/test_torch_level_assign.py``'s generator), with the
watermark an int and a 0-d tensor, and on edge inputs: no Stable row
(depth 0), every Stable row blocked (all INF), watermarks of 0, at the
largest level and above it, N not a multiple of 32.  A PyTorch model of
where the kernel writes the epilogue (ELL's inactive rows in the
prologue, the compacted Stable rows where their levels are written, the
depth by CTA maxima) is held to the reference too.

K10: a PyTorch model of the kernel's walk (a warp a row, 32 lanes each
taking a 16-byte chunk a step, the chunks counted from the 16-byte
boundary at or below the matrix's start, the bytes outside the row
masked, a warp exclusive scan of the lanes' set-byte counts for their
first slots, slots at or past d not written, the walk stopped by the
count once d columns are placed) against ``dense_to_ell_plain`` and the
reference's convert: N of 1, 17, 45, 300 and 600, rows of 4,096 bytes, a
misaligned matrix start, d of 1, 4, 8 and 64 and d > N, rows with 0, d - 1,
d, d + 1 and N deps and a set byte in a row's last byte.  CPU only: the
port takes its plain versions here; tolerance zero (bools and integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.ops import drain_kernel as rdrk
from accord_tpu_torch.ops import convert, kernels
from accord_tpu_torch.ops import drain_kernel as pdrk
from tests.test_torch_level_assign import (APPLIED, COMMITTED, D_PAD, N_PAD,
                                           PREACCEPTED, _arrays, chain_case,
                                           make_case)


def _states(dense, ell):
    ref = (rdrk.DrainState(*map(jnp.asarray, dense)),
           rdrk.EllDrainState(*map(jnp.asarray, ell)))
    st = convert.tables_from_numpy({"drain": dense, "ell": ell}, "cpu")
    return ref, (st["drain"], st["ell"])


def _eq(ref, port):
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        r, p = np.asarray(r), p.numpy()
        assert r.shape == p.shape
        if r.dtype == bool or p.dtype == bool:
            assert r.dtype == p.dtype
        np.testing.assert_array_equal(r, p)


def _check_drains(ref, port, watermarks):
    (rd, re), (pd, pe) = ref, port
    _eq(rdrk._drain_ell_logdepth_full(re), kernels.level_drain_ell(pe))
    _eq(rdrk._drain_dense_logdepth_full(rd), kernels.level_drain_dense(pd))
    _eq(rdrk._drain_ell_logdepth_full(re), pdrk._drain_ell_logdepth_full(pe))
    _eq(rdrk._drain_dense_logdepth_full(rd),
        pdrk._drain_dense_logdepth_full(pd))
    for w in watermarks:
        for pw in (w, torch.tensor(w), torch.tensor(w, dtype=torch.int32)):
            _eq(rdrk.drain_ell_watermark(re, w),
                pdrk.drain_ell_watermark(pe, pw))
            _eq(rdrk.drain_dense_watermark(rd, jnp.int32(w)),
                pdrk.drain_dense_watermark(pd, pw))
        # the fused calls' rounds and depth do not depend on the watermark
        got = kernels.level_drain_ell(pe, w)
        _eq(rdrk._drain_ell_logdepth_full(re)[2:], got[2:])
        assert pdrk._rounds_depth(got[2], got[3]) == (int(got[2]),
                                                      int(got[3]))


@pytest.mark.parametrize("seed", range(3))
def test_fused_drains_equal_reference(seed):
    case = make_case(np.random.default_rng(9300 + seed))
    ref, port = _states(*_arrays(case, N_PAD, D_PAD))
    _check_drains(ref, port, (0, 1, 2, case["n"]))


def _no_stable(n=45):
    rng = np.random.default_rng(9401)
    case = make_case(rng)
    case["n"] = n
    case["edges"] = [(i, int(j)) for i in range(1, n)
                     for j in rng.integers(0, i, 2)]
    case["status"] = [APPLIED if i % 3 else COMMITTED for i in range(n)]
    case["msb"] = list(range(n))
    case["node"] = [1] * n
    case["awaits"] = [False] * n
    return case


def _all_blocked(n=45):
    """Stable rows whose chain ends at an undecided dep: every level INF."""
    case = chain_case(n, applied_head=False)
    case["status"][0] = PREACCEPTED
    return case


EDGE_CASES = {
    "no stable rows": _no_stable,
    "all blocked": _all_blocked,
    "chain 45": lambda: chain_case(45),
    "chain 45 no applied head": lambda: chain_case(45, applied_head=False),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_fused_drain_edges_equal_reference(name):
    """N = 45 (not a multiple of 32); watermarks of 0, the largest level,
    past it, and INF (which takes the blocked rows too)."""
    case = EDGE_CASES[name]()
    n = case["n"]
    ref, port = _states(*_arrays(case, n, 4))
    depth = int(rdrk._drain_ell_logdepth_full(ref[1])[3])
    _check_drains(ref, port, (0, depth, depth + 5, pdrk.LEVEL_INF))
    got = kernels.level_drain_ell(port[1])
    if name == "no stable rows":
        assert int(got[3]) == 0 and not got[1].any()
    if name == "all blocked":
        assert int(got[3]) == 0 and not got[0].any()
        stable = port[1].status == pdrk.SLOT_STABLE
        assert torch.equal(
            kernels.level_drain_ell(port[1], pdrk.LEVEL_INF)[1], stable)


def epilogue_model_ell(state, watermark=None, ctas=1):
    """Where K7 ELL's epilogue writes: each inactive row's flags in the
    prologue (applied = status == APPLIED, newly = 0), each Stable row's
    (compacted in row order) where the engine writes its final level, by
    ``ctas`` CTAs of rows (one: the first CTA's block max; more: a CTA's
    max by atomicMax into a depth word zeroed first).  Every row is
    written exactly once.  Returns (applied, newly, rounds, depth)."""
    lv, rounds = pdrk.level_assign_ell_plain(state)
    status = state.status
    n = status.shape[0]
    w = pdrk.LEVEL_INF - 1 if watermark is None else int(watermark)
    unset = torch.full((n,), 2, dtype=torch.int8)
    applied, newly = unset.clone(), unset.clone()
    stable = status == pdrk.SLOT_STABLE
    inactive = ~stable
    applied[inactive] = (status[inactive] == pdrk.SLOT_APPLIED).to(torch.int8)
    newly[inactive] = 0
    orig = torch.nonzero(stable).reshape(-1)     # the compacted rows
    depth = 0
    for part in torch.tensor_split(orig, ctas):
        levels = lv[part]
        assert (applied[part] == 2).all() and (newly[part] == 2).all()
        ok = (levels.long() <= w).to(torch.int8)
        applied[part], newly[part] = ok, ok
        finite = torch.where(levels < pdrk.LEVEL_INF, levels, 0)
        depth = max(depth, int(finite.max()) if len(part) else 0)
    # no finite level other than 0 comes from an inactive row
    assert not ((lv[inactive] != 0) & (lv[inactive] < pdrk.LEVEL_INF)).any()
    assert (applied != 2).all() and (newly != 2).all()
    return (applied.bool(), newly.bool(), rounds,
            torch.tensor(depth, dtype=torch.int32))


@pytest.mark.parametrize("ctas", [1, 3])
def test_epilogue_model_equals_reference(ctas):
    rng = np.random.default_rng(9500 + ctas)
    cases = [make_case(rng) for _ in range(2)] + [_no_stable(),
                                                  _all_blocked()]
    for case in cases:
        n_pad = N_PAD if case["n"] <= N_PAD else case["n"]
        ref, port = _states(*_arrays(case, n_pad, D_PAD))
        _eq(rdrk._drain_ell_logdepth_full(ref[1]),
            epilogue_model_ell(port[1], ctas=ctas))
        _eq(rdrk.drain_ell_watermark(ref[1], 2),
            epilogue_model_ell(port[1], 2, ctas)[:2])


# -- K10: the row walk -------------------------------------------------------

def k10_walk_model(adj: torch.Tensor, d: int, offset: int = 0, rows=None):
    """K10's walk of each row in ``rows`` (all by default): the matrix's
    bytes start ``offset`` bytes into a 16-byte chunk; a step's 32 lanes
    take chunks base .. base + 31, each its set bytes inside the row and
    their count; when some lane has one (the vote), the warp's exclusive
    scan of the counts gives each lane its first slot, and a lane writes
    its set columns in byte order into the slots below d; ``placed`` grows
    by the warp's total; the walk stops once placed >= d or the row is
    read, and -1 fills the slots from min(placed, d).  Returns the rows'
    output (int32[len(rows), d]) and each row's steps."""
    n = adj.shape[0]
    rows = range(n) if rows is None else rows
    flat = torch.zeros(offset + n * n + 32 * 16, dtype=torch.bool)
    flat[offset:offset + n * n] = adj.reshape(-1)
    lanes = torch.arange(32)[:, None]
    byte = torch.arange(16)[None, :]
    out = torch.full((len(rows), d), -7, dtype=torch.int32)
    steps = []
    for o, i in enumerate(rows):
        r0 = offset + i * n
        r1 = r0 + n
        c1 = (r1 + 15) >> 4
        base, placed, k = r0 >> 4, 0, 0
        while True:
            k += 1
            chunk = base + lanes
            pos = chunk * 16 + byte                        # [32, 16]
            inside = (chunk < c1) & (pos >= r0) & (pos < r1)
            bits = flat[pos.clamp(max=flat.numel() - 1)] & inside
            cnt = bits.sum(dim=1)
            if bool(cnt.any()):
                first = placed + torch.cumsum(cnt, 0) - cnt
                slot = first[:, None] + torch.cumsum(bits, dim=1) - 1
                put = bits & (slot < d)
                s = slot[put]
                assert (out[o, s] == -7).all()             # each slot once
                out[o, s] = (pos[put] - r0).to(torch.int32)
                placed += int(cnt.sum())
            base += 32
            if placed >= d or base >= c1:
                break
        assert (out[o, :min(placed, d)] != -7).all()
        out[o, min(placed, d):] = -1
        steps.append(k)
    return out, steps


def _k10_matrix(n: int, d: int, seed: int) -> torch.Tensor:
    """Rows with 0, d - 1, d, d + 1 and n deps, a row whose one dep is its
    last byte, then random rows (as many deps as fit)."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    counts = [0, d - 1, d, d + 1, n, -1]
    for i in range(n):
        c = counts[i] if i < len(counts) else int(rng.integers(0, n + 1))
        if c == -1:
            adj[i, n - 1] = True
        elif c > 0:
            adj[i, rng.choice(n, min(c, n), replace=False)] = True
    return torch.from_numpy(adj)


@pytest.mark.parametrize("n", [1, 17, 45, 300, 600])
def test_k10_walk_model_equals_reference(n):
    for d in (1, 4, 8, 64):
        adj = _k10_matrix(n, d, 9600 + n + d)
        want = pdrk.dense_to_ell_plain(adj, d)
        for offset in (0, 7):
            got, _steps = k10_walk_model(adj, d, offset)
            assert torch.equal(got, want), (n, d, offset)
        if d >= 4 and (d == 8 or n in (1, 45)):
            # the reference's convert at this width (d > N at n = 1)
            cols = (np.zeros(n, np.int32), np.zeros(n, np.int64),
                    np.zeros(n, np.int64), np.zeros(n, np.int32),
                    np.zeros(n, bool))
            ref = rdrk.dense_to_ell(rdrk.DrainState(
                jnp.asarray(adj.numpy()), *map(jnp.asarray, cols)), d)
            np.testing.assert_array_equal(np.asarray(ref.adj_idx),
                                          want.numpy())


def test_k10_walk_stops_by_count():
    """Rows of 4,096 bytes (8 warp steps): a row that places d columns in
    its first step stops there; one with fewer deps reads every step (the
    empty steps cost the vote alone); a dep in the last byte is found."""
    n, d = 4096, 8
    adj = torch.zeros((n, n), dtype=torch.bool)
    adj[0, :d] = True
    adj[1, [5, 4000]] = True
    adj[2, n - 1] = True
    adj[3, :600] = True
    got, steps = k10_walk_model(adj, d, 3, rows=[0, 1, 2, 3, 4])
    assert torch.equal(got, pdrk.dense_to_ell_plain(adj, d)[:5])
    # a row starts 3 bytes into a chunk: 257 chunks, 9 steps to read it
    assert steps == [1, 9, 9, 1, 9]
