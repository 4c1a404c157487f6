"""Execution drain frontier: types and plain PyTorch versions.

Rebuild of ref: accord-core/src/main/java/accord/local/Commands.java:656-857
(maybeExecute / updateDependencyAndMaybeExecute / NotifyWaitingOn); the JAX
package's ``accord_tpu/ops/drain_kernel.py`` is the reference.

The Accord execution rule (local/Command.java WaitingOn): a Stable txn i may
execute when every dependency j with ``executeAt(j) < executeAt(i)`` has
Applied; dependencies that execute after i, or were invalidated, are removed
from the waiting set; undecided (not-yet-Committed) dependencies always
block, and a row that awaits all deps (ExclusiveSyncPoint / EphemeralRead)
waits on every live dep regardless of order.  One sweep computes the ready
frontier:

    B[i, j]  = adj[i, j] & (undecided[j] | exec(j) < exec(i) | awaits_all[i])
                         & ~(invalidated[j] | free[j])
    ready[i] = stable[i] & ~any_j (B[i, j] & ~applied[j])

in two forms: dense (``adj`` bool[N, N], at most DENSE_MAX live slots) and
ELL (``adj_idx`` int32[N, D], -1 padded) for large in-flight sets; the
fused forms sweep S stores' states in one launch.

The log-depth level pass (``level_assign_ell`` / ``level_assign_dense``)
gives each slot its execution round — 0 applied, 1..N the sweep that would
apply it, ``LEVEL_INF`` blocked forever — by a Bellman relax interleaved
with pointer jumps along each row's critical-parent chain: O(log depth)
rounds on chains.  The drain tick's widened wavefront proposes every
Stable slot with level <= W; ``ACCORD_TPU_DRAIN=fixpoint`` keeps it off.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .deps_kernel import (SLOT_APPLIED, SLOT_COMMITTED, SLOT_FREE,
                          SLOT_INVALIDATED, SLOT_STABLE, _pad1)
from .packing import ts_lt


class DrainState(NamedTuple):
    adj: torch.Tensor         # bool[N, N]  i depends on j
    status: torch.Tensor      # int32[N]    SLOT_*
    exec_msb: torch.Tensor    # int64[N]    executeAt (valid >= COMMITTED)
    exec_lsb: torch.Tensor    # int64[N]
    exec_node: torch.Tensor   # int32[N]
    awaits_all: torch.Tensor  # bool[N]     row awaits ALL deps


class EllDrainState(NamedTuple):
    adj_idx: torch.Tensor     # int32[N, D]  deps of row i, -1 padded
    status: torch.Tensor      # int32[N]
    exec_msb: torch.Tensor    # int64[N]
    exec_lsb: torch.Tensor    # int64[N]
    exec_node: torch.Tensor   # int32[N]
    awaits_all: torch.Tensor  # bool[N]


def blocking_matrix(state: DrainState) -> torch.Tensor:
    """B[i, j]: does dep j (ever) gate i's execution?"""
    undecided = (state.status >= 0) & (state.status < SLOT_COMMITTED)
    invalidated = state.status == SLOT_INVALIDATED
    free = state.status == SLOT_FREE
    exec_before = ts_lt(state.exec_msb[None, :], state.exec_lsb[None, :],
                        state.exec_node[None, :],
                        state.exec_msb[:, None], state.exec_lsb[:, None],
                        state.exec_node[:, None])   # [i, j]: exec(j) < exec(i)
    gate = undecided[None, :] | exec_before | state.awaits_all[:, None]
    return state.adj & gate & ~(invalidated | free)[None, :]


def ready_frontier_plain(state: DrainState) -> torch.Tensor:
    """One non-iterated sweep: which Stable txns are executable right now."""
    blocking = blocking_matrix(state)
    applied = state.status == SLOT_APPLIED
    waiting = (blocking & ~applied[None, :]).any(dim=1)
    return (state.status == SLOT_STABLE) & ~waiting


def _ell_blocking(state: EllDrainState):
    """B[i, d]: does dep adj_idx[i, d] gate i's execution?"""
    j = torch.clamp(state.adj_idx, min=0).to(torch.int64)
    valid = state.adj_idx >= 0
    st_j = state.status[j]
    undecided = (st_j >= 0) & (st_j < SLOT_COMMITTED)
    dead = (st_j == SLOT_INVALIDATED) | (st_j == SLOT_FREE)
    exec_before = ts_lt(state.exec_msb[j], state.exec_lsb[j],
                        state.exec_node[j],
                        state.exec_msb[:, None], state.exec_lsb[:, None],
                        state.exec_node[:, None])
    gate = undecided | exec_before | state.awaits_all[:, None]
    return valid & gate & ~dead, j


def ready_frontier_ell_plain(state: EllDrainState) -> torch.Tensor:
    blocking, j = _ell_blocking(state)
    applied_j = state.status[j] == SLOT_APPLIED
    waiting = (blocking & ~applied_j).any(dim=1)
    return (state.status == SLOT_STABLE) & ~waiting


def ready_frontier(state: DrainState) -> torch.Tensor:
    """Dense frontier sweep (CUDA kernel on a CUDA tensor)."""
    from . import kernels
    return kernels.frontier_dense(state)


def ready_frontier_ell(state: EllDrainState) -> torch.Tensor:
    """ELL frontier sweep (CUDA kernel on a CUDA tensor)."""
    from . import kernels
    return kernels.frontier_ell(state)


# -- fused sweeps over several stores (plain versions) -------------------------

def _pad_scalars(st, n: int):
    """status / executeAt / awaits columns padded to ``n`` rows: pad rows
    are FREE, so they are never Stable and never gate anything."""
    return (_pad1(st.status, n, SLOT_FREE), _pad1(st.exec_msb, n, 0),
            _pad1(st.exec_lsb, n, 0), _pad1(st.exec_node, n, 0),
            _pad1(st.awaits_all, n, False))


def fused_ready_frontier_plain(states) -> torch.Tensor:
    """The reference's ``fused_ready_frontier``: every dense state padded
    to the group's n_max (pad rows FREE, no edges), each swept alone,
    stacked: bool[S, n_max]; row i's first n_i entries are
    ready_frontier(states[i])."""
    n_max = max(st.status.shape[0] for st in states)
    out = []
    for st in states:
        n = st.status.shape[0]
        adj = st.adj
        if n < n_max:
            adj = adj.new_zeros((n_max, n_max))
            adj[:n, :n] = st.adj
        out.append(ready_frontier_plain(DrainState(adj,
                                                   *_pad_scalars(st, n_max))))
    return torch.stack(out)


def fused_ready_frontier_ell_plain(states) -> torch.Tensor:
    """ELL analogue: rows padded to n_max and edge columns to d_max with -1
    (no edge); bool[S, n_max]."""
    n_max = max(st.adj_idx.shape[0] for st in states)
    d_max = max(st.adj_idx.shape[1] for st in states)
    out = []
    for st in states:
        n, d = st.adj_idx.shape
        idx = st.adj_idx
        if (n, d) != (n_max, d_max):
            idx = idx.new_full((n_max, d_max), -1)
            idx[:n, :d] = st.adj_idx
        out.append(ready_frontier_ell_plain(
            EllDrainState(idx, *_pad_scalars(st, n_max))))
    return torch.stack(out)


def fused_ready_frontier(states) -> torch.Tensor:
    """One launch sweeping S dense states (CUDA kernel on CUDA tensors)."""
    from . import kernels
    return kernels.fused_frontier_dense(states)


def fused_ready_frontier_ell(states) -> torch.Tensor:
    """One launch sweeping S ELL states (CUDA kernel on CUDA tensors)."""
    from . import kernels
    return kernels.fused_frontier_ell(states)


# -- log-depth level assignment (plain versions) -------------------------------
#
# Each slot's execution round under the static drain: 0 applied, 1..N the
# frontier sweep that would apply it, LEVEL_INF blocked forever.  A
# Bellman relax (1 + max over blocking deps) interleaved with a pointer
# jump along each row's critical-parent chain (``ptr, off <- ptr[ptr],
# off + off[ptr]``), to a fixpoint; the widened drain tick harvests every
# Stable slot with level <= W in one sweep.

# survives ``off + level`` in int32 and ``level * n + j`` in int64
LEVEL_INF = 1 << 28


def _level_base(stable, applied0) -> torch.Tensor:
    """Initial bounds: applied 0, Stable 1, anything else INF (it never
    applies inside a static drain)."""
    one = torch.ones_like(stable, dtype=torch.int32)
    return torch.where(applied0, 0 * one,
                       torch.where(stable, one, LEVEL_INF * one))


def _level_loop(lv0, ptr0, off0, relax, n: int):
    """The doubling loop of the reference's ``_level_loop``: until no
    level changes or ``n + 3`` rounds (``n`` the padded row count).
    Returns (levels int32[N], rounds int32[])."""
    lv, ptr, off = lv0, ptr0.long(), off0
    inf = torch.full_like(lv0, LEVEL_INF)
    changed, r = True, 0
    while changed and r < n + 3:
        new = torch.where(lv < LEVEL_INF, torch.minimum(relax(lv), inf), lv)
        new = torch.maximum(new, lv)
        jumped = torch.minimum(off + new[ptr], inf)
        new = torch.where(off > 0, torch.maximum(new, jumped), new)
        new = torch.where(new > n, inf, new)
        off = torch.minimum(off + off[ptr], inf)
        ptr = ptr[ptr]
        changed = bool((new != lv).any())
        lv, r = new, r + 1
    return lv, torch.tensor(r, dtype=torch.int32, device=lv0.device)


def _critical_ptr(lv0, blocking, j, stable, n: int):
    """Each Stable row's first jump pointer: the blocking dep with the
    largest ``level * n + slot`` key (the first such column on ties);
    rows with no blocking dep, or not Stable, point at themselves with
    off 0."""
    rows = torch.arange(n, dtype=torch.int32, device=lv0.device)
    key = torch.where(blocking, lv0[j].long() * n + j,
                      torch.full_like(j, -1))
    best = torch.argmax(key, dim=1)
    pj = torch.gather(j, 1, best[:, None])[:, 0].to(torch.int32)
    ptr = torch.where(blocking.any(dim=1) & stable, pj, rows)
    return ptr, (ptr != rows).to(torch.int32)


def level_assign_ell_plain(state: EllDrainState):
    """(levels int32[N], rounds int32[]) over the ELL adjacency."""
    blocking, j = _ell_blocking(state)
    stable = state.status == SLOT_STABLE
    lv0 = _level_base(stable, state.status == SLOT_APPLIED)
    n = state.status.shape[0]
    ptr0, off0 = _critical_ptr(lv0, blocking, j, stable, n)

    def relax(lv):
        got = torch.where(blocking, lv[j], torch.zeros_like(j, dtype=lv.dtype))
        return torch.where(stable, 1 + got.max(dim=1).values, lv0)

    return _level_loop(lv0, ptr0, off0, relax, n)


def level_assign_dense_plain(state: DrainState):
    """(levels int32[N], rounds int32[]) over the dense adjacency."""
    blocking = blocking_matrix(state)
    stable = state.status == SLOT_STABLE
    lv0 = _level_base(stable, state.status == SLOT_APPLIED)
    n = state.status.shape[0]
    j = torch.arange(n, dtype=torch.int64,
                     device=lv0.device)[None, :].expand(n, n)
    ptr0, off0 = _critical_ptr(lv0, blocking, j, stable, n)

    def relax(lv):
        got = torch.where(blocking, lv[None, :], torch.zeros_like(lv)[None, :])
        return torch.where(stable, 1 + got.max(dim=1).values, lv0)

    return _level_loop(lv0, ptr0, off0, relax, n)


def level_assign_ell(state: EllDrainState):
    """Level pass over the ELL adjacency (CUDA kernel on a CUDA tensor)."""
    from . import kernels
    return kernels.level_ell(state)


def level_assign_dense(state: DrainState):
    """Level pass over the dense adjacency (CUDA kernel on a CUDA tensor)."""
    from . import kernels
    return kernels.level_dense(state)


# -- the ACCORD_TPU_DRAIN escape hatch and the drain counters -----------------

DRAIN_ENV = "ACCORD_TPU_DRAIN"


def drain_logdepth_enabled() -> bool:
    """``ACCORD_TPU_DRAIN=fixpoint`` (or fix/off/0/false/no) pins the plain
    frontier sweep: the widened log-depth tick never runs.  Default on."""
    return os.environ.get(DRAIN_ENV, "").strip().lower() not in (
        "fixpoint", "fix", "off", "0", "false", "no")


_COUNTERS = {"drain_logdepth": 0, "drain_fixpoint": 0,
             "drain_logdepth_failovers": 0, "fused_front_evictions": 0}


def drain_counters() -> dict:
    """The reference's drain counter set, with the same keys.  The routed
    drains that move the first three are not ported yet.
    ``fused_front_evictions`` stays 0 for good: a fused sweep is one
    hand-written kernel for any group shapes, so the port has no
    compiled-program cache to evict from."""
    return dict(_COUNTERS)
