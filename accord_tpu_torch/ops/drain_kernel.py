"""Execution drain: executeAt-gated Kahn fixpoint over the dependency
graph, its log-depth forms and the priced router between them.

Rebuild of ref: accord-core/src/main/java/accord/local/Commands.java:656-857
(maybeExecute / updateDependencyAndMaybeExecute / NotifyWaitingOn); the JAX
package's ``accord_tpu/ops/drain_kernel.py`` is the reference, and every
function here keeps its name, signature and return tuple.

The Accord execution rule (local/Command.java WaitingOn): a Stable txn i may
execute when every dependency j with ``executeAt(j) < executeAt(i)`` has
Applied; dependencies that execute after i, or were invalidated, are removed
from the waiting set; undecided (not-yet-Committed) dependencies always
block, and a row that awaits all deps (ExclusiveSyncPoint / EphemeralRead)
waits on every live dep regardless of order.  The static blocking relation

    B[i, j]  = adj[i, j] & (undecided[j] | exec(j) < exec(i) | awaits_all[i])
                         & ~(invalidated[j] | free[j])

gives one frontier sweep, ``ready = stable & ~applied & ~any_j(B & ~applied)``,
in two forms: dense (``adj`` bool[N, N], at most DENSE_MAX live slots) and
ELL (``adj_idx`` int32[N, D], -1 padded) for large in-flight sets; the
fused forms sweep S stores' states in one launch.

The fixpoint oracles (``drain`` / ``drain_levels``, ``drain_ell`` /
``drain_ell_levels``) iterate that sweep until nothing is ready: each sweep
applies a whole antichain of the executeAt order and reads only the
previous sweep's applied set, so the loop runs depth + 1 times
(``sweeps`` counts the final empty sweep).  They are the byte-exact
oracles every other route is held to.

The log-depth level pass (``level_assign_ell`` / ``level_assign_dense``)
gives each slot its execution round — 0 applied, 1..N the sweep that would
apply it, ``LEVEL_INF`` blocked forever — by a Bellman relax interleaved
with pointer jumps along each row's critical-parent chain: O(log depth)
rounds on chains.  The drain is then one masked compare (``level < INF``,
or ``level <= W`` for the watermark prefix, which equals W fixpoint
sweeps).  ``drain_dense_logsq`` closes the blocked-reachability relation
by repeated boolean squaring instead, and ``dense_to_ell`` re-forms a dense
state for the ELL level pass.

``drain_ell_auto`` / ``drain_auto`` route between these forms by a priced
model: once-per-process probe slopes (``drain_calibration``, measured on
the port's own kernels) times each shape's observed depth and rounds —
never a threshold.  ``ACCORD_TPU_DRAIN=fixpoint`` pins the fixpoint
oracle everywhere; a device fault inside a log-depth launch fails the
call over to the fixpoint with the same bytes.

On a CPU tensor each kernel entry point takes its ``*_plain`` version
(``ops/kernels.py``); on a CUDA tensor it launches the hand-written
kernel from ``ops/csrc`` or raises.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..utils import faults
from .deps_kernel import (SLOT_APPLIED, SLOT_COMMITTED, SLOT_FREE,
                          SLOT_INVALIDATED, SLOT_STABLE, _pad1, launch_check)
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


def ready_frontier(state: DrainState, out=None) -> torch.Tensor:
    """Dense frontier sweep (CUDA kernel on a CUDA tensor); ``out``, a
    bool[N] on the state's device or in pinned host memory, takes the
    flags in place of a new tensor."""
    from . import kernels
    return kernels.frontier_dense(state, out=out)


def ready_frontier_ell(state: EllDrainState, out=None) -> torch.Tensor:
    """ELL frontier sweep (CUDA kernel on a CUDA tensor); ``out``, a
    bool[N] on the state's device or in pinned host memory, takes the
    flags in place of a new tensor."""
    from . import kernels
    return kernels.frontier_ell(state, out=out)


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


def fused_ready_frontier(states, out=None) -> torch.Tensor:
    """One launch sweeping S dense states (CUDA kernel on CUDA tensors);
    ``out``, a bool[S, n_max] on the states' device or in pinned host
    memory, takes the flags in place of a new tensor."""
    from . import kernels
    return kernels.fused_frontier_dense(states, out=out)


def fused_ready_frontier_ell(states, out=None) -> torch.Tensor:
    """One launch sweeping S ELL states (CUDA kernel on CUDA tensors);
    ``out``, a bool[S, n_max] on the states' device or in pinned host
    memory, takes the flags in place of a new tensor."""
    from . import kernels
    return kernels.fused_frontier_ell(states, out=out)


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


# -- the fixpoint drains (the oracles) -----------------------------------------

def _sweeps(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def _fix_loop(state, waiting):
    """The fixpoint loop of the reference's ``_drain_fix`` /
    ``_drain_ell_fix``: (applied, newly, sweeps).  Each sweep reads the
    previous sweep's applied set (``waiting(applied)``: some gating dep is
    unapplied); ``sweeps`` counts every sweep, the final empty one
    included (depth + 1)."""
    stable = state.status == SLOT_STABLE
    applied0 = state.status == SLOT_APPLIED
    applied, sweeps, more = applied0, 0, True
    while more:
        ready = stable & ~applied & ~waiting(applied)
        applied = applied | ready
        more, sweeps = bool(ready.any()), sweeps + 1
    return applied, applied & ~applied0, _sweeps(sweeps, applied.device)


def _drain_fix_plain(state: DrainState):
    blocking = blocking_matrix(state)
    return _fix_loop(state, lambda applied:
                     (blocking & ~applied[None, :]).any(dim=1))


def _drain_ell_fix_plain(state: EllDrainState):
    blocking, j = _ell_blocking(state)
    return _fix_loop(state, lambda applied:
                     (blocking & ~applied[j]).any(dim=1))


def _drain_fix(state: DrainState):
    """Dense fixpoint (CUDA kernel on a CUDA tensor): (applied, newly,
    sweeps int32[])."""
    from . import kernels
    return kernels.drain_fix_dense(state)


def drain(state: DrainState):
    """Run the drain to fixpoint: (applied bool[N], newly bool[N])."""
    applied, newly, _ = _drain_fix(state)
    return applied, newly


def drain_levels(state: DrainState):
    """Forensic variant of :func:`drain`: (applied, newly, sweeps)."""
    return _drain_fix(state)


def _drain_ell_fix(state: EllDrainState):
    """ELL fixpoint (CUDA kernel on a CUDA tensor)."""
    from . import kernels
    return kernels.drain_fix_ell(state)


def drain_ell(state: EllDrainState):
    """Fixpoint drain over the ELL adjacency: (applied, newly)."""
    applied, newly, _ = _drain_ell_fix(state)
    return applied, newly


def drain_ell_levels(state: EllDrainState):
    """Forensic variant of :func:`drain_ell`: (applied, newly, sweeps)."""
    return _drain_ell_fix(state)


# -- the log-depth drains ------------------------------------------------------
#
# The level pass above gives every slot's execution round in O(log depth)
# rounds; the drain is then one masked compare over the levels.  On the
# card each drain is one launch, as each is one program in the reference:
# K7's, with the compare and the depth as its epilogue.

def level_drain_plain(status, lv, watermark=None):
    """The level-to-drain epilogue: (applied, newly, depth int32[]).
    ``applied = applied0 | (stable & lv < INF)`` — ``lv <= watermark`` when
    one is given — and ``depth`` the largest finite level (0 if none)."""
    stable = status == SLOT_STABLE
    applied0 = status == SLOT_APPLIED
    ok = lv < LEVEL_INF if watermark is None else lv <= watermark
    applied = applied0 | (stable & ok)
    finite = torch.where(lv < LEVEL_INF, lv, torch.zeros_like(lv))
    depth = (finite.max() if finite.numel()
             else torch.zeros((), dtype=torch.int32, device=lv.device))
    return applied, applied & ~applied0, depth.to(torch.int32)


def _drain_ell_logdepth_full(state: EllDrainState):
    """(applied, newly, rounds, depth) by the ELL level pass (one launch
    on a CUDA tensor: the level pass with its drain epilogue)."""
    from . import kernels
    return kernels.level_drain_ell(state)


def drain_ell_logdepth(state: EllDrainState):
    """Log-depth drain over the ELL adjacency: (applied, newly, rounds) —
    applied/newly byte-identical to :func:`drain_ell_levels`."""
    applied, newly, rounds, _depth = _drain_ell_logdepth_full(state)
    return applied, newly, rounds


def _drain_dense_logdepth_full(state: DrainState):
    from . import kernels
    return kernels.level_drain_dense(state)


def drain_logdepth(state: DrainState):
    """Dense-state analogue of :func:`drain_ell_logdepth`."""
    applied, newly, rounds, _depth = _drain_dense_logdepth_full(state)
    return applied, newly, rounds


def drain_ell_watermark(state: EllDrainState, watermark):
    """Apply every Stable slot whose round is <= ``watermark`` (an int or a
    0-d tensor) in one shot — byte-identical to ``watermark`` fixpoint
    sweeps: (applied, newly)."""
    from . import kernels
    applied, newly, _rounds, _depth = kernels.level_drain_ell(state,
                                                              watermark)
    return applied, newly


def drain_dense_watermark(state: DrainState, watermark):
    """Dense-state analogue of :func:`drain_ell_watermark`."""
    from . import kernels
    applied, newly, _rounds, _depth = kernels.level_drain_dense(state,
                                                                watermark)
    return applied, newly


def drain_dense_logsq_plain(state: DrainState):
    """The reference's ``drain_dense_logsq``: a Stable row is blocked
    forever iff it reaches — through Stable deps along blocking edges — a
    dep that never applies or a blocking cycle.  Squaring the step matrix
    closes every path length; ``squarings`` counts the final unchanged
    pass.  Exact boolean arithmetic: the counts of the float32 products
    are integers far below 2^24, and "> 0.5" is "some path"."""
    blocking = blocking_matrix(state)
    stable = state.status == SLOT_STABLE
    applied0 = state.status == SLOT_APPLIED
    bad = ~stable & ~applied0
    step = blocking & stable[None, :]
    hit = (blocking & bad[None, :]).any(dim=1)
    f32 = torch.float32
    s, squarings, more = step, 0, True
    while more:
        s2 = ((s.to(f32) @ s.to(f32)) > 0.5) | s
        more, s, squarings = bool((s2 != s).any()), s2, squarings + 1
    targets = hit | torch.diagonal(s)        # on_cycle: i reaches i
    blocked = targets | ((s.to(f32) @ targets.to(f32)) > 0.5)
    applied = applied0 | (stable & ~blocked)
    return applied, applied & ~applied0, _sweeps(squarings, applied.device)


def drain_dense_logsq(state: DrainState):
    """Dense log-squaring drain (CUDA kernel on a CUDA tensor): (applied,
    newly, squarings) with applied/newly byte-identical to
    :func:`drain_levels`."""
    from . import kernels
    return kernels.logsq_dense(state)


# -- dense -> ELL ------------------------------------------------------------

def _dense_degree_plain(adj: torch.Tensor) -> torch.Tensor:
    """int32[]: the largest row degree of a dense adjacency."""
    if adj.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=adj.device)
    return adj.sum(dim=1).max().to(torch.int32)


def _dense_degree(adj: torch.Tensor) -> torch.Tensor:
    from . import kernels
    return kernels.dense_degree(adj)


def _pow2_deg(d: int) -> int:
    out = 4
    while out < d:
        out *= 2
    return out


def dense_to_ell_plain(adj: torch.Tensor, d: int) -> torch.Tensor:
    """int32[N, d]: each row's first ``d`` set columns, ascending, -1
    after them (the reference's scatter-max into ``cumsum - 1`` slots)."""
    slot = torch.cumsum(adj.to(torch.int32), dim=1) - 1
    rows, cols = (adj & (slot < d)).nonzero(as_tuple=True)
    out = torch.full((adj.shape[0], d), -1, dtype=torch.int32,
                     device=adj.device)
    out[rows, slot[rows, cols].long()] = cols.to(torch.int32)
    return out


def dense_to_ell(state: DrainState,
                 max_degree: Optional[int] = None) -> EllDrainState:
    """Re-form a dense DrainState as the equivalent EllDrainState (same slot
    indexing, same edges; a row with more than the width keeps its first
    ``d`` deps).  Only the max degree (one device reduction) crosses to
    the host, and only when ``max_degree`` is not given."""
    from . import kernels
    if max_degree is None:
        max_degree = int(_dense_degree(state.adj))
    d = _pow2_deg(max(int(max_degree), 1))
    return EllDrainState(kernels.dense_to_ell(state.adj, d), state.status,
                         state.exec_msb, state.exec_lsb, state.exec_node,
                         state.awaits_all)


# -- routing: priced, never thresholds ---------------------------------------

DRAIN_ENV = "ACCORD_TPU_DRAIN"


def drain_logdepth_enabled() -> bool:
    """``ACCORD_TPU_DRAIN=fixpoint`` (or fix/off/0/false/no) pins the
    fixpoint oracle in every routed drain and keeps the drain tick's
    widened wavefront off.  Default on."""
    return os.environ.get(DRAIN_ENV, "").strip().lower() not in (
        "fixpoint", "fix", "off", "0", "false", "no")


# process-wide probe coefficients (seconds per element); injectable via
# set_drain_calibration
_DRAIN_CALIB = None

# per-shape observed graph stats from prior routed calls: the depth a
# fixpoint would pay and the rounds the doubling pass paid
_ROUTE_STATS = {}

_COUNTERS = {"drain_logdepth": 0, "drain_fixpoint": 0,
             "drain_logdepth_failovers": 0, "fused_front_evictions": 0}


def drain_counters() -> dict:
    """The reference's drain counter set, with the same keys.
    ``fused_front_evictions`` stays 0 for good: a fused sweep is one
    hand-written kernel for any group shapes, so the port has no
    compiled-program cache to evict from."""
    return dict(_COUNTERS)


def reset_drain_routing() -> None:
    """Forget learned per-shape stats and counters (calibration is kept —
    reset it via set_drain_calibration)."""
    _ROUTE_STATS.clear()
    for k in _COUNTERS:
        _COUNTERS[k] = 0


def set_drain_calibration(c_sweep_ell: float, c_round_ell: float,
                          c_sweep_dense: float, c_sq_dense: float,
                          c_conv: float) -> None:
    global _DRAIN_CALIB
    _DRAIN_CALIB = {"c_sweep_ell": c_sweep_ell, "c_round_ell": c_round_ell,
                    "c_sweep_dense": c_sweep_dense, "c_sq_dense": c_sq_dense,
                    "c_conv": c_conv}


def _chain_cols(n: int, device):
    hlc = torch.arange(2, n + 2, dtype=torch.int64, device=device)
    return (torch.full((n,), SLOT_STABLE, dtype=torch.int32, device=device),
            hlc, torch.zeros(n, dtype=torch.int64, device=device),
            torch.ones(n, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device))


def _probe_chain_ell(n: int, d: int = 4, device="cuda") -> EllDrainState:
    adj_idx = torch.full((n, d), -1, dtype=torch.int32, device=device)
    adj_idx[1:, 0] = torch.arange(n - 1, dtype=torch.int32, device=device)
    return EllDrainState(adj_idx, *_chain_cols(n, device))


def _probe_chain_dense(n: int, device="cuda") -> DrainState:
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    r = torch.arange(1, n, device=device)
    adj[r, r - 1] = True
    return DrainState(adj, *_chain_cols(n, device))


def _block(t: torch.Tensor) -> torch.Tensor:
    """Wait for ``t`` (the reference's ``jax.block_until_ready``)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def _measure_drain_calibration(device="cuda") -> dict:
    """The once-per-process micro-probe behind the drain route: times one
    fixpoint sweep, one doubling round, one dense sweep, one dense squaring
    and the dense->ELL re-form on small known-depth chains (the port's own
    kernels on ``device``), and divides by their element counts.  The
    crossover between fixpoint and doubling IS these slopes."""
    import statistics as _st
    import time as _time

    def timed(fn, reps=3):
        fn()                                     # warm (and build)
        runs = []
        for _ in range(reps):
            t0 = _time.perf_counter()
            fn()
            runs.append(_time.perf_counter() - t0)
        return _st.median(runs)

    n, d = 256, 4
    ell = _probe_chain_ell(n, d, device)
    sweeps = int(drain_ell_levels(ell)[2])
    t_fix = timed(lambda: _block(drain_ell_levels(ell)[0]))
    c_sweep_ell = max(t_fix, 1e-9) / (sweeps * n * d)
    rounds = int(_drain_ell_logdepth_full(ell)[2])
    t_dbl = timed(lambda: _block(_drain_ell_logdepth_full(ell)[0]))
    c_round_ell = max(t_dbl, 1e-9) / (max(rounds, 1) * n * d)
    dense = _probe_chain_dense(n, device)
    sweeps_d = int(drain_levels(dense)[2])
    t_fixd = timed(lambda: _block(drain_levels(dense)[0]))
    c_sweep_dense = max(t_fixd, 1e-9) / (sweeps_d * n * n)
    sq = int(drain_dense_logsq(dense)[2])
    t_sq = timed(lambda: _block(drain_dense_logsq(dense)[0]))
    c_sq_dense = max(t_sq, 1e-9) / (max(sq, 1) * n * n * n)
    t_conv = timed(lambda: _block(dense_to_ell(dense, 1).adj_idx))
    c_conv = max(t_conv, 1e-9) / (n * n)
    return {"c_sweep_ell": c_sweep_ell, "c_round_ell": c_round_ell,
            "c_sweep_dense": c_sweep_dense, "c_sq_dense": c_sq_dense,
            "c_conv": c_conv}


def drain_calibration(device="cuda") -> dict:
    """The probe slopes, measured once per process on ``device`` (the
    routed drains pass their state's)."""
    global _DRAIN_CALIB
    if _DRAIN_CALIB is None:
        _DRAIN_CALIB = _measure_drain_calibration(device)
    return _DRAIN_CALIB


def _rounds_depth(rounds: torch.Tensor, depth: torch.Tensor) -> tuple:
    """(int rounds, int depth) of a log-depth drain: one device-to-host
    transfer where the two are adjacent words of one buffer (the fused
    drains' on the card), else one read each."""
    if rounds.is_cuda and depth.data_ptr() == rounds.data_ptr() + 4 \
            and rounds.dtype is depth.dtype is torch.int32 \
            and depth.untyped_storage().data_ptr() == \
            rounds.untyped_storage().data_ptr():
        r, d = rounds.as_strided((2,), (1,)).tolist()
        return r, d
    return int(rounds), int(depth)


def _record_stats(key, depth: int, rounds: Optional[int]) -> None:
    st = _ROUTE_STATS.setdefault(key, {})
    st["depth"] = depth
    if rounds is not None:
        st["rounds"] = rounds


def drain_ell_auto(state: EllDrainState):
    """The routed ELL drain: (applied, newly, sweeps, route).  Prices the
    doubling pass against the per-sweep fixpoint from the probe slopes and
    this shape's observed depth/rounds; an unseen shape runs the doubling
    pass first and the measurement becomes the price.  A device fault
    inside the log-depth launch fails the call over to the fixpoint route —
    byte-identical results, one counter tick."""
    n, d = state.adj_idx.shape
    key = ("ell", n, d)
    route = "ell-logdepth"
    if not drain_logdepth_enabled():
        route = "ell-fixpoint"
    else:
        st = _ROUTE_STATS.get(key)
        if st is not None and "rounds" in st:
            cal = drain_calibration(state.status.device)
            cost_fix = (st["depth"] + 1) * n * d * cal["c_sweep_ell"]
            cost_dbl = (st["rounds"] + 1) * n * d * cal["c_round_ell"]
            if cost_fix < cost_dbl:
                route = "ell-fixpoint"
    if route == "ell-logdepth":
        try:
            launch_check("drain logdepth")
            applied, newly, rounds, depth = _drain_ell_logdepth_full(state)
            faults.check("transfer", "drain logdepth download")
            rounds, depth = _rounds_depth(rounds, depth)
            _record_stats(key, depth, rounds)
            _COUNTERS["drain_logdepth"] += 1
            return applied, newly, rounds, route
        except faults.DEVICE_EXCEPTIONS:
            _COUNTERS["drain_logdepth_failovers"] += 1
            route = "ell-fixpoint-failover"
    applied, newly, sweeps = drain_ell_levels(state)
    sweeps = int(sweeps)
    _record_stats(key, sweeps - 1, None)
    _COUNTERS["drain_fixpoint"] += 1
    return applied, newly, sweeps, route


def drain_auto(state):
    """The routed drain for either representation: (applied, newly, sweeps,
    route).  Dense states price three ways — the dense fixpoint, the dense
    reachability log-squaring, and re-forming to ELL for the doubling pass
    — against this shape's observed depth; ELL states route via
    :func:`drain_ell_auto`."""
    if isinstance(state, EllDrainState):
        return drain_ell_auto(state)
    n = state.status.shape[0]
    key = ("dense", n)
    route = "dense-to-ell-logdepth"
    if not drain_logdepth_enabled():
        route = "dense-fixpoint"
    else:
        st = _ROUTE_STATS.get(key)
        if st is not None and "rounds" in st:
            cal = drain_calibration(state.status.device)
            d = st.get("ell_d", 4)
            cost_fix = (st["depth"] + 1) * n * n * cal["c_sweep_dense"]
            sq = max(int(st["depth"]).bit_length() + 1, 2)
            cost_sq = sq * n * n * n * cal["c_sq_dense"]
            cost_dbl = n * n * cal["c_conv"] + \
                (st["rounds"] + 1) * n * d * cal["c_round_ell"]
            costs = {"dense-fixpoint": cost_fix, "dense-logsq": cost_sq,
                     "dense-to-ell-logdepth": cost_dbl}
            route = min(costs, key=costs.get)
    if route == "dense-to-ell-logdepth":
        try:
            launch_check("drain logdepth")
            ell = dense_to_ell(state)
            applied, newly, rounds, depth = _drain_ell_logdepth_full(ell)
            faults.check("transfer", "drain logdepth download")
            rounds, depth = _rounds_depth(rounds, depth)
            _record_stats(key, depth, rounds)
            _ROUTE_STATS[key]["ell_d"] = ell.adj_idx.shape[1]
            _COUNTERS["drain_logdepth"] += 1
            return applied, newly, rounds, route
        except faults.DEVICE_EXCEPTIONS:
            _COUNTERS["drain_logdepth_failovers"] += 1
            route = "dense-fixpoint-failover"
    if route == "dense-logsq":
        try:
            launch_check("drain logsq")
            applied, newly, sq = drain_dense_logsq(state)
            faults.check("transfer", "drain logsq download")
            _COUNTERS["drain_logdepth"] += 1
            return applied, newly, int(sq), route
        except faults.DEVICE_EXCEPTIONS:
            _COUNTERS["drain_logdepth_failovers"] += 1
            route = "dense-fixpoint-failover"
    applied, newly, sweeps = drain_levels(state)
    sweeps = int(sweeps)
    _record_stats(key, sweeps - 1, None)
    _COUNTERS["drain_fixpoint"] += 1
    return applied, newly, sweeps, route
