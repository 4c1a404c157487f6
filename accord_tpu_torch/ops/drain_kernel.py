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
ELL (``adj_idx`` int32[N, D], -1 padded) for large in-flight sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .deps_kernel import (SLOT_APPLIED, SLOT_COMMITTED, SLOT_FREE,
                          SLOT_INVALIDATED, SLOT_STABLE)
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
