"""Device data plane of the PyTorch/CUDA port.

- packing: packed-timestamp compare helpers (torch) and host packers
- deps_kernel: PreAccept dependency scan types, host packers and the plain
  PyTorch versions of the deps kernels
- drain_kernel: the execution drain — frontier sweeps, the fixpoint
  oracles, the log-depth drains, and the priced router between them
- kernels: the single place that sends a call to its CUDA kernel (tensor on
  a CUDA device) or to its plain version (tensor on the CPU)
- _build: compiles ``csrc/*.cu`` with nvcc and loads the library
"""

from .drain_kernel import (DrainState, blocking_matrix, drain, drain_auto,
                           drain_ell_auto, drain_ell_logdepth,
                           drain_logdepth, drain_logdepth_enabled,
                           level_assign_dense, level_assign_ell,
                           ready_frontier)

__all__ = [
    "DrainState", "blocking_matrix", "drain", "drain_auto", "drain_ell_auto",
    "drain_ell_logdepth", "drain_logdepth", "drain_logdepth_enabled",
    "level_assign_dense", "level_assign_ell", "ready_frontier",
]
