"""Device data plane of the PyTorch/CUDA port.

- packing: packed-timestamp compare helpers (torch) and host packers
- deps_kernel: PreAccept dependency scan types, host packers and the plain
  PyTorch versions of the deps kernels
- drain_kernel: the execution-drain frontier sweep types and plain versions
- kernels: the single place that sends a call to its CUDA kernel (tensor on
  a CUDA device) or to its plain version (tensor on the CPU)
- _build: compiles ``csrc/*.cu`` with nvcc and loads the library

Nothing heavy is imported here: the copied protocol modules import
``ops.packing`` for its host helpers alone.
"""
