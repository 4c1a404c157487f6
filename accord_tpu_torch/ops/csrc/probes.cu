// Latency probes: the cost of one grid barrier of a cooperative grid, of
// one block barrier with a shared-memory round trip, and of two dependent
// L2 reads and a block barrier, each measured as an empty loop of
// ``iters`` steps; and an empty kernel, the floor of a short call.
//
// Replaces no kernel of the JAX reference.  chip_smoke.py times them to
// price the per-sweep floor of the fixpoint drains (K8, K13): a Jacobi
// sweep that ends on grid.sync() cannot cost less than the grid barrier,
// a level finished inside one CTA cannot cost less than a block barrier
// plus the shared-memory counter it reads, and one whose dependents lists
// lie in global memory (K8 ELL) not less than its two dependent reads (a
// row's offset, then its dependents) and the barrier.  The empty kernel,
// launched through the planned launch path of ops/kernels.py, is what a
// short call such as the drain tick's dense frontier (K4b) cannot beat:
// the host path and one launch with no work.  Bound: latency, not bytes
// or operations.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

struct ProbeArgs {
  int32_t* out;
  int64_t iters;
};

__global__ void grid_probe(ProbeArgs a) {
  cg::grid_group grid = cg::this_grid();
  for (int64_t r = 0; r < a.iters; ++r) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.out = (int32_t)gridDim.x;
}

// each step: thread 0 bumps one of three rotating counters and clears the
// one after, a block barrier, then every thread reads the bumped counter
// (the bookkeeping of one level of a frontier held in shared memory)
__global__ void block_probe(ProbeArgs a) {
  __shared__ int32_t cnt[3];
  if (threadIdx.x < 3) cnt[threadIdx.x] = 0;
  __syncthreads();
  int32_t seen = 0;
  for (int64_t r = 0; r < a.iters; ++r) {
    if (threadIdx.x == 0) {
      atomicAdd(&cnt[(r + 1) % 3], 1);
      cnt[(r + 2) % 3] = 0;
    }
    __syncthreads();
    seen += *(volatile int32_t*)&cnt[(r + 1) % 3];
  }
  if (threadIdx.x == 0) *a.out = seen;
}

// each step: thread 0 follows two links of a chain in global memory
// (from L2: __ldcg) into one of two rotating slots, a block barrier, then
// every thread reads the slot
__global__ void chase_probe(ProbeArgs a, const int32_t* chain) {
  __shared__ int32_t at[2];
  if (threadIdx.x == 0) at[1] = 0;
  __syncthreads();
  int32_t seen = 0;
  for (int64_t r = 0; r < a.iters; ++r) {
    if (threadIdx.x == 0)
      at[r & 1] = __ldcg(chain + __ldcg(chain + at[(r + 1) & 1]));
    __syncthreads();
    seen += *(volatile int32_t*)&at[r & 1];
  }
  if (threadIdx.x == 0) *a.out = seen;
}

__global__ void empty_probe() {}

}  // namespace

// ptrs, vals: none read; one empty kernel of one warp
ACCORD_EXPORT int accord_empty_probe(void* const*, const int64_t*,
                                     void* stream) {
  empty_probe<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// ptrs: out int32[1] (grid: the blocks launched; else what was read),
//       then (mode 2) chain int32[n], chain[i] the next index of a cycle
// vals: mode (0 grid barrier, 1 block barrier, 2 two dependent L2 reads
//       and a block barrier), blocks wanted (grid mode), threads a block,
//       iters
ACCORD_EXPORT int accord_sync_probe(void* const* p, const int64_t* v,
                                    void* stream) {
  ProbeArgs a;
  a.out = (int32_t*)p[0];
  a.iters = v[3];
  const int nt = (int)v[2];
  if (nt < 32 || nt > 1024 || nt % 32 || a.iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (v[0] == 0) return launch_cooperative(grid_probe, nt, v[1], a, st);
  if (v[0] == 2) chase_probe<<<1, nt, 0, st>>>(a, (const int32_t*)p[1]);
  else block_probe<<<1, nt, 0, st>>>(a);
  return (int)cudaGetLastError();
}
