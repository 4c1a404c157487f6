// K10: re-forming a dense drain adjacency as ELL rows.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   dense_degree <- _dense_degree (:524): max over rows of the row's degree
//   dense_to_ell <- the convert program of dense_to_ell (:539, :554)
// Output, equal to the reference: int32[N, d] holding each row's first d
// set columns in ascending order and -1 after them (the reference
// scatter-maxes every set column into slot cumsum - 1 and drops the slots
// at or past d: a row with more than d deps is truncated).
//
// Design: a warp per row.  dense_degree: lanes count their bytes, a warp
// sum, one atomicMax.  dense_to_ell: lanes read 32 consecutive columns, a
// ballot gives the set ones and a popcount below each lane its slot; the
// warp stops once d columns are placed, then fills the rest with -1.
// Bound on this card: bytes — the N*N adjacency read once (dense_to_ell
// stops early on rows that reach d) and N*d int32 written.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
degree_kernel(const uint8_t* adj, int64_t N, int32_t* out) {
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nwarps = ((int64_t)gridDim.x * NT) >> 5;
  const int lane = threadIdx.x & 31;
  for (int64_t i = tid >> 5; i < N; i += nwarps) {
    int32_t c = 0;
    for (int64_t j = lane; j < N; j += 32) c += adj[i * N + j] ? 1 : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0 && c > 0) atomicMax(out, c);
  }
}

__global__ void __launch_bounds__(NT)
to_ell_kernel(const uint8_t* adj, int64_t N, int64_t d, int32_t* out) {
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nwarps = ((int64_t)gridDim.x * NT) >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1;
  for (int64_t i = tid >> 5; i < N; i += nwarps) {
    int64_t placed = 0;
    for (int64_t c0 = 0; c0 < N && placed < d; c0 += 32) {
      const int64_t j = c0 + lane;
      const bool set = j < N && adj[i * N + j];
      const uint32_t m = __ballot_sync(0xffffffffu, set);
      const int64_t slot = placed + __popc(m & below);
      if (set && slot < d) out[i * d + slot] = (int32_t)j;
      placed += __popc(m);
    }
    for (int64_t s = min64(placed, d) + lane; s < d; s += 32)
      out[i * d + s] = -1;
  }
}

unsigned warp_blocks(int64_t n) {
  int64_t b = (n * 32 + NT - 1) / NT;
  if (b > 4096) b = 4096;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

// ptrs: adj bool[N*N], degree int32[1]
// vals: N
ACCORD_EXPORT int accord_dense_degree(void* const* p, const int64_t* v,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* out = (int32_t*)p[1];
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  degree_kernel<<<warp_blocks(v[0]), NT, 0, st>>>((const uint8_t*)p[0], v[0],
                                                   out);
  return (int)cudaGetLastError();
}

// ptrs: adj bool[N*N], out int32[N*d]
// vals: N, d
ACCORD_EXPORT int accord_dense_to_ell(void* const* p, const int64_t* v,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  to_ell_kernel<<<warp_blocks(v[0]), NT, 0, st>>>((const uint8_t*)p[0], v[0],
                                                   v[1], (int32_t*)p[1]);
  return (int)cudaGetLastError();
}
