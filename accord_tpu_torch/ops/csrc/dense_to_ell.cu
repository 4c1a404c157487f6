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
// sum, one atomicMax.  dense_to_ell: the warp walks the row by K4b's
// 16-byte chunks (common.cuh RowWalk: 512 bytes a warp step, the next
// step's chunk in flight, the bytes outside the row masked, so a row need
// not start on a chunk); each lane takes its chunk's set bytes (up to 16)
// and their count; a warp exclusive scan of the counts (shuffles) gives
// each lane its first slot, and the lane writes its set columns, in byte
// order, into the slots below d; a step where no lane has a set byte costs
// one vote.  The walk stops by the warp's count once d columns are placed,
// then the rest is filled with -1.  (A lane a byte a step would keep one
// 32-byte request a warp in flight: 128 dependent steps for a row of
// 4,096 bytes with fewer than d deps, as config 3's chain rows are.)
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
  for (int64_t i = tid >> 5; i < N; i += nwarps) {
    int32_t* row = out + i * d;
    RowWalk rw(adj, N, i, lane);
    int64_t placed = 0;   // the row's set columns so far (every lane)
    do {
      int64_t col0 = 0;
      uint32_t bits = rw.bits(col0);
      if (!__any_sync(0xffffffffu, bits != 0)) continue;
      const int32_t n = __popc(bits);
      int32_t incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      for (int64_t slot = placed + incl - n; bits && slot < d;
           bits &= bits - 1u, ++slot)
        row[slot] = (int32_t)(col0 + __ffs(bits) - 1);
      placed += __shfl_sync(0xffffffffu, incl, 31);
    } while (placed < d && rw.next());
    for (int64_t s = min64(placed, d) + lane; s < d; s += 32) row[s] = -1;
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
