// K4: one sweep of the execution-drain frontier; K6: the same sweep over
// S stores in one launch.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   frontier_ell    <- ready_frontier_ell (:173) with _ell_blocking (:157)
//   frontier_dense  <- ready_frontier (:133) with blocking_matrix (:74)
//   fused_frontier_ell   <- fused_ready_frontier_ell (:244)
//   fused_frontier_dense <- fused_ready_frontier (:214)
// ready[i] = status[i] == Stable and no dep j of row i that gates it
// (undecided, executing before i, or i awaits all deps; neither
// invalidated nor free) is still unapplied.
//
// Bound on this card: bytes — the ELL sweep reads N*D dep indices and
// gathers the deps' status/executeAt columns; the dense sweep reads the
// N*N adjacency bytes once.  At the drain tick's sizes (N = 64) the bound
// is far below a launch, so the dense sweep's time is its launch and its
// host path (see ops/kernels.py, the planned launch).  Design: one thread
// per waiter row for ELL.  Dense: one warp per Stable row, each lane
// loading 16 bytes of the row a step (a warp covers 512 bytes), the
// adjacency read as aligned 16-byte chunks with the bytes outside the row
// masked (a row of N bytes need not start on a chunk), the dependency
// test run only on the set bytes, and a warp vote for "some gating dep is
// unapplied" that ends the row early; a CTA's eight rows are written as
// one 8-byte word where they can be (the output may be a pinned host
// buffer, written over the bus).  The fused sweeps keep a thread a row
// (ELL) and a warp a row, a byte a lane (dense), and put the store on
// blockIdx.y; each store is read where it lies through a table of its
// base pointers and sizes, and the reference's padding is applied by
// rule: rows at or past a store's n_i are FREE (never ready), ELL edges
// past its degree d_i read as -1, dense columns past n_i are no edge.
// One launch per group.
#include "common.cuh"

namespace {

struct DrainArgs {
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int64_t N;
};

__device__ __forceinline__ bool blocks(const DrainArgs& a, int64_t i,
                                       int64_t j) {
  const int32_t sj = a.status[j];
  if (sj == SLOT_INVALIDATED || sj == SLOT_FREE || sj == SLOT_APPLIED)
    return false;
  const bool undecided = sj >= 0 && sj < SLOT_COMMITTED;
  return undecided || a.awaits[i] ||
         ts_lt(a.emsb[j], a.elsb[j], a.enode[j], a.emsb[i], a.elsb[i],
               a.enode[i]);
}

__global__ void __launch_bounds__(256)
frontier_ell(DrainArgs a, const int32_t* adj, int64_t D, uint8_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.N) return;
  bool ready = a.status[i] == SLOT_STABLE;
  for (int64_t d = 0; ready && d < D; ++d) {
    const int32_t j = adj[i * D + d];
    if (j >= 0 && blocks(a, i, j)) ready = false;
  }
  out[i] = ready;
}

// the set (non-zero) bytes of a 16-byte chunk as a 16-bit mask, byte k
// at bit k
__device__ __forceinline__ uint32_t set_bytes(const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t t = w[q] | (w[q] >> 4);
    t |= t >> 2;
    t |= t >> 1;
    t &= 0x01010101u;          // bit 0 of each byte: the byte is set
    bits |= ((t * 0x01020408u) >> 24) << (4 * q);   // gather to 4 bits
  }
  return bits;
}

constexpr int DENSE_ROWS = 8;   // rows (warps) a frontier_dense CTA

__global__ void __launch_bounds__(32 * DENSE_ROWS)
frontier_dense(DrainArgs a, const uint8_t* adj, uint8_t* out) {
  __shared__ __align__(8) uint8_t row_ready[DENSE_ROWS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i0 = (int64_t)blockIdx.x * DENSE_ROWS;
  const int64_t i = i0 + w;
  bool ready = false;
  if (i < a.N) {   // whole warps take a row
    // the row's bytes [r0, r1) counted from the 16-byte boundary at or
    // below the adjacency's start; the row's own fields and its first
    // chunk are read together, before the Stable test
    const uint4* chunks = (const uint4*)((uintptr_t)adj & ~(uintptr_t)15);
    const int64_t r0 = (int64_t)((uintptr_t)adj & 15) + i * a.N;
    const int64_t r1 = r0 + a.N;
    const int64_t c1 = (r1 + 15) >> 4;
    int64_t c = (r0 >> 4) + lane;
    uint4 v = c < c1 ? __ldg(chunks + c) : make_uint4(0, 0, 0, 0);
    const int32_t si = __ldg(a.status + i);
    const int64_t em = __ldg(a.emsb + i), el = __ldg(a.elsb + i);
    const int32_t en = __ldg(a.enode + i);
    const bool aw = __ldg(a.awaits + i);
    ready = si == SLOT_STABLE;
    bool waiting = false;
    while (ready && !waiting) {
      bool w_ = false;
      if (c < c1) {
        const int64_t p = c << 4;
        const int lo = (int)max64(r0 - p, 0), hi = (int)min64(r1 - p, 16);
        uint32_t bits =
            set_bytes(v) & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
        while (bits && !w_) {
          const int k = __ffs(bits) - 1;
          bits &= bits - 1u;
          // a dependency's four fields read together
          const int64_t j = p + k - r0;
          const int32_t sj = a.status[j];
          const int64_t jm = a.emsb[j], jl = a.elsb[j];
          const int32_t jn = a.enode[j];
          w_ = sj != SLOT_INVALIDATED && sj != SLOT_FREE &&
               sj != SLOT_APPLIED &&
               ((sj >= 0 && sj < SLOT_COMMITTED) || aw ||
                ts_lt(jm, jl, jn, em, el, en));
        }
      }
      waiting = __any_sync(0xffffffffu, w_);
      c += 32;
      if (c - lane >= c1) break;   // the row is read (uniform in the warp)
      if (c < c1) v = __ldg(chunks + c);
    }
    ready = ready && !waiting;
  }
  if (lane == 0) row_ready[w] = ready;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int64_t rows = min64(DENSE_ROWS, a.N - i0);
    uint8_t* o = out + i0;
    if (rows == DENSE_ROWS && ((uintptr_t)o & 7) == 0) {
      *(uint2*)o = *(const uint2*)row_ready;
    } else {
      for (int r = 0; r < rows; ++r) o[r] = row_ready[r];
    }
  }
}

// one store of a fused group: adj, status, exec_msb, exec_lsb, exec_node,
// awaits_all base pointers, then its rows n and its adjacency width
// (degree d for ELL, n for dense) — the wrapper's table row
struct DrainRef {
  const void* adj;
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int64_t n, width;
};
static_assert(sizeof(DrainRef) == 8 * 8, "DrainRef is 8 int64 words");

__device__ __forceinline__ DrainArgs ref_args(const DrainRef& r) {
  DrainArgs a;
  a.status = r.status;
  a.emsb = r.emsb;
  a.elsb = r.elsb;
  a.enode = r.enode;
  a.awaits = r.awaits;
  a.N = r.n;
  return a;
}

__global__ void __launch_bounds__(256)
fused_frontier_ell(const DrainRef* refs, int64_t n_max, uint8_t* out) {
  const DrainRef r = refs[blockIdx.y];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_max) return;
  bool ready = i < r.n && r.status[i] == SLOT_STABLE;
  if (ready) {
    const DrainArgs a = ref_args(r);
    const int32_t* adj = (const int32_t*)r.adj;
    for (int64_t d = 0; ready && d < r.width; ++d) {
      const int32_t j = adj[i * r.width + d];
      if (j >= 0 && blocks(a, i, j)) ready = false;
    }
  }
  out[blockIdx.y * n_max + i] = ready;
}

__global__ void __launch_bounds__(256)
fused_frontier_dense(const DrainRef* refs, int64_t n_max, uint8_t* out) {
  const DrainRef r = refs[blockIdx.y];
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n_max) return;   // whole warps exit together
  const bool stable = i < r.n && r.status[i] == SLOT_STABLE;
  bool waiting = false;
  if (stable) {
    const DrainArgs a = ref_args(r);
    const uint8_t* row = (const uint8_t*)r.adj + i * r.n;
    for (int64_t j0 = 0; j0 < r.n && !waiting; j0 += 32) {
      const int64_t j = j0 + lane;
      const bool w = j < r.n && row[j] && blocks(a, i, j);
      waiting = __any_sync(0xffffffffu, w);
    }
  }
  if (lane == 0) out[blockIdx.y * n_max + i] = stable && !waiting;
}

DrainArgs args(void* const* p, const int64_t* v) {
  DrainArgs a;
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  a.N = v[0];
  return a;
}

}  // namespace

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, out bool[N]
// vals: N, D
ACCORD_EXPORT int accord_frontier_ell(void* const* p, const int64_t* v,
                                      void* stream) {
  const DrainArgs a = args(p, v);
  if (a.N > 0)
    frontier_ell<<<(unsigned)((a.N + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(a, (const int32_t*)p[0], v[1],
                                           (uint8_t*)p[6]);
  return (int)cudaGetLastError();
}

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       out bool[N] (device memory, or pinned host memory the card maps)
// vals: N
ACCORD_EXPORT int accord_frontier_dense(void* const* p, const int64_t* v,
                                        void* stream) {
  const DrainArgs a = args(p, v);
  if (a.N > 0)
    frontier_dense<<<(unsigned)((a.N + DENSE_ROWS - 1) / DENSE_ROWS),
                     32 * DENSE_ROWS, 0, (cudaStream_t)stream>>>(
        a, (const uint8_t*)p[0], (uint8_t*)p[6]);
  return (int)cudaGetLastError();
}

// ptrs: refs DrainRef[S] (adj = adj_idx int32[n_i*d_i]), out bool[S*n_max]
// vals: S, n_max
ACCORD_EXPORT int accord_fused_frontier_ell(void* const* p, const int64_t* v,
                                            void* stream) {
  const int64_t S = v[0], n_max = v[1];
  if (S > 0 && n_max > 0)
    fused_frontier_ell<<<dim3((unsigned)((n_max + 255) / 256), (unsigned)S),
                         256, 0, (cudaStream_t)stream>>>(
        (const DrainRef*)p[0], n_max, (uint8_t*)p[1]);
  return (int)cudaGetLastError();
}

// ptrs: refs DrainRef[S] (adj = bool[n_i*n_i]), out bool[S*n_max]
// vals: S, n_max
ACCORD_EXPORT int accord_fused_frontier_dense(void* const* p,
                                              const int64_t* v,
                                              void* stream) {
  const int64_t S = v[0], n_max = v[1];
  if (S > 0 && n_max > 0)
    fused_frontier_dense<<<dim3((unsigned)((n_max * 32 + 255) / 256),
                                (unsigned)S),
                           256, 0, (cudaStream_t)stream>>>(
        (const DrainRef*)p[0], n_max, (uint8_t*)p[1]);
  return (int)cudaGetLastError();
}
