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
// per waiter row for ELL.  Dense (K4b and K6 through one device function,
// dense_row_ready): one warp per Stable row, each lane loading 16 bytes
// of the row a step (common.cuh RowWalk: a warp covers 512 bytes), the
// dependency test run only on the set bytes, and a warp vote for "some
// gating dep is unapplied" that ends the row early; a CTA's eight rows
// are written as one 8-byte word where they can be (the output may be a
// pinned host buffer, written over the bus).  K6 dense takes its members
// by value (up to MAX_STORES a launch; ops/kernels.py splits a larger
// group) and runs a flat grid of (member, 8-row group) CTAs, so a small
// member costs no CTA for the rows it lacks; the reference pads each
// member to n_max with FREE rows, which are never ready, so its last CTA
// writes them false.  K6 ELL keeps a thread a row and puts the store on
// blockIdx.y, each store read where it lies through a table of its base
// pointers and sizes that its wrapper uploads; ELL edges past a store's
// degree d_i read as -1.  One launch per group.
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

constexpr int DENSE_ROWS = 8;   // rows (warps) a dense frontier CTA
// members a fused dense launch takes by value (ops/_build.py LIMITS)
constexpr int MAX_STORES = ACCORD_FUSED_MAX_STORES;

// Is row i ready: Stable, and no dependency that gates it is unapplied?
// The calling warp walks the row (RowWalk) and runs the dependency test
// on its set bytes only, each dependency's four fields read together, and
// stops at the first step whose vote finds a gating dependency unapplied;
// every lane returns the answer.  K4b and K6 dense.
__device__ __forceinline__ bool dense_row_ready(const DrainArgs& a,
                                                const uint8_t* adj, int64_t i,
                                                int lane) {
  RowWalk rw(adj, a.N, i, lane);
  const int32_t si = __ldg(a.status + i);
  const int64_t em = __ldg(a.emsb + i), el = __ldg(a.elsb + i);
  const int32_t en = __ldg(a.enode + i);
  const bool aw = __ldg(a.awaits + i);
  if (si != SLOT_STABLE) return false;
  bool waiting;
  do {
    int64_t col0;
    uint32_t bits = rw.bits(col0);
    bool w = false;
    while (bits && !w) {
      const int64_t j = col0 + __ffs(bits) - 1;
      bits &= bits - 1u;
      const int32_t sj = a.status[j];
      const int64_t jm = a.emsb[j], jl = a.elsb[j];
      const int32_t jn = a.enode[j];
      w = sj != SLOT_INVALIDATED && sj != SLOT_FREE && sj != SLOT_APPLIED &&
          ((sj >= 0 && sj < SLOT_COMMITTED) || aw ||
           ts_lt(jm, jl, jn, em, el, en));
    }
    waiting = __any_sync(0xffffffffu, w);
  } while (!waiting && rw.next());
  return !waiting;
}

// a CTA's flags for ``rows`` (at most DENSE_ROWS) rows from ``o``: one
// 8-byte store where it can be (the output may be pinned host memory,
// written over the bus)
__device__ __forceinline__ void store_flags(const uint8_t* flags,
                                            uint8_t* o, int64_t rows) {
  if (rows == DENSE_ROWS && ((uintptr_t)o & 7) == 0) {
    *(uint2*)o = *(const uint2*)flags;
  } else {
    for (int r = 0; r < rows; ++r) o[r] = flags[r];
  }
}

__global__ void __launch_bounds__(32 * DENSE_ROWS)
frontier_dense(DrainArgs a, const uint8_t* adj, uint8_t* out) {
  __shared__ __align__(8) uint8_t flags[DENSE_ROWS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i0 = (int64_t)blockIdx.x * DENSE_ROWS;
  const int64_t i = i0 + w;
  const bool ready = i < a.N && dense_row_ready(a, adj, i, lane);
  if (lane == 0) flags[w] = ready;
  __syncthreads();
  if (threadIdx.x == 0) store_flags(flags, out + i0, min64(DENSE_ROWS,
                                                           a.N - i0));
}

// one member of a fused dense launch, by value: its columns, its rows n,
// the row of its flags in the launch's output, and its first CTA (its
// DENSE_ROWS-row groups follow the members' before it)
struct FrontierMember {
  const uint8_t* adj;
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int64_t n, out, g0;
};

// a launch's members (at most MAX_STORES: 72 bytes each, 9.2 KB in all)
struct FusedFrontierParams {
  FrontierMember m[MAX_STORES];
  int64_t S, n_max;
  uint8_t* out;   // bool[S, n_max]
};

// K6 dense: a CTA a (member, DENSE_ROWS-row group) item, a flat grid of
// the members' groups (a member of n rows has max(1, ceil(n / 8))); the
// rows of each member from n to n_max are written false by its last CTA,
// which walks none of them
__global__ void __launch_bounds__(32 * DENSE_ROWS)
fused_frontier_dense(const __grid_constant__ FusedFrontierParams p) {
  __shared__ __align__(8) uint8_t flags[DENSE_ROWS];
  const int64_t g = blockIdx.x;
  int lo = 0, hi = (int)p.S - 1;   // the last member whose groups start
  while (lo < hi) {                // at or before g
    const int mid = (lo + hi + 1) >> 1;
    if (p.m[mid].g0 <= g) lo = mid; else hi = mid - 1;
  }
  const FrontierMember& m = p.m[lo];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i0 = (g - m.g0) * DENSE_ROWS;
  const int64_t i = i0 + w;
  DrainArgs a;
  a.status = m.status;
  a.emsb = m.emsb;
  a.elsb = m.elsb;
  a.enode = m.enode;
  a.awaits = m.awaits;
  a.N = m.n;
  const bool ready = i < m.n && dense_row_ready(a, m.adj, i, lane);
  if (lane == 0) flags[w] = ready;
  __syncthreads();
  uint8_t* o = p.out + m.out;
  if (threadIdx.x == 0)
    store_flags(flags, o + i0, min64(DENSE_ROWS, p.n_max - i0));
  const int64_t next = lo + 1 < p.S ? p.m[lo + 1].g0 : (int64_t)gridDim.x;
  if (g + 1 == next)
    for (int64_t r = i0 + DENSE_ROWS + threadIdx.x; r < p.n_max;
         r += blockDim.x)
      o[r] = 0;
}

// one store of a fused ELL group: adj_idx, status, exec_msb, exec_lsb,
// exec_node, awaits_all base pointers, then its rows n and its degree d
// (the wrapper's table row)
struct DrainRef {
  const int32_t* adj;
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
    for (int64_t d = 0; ready && d < r.width; ++d) {
      const int32_t j = r.adj[i * r.width + d];
      if (j >= 0 && blocks(a, i, j)) ready = false;
    }
  }
  out[blockIdx.y * n_max + i] = ready;
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

// ptrs: out bool[S*n_max] (device memory, or pinned host memory the card
//       maps)
// vals: S (at most MAX_STORES), n_max, CTAs; then 9 per member: adj
//       bool[n_i*n_i], status, exec_msb, exec_lsb, exec_node, awaits_all
//       (addresses), n_i, its flags' first row in out (member x n_max),
//       its first CTA (ops/kernels.py fused_frontier_launches)
ACCORD_EXPORT int accord_fused_frontier_dense(void* const* p,
                                              const int64_t* v,
                                              void* stream) {
  FusedFrontierParams a;
  a.S = v[0];
  a.n_max = v[1];
  a.out = (uint8_t*)p[0];
  const int64_t ctas = v[2];
  if (a.S < 1 || a.S > MAX_STORES || a.n_max < 0)
    return (int)cudaErrorInvalidValue;
  int64_t g = 0;
  for (int64_t k = 0; k < a.S; ++k) {
    const int64_t* r = v + 3 + 9 * k;
    FrontierMember& m = a.m[k];
    m.adj = (const uint8_t*)r[0];
    m.status = (const int32_t*)r[1];
    m.emsb = (const int64_t*)r[2];
    m.elsb = (const int64_t*)r[3];
    m.enode = (const int32_t*)r[4];
    m.awaits = (const uint8_t*)r[5];
    m.n = r[6];
    m.out = r[7];
    m.g0 = r[8];
    if (m.n < 0 || m.n > a.n_max || m.out != k * a.n_max || m.g0 != g)
      return (int)cudaErrorInvalidValue;
    g += max64(1, (m.n + DENSE_ROWS - 1) / DENSE_ROWS);
  }
  if (g != ctas || g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (a.n_max > 0)
    fused_frontier_dense<<<(unsigned)g, 32 * DENSE_ROWS, 0,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
