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
// Bound on this card: bytes — the ELL sweep reads the dep indices of its
// Stable rows and gathers the deps' status/executeAt columns; the dense
// sweep reads the N*N adjacency bytes once.  At the drain tick's sizes
// the bound is far below a launch, so a sweep's time is its launch, its
// host path (ops/kernels.py, the packed launch) and its chain of
// dependent reads.
//
// ELL (K4a and K6 ELL through one device function, ell_row_ready): a
// thread a row, its edges gathered in parallel.  A row reads its status
// first (a row that is not Stable reads nothing more), then its first
// ELL_CHUNK indices and its own fields together; every dependency of the
// chunk has its status read at once, the next chunk's indices in flight;
// a decided dependency usually executes before its dependent, so the
// first live decided one's executeAt is read alone, and the others' only
// when it does not settle the row (none read where an undecided
// dependency, or awaits_all, already does).  The row stops at the first
// chunk with a gating dependency unapplied.  So no edge's reads wait on
// the previous edge's verdict: a row's chain is its status, its indices,
// then two or three dependent reads a chunk.  Lanes on edges (a warp
// 32 / P rows of P lanes, a ballot a segment) measured slower on the card
// at the drain tick's [131072, 8]: eight times the threads, each paying
// the whole chain (PERF.md, K4a's row).  A CTA is ELL_ROWS rows; its
// flags leave as 16-byte stores where aligned (the output may be pinned
// host memory, written over the bus).
//
// Dense (K4b and K6 dense through dense_row_ready): one warp per Stable
// row, each lane loading 16 bytes of the row a step (common.cuh RowWalk:
// a warp covers 512 bytes), the dependency test run only on the set
// bytes, and a warp vote for "some gating dep is unapplied" that ends the
// row early; a CTA's eight rows are written as one 8-byte word where they
// can be.
//
// The fused sweeps (K6) take their members by value in one parameter (up
// to MAX_STORES a launch; ops/kernels.py splits a larger group) and run a
// flat grid of (member, row group) CTAs, so a small member costs no CTA
// for the rows it lacks; the reference pads each member to n_max with FREE
// rows, which are never ready, so its last CTA writes them false.  An ELL
// member walks its own degree d_i: the reference's edges past it are -1.
#include "common.cuh"

namespace {

struct DrainArgs {
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int64_t N;
};

// rows (threads) an ELL CTA, and the edges a thread gathers at once
constexpr int ELL_ROWS = ACCORD_FRONTIER_ELL_ROWS;
constexpr int ELL_CHUNK = ACCORD_FRONTIER_ELL_CHUNK;

// one ELL sweep's input, by value: adj_idx, status, exec_msb, exec_lsb,
// exec_node, awaits_all, its rows n and degree d; in a fused launch also
// the row of its flags in the launch's output and its first CTA
struct EllMember {
  const int32_t* adj;
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int64_t n, d, out, g0;
};

// edges c0 .. c0 + ELL_CHUNK - 1 of a row of degree d (-1 past d)
__device__ __forceinline__ void ell_chunk(const int32_t* row, int64_t d,
                                          int64_t c0,
                                          int32_t (&j)[ELL_CHUNK]) {
#pragma unroll
  for (int c = 0; c < ELL_CHUNK; ++c)
    j[c] = c0 + c < d ? __ldg(row + c0 + c) : -1;
}

// Is row i of m ready: Stable, and no dependency that gates it unapplied?
// After its status, the row's first ELL_CHUNK indices and its own fields
// are read together; then every dependency of the chunk has its status
// read at once, the next chunk's indices in flight; the executeAt of the
// first live decided one, then of the others that still decide the
// verdict (live, decided, the row not awaits_all, none of the chunk's
// gating yet), each set at once; the row stops at the first chunk with a
// gating dependency unapplied.
__device__ __forceinline__ bool ell_row_ready(const EllMember& m, int64_t i) {
  if (i >= m.n) return false;
  const int64_t D = m.d;
  const int32_t* row = m.adj + i * D;
  if (__ldg(m.status + i) != SLOT_STABLE) return false;
  int32_t j[ELL_CHUNK];
  ell_chunk(row, D, 0, j);
  const int64_t em = __ldg(m.emsb + i), el = __ldg(m.elsb + i);
  const int32_t en = __ldg(m.enode + i);
  const bool aw = __ldg(m.awaits + i);
  for (int64_t c0 = 0;;) {
    int32_t sj[ELL_CHUNK], jn[ELL_CHUNK];
#pragma unroll
    for (int c = 0; c < ELL_CHUNK; ++c)
      sj[c] = j[c] >= 0 ? __ldg(m.status + j[c]) : SLOT_FREE;
    ell_chunk(row, D, c0 + ELL_CHUNK, jn);
    bool w = false, need[ELL_CHUNK];
#pragma unroll
    for (int c = 0; c < ELL_CHUNK; ++c) {
      const bool live = sj[c] != SLOT_INVALIDATED && sj[c] != SLOT_FREE &&
                        sj[c] != SLOT_APPLIED;
      const bool undecided = sj[c] >= 0 && sj[c] < SLOT_COMMITTED;
      w = w || (live && (undecided || aw));
      need[c] = live && !undecided && !aw;
    }
    // a decided dependency usually executes before its dependent, so the
    // first one's executeAt alone settles most rows; the others' only
    // where it does not
    int32_t jf = -1;
#pragma unroll
    for (int c = 0; c < ELL_CHUNK; ++c)
      if (need[c] && jf < 0) {
        jf = j[c];
        need[c] = false;
      }
    if (!w && jf >= 0)
      w = ts_lt(__ldg(m.emsb + jf), __ldg(m.elsb + jf), __ldg(m.enode + jf),
                em, el, en);
    if (!w) {
      int64_t jm[ELL_CHUNK], jl[ELL_CHUNK];
      int32_t jo[ELL_CHUNK];
#pragma unroll
      for (int c = 0; c < ELL_CHUNK; ++c) {
        jm[c] = jl[c] = 0;
        jo[c] = 0;
        if (need[c]) {
          jm[c] = __ldg(m.emsb + j[c]);
          jl[c] = __ldg(m.elsb + j[c]);
          jo[c] = __ldg(m.enode + j[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < ELL_CHUNK; ++c)
        w = w || (need[c] && ts_lt(jm[c], jl[c], jo[c], em, el, en));
    }
    if (w) return false;
    c0 += ELL_CHUNK;
    if (c0 >= D) return true;
#pragma unroll
    for (int c = 0; c < ELL_CHUNK; ++c) j[c] = jn[c];
  }
}

// ``bytes`` zero bytes from o, by the CTA: 16-byte stores between the
// aligned ends
__device__ __forceinline__ void zero_flags(uint8_t* o, int64_t bytes) {
  if (bytes <= 0) return;
  const int64_t head = min64((int64_t)((16 - ((uintptr_t)o & 15)) & 15),
                             bytes);
  const int64_t body = (bytes - head) >> 4;
  for (int64_t r = threadIdx.x; r < head; r += blockDim.x) o[r] = 0;
  uint4* w = (uint4*)(o + head);
  for (int64_t k = threadIdx.x; k < body; k += blockDim.x)
    w[k] = make_uint4(0, 0, 0, 0);
  for (int64_t r = head + (body << 4) + threadIdx.x; r < bytes;
       r += blockDim.x)
    o[r] = 0;
}

// a CTA's ``rows`` flags from shared ``f`` (16-byte aligned) to o, by the
// CTA: 16-byte stores where o is aligned to 16, 8-byte where to 8, else
// bytes (the output may be pinned host memory, written over the bus)
__device__ __forceinline__ void store_flags(const uint8_t* f, uint8_t* o,
                                            int rows) {
  int done = 0;
  if (((uintptr_t)o & 15) == 0) {
    done = rows & ~15;
    for (int t = threadIdx.x; t < (rows >> 4); t += blockDim.x)
      ((uint4*)o)[t] = ((const uint4*)f)[t];
  }
  if (((uintptr_t)o & 7) == 0) {
    for (int t = (done >> 3) + threadIdx.x; t < (rows >> 3); t += blockDim.x)
      ((uint2*)o)[t] = ((const uint2*)f)[t];
    done = rows & ~7;
  }
  for (int t = done + threadIdx.x; t < rows; t += blockDim.x) o[t] = f[t];
}

// The rows of CTA g of member m (ELL_ROWS rows from g times that, a thread
// a row): their flags to o (the member's row of flags), the first
// ``n_out`` rows of it written (n, or the launch's n_max); ``last``: the
// member's last CTA, which writes its rows from its own past to n_out
// false.  Every thread of the CTA calls it.
__device__ __forceinline__ void ell_cta(const EllMember& m, int64_t g,
                                        uint8_t* o, int64_t n_out,
                                        bool last) {
  __shared__ __align__(16) uint8_t flags[ELL_ROWS];
  const int64_t i0 = g * ELL_ROWS;
  flags[threadIdx.x] = ell_row_ready(m, i0 + threadIdx.x);
  __syncthreads();
  store_flags(flags, o + i0, (int)min64(ELL_ROWS, n_out - i0));
  if (last) zero_flags(o + i0 + ELL_ROWS, n_out - i0 - ELL_ROWS);
}

__global__ void __launch_bounds__(ELL_ROWS)
frontier_ell(const EllMember m, uint8_t* out) {
  ell_cta(m, blockIdx.x, out, m.n, false);
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

__global__ void __launch_bounds__(32 * DENSE_ROWS)
frontier_dense(DrainArgs a, const uint8_t* adj, uint8_t* out) {
  __shared__ __align__(16) uint8_t flags[DENSE_ROWS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i0 = (int64_t)blockIdx.x * DENSE_ROWS;
  const int64_t i = i0 + w;
  const bool ready = i < a.N && dense_row_ready(a, adj, i, lane);
  if (lane == 0) flags[w] = ready;
  __syncthreads();
  store_flags(flags, out + i0, (int)min64(DENSE_ROWS, a.N - i0));
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
  __shared__ __align__(16) uint8_t flags[DENSE_ROWS];
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
  store_flags(flags, o + i0, (int)min64(DENSE_ROWS, p.n_max - i0));
  const int64_t next = lo + 1 < p.S ? p.m[lo + 1].g0 : (int64_t)gridDim.x;
  if (g + 1 == next)
    zero_flags(o + i0 + DENSE_ROWS, p.n_max - i0 - DENSE_ROWS);
}

// a launch's ELL members (at most MAX_STORES: 80 bytes each, 10 KB in all)
struct FusedEllParams {
  EllMember m[MAX_STORES];
  int64_t S, n_max;
  uint8_t* out;   // bool[S, n_max]
};

// K6 ELL: a CTA a (member, ELL_ROWS-row group) item, a flat grid of the
// members' groups (a member of n rows has max(1, ceil(n / ELL_ROWS))); the
// rows of each member from its groups' end to n_max are written false by
// its last CTA
__global__ void __launch_bounds__(ELL_ROWS)
fused_frontier_ell(const __grid_constant__ FusedEllParams p) {
  const int64_t g = blockIdx.x;
  int lo = 0, hi = (int)p.S - 1;   // the last member whose groups start
  while (lo < hi) {                // at or before g
    const int mid = (lo + hi + 1) >> 1;
    if (p.m[mid].g0 <= g) lo = mid; else hi = mid - 1;
  }
  const EllMember& m = p.m[lo];
  const int64_t next = lo + 1 < p.S ? p.m[lo + 1].g0 : (int64_t)gridDim.x;
  ell_cta(m, g - m.g0, p.out + m.out, p.n_max, g + 1 == next);
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
//       awaits_all, out bool[N] (device memory, or pinned host memory the
//       card maps)
// vals: N, D
ACCORD_EXPORT int accord_frontier_ell(void* const* p, const int64_t* v,
                                      void* stream) {
  EllMember m;
  m.adj = (const int32_t*)p[0];
  m.status = (const int32_t*)p[1];
  m.emsb = (const int64_t*)p[2];
  m.elsb = (const int64_t*)p[3];
  m.enode = (const int32_t*)p[4];
  m.awaits = (const uint8_t*)p[5];
  m.n = v[0];
  m.d = v[1];
  m.out = m.g0 = 0;
  if (m.n < 0 || m.d < 0) return (int)cudaErrorInvalidValue;
  const int64_t ctas = (m.n + ELL_ROWS - 1) / ELL_ROWS;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (ctas > 0)
    frontier_ell<<<(unsigned)ctas, ELL_ROWS, 0,
                   (cudaStream_t)stream>>>(m, (uint8_t*)p[6]);
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

// ptrs: out bool[S*n_max] (device memory, or pinned host memory the card
//       maps)
// vals: S (at most MAX_STORES), n_max, CTAs; then 10 per member: adj_idx
//       int32[n_i*d_i], status, exec_msb, exec_lsb, exec_node, awaits_all
//       (addresses), n_i, d_i, its flags' first row in out (member x
//       n_max), its first CTA (ops/kernels.py fused_frontier_launches)
ACCORD_EXPORT int accord_fused_frontier_ell(void* const* p, const int64_t* v,
                                            void* stream) {
  FusedEllParams a;
  a.S = v[0];
  a.n_max = v[1];
  a.out = (uint8_t*)p[0];
  const int64_t ctas = v[2];
  if (a.S < 1 || a.S > MAX_STORES || a.n_max < 0)
    return (int)cudaErrorInvalidValue;
  int64_t g = 0;
  for (int64_t k = 0; k < a.S; ++k) {
    const int64_t* r = v + 3 + 10 * k;
    EllMember& m = a.m[k];
    m.adj = (const int32_t*)r[0];
    m.status = (const int32_t*)r[1];
    m.emsb = (const int64_t*)r[2];
    m.elsb = (const int64_t*)r[3];
    m.enode = (const int32_t*)r[4];
    m.awaits = (const uint8_t*)r[5];
    m.n = r[6];
    m.d = r[7];
    m.out = r[8];
    m.g0 = r[9];
    if (m.n < 0 || m.n > a.n_max || m.d < 0 || m.out != k * a.n_max ||
        m.g0 != g)
      return (int)cudaErrorInvalidValue;
    g += max64(1, (m.n + ELL_ROWS - 1) / ELL_ROWS);
  }
  if (g != ctas || g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (a.n_max > 0)
    fused_frontier_ell<<<(unsigned)g, ELL_ROWS, 0,
                         (cudaStream_t)stream>>>(a);
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
