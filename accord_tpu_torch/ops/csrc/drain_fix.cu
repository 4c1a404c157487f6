// K8: the fixpoint drains, the oracles every other drain route is held to.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   drain_fix_dense <- drain_levels (:126) / drain (:115) = _drain_fix (:87)
//   drain_fix_ell   <- drain_ell_levels (:300) / drain_ell (:292)
//                      = _drain_ell_fix (:274)
// Output, equal to the reference: applied bool[N], newly bool[N] and the
// sweep count int32 (every sweep, the final empty one included).
//
// Both are the frontier form of the fixpoint (drain_frontier.cuh): counts
// of each Stable row's gating deps not applied at the start, levels of the
// rows whose count reaches 0, the grid on a level wider than the handover
// and the first CTA alone on the others, in one cooperative launch.
//
// drain_fix_dense: the engine's tile loader over the bool adjacency.
// Bound on this card: one read of the adjacency; a deep chain pays a
// latency a level, past the handover one block barrier and the shared-
// memory round trips of the level's lists.
//
// drain_fix_ell: the edge loader.  The gating test of an edge is the
// reference's _ell_blocking (:157-170): adj_idx >= 0, the dep undecided, or
// executing before the row, or the row awaiting all, and the dep neither
// INVALIDATED nor FREE.  The counts are per edge: a dep listed twice in a
// row counts twice and its dependents list holds the row twice.  The lists
// are the counted edges transposed into CSR inside the launch (a length per
// dep by atomics, offsets by one atomic a CTA's rows, then placement; each
// list padded with -1 to 4 entries, read by 16-byte loads), and a level
// reads them from global memory (2-3 MB at [100,000, 8] stay in L2); the
// counts fit a byte while D <= 255, so at N = 100,000 they and two levels
// fit the first CTA's shared memory.  The handover is its own
// (ops/_build.py GEOMETRY ACCORD_DRAIN_HANDOVER_ELL, passed to nvcc).
// Bound: two reads of adj_idx and the columns' gathers, then two dependent
// L2 round trips and a block barrier a level.
#include "drain_frontier.cuh"

namespace {

// the edges of a row the edge loader's prologue takes at once
constexpr int PREFETCH = 8;

struct Cols {
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
};

Cols cols(void* const* p) {
  return Cols{(const int32_t*)p[1], (const int64_t*)p[2],
              (const int64_t*)p[3], (const int32_t*)p[4],
              (const uint8_t*)p[5]};
}

// the dense adjacency bool[N, N] and its columns, for the tile loader
struct DenseSrc {
  const uint8_t* adj;
  Cols c;
  uint8_t *applied, *newly;
  int64_t N;
  __device__ __forceinline__ const uint8_t* row(int64_t i) const {
    return adj + i * N;
  }
  __device__ __forceinline__ int32_t status(int64_t i) const {
    return c.status[i];
  }
  __device__ __forceinline__ int64_t emsb(int64_t i) const { return c.emsb[i]; }
  __device__ __forceinline__ int64_t elsb(int64_t i) const { return c.elsb[i]; }
  __device__ __forceinline__ int32_t enode(int64_t i) const {
    return c.enode[i];
  }
  __device__ __forceinline__ uint8_t awaits(int64_t i) const {
    return c.awaits[i];
  }
  __device__ __forceinline__ void write(int64_t i, bool ap, bool nw) const {
    applied[i] = ap;
    newly[i] = nw;
  }
};

// The edge loader over adj_idx int32[N, D]:
//   P0. the lengths and placement cursors zeroed;
//   P1. a thread a row: the counted edges of a Stable row (gating, the dep
//       not applied at the start) and its count; of them, those whose dep
//       is Stable (the lists a level walks) as bits ([N, WD] words) and the
//       dep's length by an atomic;
//   P2. the offsets, NT consecutive rows a CTA at a time: a Stable row's
//       list padded with -1 to 4 entries, a heavy row's (more than ITEM
//       dependents) to whole items of ITEM, a block scan of their sizes
//       and one atomic for their base; the rows at count 0 form the first
//       level (a heavy row as its items);
//   P3. a thread a row: each marked edge places the row in its dep's list
//       (HEAVY marking a heavy row).
// P1 and P3 take PREFETCH edges of a row at a time, their loads in flight
// together.
struct EdgeLoader {
  static constexpr bool WORDS = false;
  static constexpr bool BYTE_COUNTS = true;
  const int32_t* adj;
  Cols c;
  uint8_t *applied, *newly;
  uint32_t* mask;   // [N, WD] the listed edges of a row (bit d % 32)
  int32_t* fill;    // [N] the dependents placed in a dep's list so far
  Frontier f;
  int64_t D, WD;

  __device__ __forceinline__ int32_t status(int64_t i) const {
    return c.status[i];
  }
  __device__ __forceinline__ void write(int64_t i, bool ap, bool nw) const {
    applied[i] = ap;
    newly[i] = nw;
  }
  // does edge (i, j) count: j a row that gates i and is not applied
  __device__ __forceinline__ bool counted(int64_t i, int32_t j) const {
    return j >= 0 && j < f.N && c.status[j] != SLOT_APPLIED &&
           drain_gates(c.status, c.emsb, c.elsb, c.enode, c.awaits, i, j);
  }

  __device__ void prologue(cg::grid_group& grid) const {
    __shared__ int32_t s_base;
    const int64_t N = f.N;
    const int64_t tid = (int64_t)blockIdx.x * FNT + threadIdx.x;
    const int64_t nthreads = (int64_t)gridDim.x * FNT;

    for (int64_t i = tid; i < N; i += nthreads) f.deg[i] = fill[i] = 0;
    if (tid < 5) f.nlist[tid] = 0;
    grid.sync();

    // P1
    for (int64_t i = tid; i < N; i += nthreads) {
      if (c.status[i] != SLOT_STABLE) continue;
      int32_t n = 0;
      for (int64_t vb = 0; vb < D; vb += 32) {
        const int64_t ve = min64(vb + 32, D);
        uint32_t m = 0;
        for (int64_t db = vb; db < ve; db += PREFETCH) {
          int32_t j[PREFETCH];
          bool g[PREFETCH];
#pragma unroll
          for (int u = 0; u < PREFETCH; ++u)
            j[u] = db + u < ve ? adj[i * D + db + u] : -1;
#pragma unroll
          for (int u = 0; u < PREFETCH; ++u) g[u] = counted(i, j[u]);
#pragma unroll
          for (int u = 0; u < PREFETCH; ++u)
            if (g[u]) {
              ++n;
              if (c.status[j[u]] == SLOT_STABLE) {
                m |= 1u << (db + u - vb);
                atomicAdd(&f.deg[j[u]], 1);
              }
            }
        }
        mask[i * WD + vb / 32] = m;
      }
      f.cnt[i] = n;
    }
    grid.sync();

    // P2 (warp-uniform rows: the first level is appended a warp at a time)
    const LvG first{f.list};
    for (int64_t g0 = (int64_t)blockIdx.x * FNT; g0 < N; g0 += nthreads) {
      const int64_t i = g0 + threadIdx.x;
      const bool stable = i < N && c.status[i] == SLOT_STABLE;
      const int32_t d = stable ? __ldcg(f.deg + i) : 0;
      const int32_t k = (d + ITEM - 1) / ITEM;   // heavy: k > 1
      const int32_t len = !stable ? 0 : k > 1 ? k * ITEM : (d + 3) & ~3;
      int32_t total;
      const int32_t pre = block_exclusive_scan<FNT>(len, &total);
      if (threadIdx.x == 0) s_base = atomicAdd(&f.nlist[3], total);
      __syncthreads();
      const int32_t o = s_base + pre;
      if (stable) {
        f.off[i] = o;
        for (int32_t e = d; e < len; ++e) f.dep[o + e] = -1;
      }
      const int32_t kf = !(stable && __ldcg(f.cnt + i) == 0) ? 0
                         : k > 1 ? k : 1;
      int32_t at = warp_reserve(kf, &f.nlist[0]);
      if (kf == 1) first.put(at, (int32_t)i);
      else
        for (int32_t t = 0; t < kf; ++t) first.put(at++, -1 - (o + ITEM * t));
      __syncthreads();   // s_base is the next rows'
    }
    grid.sync();

    // P3
    for (int64_t i = tid; i < N; i += nthreads) {
      if (c.status[i] != SLOT_STABLE) continue;
      const int32_t me = (int32_t)i | (__ldcg(f.deg + i) > ITEM ? HEAVY : 0);
      for (int64_t vb = 0; vb < D; vb += 32)
        for (uint32_t m = mask[i * WD + vb / 32]; m;) {
          int32_t j[PREFETCH], at[PREFETCH];
#pragma unroll
          for (int u = 0; u < PREFETCH; ++u) {
            j[u] = m ? adj[i * D + vb + __ffs(m) - 1] : -1;
            m &= m - 1;
          }
#pragma unroll
          for (int u = 0; u < PREFETCH; ++u)
            at[u] = j[u] >= 0 ? __ldcg(f.off + j[u]) + atomicAdd(&fill[j[u]], 1)
                              : 0;
#pragma unroll
          for (int u = 0; u < PREFETCH; ++u)
            if (j[u] >= 0) f.dep[at[u]] = me;
        }
    }
    grid.sync();
  }
};

// the entries a level of the edge loader holds at most for N rows of D
// edges: a Stable row, or a heavy row's items (one for every ITEM of its
// listed dependents, and one more at most)
int64_t edge_level_entries(int64_t N, int64_t D) {
  return N + (N * D + ITEM - 1) / ITEM;
}

// the edge loader's workspace in int32 words for N rows of D edges: the
// lists (N x D entries and fewer than ITEM pads a row; first, 16-byte
// aligned),
// counts, offsets, lengths, cursors (N each), two levels, five words, the
// listed-edge words (N x WD)
int64_t edge_workspace_words(int64_t N, int64_t D) {
  return N * (D + ITEM) + 4 * N + 2 * edge_level_entries(N, D) + 5 +
         N * ((D + 31) / 32);
}

}  // namespace

// The workspace drain_fix_dense needs for N rows, in int32 words: the
// wrapper allocates it.
ACCORD_EXPORT int64_t accord_drain_fix_workspace_words(int64_t N) {
  return tile_workspace_words(N);
}

// The workspace drain_fix_ell needs for N rows of D edges, in int32 words.
ACCORD_EXPORT int64_t accord_drain_fix_ell_workspace_words(int64_t N,
                                                           int64_t D) {
  return edge_workspace_words(N, D);
}

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       workspace int32[accord_drain_fix_workspace_words(N)],
//       applied bool[N], newly bool[N], sweeps int32[1]
// vals: N, workspace words
ACCORD_EXPORT int accord_drain_fix_dense(void* const* p, const int64_t* v,
                                         void* stream) {
  const int64_t N = v[0];
  if (N < 0 || N > INT32_MAX / 2 || v[1] < tile_workspace_words(N))
    return (int)cudaErrorInvalidValue;
  DenseSrc src{(const uint8_t*)p[0], cols(p), (uint8_t*)p[7],
               (uint8_t*)p[8], N};
  TileLoader<DenseSrc> a = tile_loader(src, N, (uint32_t*)p[6]);
  a.f.sweeps = (int32_t*)p[9];
  a.vec = (N % 16 == 0) && ((uintptr_t)src.adj % 16 == 0);
  // a warp a tile or a row, whichever is more
  const int64_t want = (max64(a.W * a.W, N) + FW - 1) / FW;
  return launch_cooperative(frontier_kernel<TileLoader<DenseSrc>>, FNT, want,
                            a, (cudaStream_t)stream, FIX_SMEM);
}

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, workspace int32[accord_drain_fix_ell_workspace_words],
//       applied bool[N], newly bool[N], sweeps int32[1]
// vals: N, D, workspace words
ACCORD_EXPORT int accord_drain_fix_ell(void* const* p, const int64_t* v,
                                       void* stream) {
  const int64_t N = v[0], D = v[1];
  if (N < 0 || N > INT32_MAX / 2 || D < 0 || N * (D + ITEM) > INT32_MAX ||
      v[2] < edge_workspace_words(N, D))
    return (int)cudaErrorInvalidValue;
  EdgeLoader a;
  a.adj = (const int32_t*)p[0];
  a.c = cols(p);
  a.applied = (uint8_t*)p[7];
  a.newly = (uint8_t*)p[8];
  a.D = D;
  a.WD = (D + 31) / 32;
  a.f.dep = (int32_t*)p[6];
  a.f.cap = N * (D + ITEM);
  a.f.cnt = a.f.dep + a.f.cap;
  a.f.off = a.f.cnt + N;
  a.f.deg = a.f.off + N;
  a.fill = a.f.deg + N;
  a.f.list = a.fill + N;
  a.f.L = edge_level_entries(N, D);
  a.f.nlist = a.f.list + 2 * a.f.L;
  a.mask = (uint32_t*)(a.f.nlist + 5);
  a.f.sweeps = (int32_t*)p[9];
  a.f.N = N;
  a.f.handover = ACCORD_DRAIN_HANDOVER_ELL;
  a.f.cbytes = D <= 255 ? 1 : 4;
  // a thread a row
  return launch_cooperative(frontier_kernel<EdgeLoader>, FNT,
                            (N + FNT - 1) / FNT, a, (cudaStream_t)stream,
                            FIX_SMEM);
}
