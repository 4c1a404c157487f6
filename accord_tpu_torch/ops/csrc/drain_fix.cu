// K8: the fixpoint drains, the oracles every other drain route is held to.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   drain_fix_dense <- drain_levels (:126) / drain (:115) = _drain_fix (:87)
//   drain_fix_ell   <- drain_ell_levels (:300) / drain_ell (:292)
//                      = _drain_ell_fix (:274)
// Output, equal to the reference: applied bool[N], newly bool[N] and the
// sweep count int32 (every sweep, the final empty one included).
//
// Each sweep applies every Stable, unapplied row none of whose gating deps
// is unapplied AS OF THE PREVIOUS SWEEP (a Jacobi step: the reference's
// while_loop body reads the carried applied set), and the sweep count is
// part of the result (it prices the router).
//
// drain_fix_dense, the frontier form of that fixpoint.  A Stable row
// applies at sweep r exactly when the last of its gating deps that were
// unapplied at the start applied at sweep r - 1 (rows applied at the start
// count as sweep 0).  So the kernel counts, per Stable row, its gating
// deps not applied at the start, and each level decrements only the
// counts of the Stable rows that the level's rows gate: the rows whose
// count reaches 0 are the next level.  sweeps = the non-empty levels + 1.
// A cycle, a self-gating row and a row behind an unapplied non-Stable row
// never reach 0, as in the reference.  One cooperative launch:
//   1. tiles of 32 rows x 32 deps, a warp each: the gating bits of the
//      lane's row (16-byte reads of the bool adjacency, the dep's columns
//      by shuffle), packed row-major ([N, W] words, for the counts) and,
//      by 32 ballots, transposed to the Stable rows each dep gates ([N, W]);
//      the words of the rows applied at the start;
//   2. a warp a Stable row: its count (rows at 0 form the first level)
//      and the rows it gates as a list (placed by one atomic for a CTA's
//      rows, kept while all fit in DEP_CAP);
//   3. while a level holds more than HANDOVER rows, the grid works on it:
//      a warp a row of the level walks the row's transposed words and
//      decrements the counts it gates (global atomics), the rows whose
//      count reaches 0 append themselves to the next level (one atomic a
//      warp); grid.sync();
//   4. once a level holds HANDOVER rows or fewer, every CTA but the first
//      exits, and the first finishes alone with block barriers only,
//      whatever the width of the levels after.  When the counts, levels
//      and lists fit in its shared memory it copies them there, and a
//      level costs a few shared-memory round trips and a barrier (a lane
//      a dependent, or a lane a row on a level of more rows than warps);
//      else it walks the transposed words as in 3, with the counts and
//      levels in shared memory while those fit.
// Bound on this card: one read of the adjacency (bytes) and one walk of
// each applied row's words, but a deep chain pays a latency a level: the
// earlier design paid a grid barrier and a sweep of every row a level
// (4,097 of them on config 3's 4,096-deep chain); this one pays, past the
// handover, one block barrier and the shared-memory round trips of the
// level's lists (the L2 read of a row's words, measured at about 1 us, set
// the time of a level when the lists stayed in global memory).
//
// drain_fix_ell: ONE cooperative launch per drain, a thread per row
// striding over the rows; each sweep reads a per-row stamp, the sweep
// that applied the row (0 applied at the start, NEVER not yet): sweep r
// counts a dep as applied iff its stamp is below r, so a row applied
// during sweep r reads as unapplied to the rest of that sweep, whichever
// order the threads run in.  The gating edges are computed once, into an
// [N, D] copy of adj_idx with the non-gating edges set to -1; grid.sync()
// ends each sweep and a "ready" flag in three rotating words ends the loop
// on the device.  Its sweeps pay the grid barrier (ROADMAP: the frontier
// form above applies to it too).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int32_t NEVER = 0x7fffffff;

struct Cols {
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
};

__device__ __forceinline__ bool gates(const Cols& c, int64_t i, int64_t j) {
  return drain_gates(c.status, c.emsb, c.elsb, c.enode, c.awaits, i, j);
}

// threads a CTA of the dense frontier drain; the largest level the first
// CTA finishes alone (ops/_build.py GEOMETRY); the shared memory of a CTA,
// which the first CTA fills, past the handover, with the counts, the
// levels and the dependents lists (14 N + 2 E bytes for N rows and E
// dependents; in global memory when they do not fit), and so the most
// dependents the lists are built for
constexpr int FNT = 256;
constexpr int FW = FNT / 32;
constexpr int HANDOVER = ACCORD_DRAIN_HANDOVER;
constexpr size_t FIX_SMEM = 112 * 1024;
constexpr int64_t DEP_CAP = FIX_SMEM / 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_WORDS = 8;
constexpr int WALK_SPREAD = 64;

struct FrontierArgs {
  const uint8_t* adj;   // bool[N*N]
  Cols c;
  uint32_t* blk;        // [N, W] gating deps of row i (bit b of word v: 32v+b)
  uint32_t* blkT;       // [N, W] the Stable rows dep j gates (word v: rows 32v..)
  uint32_t* app0;       // [W] rows applied at the start
  int32_t* cnt;         // [N] a Stable row's gating deps not applied yet
  int32_t* off;         // [N] where a Stable row's dependents start in dep
  int32_t* deg;         // [N] how many they are
  int32_t* dep;         // [DEP_CAP] the dependents lists, rows in order
  int32_t* list;        // [2, N] a level's rows, then the next level's
  int32_t* nlist;       // [4] rotating level sizes; the dependents in all
  uint8_t *applied, *newly;
  int32_t* sweeps;
  int64_t N, W;
  int vec;              // rows 16-byte aligned: read the adjacency by uint4
};

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) |
         (x & 0xff0000u ? 4u : 0u) | (x & 0xff000000u ? 8u : 0u);
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint4 x) {
  return nonzero_bytes(x.x) | (nonzero_bytes(x.y) << 4) |
         (nonzero_bytes(x.z) << 8) | (nonzero_bytes(x.w) << 12);
}

// append the rows of the warp whose count just reached 0 (old == 1) to
// ``nxt`` (size ``*nn``), one atomic for the warp
template <typename L>
__device__ __forceinline__ void append_ready(int32_t old, int32_t i, L* nxt,
                                             int32_t* nn) {
  const int lane = threadIdx.x & 31;
  const unsigned ready = __ballot_sync(FULL, old == 1);
  if (!ready) return;
  const int first = __ffs(ready) - 1;
  int32_t at = 0;
  if (lane == first) at = atomicAdd(nn, __popc(ready));
  at = __shfl_sync(FULL, at, first);
  if (old == 1) nxt[at + __popc(ready & ((1u << lane) - 1u))] = (L)i;
}

// the counts that the rows of one level ``cur[0:n)`` gate, a warp a row,
// from the transposed words: a lane holds WALK_WORDS of them, all loaded
// before any count moves (one L2 round trip a chunk of 8,192 rows).  A
// chunk's set bits move their counts in the fewest steps it allows: up to
// WALK_SPREAD bits gathered into the warp's scratch, a lane a bit; more,
// a group of 32 words at a time, a lane a bit of its own word or the warp
// on one word at a time, whichever takes fewer steps.  GRID: the level
// was written by other CTAs (read it from L2)
template <bool GRID, typename L>
__device__ __forceinline__ void walk_words(const FrontierArgs& a,
                                           const L* cur, int64_t n,
                                           int64_t warp, int64_t nwarps,
                                           int32_t* cnt, L* nxt, int32_t* nn,
                                           int32_t* wbits) {
  const int lane = threadIdx.x & 31;
  for (int64_t e = warp; e < n; e += nwarps) {
    const int64_t j = GRID ? (int64_t)__ldcg((const int32_t*)cur + e)
                           : (int64_t)cur[e];
    const uint32_t* row = a.blkT + j * a.W;
    for (int64_t vb = 0; vb < a.W; vb += 32 * WALK_WORDS) {
      uint32_t w[WALK_WORDS];
#pragma unroll
      for (int u = 0; u < WALK_WORDS; ++u) {
        const int64_t v = vb + 32 * u + lane;
        w[u] = v < a.W ? row[v] : 0u;
      }
      int bits = 0;
#pragma unroll
      for (int u = 0; u < WALK_WORDS; ++u) bits += __popc(w[u]);
      int inc = bits;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      const int total = __shfl_sync(FULL, inc, 31);
      if (total <= WALK_SPREAD) {
        int at = inc - bits;
#pragma unroll
        for (int u = 0; u < WALK_WORDS; ++u)
          for (uint32_t x = w[u]; x; x &= x - 1)
            wbits[at++] = (int32_t)((vb + 32 * u + lane) * 32 + __ffs(x) - 1);
        __syncwarp();
        for (int k = lane; k - lane < total; k += 32) {
          const int32_t i = k < total ? wbits[k] : -1;
          append_ready(i >= 0 ? atomicSub(&cnt[i], 1) : 0, i, nxt, nn);
        }
        __syncwarp();
        continue;
      }
#pragma unroll
      for (int u = 0; u < WALK_WORDS; ++u) {
        const unsigned words = __ballot_sync(FULL, w[u] != 0);
        if (__popc(words) < __reduce_max_sync(FULL, __popc(w[u]))) {
          for (unsigned y = words; y; y &= y - 1) {
            const int src = __ffs(y) - 1;
            const uint32_t x = __shfl_sync(FULL, w[u], src);
            const int32_t i = ((x >> lane) & 1)
                                  ? (int32_t)((vb + 32 * u + src) * 32 + lane)
                                  : -1;
            append_ready(i >= 0 ? atomicSub(&cnt[i], 1) : 0, i, nxt, nn);
          }
          continue;
        }
        const int32_t base = (int32_t)((vb + 32 * u + lane) * 32);
        for (uint32_t x = w[u]; __any_sync(FULL, x); x &= x - 1) {
          const int32_t i = x ? base + __ffs(x) - 1 : -1;
          append_ready(i >= 0 ? atomicSub(&cnt[i], 1) : 0, i, nxt, nn);
        }
      }
    }
  }
}

// the same from the dependents lists in shared memory (the first CTA
// alone): a level of more rows than warps a lane a row (a wide level after
// the handover), else a warp a row and a lane a dependent
__device__ __forceinline__ void walk_lists(const uint16_t* cur, int32_t n,
                                           int32_t* cnt, const int32_t* off,
                                           const uint16_t* deg,
                                           const uint16_t* dep, uint16_t* nxt,
                                           int32_t* nn) {
  const int lane = threadIdx.x & 31;
  if (n > FW) {
    for (int32_t e0 = threadIdx.x - lane; e0 < n; e0 += FNT) {
      const int32_t j = e0 + lane < n ? cur[e0 + lane] : -1;
      const int32_t d = j >= 0 ? deg[j] : 0, o = j >= 0 ? off[j] : 0;
      for (int32_t k = 0; __any_sync(FULL, k < d); ++k) {
        const int32_t i = k < d ? dep[o + k] : -1;
        append_ready(i >= 0 ? atomicSub(&cnt[i], 1) : 0, i, nxt, nn);
      }
    }
    return;
  }
  for (int32_t e = threadIdx.x >> 5; e < n; e += FW) {
    const int32_t j = cur[e], d = deg[j], o = off[j];
    for (int32_t k = lane; k - lane < d; k += 32) {
      const int32_t i = k < d ? dep[o + k] : -1;
      append_ready(i >= 0 ? atomicSub(&cnt[i], 1) : 0, i, nxt, nn);
    }
  }
}

// applied and newly from the final counts (GRID: counts in global memory,
// written by every CTA)
template <bool GRID>
__device__ __forceinline__ void write_drained(const FrontierArgs& a,
                                              const int32_t* cnt, int64_t i0,
                                              int64_t step) {
  for (int64_t i = i0; i < a.N; i += step) {
    const int32_t st = a.c.status[i];
    const bool newly =
        st == SLOT_STABLE && (GRID ? __ldcg(cnt + i) : cnt[i]) == 0;
    a.applied[i] = newly || st == SLOT_APPLIED;
    a.newly[i] = newly;
  }
}

__global__ void __launch_bounds__(FNT) fix_frontier_kernel(FrontierArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fsm[];
  __shared__ int32_t sn[3], s_pre[FW], s_base;
  __shared__ int32_t s_bits[FW * WALK_SPREAD];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t warp = (int64_t)blockIdx.x * FW + wid;
  const int64_t nwarps = (int64_t)gridDim.x * FW;
  const int64_t N = a.N, W = a.W;

  // 1. the gating bits, a warp a tile of 32 rows (lane: row 32I + lane)
  // by 32 deps (lane: the columns of dep 32J + lane)
  if (blockIdx.x == 0 && threadIdx.x < 4) a.nlist[threadIdx.x] = 0;
  // the adjacency bits of the lane's row in tile t, the next tile's
  // loaded while this one is worked on
  auto adj_bits = [&](int64_t t) -> uint32_t {
    const int64_t I = t / W, J = t - I * W, i = I * 32 + lane;
    if (t >= W * W || i >= N) return 0u;
    const uint8_t* row = a.adj + i * N + J * 32;
    const int64_t nb = min64(32, N - J * 32);
    if (a.vec && nb == 32) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      return nonzero_bytes(r4[0]) | (nonzero_bytes(r4[1]) << 16);
    }
    uint32_t bits = 0;
    for (int64_t b = 0; b < nb; ++b)
      if (row[b]) bits |= 1u << b;
    return bits;
  };
  uint32_t adj_next = adj_bits(warp);
  for (int64_t t = warp; t < W * W; t += nwarps) {
    const int64_t I = t / W, J = t - I * W;
    const int64_t i = I * 32 + lane, j = J * 32 + lane;
    const uint32_t adjb = adj_next;
    adj_next = adj_bits(t + nwarps);
    int32_t si = SLOT_FREE, ni = 0, sj = SLOT_FREE, nj = 0;
    int64_t mi = 0, li = 0, mj = 0, lj = 0;
    bool awi = false;
    if (i < N) {
      si = a.c.status[i];
      mi = a.c.emsb[i];
      li = a.c.elsb[i];
      ni = a.c.enode[i];
      awi = a.c.awaits[i] != 0;
    }
    if (j < N) {
      sj = a.c.status[j];
      mj = a.c.emsb[j];
      lj = a.c.elsb[j];
      nj = a.c.enode[j];
    }
    uint32_t g = 0;
    for (unsigned x = __reduce_or_sync(FULL, adjb); x; x &= x - 1) {
      const int b = __ffs(x) - 1;
      const int32_t s = __shfl_sync(FULL, sj, b);
      const int64_t em = __shfl_sync(FULL, mj, b);
      const int64_t el = __shfl_sync(FULL, lj, b);
      const int32_t en = __shfl_sync(FULL, nj, b);
      const bool dead = s == SLOT_INVALIDATED || s == SLOT_FREE;
      const bool undecided = s >= 0 && s < SLOT_COMMITTED;
      if (((adjb >> b) & 1) && !dead &&
          (undecided || awi || ts_lt(em, el, en, mi, li, ni)))
        g |= 1u << b;
    }
    if (i < N) a.blk[i * W + J] = g;
    const uint32_t tg = si == SLOT_STABLE ? g : 0u;
    uint32_t mine = 0;
    for (unsigned x = __reduce_or_sync(FULL, tg); x; x &= x - 1) {
      const int b = __ffs(x) - 1;
      const uint32_t word = __ballot_sync(FULL, (tg >> b) & 1);
      if (lane == b) mine = word;
    }
    if (j < N) a.blkT[j * W + I] = mine;
    if (I == 0) {
      const uint32_t ap = __ballot_sync(FULL, sj == SLOT_APPLIED);
      if (lane == 0) a.app0[J] = ap;
    }
  }
  grid.sync();

  // 2. a warp a Stable row, FW consecutive rows a CTA at a time: the
  // gating deps not applied at the start (rows at 0 are the first level),
  // and the rows it gates as a list, placed by one atomic for the FW rows
  // (the lists are kept only while they fit in DEP_CAP)
  for (int64_t g0 = (int64_t)blockIdx.x * FW; g0 < N;
       g0 += (int64_t)gridDim.x * FW) {
    const int64_t i = g0 + wid;
    const bool stable = i < N && a.c.status[i] == SLOT_STABLE;  // per warp
    int c = 0, d = 0;
    if (stable) {
      for (int64_t v = lane; v < W; v += 32) {
        c += __popc(a.blk[i * W + v] & ~a.app0[v]);
        d += __popc(a.blkT[i * W + v]);
      }
      c = __reduce_add_sync(FULL, c);
      d = __reduce_add_sync(FULL, d);
      if (lane == 0) {
        a.cnt[i] = c;
        if (c == 0) a.list[atomicAdd(&a.nlist[0], 1)] = (int32_t)i;
      }
    }
    if (lane == 0) s_pre[wid] = d;
    __syncthreads();
    if (wid == 0) {
      const int x = lane < FW ? s_pre[lane] : 0;
      int inc = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      if (lane == 31) s_base = atomicAdd(&a.nlist[3], inc);
      if (lane < FW) s_pre[lane] = inc - x;
    }
    __syncthreads();
    if (stable) {
      const int64_t o = (int64_t)s_base + s_pre[wid];
      if (lane == 0) {
        a.off[i] = (int32_t)min64(o, INT32_MAX);
        a.deg[i] = d;
      }
      if (d && o + d <= DEP_CAP) {
        int32_t run = 0;
        for (int64_t vb = 0; vb < W; vb += 32) {
          const int64_t v = vb + lane;
          uint32_t x = v < W ? a.blkT[i * W + v] : 0u;
          int inc = __popc(x);
#pragma unroll
          for (int s2 = 1; s2 < 32; s2 <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, s2);
            if (lane >= s2) inc += y;
          }
          int32_t at = (int32_t)o + run + inc - __popc(x);
          for (; x; x &= x - 1) a.dep[at++] = (int32_t)(v * 32 + __ffs(x) - 1);
          run += __shfl_sync(FULL, inc, 31);
        }
      }
    }
    __syncthreads();   // s_pre and s_base are the next rows'
  }
  grid.sync();

  // 3. the wide levels, the grid on each: level r + 1 is list[r & 1],
  // its size nlist[r % 3]; the size of the level after next is cleared
  int64_t r = 0;
  int32_t n = *(volatile int32_t*)&a.nlist[0];
  while (n > HANDOVER) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.nlist[(r + 2) % 3] = 0;
    walk_words<true>(a, a.list + (r & 1) * N, n, warp, nwarps, a.cnt,
                     a.list + ((r + 1) & 1) * N, a.nlist + (r + 1) % 3,
                     s_bits + wid * WALK_SPREAD);
    ++r;
    grid.sync();
    n = *(volatile int32_t*)&a.nlist[r % 3];
  }
  const int64_t tid = (int64_t)blockIdx.x * FNT + threadIdx.x;
  if (n == 0) {   // drained on the grid
    write_drained<true>(a, a.cnt, tid, (int64_t)gridDim.x * FNT);
    if (tid == 0) *a.sweeps = (int32_t)(r + 1);
    return;
  }

  // 4. the first CTA alone: a level of at most HANDOVER rows, then the
  // rest, with block barriers only.  The counts and levels move to shared
  // memory when they fit (8 N bytes), and the dependents lists too when
  // they also fit (14 N + 2 E); else the counts and levels stay in global
  // memory, and without the lists a row's transposed words are walked
  if (blockIdx.x != 0) return;
  const int64_t E = *(volatile int32_t*)&a.nlist[3];
  const bool scnt = 8 * N <= (int64_t)FIX_SMEM;
  const bool slists =
      scnt && E <= DEP_CAP && 14 * N + 2 * E <= (int64_t)FIX_SMEM;
  int32_t* scn = reinterpret_cast<int32_t*>(fsm);
  uint16_t* scur = reinterpret_cast<uint16_t*>(fsm + 4 * N);
  uint16_t* snxt = scur + N;
  int32_t* soff = reinterpret_cast<int32_t*>(fsm + 8 * N);
  uint16_t* sdeg = reinterpret_cast<uint16_t*>(fsm + 12 * N);
  uint16_t* sdep = sdeg + N;
  int32_t* gcur = a.list + (r & 1) * N;
  int32_t* gnxt = a.list + ((r + 1) & 1) * N;
  if (scnt) {
    for (int64_t i = threadIdx.x; i < N; i += FNT) scn[i] = __ldcg(a.cnt + i);
    for (int e = threadIdx.x; e < n; e += FNT)
      scur[e] = (uint16_t)__ldcg(gcur + e);
  }
  if (slists) {
    for (int64_t i = threadIdx.x; i < N; i += FNT) {
      soff[i] = __ldcg(a.off + i);
      sdeg[i] = (uint16_t)__ldcg(a.deg + i);
    }
    for (int64_t k = threadIdx.x; k < E; k += FNT)
      sdep[k] = (uint16_t)__ldcg(a.dep + k);
  }
  if (threadIdx.x < 3) sn[threadIdx.x] = threadIdx.x == 0 ? n : 0;
  __syncthreads();
  for (int64_t q = 0;; ++q) {
    const int32_t nc = sn[q % 3];
    if (nc == 0) {
      r += q;
      break;
    }
    if (threadIdx.x == 0) sn[(q + 2) % 3] = 0;
    int32_t* nn = &sn[(q + 1) % 3];
    if (slists)
      walk_lists(scur, nc, scn, soff, sdeg, sdep, snxt, nn);
    else if (scnt)
      walk_words<false>(a, scur, nc, wid, FW, scn, snxt, nn,
                        s_bits + wid * WALK_SPREAD);
    else
      walk_words<false>(a, gcur, nc, wid, FW, a.cnt, gnxt, nn,
                        s_bits + wid * WALK_SPREAD);
    uint16_t* t = scur;
    scur = snxt;
    snxt = t;
    int32_t* g = gcur;
    gcur = gnxt;
    gnxt = g;
    __syncthreads();
  }
  if (scnt)
    write_drained<false>(a, scn, threadIdx.x, FNT);
  else
    write_drained<true>(a, a.cnt, threadIdx.x, FNT);
  if (threadIdx.x == 0) *a.sweeps = (int32_t)(r + 1);
}

// the workspace's int32 words for N rows: blk and blkT (N x W each), the
// applied words (W), counts, list offsets and degrees (N each), the
// dependents lists (DEP_CAP), two levels (2N), four sizes
int64_t frontier_workspace_words(int64_t N) {
  const int64_t W = (N + 31) / 32;
  return 2 * N * W + W + 5 * N + DEP_CAP + 4;
}

struct EllFixArgs {
  const int32_t* adj;   // int32[N*D]
  Cols c;
  int32_t* bidx;        // [N*D] the gating deps, -1 elsewhere
  int32_t* stamp;       // [N] the sweep that applied the row
  int32_t* flags;       // [3]
  uint8_t *applied, *newly;
  int32_t* sweeps;
  int64_t N, D;
};

__global__ void __launch_bounds__(NT) fix_ell_kernel(EllFixArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  const int64_t N = a.N, D = a.D;

  for (int64_t i = tid; i < N; i += nthreads) {
    for (int64_t d = 0; d < D; ++d) {
      const int32_t j = a.adj[i * D + d];
      a.bidx[i * D + d] = (j >= 0 && gates(a.c, i, j)) ? j : -1;
    }
    a.stamp[i] = a.c.status[i] == SLOT_APPLIED ? 0 : NEVER;
  }
  if (tid == 0) a.flags[0] = a.flags[1] = a.flags[2] = 0;
  grid.sync();

  int64_t r = 0;
  bool more = true;
  while (more) {
    const int32_t sweep = (int32_t)(r + 1);
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    bool mine = false;
    for (int64_t i = tid; i < N; i += nthreads) {
      if (a.c.status[i] != SLOT_STABLE || a.stamp[i] != NEVER) continue;
      bool ready = true;
      for (int64_t d = 0; ready && d < D; ++d) {
        const int32_t j = a.bidx[i * D + d];
        if (j >= 0 && a.stamp[j] >= sweep) ready = false;
      }
      if (ready) {
        a.stamp[i] = sweep;
        mine = true;
      }
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    more = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  for (int64_t i = tid; i < N; i += nthreads) {
    const bool ap = a.stamp[i] != NEVER;
    a.applied[i] = ap;
    a.newly[i] = ap && a.c.status[i] != SLOT_APPLIED;
  }
  if (tid == 0) *a.sweeps = (int32_t)r;
}

Cols cols(void* const* p) {
  return Cols{(const int32_t*)p[1], (const int64_t*)p[2],
              (const int64_t*)p[3], (const int32_t*)p[4],
              (const uint8_t*)p[5]};
}

}  // namespace

// The workspace drain_fix_dense needs for N rows, in int32 words: the
// wrapper allocates it.
ACCORD_EXPORT int64_t accord_drain_fix_workspace_words(int64_t N) {
  return frontier_workspace_words(N);
}

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       workspace int32[accord_drain_fix_workspace_words(N)],
//       applied bool[N], newly bool[N], sweeps int32[1]
// vals: N, workspace words
ACCORD_EXPORT int accord_drain_fix_dense(void* const* p, const int64_t* v,
                                         void* stream) {
  FrontierArgs a;
  a.adj = (const uint8_t*)p[0];
  a.c = cols(p);
  a.N = v[0];
  if (a.N < 0 || a.N > INT32_MAX / 2 || v[1] < frontier_workspace_words(a.N))
    return (int)cudaErrorInvalidValue;
  a.W = (a.N + 31) / 32;
  uint32_t* ws = (uint32_t*)p[6];
  a.blk = ws;
  a.blkT = a.blk + a.N * a.W;
  a.app0 = a.blkT + a.N * a.W;
  a.cnt = (int32_t*)(a.app0 + a.W);
  a.off = a.cnt + a.N;
  a.deg = a.off + a.N;
  a.dep = a.deg + a.N;
  a.list = a.dep + DEP_CAP;
  a.nlist = a.list + 2 * a.N;
  a.applied = (uint8_t*)p[7];
  a.newly = (uint8_t*)p[8];
  a.sweeps = (int32_t*)p[9];
  a.vec = (a.N % 16 == 0) && ((uintptr_t)a.adj % 16 == 0);
  // a warp a tile or a row, whichever is more
  const int64_t want = (max64(a.W * a.W, a.N) + FW - 1) / FW;
  return launch_cooperative(fix_frontier_kernel, FNT, want, a,
                            (cudaStream_t)stream, FIX_SMEM);
}

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, bidx int32[N*D], stamp int32[N], flags int32[3],
//       applied bool[N], newly bool[N], sweeps int32[1]
// vals: N, D
ACCORD_EXPORT int accord_drain_fix_ell(void* const* p, const int64_t* v,
                                       void* stream) {
  EllFixArgs a;
  a.adj = (const int32_t*)p[0];
  a.c = cols(p);
  a.bidx = (int32_t*)p[6];
  a.stamp = (int32_t*)p[7];
  a.flags = (int32_t*)p[8];
  a.applied = (uint8_t*)p[9];
  a.newly = (uint8_t*)p[10];
  a.sweeps = (int32_t*)p[11];
  a.N = v[0];
  a.D = v[1];
  // a thread per row
  return launch_cooperative(fix_ell_kernel, NT, (a.N + NT - 1) / NT, a,
                            (cudaStream_t)stream);
}
