// K7: log-depth level assignment of the execution drain.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   level_ell   <- level_assign_ell (:397) = _ell_levels (:381)
//   level_dense <- level_assign_dense (:421) = _dense_levels (:404)
// with _level_base (:321), _critical_ptr (:366) and _level_loop (:331).
// Output, equal to the reference: levels int32[N] (0 applied, 1..N the
// frontier sweep that would apply the slot, LEVEL_INF = 2^28 blocked
// forever) and the round count int32.
//
// Each round is a Bellman relax (1 + max level over the blocking deps)
// followed by a pointer jump along each row's critical-parent chain
// (level >= off + level[ptr]; then ptr <- ptr[ptr], off <- off + off[ptr]),
// until no level changes or the round count reaches N + 3 (N the padded
// row count).  The jump reads the relax's output of OTHER rows, and the
// doubling reads the old ptr/off of other rows, so every round has two
// ordering points and double buffers for level, ptr and off.  Both forms
// are ONE cooperative launch a call (the blocks that fit on the card at
// once), and a per-round "changed" vote ends the loop on the device: no
// host round trip per round.
//
// ELL (level_kernel): a thread a row, the rounds on the grid, two grid
// barriers a round (cooperative_groups grid.sync(); three rotating
// "changed" words, so a reset never races a read).
//
// Dense (level_dense_kernel).  The blocking set is fixed for the call
// (status and executeAt do not change), so the [N, N] bytes are read once.
// A CTA takes a run of rows, a warp a row, 32 at a time: the warp walks
// the row's bytes (K4b's 16-byte walk, common.cuh RowWalk), runs the gate
// on its set bytes only, counts the row's gating deps, keeps the first
// KEEP of them and takes the base level and the critical parent (the
// gating dep of the largest level0 * N + slot key) in the same pass; a
// block scan of the 32 counts places each row's list in the CTA's region
// of the workspace's list (cap / CTAs entries), where a row of at most
// KEEP deps writes those it kept and a heavier row walks its bytes again.
// A list past its region is not written, and its row walks its bytes in
// every round (the grid form only).  One grid barrier ends the prologue.
// Then the rounds on the lists.  When the round state fits the first
// CTA (N <= RPT * LNT, and 4 * (6N + CTAs + E) bytes for E gating deps in
// LEVEL_SMEM: the levels, mid, ptr x2, off x2, the regions' starts and
// the lists), the first CTA runs them alone, its threads holding their
// own rows' state in registers, with two block barriers a round (the
// "changed" vote is __syncthreads_or) and the other CTAs gone; else the
// grid runs them, a warp a row over its list, with two grid barriers a
// round.  The device picks the form from the counts.  Crossover
// (chip_smoke.py's K7 dense cases with the rounds pinned to the grid by a
// launch value that has since gone; NVIDIA H100 80GB HBM3, PERF.md's K7
// dense row): none where the state fits.  The first CTA won
// on every input timed: 0.057 and 0.075 ms against 0.099 and 0.105 on
// the 4,096-deep chain, 0.51 and 0.52 against 0.85 and 0.83 at its
// shared-memory cap (1,024 rows, 30 deps a row).  A grid
// barrier costs more than a round of one CTA's shared-memory reads up to
// the edges its shared memory holds.
//
// Bound on this card: bytes and latency: one read of the N*N adjacency,
// then ~2*log2(depth) + c rounds of two barriers each; the chain's floor
// is one read of 16 MB plus its rounds' block barriers.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int32_t LEVEL_INF = 1 << 28;

struct LevelArgs {
  const int32_t* adj;   // int32[N*D]
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int32_t *lv[2], *mid, *ptr[2], *off[2], *flags, *rounds, *out;
  int64_t N, D;
};

__device__ __forceinline__ bool gates(const LevelArgs& a, int64_t i,
                                      int64_t j) {
  return drain_gates(a.status, a.emsb, a.elsb, a.enode, a.awaits, i, j);
}

__device__ __forceinline__ int32_t base_of(int32_t s) {
  return s == SLOT_APPLIED ? 0 : (s == SLOT_STABLE ? 1 : LEVEL_INF);
}

__device__ __forceinline__ int32_t base_level(const LevelArgs& a,
                                              int64_t i) {
  return base_of(a.status[i]);
}

__device__ __forceinline__ int64_t warp_max64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max64(v, (int64_t)__shfl_xor_sync(0xffffffffu, (long long)v, o));
  return v;
}

__device__ __forceinline__ int32_t warp_max32(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = maxi(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over row i's blocking deps of key(j) (-1 when there is none), by
// the calling thread
template <typename Key>
__device__ __forceinline__ int64_t row_max(const LevelArgs& a, int64_t i,
                                           Key key) {
  int64_t best = -1;
  const int32_t* adj = a.adj + i * a.D;
  for (int64_t d = 0; d < a.D; ++d) {
    const int32_t j = adj[d];
    if (j >= 0 && gates(a, i, j)) best = max64(best, key(j));
  }
  return best;
}

__global__ void __launch_bounds__(NT) level_kernel(LevelArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  const int64_t N = a.N;

  // base levels and each Stable row's critical parent: the blocking dep
  // with the largest level0 * N + slot key (keys are unique per slot)
  for (int64_t i = tid; i < N; i += nthreads) {
    const int32_t lv0 = base_level(a, i);
    const int64_t best = row_max(a, i, [&](int64_t j) {
      return (int64_t)base_level(a, j) * N + j;
    });
    const bool stable = a.status[i] == SLOT_STABLE;
    const int32_t p = (best >= 0 && stable) ? (int32_t)(best % N)
                                            : (int32_t)i;
    a.lv[0][i] = lv0;
    a.ptr[0][i] = p;
    a.off[0][i] = p != i ? 1 : 0;
  }
  if (tid == 0) {
    a.flags[0] = 0;
    a.flags[1] = 0;
    a.flags[2] = 0;
  }
  grid.sync();

  int64_t r = 0;
  bool changed = true;
  while (changed && r < N + 3) {
    const int c = (int)(r & 1);
    const int32_t* lv = a.lv[c];
    // relax: new = max(lv, min(relax(lv), INF)) for rows below INF
    for (int64_t i = tid; i < N; i += nthreads) {
      const int32_t old = lv[i];
      int32_t nw = old;
      if (old < LEVEL_INF) {
        int32_t rel;
        if (a.status[i] == SLOT_STABLE) {
          const int64_t m = row_max(a, i, [&](int64_t j) {
            return (int64_t)lv[j];
          });
          rel = 1 + (int32_t)max64(m, 0);
        } else {
          rel = base_level(a, i);
        }
        nw = maxi(mini(rel, LEVEL_INF), old);
      }
      a.mid[i] = nw;
    }
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    grid.sync();
    // jump along the witness walk, clamp, and double the walk
    int32_t* lv_next = a.lv[c ^ 1];
    const int32_t* ptr = a.ptr[c];
    const int32_t* off = a.off[c];
    bool mine = false;
    for (int64_t i = tid; i < N; i += nthreads) {
      const int32_t o = off[i];
      const int32_t p = ptr[i];
      int32_t nw = a.mid[i];
      if (o > 0) nw = maxi(nw, mini(o + a.mid[p], LEVEL_INF));
      if (nw > N) nw = LEVEL_INF;
      lv_next[i] = nw;
      a.off[c ^ 1][i] = mini(o + off[p], LEVEL_INF);
      a.ptr[c ^ 1][i] = ptr[p];
      mine |= nw != lv[i];
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    changed = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  const int32_t* fin = a.lv[r & 1];
  for (int64_t i = tid; i < N; i += nthreads) a.out[i] = fin[i];
  if (tid == 0) *a.rounds = (int32_t)r;
}

// -- dense --------------------------------------------------------------------

// threads a level_dense CTA; the gating deps a row keeps from its count
// walk; the rows a thread of the first CTA holds in registers (so the
// first-CTA form takes N <= RPT * LNT); the first CTA's dynamic shared
// memory (the rest of the 227 KB a CTA may hold is its static shared
// memory)
constexpr int LNT = 1024;
constexpr int LW = LNT / 32;
constexpr int KEEP = 8;
constexpr int RPT = 4;
constexpr size_t LEVEL_SMEM = 220 * 1024;
constexpr int32_t OVER = 0x7fffffff;   // a CTA's total: a list did not fit

struct DenseArgs {
  const uint8_t* adj;   // bool[N*N]
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  // the workspace (dense_workspace_words): the levels, the rounds, then
  int32_t *out, *rounds, *flags, *lv[2], *mid, *ptr[2], *off[2];
  int32_t *start, *end;   // [N] a row's list in ``list``; start -1: the
                          // list did not fit, the row walks its bytes
  int32_t *total;         // [CTAs] the entries of a CTA's list region
  int32_t *list;          // [cap] a region of cap / CTAs entries a CTA
  int64_t N, cap;
};

// the list capacity of an N-row workspace: 8 entries a row, and at least
// what the first CTA's shared memory holds, at most N * N
__host__ __device__ inline int64_t list_cap(int64_t N) {
  return min64(N * N, max64(8 * N, (int64_t)(LEVEL_SMEM / 4)));
}

// the CTAs of an N-row launch at most: a warp a row
__host__ __device__ inline int64_t dense_ctas(int64_t N) {
  return (N * 32 + LNT - 1) / LNT;
}

__host__ __device__ inline int64_t dense_workspace_words(int64_t N) {
  return N + 1 + 3 + 9 * N + dense_ctas(N) + list_cap(N);
}

// Walk Stable row i's gating deps in column order by the calling warp
// (RowWalk, the gate on the set bytes only, each dep's four fields read
// together): the lane that finds dep j calls dep(j, status[j]); then the
// warp calls put(rank, j) for each, ``rank`` its place in the row.  Stops
// at the first step after which ``limit`` deps are found.  Returns the
// deps found (in every lane).
template <typename Dep, typename Put>
__device__ __forceinline__ int32_t walk_gating(const DenseArgs& a, int64_t i,
                                               int lane, int32_t limit,
                                               Dep dep, Put put) {
  RowWalk rw(a.adj, a.N, i, lane);
  const int64_t em = __ldg(a.emsb + i), el = __ldg(a.elsb + i);
  const int32_t en = __ldg(a.enode + i);
  const bool aw = __ldg(a.awaits + i);
  int32_t total = 0;
  do {
    int64_t col0 = 0;
    uint32_t gate = 0;
    for (uint32_t bits = rw.bits(col0); bits; bits &= bits - 1u) {
      const int k = __ffs(bits) - 1;
      const int64_t j = col0 + k;
      const int32_t sj = __ldg(a.status + j);
      const int64_t jm = __ldg(a.emsb + j), jl = __ldg(a.elsb + j);
      const int32_t jn = __ldg(a.enode + j);
      if (sj != SLOT_INVALIDATED && sj != SLOT_FREE &&
          ((sj >= 0 && sj < SLOT_COMMITTED) || aw ||
           ts_lt(jm, jl, jn, em, el, en))) {
        gate |= 1u << k;
        dep(j, sj);
      }
    }
    const int32_t n = __popc(gate);
    int32_t incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int32_t rank = total + incl - n;
    for (; gate; gate &= gate - 1u) put(rank++, col0 + __ffs(gate) - 1);
    total += __shfl_sync(0xffffffffu, incl, 31);
  } while (total < limit && rw.next());
  return total;
}

// The rounds by the first CTA alone: each thread holds the level, the
// walk (ptr, off) and the list range of its rows (i = thread + k * LNT)
// in registers; shared memory holds what other rows read: the levels, the
// relax's output (mid), the walks (double-buffered: a jump reads other
// rows' old ptr and off while it writes its own) and the lists, copied
// from the CTAs' regions into one run (``pre`` the regions' starts in it)
__device__ void first_cta_rounds(const DenseArgs& a, int32_t* sm, int64_t E,
                                 int64_t rb, int64_t capb) {
  const int N = (int)a.N;
  const int G = (int)gridDim.x;
  const int t = threadIdx.x;
  int32_t* lv = sm;
  int32_t* mid = sm + N;
  int32_t* ptr = sm + 2 * N;   // [2][N]
  int32_t* off = sm + 4 * N;   // [2][N]
  int32_t* pre = sm + 6 * N;   // [G]
  int32_t* list = pre + G;     // [E]
  int32_t tot;
  const int32_t mine_tot = t < G ? __ldcg(a.total + t) : 0;
  const int32_t before = block_exclusive_scan<LNT>(mine_tot, &tot);
  if (t < G) pre[t] = before;
  int32_t my_lv[RPT], my_ptr[RPT], my_off[RPT], my_s[RPT], my_e[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = t + k * LNT;
    my_lv[k] = my_ptr[k] = my_off[k] = my_s[k] = my_e[k] = 0;
    if (i < N) {
      my_lv[k] = __ldcg(a.lv[0] + i);
      my_ptr[k] = __ldcg(a.ptr[0] + i);
      my_off[k] = __ldcg(a.off[0] + i);
      my_s[k] = __ldcg(a.start + i);
      my_e[k] = __ldcg(a.end + i);
      lv[i] = my_lv[k];
      ptr[i] = my_ptr[k];
      off[i] = my_off[k];
    }
  }
  __syncthreads();   // pre
#pragma unroll
  for (int k = 0; k < RPT; ++k) {   // the ranges into the one run
    const int i = t + k * LNT;
    if (i < N && my_e[k] > my_s[k]) {
      const int b = (int)(i / rb);
      const int32_t d = pre[b] - (int32_t)(b * capb);
      my_s[k] += d;
      my_e[k] += d;
    }
  }
  for (int e = t; e < E; e += LNT) {
    const int b = (int)upper_bound(pre, G, e) - 1;
    list[e] = __ldcg(a.list + b * capb + (e - pre[b]));
  }
  __syncthreads();
  int r = 0;
  bool changed = true;
  while (changed && r < N + 3) {
    const int c = r & 1;
    // relax; a row below INF other than level 0 is a Stable row (the
    // other rows stay 0 or INF)
    int32_t my_mid[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int i = t + k * LNT;
      int32_t nw = my_lv[k];
      if (i < N && nw >= 1 && nw < LEVEL_INF) {
        int32_t m = 0;
        for (int32_t e = my_s[k]; e < my_e[k]; ++e) m = maxi(m, lv[list[e]]);
        nw = maxi(mini(1 + m, LEVEL_INF), nw);
      }
      my_mid[k] = nw;
      if (i < N) mid[i] = nw;
    }
    __syncthreads();
    bool mine = false;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int i = t + k * LNT;
      if (i < N) {
        const int32_t o = my_off[k], p = my_ptr[k];
        const int32_t mp = mid[p], op = off[c * N + p], pp = ptr[c * N + p];
        int32_t nw = my_mid[k];
        if (o > 0) nw = maxi(nw, mini(o + mp, LEVEL_INF));
        if (nw > N) nw = LEVEL_INF;
        mine |= nw != my_lv[k];
        my_lv[k] = nw;
        my_off[k] = mini(o + op, LEVEL_INF);
        my_ptr[k] = pp;
        lv[i] = nw;
        off[(c ^ 1) * N + i] = my_off[k];
        ptr[(c ^ 1) * N + i] = pp;
      }
    }
    changed = __syncthreads_or(mine);
    ++r;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = t + k * LNT;
    if (i < N) a.out[i] = my_lv[k];
  }
  if (t == 0) *a.rounds = r;
}

__global__ void __launch_bounds__(LNT) level_dense_kernel(DenseArgs a) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t kept[LW][KEEP];   // a warp's row's first gating deps
  __shared__ int32_t woff[LW + 1];     // the warps' list offsets, the sum
  __shared__ int64_t seen;             // the entries of all regions (or -1)
  cg::grid_group grid = cg::this_grid();
  const int64_t N = a.N;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tid = (int64_t)blockIdx.x * LNT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * LNT;
  const int64_t warp = tid >> 5, warps = nthreads >> 5;
  const int G = (int)gridDim.x;
  // a CTA takes rows [rb * b, rb * (b + 1)), a warp a row, 32 at a time,
  // and lists them in its region of the list, capb entries
  const int64_t rb = (N + G - 1) / G, capb = a.cap / G;
  int32_t* region = a.list + blockIdx.x * capb;

  // 1. count and list: base levels; each Stable row's gating deps, its
  // critical parent (the dep of the largest level0 * N + slot key; keys
  // are unique per slot) and its list: a row of at most KEEP deps writes
  // those the walk kept, a heavier one walks its row again
  int32_t used = 0;
  bool over = false;
  const int64_t r0 = min64(N, (int64_t)blockIdx.x * rb);
  const int64_t r1 = min64(N, r0 + rb);
  for (int64_t b0 = r0; b0 < r1; b0 += LW) {
    const int64_t i = b0 + w;
    int32_t cnt = 0;
    if (i < r1) {
      const int32_t si = __ldg(a.status + i);
      int64_t best = -1;
      if (si == SLOT_STABLE) {
        cnt = walk_gating(
            a, i, lane, INT32_MAX,
            [&](int64_t j, int32_t sj) {
              best = max64(best, (int64_t)base_of(sj) * N + j);
            },
            [&](int32_t rank, int64_t j) {
              if (rank < KEEP) kept[w][rank] = (int32_t)j;
            });
        best = warp_max64(best);
      }
      if (lane == 0) {
        const int32_t p = best >= 0 ? (int32_t)(best % N) : (int32_t)i;
        a.lv[0][i] = base_of(si);
        a.ptr[0][i] = p;
        a.off[0][i] = p != i ? 1 : 0;
      }
    }
    if (lane == 0) woff[w] = cnt;
    __syncthreads();
    if (w == 0) {
      const int32_t c = woff[lane];
      int32_t incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      woff[lane] = incl - c;
      if (lane == 31) woff[LW] = incl;
    }
    __syncthreads();
    if (i < r1) {
      const int32_t s = used + woff[w], e = s + cnt;
      const bool fits = e <= capb;
      over |= cnt > 0 && !fits;
      if (lane == 0) {
        a.start[i] = cnt == 0 ? 0 : fits ? (int32_t)(blockIdx.x * capb) + s
                                         : -1;
        a.end[i] = cnt == 0 ? 0 : (int32_t)(blockIdx.x * capb) + e;
      }
      __syncwarp();
      if (cnt > 0 && fits) {
        if (cnt <= KEEP) {
          if (lane < cnt) region[s + lane] = kept[w][lane];
        } else {
          walk_gating(a, i, lane, cnt, [](int64_t, int32_t) {},
                      [&](int32_t rank, int64_t j) {
                        region[s + rank] = (int32_t)j;
                      });
        }
      }
    }
    used += woff[LW];
    __syncthreads();   // kept and woff are written again
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) a.total[blockIdx.x] = over ? OVER : used;
  if (tid < 3) a.flags[tid] = 0;
  grid.sync();

  // the form, from the regions' totals (each CTA reads them all)
  if (w == 0) {
    int64_t sum = 0;
    bool any_over = false;
    for (int b = lane; b < G; b += 32) {
      const int32_t x = __ldcg(a.total + b);
      any_over |= x == OVER;
      sum += x == OVER ? 0 : x;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, (long long)sum, o);
    any_over = __any_sync(0xffffffffu, any_over);
    if (lane == 0) seen = any_over ? -1 : sum;
  }
  __syncthreads();
  const int64_t E = seen;
  const bool first = E >= 0 && N <= RPT * LNT &&
                     4 * (6 * N + G + E) <= (int64_t)LEVEL_SMEM;
  if (first) {
    if (blockIdx.x == 0) first_cta_rounds(a, sm, E, rb, capb);
    return;
  }

  // the rounds on the grid: a warp a row over its list (or its bytes,
  // for a list that did not fit), a thread a row for the jump
  int64_t r = 0;
  bool changed = true;
  while (changed && r < N + 3) {
    const int c = (int)(r & 1);
    const int32_t* lv = a.lv[c];
    for (int64_t i = warp; i < N; i += warps) {
      const int32_t old = __ldcg(lv + i);
      int32_t nw = old;
      if (old >= 1 && old < LEVEL_INF) {
        const int32_t s = __ldcg(a.start + i), e = __ldcg(a.end + i);
        int32_t m = 0;
        if (s >= 0) {
          for (int32_t k = s + lane; k < e; k += 32)
            m = maxi(m, __ldcg(lv + __ldcg(a.list + k)));
        } else {
          walk_gating(a, i, lane, INT32_MAX,
                      [&](int64_t j, int32_t) { m = maxi(m, __ldcg(lv + j)); },
                      [](int32_t, int64_t) {});
        }
        nw = maxi(mini(1 + warp_max32(m), LEVEL_INF), old);
      }
      if (lane == 0) a.mid[i] = nw;
    }
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    grid.sync();
    int32_t* lv_next = a.lv[c ^ 1];
    const int32_t* ptr = a.ptr[c];
    const int32_t* off = a.off[c];
    bool mine = false;
    for (int64_t i = tid; i < N; i += nthreads) {
      const int32_t o = __ldcg(off + i);
      const int32_t p = __ldcg(ptr + i);
      int32_t nw = __ldcg(a.mid + i);
      if (o > 0) nw = maxi(nw, mini(o + __ldcg(a.mid + p), LEVEL_INF));
      if (nw > N) nw = LEVEL_INF;
      lv_next[i] = nw;
      a.off[c ^ 1][i] = mini(o + __ldcg(off + p), LEVEL_INF);
      a.ptr[c ^ 1][i] = __ldcg(ptr + p);
      mine |= nw != __ldcg(lv + i);
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    changed = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  const int32_t* fin = a.lv[r & 1];
  for (int64_t i = tid; i < N; i += nthreads) a.out[i] = __ldcg(fin + i);
  if (tid == 0) *a.rounds = (int32_t)r;
}

}  // namespace

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, lv0, lv1, mid, ptr0, ptr1, off0, off1 (int32[N]
//       scratch each), flags int32[3], rounds int32[1], levels int32[N]
// vals: N, D
ACCORD_EXPORT int accord_level_ell(void* const* p, const int64_t* v,
                                   void* stream) {
  LevelArgs a;
  a.adj = (const int32_t*)p[0];
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  a.lv[0] = (int32_t*)p[6];
  a.lv[1] = (int32_t*)p[7];
  a.mid = (int32_t*)p[8];
  a.ptr[0] = (int32_t*)p[9];
  a.ptr[1] = (int32_t*)p[10];
  a.off[0] = (int32_t*)p[11];
  a.off[1] = (int32_t*)p[12];
  a.flags = (int32_t*)p[13];
  a.rounds = (int32_t*)p[14];
  a.out = (int32_t*)p[15];
  a.N = v[0];
  a.D = v[1];
  if (a.N <= 0) return (int)cudaGetLastError();
  return launch_cooperative(level_kernel, NT, (a.N + NT - 1) / NT, a,
                            (cudaStream_t)stream);
}

// int32 words of level_dense's workspace for N rows: the levels [N], the
// rounds, then its scratch
ACCORD_EXPORT int64_t accord_level_dense_workspace_words(int64_t N) {
  return dense_workspace_words(N);
}

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       workspace int32[accord_level_dense_workspace_words(N)]: the
//       levels int32[N], the rounds int32, then the scratch
// vals: N (N * N < 2^31), workspace words
ACCORD_EXPORT int accord_level_dense(void* const* p, const int64_t* v,
                                     void* stream) {
  DenseArgs a;
  a.N = v[0];
  if (a.N < 0 || a.N * a.N > INT32_MAX ||
      v[1] < dense_workspace_words(a.N))
    return (int)cudaErrorInvalidValue;
  if (a.N == 0) return (int)cudaGetLastError();
  a.adj = (const uint8_t*)p[0];
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  int32_t* w = (int32_t*)p[6];
  const int64_t N = a.N;
  a.out = w;
  a.rounds = w + N;
  a.flags = a.rounds + 1;
  a.lv[0] = a.flags + 3;
  a.lv[1] = a.lv[0] + N;
  a.mid = a.lv[1] + N;
  a.ptr[0] = a.mid + N;
  a.ptr[1] = a.ptr[0] + N;
  a.off[0] = a.ptr[1] + N;
  a.off[1] = a.off[0] + N;
  a.start = a.off[1] + N;
  a.end = a.start + N;
  a.total = a.end + N;
  a.list = a.total + dense_ctas(N);
  a.cap = list_cap(N);
  // a warp a row for the count pass
  return launch_cooperative(level_dense_kernel, LNT, dense_ctas(N), a,
                            (cudaStream_t)stream, LEVEL_SMEM);
}
