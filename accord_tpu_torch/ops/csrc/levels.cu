// K7: log-depth level assignment of the execution drain.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   level_ell   <- level_assign_ell (:397) = _ell_levels (:381)
//   level_dense <- level_assign_dense (:421) = _dense_levels (:404)
// with _level_base (:321), _critical_ptr (:366) and _level_loop (:331);
// and, as the epilogue of the same launch (K9 level_drain), the drain of
// the reference's one-program log-depth drains: _levels_to_drain (:427)
// and the depth of _drain_ell_logdepth_full (:434) /
// _drain_dense_logdepth_full (:451), or the prefix of
// drain_ell_watermark (:465) / drain_dense_watermark (:479).
// Output, equal to the reference: levels int32[N] (0 applied, 1..N the
// frontier sweep that would apply the slot, LEVEL_INF = 2^28 blocked
// forever) and the round count int32; with the epilogue, also applied
// bool[N] = applied0 | (stable & lv <= w) (w = LEVEL_INF - 1 for "lv <
// INF", else the watermark, a value or a device scalar), newly bool[N] =
// applied & ~applied0 and the depth int32 (the largest finite level, 0 if
// none).
//
// Each round is a Bellman relax (1 + max level over the blocking deps)
// followed by a pointer jump along each row's critical-parent chain
// (level >= off + level[ptr]; then ptr <- ptr[ptr], off <- off + off[ptr]),
// until no level changes or the round count reaches N + 3 (N the padded
// row count).  Levels above N are clamped to INF.
//
// One engine, two loaders, ONE cooperative launch a call.  The blocking
// set is fixed for the call (status and executeAt do not change), so a
// loader gates each edge once, in a prologue that also takes each row's
// base level and its critical parent (the gating dep of the largest
// level0 * N + slot key), and hands the engine a round state of R rows:
// levels, walks (ptr, off, one int2 word a row) and each row's list of
// gating deps as a range (another int2) of a global list.  A per-round
// "changed" vote ends the loop on the device: no host round trip per
// round.  On the grid the vote rides on the arrivals of the barrier that
// ends the round (vote_barrier); a grid of one CTA takes block barriers.
//
// The rounds engine.  When the round state fits the first CTA (at most
// RPT * LNT rows that can change, and 4 * (6R + E) bytes for E list
// entries in LEVEL_SMEM: the levels, mid, ptr x2, off x2 and the lists,
// packed by a block scan of the rows' list lengths), the first CTA runs
// the rounds alone, its threads holding their own rows' state in
// registers, with two block barriers a round (the vote is
// __syncthreads_or) and the other CTAs gone; else the grid runs them.
// The device picks the form from the counts.  A row below INF other than
// level 0 is a Stable row: only those relax.
//
// Dense loader (level_dense_kernel; R = N, every row).  A CTA takes a run
// of rows, a warp a row, 32 at a time: the warp walks the row's bytes
// (K4b's 16-byte walk, common.cuh RowWalk), runs the gate on its set bytes
// only, counts the row's gating deps, keeps the first KEEP of them and
// takes the critical parent in the same pass; a block scan of the 32
// counts places each row's list in the CTA's region of the workspace's
// list (cap / CTAs entries), where a row of at most KEEP deps writes those
// it kept and a heavier row walks its bytes again.  A list past its
// region is not written, and its row walks its bytes in every round (the
// grid form only).  Its grid form relaxes a warp a row, two grid barriers
// a round.  (PR 12's crossover, NVIDIA H100 80GB HBM3, PERF.md's K7 dense
// row: the first CTA won on every input timed where the state fits.)
//
// ELL loader (level_ell_kernel; R = A + 2).  Only Stable rows can change
// level: applied rows stay 0 and every other row stays INF through every
// round.  So a thread a row gates its D edges once; a Stable row lists
// its Stable gating deps at its own slot of the list (i * D), or only the
// constant INF row when some gating dep is neither Stable nor applied
// (its relax is INF then); applied deps add 0 and are dropped.  The A
// Stable rows are compacted in row order (a CTA's run of rows ranked by a
// block scan, the CTAs' bases by a scan of their counts after one grid
// barrier), then two constant rows follow: Z = A at level 0 (every
// applied dep) and I = A + 1 at INF (every other inactive dep), each
// pointing at itself with off 0, so that a critical parent that is
// inactive jumps by a constant, as the reference's does.  A second pass
// maps the lists and the parents to compacted indices (in place); a
// second grid barrier hands them to the engine.  The clamp and the round
// cap keep the padded N, and the vote over the active rows is the vote
// over all rows, so levels and rounds equal the reference's.  Its grid
// form runs a thread a row, the row's state in registers and its list in
// shared memory, with ONE grid barrier a round: a row computes its
// parent's relax itself from the previous round's levels (the jump needs
// mid[ptr]), so no row waits for another's relax.  (Two barriers a round
// read 1-2 us slower on phase 5's state, PERF.md's K7 ELL row, NVIDIA H100
// 80GB HBM3.)
//
// The level-drain epilogue (K9).  A level is final where the engine
// writes it out, so the drain's flags are written there, by the thread
// that holds the level in a register: in the first CTA form at the end of
// its rounds, the depth a block max (a warp reduce, then one shared
// word); in the grid form by each writer of grid_out, the depth a warp
// max, then a CTA's max by one atomicMax into the depth word the kernel
// zeroes before its first grid barrier.  ELL's inactive rows (every row
// that is not Stable) take their flags in the prologue, where their level
// is written (applied = status == APPLIED, newly = 0); their levels, 0 or
// INF, add nothing to the depth.  The compacted rows are Stable, so their
// flags need no status read; K7 dense's rows all pass through the engine
// and read their status.  The levels-only form (null flag pointers) writes
// no flag and no depth.  The reference's programs are one program each;
// a launch of its own would cost a launch's host path, a memset and a
// second read of the levels for 1 MB of work at 100,000 rows.
//
// Bound on this card: bytes and latency.  Dense: one read of the N*N
// adjacency, then ~2*log2(depth) + c rounds of two barriers each.  ELL:
// one read of the Stable rows' adjacency and their deps' fields, then the
// rounds' barriers.  The epilogue adds two bytes a row written (and
// dense's status read again).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int32_t LEVEL_INF = 1 << 28;
// threads a CTA; the gating deps a dense row keeps from its count walk;
// the rows a thread of the first CTA holds in registers (so the first-CTA
// form takes RPT * LNT rows that change); the dynamic shared memory (the
// rest of the
// 227 KB a CTA may hold is its static shared memory)
constexpr int LNT = 1024;
constexpr int LW = LNT / 32;
constexpr int KEEP = 8;
constexpr int RPT = 4;
constexpr size_t LEVEL_SMEM = 220 * 1024;
constexpr int32_t OVER = 0x7fffffff;   // a CTA's total: a list did not fit

__device__ __forceinline__ int32_t base_of(int32_t s) {
  return s == SLOT_APPLIED ? 0 : (s == SLOT_STABLE ? 1 : LEVEL_INF);
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

// a grid barrier; a block barrier when the grid is one CTA
__device__ __forceinline__ void grid_barrier(cg::grid_group& grid) {
  if (gridDim.x == 1)
    __syncthreads();
  else
    grid.sync();
}

// -- the rounds engine -------------------------------------------------------

// The round state a loader hands the engine, in the workspace: R rows
// (the engine's functions take R, and A, the first rows that have an
// output: row k's level goes to out[orig[k]], out[k] when orig is null).
// It stays in the kernel's parameter, so a round's parity indexes it.
struct Rounds {
  int32_t *out, *rounds, *flags;   // levels [N], the rounds, 3 vote words
  int32_t *lv[2], *mid;   // [R] each
  int2* walk[2];          // [R] each: (ptr, off), one read for both
  int2* span;             // [R] a row's list: [x, y) of ``list``
  int32_t* list;
  int32_t* orig;
  int64_t N;              // the padded row count (clamp, round cap)
  // the level-drain epilogue: null flags for the levels alone
  const int32_t* status;
  uint8_t *applied, *newly;   // [N] each
  int32_t* depth;
  const void* wptr;   // the watermark word (wbytes 4 or 8), or wval
  int64_t wval;
  int32_t wbytes;
};

// the epilogue's bound w: applied where lv <= w
__device__ __forceinline__ int64_t watermark(const Rounds& a) {
  return a.wbytes == 8   ? __ldg((const int64_t*)a.wptr)
         : a.wbytes == 4 ? (int64_t)__ldg((const int32_t*)a.wptr)
                         : a.wval;
}

// row ``row``'s drain flags at its final level ``lv``; a row with an
// original index (ELL's compacted rows) is Stable
__device__ __forceinline__ void drain_flags(const Rounds& a, int64_t row,
                                            int32_t lv, int64_t w) {
  const int32_t s = a.orig ? SLOT_STABLE : __ldg(a.status + row);
  const bool a0 = s == SLOT_APPLIED;
  const bool ap = a0 || (s == SLOT_STABLE && (int64_t)lv <= w);
  a.applied[row] = ap;
  a.newly[row] = ap && !a0;
}

// a level's share of the depth: itself where finite, else 0
__device__ __forceinline__ int32_t finite(int32_t lv) {
  return lv < LEVEL_INF ? lv : 0;
}

// The rounds by the first CTA alone: each thread holds the level, the
// walk (ptr, off) and the list range of its rows (k = thread + q * LNT)
// in registers; shared memory holds what other rows read: the levels, the
// relax's output (mid), the walks (double-buffered: a jump reads other
// rows' old ptr and off while it writes its own) and the lists, packed
// into one run by a block scan of the rows' list lengths.  Rows past
// RPT * LNT (ELL's two constant rows, when A = RPT * LNT) have no thread:
// a constant row keeps its level, mid and walk, set here once.
__device__ void first_cta_rounds(const Rounds& a, int32_t* sm, int R,
                                 int64_t A) {
  const int t = threadIdx.x;
  int32_t* lv = sm;
  int32_t* mid = sm + R;
  int32_t* ptr = sm + 2 * R;   // [2][R]
  int32_t* off = sm + 4 * R;   // [2][R]
  int32_t* list = sm + 6 * R;
  int32_t my_lv[RPT], my_ptr[RPT], my_off[RPT], my_s[RPT], my_e[RPT];
  int32_t len = 0;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int k = t + q * LNT;
    my_lv[q] = my_ptr[q] = my_off[q] = my_s[q] = my_e[q] = 0;
    if (k < R) {
      my_lv[q] = __ldcg(a.lv[0] + k);
      const int2 w = __ldcg(a.walk[0] + k), sp = __ldcg(a.span + k);
      my_ptr[q] = w.x;
      my_off[q] = w.y;
      my_s[q] = sp.x;
      my_e[q] = sp.y;
      lv[k] = my_lv[q];
      ptr[k] = my_ptr[q];
      off[k] = my_off[q];
      len += my_e[q] - my_s[q];
    }
  }
  for (int k = RPT * LNT + t; k < R; k += LNT) {
    const int2 w = __ldcg(a.walk[0] + k);
    lv[k] = mid[k] = __ldcg(a.lv[0] + k);
    ptr[k] = ptr[R + k] = w.x;
    off[k] = off[R + k] = w.y;
  }
  int32_t tot;
  int32_t at = block_exclusive_scan<LNT>(len, &tot);
#pragma unroll
  for (int q = 0; q < RPT; ++q) {   // the lists into the one run
    const int32_t s = my_s[q], e = my_e[q];
    for (int32_t x = s; x < e; ++x) list[at + x - s] = __ldcg(a.list + x);
    my_s[q] = at;
    my_e[q] = at + e - s;
    at += e - s;
  }
  __shared__ int32_t depth;
  if (t == 0) depth = 0;
  __syncthreads();
  int r = 0;
  bool changed = true;
  while (changed && r < a.N + 3) {
    const int c = r & 1;
    int32_t my_mid[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int k = t + q * LNT;
      int32_t nw = my_lv[q];
      if (k < R && nw >= 1 && nw < LEVEL_INF) {
        int32_t m = 0;
        for (int32_t e = my_s[q]; e < my_e[q]; ++e) m = maxi(m, lv[list[e]]);
        nw = maxi(mini(1 + m, LEVEL_INF), nw);
      }
      my_mid[q] = nw;
      if (k < R) mid[k] = nw;
    }
    __syncthreads();
    bool mine = false;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int k = t + q * LNT;
      if (k < R) {
        const int32_t o = my_off[q], p = my_ptr[q];
        const int32_t mp = mid[p], op = off[c * R + p], pp = ptr[c * R + p];
        int32_t nw = my_mid[q];
        if (o > 0) nw = maxi(nw, mini(o + mp, LEVEL_INF));
        if (nw > a.N) nw = LEVEL_INF;
        mine |= nw != my_lv[q];
        my_lv[q] = nw;
        my_off[q] = mini(o + op, LEVEL_INF);
        my_ptr[q] = pp;
        lv[k] = nw;
        off[(c ^ 1) * R + k] = my_off[q];
        ptr[(c ^ 1) * R + k] = pp;
      }
    }
    changed = __syncthreads_or(mine);
    ++r;
  }
  int32_t best = 0;
  const int64_t w = a.applied ? watermark(a) : 0;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int k = t + q * LNT;
    if (k < A) {
      const int32_t row = a.orig ? __ldcg(a.orig + k) : k;
      a.out[row] = my_lv[q];
      if (a.applied) {
        drain_flags(a, row, my_lv[q], w);
        best = maxi(best, finite(my_lv[q]));
      }
    }
  }
  if (a.applied) {
    best = __reduce_max_sync(0xffffffffu, best);
    if ((t & 31) == 0 && best > 0) atomicMax(&depth, best);
    __syncthreads();
    if (t == 0) *a.depth = depth;
  }
  if (t == 0) *a.rounds = r;
}

// The grid barrier that ends round r and carries its "changed" vote: the
// CTA's vote (``vote``, reduced by the caller's __syncthreads_or, which
// also orders the CTA's writes before its arrival) is added with the
// arrival to word r % 3 of the flags, which counts arrivals in its low 16
// bits and votes above them; thread 0 of each CTA waits for every
// arrival and shares the word (one read a CTA: every thread's read of one
// word would queue thousands of requests at one L2 slice).  Word r % 3 is
// zero when round r starts: CTA 0 zeroes word (r + 1) % 3 before it
// arrives, when every CTA has left the barrier of round r - 2, its last
// use.  Returns whether any CTA voted.
__device__ __forceinline__ bool vote_barrier(const Rounds& a, int64_t r,
                                             bool vote) {
  __shared__ unsigned seen;
  if (threadIdx.x == 0) {
    unsigned* w = (unsigned*)a.flags + r % 3;
    if (blockIdx.x == 0) a.flags[(r + 1) % 3] = 0;
    __threadfence();
    atomicAdd(w, vote ? 0x10001u : 1u);
    unsigned v;
    do {
      v = *(volatile unsigned*)w;
    } while ((v & 0xffffu) < gridDim.x);
    __threadfence();
    seen = v;
  }
  __syncthreads();
  return (seen >> 16) != 0;
}

// the jump of round r on the grid, a thread a row, then the vote; returns
// whether some level changed
__device__ bool grid_jump(const Rounds& a, int64_t r, int64_t R) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int c = (int)(r & 1);
  const int32_t* lv = a.lv[c];
  const int2* walk = a.walk[c];
  bool mine = false;
  for (int64_t i = tid; i < R; i += nthreads) {
    const int2 w = __ldcg(walk + i);
    const int32_t o = w.y, p = w.x;
    int32_t nw = __ldcg(a.mid + i);
    const int2 wp = __ldcg(walk + p);
    if (o > 0) nw = maxi(nw, mini(o + __ldcg(a.mid + p), LEVEL_INF));
    if (nw > a.N) nw = LEVEL_INF;
    a.lv[c ^ 1][i] = nw;
    a.walk[c ^ 1][i] = make_int2(wp.x, mini(o + wp.y, LEVEL_INF));
    mine |= nw != __ldcg(lv + i);
  }
  return vote_barrier(a, r, __syncthreads_or(mine));
}

// the levels of the last round to out, and the round count; with the
// epilogue each writer's flags, and a CTA's depth into the depth word
// (zeroed before the first grid barrier)
__device__ void grid_out(const Rounds& a, int64_t r, int64_t A) {
  __shared__ int32_t depth;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int32_t* fin = a.lv[r & 1];
  const int64_t w = a.applied ? watermark(a) : 0;
  int32_t best = 0;
  for (int64_t k = tid; k < A; k += nthreads) {
    const int64_t row = a.orig ? __ldcg(a.orig + k) : k;
    const int32_t lv = __ldcg(fin + k);
    a.out[row] = lv;
    if (a.applied) {
      drain_flags(a, row, lv, w);
      best = maxi(best, finite(lv));
    }
  }
  if (tid == 0) *a.rounds = (int32_t)r;
  if (a.applied) {
    if (threadIdx.x == 0) depth = 0;
    __syncthreads();
    best = __reduce_max_sync(0xffffffffu, best);
    if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(&depth, best);
    __syncthreads();
    if (threadIdx.x == 0 && depth > 0) atomicMax(a.depth, depth);
  }
}

// -- dense loader ------------------------------------------------------------

struct DenseArgs {
  const uint8_t* adj;   // bool[N*N]
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  Rounds r;               // span.x -1: the list did not fit, the row walks
  int32_t* total;         // [CTAs] the entries of a CTA's list region
  int64_t cap;            // the list's entries: a region of cap / CTAs a CTA
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
  return N + 2 + 4 + 9 * N + dense_ctas(N) + list_cap(N);
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
  RowWalk rw(a.adj, a.r.N, i, lane);
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

__global__ void __launch_bounds__(LNT) level_dense_kernel(DenseArgs a) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t kept[LW][KEEP];   // a warp's row's first gating deps
  __shared__ int32_t woff[LW + 1];     // the warps' list offsets, the sum
  __shared__ int64_t seen;             // the entries of all regions (or -1)
  cg::grid_group grid = cg::this_grid();
  const Rounds& R = a.r;
  const int64_t N = R.N;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tid = (int64_t)blockIdx.x * LNT + threadIdx.x;
  const int64_t warp = tid >> 5, warps = ((int64_t)gridDim.x * LNT) >> 5;
  const int G = (int)gridDim.x;
  // a CTA takes rows [rb * b, rb * (b + 1)), a warp a row, 32 at a time,
  // and lists them in its region of the list, capb entries
  const int64_t rb = (N + G - 1) / G, capb = a.cap / G;
  int32_t* region = R.list + blockIdx.x * capb;

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
        R.lv[0][i] = base_of(si);
        R.walk[0][i] = make_int2(p, p != i ? 1 : 0);
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
        R.span[i] = cnt == 0 ? make_int2(0, 0)
                    : make_int2(fits ? (int32_t)(blockIdx.x * capb) + s : -1,
                                (int32_t)(blockIdx.x * capb) + e);
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
  if (tid < 3) R.flags[tid] = 0;
  if (tid == 0 && R.applied) *R.depth = 0;
  grid_barrier(grid);

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
  if (E >= 0 && N <= RPT * LNT && 4 * (6 * N + E) <= (int64_t)LEVEL_SMEM) {
    if (blockIdx.x == 0) first_cta_rounds(R, sm, (int)N, N);
    return;
  }

  // the rounds on the grid: a warp a row over its list (or its bytes, for
  // a list that did not fit) for the relax, a thread a row for the jump
  int64_t r = 0;
  bool changed = true;
  while (changed && r < N + 3) {
    const int32_t* lv = R.lv[r & 1];
    for (int64_t i = warp; i < N; i += warps) {
      const int32_t old = __ldcg(lv + i);
      int32_t nw = old;
      if (old >= 1 && old < LEVEL_INF) {
        const int2 sp = __ldcg(R.span + i);
        const int32_t s = sp.x, e = sp.y;
        int32_t m = 0;
        if (s >= 0) {
          for (int32_t k = s + lane; k < e; k += 32)
            m = maxi(m, __ldcg(lv + __ldcg(R.list + k)));
        } else {
          walk_gating(a, i, lane, INT32_MAX,
                      [&](int64_t j, int32_t) { m = maxi(m, __ldcg(lv + j)); },
                      [](int32_t, int64_t) {});
        }
        nw = maxi(mini(1 + warp_max32(m), LEVEL_INF), old);
      }
      if (lane == 0) R.mid[i] = nw;
    }
    grid_barrier(grid);
    changed = grid_jump(R, r, N);
    ++r;
  }
  grid_out(R, r, N);
}

// -- ELL loader --------------------------------------------------------------

struct EllArgs {
  const int32_t* adj;   // int32[N*D]
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  Rounds r;   // R = N + 2 rows of room; ``list`` [N*D]: row i's at i * D
  int32_t* stats;   // A, E, the form (0 the first CTA, 1 the grid)
  int32_t* tot;     // [2 * CTAs] a CTA's Stable rows and list entries
  int64_t D;
};

// a Stable row's critical parent between the passes: a Stable slot, or
// one of these
constexpr int32_t PARENT_INF = -1, PARENT_APPLIED = -2, PARENT_NONE = -3;

// a thread a row, and a thread for each round-state row (N + 2)
__host__ __device__ inline int64_t ell_ctas(int64_t N) {
  return (N + 2 + LNT - 1) / LNT;
}

__host__ __device__ inline int64_t ell_workspace_words(int64_t N,
                                                       int64_t D) {
  return N + 2 + 3 + 3 + 10 * (N + 2) + 2 * ell_ctas(N) + N * D;
}

// the edges a thread gathers at once: each step of a loop over a row's
// edges issues its EB loads together, so a row pays one latency a step
constexpr int EB = 8;

// does dep j (status sj, executeAt words jm, jl) gate Stable row i (the
// reference's _ell_blocking); j's node is read only on a tie of both words
__device__ __forceinline__ bool ell_gates(const EllArgs& a, int32_t sj,
                                          uint64_t jm, uint64_t jl,
                                          int64_t j, bool aw, uint64_t em,
                                          uint64_t el, int32_t en) {
  if (sj == SLOT_INVALIDATED || sj == SLOT_FREE) return false;
  if ((sj >= 0 && sj < SLOT_COMMITTED) || aw) return true;
  if (jm != em) return jm < em;
  if (jl != el) return jl < el;
  return __ldg(a.enode + j) < en;
}

// The relax of a round-state row by the calling thread, from levels lv:
// its level ``old`` and its list [s, e)
__device__ __forceinline__ int32_t relax_list(const Rounds& a,
                                              const int32_t* lv, int32_t old,
                                              int32_t s, int32_t e) {
  if (old < 1 || old >= LEVEL_INF) return old;
  int32_t m = 0;
  for (int32_t x0 = s; x0 < e; x0 += EB) {
    int32_t v[EB];
#pragma unroll
    for (int q = 0; q < EB; ++q)
      v[q] = x0 + q < e ? __ldcg(a.list + x0 + q) : -1;
#pragma unroll
    for (int q = 0; q < EB; ++q)
      if (v[q] >= 0) m = maxi(m, __ldcg(lv + v[q]));
  }
  return maxi(mini(1 + m, LEVEL_INF), old);
}

// the relax of round-state row k, its level and list read here
__device__ __forceinline__ int32_t relax_row(const Rounds& a,
                                             const int32_t* lv, int64_t k) {
  const int32_t old = __ldcg(lv + k);
  const int2 sp = __ldcg(a.span + k);
  return relax_list(a, lv, old, sp.x, sp.y);
}

__global__ void __launch_bounds__(LNT) level_ell_kernel(EllArgs a) {
  extern __shared__ int32_t sm[];
  cg::grid_group grid = cg::this_grid();
  const Rounds& R = a.r;
  // int32 indices throughout (N * D < 2^31): a 1,024-thread CTA has 64
  // registers a thread, and a spill goes to L2 here (the shared memory
  // takes most of L1)
  const int32_t N = (int32_t)R.N, D = (int32_t)a.D;
  const int t = threadIdx.x;
  const int32_t tid = blockIdx.x * LNT + t;
  const int32_t nthreads = gridDim.x * LNT;
  const int G = (int)gridDim.x;
  const int32_t rb = (N + G - 1) / G;
  const int32_t r0 = mini(N, blockIdx.x * rb);
  const int32_t r1 = mini(N, r0 + rb);
  // a row's edges by 16-byte loads where the rows are 16-byte aligned
  const bool vec = D % 4 == 0 && ((uintptr_t)a.adj & 15) == 0;
  // between the passes: a Stable row's rank in its CTA (mid), its list's
  // length (lv[1]) and its critical parent (walk[1]), by its slot
  int32_t* rank = R.mid;
  int32_t* cnt_of = R.lv[1];
  int32_t* parent = (int32_t*)R.walk[1];

  // 1. a thread a row, LNT rows at a time: base levels (the output of
  // every row but the Stable ones), each Stable row's gate over its D
  // edges, four at a time, its list, its critical parent and its rank
  int32_t used = 0, edges = 0;
  // the thread's row of the first LNT, for pass 2: its rank (or -1), its
  // list's length and its parent
  int32_t k1 = -1, cnt1 = 0, pc1 = 0;
  for (int32_t c0 = r0; c0 < r1; c0 += LNT) {
    const int32_t i = c0 + t;
    int32_t stable = 0;
    if (i < r1) {
      const int32_t si = __ldg(a.status + i);
      if (si == SLOT_STABLE) {
        stable = 1;
        const uint64_t em = (uint64_t)__ldg(a.emsb + i);
        const uint64_t el = (uint64_t)__ldg(a.elsb + i);
        const int32_t en = __ldg(a.enode + i);
        const bool aw = __ldg(a.awaits + i);
        const int32_t* row = a.adj + i * D;
        int32_t* li = R.list + i * D;
        int64_t best = -1;
        int32_t cnt = 0;
        bool inf = false;
        for (int32_t d0 = 0; d0 < D; d0 += 4) {
          int32_t j[4], sj[4];
          uint64_t jm[4], jl[4];
          if (vec) {
            const int4 v = __ldg((const int4*)(row + d0));
            j[0] = v.x;
            j[1] = v.y;
            j[2] = v.z;
            j[3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              j[q] = d0 + q < D ? __ldg(row + d0 + q) : -1;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // executeAt ties are common
            sj[q] = j[q] >= 0 ? __ldg(a.status + j[q]) : SLOT_FREE;
            jm[q] = j[q] >= 0 ? (uint64_t)__ldg(a.emsb + j[q]) : 0;
            jl[q] = j[q] >= 0 ? (uint64_t)__ldg(a.elsb + j[q]) : 0;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (!ell_gates(a, sj[q], jm[q], jl[q], j[q], aw, em, el, en))
              continue;
            const int32_t b = base_of(sj[q]);
            best = max64(best, (int64_t)b * N + j[q]);
            if (b == 1) li[cnt++] = j[q];
            inf |= b == LEVEL_INF;
          }
        }
        if (inf) {   // its relax is INF: one entry, the INF row
          li[0] = PARENT_INF;
          cnt = 1;
        }
        const int64_t cls = best / N;
        const int32_t pc = best < 0 ? PARENT_NONE
                           : cls == 0 ? PARENT_APPLIED
                           : cls == 1 ? (int32_t)(best - cls * N) : PARENT_INF;
        parent[i] = pc;
        cnt_of[i] = cnt;
        edges += cnt;
        if (c0 == r0) {
          cnt1 = cnt;
          pc1 = pc;
        }
      } else {   // inactive: a constant level; the epilogue's flags here
        R.out[i] = si == SLOT_APPLIED ? 0 : LEVEL_INF;
        if (R.applied) {
          R.applied[i] = si == SLOT_APPLIED;
          R.newly[i] = 0;
        }
      }
    }
    int32_t n_stable;
    const int32_t before = block_exclusive_scan<LNT>(stable, &n_stable);
    if (stable) rank[i] = used + before;
    if (stable && c0 == r0) k1 = before;
    used += n_stable;
  }
  int32_t n_edges;
  block_exclusive_scan<LNT>(edges, &n_edges);
  if (t == 0) {
    a.tot[2 * blockIdx.x] = used;
    a.tot[2 * blockIdx.x + 1] = n_edges;
  }
  if (tid < 3) R.flags[tid] = 0;
  if (tid == 0 && R.applied) *R.depth = 0;
  grid_barrier(grid);

  // 2. the CTAs' bases (G <= LNT: one CTA an SM), A and E; each Stable
  // row's compacted index, its list and parent mapped to it, in place
  int32_t A, E;
  const int32_t mine_rows = t < G ? __ldcg(a.tot + 2 * t) : 0;
  const int32_t base = block_exclusive_scan<LNT>(mine_rows, &A);
  block_exclusive_scan<LNT>(t < G ? __ldcg(a.tot + 2 * t + 1) : 0, &E);
  if (t < G) sm[t] = base;
  __syncthreads();
  const int32_t Z = A, I = A + 1;
  auto cidx = [&](int32_t j) { return sm[j / rb] + __ldcg(rank + j); };
  for (int32_t i = r0 + t; i < r1; i += LNT) {
    const bool mine1 = i < r0 + LNT;
    if (mine1 ? k1 < 0 : __ldg(a.status + i) != SLOT_STABLE) continue;
    const int32_t k = sm[blockIdx.x] + (mine1 ? k1 : __ldcg(rank + i));
    const int32_t cnt = mine1 ? cnt1 : __ldcg(cnt_of + i);
    const int32_t pc = mine1 ? pc1 : __ldcg(parent + i);
    const int32_t p = pc >= 0 ? cidx(pc)
                      : pc == PARENT_INF ? I : pc == PARENT_APPLIED ? Z : k;
    int32_t* li = R.list + i * D;
    for (int32_t x0 = 0; x0 < cnt; x0 += EB) {
      int32_t j[EB];
#pragma unroll
      for (int q = 0; q < EB; ++q)
        j[q] = x0 + q < cnt ? __ldcg(li + x0 + q) : 0;
#pragma unroll
      for (int q = 0; q < EB; ++q)   // every rank read before a store
        j[q] = x0 + q >= cnt ? 0 : j[q] < 0 ? I : cidx(j[q]);
#pragma unroll
      for (int q = 0; q < EB; ++q)
        if (x0 + q < cnt) li[x0 + q] = j[q];
    }
    R.lv[0][k] = 1;
    R.walk[0][k] = make_int2(p, p != k ? 1 : 0);
    R.span[k] = make_int2(i * D, i * D + cnt);
    R.orig[k] = i;
  }
  const bool first = A <= RPT * LNT &&
                     4 * (6 * ((int64_t)A + 2) + E) <= (int64_t)LEVEL_SMEM;
  if (tid < 2) {   // Z at level 0, I at INF: constant, pointing at itself
    R.lv[0][A + tid] = tid ? LEVEL_INF : 0;
    R.walk[0][A + tid] = make_int2(A + tid, 0);
    R.span[A + tid] = make_int2(0, 0);
  }
  if (tid == 0) {
    a.stats[0] = A;
    a.stats[1] = E;
    a.stats[2] = first ? 0 : 1;
  }
  const int32_t RA = A + 2;   // the round state's rows
  grid_barrier(grid);
  if (first) {
    if (blockIdx.x == 0) first_cta_rounds(R, sm, RA, A);
    return;
  }

  // the rounds on the grid: thread ``me`` keeps round-state row me, its
  // level, walk and list range, in registers; a row past the grid's
  // threads is read from global memory each round.  (Rows spread over
  // every CTA instead read slower on phase 5's state: their stores do not
  // coalesce.)
  const int32_t me = tid;
  const bool own = me < RA;
  int32_t my_lv = 0, my_o = 0, my_p = 0, my_s = 0, my_e = 0;
  if (own) {
    my_lv = __ldcg(R.lv[0] + me);
    const int2 w = __ldcg(R.walk[0] + me), sp = __ldcg(R.span + me);
    my_o = w.y;
    my_p = w.x;
    my_s = sp.x;
    my_e = sp.y;
  }
  int32_t r = 0;
  bool changed = true;
  while (changed && r < N + 3) {
    const int c = r & 1;
    const int32_t* lv = R.lv[c];
    const int2* walk = R.walk[c];
    // the jump's mid[ptr] is the parent's relax, computed here from the
    // previous round's levels: one grid barrier a round
    bool mine = false;
    if (own) {
      const int2 wp = __ldcg(walk + my_p);
      int32_t nw = relax_list(R, lv, my_lv, my_s, my_e);
      if (my_o > 0)
        nw = maxi(nw, mini(my_o + relax_row(R, lv, my_p), LEVEL_INF));
      if (nw > N) nw = LEVEL_INF;
      mine = nw != my_lv;
      my_lv = nw;
      my_o = mini(my_o + wp.y, LEVEL_INF);
      my_p = wp.x;
      R.lv[c ^ 1][me] = nw;
      R.walk[c ^ 1][me] = make_int2(my_p, my_o);
    }
    for (int32_t k = me + nthreads; k < RA; k += nthreads) {
      const int2 w = __ldcg(walk + k);
      const int32_t o = w.y, p = w.x;
      const int2 wp = __ldcg(walk + p);
      int32_t nw = relax_row(R, lv, k);
      if (o > 0) nw = maxi(nw, mini(o + relax_row(R, lv, p), LEVEL_INF));
      if (nw > N) nw = LEVEL_INF;
      R.lv[c ^ 1][k] = nw;
      R.walk[c ^ 1][k] = make_int2(wp.x, mini(o + wp.y, LEVEL_INF));
      mine |= nw != __ldcg(lv + k);
    }
    changed = vote_barrier(R, r, __syncthreads_or(mine));
    ++r;
  }
  grid_out(R, r, A);
}

// the epilogue's arguments: ptrs applied, newly, the watermark word (each
// may be null); vals the watermark value, the watermark word's bytes (0:
// the value)
void set_epilogue(Rounds& r, const int32_t* status, void* const* p,
                  const int64_t* v) {
  r.status = status;
  r.applied = (uint8_t*)p[0];
  r.newly = (uint8_t*)p[1];
  r.wptr = p[2];
  r.wval = v[0];
  r.wbytes = (int32_t)v[1];
}

bool epilogue_ok(void* const* p, const int64_t* v) {
  return (p[0] == nullptr) == (p[1] == nullptr) &&
         (v[1] == 0 || ((v[1] == 4 || v[1] == 8) && p[2] != nullptr));
}

}  // namespace

// int32 words of level_ell's workspace for N rows of D deps: the levels
// [N], the rounds, the depth, the stats (A, E, the form), then its scratch
ACCORD_EXPORT int64_t accord_level_ell_workspace_words(int64_t N, int64_t D) {
  return ell_workspace_words(N, D);
}

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, workspace int32[accord_level_ell_workspace_words(N, D)],
//       then the level-drain epilogue's applied bool[N], newly bool[N] and
//       watermark word (int32 or int64), each null for the levels alone
// vals: N, D (N * D < 2^31), workspace words, the watermark value (read
//       when its word's bytes are 0), the watermark word's bytes (0, 4, 8)
ACCORD_EXPORT int accord_level_ell(void* const* p, const int64_t* v,
                                   void* stream) {
  EllArgs a;
  const int64_t N = v[0], D = v[1];
  if (N < 0 || D < 1 || N * D > INT32_MAX - 2 ||
      v[2] < ell_workspace_words(N, D) || !epilogue_ok(p + 7, v + 3))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  a.adj = (const int32_t*)p[0];
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  a.D = D;
  int32_t* w = (int32_t*)p[6];
  const int64_t R = N + 2;
  Rounds& r = a.r;
  set_epilogue(r, a.status, p + 7, v + 3);
  r.out = w;
  r.rounds = w + N;
  r.depth = r.rounds + 1;
  a.stats = r.depth + 1;
  r.flags = a.stats + 3;
  r.lv[0] = r.flags + 3;   // N + 8 words: the int2 arrays at 8 bytes
  r.lv[1] = r.lv[0] + R;
  r.mid = r.lv[1] + R;
  r.walk[0] = (int2*)(r.mid + R);
  r.walk[1] = r.walk[0] + R;
  r.span = r.walk[1] + R;
  r.orig = (int32_t*)(r.span + R);
  a.tot = r.orig + R;
  r.list = a.tot + 2 * ell_ctas(N);
  r.N = N;
  return launch_cooperative(level_ell_kernel, LNT, ell_ctas(N), a,
                            (cudaStream_t)stream, LEVEL_SMEM);
}

// int32 words of level_dense's workspace for N rows: the levels [N], the
// rounds, the depth, then its scratch
ACCORD_EXPORT int64_t accord_level_dense_workspace_words(int64_t N) {
  return dense_workspace_words(N);
}

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       workspace int32[accord_level_dense_workspace_words(N)]: the
//       levels int32[N], the rounds int32, the depth int32, then the
//       scratch; then the level-drain epilogue's applied bool[N], newly
//       bool[N] and watermark word, each null for the levels alone
// vals: N (N * N < 2^31), workspace words, the watermark value, the
//       watermark word's bytes (0, 4, 8)
ACCORD_EXPORT int accord_level_dense(void* const* p, const int64_t* v,
                                     void* stream) {
  DenseArgs a;
  const int64_t N = v[0];
  if (N < 0 || N * N > INT32_MAX || v[1] < dense_workspace_words(N) ||
      !epilogue_ok(p + 7, v + 2))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  a.adj = (const uint8_t*)p[0];
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  int32_t* w = (int32_t*)p[6];
  Rounds& r = a.r;
  set_epilogue(r, a.status, p + 7, v + 2);
  r.out = w;
  r.rounds = w + N;
  r.depth = r.rounds + 1;
  r.flags = r.depth + 1;
  r.lv[0] = r.flags + 4;   // a pad word: N + 6 words before the int2
                           // arrays' 3N
  r.lv[1] = r.lv[0] + N;
  r.mid = r.lv[1] + N;
  r.walk[0] = (int2*)(r.mid + N);
  r.walk[1] = r.walk[0] + N;
  r.span = r.walk[1] + N;
  r.orig = nullptr;
  a.total = (int32_t*)(r.span + N);
  r.list = a.total + dense_ctas(N);
  r.N = N;
  a.cap = list_cap(N);
  // a warp a row for the count pass
  return launch_cooperative(level_dense_kernel, LNT, dense_ctas(N), a,
                            (cudaStream_t)stream, LEVEL_SMEM);
}
