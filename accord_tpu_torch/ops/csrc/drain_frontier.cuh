// The frontier form of the fixpoint drain: one engine, shared by K8
// drain_fix_dense and drain_fix_ell (drain_fix.cu) and K13
// sharded_drain_fix (sharded_frontier.cu).
//
// The fixpoint applies, each sweep, every Stable unapplied row none of
// whose gating deps is unapplied as of the previous sweep (a Jacobi step),
// and counts its sweeps, the final empty one included.  A Stable row
// applies at sweep r exactly when the last of its gating deps that were
// unapplied at the start applied at sweep r - 1 (rows applied at the start
// count as sweep 0).  So a loader counts, per Stable row, its gating deps
// not applied at the start and lists, per dep, the Stable rows it gates;
// the rows at count 0 are the first level, and each level decrements the
// counts of the rows its rows gate: those reaching 0 are the next level.
// sweeps = the non-empty levels + 1.  A cycle, a self-gating row and a row
// behind an unapplied non-Stable row never reach 0, as in the reference.
//
// One cooperative launch: the loader's prologue (its own grid barriers),
// then
//   1. while a level holds more than the loader's handover, the grid works
//      on it: a warp a row or a lane an item of the level decrements the
//      counts it gates (global atomics); rows reaching 0 append themselves
//      to the next level (one atomic a warp); grid.sync();
//   2. while a level holds the handover or fewer entries, the first CTA
//      works alone with block barriers only, and the others wait for its
//      hand-off word: a level wider than the handover goes back to the
//      grid (step 1), and the last level ends the launch.  Its shared
//      memory holds the first ``handover`` entries of two levels and,
//      while they fit, the counts (a byte a row when every count fits one,
//      else 32 bits) and, while N < 2^16, a tile loader's dependents lists
//      as 16-bit rows (a level then costs a few shared-memory round trips
//      and a barrier).
// Without the lists in shared memory a level walks the edge loader's
// global lists (a lane an entry: a row's offset and length in one L2 round
// trip, its dependents in one more) or the tile loaders' transposed words
// (a warp a row).  A level in the first CTA costs a block barrier,
// those round trips and the instructions of its busiest warp: measured,
// the last dominate (PERF.md, the frontier engine's findings).
//
// Loaders: ``TileLoader<Src>`` (below) packs a bool adjacency into
// gating words by 32 x 32 tiles, for K8 dense (one [N, N] array) and K13
// (row slices); drain_fix.cu's ``EdgeLoader`` reads an ELL adjacency and
// builds the lists as its counted edges transposed; its level entries are
// rows of at most ITEM dependents and items of ITEM dependents of the
// heavier rows, so that a level's size is its work, however skewed.  A
// loader provides prologue(grid), status(i), write(i, applied, newly), its
// ``Frontier``
// ``f`` and the constants WORDS (walk the transposed words ``blkT`` of
// ``W`` words a row; else walk the entries of its global lists)
// and BYTE_COUNTS (its counts may fit a byte: ``f.cbytes``).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// threads a CTA; the shared memory of a CTA, which the first CTA fills
// past the handover (the dense lists take 14 N + 2 E bytes for N rows and
// E dependents), and so the most dependents a tile loader lists; a walk's chunk of transposed words a lane and the set bits
// it gathers; the dependents of an item of the edge loader's levels (3 x
// 16 bytes, a lane's loads in one round trip: one item covers all but the
// rare row of config 3's hot chains, whose out-degree is 10 at p99); the
// rows a thread loads at once where one CTA reads many
constexpr int FNT = 256;
constexpr int FW = FNT / 32;
constexpr size_t FIX_SMEM = 112 * 1024;
constexpr int64_t DEP_CAP = FIX_SMEM / 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_WORDS = 8;
constexpr int WALK_SPREAD = 64;
constexpr int ITEM = ACCORD_DRAIN_ELL_ITEM;   // ops/_build.py GEOMETRY
static_assert(ITEM % 4 == 0, "an item is read by 16-byte loads");
constexpr int32_t HEAVY = 1 << 30;   // a dependents-list entry: a heavy row
constexpr int BATCH = 16;

// what a loader hands the level walk (int32 arrays in its workspace)
struct Frontier {
  int32_t* cnt;      // [N] a Stable row's gating deps not applied yet
  int32_t* off;      // [N] where a row's dependents start in dep
  int32_t* deg;      // [N] how many they are
  int32_t* dep;      // [cap] the dependents lists (the edge loader's
                     // padded with -1: see walk_entries)
  int32_t* list;     // [2, L] a level's entries, then the next level's
  int32_t* nlist;    // [5] rotating level sizes; the dependents in all;
                     // the first CTA's hand-off word
  int32_t* sweeps;
  int64_t N, cap;    // rows; the dependents the lists hold at most
  int64_t L;         // the entries a level holds at most
  int32_t handover;  // the widest level (entries) the first CTA takes
  int32_t cbytes;    // 1: every count fits a byte
};

// A read of what other CTAs wrote, from L2.  Under a branch it is volatile
// (ld_l2), so that the compiler never moves it out of the branch that
// guards it, as it may an ld.global.cg (an asm it takes for pure); volatile
// reads are issued one after another, so loops that read many take
// __ldcg with no branch around it
__device__ __forceinline__ int32_t ld_l2(const int32_t* p) {
  return *(const volatile int32_t*)p;
}

// counts: 32 bits in global memory (written by every CTA), 32 bits or a
// byte a row in shared memory.  dec returns the count before the decrement
// (a byte is never decremented below 0: each decrement is a counted edge)
struct CntG {
  int32_t* p;
  __device__ __forceinline__ int32_t dec(int32_t i) const {
    return atomicSub(p + i, 1);
  }
  __device__ __forceinline__ int32_t get(int64_t i) const {
    return __ldcg(p + i);
  }
};

struct CntS {
  int32_t* p;
  __device__ __forceinline__ int32_t dec(int32_t i) const {
    return atomicSub(p + i, 1);
  }
  __device__ __forceinline__ int32_t get(int64_t i) const { return p[i]; }
};

struct CntB {
  uint32_t* p;
  __device__ __forceinline__ int32_t dec(int32_t i) const {
    const int sh = (i & 3) * 8;
    return (int32_t)((atomicSub(p + (i >> 2), 1u << sh) >> sh) & 0xffu);
  }
  __device__ __forceinline__ int32_t get(int64_t i) const {
    return reinterpret_cast<const uint8_t*>(p)[i];
  }
};

// levels: in global memory (the grid's, written by other CTAs), in shared
// memory as 16-bit rows, or split: the first ``cap`` entries in shared
// memory, the rest in global memory (the first CTA's: it walks no level
// past ``cap`` entries, and hands such a level back to the grid)
struct LvG {
  int32_t* g;
  __device__ __forceinline__ int32_t get(int64_t e) const {
    return ld_l2(g + e);
  }
  __device__ __forceinline__ void put(int64_t e, int32_t v) const {
    g[e] = v;
  }
};

struct LvS {
  uint16_t* s;
  __device__ __forceinline__ int32_t get(int64_t e) const { return s[e]; }
  __device__ __forceinline__ void put(int64_t e, int32_t v) const {
    s[e] = (uint16_t)v;
  }
};

struct LvX {
  int32_t *s, *g;
  int64_t cap;
  __device__ __forceinline__ int32_t get(int64_t e) const { return s[e]; }
  __device__ __forceinline__ void put(int64_t e, int32_t v) const {
    if (e < cap) s[e] = v; else g[e] = v;
  }
};

// append the rows of the warp that are ready to ``nxt`` (size ``*nn``),
// one atomic for the warp
template <class Lv>
__device__ __forceinline__ void append_if(bool ready, int32_t i,
                                          const Lv& nxt, int32_t* nn) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(FULL, ready);
  if (!m) return;
  const int first = __ffs(m) - 1;
  int32_t at = 0;
  if (lane == first) at = atomicAdd(nn, __popc(m));
  at = __shfl_sync(FULL, at, first);
  if (ready) nxt.put(at + __popc(m & ((1u << lane) - 1u)), i);
}

// decrement the count of dependent i (-1: none) and append it at 0
template <class C, class Lv>
__device__ __forceinline__ void release(int32_t i, const C& cnt,
                                        const Lv& nxt, int32_t* nn) {
  append_if(i >= 0 && cnt.dec(i) == 1, i, nxt, nn);
}

// reserve ``k`` entries of a level for each lane of the warp, one atomic
// for the warp (every lane calls it); returns the lane's first
__device__ __forceinline__ int32_t warp_reserve(int32_t k, int32_t* nn) {
  const int lane = threadIdx.x & 31;
  int32_t inc = k;
#pragma unroll
  for (int s2 = 1; s2 < 32; s2 <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, inc, s2);
    if (lane >= s2) inc += y;
  }
  const int32_t total = __shfl_sync(FULL, inc, 31);
  if (total == 0) return 0;
  int32_t at = 0;
  if (lane == 31) at = atomicAdd(nn, total);
  return __shfl_sync(FULL, at, 31) + inc - k;
}

// the counts that the rows of one level ``cur[0:n)`` gate, a warp a row,
// from the transposed words: a lane holds WALK_WORDS of them, all loaded
// before any count moves (one L2 round trip a chunk of 8,192 rows).  A
// chunk's set bits move their counts in the fewest steps it allows: up to
// WALK_SPREAD bits gathered into the warp's scratch, a lane a bit; more,
// a group of 32 words at a time, a lane a bit of its own word or the warp
// on one word at a time, whichever takes fewer steps
template <class Lc, class C, class Ln>
__device__ __forceinline__ void walk_words(const uint32_t* blkT, int64_t W,
                                           const Lc& cur, int64_t n,
                                           int64_t warp, int64_t nwarps,
                                           const C& cnt, const Ln& nxt,
                                           int32_t* nn, int32_t* wbits) {
  const int lane = threadIdx.x & 31;
  for (int64_t e = warp; e < n; e += nwarps) {
    const uint32_t* row = blkT + (int64_t)cur.get(e) * W;
    for (int64_t vb = 0; vb < W; vb += 32 * WALK_WORDS) {
      uint32_t w[WALK_WORDS];
#pragma unroll
      for (int u = 0; u < WALK_WORDS; ++u) {
        const int64_t v = vb + 32 * u + lane;
        w[u] = v < W ? row[v] : 0u;
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
        for (int k = lane; k - lane < total; k += 32)
          release(k < total ? wbits[k] : -1, cnt, nxt, nn);
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
            release(((x >> lane) & 1)
                        ? (int32_t)((vb + 32 * u + src) * 32 + lane) : -1,
                    cnt, nxt, nn);
          }
          continue;
        }
        const int32_t base = (int32_t)((vb + 32 * u + lane) * 32);
        for (uint32_t x = w[u]; __any_sync(FULL, x); x &= x - 1)
          release(x ? base + __ffs(x) - 1 : -1, cnt, nxt, nn);
      }
    }
  }
}

// the same from the edge loader's lists in global memory (written before a
// grid barrier, read-only since).  A level entry is a light row (at most
// ITEM dependents) or one item of a heavy row's list (-1 - its offset: the
// list is padded with -1 to whole items); a list entry is a dependent row,
// HEAVY marking a heavy one.  A lane an entry, the entries spread over the
// warps first: a row's offset and length in one L2 round trip, then its
// dependents by 16-byte loads in another; their counts moved by atomics
// issued back to back, and the rows reaching 0 appended by one atomic a
// warp (a heavy row as its items: its offset and length in one more round
// trip)
template <class Lc, class C, class Ln>
__device__ __forceinline__ void walk_entries(const Frontier& f,
                                             const Lc& cur, int64_t n,
                                             int64_t thread, int64_t nthreads,
                                             const C& cnt, const Ln& nxt,
                                             int32_t* nn) {
  constexpr int V = ITEM / 4;
  const int lane = threadIdx.x & 31;
  const int64_t warp = thread >> 5, nw = nthreads >> 5;
  for (int64_t base = 0; base < n; base += nthreads) {
    const int64_t e = base + lane * nw + warp;
    int32_t o = 0, d = 0;
    if (e < n) {
      const int32_t x = cur.get(e);
      if (x >= 0) {
        o = f.off[x];
        d = f.deg[x];
      } else {
        o = -1 - x;
        d = ITEM;
      }
    }
    const int4* row = reinterpret_cast<const int4*>(f.dep + o);
    int4 q[V];
#pragma unroll
    for (int c = 0; c < V; ++c)
      q[c] = 4 * c < d ? row[c] : make_int4(-1, -1, -1, -1);
    int32_t dj[ITEM], old[ITEM];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      dj[4 * c] = q[c].x;
      dj[4 * c + 1] = q[c].y;
      dj[4 * c + 2] = q[c].z;
      dj[4 * c + 3] = q[c].w;
    }
#pragma unroll
    for (int u = 0; u < ITEM; ++u)
      old[u] = dj[u] >= 0 ? cnt.dec(dj[u] & ~HEAVY) : 0;
    // a ready light row is one entry (its id), a ready heavy row k >= 2
    // items (from its offset and length; rare)
    int32_t ready = 0, flags = 0;
#pragma unroll
    for (int u = 0; u < ITEM; ++u) {
      ready += old[u] == 1;
      flags |= old[u] == 1 ? dj[u] : 0;
    }
    flags = __reduce_or_sync(FULL, (flags & HEAVY) | (ready > 0));
    if (!flags) continue;
    if (!(flags & HEAVY)) {
      int32_t at = warp_reserve(ready, nn);
#pragma unroll
      for (int u = 0; u < ITEM; ++u)
        if (old[u] == 1) nxt.put(at++, dj[u]);
      continue;
    }
    int32_t k[ITEM], total = 0;
#pragma unroll
    for (int u = 0; u < ITEM; ++u) {
      const bool heavy = old[u] == 1 && (dj[u] & HEAVY);
      const int32_t i = dj[u] & ~HEAVY;
      k[u] = old[u] != 1 ? 0 : heavy ? (f.deg[i] + ITEM - 1) / ITEM : 1;
      dj[u] = heavy ? f.off[i] : i;
      total += k[u];
    }
    int32_t at = warp_reserve(total, nn);
#pragma unroll
    for (int u = 0; u < ITEM; ++u) {
      if (k[u] == 1) nxt.put(at++, dj[u]);
      else
        for (int32_t t = 0; t < k[u]; ++t)
          nxt.put(at++, -1 - (dj[u] + ITEM * t));
    }
  }
}

// the same from the dependents lists in shared memory (the first CTA
// alone): a level of more rows than warps a lane a row, else a warp a row
// and a lane a dependent
template <class Lv, class C>
__device__ __forceinline__ void walk_lists(const Lv& cur, int32_t n,
                                           const C& cnt, const int32_t* off,
                                           const uint16_t* deg,
                                           const uint16_t* dep,
                                           const Lv& nxt, int32_t* nn) {
  const int lane = threadIdx.x & 31;
  if (n > FW) {
    for (int32_t e0 = threadIdx.x - lane; e0 < n; e0 += FNT) {
      const int32_t j = e0 + lane < n ? cur.get(e0 + lane) : -1;
      const int32_t d = j >= 0 ? deg[j] : 0, o = j >= 0 ? off[j] : 0;
      for (int32_t k = 0; __any_sync(FULL, k < d); ++k)
        release(k < d ? (int32_t)dep[o + k] : -1, cnt, nxt, nn);
    }
    return;
  }
  for (int32_t e = threadIdx.x >> 5; e < n; e += FW) {
    const int32_t j = cur.get(e), d = deg[j], o = off[j];
    for (int32_t k = lane; k - lane < d; k += 32)
      release(k < d ? (int32_t)dep[o + k] : -1, cnt, nxt, nn);
  }
}

// one level's walk, by the loader's own dependents
template <class L, class Lc, class C, class Ln>
__device__ __forceinline__ void walk(const L& a, const Lc& cur, int64_t n,
                                     int64_t thread, int64_t nthreads,
                                     const C& cnt, const Ln& nxt, int32_t* nn,
                                     int32_t* wbits) {
  if constexpr (L::WORDS)
    walk_words(a.blkT, a.W, cur, n, thread >> 5, nthreads >> 5, cnt, nxt, nn,
               wbits);
  else
    walk_entries(a.f, cur, n, thread, nthreads, cnt, nxt, nn);
}

// applied and newly from the final counts, BATCH rows a thread at a time
// (their loads in flight together: the first CTA alone writes every row),
// then the rows left
template <class L, class C>
__device__ __forceinline__ void write_drained(const L& a, const C& cnt,
                                              int64_t i0, int64_t step) {
  auto write = [&](int64_t i, int32_t st, int32_t c) {
    const bool newly = st == SLOT_STABLE && c == 0;
    a.write(i, newly || st == SLOT_APPLIED, newly);
  };
  int64_t b = i0;
  for (; b + (BATCH - 1) * step < a.f.N; b += BATCH * step) {
    int32_t st[BATCH], c[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      st[u] = a.status(b + u * step);
      c[u] = cnt.get(b + u * step);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) write(b + u * step, st[u], c[u]);
  }
  for (; b < a.f.N; b += step) write(b, a.status(b), cnt.get(b));
}

// the first CTA's levels from a level of ``n`` rows in ``cur``, with
// block barriers only, while a level holds at most ``cap`` rows; step(cur,
// n, nxt, nn) walks one level.  Returns the levels walked; ``cur`` is then
// the level after them and ``last`` its size (0: none is left)
template <class Lv, class Step>
__device__ __forceinline__ int64_t block_levels(int32_t n, int32_t cap,
                                                int32_t* sn, Lv& cur, Lv& nxt,
                                                Step step, int32_t& last) {
  if (threadIdx.x < 3) sn[threadIdx.x] = threadIdx.x == 0 ? n : 0;
  __syncthreads();
  for (int64_t q = 0;; ++q) {
    const int32_t nc = sn[q % 3];
    if ((uint32_t)(nc - 1) >= (uint32_t)cap) {   // none, or wider than cap
      last = nc;
      return q;
    }
    if (threadIdx.x == 0) sn[(q + 2) % 3] = 0;
    step(cur, nc, nxt, &sn[(q + 1) % 3]);
    const Lv t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  }
}

// the counts in global memory, or in shared memory at ``fsm`` (32 bits or
// a byte a row)
template <class L, class Run>
__device__ __forceinline__ void with_counts(const L& a, bool shared,
                                            unsigned char* fsm, Run run) {
  if (!shared) {
    run(CntG{a.f.cnt});
    return;
  }
  if constexpr (L::BYTE_COUNTS) {
    if (a.f.cbytes == 1) {
      run(CntB{reinterpret_cast<uint32_t*>(fsm)});
      return;
    }
  }
  run(CntS{reinterpret_cast<int32_t*>(fsm)});
}

// 2. the first CTA alone from round r's level of n entries (at most the
// handover).  Shared memory holds the counts while they fit; then, while N
// < 2^16 and all fit, a tile loader's two levels and dependents lists as
// 16-bit rows, else the first ``handover`` entries of two levels (a level
// it walks is never wider).  It walks the levels until one is wider than
// the handover, which it hands back to the grid (its entries and the
// counts written to global memory, its size to nlist), or none is left (it
// writes the outputs and the sweeps while the counts are its own).
// Returns the round of the level handed back, or -1
template <class L>
__device__ __forceinline__ int64_t first_cta(const L& a, int64_t r, int32_t n,
                                             unsigned char* fsm, int32_t* sn,
                                             int32_t* wbits) {
  const Frontier& f = a.f;
  const int64_t N = f.N;
  const int64_t lcap = f.handover;
  const int64_t E = ld_l2(&f.nlist[3]);
  const int64_t ncnt = (f.cbytes * N + 15) & ~(int64_t)15;
  const bool scnt = ncnt + 8 * lcap <= (int64_t)FIX_SMEM;
  const bool slists = L::WORDS && scnt && N < 65536 && E <= f.cap &&
                      ncnt + 10 * N + 2 * E <= (int64_t)FIX_SMEM;
  unsigned char* lvs = fsm + (scnt ? ncnt : 0);
  int32_t* gcur = f.list + (r & 1) * f.L;
  auto stage_count = [&](int64_t i, int32_t v) {
    if (f.cbytes == 1) fsm[i] = (uint8_t)v;
    else reinterpret_cast<int32_t*>(fsm)[i] = v;
  };
  if (scnt) {   // BATCH rows a thread at a time, then the rest
    int64_t b = threadIdx.x;
    for (; b + (BATCH - 1) * FNT < N; b += BATCH * FNT) {
      int32_t v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) v[u] = __ldcg(f.cnt + b + u * FNT);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) stage_count(b + u * FNT, v[u]);
    }
    for (; b < N; b += FNT) stage_count(b, __ldcg(f.cnt + b));
  }
  // two levels of 16-bit rows, offsets, 16-bit lengths and lists
  uint16_t* scur = reinterpret_cast<uint16_t*>(lvs);
  int32_t* soff = reinterpret_cast<int32_t*>(lvs + 4 * N);
  uint16_t* sdeg = reinterpret_cast<uint16_t*>(soff + N);
  uint16_t* sdep = sdeg + N;
  if (slists) {
    for (int e = threadIdx.x; e < n; e += FNT)
      scur[e] = (uint16_t)__ldcg(gcur + e);
    for (int64_t i = threadIdx.x; i < N; i += FNT) {
      soff[i] = __ldcg(f.off + i);
      sdeg[i] = (uint16_t)__ldcg(f.deg + i);
    }
    for (int64_t k = threadIdx.x; k < E; k += FNT)
      sdep[k] = (uint16_t)__ldcg(f.dep + k);
  } else {
    for (int e = threadIdx.x; e < n; e += FNT)
      reinterpret_cast<int32_t*>(lvs)[e] = __ldcg(gcur + e);
  }
  int64_t handed = -1;
  with_counts(a, scnt, fsm, [&](auto cnt) {
    int32_t last;
    // the level reached (its first ``cap`` entries in ``cur``)
    auto finish = [&](const auto& cur, int64_t cap) {
      if (last == 0 && scnt) {
        write_drained(a, cnt, threadIdx.x, FNT);
        if (threadIdx.x == 0) *f.sweeps = (int32_t)(r + 1);
        return;
      }
      // (with the counts in global memory an empty level goes back too:
      // the grid writes the outputs)
      int32_t* g = f.list + (r & 1) * f.L;
      for (int64_t e = threadIdx.x; e < min64(last, cap); e += FNT)
        g[e] = cur.get(e);
      if (scnt)
        for (int64_t i = threadIdx.x; i < N; i += FNT) f.cnt[i] = cnt.get(i);
      if (threadIdx.x == 0) {
        f.nlist[r % 3] = last;
        f.nlist[(r + 1) % 3] = 0;
      }
      handed = r;
    };
    if (slists) {
      LvS cur{scur}, nxt{scur + N};
      r += block_levels(n, f.handover, sn, cur, nxt,
                        [&](const LvS& c, int32_t nc, const LvS& x,
                            int32_t* nn) {
                          walk_lists(c, nc, cnt, soff, sdeg, sdep, x, nn);
                        }, last);
      finish(cur, N);
    } else {
      int32_t* s0 = reinterpret_cast<int32_t*>(lvs);
      LvX cur{s0, gcur, lcap};
      LvX nxt{s0 + lcap, f.list + ((r + 1) & 1) * f.L, lcap};
      r += block_levels(n, f.handover, sn, cur, nxt,
                        [&](const LvX& c, int32_t nc, const LvX& x,
                            int32_t* nn) {
                          walk(a, c, nc, threadIdx.x, FNT, cnt, x, nn, wbits);
                        }, last);
      finish(cur, lcap);
    }
  });
  return handed;
}

template <class L>
__device__ __forceinline__ void frontier_levels(const L& a,
                                                cg::grid_group& grid) {
  extern __shared__ __align__(16) unsigned char fsm[];
  __shared__ int32_t sn[3], s_word;
  __shared__ int32_t s_bits[FW * WALK_SPREAD];
  const Frontier& f = a.f;
  const int64_t tid = (int64_t)blockIdx.x * FNT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * FNT;
  int32_t* wbits = s_bits + (threadIdx.x >> 5) * WALK_SPREAD;
  const CntG gcnt{f.cnt};
  int64_t r = 0;
  int32_t n = ld_l2(&f.nlist[0]), word = 0;
  for (;;) {
    // 1. the wide levels, the grid on each: level r + 1 is list[r & 1],
    // its size nlist[r % 3]; the size of the level after next is cleared
    while (n > f.handover) {
      if (tid == 0) f.nlist[(r + 2) % 3] = 0;
      walk(a, LvG{f.list + (r & 1) * f.L}, n, tid, nthreads, gcnt,
           LvG{f.list + ((r + 1) & 1) * f.L}, f.nlist + (r + 1) % 3, wbits);
      ++r;
      grid.sync();
      n = ld_l2(&f.nlist[r % 3]);
    }
    if (n == 0) {   // drained on the grid
      write_drained(a, gcnt, tid, nthreads);
      if (tid == 0) *f.sweeps = (int32_t)(r + 1);
      return;
    }
    // 2. the first CTA while the levels hold at most the handover; the
    // others wait for its hand-off word (nlist[4]): the round of a level it
    // hands back, or -1 when it has finished
    if (blockIdx.x == 0) {
      const int64_t handed = first_cta(a, r, n, fsm, sn, wbits);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        s_word = (int32_t)handed;
        *(volatile int32_t*)&f.nlist[4] = s_word;
      }
    } else if (threadIdx.x == 0) {
      int32_t v;
      while ((v = ld_l2(&f.nlist[4])) == word) __nanosleep(64);
      __threadfence();
      s_word = v;
    }
    __syncthreads();
    word = s_word;
    if (word < 0) return;
    r = word;
    n = ld_l2(&f.nlist[r % 3]);
  }
}

// one CTA an SM (as the shared memory allows): the registers a lane's
// dependents and counts take in the edge loader's walk
template <class L>
__global__ void __launch_bounds__(FNT, 1)
frontier_kernel(const __grid_constant__ L a) {
  cg::grid_group grid = cg::this_grid();
  a.prologue(grid);
  frontier_levels(a, grid);
}

// the dense loaders' workspace in int32 words for N rows: blk and blkT
// (N x W each), the applied words (W), counts, list offsets and degrees
// (N each), the dependents lists (DEP_CAP), two levels (2N), five words
inline int64_t tile_workspace_words(int64_t N) {
  const int64_t W = (N + 31) / 32;
  return 2 * N * W + W + 5 * N + DEP_CAP + 5;
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) |
         (x & 0xff0000u ? 4u : 0u) | (x & 0xff000000u ? 8u : 0u);
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint4 x) {
  return nonzero_bytes(x.x) | (nonzero_bytes(x.y) << 4) |
         (nonzero_bytes(x.z) << 8) | (nonzero_bytes(x.w) << 12);
}

// The tile loader, over a bool adjacency whose rows and columns ``Src``
// reads: row(i) (N bytes), status / emsb / elsb / enode / awaits(i) and
// write(i, applied, newly).
//   1. tiles of 32 rows x 32 deps, a warp each: the gating bits of the
//      lane's row (16-byte reads of the bool adjacency when ``vec``, the
//      dep's columns by shuffle), packed row-major ([N, W] words, for the
//      counts) and, by 32 ballots, transposed to the Stable rows each dep
//      gates ([N, W]); the words of the rows applied at the start;
//   2. a warp a Stable row: its count (rows at 0 form the first level)
//      and the rows it gates as a list (placed by one atomic for a CTA's
//      rows, kept while all fit in DEP_CAP).
// Bound: one read of the adjacency; a level then walks its rows' lists or
// transposed words.
template <class Src>
struct TileLoader {
  static constexpr bool WORDS = true;
  static constexpr bool BYTE_COUNTS = false;
  Src src;
  Frontier f;
  uint32_t* blk;    // [N, W] gating deps of row i (bit b of word v: 32v+b)
  uint32_t* blkT;   // [N, W] the Stable rows dep j gates (word v: rows 32v..)
  uint32_t* app0;   // [W] rows applied at the start
  int64_t W;
  int vec;          // rows 16-byte aligned: read the adjacency by uint4

  __device__ __forceinline__ int32_t status(int64_t i) const {
    return src.status(i);
  }
  __device__ __forceinline__ void write(int64_t i, bool applied,
                                        bool newly) const {
    src.write(i, applied, newly);
  }

  __device__ void prologue(cg::grid_group& grid) const {
    __shared__ int32_t s_pre[FW], s_base;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int64_t warp = (int64_t)blockIdx.x * FW + wid;
    const int64_t nwarps = (int64_t)gridDim.x * FW;
    const int64_t N = f.N;

    // 1. the gating bits, a warp a tile of 32 rows (lane: row 32I + lane)
    // by 32 deps (lane: the columns of dep 32J + lane)
    if (blockIdx.x == 0 && threadIdx.x < 5) f.nlist[threadIdx.x] = 0;
    // the adjacency bits of the lane's row in tile t, the next tile's
    // loaded while this one is worked on
    auto adj_bits = [&](int64_t t) -> uint32_t {
      const int64_t I = t / W, J = t - I * W, i = I * 32 + lane;
      if (t >= W * W || i >= N) return 0u;
      const uint8_t* row = src.row(i) + J * 32;
      const int64_t nb = min64(32, N - J * 32);
      if (vec && nb == 32) {
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
        si = src.status(i);
        mi = src.emsb(i);
        li = src.elsb(i);
        ni = src.enode(i);
        awi = src.awaits(i) != 0;
      }
      if (j < N) {
        sj = src.status(j);
        mj = src.emsb(j);
        lj = src.elsb(j);
        nj = src.enode(j);
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
      if (i < N) blk[i * W + J] = g;
      const uint32_t tg = si == SLOT_STABLE ? g : 0u;
      uint32_t mine = 0;
      for (unsigned x = __reduce_or_sync(FULL, tg); x; x &= x - 1) {
        const int b = __ffs(x) - 1;
        const uint32_t word = __ballot_sync(FULL, (tg >> b) & 1);
        if (lane == b) mine = word;
      }
      if (j < N) blkT[j * W + I] = mine;
      if (I == 0) {
        const uint32_t ap = __ballot_sync(FULL, sj == SLOT_APPLIED);
        if (lane == 0) app0[J] = ap;
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
      const bool stable = i < N && src.status(i) == SLOT_STABLE;  // per warp
      int c = 0, d = 0;
      if (stable) {
        for (int64_t v = lane; v < W; v += 32) {
          c += __popc(blk[i * W + v] & ~app0[v]);
          d += __popc(blkT[i * W + v]);
        }
        c = __reduce_add_sync(FULL, c);
        d = __reduce_add_sync(FULL, d);
        if (lane == 0) {
          f.cnt[i] = c;
          if (c == 0) f.list[atomicAdd(&f.nlist[0], 1)] = (int32_t)i;
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
        if (lane == 31) s_base = atomicAdd(&f.nlist[3], inc);
        if (lane < FW) s_pre[lane] = inc - x;
      }
      __syncthreads();
      if (stable) {
        const int64_t o = (int64_t)s_base + s_pre[wid];
        if (lane == 0) {
          f.off[i] = (int32_t)min64(o, INT32_MAX);
          f.deg[i] = d;
        }
        if (d && o + d <= DEP_CAP) {
          int32_t run = 0;
          for (int64_t vb = 0; vb < W; vb += 32) {
            const int64_t v = vb + lane;
            uint32_t x = v < W ? blkT[i * W + v] : 0u;
            int inc = __popc(x);
#pragma unroll
            for (int s2 = 1; s2 < 32; s2 <<= 1) {
              const int y = __shfl_up_sync(FULL, inc, s2);
              if (lane >= s2) inc += y;
            }
            int32_t at = (int32_t)o + run + inc - __popc(x);
            for (; x; x &= x - 1)
              f.dep[at++] = (int32_t)(v * 32 + __ffs(x) - 1);
            run += __shfl_sync(FULL, inc, 31);
          }
        }
      }
      __syncthreads();   // s_pre and s_base are the next rows'
    }
    grid.sync();
  }
};

// A tile loader over the workspace ``ws`` of tile_workspace_words(N)
// words; the caller fills ``src``, ``vec`` and ``f.sweeps``
template <class Src>
inline TileLoader<Src> tile_loader(const Src& src, int64_t N, uint32_t* ws) {
  TileLoader<Src> a;
  a.src = src;
  a.W = (N + 31) / 32;
  a.blk = ws;
  a.blkT = a.blk + N * a.W;
  a.app0 = a.blkT + N * a.W;
  a.f.cnt = (int32_t*)(a.app0 + a.W);
  a.f.off = a.f.cnt + N;
  a.f.deg = a.f.off + N;
  a.f.dep = a.f.deg + N;
  a.f.list = a.f.dep + DEP_CAP;
  a.f.nlist = a.f.list + 2 * N;
  a.f.N = N;
  a.f.L = N;
  a.f.cap = DEP_CAP;
  a.f.handover = ACCORD_DRAIN_HANDOVER;
  a.f.cbytes = 4;
  a.vec = 0;
  return a;
}

}  // namespace
