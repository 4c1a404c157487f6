// K1: the PreAccept deps scan, as two entry points sharing one exact
// predicate and one row compaction.
//
// Replaces (JAX reference, accord_tpu/ops/deps_kernel.py):
//   deps_bucketed  <- bucketed_flat (:448, jitted :548) with _compact_rows (:287),
//                     and its row_offset form (:466) for a row-sharded slice
//                     (accord_tpu/parallel/sharded.py:287, :519)
//   deps_dense     <- flat_csr_local (:351) = _dep_mask_and_conflict (:174)
//                     + _compact_topk (:238) + _triple_codes (:343)
//                     + _compact_rows (:287)
// Output, byte-equal to the reference: header int32[2+B] = (total, maxc,
// row_end[B]) and entries[s] (int32 or int64 composite codes
// slot*M_t*Q + col*Q + q, ascending and unique per row, -1 elsewhere).
//
// deps_bucketed.  Bound on this card: it reads each touched bucket line
// and the wide list once per query (bytes), plus a per-row sort of the few
// codes that pass the predicate.  Most calls are small (the burn's
// flushes), so a call is one cooperative launch with no memset, three
// phases between grid barriers, every buffer carved from one workspace
// (accord_bucketed_workspace_words):
//   1. a CTA a query row: each candidate is evaluated once (its slot,
//      then the rest of a live entry), a lane EU at a time with their
//      loads in flight together, four CTAs an SM (the scan is bound by
//      the latency of its gathers), and ballots place the valid codes in
//      a shared buffer (one shared atomic a warp's 32 x EU, their order
//      kept within the warp).  A row of at most 32 codes is sorted by one warp
//      in registers (a bitonic network of shuffles), deduplicated by its
//      neighbour and cut at kk, with no block barrier; a longer row sorts
//      its nv codes as warp-sorted runs of 32 merged pairwise (a search a
//      code a round, one block barrier a round), then keeps the first of
//      each run of equal codes up to kk.  Rows with more candidates than
//      SMEM_CODES sort in a global scratch of their CTA instead;
//   2. one CTA scans the row counts into the header and the row starts;
//   3. a CTA a row copies its kept codes to its offset, truncated at s,
//      with -1 in a row's positions past kk and after the total, as the
//      reference's _compact_rows lays them out.
//
// deps_dense.  Bound on this card: operations, B x N (row, slot) tests of
// up to m x m_t interval pairs, two int64 compares a pair.  A design of
// one block a query row walking the whole table (the first port) reads
// the table once a row and leaves the card with two blocks an SM, each a
// chain of block scans.  Now the slots are tiled across CTAs, so that one
// staged group of query rows serves a tile of slots and one slot in
// registers serves the group (the predicate and its exact filters are
// dense_tile.cuh's).  One cooperative launch, four phases between grid
// barriers, every scratch buffer carved from one workspace
// (accord_dense_workspace_words), no memset:
//   1. items of (256 slots x 32 query rows): a thread holds its slot, and
//      for each staged row a warp ballots its 32 mask bits into one word
//      and sums its triple counts: mask words and word sums [B, N/32];
//   2. a CTA a row: the popcount prefix finds the word where the mask rank
//      crosses kp = min(k, N), which keeps only its first bits (one warp
//      recounts that word's triples); the selected triples' count, the
//      mask count and each selected word's triple offset;
//   3. one CTA scans the counts into the header and the row starts;
//   4. a warp takes 32 words of a row and walks their selected slots in
//      order from each word's offset: for one slot its lanes test 32
//      (col, q) pairs at a time and a ballot places the overlapping ones,
//      up to kk a row; then -1 after the total and in a row's positions
//      past kk.  (Not a lane a slot, each recounting its pairs: that
//      phase took most of the call at the recorded shape; the pairs of
//      one slot are the parallel work, the selected slots of a word few.)
// Why one cooperative launch and not three plain ones: phases 2 and 3
// each need every CTA of the phase before, the small calls (the burn's
// flushes) are all host path and launch latency, and the grid barriers
// cost a few microseconds where the launches and the memset they replace
// cost more.
#include <cooperative_groups.h>

#include "common.cuh"
#include "dense_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// threads a CTA (ops/_build.py GEOMETRY)
constexpr int NT = ACCORD_DEPS_THREADS;

template <typename T>
__device__ __forceinline__ T sentinel();
template <>
__device__ __forceinline__ int32_t sentinel<int32_t>() { return 0x7fffffff; }
template <>
__device__ __forceinline__ int64_t sentinel<int64_t>() {
  return 0x7fffffffffffffffLL;
}

struct Query {
  int64_t bm, bl, sm, sl;
  int32_t bn, wit, sn;
};

__device__ __forceinline__ Query load_query(const int64_t* row) {
  Query q;
  q.bm = row[0];
  q.bl = row[1];
  q.bn = (int32_t)row[2];
  q.wit = (int32_t)row[3];
  q.sm = row[4];
  q.sl = row[5];
  q.sn = (int32_t)row[6];
  return q;
}

// the exact per-entry predicate shared by both routes: witnessed kind,
// strictly earlier than the bound, not the query itself, not below the
// batch prune floor
__device__ __forceinline__ bool entry_pred(const Query& q, int64_t em,
                                           int64_t el, int32_t en,
                                           int32_t kind, int64_t pm,
                                           int64_t pl, int32_t pn) {
  return ((q.wit >> kind) & 1) && ts_lt(em, el, en, q.bm, q.bl, q.bn) &&
         !ts_eq(em, el, en, q.sm, q.sl, q.sn) &&
         !ts_lt(em, el, en, pm, pl, pn);
}

struct BucketArgs {
  const int64_t* qmat;
  const int64_t *blo, *bhi, *bmsb, *blsb;
  const int32_t *bslot, *bcol, *bnode, *bkind;
  const int64_t *wlo, *whi, *wmsb, *wlsb;
  const int32_t *wslot, *wcol, *wnode, *wkind;
  int qcols, m, span, K, keff, W, m_t;
  int64_t pm, pl;
  int32_t pn;
  int C, kk;
  // row-sharded slice: global bucket rows translate to [0, G) by - roff,
  // rows outside the slice read as no bucket (has_roff == 0: unsharded)
  int has_roff, roff, G;
};

__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// candidates a lane of K1a evaluates at once: their loads are issued
// together, one round trip for the slots and one for the rest
constexpr int EU = 2;

// candidates cb + 32u + lane (u < EU) of a row: (valid, code) each.
// Candidates [0, m*span*keff) are the touched bucket lines (probe p = c /
// keff probes query interval p / span); the rest cross the wide list with
// every query interval.  An entry's slot is read first; its interval,
// timestamp, kind and column only if the slot is live.
template <typename T>
__device__ __forceinline__ void bucket_candidates(const BucketArgs& a,
                                                  const int64_t* row,
                                                  const Query& q, int cb,
                                                  bool* valid, T* code) {
  const int nb = a.m * a.span * a.keff;
  const int64_t mq = (int64_t)a.m_t * a.m;
  const int lane = threadIdx.x & 31;
  int64_t at[EU];   // the entry's index, -1: none
  bool wide[EU];
  int qi[EU];
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    const int c = cb + 32 * u + lane;
    at[u] = -1;
    wide[u] = c >= nb;
    qi[u] = 0;
    if (c < nb) {
      const int p = c / a.keff;
      qi[u] = p / a.span;
      int32_t g = (int32_t)ldg64(row + 7 + 2 * a.m + p);
      if (a.has_roff) {
        const int32_t l = g - a.roff;
        g = (g >= 0 && l >= 0 && l < a.G) ? l : -1;
      }
      if (g >= 0) at[u] = (int64_t)g * a.K + (c - p * a.keff);
    } else if (c < a.C) {
      qi[u] = (c - nb) / a.W;
      at[u] = c - nb - (int64_t)qi[u] * a.W;
    }
  }
  int32_t slot[EU];
#pragma unroll
  for (int u = 0; u < EU; ++u)
    slot[u] = at[u] < 0 ? -1 : (wide[u] ? a.wslot : a.bslot)[at[u]];
  int64_t lo[EU], hi[EU], em[EU], el[EU];
  int32_t en[EU], ek[EU], col[EU];
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    if (slot[u] < 0) continue;
    const int64_t x = at[u];
    lo[u] = (wide[u] ? a.wlo : a.blo)[x];
    hi[u] = (wide[u] ? a.whi : a.bhi)[x];
    em[u] = (wide[u] ? a.wmsb : a.bmsb)[x];
    el[u] = (wide[u] ? a.wlsb : a.blsb)[x];
    en[u] = (wide[u] ? a.wnode : a.bnode)[x];
    ek[u] = (wide[u] ? a.wkind : a.bkind)[x];
    col[u] = (wide[u] ? a.wcol : a.bcol)[x];
  }
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    valid[u] = false;
    if (slot[u] < 0) continue;
    const int64_t qlo = ldg64(row + 7 + qi[u]);
    const int64_t qhi = ldg64(row + 7 + a.m + qi[u]);
    valid[u] = lo[u] <= qhi && qlo <= hi[u] &&
               entry_pred(q, em[u], el[u], en[u], ek[u], a.pm, a.pl, a.pn);
    code[u] = (T)((T)slot[u] * (T)mq + (T)col[u] * (T)a.m + (T)qi[u]);
  }
}

constexpr unsigned FULL = 0xffffffffu;
// codes a row sorts in shared memory (ops/kernels.py SMEM_CODES); a row
// with more candidates sorts in its CTA's global scratch
constexpr int SMEM_CODES = 4096;
// CTAs of a launch whose rows sort in global scratch: the scratch the
// workspace holds
constexpr int GLOBAL_CTAS = 512;

__host__ __device__ __forceinline__ int64_t round32(int64_t n) {
  return (n + 31) & ~(int64_t)31;
}

// ascending bitonic sort of one code a lane across a warp
template <typename T>
__device__ __forceinline__ T warp_sort32(T x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const T y = __shfl_xor_sync(FULL, x, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      x = keep_min ? (y < x ? y : x) : (y < x ? x : y);
    }
  return x;
}

// codes of x[0:n) below v / not above v
template <typename T>
__device__ __forceinline__ int count_below(const T* x, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
template <typename T>
__device__ __forceinline__ int count_not_above(const T* x, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ascending sort of a[0:n) by the block (n > 32): warp-sorted runs of 32
// (the last padded with the sentinel), then pairwise merges into the
// other buffer, a code placed by its rank in the partner run (equal codes:
// the left run's first).  Returns the buffer that holds the result.
template <typename T>
__device__ T* block_merge_sort(T* a, T* b, int n) {
  const int lane = threadIdx.x & 31;
  const int n32 = (int)round32(n);
  for (int r = threadIdx.x - lane; r < n32; r += NT) {
    const int i = r + lane;
    a[i] = warp_sort32(i < n ? a[i] : sentinel<T>(), lane);
  }
  __syncthreads();
  for (int w = 32; w < n32; w <<= 1) {
    for (int i = threadIdx.x; i < n32; i += NT) {
      const int base = i & ~(2 * w - 1), in = i - base;
      const T x = a[i];
      const int right = mini(w, maxi(0, n32 - base - w));
      b[base + (in < w ? in + count_below(a + base + w, right, x)
                       : in - w + count_not_above(a + base, w, x))] = x;
    }
    __syncthreads();
    T* t = a;
    a = b;
    b = t;
  }
  return a;
}

struct BucketOut {
  int32_t* hdr;
  void* ent;
  int64_t* starts;   // [B + 1] row starts, then the total
  int32_t* counts;   // [B] unique codes a row (uncut)
  void* rowbuf;      // [B, kk] a row's first kk unique codes
  void* scratch;     // [GLOBAL_CTAS, 2, round32(C)] (rows past SMEM_CODES)
  int64_t s;
  int B;
};

struct BucketParams {
  BucketArgs a;
  BucketOut o;
};

// four CTAs an SM (64 registers a thread): the scan is bound by the
// latency of its gathers, so CTAs in flight matter more than registers
template <typename T, bool SMEM>
__global__ void __launch_bounds__(NT, 4) bucketed_csr(BucketParams P) {
  cg::grid_group grid = cg::this_grid();
  const BucketArgs& a = P.a;
  const BucketOut& o = P.o;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_fill[2], s_max;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t c32 = round32(a.C);
  T* buf = SMEM ? reinterpret_cast<T*>(smem_raw)
                : (T*)o.scratch + (int64_t)blockIdx.x * 2 * c32;
  T* alt = buf + c32;
  T* rowbuf = (T*)o.rowbuf;

  // 1. a CTA a row: candidates once, ballot-placed; sort, dedupe, kk cut.
  // A row fills s_fill[it & 1] and clears the other for the next row
  if (threadIdx.x < 2) s_fill[threadIdx.x] = 0;
  int it = 0;
  for (int b = blockIdx.x; b < o.B; b += gridDim.x, ++it) {
    const int64_t* row = a.qmat + (int64_t)b * a.qcols;
    const Query q = load_query(row);
    __syncthreads();   // the previous row's buffer and count are read
    if (threadIdx.x == 0) s_fill[(it + 1) & 1] = 0;
    for (int cb = (threadIdx.x - lane) * EU; cb < a.C; cb += NT * EU) {
      bool v[EU];
      T code[EU];
      bucket_candidates<T>(a, row, q, cb, v, code);
      unsigned bal[EU];
      int n = 0;
#pragma unroll
      for (int u = 0; u < EU; ++u) {
        bal[u] = __ballot_sync(FULL, v[u]);
        n += __popc(bal[u]);
      }
      int base = 0;
      if (lane == 0 && n) base = atomicAdd(&s_fill[it & 1], n);
      base = __shfl_sync(FULL, base, 0);
#pragma unroll
      for (int u = 0; u < EU; ++u) {
        if (v[u]) buf[base + __popc(bal[u] & below)] = code[u];
        base += __popc(bal[u]);
      }
    }
    __syncthreads();
    const int nv = s_fill[it & 1];
    T* out = rowbuf + (int64_t)b * a.kk;
    if (nv <= 32) {
      if (threadIdx.x < 32) {
        const T x = warp_sort32(lane < nv ? buf[lane] : sentinel<T>(), lane);
        const T prev = __shfl_up_sync(FULL, x, 1);
        const bool u = lane < nv && (lane == 0 || x != prev);
        const unsigned keep = __ballot_sync(FULL, u);
        const int r = __popc(keep & below);
        if (u && r < a.kk) out[r] = x;
        if (lane == 0) o.counts[b] = __popc(keep);
      }
      continue;
    }
    const T* srt = block_merge_sort(buf, alt, nv);
    if (threadIdx.x < 32) {   // one warp keeps the first of each run
      int run = 0;
      for (int i = lane; i - lane < nv; i += 32) {
        const bool u = i < nv && (i == 0 || srt[i] != srt[i - 1]);
        const unsigned keep = __ballot_sync(FULL, u);
        const int r = run + __popc(keep & below);
        if (u && r < a.kk) out[r] = srt[i];
        run += __popc(keep);
      }
      if (lane == 0) o.counts[b] = run;
    }
  }
  grid.sync();

  // 2. one CTA: row_end = cumsum(counts), the header, the row starts
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) s_max = 0;
    long long run = 0;
    int mx = 0;
    for (int base = 0; base < o.B; base += NT) {
      const int b = base + threadIdx.x;
      const int v = b < o.B ? o.counts[b] : 0;
      mx = maxi(mx, v);
      long long tot;
      const long long e = block_exclusive_scan<NT, long long>(v, &tot);
      if (b < o.B) {
        o.starts[b] = run + e;
        o.hdr[2 + b] = (int32_t)(run + e + v);
      }
      run += tot;
    }
    atomicMax(&s_max, mx);
    __syncthreads();
    if (threadIdx.x == 0) {
      o.hdr[0] = (int32_t)run;
      o.hdr[1] = s_max;
      o.starts[o.B] = run;
    }
  }
  grid.sync();

  // 3. a CTA a row: its kept codes at its offset, -1 past kk; then -1
  // after the total
  T* ent = (T*)o.ent;
  for (int b = blockIdx.x; b < o.B; b += gridDim.x) {
    const int c = o.counts[b];
    const int64_t st = o.starts[b];
    const int64_t end = min64(st + c, o.s);
    const T* src = rowbuf + (int64_t)b * a.kk;
    for (int64_t p = st + threadIdx.x; p < end; p += NT)
      ent[p] = p - st < a.kk ? src[p - st] : (T)-1;
  }
  for (int64_t p = min64(o.starts[o.B], o.s) + (int64_t)blockIdx.x * NT +
                   threadIdx.x;
       p < o.s; p += (int64_t)gridDim.x * NT)
    ent[p] = (T)-1;
}

// the workspace's int64 words: row starts (B + 1), counts (B, 32 bits),
// the rows' kept codes (B x kk) and, for rows past SMEM_CODES, the
// scratch of GLOBAL_CTAS CTAs (two buffers of round32(C) codes each)
int64_t bucketed_workspace_words(int64_t B, int64_t C, int64_t kk,
                                 bool wide) {
  const int64_t cs = wide ? 8 : 4;
  const int64_t scratch =
      C > SMEM_CODES ? min64(B, GLOBAL_CTAS) * 2 * round32(C) : 0;
  return (B + 1) + (B + 1) / 2 + (B * kk * cs + 7) / 8 +
         (scratch * cs + 7) / 8;
}

template <typename T>
int launch_bucketed(void* const* p, const int64_t* v, cudaStream_t st) {
  BucketParams P;
  BucketArgs& a = P.a;
  BucketOut& o = P.o;
  a.qmat = (const int64_t*)p[0];
  a.blo = (const int64_t*)p[1];
  a.bhi = (const int64_t*)p[2];
  a.bslot = (const int32_t*)p[3];
  a.bcol = (const int32_t*)p[4];
  a.bmsb = (const int64_t*)p[5];
  a.blsb = (const int64_t*)p[6];
  a.bnode = (const int32_t*)p[7];
  a.bkind = (const int32_t*)p[8];
  a.wlo = (const int64_t*)p[9];
  a.whi = (const int64_t*)p[10];
  a.wslot = (const int32_t*)p[11];
  a.wcol = (const int32_t*)p[12];
  a.wmsb = (const int64_t*)p[13];
  a.wlsb = (const int64_t*)p[14];
  a.wnode = (const int32_t*)p[15];
  a.wkind = (const int32_t*)p[16];
  const int64_t B = v[0];
  a.qcols = (int)v[1];
  a.m = (int)v[2];
  a.span = (int)v[3];
  a.K = (int)v[4];
  a.keff = (int)v[5];
  a.W = (int)v[6];
  a.pm = v[7];
  a.pl = v[8];
  a.pn = (int32_t)v[9];
  a.m_t = (int)v[10];
  const int64_t s = v[12], k = v[13];
  a.has_roff = (int)v[14];
  a.roff = (int)v[15];
  a.G = (int)v[16];
  const int64_t C = (int64_t)a.m * a.span * a.keff + (int64_t)a.m * a.W;
  if (B < 1 || B > INT32_MAX || a.m < 0 || a.span < 0 || a.keff < 0 ||
      a.keff > a.K || a.W < 0 || C > INT32_MAX / 2 ||
      a.qcols != 7 + 2 * a.m + a.m * a.span || s < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  a.C = (int)C;
  a.kk = (int)min64(k, C);
  if (v[17] < bucketed_workspace_words(B, C, a.kk, sizeof(T) == 8))
    return (int)cudaErrorInvalidValue;
  o.hdr = (int32_t*)p[18];
  o.ent = p[19];
  int64_t* ws = (int64_t*)p[17];
  o.starts = ws;
  o.counts = (int32_t*)(ws + B + 1);
  o.rowbuf = ws + (B + 1) + (B + 1) / 2;
  o.scratch = (unsigned char*)o.rowbuf + ((B * a.kk * sizeof(T) + 7) / 8) * 8;
  o.s = s;
  o.B = (int)B;
  if (C <= SMEM_CODES)
    return launch_cooperative(bucketed_csr<T, true>, NT, B, P, st,
                              2 * SMEM_CODES * sizeof(T));
  return launch_cooperative(bucketed_csr<T, false>, NT,
                            min64(B, GLOBAL_CTAS), P, st);
}

// -- K1b: the dense route, tiled across slots ---------------------------------

// query rows a pass-1 item stages, and the query intervals they may hold
constexpr int DR = 32;
constexpr int DQ = 1024;

struct DenseParams {
  dense_tile::Table t;
  const int64_t* qmat;
  int64_t* starts;    // [B + 1] row starts, then the total
  uint32_t* maskw;    // [B, W] mask words (bit l of word w: slot 32w + l)
  int32_t* tpre;      // [B, W] triples of each word, then their prefix
  int32_t* counts;    // [B] selected triples
  int32_t* pairc;     // [B] mask bits
  int32_t* nsel;      // [B] leading words that hold the selected slots
  int32_t* hdr;
  void* ent;
  int64_t s;
  int B, qcols, m, W, kp, kk, rows;
};

template <typename T, int MT>
__global__ void __launch_bounds__(NT) dense_csr(DenseParams a) {
  namespace dt = dense_tile;
  cg::grid_group grid = cg::this_grid();
  __shared__ dt::Row srow[DR];
  __shared__ int64_t sq[2 * DQ];
  __shared__ int s_cut, s_csum;
  __shared__ unsigned s_cword;
  __shared__ int s_max;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int m = a.m, m_t = a.t.m_t;

  // 1. mask words and their triple sums: one item is NT slots (one a
  // thread, in registers) against a group of staged query rows
  const int64_t ntiles = ((int64_t)a.t.N + NT - 1) / NT;
  const int64_t ngroups = (a.B + a.rows - 1) / a.rows;
  for (int64_t item = blockIdx.x; item < ntiles * ngroups;
       item += gridDim.x) {
    const int64_t tile = item % ntiles;
    const int b0 = (int)(item / ntiles) * a.rows;
    const int nr = mini(a.rows, a.B - b0);
    __syncthreads();   // the previous item's rows are read
    for (int r = threadIdx.x; r < nr; r += NT)
      srow[r] = dt::load_row(a.qmat + (int64_t)(b0 + r) * a.qcols, m);
    for (int i = threadIdx.x; i < nr * m; i += NT) {
      const int r = i / m, qi = i - r * m;
      const int64_t* q = a.qmat + (int64_t)(b0 + r) * a.qcols;
      sq[i] = q[7 + qi];
      sq[DQ + i] = q[7 + m + qi];
    }
    __syncthreads();
    const int64_t j = tile * NT + threadIdx.x;
    const dt::Slot<MT> slot = dt::load_slot<MT>(a.t, j);
    const int64_t w = j >> 5;
    for (int r = 0; r < nr; ++r) {
      int n = 0;
      if (dt::row_admits(srow[r], slot))
        n = dt::pair_count(srow[r], slot, sq + r * m, sq + DQ + r * m, m,
                           m_t);
      const unsigned word = __ballot_sync(0xffffffffu, n > 0);
      const int sum = __reduce_add_sync(0xffffffffu, n);
      if (lane == 0 && w < a.W) {
        const int64_t o = (int64_t)(b0 + r) * a.W + w;
        a.maskw[o] = word;
        a.tpre[o] = sum;
      }
    }
  }
  grid.sync();

  // 2. per row: the mask count, the word where the rank crosses kp (only
  // its first bits stay), the selected triples and each selected word's
  // triple offset in the row
  const int per = (a.W + NT - 1) / NT;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    uint32_t* mw = a.maskw + (int64_t)b * a.W;
    int32_t* tp = a.tpre + (int64_t)b * a.W;
    const int w0 = mini(threadIdx.x * per, a.W), w1 = mini(w0 + per, a.W);
    int pc = 0;
    for (int w = w0; w < w1; ++w) pc += __popc(mw[w]);
    if (threadIdx.x == 0) {
      s_cut = a.W;
      s_cword = 0;
      s_csum = 0;
    }
    int ptot;
    const int pex = block_exclusive_scan<NT, int>(pc, &ptot);
    int run = pex;
    // (a segment that starts past kp may begin with empty words: only a
    // word with bits decides anything, and only the one thread whose
    // segment holds the crossing word writes s_cword)
    for (int w = w0; w < w1; ++w) {
      const unsigned x = mw[w];
      const int p = __popc(x);
      if (p == 0) continue;
      if (run >= a.kp) {               // nothing of w is selected
        atomicMin(&s_cut, w);
        break;
      }
      if (run + p > a.kp) {            // the first kp - run bits are
        s_cword = dense_tile::low_set_bits(x, a.kp - run);
        atomicMin(&s_cut, w + 1);
        break;
      }
      run += p;
    }
    __syncthreads();
    const int cut = s_cut;
    const unsigned cword = s_cword;
    if (cword && wid == 0) {           // recount the partial word
      const int64_t* q = a.qmat + (int64_t)b * a.qcols;
      int n = 0;
      for (unsigned x = cword; x; x &= x - 1) {
        const int64_t js = (int64_t)(cut - 1) * 32 + (__ffs(x) - 1);
        for (int p0 = 0; p0 < m_t * m; p0 += 32) {
          const int p = p0 + lane;
          n += __popc(__ballot_sync(
              0xffffffffu, p < m_t * m && dt::pair_hit(q, m, a.t.lo + js * m_t,
                                                      a.t.hi + js * m_t, p)));
        }
      }
      if (lane == 0) s_csum = n;
    }
    __syncthreads();
    const int full = cword ? cut - 1 : cut;
    int ts = 0;
    for (int w = w0; w < mini(w1, full); ++w) ts += tp[w];
    if (cword && cut - 1 >= w0 && cut - 1 < w1) ts += s_csum;
    int ttot;
    int off = block_exclusive_scan<NT, int>(ts, &ttot);
    for (int w = w0; w < mini(w1, cut); ++w) {
      const int v = w < full ? tp[w] : s_csum;
      tp[w] = off;
      off += v;
    }
    if (cword && cut - 1 >= w0 && cut - 1 < w1) mw[cut - 1] = cword;
    if (threadIdx.x == 0) {
      a.counts[b] = ttot;
      a.pairc[b] = ptot;
      a.nsel[b] = cut;
    }
    __syncthreads();   // s_cut, s_cword, s_csum are the next row's
  }
  grid.sync();

  // 3. one CTA: row_end = cumsum(counts), the header, the row starts
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) s_max = 0;
    long long run = 0;
    int mx = 0;
    for (int base = 0; base < a.B; base += NT) {
      const int b = base + threadIdx.x;
      const int v = b < a.B ? a.counts[b] : 0;
      if (b < a.B) mx = maxi(mx, maxi(v, a.pairc[b]));
      long long tot;
      const long long e = block_exclusive_scan<NT, long long>(v, &tot);
      if (b < a.B) {
        a.starts[b] = run + e;
        a.hdr[2 + b] = (int32_t)(run + e + v);
      }
      run += tot;
    }
    atomicMax(&s_max, mx);
    __syncthreads();
    if (threadIdx.x == 0) {
      a.hdr[0] = (int32_t)run;
      a.hdr[1] = s_max;
      a.starts[a.B] = run;
    }
  }
  grid.sync();

  // 4. the triples of the selected slots in (slot, col, q) order: a warp
  // takes 32 words of a row and walks their selected slots in order from
  // each word's offset; for one slot its lanes test 32 (col, q) pairs at
  // a time, and a ballot places the overlapping ones; then -1 after the
  // total and in a row's positions past kk
  T* ent = (T*)a.ent;
  const int ngw = (a.W + 31) / 32;
  const int mq = m_t * m;
  const int64_t nwarps = (int64_t)gridDim.x * (NT / 32);
  const unsigned below = (1u << lane) - 1u;
  for (int64_t it = (int64_t)blockIdx.x * (NT / 32) + wid;
       it < (int64_t)a.B * ngw; it += nwarps) {
    const int b = (int)(it / ngw);
    const int g = (int)(it - (int64_t)b * ngw);
    const int ns = a.nsel[b];
    if (g * 32 >= ns) continue;
    const int w = g * 32 + lane;
    const unsigned word = w < ns ? a.maskw[(int64_t)b * a.W + w] : 0u;
    const int tpw = word ? a.tpre[(int64_t)b * a.W + w] : 0;
    unsigned nz = __ballot_sync(0xffffffffu, word != 0);
    if (!nz) continue;
    const int64_t* q = a.qmat + (int64_t)b * a.qcols;
    const int64_t st = a.starts[b];
    while (nz) {
      const int l = __ffs(nz) - 1;
      nz &= nz - 1;
      unsigned x = __shfl_sync(0xffffffffu, word, l);
      int off = __shfl_sync(0xffffffffu, tpw, l);
      while (x && off < a.kk) {
        const int64_t js = (int64_t)(g * 32 + l) * 32 + (__ffs(x) - 1);
        x &= x - 1;
        const int64_t* lo = a.t.lo + js * m_t;
        const int64_t* hi = a.t.hi + js * m_t;
        for (int p0 = 0; p0 < mq && off < a.kk; p0 += 32) {
          const int p = p0 + lane;
          const bool hit = p < mq && dt::pair_hit(q, m, lo, hi, p);
          const unsigned bal = __ballot_sync(0xffffffffu, hit);
          const int o = off + __popc(bal & below);
          if (hit && o < a.kk && st + o < a.s)
            ent[st + o] = (T)((T)js * (T)mq + (T)p);
          off += __popc(bal);
        }
      }
    }
  }
  const int64_t total = a.starts[a.B];
  for (int64_t p = min64(total, a.s) + (int64_t)blockIdx.x * NT + threadIdx.x;
       p < a.s; p += (int64_t)gridDim.x * NT)
    ent[p] = (T)-1;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int c = a.counts[b];
    if (c <= a.kk) continue;
    const int64_t st = a.starts[b];
    const int64_t end = min64(st + c, a.s);
    for (int64_t p = st + a.kk + threadIdx.x; p < end; p += NT)
      ent[p] = (T)-1;
  }
}

// the workspace's int64 words for B rows over N slots (W = N / 32 words):
// starts (B + 1), mask words and triple prefixes (B x W each, 32 bits),
// counts, mask counts and selected words (B each, 32 bits)
int64_t dense_workspace_words(int64_t B, int64_t N) {
  const int64_t W = (N + 31) / 32;
  return (B + 1) + B * W + (3 * B + 1) / 2;
}

template <typename T>
int launch_dense(DenseParams& a, cudaStream_t st) {
  const int64_t ntiles = ((int64_t)a.t.N + NT - 1) / NT;
  const int64_t items = ntiles * ((a.B + a.rows - 1) / a.rows);
  const int64_t warps = (int64_t)a.B * ((a.W + 31) / 32) / (NT / 32);
  int64_t want = items > a.B ? items : a.B;
  if (warps > want) want = warps;
  return a.t.m_t <= dense_tile::MT_REG
             ? launch_cooperative(dense_csr<T, dense_tile::MT_REG>, NT, want,
                                  a, st)
             : launch_cooperative(dense_csr<T, 0>, NT, want, a, st);
}

}  // namespace

// The workspace a call of accord_deps_bucketed needs, in int64 words, for
// B rows of C candidates kept up to kk: the wrapper allocates it.
ACCORD_EXPORT int64_t accord_bucketed_workspace_words(int64_t B, int64_t C,
                                                      int64_t kk,
                                                      int64_t wide) {
  return bucketed_workspace_words(B, C, kk, wide != 0);
}

// ptrs: qmat, blo, bhi, bslot, bcol, bmsb, blsb, bnode, bkind, wlo, whi,
//       wslot, wcol, wmsb, wlsb, wnode, wkind, workspace int64[words]
//       (accord_bucketed_workspace_words), hdr int32[2+B], ent[s]
// vals: B, qcols, m, span, K, keff, W, pm, pl, pn, m_t, wide, s, k,
//       has_row_offset, row_offset, G (bucket rows of this slice),
//       workspace words
ACCORD_EXPORT int accord_deps_bucketed(void* const* p, const int64_t* v,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return v[11] ? launch_bucketed<int64_t>(p, v, st)
               : launch_bucketed<int32_t>(p, v, st);
}

// The workspace a call needs, in int64 words: the wrapper allocates it.
ACCORD_EXPORT int64_t accord_dense_workspace_words(int64_t B, int64_t N) {
  return dense_workspace_words(B, N);
}

// ptrs: qmat, msb, lsb, node, kind, status, lo, hi, workspace int64[words]
//       (accord_dense_workspace_words), hdr int32[2+B], ent[s]
// vals: B, qcols, m, N, m_t, pm, pl, pn, wide, s, k, workspace words
ACCORD_EXPORT int accord_deps_dense(void* const* p, const int64_t* v,
                                    void* stream) {
  DenseParams a;
  a.qmat = (const int64_t*)p[0];
  a.t.msb = (const int64_t*)p[1];
  a.t.lsb = (const int64_t*)p[2];
  a.t.node = (const int32_t*)p[3];
  a.t.kind = (const int32_t*)p[4];
  a.t.status = (const int32_t*)p[5];
  a.t.lo = (const int64_t*)p[6];
  a.t.hi = (const int64_t*)p[7];
  int64_t* ws = (int64_t*)p[8];
  a.hdr = (int32_t*)p[9];
  a.ent = p[10];
  const int64_t B = v[0], N = v[3], k = v[10];
  a.qcols = (int)v[1];
  a.m = (int)v[2];
  a.t.m_t = (int)v[4];
  a.t.pm = v[5];
  a.t.pl = v[6];
  a.t.pn = (int32_t)v[7];
  a.s = v[9];
  if (B < 1 || B > INT32_MAX || N < 0 || N > INT32_MAX || a.m < 0 ||
      a.m > DQ || a.t.m_t < 1 || a.qcols != 7 + 2 * a.m || a.s < 0 ||
      k < 0 || v[11] < dense_workspace_words(B, N))
    return (int)cudaErrorInvalidValue;
  a.B = (int)B;
  a.t.N = (int)N;
  a.W = (int)((N + 31) / 32);
  a.kp = (int)min64(k, N);
  a.kk = (int)min64(k, (int64_t)a.kp * a.t.m_t * a.m);
  a.rows = mini(DR, DQ / maxi(a.m, 1));
  a.starts = ws;
  a.maskw = (uint32_t*)(ws + B + 1);
  a.tpre = (int32_t*)(a.maskw + B * a.W);
  a.counts = a.tpre + B * a.W;
  a.pairc = a.counts + B;
  a.nsel = a.pairc + B;
  cudaStream_t st = (cudaStream_t)stream;
  return v[8] ? launch_dense<int64_t>(a, st) : launch_dense<int32_t>(a, st);
}
