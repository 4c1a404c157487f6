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
// codes that pass the predicate.  Design: one block per query row, which
// counts its valid candidates, gathers them into shared memory (global
// scratch when the row has more candidates than fit), sorts them with a
// bitonic network and keeps the first of each run into a row buffer; one
// block then scans the row counts into the header, and a last pass copies
// each row to its offset, truncated at s, exactly as the reference's
// _compact_rows does.
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
  int C, kk, Cp;
  // row-sharded slice: global bucket rows translate to [0, G) by - roff,
  // rows outside the slice read as no bucket (has_roff == 0: unsharded)
  int has_roff, roff, G;
};

// candidate c of row b: (valid, code).  Candidates [0, m*span*keff) are the
// touched bucket lines (probe p = c / keff probes query interval p / span);
// the rest cross the wide list with every query interval.
template <typename T>
__device__ __forceinline__ bool bucket_candidate(const BucketArgs& a,
                                                 const int64_t* row,
                                                 const Query& q, int c,
                                                 T* code) {
  const int nb = a.m * a.span * a.keff;
  const int64_t mq = (int64_t)a.m_t * a.m;
  if (c < nb) {
    const int p = c / a.keff;
    const int e = c - p * a.keff;
    const int qi = p / a.span;
    int32_t g = (int32_t)row[7 + 2 * a.m + p];
    if (a.has_roff) {
      const int32_t l = g - a.roff;
      g = (g >= 0 && l >= 0 && l < a.G) ? l : -1;
    }
    if (g < 0) return false;
    const int64_t idx = (int64_t)g * a.K + e;
    const int32_t slot = a.bslot[idx];
    if (slot < 0) return false;
    const int64_t qlo = row[7 + qi], qhi = row[7 + a.m + qi];
    if (!(a.blo[idx] <= qhi && qlo <= a.bhi[idx])) return false;
    if (!entry_pred(q, a.bmsb[idx], a.blsb[idx], a.bnode[idx], a.bkind[idx],
                    a.pm, a.pl, a.pn))
      return false;
    *code = (T)((T)slot * (T)mq + (T)a.bcol[idx] * (T)a.m + (T)qi);
    return true;
  }
  const int c2 = c - nb;
  const int qi = c2 / a.W;
  const int w = c2 - qi * a.W;
  const int32_t slot = a.wslot[w];
  if (slot < 0) return false;
  const int64_t qlo = row[7 + qi], qhi = row[7 + a.m + qi];
  if (!(a.wlo[w] <= qhi && qlo <= a.whi[w])) return false;
  if (!entry_pred(q, a.wmsb[w], a.wlsb[w], a.wnode[w], a.wkind[w], a.pm,
                  a.pl, a.pn))
    return false;
  *code = (T)((T)slot * (T)mq + (T)a.wcol[w] * (T)a.m + (T)qi);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(NT)
bucketed_rows(BucketArgs a, T* scratch, int32_t* counts, T* rowbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_valid, fill;
  const int b = blockIdx.x;
  const int64_t* row = a.qmat + (int64_t)b * a.qcols;
  const Query q = load_query(row);
  if (threadIdx.x == 0) {
    n_valid = 0;
    fill = 0;
  }
  __syncthreads();
  int mine = 0;
  T code;
  for (int c = threadIdx.x; c < a.C; c += NT)
    mine += bucket_candidate<T>(a, row, q, c, &code);
  if (mine) atomicAdd(&n_valid, mine);
  __syncthreads();
  const int nv = n_valid;
  const int np = next_pow2(nv > 0 ? nv : 1);
  T* buf = scratch ? scratch + (int64_t)b * a.Cp
                  : reinterpret_cast<T*>(smem_raw);
  for (int c = threadIdx.x; c < a.C; c += NT)
    if (bucket_candidate<T>(a, row, q, c, &code)) buf[atomicAdd(&fill, 1)] = code;
  for (int i = nv + threadIdx.x; i < np; i += NT) buf[i] = sentinel<T>();
  __syncthreads();
  block_bitonic_sort<NT>(buf, np);
  // keep the first code of each run (a triple reachable via several
  // buckets), in ascending order
  int run = 0;
  for (int base = 0; base < nv; base += NT) {
    const int i = base + threadIdx.x;
    const bool u = i < nv && (i == 0 || buf[i] != buf[i - 1]);
    int tot;
    const int r = block_exclusive_scan<NT, int>(u ? 1 : 0, &tot);
    if (u && run + r < a.kk) rowbuf[(int64_t)b * a.kk + run + r] = buf[i];
    run += tot;
  }
  if (threadIdx.x == 0) counts[b] = run;
}

// one block: row_end = cumsum(counts), header (total, maxc, row_end),
// starts for the write pass
__global__ void __launch_bounds__(1024)
rows_scan(const int32_t* counts, int B, int64_t* starts, int32_t* hdr) {
  __shared__ int maxc;
  if (threadIdx.x == 0) maxc = 0;
  __syncthreads();
  long long run = 0;
  int mx = 0;
  for (int base = 0; base < B; base += 1024) {
    const int b = base + threadIdx.x;
    const int v = b < B ? counts[b] : 0;
    if (b < B) mx = maxi(mx, v);
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(v, &tot);
    if (b < B) {
      starts[b] = run + e;
      hdr[2 + b] = (int32_t)(run + e + v);
    }
    run += tot;
  }
  atomicMax(&maxc, mx);
  __syncthreads();
  if (threadIdx.x == 0) {
    hdr[0] = (int32_t)run;
    hdr[1] = maxc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
rows_write(const int32_t* counts, const int64_t* starts, const T* rowbuf,
           int kk, int64_t s, T* ent) {
  const int b = blockIdx.x;
  const int n = mini(counts[b], kk);
  const int64_t st = starts[b];
  for (int r = threadIdx.x; r < n; r += NT) {
    const int64_t pos = st + r;
    if (pos < s) ent[pos] = rowbuf[(int64_t)b * kk + r];
  }
}

template <typename T>
int launch_bucketed(void* const* p, const int64_t* v, cudaStream_t st) {
  BucketArgs a;
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
  int32_t* counts = (int32_t*)p[17];
  int64_t* starts = (int64_t*)p[18];
  T* rowbuf = (T*)p[19];
  T* scratch = (T*)p[20];
  int32_t* hdr = (int32_t*)p[21];
  T* ent = (T*)p[22];
  const int B = (int)v[0];
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
  const int64_t s = v[12];
  const int k = (int)v[13];
  a.has_roff = (int)v[14];
  a.roff = (int)v[15];
  a.G = (int)v[16];
  a.C = a.m * a.span * a.keff + a.m * a.W;
  a.kk = mini(k, a.C);
  a.Cp = next_pow2(a.C);
  cudaMemsetAsync(ent, 0xff, (size_t)s * sizeof(T), st);
  // the wrapper passes scratch when a row's codes outgrow shared memory
  const size_t smem = scratch ? 0 : (size_t)a.Cp * sizeof(T);
  bucketed_rows<T><<<B, NT, smem, st>>>(a, scratch, counts, rowbuf);
  rows_scan<<<1, 1024, 0, st>>>(counts, B, starts, hdr);
  rows_write<T><<<B, NT, 0, st>>>(counts, starts, rowbuf, a.kk, s, ent);
  return (int)cudaGetLastError();
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

// the n lowest set bits of x
__device__ __forceinline__ unsigned low_set_bits(unsigned x, int n) {
  unsigned r = 0;
  for (; n > 0 && x; --n) {
    const unsigned b = x & (0u - x);
    r |= b;
    x ^= b;
  }
  return r;
}

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
        s_cword = low_set_bits(x, a.kp - run);
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

// ptrs: qmat, blo, bhi, bslot, bcol, bmsb, blsb, bnode, bkind, wlo, whi,
//       wslot, wcol, wmsb, wlsb, wnode, wkind, counts[B], starts[B],
//       rowbuf[B*kk], scratch[B*Cp] (null: sort in shared memory),
//       hdr[2+B], ent[s]
// vals: B, qcols, m, span, K, keff, W, pm, pl, pn, m_t, wide, s, k,
//       has_row_offset, row_offset, G (bucket rows of this slice)
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
