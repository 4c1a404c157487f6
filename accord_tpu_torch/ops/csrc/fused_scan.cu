// K5: the dense deps scan and its attribution for S stores, each stage one
// cooperative launch.
//
// Replaces (JAX reference, accord_tpu/ops/deps_kernel.py):
//   fused_deps_dense <- fused_flat_csr (:605): flat_csr_local (:351)
//                       vmapped over the stores' tables, padded to the
//                       group by _pad_table_cols (:590)
//   fused_attr_post  <- the attribution stage of fused_flat_attr (:1081):
//                       _attr_post (:921) vmapped over the stores, with
//                       _pad_attr_cols (:1040) and _pad_attr_index (:1052)
// Output, byte-equal to the reference: header int32[S, 2+B] and entries
// [S, s] (raw), then header int32[S, 5+B] and entries [S, s]
// (attributed); block i is store i's solo answer over its table padded to
// the group's (n_max, m_max), codes on m_max, with the group's kp =
// min(k, n_max) and kk = min(k, kp * m_max * m).
//
// The reference pads and stacks the tables inside its jitted program.
// Here each member is read where it lies, and the padding is applied by
// rule: slots at or past n_i are FREE (never in the mask), interval
// columns at or past m_t_i are PAD (lo = INT64_MAX, hi = INT64_MIN, so a
// pair with one overlaps only a query interval over the whole line),
// attribution rows past n_i read as (Range, FREE, 0...), index tails as
// +INF / 0 / the live eptr length.  Every member's pointers and sizes
// travel by value, in a __grid_constant__ kernel parameter (at most
// MAX_STORES of them, ops/_build.py LIMITS; the wrapper splits a larger
// group into launches): no table is uploaded and no memset made.
//
// fused_deps_dense.  Bound on this card: operations, sum_i B x n_i (row,
// slot) tests of up to m x m_t_i interval pairs.  The fused flushes are
// small (16 stores x 2,048 slots x 4 rows in bench config 5, a few
// stores of tens of slots in the burn), so a call is its fixed part: the
// first port's memset and three launches of B x S CTAs, each walking its
// member's whole table in block scans, took 400x the bound.  Now it is
// K1b's design (deps_scan.cu dense_csr) over the members: one cooperative
// launch, four phases between grid barriers, every scratch buffer carved
// from one workspace (accord_fused_scan_workspace_words):
//   1. items of (member, 256-slot tile of that member, up to 32 staged
//      query rows), sum_i ceil(n_i / 256) x ceil(B / 32) of them: a thread
//      holds its slot in registers, the predicate and its exact span
//      filters are dense_tile.cuh's over the member's own m_t_i, and the
//      PAD columns' pairs are counted by rule (m_max - m_t_i of them for
//      each query interval over the whole line); for each row a warp
//      ballots its 32 mask bits into one word and sums its triples: the
//      member's mask words and word sums [B, ceil(n_i / 32)];
//   2. a CTA a (member, row): the popcount prefix finds the word where the
//      mask rank crosses kp, which keeps only its first bits (one warp
//      recounts its triples); the selected triples, the mask count and
//      each selected word's triple offset;
//   3. a CTA a member scans its rows' counts into its header and starts;
//   4. a warp a selected word of a (member, row), a lane a slot: each
//      lane counts its slot's triples over the group's m_max x m pairs, a
//      warp scan places them after the word's offset and each lane writes
//      its own, up to kk a row; then -1 after each member's total and in a
//      row's positions past kk.
//
// fused_attr_post.  Bound on this card: bytes, each live entry read once
// and written at most once, with a few gathers and short searches an
// entry.  K2's design (attr_post.cu) over the members: one cooperative
// launch of 1,024-thread CTAs, one workspace
// (accord_fused_attr_workspace_words), no memset, three phases:
//   1. chunks of CW 32-entry words (ops/_build.py GEOMETRY
//      ACCORD_FUSED_CHUNK_WORDS), a member's ceil(s / 32 / CW) of them:
//      a warp a word, a lane an entry (its row by a search of the
//      member's row_end staged in shared memory, the previous entry's key
//      from the lane before), one ballot word of keep flags; the chunk's
//      kept entries and elision tallies.  Words past the member's live
//      entries are neither read nor written;
//   2. a CTA a member scans its chunks' sums into their offsets and sums
//      its tallies into its header;
//   3. each chunk places its kept entries at its offset, writes -1 in its
//      positions at or past the member's kept total, and the new row ends
//      off the kept prefix, row_end[b] - (X(b) - kept(X(b))) with X(b) =
//      min(row_end[b], total, s), as attr_post.cu derives them: no per-row
//      drop counts.
#include <cooperative_groups.h>

#include "common.cuh"
#include "dense_tile.cuh"

namespace cg = cooperative_groups;
namespace dt = dense_tile;

namespace {

// threads a scan CTA (ops/_build.py GEOMETRY, as K1b)
constexpr int NT = ACCORD_DEPS_THREADS;
// members a launch takes by value (ops/_build.py LIMITS)
constexpr int MAX_STORES = ACCORD_FUSED_MAX_STORES;
// query rows a phase-1 item stages, and the query intervals they may hold
constexpr int DR = 32;
constexpr int DQ = 1024;
constexpr int64_t PAD_LO = 0x7fffffffffffffffLL;
constexpr int64_t PAD_HI = (int64_t)0x8000000000000000ULL;
constexpr int64_t I64_INF = 0x7fffffffffffffffLL;

// one member of the raw stage: its table (n_i slots, m_t_i columns, its
// prune floor) and where its tiles and mask words start
struct ScanStore {
  dense_tile::Table t;
  int64_t word0;     // mask words of the members before it, x B
  int32_t tile0;     // 256-slot tiles of the members before it
  int32_t pad_;
};

struct ScanParams {
  ScanStore st[MAX_STORES];
  const int64_t* qmats;   // [S, B, qcols]
  int64_t* starts;        // [S, B + 1] row starts, then the total
  uint32_t* maskw;        // member i's [B, W_i] words at st[i].word0
  int32_t* tpre;          // their triple sums, then offsets (same layout)
  int32_t* counts;        // [S, B] selected triples
  int32_t* pairc;         // [S, B] mask bits
  int32_t* nsel;          // [S, B] leading words that hold the selection
  int32_t* hdr;           // [S, 2 + B]
  void* ent;              // [S, s]
  int64_t s;
  int S, B, qcols, m, M, kp, kk, rows, tiles, wg;
};
static_assert(sizeof(ScanParams) <= 32764, "kernel parameter space");

// the member that holds global tile t: the last whose first tile is <= t
// (a member without slots has no tile and is skipped)
__device__ __forceinline__ int member_of_tile(const ScanParams& a, int t) {
  int lo = 0, hi = a.S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.st[mid].tile0 <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// query intervals of qmat row q over the whole line: each overlaps every
// PAD column the group adds to a narrower member
__device__ __forceinline__ int full_span(const int64_t* q, int m) {
  int n = 0;
  for (int i = 0; i < m; ++i)
    n += q[7 + i] == INT64_MIN && q[7 + m + i] == INT64_MAX;
  return n;
}

// does pair p = c * m + qi of the group's m_max x m overlap: a column
// past the member's m_t is PAD
__device__ __forceinline__ bool pair_hit_padded(const int64_t* q, int m,
                                                const int64_t* lo,
                                                const int64_t* hi, int m_t,
                                                int p) {
  const int c = p / m, qi = p - c * m;
  const int64_t l = c < m_t ? lo[c] : PAD_LO;
  const int64_t h = c < m_t ? hi[c] : PAD_HI;
  return q[7 + qi] <= h && l <= q[7 + m + qi];
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT)
fused_csr(const __grid_constant__ ScanParams a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ dt::Row srow[DR];
  __shared__ int s_pad[DR];     // the PAD pairs a slot of the item adds
  __shared__ int64_t sq[2 * DQ];
  __shared__ int s_cut, s_csum;
  __shared__ unsigned s_cword;
  __shared__ int s_max;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int m = a.m, M = a.M;

  // 1. mask words and their triple sums: one item is NT slots of one
  // member (one a thread, in registers) against a group of its rows
  const int64_t ngroups = (a.B + a.rows - 1) / a.rows;
  for (int64_t item = blockIdx.x; item < (int64_t)a.tiles * ngroups;
       item += gridDim.x) {
    const int tile = (int)(item % a.tiles);
    const int b0 = (int)(item / a.tiles) * a.rows;
    const int i = member_of_tile(a, tile);
    const ScanStore& st = a.st[i];
    const int nr = mini(a.rows, a.B - b0);
    const int64_t* qb = a.qmats + ((int64_t)i * a.B + b0) * a.qcols;
    __syncthreads();   // the previous item's rows are read
    for (int r = threadIdx.x; r < nr; r += NT) {
      srow[r] = dt::load_row(qb + (int64_t)r * a.qcols, m);
      s_pad[r] = (M - st.t.m_t) * full_span(qb + (int64_t)r * a.qcols, m);
    }
    for (int x = threadIdx.x; x < nr * m; x += NT) {
      const int r = x / m, qi = x - r * m;
      const int64_t* q = qb + (int64_t)r * a.qcols;
      sq[x] = q[7 + qi];
      sq[DQ + x] = q[7 + m + qi];
    }
    __syncthreads();
    const int64_t j = (int64_t)(tile - st.tile0) * NT + threadIdx.x;
    const dt::Slot<MT> slot = dt::load_slot<MT>(st.t, j);
    const int W = (st.t.N + 31) >> 5;
    const int w = (int)(j >> 5);
    for (int r = 0; r < nr; ++r) {
      int n = 0;
      if (dt::row_admits(srow[r], slot))
        n = dt::pair_count(srow[r], slot, sq + r * m, sq + DQ + r * m, m,
                           st.t.m_t) + s_pad[r];
      const unsigned word = __ballot_sync(0xffffffffu, n > 0);
      const int sum = __reduce_add_sync(0xffffffffu, n);
      if (lane == 0 && w < W) {
        const int64_t o = st.word0 + (int64_t)(b0 + r) * W + w;
        a.maskw[o] = word;
        a.tpre[o] = sum;
      }
    }
  }
  grid.sync();

  // 2. per (member, row): the mask count, the word where the rank crosses
  // kp (only its first bits stay), the selected triples and each selected
  // word's triple offset in the row
  for (int64_t rb = blockIdx.x; rb < (int64_t)a.S * a.B; rb += gridDim.x) {
    const int i = (int)(rb / a.B);
    const int b = (int)(rb - (int64_t)i * a.B);
    const ScanStore& st = a.st[i];
    const int W = (st.t.N + 31) >> 5;
    uint32_t* mw = a.maskw + st.word0 + (int64_t)b * W;
    int32_t* tp = a.tpre + st.word0 + (int64_t)b * W;
    const int per = (W + NT - 1) / NT;
    const int w0 = mini(threadIdx.x * per, W), w1 = mini(w0 + per, W);
    int pc = 0;
    for (int w = w0; w < w1; ++w) pc += __popc(mw[w]);
    if (threadIdx.x == 0) {
      s_cut = W;
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
        s_cword = dt::low_set_bits(x, a.kp - run);
        atomicMin(&s_cut, w + 1);
        break;
      }
      run += p;
    }
    __syncthreads();
    const int cut = s_cut;
    const unsigned cword = s_cword;
    if (cword && wid == 0) {           // recount the partial word
      const int64_t* q = a.qmats + rb * a.qcols;
      const int m_t = st.t.m_t;
      const int lim = (full_span(q, m) ? M : m_t) * m;
      int n = 0;
      for (unsigned x = cword; x; x &= x - 1) {
        const int64_t js = (int64_t)(cut - 1) * 32 + (__ffs(x) - 1);
        for (int p0 = 0; p0 < lim; p0 += 32) {
          const int p = p0 + lane;
          n += __popc(__ballot_sync(
              0xffffffffu,
              p < lim && pair_hit_padded(q, m, st.t.lo + js * m_t,
                                         st.t.hi + js * m_t, m_t, p)));
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
      a.counts[rb] = ttot;
      a.pairc[rb] = ptot;
      a.nsel[rb] = cut;
    }
    __syncthreads();   // s_cut, s_cword, s_csum are the next row's
  }
  grid.sync();

  // 3. a CTA a member: row_end = cumsum(counts), the header, the starts
  for (int i = blockIdx.x; i < a.S; i += gridDim.x) {
    const int32_t* counts = a.counts + (int64_t)i * a.B;
    const int32_t* pairc = a.pairc + (int64_t)i * a.B;
    int64_t* starts = a.starts + (int64_t)i * (a.B + 1);
    int32_t* hdr = a.hdr + (int64_t)i * (2 + a.B);
    if (threadIdx.x == 0) s_max = 0;
    long long run = 0;
    int mx = 0;
    for (int base = 0; base < a.B; base += NT) {
      const int b = base + threadIdx.x;
      const int v = b < a.B ? counts[b] : 0;
      if (b < a.B) mx = maxi(mx, maxi(v, pairc[b]));
      long long tot;
      const long long e = block_exclusive_scan<NT, long long>(v, &tot);
      if (b < a.B) {
        starts[b] = run + e;
        hdr[2 + b] = (int32_t)(run + e + v);
      }
      run += tot;
    }
    atomicMax(&s_max, mx);
    __syncthreads();
    if (threadIdx.x == 0) {
      hdr[0] = (int32_t)run;
      hdr[1] = s_max;
      starts[a.B] = run;
    }
    __syncthreads();   // s_max is the next member's
  }
  grid.sync();

  // 4. the triples of the selected slots in (slot, col, q) order, codes on
  // the group's m_max: a warp a selected word of a (member, row), a lane a
  // slot of it.  Each lane counts its slot's triples (the loads of the
  // word's slots in flight together: a warp walking one slot after another
  // paid a round trip to L2 a slot, most of a call with a few stores of
  // many selected slots, as the burn's), a warp scan places them after
  // the word's offset, and each lane writes its own, up to kk a row; then
  // -1 after each member's total and in a row's positions past kk
  T* ent = (T*)a.ent;
  const int64_t mq = (int64_t)M * m;
  const int64_t nwarps = (int64_t)gridDim.x * (NT / 32);
  for (int64_t it = (int64_t)blockIdx.x * (NT / 32) + wid;
       it < (int64_t)a.S * a.B * a.wg; it += nwarps) {
    const int64_t rb = it / a.wg;
    const int w = (int)(it - rb * a.wg);
    if (w >= a.nsel[rb]) continue;
    const int i = (int)(rb / a.B);
    const int b = (int)(rb - (int64_t)i * a.B);
    const ScanStore& st = a.st[i];
    const int64_t wo = st.word0 + (int64_t)b * ((st.t.N + 31) >> 5) + w;
    const unsigned word = a.maskw[wo];
    if (!word) continue;
    const int off_w = a.tpre[wo];
    if (off_w >= a.kk) continue;
    const int64_t* q = a.qmats + rb * a.qcols;
    const int m_t = st.t.m_t;
    const int cols = full_span(q, m) ? M : m_t;
    const bool mine = (word >> lane) & 1;
    const int64_t js = (int64_t)w * 32 + lane;
    const int64_t* lo = st.t.lo + js * m_t;
    const int64_t* hi = st.t.hi + js * m_t;
    int t = 0;
    if (mine)
      for (int c = 0; c < cols; ++c) {
        const int64_t l = c < m_t ? lo[c] : PAD_LO;
        const int64_t h = c < m_t ? hi[c] : PAD_HI;
        for (int qi = 0; qi < m; ++qi)
          t += q[7 + qi] <= h && l <= q[7 + m + qi];
      }
    int x = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    int off = off_w + x - t;
    if (!mine || off >= a.kk) continue;
    const int64_t sb = a.starts[(int64_t)i * (a.B + 1) + b];
    T* out = ent + (int64_t)i * a.s;
    for (int c = 0; c < cols && off < a.kk; ++c) {
      const int64_t l = c < m_t ? lo[c] : PAD_LO;
      const int64_t h = c < m_t ? hi[c] : PAD_HI;
      for (int qi = 0; qi < m && off < a.kk; ++qi)
        if (q[7 + qi] <= h && l <= q[7 + m + qi]) {
          if (sb + off < a.s)
            out[sb + off] = (T)((T)js * (T)mq + (T)(c * m + qi));
          ++off;
        }
    }
  }
  for (int64_t x = (int64_t)blockIdx.x * NT + threadIdx.x;
       x < (int64_t)a.S * a.s; x += (int64_t)gridDim.x * NT) {
    const int64_t i = x / a.s;
    if (x - i * a.s >= a.starts[i * (a.B + 1) + a.B]) ent[x] = (T)-1;
  }
  for (int64_t rb = blockIdx.x; rb < (int64_t)a.S * a.B; rb += gridDim.x) {
    const int c = a.counts[rb];
    if (c <= a.kk) continue;
    const int64_t i = rb / a.B;
    const int64_t sb = a.starts[i * (a.B + 1) + (rb - i * a.B)];
    const int64_t end = min64(sb + c, a.s);
    for (int64_t p = sb + a.kk + threadIdx.x; p < end; p += NT)
      ent[i * a.s + p] = (T)-1;
  }
}

// the workspace's int64 words for S members of B rows and W mask words a
// row in all: starts (S (B + 1)), mask words and triple prefixes (B x W
// each, 32 bits), counts, mask counts and selected words (S B each, 32
// bits)
int64_t scan_workspace_words(int64_t S, int64_t B, int64_t W) {
  return S * (B + 1) + B * W + (3 * S * B + 1) / 2;
}

template <typename T>
int launch_scan(ScanParams& a, cudaStream_t st) {
  const int64_t items = (int64_t)a.tiles * ((a.B + a.rows - 1) / a.rows);
  const int64_t rows = (int64_t)a.S * a.B;
  const int64_t warps = rows * ((a.wg + 31) / 32) / (NT / 32);
  int64_t want = items > rows ? items : rows;
  if (warps > want) want = warps;
  return a.M <= dense_tile::MT_REG
             ? launch_cooperative(fused_csr<T, dense_tile::MT_REG>, NT, want,
                                  a, st)
             : launch_cooperative(fused_csr<T, 0>, NT, want, a, st);
}

// -- attribution --------------------------------------------------------------

// attribution CTA: 1,024 threads, two an SM, as K2
constexpr int ANT = 1024;
// row_end entries staged in shared memory (a larger batch searches global)
constexpr int SROWS = 2048;
// 32-entry words a chunk (ops/_build.py GEOMETRY): a word a warp
constexpr int CW = ACCORD_FUSED_CHUNK_WORDS;
static_assert(CW >= 1 && CW <= ANT, "a chunk's words, one a phase-3 thread");

// one member of the attribution: its table's lo, its attribution columns
// and index, and their lengths
struct AttrStore {
  const int64_t* lo;
  const int32_t *dom, *status;
  const int64_t *dmsb, *dlsb;
  const int32_t* dnode;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* eknown;
  const int64_t *fbnd, *fmsb, *flsb;
  const int32_t* fnode;
  const int64_t* etok;
  const int32_t* eptr;
  const int64_t *erank, *exm, *exl;
  const int32_t* exn;
  const int64_t* estride;
  int32_t n, m_t, F, T, L, pad_;
};

struct AttrParams {
  AttrStore st[MAX_STORES];
  const int64_t* rankb;     // [S, B]
  const int32_t* hdr_raw;   // [S, 2 + B]
  const void* ent;          // [S, s]
  int32_t* hdr;             // [S, 5 + B]
  void* out;                // [S, s]
  uint32_t* keepw;          // [S, nw] keep flags, a word a 32 entries
  long long* csum;          // [S, cpm + 1] kept entries of each chunk,
                            // then their member-local prefix and total
  long long* tally;         // [S cpm, 2] n_trans, n_dec of each chunk
  int64_t s, nw, F, T, L;   // s, its words, the group's index lengths
  int S, B, M, m, floors, elide, cpm;
};
static_assert(sizeof(AttrParams) <= 32764, "kernel parameter space");

// the member's attribution columns and index padded to the group, by rule
// (_pad_attr_cols, _pad_attr_index; the table's lo by _pad_table_cols)
struct PadAttr {
  const AttrStore& r;
  __device__ int32_t dom(int64_t j) const { return j < r.n ? r.dom[j] : 1; }
  __device__ int32_t status(int64_t j) const {
    return j < r.n ? r.status[j] : SLOT_FREE;
  }
  __device__ int64_t dmsb(int64_t j) const { return j < r.n ? r.dmsb[j] : 0; }
  __device__ int64_t dlsb(int64_t j) const { return j < r.n ? r.dlsb[j] : 0; }
  __device__ int32_t dnode(int64_t j) const {
    return j < r.n ? r.dnode[j] : 0;
  }
  __device__ int64_t emsb(int64_t j) const { return j < r.n ? r.emsb[j] : 0; }
  __device__ int64_t elsb(int64_t j) const { return j < r.n ? r.elsb[j] : 0; }
  __device__ int32_t enode(int64_t j) const {
    return j < r.n ? r.enode[j] : 0;
  }
  __device__ bool eknown(int64_t j) const { return j < r.n && r.eknown[j]; }
  __device__ int64_t tlo(int64_t j, int64_t c) const {
    return (j < r.n && c < r.m_t) ? r.lo[j * r.m_t + c] : PAD_LO;
  }
  __device__ int64_t fbnd(int64_t f) const {
    return f < r.F ? r.fbnd[f] : I64_INF;
  }
  __device__ int64_t fmsb(int64_t f) const { return f <= r.F ? r.fmsb[f] : 0; }
  __device__ int64_t flsb(int64_t f) const { return f <= r.F ? r.flsb[f] : 0; }
  __device__ int32_t fnode(int64_t f) const {
    return f <= r.F ? r.fnode[f] : 0;
  }
  __device__ int64_t etok(int64_t t) const {
    return t < r.T ? r.etok[t] : I64_INF;
  }
  __device__ int64_t eptr(int64_t t) const {
    return r.eptr[t <= r.T ? t : r.T];
  }
  __device__ int64_t erank(int64_t l) const {
    return l < r.L ? r.erank[l] : I64_INF;
  }
  __device__ int64_t exm(int64_t l) const { return l < r.L ? r.exm[l] : 0; }
  __device__ int64_t exl(int64_t l) const { return l < r.L ? r.exl[l] : 0; }
  __device__ int32_t exn(int64_t l) const { return l < r.L ? r.exn[l] : 0; }
};

// searchsorted over an accessor of the group's length: left (first x >=
// v) or right (first x > v)
template <bool RIGHT, typename At>
__device__ __forceinline__ int64_t search(int64_t n, int64_t v, At at) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t x = at(mid);
    if (RIGHT ? x <= v : x < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the keep flag of live entry ``code`` of a member, in attr_post.cu's
// order of legs (a repeat of its key is dropped and counted nowhere, a
// TRANSITIVE entry needs only the floor, and only a decided entry above
// the floor searches for its pivot); its tallies are the reference's
template <typename T>
__device__ __forceinline__ bool entry_keep(const AttrParams& a,
                                           const PadAttr& x, T code,
                                           int64_t rankb, bool firstp,
                                           int& n_tr, int& n_dc) {
  const T mq = (T)a.M * (T)a.m;
  const T q = dt::fdiv<T>(code, mq);
  const int64_t slot = max64((int64_t)q, 0);
  if (x.dom(slot) != 0) return true;       // not a key dep: kept
  if (!firstp) return false;
  const int32_t st = x.status(slot);
  const int64_t col = min64(
      max64((int64_t)dt::fdiv<T>((T)(code - q * mq), (T)a.m), 0), a.M - 1);
  const int64_t tok = x.tlo(slot, col);
  if (a.floors) {
    const int64_t fi =
        search<true>(a.F, tok, [&](int64_t f) { return x.fbnd(f); });
    if (ts_lt(x.dmsb(slot), x.dlsb(slot), x.dnode(slot), x.fmsb(fi),
              x.flsb(fi), x.fnode(fi)))
      return false;                        // below the floor
  }
  if (st == SLOT_TRANSITIVE) {
    ++n_tr;
    return false;
  }
  if (!a.elide || !(st >= SLOT_COMMITTED && st <= SLOT_APPLIED &&
                    x.eknown(slot)))
    return true;                           // not decided: no pivot
  const int64_t seg =
      search<false>(a.T, tok, [&](int64_t t) { return x.etok(t); });
  const int64_t seg_c = min64(seg, max64(a.T - 1, 0));
  if (x.etok(seg_c) != tok) return true;
  const int64_t base = x.eptr(seg_c);
  const int64_t key = seg_c * x.r.estride[0] + rankb;
  const int64_t cnt =
      search<false>(a.L, key, [&](int64_t l) { return x.erank(l); }) - base;
  if (cnt <= 0) return true;
  const int64_t pidx = max64(base + cnt - 1, 0);
  if (ts_lt(x.emsb(slot), x.elsb(slot), x.enode(slot), x.exm(pidx),
            x.exl(pidx), x.exn(pidx))) {
    ++n_dc;                                // decided below the pivot
    return false;
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(ANT, 2)
fused_attr(const __grid_constant__ AttrParams a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t s_rows[SROWS];
  __shared__ unsigned long long s_sum[3];
  __shared__ unsigned s_word[ANT];
  __shared__ int s_off[ANT];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t nchunks = (int64_t)a.S * a.cpm;
  int staged = -1;   // the member whose row_end s_rows holds

  // 1. keep flags, a ballot word a warp, a chunk at a time
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int i = (int)(c / a.cpm);
    const int64_t lc = c - (int64_t)i * a.cpm;
    const int32_t* hraw = a.hdr_raw + (int64_t)i * (2 + a.B);
    __syncthreads();   // the previous chunk's rows and sums are read
    if (a.B <= SROWS && staged != i)
      for (int b = threadIdx.x; b < a.B; b += ANT) s_rows[b] = hraw[2 + b];
    staged = i;
    if (threadIdx.x < 3) s_sum[threadIdx.x] = 0;
    __syncthreads();
    const int32_t* re = a.B <= SROWS ? s_rows : hraw + 2;
    const PadAttr x{a.st[i]};
    const T* ent = (const T*)a.ent + (int64_t)i * a.s;
    const int64_t* rankb = a.rankb + (int64_t)i * a.B;
    const int64_t live_end = min64(max64((int64_t)hraw[0], 0), a.s);
    const int64_t w1 = min64((lc + 1) * CW, a.nw);
    int n_tr = 0, n_dc = 0;
    for (int64_t w = lc * CW + wid; w < w1 && w * 32 < live_end;
         w += ANT / 32) {
      const int64_t pos = w * 32 + lane;
      const bool live = pos < live_end;
      const T code = live ? ent[pos] : (T)0;
      const int64_t row = live ? dt::row_of(re, a.B, pos) : 0;
      const int64_t key = row * (int64_t(1) << 40) +
                          (int64_t)dt::fdiv<T>(code, (T)a.m);
      int64_t pkey = __shfl_up_sync(0xffffffffu, key, 1);
      if (lane == 0 && live && pos > 0) {
        const int64_t prow = dt::row_of(re, a.B, pos - 1);
        pkey = prow * (int64_t(1) << 40) +
               (int64_t)dt::fdiv<T>(ent[pos - 1], (T)a.m);
      }
      const bool k = live && entry_keep<T>(a, x, code, rankb[row],
                                           pos == 0 || key != pkey, n_tr,
                                           n_dc);
      const unsigned word = __ballot_sync(0xffffffffu, k);
      if (lane == 0) {
        a.keepw[(int64_t)i * a.nw + w] = word;
        atomicAdd(&s_sum[0], (unsigned long long)__popc(word));
      }
    }
    if (n_tr) atomicAdd(&s_sum[1], (unsigned long long)n_tr);
    if (n_dc) atomicAdd(&s_sum[2], (unsigned long long)n_dc);
    __syncthreads();
    if (threadIdx.x == 0) {
      a.csum[(int64_t)i * (a.cpm + 1) + lc] = (long long)s_sum[0];
      a.tally[2 * c] = (long long)s_sum[1];
      a.tally[2 * c + 1] = (long long)s_sum[2];
    }
  }
  grid.sync();

  // 2. a CTA a member: its chunks' kept entries scanned in place (their
  // offsets, then the member's total at csum[cpm]) and its tallies summed
  // into its header
  for (int i = blockIdx.x; i < a.S; i += gridDim.x) {
    long long* cs = a.csum + (int64_t)i * (a.cpm + 1);
    const long long* ty = a.tally + 2 * (int64_t)i * a.cpm;
    __syncthreads();   // the previous member's tallies are read
    if (threadIdx.x == 0) s_sum[1] = s_sum[2] = 0;   // ordered by the scan
    long long run = 0, tr = 0, dc = 0;
    for (int base = 0; base < a.cpm; base += ANT) {
      const int c = base + threadIdx.x;
      const long long v = c < a.cpm ? cs[c] : 0;
      if (c < a.cpm) {
        tr += ty[2 * c];
        dc += ty[2 * c + 1];
      }
      long long tot;
      const long long e = block_exclusive_scan<ANT, long long>(v, &tot);
      if (c < a.cpm) cs[c] = run + e;
      run += tot;
    }
    if (tr) atomicAdd(&s_sum[1], (unsigned long long)tr);
    if (dc) atomicAdd(&s_sum[2], (unsigned long long)dc);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int32_t* hraw = a.hdr_raw + (int64_t)i * (2 + a.B);
      int32_t* hdr = a.hdr + (int64_t)i * (5 + a.B);
      cs[a.cpm] = run;
      hdr[1] = hraw[0];
      hdr[2] = hraw[1];
      hdr[3] = (int32_t)s_sum[1];
      hdr[4] = (int32_t)s_sum[2];
    }
  }
  grid.sync();

  // 3. each chunk's kept entries at its offset, -1 in its positions at or
  // past the member's kept total, and the new row ends
  staged = -1;
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int i = (int)(c / a.cpm);
    const int64_t lc = c - (int64_t)i * a.cpm;
    const int32_t* hraw = a.hdr_raw + (int64_t)i * (2 + a.B);
    __syncthreads();   // the previous chunk's words and rows are read
    if (a.B <= SROWS && staged != i)
      for (int b = threadIdx.x; b < a.B; b += ANT) s_rows[b] = hraw[2 + b];
    staged = i;
    __syncthreads();
    const int32_t* re = a.B <= SROWS ? s_rows : hraw + 2;
    const long long* cs = a.csum + (int64_t)i * (a.cpm + 1);
    const long long base = cs[lc];
    const long long kept_all = cs[a.cpm];
    const int64_t live_end = min64(max64((int64_t)hraw[0], 0), a.s);
    const T* ent = (const T*)a.ent + (int64_t)i * a.s;
    T* out = (T*)a.out + (int64_t)i * a.s;
    int32_t* hdr = a.hdr + (int64_t)i * (5 + a.B);
    const int64_t w0 = lc * CW, w1 = min64(w0 + CW, a.nw);
    const int64_t w = w0 + threadIdx.x;
    const unsigned word = w < w1 && w * 32 < live_end
                              ? a.keepw[(int64_t)i * a.nw + w] : 0u;
    int ctot;
    const int off = block_exclusive_scan<ANT, int>(__popc(word), &ctot);
    s_word[threadIdx.x] = word;
    s_off[threadIdx.x] = off;
    if (w < w1)
      dt::row_ends_in(hdr, a.B, re, w * 32, min64(w * 32 + 32, a.s),
                      live_end, base + off, word);
    __syncthreads();
    for (int t = wid; w0 + t < w1; t += ANT / 32) {
      const unsigned x = s_word[t];
      if ((x >> lane) & 1)
        out[base + s_off[t] + __popc(x & ((1u << lane) - 1u))] =
            ent[(w0 + t) * 32 + lane];
    }
    for (int64_t p = max64(w0 * 32, kept_all) + threadIdx.x;
         p < min64(w1 * 32, a.s); p += ANT)
      out[p] = (T)-1;
    if (lc == 0 && live_end == a.s) {
      // the rows whose X(b) is s itself: every kept entry lies below
      const int64_t last = a.B - 1;
      for (int64_t b = dt::first_at_least(re, last, a.s) + threadIdx.x;
           b <= last; b += ANT) {
        const int32_t ne =
            (int32_t)((long long)re[b] - ((long long)a.s - kept_all));
        hdr[5 + b] = ne;
        if (b == last) hdr[0] = ne;
      }
    }
  }
}

// chunks a member's s entries take
int64_t attr_chunks(int64_t s) {
  const int64_t c = ((s + 31) / 32 + CW - 1) / CW;
  return c > 1 ? c : 1;
}

// the workspace's int64 words for S members of s entries: per chunk its
// kept entries (then a member's total) and two tallies, and the keep words
// (S x s / 32, 32 bits)
int64_t attr_workspace_words(int64_t S, int64_t s) {
  const int64_t cpm = attr_chunks(s);
  return S * (cpm + 1) + 2 * S * cpm + (S * ((s + 31) / 32) + 1) / 2;
}

template <typename T>
int launch_attr(AttrParams& a, cudaStream_t st) {
  return launch_cooperative(fused_attr<T>, ANT, (int64_t)a.S * a.cpm, a, st);
}

}  // namespace

// The workspaces a call needs, in int64 words: the wrapper allocates them.
ACCORD_EXPORT int64_t accord_fused_scan_workspace_words(int64_t S, int64_t B,
                                                        int64_t W) {
  return scan_workspace_words(S, B, W);
}

ACCORD_EXPORT int64_t accord_fused_attr_workspace_words(int64_t S,
                                                        int64_t s) {
  return attr_workspace_words(S, s);
}

// ptrs: qmats int64[S*B*qcols], workspace int64[words]
//       (accord_fused_scan_workspace_words), hdr int32[S*(2+B)], ent[S*s]
// vals: S (at most MAX_STORES), B, qcols, m, n_max, m_max, wide, s, k,
//       workspace words; then 9 per member: its table's msb, lsb, node,
//       kind, status, lo, hi (addresses), n, m_t; then 3 per member: its
//       prune floor's msb, lsb, node
ACCORD_EXPORT int accord_fused_deps_dense(void* const* p, const int64_t* v,
                                          void* stream) {
  ScanParams a;
  const int64_t S = v[0], B = v[1], N = v[4], k = v[8];
  a.qcols = (int)v[2];
  a.m = (int)v[3];
  a.M = (int)v[5];
  a.s = v[7];
  if (S < 1 || S > MAX_STORES || B < 1 || B > INT32_MAX || N < 0 ||
      N > INT32_MAX || a.m < 0 || a.m > DQ || a.M < 1 ||
      a.qcols != 7 + 2 * a.m || a.s < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  int64_t tiles = 0, words = 0;
  for (int64_t i = 0; i < S; ++i) {
    const int64_t* r = v + 10 + 9 * i;
    const int64_t* pr = v + 10 + 9 * S + 3 * i;
    ScanStore& x = a.st[i];
    if (r[7] < 0 || r[7] > N || r[8] < 1 || r[8] > a.M)
      return (int)cudaErrorInvalidValue;
    x.t.msb = (const int64_t*)r[0];
    x.t.lsb = (const int64_t*)r[1];
    x.t.node = (const int32_t*)r[2];
    x.t.kind = (const int32_t*)r[3];
    x.t.status = (const int32_t*)r[4];
    x.t.lo = (const int64_t*)r[5];
    x.t.hi = (const int64_t*)r[6];
    x.t.N = (int)r[7];
    x.t.m_t = (int)r[8];
    x.t.pm = pr[0];
    x.t.pl = pr[1];
    x.t.pn = (int32_t)pr[2];
    x.tile0 = (int32_t)tiles;
    x.word0 = B * words;
    x.pad_ = 0;
    tiles += (r[7] + NT - 1) / NT;
    words += (r[7] + 31) / 32;
  }
  if (v[9] < scan_workspace_words(S, B, words) || tiles > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  a.S = (int)S;
  a.B = (int)B;
  a.tiles = (int)tiles;
  a.wg = (int)((N + 31) / 32);
  a.kp = (int)min64(k, N);
  a.kk = (int)min64(k, (int64_t)a.kp * a.M * a.m);
  a.rows = mini(DR, DQ / maxi(a.m, 1));
  int64_t* ws = (int64_t*)p[1];
  a.qmats = (const int64_t*)p[0];
  a.hdr = (int32_t*)p[2];
  a.ent = p[3];
  a.starts = ws;
  a.maskw = (uint32_t*)(ws + S * (B + 1));
  a.tpre = (int32_t*)(a.maskw + B * words);
  a.counts = a.tpre + B * words;
  a.pairc = a.counts + S * B;
  a.nsel = a.pairc + S * B;
  cudaStream_t st = (cudaStream_t)stream;
  return v[6] ? launch_scan<int64_t>(a, st) : launch_scan<int32_t>(a, st);
}

// ptrs: rankb int64[S*B], hdr_raw int32[S*(2+B)], ent[S*s], workspace
//       int64[words] (accord_fused_attr_workspace_words), hdr
//       int32[S*(5+B)], out[S*s]
// vals: S (at most MAX_STORES), s, B, m_max, m, floors, elide, F, T, L
//       (the group's index lengths), wide, workspace words, then 26 per
//       member: its table's lo (address), n, m_t; its attribution columns
//       dom, status, dmsb, dlsb, dnode, emsb, elsb, enode, eknown; its
//       index fbnd, fmsb, flsb, fnode, etok, eptr, erank, exm, exl, exn,
//       estride (addresses), then F, T, L
ACCORD_EXPORT int accord_fused_attr_post(void* const* p, const int64_t* v,
                                         void* stream) {
  AttrParams a;
  const int64_t S = v[0];
  a.s = v[1];
  a.M = (int)v[3];
  a.m = (int)v[4];
  a.floors = (int)v[5];
  a.elide = (int)v[6];
  a.F = v[7];
  a.T = v[8];
  a.L = v[9];
  if (S < 1 || S > MAX_STORES || a.s < 0 || v[2] < 1 || v[2] > INT32_MAX ||
      a.M < 1 || a.m < 1 || v[11] < attr_workspace_words(S, a.s))
    return (int)cudaErrorInvalidValue;
  for (int64_t i = 0; i < S; ++i) {
    const int64_t* r = v + 12 + 26 * i;
    AttrStore& x = a.st[i];
    if (r[1] < 0 || r[2] < 1 || r[2] > a.M || r[23] > a.F || r[24] > a.T ||
        r[25] > a.L)
      return (int)cudaErrorInvalidValue;
    x.lo = (const int64_t*)r[0];
    x.n = (int32_t)r[1];
    x.m_t = (int32_t)r[2];
    x.dom = (const int32_t*)r[3];
    x.status = (const int32_t*)r[4];
    x.dmsb = (const int64_t*)r[5];
    x.dlsb = (const int64_t*)r[6];
    x.dnode = (const int32_t*)r[7];
    x.emsb = (const int64_t*)r[8];
    x.elsb = (const int64_t*)r[9];
    x.enode = (const int32_t*)r[10];
    x.eknown = (const uint8_t*)r[11];
    x.fbnd = (const int64_t*)r[12];
    x.fmsb = (const int64_t*)r[13];
    x.flsb = (const int64_t*)r[14];
    x.fnode = (const int32_t*)r[15];
    x.etok = (const int64_t*)r[16];
    x.eptr = (const int32_t*)r[17];
    x.erank = (const int64_t*)r[18];
    x.exm = (const int64_t*)r[19];
    x.exl = (const int64_t*)r[20];
    x.exn = (const int32_t*)r[21];
    x.estride = (const int64_t*)r[22];
    x.F = (int32_t)r[23];
    x.T = (int32_t)r[24];
    x.L = (int32_t)r[25];
    x.pad_ = 0;
  }
  a.S = (int)S;
  a.B = (int)v[2];
  a.nw = (a.s + 31) / 32;
  a.cpm = (int)attr_chunks(a.s);
  a.rankb = (const int64_t*)p[0];
  a.hdr_raw = (const int32_t*)p[1];
  a.ent = p[2];
  int64_t* ws = (int64_t*)p[3];
  a.hdr = (int32_t*)p[4];
  a.out = p[5];
  a.csum = (long long*)ws;
  a.tally = a.csum + S * (a.cpm + 1);
  a.keepw = (uint32_t*)(a.tally + 2 * S * a.cpm);
  cudaStream_t st = (cudaStream_t)stream;
  return v[10] ? launch_attr<int64_t>(a, st) : launch_attr<int32_t>(a, st);
}
