// K2: post-compaction attribution over the compacted entry buffer.
//
// Replaces (JAX reference, accord_tpu/ops/deps_kernel.py): _attr_post (:921)
// with _attr_key_masks (:875), as composed by calculate_deps_flat_attr
// (:998) and bucketed_attr (:1015, jitted :1034); with ``tok=`` as the
// mesh-bucketed attribution runs it (accord_tpu/parallel/sharded.py:578),
// and attr_tok, that caller's per-entry token (:566-576, the psum's
// contributions of the slices on one device).
// Input: the raw CSR of K1 (header int32[2+B], entries[s]).  Output,
// byte-equal to the reference: header int32[5+B] = (total, raw total,
// raw maxc, n_trans, n_dec, row_end[B]) and the kept entries recompacted
// in order, -1 elsewhere.
//
// Per live entry: its row by searchsorted(row_end, pos, right); for
// key-domain deps the exact per-token RedundantBefore floor (searchsorted
// of the token in fbnd, right side), TRANSITIVE elision, decided-below-
// pivot elision (searchsorted of seg*estride + rankb in erank, left side)
// and the (row, slot, col) dedupe against the previous entry.  The static
// ``floors`` / ``elide`` switches drop whole legs, as in the reference.
//
// Bound on this card: bytes — each entry is read once and written at most
// once, with a handful of gathers (attr columns, one lo) and two short
// binary searches per entry.  At the main path's sizes a call is its fixed
// part (the burn's calls hold a few hundred entries), so the design is one
// cooperative launch, one workspace (accord_attr_workspace_words) and no
// memset, in three phases between two grid barriers:
//   1. each CTA takes a contiguous range of 32-entry words, a warp a word,
//      a lane an entry: its row by one search of row_end staged in shared
//      memory, the previous entry's (row, slot, col) key from the lane
//      before (lane 0 computes its own), the keep flag, and one ballot
//      word of keep flags; the CTA sums its kept entries and its elision
//      tallies (integers, so the order does not matter);
//   2. one CTA scans the CTAs' sums into their offsets and sums the
//      tallies into the header;
//   3. each CTA places its kept entries at its offset (1,024 words at a
//      time: a block scan of their popcounts, then the warps write the
//      words' entries in turn, a word coalesced), writes -1 after the
//      last kept entry, and the recompacted row_end.  No per-row drop
//      counts: entries are in row order, so the live entries of rows <= b
//      are the positions below X(b) = min(row_end[b], total, s)
//      (min(total, s) for the last row, which takes every later
//      position), and row b's new end is row_end[b] - (X(b) -
//      kept(X(b))), with kept(x) the kept entries below position x: the
//      thread whose word holds X(b) reads it off its word's offset and a
//      popcount, and CTA 0 takes X(b) = s.
#include <cooperative_groups.h>

#include "common.cuh"
#include "dense_tile.cuh"

namespace cg = cooperative_groups;
namespace dt = dense_tile;

namespace {

constexpr int NT = 256;
// attr_post's CTA: 1,024 threads, two an SM (32 registers a thread), so
// that the grid barriers and the one-CTA scan see few CTAs while as many
// warps are in flight as with small CTAs
constexpr int ANT = 1024;
// row_end entries staged in shared memory (a larger batch searches global)
constexpr int SROWS = 2048;

struct AttrArgs {
  const int64_t* tlo;
  const int32_t *dom, *status, *dnode, *enode, *fnode, *eptr, *exn;
  const int64_t *dmsb, *dlsb, *emsb, *elsb, *fbnd, *fmsb, *flsb, *etok,
      *erank, *exm, *exl, *estride, *rankb;
  const uint8_t* eknown;
  const int32_t* hdr_raw;
  const void* ent;
  const int64_t* tok;   // per-entry token (mesh bucketed), or null: tlo
  int32_t* hdr;
  void* out;
  uint32_t* keepw;      // [s / 32] keep flags, one word a 32 entries
  long long* csum;      // [grid + 1] kept entries of each CTA, then
                        // their exclusive prefix and the total
  long long* tally;     // [2 x grid] n_trans, n_dec of each CTA
  int64_t s, F, T_len, L;
  int B, m_t, m, floors, elide;
};

// the keep flag of live entry ``pos`` (code, row, first of its key); a
// key-domain entry it grades adds to the elision tallies.  The legs run
// in the order that skips the most searches: a repeat of its key is
// dropped and counted nowhere, a TRANSITIVE entry needs only the floor
// (its tally), and only a decided entry above the floor needs the pivot
// search; the result is the reference's keep_floor & !el_trans & !el_dec
// & firstp, and its tallies firstp & keep_floor & el_trans and firstp &
// keep_floor & !el_trans & el_dec
template <typename T>
__device__ __forceinline__ bool entry_keep(const AttrArgs& a, T code,
                                           int64_t pos, int64_t row,
                                           bool firstp, int& n_tr,
                                           int& n_dc) {
  const T mq = (T)a.m_t * (T)a.m;
  const T q = dt::fdiv<T>(code, mq);
  const int64_t slot = max64((int64_t)q, 0);
  if (a.dom[slot] != 0) return true;       // not a key dep: kept
  if (!firstp) return false;
  const int32_t st = a.status[slot];
  const int64_t col = min64(
      max64((int64_t)dt::fdiv<T>((T)(code - q * mq), (T)a.m), 0), a.m_t - 1);
  const int64_t tok = a.tok ? a.tok[pos] : a.tlo[slot * a.m_t + col];
  if (a.floors) {
    const int64_t fi = upper_bound(a.fbnd, a.F, tok);
    if (ts_lt(a.dmsb[slot], a.dlsb[slot], a.dnode[slot], a.fmsb[fi],
              a.flsb[fi], a.fnode[fi]))
      return false;                        // below the floor
  }
  if (st == SLOT_TRANSITIVE) {
    ++n_tr;
    return false;
  }
  if (!a.elide || !(st >= SLOT_COMMITTED && st <= SLOT_APPLIED &&
                    a.eknown[slot]))
    return true;                           // not decided: no pivot
  const int64_t seg = lower_bound(a.etok, a.T_len, tok);
  const int64_t seg_c = min64(seg, max64(a.T_len - 1, 0));
  if (a.etok[seg_c] != tok) return true;
  const int64_t base = a.eptr[seg_c];
  const int64_t cnt =
      lower_bound(a.erank, a.L, seg_c * a.estride[0] + a.rankb[row]) - base;
  if (cnt <= 0) return true;
  const int64_t pidx = base + cnt - 1;
  if (ts_lt(a.emsb[slot], a.elsb[slot], a.enode[slot], a.exm[pidx],
            a.exl[pidx], a.exn[pidx])) {
    ++n_dc;                                // decided below the pivot
    return false;
  }
  return true;
}

// the entries' chains of dependent loads are hidden by the warps in
// flight, not by work inside one
template <typename T>
__global__ void __launch_bounds__(ANT, 2) attr_post(AttrArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t s_rows[SROWS];
  __shared__ unsigned long long s_sum[3];
  __shared__ unsigned s_word[ANT];
  __shared__ int s_off[ANT];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const T* ent = (const T*)a.ent;
  const int32_t* re = a.B <= SROWS ? s_rows : a.hdr_raw + 2;
  const int64_t live_end = min64(max64((int64_t)a.hdr_raw[0], 0), a.s);
  const int64_t nw = (a.s + 31) / 32;
  const int64_t wpc = (nw + gridDim.x - 1) / gridDim.x;
  const int64_t w0 = min64((int64_t)blockIdx.x * wpc, nw);
  const int64_t w1 = min64(w0 + wpc, nw);
  if (a.B <= SROWS)
    for (int i = threadIdx.x; i < a.B; i += ANT) s_rows[i] = a.hdr_raw[2 + i];
  if (threadIdx.x < 3) s_sum[threadIdx.x] = 0;
  __syncthreads();

  // 1. keep flags, a ballot word a warp
  int n_tr = 0, n_dc = 0;
  for (int64_t w = w0 + wid; w < w1; w += ANT / 32) {
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
    const bool k = live && entry_keep<T>(a, code, pos, row,
                                         pos == 0 || key != pkey, n_tr, n_dc);
    const unsigned word = __ballot_sync(0xffffffffu, k);
    if (lane == 0) {
      a.keepw[w] = word;
      atomicAdd(&s_sum[0], (unsigned long long)__popc(word));
    }
  }
  if (n_tr) atomicAdd(&s_sum[1], (unsigned long long)n_tr);
  if (n_dc) atomicAdd(&s_sum[2], (unsigned long long)n_dc);
  __syncthreads();
  if (threadIdx.x == 0) {
    a.csum[blockIdx.x] = (long long)s_sum[0];
    a.tally[2 * blockIdx.x] = (long long)s_sum[1];
    a.tally[2 * blockIdx.x + 1] = (long long)s_sum[2];
  }
  grid.sync();

  // 2. one CTA: the CTAs' kept entries scanned in place (their offsets,
  // then the total at csum[grid]) and the tallies summed into the header.
  // (Not every CTA summing the sums before it: at a thousand CTAs that
  // reads the same few lines of L2 a million times, and it took most of
  // the call.)
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) s_sum[1] = s_sum[2] = 0;   // ordered by the scan
    long long run = 0, tr = 0, dc = 0;
    for (int base = 0; base < (int)gridDim.x; base += ANT) {
      const int i = base + threadIdx.x;
      const long long v = i < (int)gridDim.x ? a.csum[i] : 0;
      if (i < (int)gridDim.x) {
        tr += a.tally[2 * i];
        dc += a.tally[2 * i + 1];
      }
      long long tot;
      const long long e = block_exclusive_scan<ANT, long long>(v, &tot);
      if (i < (int)gridDim.x) a.csum[i] = run + e;
      run += tot;
    }
    if (tr) atomicAdd(&s_sum[1], (unsigned long long)tr);
    if (dc) atomicAdd(&s_sum[2], (unsigned long long)dc);
    __syncthreads();
    if (threadIdx.x == 0) {
      a.csum[gridDim.x] = run;
      a.hdr[1] = a.hdr_raw[0];
      a.hdr[2] = a.hdr_raw[1];
      a.hdr[3] = (int32_t)s_sum[1];
      a.hdr[4] = (int32_t)s_sum[2];
    }
  }
  grid.sync();

  // 3. each CTA's kept entries at its offset, -1 after the last, and the
  // new row ends
  long long base = a.csum[blockIdx.x];
  const long long kept_all = a.csum[gridDim.x];
  T* out = (T*)a.out;
  for (int64_t c0 = w0; c0 < w1; c0 += ANT) {
    const int64_t w = c0 + threadIdx.x;
    const unsigned word = w < w1 ? a.keepw[w] : 0u;
    int ctot;
    const int off = block_exclusive_scan<ANT, int>(__popc(word), &ctot);
    s_word[threadIdx.x] = word;
    s_off[threadIdx.x] = off;
    if (w < w1)
      dt::row_ends_in(a.hdr, a.B, re, w * 32, min64(w * 32 + 32, a.s),
                      live_end, base + off, word);
    __syncthreads();
    for (int t = wid; t < ANT && c0 + t < w1; t += ANT / 32) {
      const unsigned x = s_word[t];
      if ((x >> lane) & 1)
        out[base + s_off[t] + __popc(x & ((1u << lane) - 1u))] =
            ent[(c0 + t) * 32 + lane];
    }
    base += ctot;
    __syncthreads();   // s_word, s_off are the next chunk's
  }
  for (int64_t p = kept_all + (int64_t)blockIdx.x * ANT + threadIdx.x;
       p < a.s; p += (int64_t)gridDim.x * ANT)
    out[p] = (T)-1;
  if (blockIdx.x == 0 && live_end == a.s) {
    // the rows whose X(b) is s itself: every kept entry lies below
    const int64_t last = a.B - 1;
    for (int64_t b = dt::first_at_least(re, last, a.s) + threadIdx.x;
         b <= last; b += ANT) {
      const int32_t ne =
          (int32_t)((long long)re[b] - ((long long)a.s - kept_all));
      a.hdr[5 + b] = ne;
      if (b == last) a.hdr[0] = ne;
    }
  }
}

// CTAs a call of s entries wants: a word a warp at least
int64_t attr_ctas(int64_t s) {
  const int64_t nw = (s + 31) / 32;
  const int64_t c = (nw + ANT / 32 - 1) / (ANT / 32);
  return c > 1 ? c : 1;
}

// the workspace's int64 words for s entries: keep words (s / 32, 32 bits),
// per CTA its kept entries (then their total) and two tallies
int64_t attr_workspace_words(int64_t s) {
  return ((s + 31) / 32 + 1) / 2 + 3 * attr_ctas(s) + 1;
}

template <typename T>
int launch(AttrArgs& a, cudaStream_t st) {
  return launch_cooperative(attr_post<T>, ANT, attr_ctas(a.s), a, st);
}

}  // namespace

// The workspace a call needs, in int64 words: the wrapper allocates it.
ACCORD_EXPORT int64_t accord_attr_workspace_words(int64_t s) {
  return attr_workspace_words(s);
}

// ptrs: tlo, dom, status, dmsb, dlsb, dnode, emsb, elsb, enode, eknown,
//       fbnd, fmsb, flsb, fnode, etok, eptr, erank, exm, exl, exn, estride,
//       rankb, hdr_raw, ent, workspace int64[words]
//       (accord_attr_workspace_words), hdr int32[5+B], out[s], tok[s]
//       (null: gather lo[slot, col])
// vals: s, B, m_t, m, floors, elide, F, T, L, wide, workspace words
ACCORD_EXPORT int accord_attr_post(void* const* p, const int64_t* v,
                                   void* stream) {
  AttrArgs a;
  a.tlo = (const int64_t*)p[0];
  a.dom = (const int32_t*)p[1];
  a.status = (const int32_t*)p[2];
  a.dmsb = (const int64_t*)p[3];
  a.dlsb = (const int64_t*)p[4];
  a.dnode = (const int32_t*)p[5];
  a.emsb = (const int64_t*)p[6];
  a.elsb = (const int64_t*)p[7];
  a.enode = (const int32_t*)p[8];
  a.eknown = (const uint8_t*)p[9];
  a.fbnd = (const int64_t*)p[10];
  a.fmsb = (const int64_t*)p[11];
  a.flsb = (const int64_t*)p[12];
  a.fnode = (const int32_t*)p[13];
  a.etok = (const int64_t*)p[14];
  a.eptr = (const int32_t*)p[15];
  a.erank = (const int64_t*)p[16];
  a.exm = (const int64_t*)p[17];
  a.exl = (const int64_t*)p[18];
  a.exn = (const int32_t*)p[19];
  a.estride = (const int64_t*)p[20];
  a.rankb = (const int64_t*)p[21];
  a.hdr_raw = (const int32_t*)p[22];
  a.ent = p[23];
  int64_t* ws = (int64_t*)p[24];
  a.hdr = (int32_t*)p[25];
  a.out = p[26];
  a.tok = (const int64_t*)p[27];
  a.s = v[0];
  a.B = (int)v[1];
  a.m_t = (int)v[2];
  a.m = (int)v[3];
  a.floors = (int)v[4];
  a.elide = (int)v[5];
  a.F = v[6];
  a.T_len = v[7];
  a.L = v[8];
  if (a.s < 0 || v[1] < 1 || v[1] > INT32_MAX || a.m_t < 1 || a.m < 1 ||
      v[10] < attr_workspace_words(a.s))
    return (int)cudaErrorInvalidValue;
  const int64_t ctas = attr_ctas(a.s);
  a.csum = (long long*)ws;
  a.tally = a.csum + ctas + 1;
  a.keepw = (uint32_t*)(a.tally + 2 * ctas);
  cudaStream_t st = (cudaStream_t)stream;
  return v[9] ? launch<int64_t>(a, st) : launch<int32_t>(a, st);
}

namespace {

// the pointers an attr_tok launch takes by value: every slice's lo (null
// for a slice on another device), then the entries of its rows of tok
constexpr int TOK_REFS = ACCORD_TOK_MAX_REFS;   // ops/_build.py LIMITS

struct TokParams {
  int64_t d, s, sn, rows;
  int m_t, m;
  int64_t* tok;                // the launch's first row of tok [d, s]
  const void* ref[TOK_REFS];   // lo [sn * m_t] of slice o < d, then row
                               // i's entries [s] at ref[d + i]
};

// tok[i*s + p]: the token lo[slot, col] of row i's entry p, read from the
// slice that owns the slot when that slice is on this device (ref[owner]
// non-null), else 0 — one device's contribution to the cross-slice sum.
// A thread a code.
template <typename T>
__global__ void __launch_bounds__(NT)
attr_tok(const __grid_constant__ TokParams a) {
  const int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t i = blockIdx.y;
  if (p >= a.s) return;
  const int64_t code = (int64_t)__ldg((const T*)a.ref[a.d + i] + p);
  const int64_t mq = (int64_t)a.m_t * a.m;
  const int64_t slot = max64(floordiv(code, mq), 0);
  const int64_t col = min64(max64(floordiv(floormod(code, mq), a.m), 0),
                            a.m_t - 1);
  const int64_t owner = slot / a.sn;
  const int64_t* lo =
      owner < a.d ? (const int64_t*)a.ref[owner] : (const int64_t*)nullptr;
  a.tok[i * a.s + p] =
      code >= 0 && lo ? __ldg(lo + (slot - owner * a.sn) * a.m_t + col) : 0;
}

}  // namespace

// ptrs: tok int64 (the launch's first row of tok[d, s])
// vals: d, s, sn, m_t, m, wide, rows, then d lo pointers (slice o's
//       lo[sn * m_t] on this device, or 0), then ``rows`` entries
//       pointers (int32[s], int64[s] when wide); d + rows <= TOK_REFS
ACCORD_EXPORT int accord_attr_tok(void* const* p, const int64_t* v,
                                  void* stream) {
  TokParams a;
  a.d = v[0];
  a.s = v[1];
  a.sn = v[2];
  a.m_t = (int)v[3];
  a.m = (int)v[4];
  a.rows = v[6];
  if (a.d < 1 || a.rows < 0 || a.d + a.rows > TOK_REFS || a.s < 0 ||
      a.sn < 1 || a.m_t < 1 || a.m < 1)
    return (int)cudaErrorInvalidValue;
  if (a.s == 0 || a.rows == 0) return (int)cudaGetLastError();
  a.tok = (int64_t*)p[0];
  for (int64_t k = 0; k < a.d + a.rows; ++k)
    a.ref[k] = (const void*)v[7 + k];
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((a.s + NT - 1) / NT), (unsigned)a.rows);
  if (v[5])
    attr_tok<int64_t><<<grid, NT, 0, st>>>(a);
  else
    attr_tok<int32_t><<<grid, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}
