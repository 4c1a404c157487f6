// K12: the on-device cross-shard merge of attributed CSR blocks.
//
// Replaces (JAX reference): accord_tpu/parallel/sharded.py:425
// _merge_shard_blocks, as run inside sharded_flat_attr (:472),
// sharded_bucketed_attr (:519) and sharded_fused_attr (:595, batched over
// S stores).  Input per store: d shard blocks, header int32[5+B]
// (total, raw total, raw maxc, n_trans, n_dec, row_end[B]) and entries[s],
// each read where it lies; the code offset globalizes a slot-sharded
// block's codes (code + off for code >= 0; 0 for the bucketed form, whose
// codes are global).  Output, byte-equal to the reference's flat sort: the
// entries in (row, code) order, in the bucketed form without identical
// codes and without key-domain repeats of one (row, slot, col); a
// recompacted row_end; header (total, max raw total, max raw maxc, sum
// n_trans, sum n_dec, row_end); entries[d*s] with -1 after the kept ones.
// A block that overflowed (raw total > s or raw maxc > k) leaves -1 holes
// inside its rows, whose composites (row * cs - 1) break its order: such a
// block is sorted before the merge.  The merged header still tells the
// host that a block overflowed, and the host discards such a merge for a
// re-launch.
//
// Bound on this card: bytes — d*s entries read, the merged block written.
// At the mesh's shapes (8 blocks of 8,192) that is half a megabyte: a
// call's cost is its fixed part, so the design is one launch and no
// upload.  The blocks' (header, entries, offset) travel by value in a
// __grid_constant__ parameter (MAX_REFS of them, 128 and 3 KB, set in
// ops/_build.py's LIMITS; beyond that the wrapper uploads the table), every scratch buffer is carved from one
// workspace, and the kernel writes the -1 tail and zeroes its counters
// itself.  One cooperative launch, phases between grid barriers:
//   1. one CTA per TILE positions of a block: the codes loaded coalesced
//      into shared memory, each thread walking a running row pointer along
//      row_end (staged in shared memory) over its 8 positions, one
//      upper_bound a thread, the (row, code) composites stored coalesced;
//      a block that descends anywhere is then sorted in place (bitonic,
//      padded to a power of two; a barrier more, only then);
//   2. log2(d) levels of pairwise merges by merge path: each CTA owns
//      TILE = 2,048 consecutive positions of one pair's output, finds the
//      two ends of its range with one diagonal search each (all 256
//      threads probe at once, two rounds), stages the two input segments
//      in shared memory and merges them there, 8 positions a thread; the
//      last level keeps its merged positions in registers and applies the
//      dedupe (each position's predecessor: the previous thread's last,
//      or the larger of the inputs' positions before the range), counting
//      the kept entries of its tile and of each row (one atomic a run of
//      equal rows);
//   3. each tile's kept entries written at the sum of the tiles before
//      it, the -1 tail, and per store row_end and the header.
// Grid barriers: 1 + log2(d) (2 for d = 1, whose keep pass has its own),
// so 4 for the 8-slice mesh, and one more when a block must be sorted.
// Why pairwise levels and not one d-way merge path: an exact d-way split
// of a range needs the q-th smallest (value, run) pair across d runs, a
// selection whose every probe costs d searches; a pairwise split is one
// diagonal search, so each level costs a CTA two searches, and the 8-slice
// mesh pays 3 levels.  Ties between runs merge in either order: equal
// composites give equal bytes.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int E = 8;                 // merged positions a thread
constexpr int TILE = NT * E;         // merged positions a CTA a step
constexpr int MAX_REFS = ACCORD_MERGE_MAX_REFS;  // blocks by value
constexpr int ROW_SMEM = 4096;       // row_end entries staged
constexpr int64_t INF = 0x7fffffffffffffffLL;

struct BlockRef {
  const int32_t* hdr;
  const void* ent;
  int64_t off;
};
static_assert(sizeof(BlockRef) == 3 * 8, "BlockRef is 3 int64 words");

struct MergeParams {
  BlockRef inl[MAX_REFS];
  const BlockRef* table;     // null: the blocks are inl
  const int32_t* dom;        // [ndom] (bucketed dedupe)
  int64_t S, d, s, P, cs, key_m, mq, ndom, tps;
  int32_t B;
  int64_t* ka;               // [S*d*P] composites, then merge ping-pong
  int64_t* kb;               // [S*d*P]
  int64_t* lens;             // [S*d] live entries of each block
  long long* tsum;           // [S*tps] kept entries of each tile
  unsigned long long* counts;  // [S*B] kept entries of each row
  int64_t* desc;             // [S*d*nc] a chunk of composites descends
  int32_t* hdr;              // [S*(5+B)]
  void* out;                 // [S*d*s]
};
static_assert(sizeof(MergeParams) <= 4096, "kernel parameter limit");

__device__ __forceinline__ BlockRef block_ref(const MergeParams& a,
                                              int64_t k) {
  return a.table ? a.table[k] : a.inl[k];
}

// live entries of run j (blocks j*w .. (j+1)*w - 1) of store st
__device__ __forceinline__ int64_t run_len(const MergeParams& a, int64_t st,
                                           int64_t j, int64_t w) {
  int64_t n = 0;
  for (int64_t i = j * w; i < min64((j + 1) * w, a.d); ++i)
    n += a.lens[st * a.d + i];
  return n;
}

// entries taken from a among the first k of the stable merge of a and b
// (ties from a first), by all NT threads at once: each round probes NT
// diagonal points and keeps the interval between the last true and the
// first false
__device__ int64_t coop_merge_path(const int64_t* a, int64_t la,
                                   const int64_t* b, int64_t lb, int64_t k) {
  int64_t lo = max64(0, k - lb), hi = min64(k, la);
  while (lo < hi) {
    const int64_t w = hi - lo;
    const int64_t np = w < NT ? w : NT;
    bool pred = false;
    if (threadIdx.x < np) {
      const int64_t mid = lo + ((int64_t)threadIdx.x * w) / np;
      pred = a[mid] <= b[k - 1 - mid];
    }
    const int64_t cnt = __syncthreads_count(pred);
    const int64_t nlo = cnt ? lo + ((cnt - 1) * w) / np + 1 : lo;
    const int64_t nhi = cnt < np ? lo + (cnt * w) / np : hi;
    lo = nlo;
    hi = nhi;
  }
  return lo;
}

// the same split by one thread, in shared memory
__device__ __forceinline__ int merge_path(const int64_t* a, int la,
                                          const int64_t* b, int lb, int k) {
  int lo = maxi(0, k - lb), hi = mini(k, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[k - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// does sorted position q (composite x, predecessor prev) survive the dedupe
__device__ __forceinline__ bool kept(const MergeParams& a, int64_t q,
                                     int64_t x, int64_t prev) {
  if (!a.key_m) return true;
  const bool first = q == 0 || x != prev;
  const bool firstp =
      q == 0 || floordiv(x, a.key_m) != floordiv(prev, a.key_m);
  const int64_t mcode = floormod(x, a.cs);
  const int64_t di = min64(max64(floordiv(mcode, a.mq), 0), a.ndom - 1);
  return first && (a.dom[di] != 0 || firstp);
}

// a thread's E merged positions q0.. (values v, v[-1] = prev): the kept
// ones, adding each row's kept entries to counts (one atomic a run of
// equal rows; the reference's scatter-add wraps a row of -1, a hole in
// row 0, to the last row, as an index of -1 does, and drops row B)
__device__ long long keep_count(const MergeParams& a, int64_t st, int64_t q0,
                                int64_t len, const int64_t* v,
                                int64_t prev) {
  long long n = 0, run = 0;
  int64_t run_row = 0;
  for (int e = 0; e < E && q0 + e < len; ++e) {
    if (!kept(a, q0 + e, v[e], e ? v[e - 1] : prev)) continue;
    ++n;
    int64_t row = floordiv(v[e], a.cs);
    if (row < 0) row += a.B;
    if (run && row != run_row) {
      if (run_row >= 0 && run_row < a.B)
        atomicAdd(a.counts + st * a.B + run_row, (unsigned long long)run);
      run = 0;
    }
    run_row = row;
    ++run;
  }
  if (run && run_row >= 0 && run_row < a.B)
    atomicAdd(a.counts + st * a.B + run_row, (unsigned long long)run);
  return n;
}

// the store and tile of step g of a phase over each store's merged
// entries (tiles of TILE); false past the last tile
__device__ __forceinline__ bool locate_tile(const MergeParams& a, int64_t g,
                                            int64_t* st, int64_t* t,
                                            int64_t* len) {
  for (int64_t i = 0; i < a.S; ++i) {
    const int64_t l = run_len(a, i, 0, a.d);
    const int64_t nt = (l + TILE - 1) / TILE;
    if (g < nt) {
      *st = i;
      *t = g;
      *len = l;
      return true;
    }
    g -= nt;
  }
  return false;
}

// a thread's E positions of a merged run f from q0 (INF past len)
__device__ __forceinline__ void load_run(const int64_t* f, int64_t q0,
                                         int64_t len, int64_t* v) {
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = q0 + e < len ? f[q0 + e] : INF;
}

template <typename TE>
__global__ void __launch_bounds__(NT)
merge_blocks(const __grid_constant__ MergeParams a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int64_t tile[TILE];
  __shared__ int32_t rend[ROW_SMEM];
  const int tid = threadIdx.x;
  const int64_t nblk = a.S * a.d;
  const int64_t gtid = (int64_t)blockIdx.x * NT + tid;
  const int64_t gstride = (int64_t)gridDim.x * NT;

  // 1. composites, one CTA a TILE-position chunk of a block: codes loaded
  // coalesced into shared memory, a running row pointer a thread over its
  // E positions, the composites stored coalesced; each chunk flags a
  // descent (its first position against the one before it included)
  const int64_t nc = (a.P + TILE - 1) / TILE;
  __shared__ int64_t edge;
  for (int64_t g = blockIdx.x; g < nblk * nc; g += gridDim.x) {
    const int64_t k = g / nc, base = (g % nc) * TILE;
    const int n = (int)min64(TILE, a.P - base);
    const BlockRef r = block_ref(a, k);
    const int64_t len = min64(max64((int64_t)r.hdr[0], 0), a.s);
    const bool staged = a.B <= ROW_SMEM;
    if (staged)
      for (int i = tid; i < a.B; i += NT) rend[i] = r.hdr[5 + i];
    const int32_t* row_end = staged ? rend : r.hdr + 5;
    const TE* ent = (const TE*)r.ent;
    for (int i = tid; i < n; i += NT) {
      int64_t code = INF;
      if (base + i < len) {
        code = (int64_t)ent[base + i];
        if (code >= 0) code += r.off;
      }
      tile[i] = code;
    }
    __syncthreads();
    if (tid == 0 && base > 0 && base - 1 < len) {
      int64_t code = (int64_t)ent[base - 1];
      if (code >= 0) code += r.off;
      edge = upper_bound(row_end, a.B, base - 1) * a.cs + code;
    }
    const int i0 = tid * E;
    if (i0 < n && base + i0 < len) {
      int64_t row = upper_bound(row_end, a.B, base + i0);
      for (int e = 0; e < E && i0 + e < n && base + i0 + e < len; ++e) {
        const int64_t p = base + i0 + e;
        while (row < a.B && row_end[row] <= p) ++row;
        tile[i0 + e] += row * a.cs;
      }
    }
    __syncthreads();
    int64_t* comp = a.ka + k * a.P;
    bool desc = false;
    for (int i = tid; i < n; i += NT) {
      const int64_t x = tile[i];
      if (base + i < len && base + i > 0 && x < (i ? tile[i - 1] : edge))
        desc = true;
      comp[base + i] = x;
    }
    const int flagged = __syncthreads_or(desc);
    if (tid == 0) {
      a.desc[g] = flagged;
      if (base == 0) a.lens[k] = len;
    }
  }
  for (int64_t i = gtid; i < a.S * a.B; i += gstride) a.counts[i] = 0;
  grid.sync();
  // a block that descends anywhere is sorted in place (rare: an overflow)
  int any = 0;
  for (int64_t i = tid; i < nblk * nc; i += NT) any |= a.desc[i] != 0;
  if (__syncthreads_or(any)) {
    for (int64_t k = blockIdx.x; k < nblk; k += gridDim.x) {
      int dk = 0;
      for (int64_t c = tid; c < nc; c += NT) dk |= a.desc[k * nc + c] != 0;
      if (__syncthreads_or(dk))
        block_bitonic_sort<NT, int64_t>(a.ka + k * a.P, (int)a.P);
    }
    grid.sync();
  }

  // 2. pairwise merge levels; the last one also keeps and counts
  int64_t* src = a.ka;
  int64_t* dst = a.kb;
  for (int64_t w = 1; w < a.d; w <<= 1) {
    const bool last = 2 * w >= a.d;
    const int64_t runs = (a.d + w - 1) / w;
    const int64_t pairs = (runs + 1) / 2;
    for (int64_t g = blockIdx.x;; g += gridDim.x) {
      // the pair and tile of step g
      int64_t st = -1, m = 0, t = g, la = 0, lb = 0;
      for (int64_t i = 0; i < a.S && st < 0; ++i)
        for (int64_t j = 0; j < pairs; ++j) {
          const int64_t x = run_len(a, i, 2 * j, w);
          const int64_t y = run_len(a, i, 2 * j + 1, w);
          const int64_t nt = (x + y + TILE - 1) / TILE;
          if (t < nt) {
            st = i;
            m = j;
            la = x;
            lb = y;
            break;
          }
          t -= nt;
        }
      if (st < 0) break;
      const int64_t base = (st * a.d + 2 * m * w) * a.P;
      const int64_t* ra = src + base;
      const int64_t* rb = src + base + w * a.P;
      const int64_t q0 = t * TILE, q1 = min64(q0 + TILE, la + lb);
      const int64_t i0 = coop_merge_path(ra, la, rb, lb, q0);
      const int64_t i1 = coop_merge_path(ra, la, rb, lb, q1);
      const int na = (int)(i1 - i0), nb = (int)((q1 - i1) - (q0 - i0));
      for (int i = tid; i < na + nb; i += NT)
        tile[i] = i < na ? ra[i0 + i] : rb[q0 - i0 + i - na];
      __syncthreads();
      const int diag = tid * E;
      int64_t v[E];
      if (diag < na + nb) {
        int ii = merge_path(tile, na, tile + na, nb, diag);
        int jj = diag - ii;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (diag + e >= na + nb) {
            v[e] = INF;
            continue;
          }
          const bool take_a =
              jj >= nb || (ii < na && tile[ii] <= tile[na + jj]);
          v[e] = take_a ? tile[ii++] : tile[na + jj++];
          dst[base + q0 + diag + e] = v[e];
        }
      }
      if (last) {
        // the position before the tile is the larger of the two inputs'
        // positions before their splits
        const int64_t before =
            q0 ? max64(i0 ? ra[i0 - 1] : LLONG_MIN,
                       q0 - i0 ? rb[q0 - i0 - 1] : LLONG_MIN)
               : INF;
        __syncthreads();               // every thread has merged
        tile[tid] = diag < na + nb ? v[E - 1] : INF;
        __syncthreads();
        long long n = 0;
        if (diag < na + nb)
          n = keep_count(a, st, q0 + diag, la + lb, v,
                         tid ? tile[tid - 1] : before);
        long long tot;
        block_exclusive_scan<NT, long long>(n, &tot);
        if (tid == 0) a.tsum[st * a.tps + t] = tot;
      }
      __syncthreads();                 // tile is restaged
    }
    grid.sync();
    int64_t* x = src;
    src = dst;
    dst = x;
  }
  const int64_t* fin = src;           // each store's merged run at st*d*P

  // with no merge level (d = 1), keep and count in a pass of its own
  if (a.d == 1) {
    for (int64_t g = blockIdx.x;; g += gridDim.x) {
      int64_t st, t, len;
      if (!locate_tile(a, g, &st, &t, &len)) break;
      const int64_t* f = fin + st * a.d * a.P;
      const int64_t q0 = t * TILE + (int64_t)tid * E;
      int64_t v[E];
      load_run(f, q0, len, v);
      const long long n = q0 < len
          ? keep_count(a, st, q0, len, v, q0 ? f[q0 - 1] : INF) : 0;
      long long tot;
      block_exclusive_scan<NT, long long>(n, &tot);
      if (tid == 0) a.tsum[st * a.tps + t] = tot;
    }
    grid.sync();
  }

  // 3. the kept entries, the -1 tail, row_end and the header
  TE* out = (TE*)a.out;
  const int64_t n_out = a.d * a.s;
  for (int64_t g = blockIdx.x;; g += gridDim.x) {
    int64_t st, t, len;
    if (!locate_tile(a, g, &st, &t, &len)) break;
    long long before = 0;
    for (int64_t i = tid; i < t; i += NT) before += a.tsum[st * a.tps + i];
    long long tot;
    block_exclusive_scan<NT, long long>(before, &tot);
    before = tot;
    const int64_t* f = fin + st * a.d * a.P;
    const int64_t q0 = t * TILE + (int64_t)tid * E;
    int64_t v[E];
    load_run(f, q0, len, v);
    bool keep[E];
    long long n = 0;
    const int64_t prev = q0 && q0 < len ? f[q0 - 1] : INF;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      keep[e] = q0 + e < len && kept(a, q0 + e, v[e], e ? v[e - 1] : prev);
      n += keep[e];
    }
    long long pos = block_exclusive_scan<NT, long long>(n, &tot) + before;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (keep[e]) out[st * n_out + pos++] = (TE)floormod(v[e], a.cs);
  }
  for (int64_t st = 0; st < a.S; ++st) {
    const int64_t nt = (run_len(a, st, 0, a.d) + TILE - 1) / TILE;
    long long k = 0;
    for (int64_t i = tid; i < nt; i += NT) k += a.tsum[st * a.tps + i];
    long long tot;
    block_exclusive_scan<NT, long long>(k, &tot);
    for (int64_t q = tot + gtid; q < n_out; q += gstride)
      out[st * n_out + q] = (TE)-1;
  }
  for (int64_t st = blockIdx.x; st < a.S; st += gridDim.x) {
    int32_t* h = a.hdr + st * (5 + a.B);
    long long run = 0;
    for (int base = 0; base < a.B; base += NT) {
      const int b = base + tid;
      const long long c = b < a.B ? (long long)a.counts[st * a.B + b] : 0;
      long long tot;
      const long long e = block_exclusive_scan<NT, long long>(c, &tot);
      if (b < a.B) h[5 + b] = (int32_t)(run + e + c);
      run += tot;
    }
    if (tid == 0) {
      long long mx1 = LLONG_MIN, mx2 = LLONG_MIN, s3 = 0, s4 = 0;
      for (int64_t j = 0; j < a.d; ++j) {
        const int32_t* hj = block_ref(a, st * a.d + j).hdr;
        mx1 = max64(mx1, hj[1]);
        mx2 = max64(mx2, hj[2]);
        s3 += hj[3];
        s4 += hj[4];
      }
      h[0] = (int32_t)run;
      h[1] = (int32_t)mx1;
      h[2] = (int32_t)mx2;
      h[3] = (int32_t)s3;
      h[4] = (int32_t)s4;
    }
  }
}

// the workspace's int64 words for S stores of d blocks of s entries and B
// rows (P = s rounded up to a power of two): composites and merge buffers
// (2*d*P a store), run lengths (d), tile sums (tps), row counts (B) and
// descent flags (d*nc)
int64_t workspace_words(int64_t S, int64_t d, int64_t s, int64_t B) {
  const int64_t P = next_pow2((int)(s > 0 ? s : 1));
  const int64_t tps = (d * s + TILE - 1) / TILE;
  const int64_t nc = (P + TILE - 1) / TILE;
  return S * (2 * d * P + d + tps + B + d * nc);
}

template <typename TE>
int launch(MergeParams& a, cudaStream_t st) {
  const int64_t chunks = a.S * a.d * ((a.P + TILE - 1) / TILE);
  const int64_t tiles = a.S * a.tps;
  return launch_cooperative(merge_blocks<TE>, NT,
                            chunks > tiles ? chunks : tiles, a, st);
}

}  // namespace

// The workspace a call needs, in int64 words: the wrapper allocates it.
ACCORD_EXPORT int64_t accord_merge_workspace_words(int64_t S, int64_t d,
                                                   int64_t s, int64_t B) {
  return workspace_words(S, d, s, B);
}

// ptrs: table BlockRef[S*d] (null: the blocks are in vals), dom int32[ndom]
//       (bucketed dedupe; null otherwise), workspace int64[words]
//       (accord_merge_workspace_words), hdr int32[S*(5+B)], out[S*d*s]
// vals: S, d, s, B, codespace, dedupe_key_m (0: no dedupe), mq, ndom, wide,
//       workspace words, then with a null table S*d x (hdr, entries,
//       code offset), store-major
ACCORD_EXPORT int accord_merge_blocks(void* const* p, const int64_t* v,
                                      void* stream) {
  MergeParams a;
  a.table = (const BlockRef*)p[0];
  a.dom = (const int32_t*)p[1];
  int64_t* ws = (int64_t*)p[2];
  a.hdr = (int32_t*)p[3];
  a.out = p[4];
  a.S = v[0];
  a.d = v[1];
  a.s = v[2];
  a.B = (int32_t)v[3];
  a.cs = v[4];
  a.key_m = v[5];
  a.mq = v[6];
  a.ndom = v[7];
  const bool wide = v[8] != 0;
  if (a.S < 1 || a.d < 1 || a.s < 0 || a.B < 1 || a.cs < 1 || a.mq < 1 ||
      (a.key_m && (a.dom == nullptr || a.ndom < 1)))
    return (int)cudaErrorInvalidValue;
  if (a.table == nullptr) {
    if (a.S * a.d > MAX_REFS) return (int)cudaErrorInvalidValue;
    for (int64_t k = 0; k < a.S * a.d; ++k) {
      a.inl[k].hdr = (const int32_t*)v[10 + 3 * k];
      a.inl[k].ent = (const void*)v[11 + 3 * k];
      a.inl[k].off = v[12 + 3 * k];
    }
  }
  if (v[9] < workspace_words(a.S, a.d, a.s, a.B))
    return (int)cudaErrorInvalidValue;
  a.P = next_pow2((int)(a.s > 0 ? a.s : 1));
  a.tps = (a.d * a.s + TILE - 1) / TILE;
  a.ka = ws;
  a.kb = a.ka + a.S * a.d * a.P;
  a.lens = a.kb + a.S * a.d * a.P;
  a.tsum = (long long*)(a.lens + a.S * a.d);
  a.counts = (unsigned long long*)(a.tsum + a.S * a.tps);
  a.desc = (int64_t*)(a.counts + a.S * a.B);
  cudaStream_t st = (cudaStream_t)stream;
  return wide ? launch<int64_t>(a, st) : launch<int32_t>(a, st);
}
