// K12: the on-device cross-shard merge of attributed CSR blocks.
//
// Replaces (JAX reference): accord_tpu/parallel/sharded.py:425
// _merge_shard_blocks, as run inside sharded_flat_attr (:472),
// sharded_bucketed_attr (:519) and sharded_fused_attr (:595, batched over
// S stores).  Input per store: d shard blocks, header int32[5+B]
// (total, raw total, raw maxc, n_trans, n_dec, row_end[B]) and entries[s],
// each read where it lies through a table of (header, entries, code
// offset) pointers; the offset globalizes a slot-sharded block's codes
// (code + off for code >= 0; 0 for the bucketed form, whose codes are
// global).  Output, byte-equal to the reference's flat sort: the entries
// in (row, code) order, in the bucketed form without identical codes and
// without key-domain repeats of one (row, slot, col); a recompacted
// row_end; header (total, max raw total, max raw maxc, sum n_trans,
// sum n_dec, row_end); entries[d*s] with -1 after total.
//
// Each block's (row, code) composites are first written to scratch, one
// thread per entry (the row by a binary search of row_end, once per entry
// instead of once per probe), and a block that is not ascending is sorted
// there: an overflowed block (raw total > s or raw maxc > k) leaves -1
// holes inside its rows, whose composites (row * cs - 1) break the order.
// The flat sort is then a merge of ascending runs: an entry's place is the
// number of smaller composites in every block (d binary searches) plus its
// rank among equal ones (equal entries of lower shards first).  Exact for
// every input; the merged header still tells the host that a block
// overflowed, and the host discards such a merge for a re-launch.
//
// Bound on this card: bytes — d*s entries read, the merged block written,
// plus a scratch copy of the composites.  Design: a prep pass writes the
// composites (int64 max past a block's live length) and flags a block
// whose composites descend anywhere; one block of 1,024 threads sorts each
// flagged block in place (bitonic, the block padded to a power of two); a
// rank pass (one thread per input entry) scatters each composite to its
// sorted place; a keep pass over the sorted array applies the dedupe and
// counts kept entries per row; a block scan and a scan of the block sums
// place them; one block per store rebuilds row_end and the header.
#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int64_t INF = 0x7fffffffffffffffLL;

struct BlockRef {
  const int32_t* hdr;
  const void* ent;
  int64_t off;
};
static_assert(sizeof(BlockRef) == 3 * 8, "BlockRef is 3 int64 words");

struct MergeArgs {
  const BlockRef* refs;   // [S*d]
  int64_t d, s, cs, key_m, mq, ndom;
  int B;
  const int32_t* dom;
};

template <typename T>
__device__ __forceinline__ int64_t live_len(const BlockRef& r, int64_t s) {
  return min64(max64((int64_t)r.hdr[0], 0), s);
}

// the (row, code) composite of block entry p (p < live length)
template <typename T>
__device__ __forceinline__ int64_t composite(const MergeArgs& a,
                                             const BlockRef& r, int64_t p) {
  const int64_t row = upper_bound(r.hdr + 5, a.B, p);
  int64_t code = (int64_t)((const T*)r.ent)[p];
  if (code >= 0) code += r.off;
  return row * a.cs + code;
}

// block (st, i)'s composites, padded with INF to P; flag a descent
template <typename T>
__global__ void __launch_bounds__(NT)
merge_prep(MergeArgs a, int64_t P, int64_t* comp, int32_t* unsorted) {
  const int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t i = blockIdx.y, st = blockIdx.z;
  const BlockRef& r = a.refs[st * a.d + i];
  if (p >= P) return;
  const int64_t len = live_len<T>(r, a.s);
  const int64_t x = p < len ? composite<T>(a, r, p) : INF;
  comp[(st * a.d + i) * P + p] = x;
  if (p + 1 < len && composite<T>(a, r, p + 1) < x)
    atomicOr(unsorted + st * a.d + i, 1);
}

// one block per flagged shard block: sort its P composites in place
__global__ void __launch_bounds__(1024)
merge_sort_unsorted(int64_t d, int64_t P, int64_t* comp,
                    const int32_t* unsorted) {
  const int64_t b = (int64_t)blockIdx.y * d + blockIdx.x;
  if (!unsorted[b]) return;
  block_bitonic_sort<1024, int64_t>(comp + b * P, (int)P);
}

// number of a block's (ascending) composites below x (strict) or at most x
__device__ __forceinline__ int64_t count_below(const int64_t* c, int64_t len,
                                               int64_t x, bool or_equal) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (c[mid] < x || (or_equal && c[mid] == x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(NT)
merge_rank(MergeArgs a, int64_t P, const int64_t* comp, int64_t* sorted) {
  const int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t i = blockIdx.y, st = blockIdx.z;
  const BlockRef* refs = a.refs + st * a.d;
  const int64_t len = live_len<T>(refs[i], a.s);
  if (p >= len) return;
  const int64_t* cst = comp + st * a.d * P;
  const int64_t x = cst[i * P + p];
  int64_t rank = 0;
  for (int64_t j = 0; j < a.d; ++j) {
    if (j == i) {
      rank += p;    // this block's entries before p are all <= x
      continue;
    }
    rank += count_below(cst + j * P, live_len<T>(refs[j], a.s), x, j < i);
  }
  sorted[st * a.d * a.s + rank] = x;
}

// keep flag of sorted entry p, and its row's kept count
__global__ void __launch_bounds__(NT)
merge_keep(MergeArgs a, const int64_t* sorted, int32_t* keep,
           unsigned long long* counts) {
  const int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t st = blockIdx.y;
  const int64_t n = a.d * a.s;
  if (p >= n) return;
  int64_t total = 0;
  for (int64_t j = 0; j < a.d; ++j)
    total += min64(max64((int64_t)a.refs[st * a.d + j].hdr[0], 0), a.s);
  const int64_t* srt = sorted + st * n;
  bool k = p < total;
  int64_t x = INF;
  if (k) {
    x = srt[p];
    if (a.key_m) {
      const int64_t prev = p ? srt[p - 1] : INF;
      const bool first = p == 0 || x != prev;
      const bool firstp =
          p == 0 || floordiv(x, a.key_m) != floordiv(prev, a.key_m);
      const int64_t mcode = floormod(x, a.cs);
      const int64_t di =
          min64(max64(floordiv(mcode, a.mq), 0), a.ndom - 1);
      const bool is_key = a.dom[di] == 0;
      k = first && (!is_key || firstp);
    }
  }
  keep[st * n + p] = k ? 1 : 0;
  if (k) {
    // the reference's scatter-add wraps a row of -1 (a hole in row 0) to
    // the last row, as an index of -1 does
    int64_t row = floordiv(x, a.cs);
    if (row < 0) row += a.B;
    if (row >= 0 && row < a.B) atomicAdd(counts + st * a.B + row, 1ULL);
  }
}

__global__ void __launch_bounds__(NT)
scan_blocks(const int32_t* keep, int64_t n, int64_t nb, int32_t* local,
            long long* bsum) {
  const int64_t st = blockIdx.y;
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int v = pos < n ? keep[st * n + pos] : 0;
  int tot;
  const int e = block_exclusive_scan<NT, int>(v, &tot);
  if (pos < n) local[st * n + pos] = e;
  if (threadIdx.x == 0) bsum[st * nb + blockIdx.x] = tot;
}

// one block per store: exclusive scan of its block sums, in place
__global__ void __launch_bounds__(1024)
scan_sums(long long* bsum, int64_t nb) {
  long long* b = bsum + (int64_t)blockIdx.x * nb;
  long long run = 0;
  for (int64_t base = 0; base < nb; base += 1024) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < nb ? b[i] : 0;
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(v, &tot);
    if (i < nb) b[i] = run + e;
    run += tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
merge_write(MergeArgs a, const int64_t* sorted, const int32_t* keep,
            const int32_t* local, const long long* bsum, int64_t nb,
            T* out) {
  const int64_t st = blockIdx.y;
  const int64_t n = a.d * a.s;
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (pos < n && keep[st * n + pos])
    out[st * n + bsum[st * nb + blockIdx.x] + local[st * n + pos]] =
        (T)floormod(sorted[st * n + pos], a.cs);
}

// one block per store: row_end = cumsum(counts) and the merged header
__global__ void __launch_bounds__(1024)
merge_header(MergeArgs a, const unsigned long long* counts, int32_t* hdr) {
  const int64_t st = blockIdx.x;
  int32_t* h = hdr + st * (5 + a.B);
  long long run = 0;
  for (int base = 0; base < a.B; base += 1024) {
    const int b = base + threadIdx.x;
    const long long c = b < a.B ? (long long)counts[st * a.B + b] : 0;
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(c, &tot);
    if (b < a.B) h[5 + b] = (int32_t)(run + e + c);
    run += tot;
  }
  if (threadIdx.x == 0) {
    long long mx1 = LLONG_MIN, mx2 = LLONG_MIN, s3 = 0, s4 = 0;
    for (int64_t j = 0; j < a.d; ++j) {
      const int32_t* hj = a.refs[st * a.d + j].hdr;
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

template <typename T>
int launch(void* const* p, const int64_t* v, cudaStream_t st) {
  MergeArgs a;
  a.refs = (const BlockRef*)p[0];
  a.dom = (const int32_t*)p[1];
  int64_t* sorted = (int64_t*)p[2];
  int32_t* keep = (int32_t*)p[3];
  int32_t* local = (int32_t*)p[4];
  long long* bsum = (long long*)p[5];
  unsigned long long* counts = (unsigned long long*)p[6];
  int32_t* hdr = (int32_t*)p[7];
  T* out = (T*)p[8];
  int64_t* comp = (int64_t*)p[9];
  int32_t* unsorted = (int32_t*)p[10];
  const int64_t S = v[0];
  a.d = v[1];
  a.s = v[2];
  a.B = (int)v[3];
  a.cs = v[4];
  a.key_m = v[5];
  a.mq = v[6];
  a.ndom = v[7];
  const int64_t n = a.d * a.s;
  const int64_t nb = (n + NT - 1) / NT;
  if (S <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(out, 0xff, (size_t)(S * n) * sizeof(T), st);
  cudaMemsetAsync(counts, 0, (size_t)(S * a.B) * sizeof(unsigned long long),
                  st);
  if (n > 0) {
    const int64_t P = next_pow2((int)a.s);
    cudaMemsetAsync(unsorted, 0, (size_t)(S * a.d) * sizeof(int32_t), st);
    merge_prep<T><<<dim3((unsigned)((P + NT - 1) / NT), (unsigned)a.d,
                         (unsigned)S), NT, 0, st>>>(a, P, comp, unsorted);
    merge_sort_unsorted<<<dim3((unsigned)a.d, (unsigned)S), 1024, 0, st>>>(
        a.d, P, comp, unsorted);
    merge_rank<T><<<dim3((unsigned)((a.s + NT - 1) / NT), (unsigned)a.d,
                         (unsigned)S), NT, 0, st>>>(a, P, comp, sorted);
    merge_keep<<<dim3((unsigned)nb, (unsigned)S), NT, 0, st>>>(a, sorted,
                                                               keep, counts);
    scan_blocks<<<dim3((unsigned)nb, (unsigned)S), NT, 0, st>>>(keep, n, nb,
                                                                local, bsum);
    scan_sums<<<(unsigned)S, 1024, 0, st>>>(bsum, nb);
    merge_write<T><<<dim3((unsigned)nb, (unsigned)S), NT, 0, st>>>(
        a, sorted, keep, local, bsum, nb, out);
  }
  merge_header<<<(unsigned)S, 1024, 0, st>>>(a, counts, hdr);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: refs BlockRef[S*d] (store-major; hdr int32[5+B], entries[s], code
//       offset), dom int32[ndom] (bucketed dedupe; null otherwise),
//       sorted int64[S*d*s], keep int32[S*d*s], local int32[S*d*s],
//       bsum int64[S*nb], counts uint64[S*B], hdr int32[S*(5+B)],
//       out[S*d*s], comp int64[S*d*P] (P = s rounded up to a power of
//       two), unsorted int32[S*d]
// vals: S, d, s, B, codespace, dedupe_key_m (0: no dedupe), mq, ndom, wide
ACCORD_EXPORT int accord_merge_blocks(void* const* p, const int64_t* v,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return v[8] ? launch<int64_t>(p, v, st) : launch<int32_t>(p, v, st);
}
