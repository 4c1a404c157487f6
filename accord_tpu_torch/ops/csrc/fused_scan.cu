// K5: the dense deps scan and its attribution for S stores in one launch.
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
// the group's (n_max, m_max), codes on m_max.
//
// The reference pads and stacks the tables inside its jitted program.
// Here each store is read where it lies: the wrapper uploads one table of
// per-store base pointers and sizes (StoreRef), the store is blockIdx.y,
// and the padding is applied by rule in the accessors below — slots at or
// past n_i read as FREE (msb = lsb = node = kind = 0), interval columns
// at or past m_t_i as PAD (lo = INT64_MAX, hi = INT64_MIN), attribution
// rows past n_i as (Range, FREE, 0...), index tails as +INF / 0 / the
// live eptr length — so every compare sees the reference's padded bytes.
// The kernels are those of deps_scan.cu (dense route) and attr_post.cu
// with a store index; a fused flush makes the same launches as one solo
// dense attributed flush (4 memsets, 8 kernels), whatever S is.
//
// Bound on this card: as the solo kernels, times S — the dense scan reads
// each store's table once per query row (L2-resident at the fused flushes'
// sizes); the attribution reads each entry once.  What fusion saves is
// S-1 launch sequences and their round trips, not bytes.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int64_t PAD_LO = 0x7fffffffffffffffLL;
constexpr int64_t PAD_HI = (int64_t)0x8000000000000000ULL;
constexpr int64_t I64_INF = 0x7fffffffffffffffLL;

// one store of the group, as the wrapper's table row lays it out
struct StoreRef {
  const int64_t *msb, *lsb;
  const int32_t *node, *kind, *status;
  const int64_t *lo, *hi;
  const int32_t *dom, *astatus;
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
  int64_t n, m_t, F, T, L;
};
static_assert(sizeof(StoreRef) == 32 * 8, "StoreRef is 32 int64 words");

// the store's table padded to the group's (N, M), by rule
struct PadTable {
  const StoreRef& r;
  int64_t N, M;
  __device__ int32_t status(int64_t j) const {
    return j < r.n ? r.status[j] : SLOT_FREE;
  }
  __device__ int64_t msb(int64_t j) const { return j < r.n ? r.msb[j] : 0; }
  __device__ int64_t lsb(int64_t j) const { return j < r.n ? r.lsb[j] : 0; }
  __device__ int32_t node(int64_t j) const { return j < r.n ? r.node[j] : 0; }
  __device__ int32_t kind(int64_t j) const { return j < r.n ? r.kind[j] : 0; }
  __device__ int64_t lo(int64_t j, int64_t c) const {
    return (j < r.n && c < r.m_t) ? r.lo[j * r.m_t + c] : PAD_LO;
  }
  __device__ int64_t hi(int64_t j, int64_t c) const {
    return (j < r.n && c < r.m_t) ? r.hi[j * r.m_t + c] : PAD_HI;
  }
};

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

struct ScanArgs {
  const StoreRef* refs;
  const int64_t* qmats;    // [S, B, qcols]
  const int64_t* prunes;   // [S, 3]
  int B, qcols, m, kp;
  int64_t N, M;
};

// the dense route's exact mask over the padded table (deps_scan.cu's
// dense_mask with the store's prune floor)
__device__ __forceinline__ bool fused_mask(const PadTable& t,
                                           const int64_t* row,
                                           const Query& q, int m,
                                           const int64_t* pr, int64_t j) {
  const int32_t st = t.status(j);
  if (st < 0 || st == SLOT_INVALIDATED) return false;
  const int64_t em = t.msb(j), el = t.lsb(j);
  const int32_t en = t.node(j);
  if (!(((q.wit >> t.kind(j)) & 1) && ts_lt(em, el, en, q.bm, q.bl, q.bn) &&
        !ts_eq(em, el, en, q.sm, q.sl, q.sn) &&
        !ts_lt(em, el, en, pr[0], pr[1], (int32_t)pr[2])))
    return false;
  for (int qi = 0; qi < m; ++qi) {
    const int64_t qlo = row[7 + qi], qhi = row[7 + m + qi];
    for (int64_t c = 0; c < t.M; ++c)
      if (qlo <= t.hi(j, c) && t.lo(j, c) <= qhi) return true;
  }
  return false;
}

__device__ __forceinline__ int triple_count(const PadTable& t,
                                            const int64_t* row, int m,
                                            int64_t j) {
  int n = 0;
  for (int64_t c = 0; c < t.M; ++c)
    for (int qi = 0; qi < m; ++qi)
      n += row[7 + qi] <= t.hi(j, c) && t.lo(j, c) <= row[7 + m + qi];
  return n;
}

// per (row, store): the first kp mask columns in slot order, the full
// mask count and the triple count over the selected slots.  Pad slots
// (j >= n_i) are FREE, never in the mask, so the scan stops at n_i.
__global__ void __launch_bounds__(NT)
fused_select(ScanArgs a, int32_t* sel, int32_t* pair_counts,
             int32_t* counts) {
  __shared__ int tri;
  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const StoreRef& r = a.refs[s];
  const PadTable t{r, a.N, a.M};
  const int64_t rb = (int64_t)s * a.B + b;
  const int64_t* row = a.qmats + rb * a.qcols;
  const int64_t* pr = a.prunes + 3 * (int64_t)s;
  const Query q = load_query(row);
  if (threadIdx.x == 0) tri = 0;
  __syncthreads();
  int run = 0;
  int mine = 0;
  for (int64_t base = 0; base < r.n; base += NT) {
    const int64_t j = base + threadIdx.x;
    const bool f = j < r.n && fused_mask(t, row, q, a.m, pr, j);
    int tot;
    const int rk = block_exclusive_scan<NT, int>(f ? 1 : 0, &tot);
    if (f && run + rk < a.kp) {
      sel[rb * a.kp + run + rk] = (int32_t)j;
      mine += triple_count(t, row, a.m, j);
    }
    run += tot;
  }
  if (mine) atomicAdd(&tri, mine);
  __syncthreads();
  if (threadIdx.x == 0) {
    pair_counts[rb] = run;
    counts[rb] = tri;
  }
}

// one block per store: row_end = cumsum(counts), header (total, maxc,
// row_end), starts for the write pass; maxc also covers pair_counts
__global__ void __launch_bounds__(1024)
fused_rows_scan(const int32_t* counts, const int32_t* pair_counts, int B,
                int64_t* starts, int32_t* hdr) {
  __shared__ int maxc;
  const int64_t s = blockIdx.y;
  counts += s * B;
  pair_counts += s * B;
  starts += s * B;
  hdr += s * (2 + B);
  if (threadIdx.x == 0) maxc = 0;
  __syncthreads();
  long long run = 0;
  int mx = 0;
  for (int base = 0; base < B; base += 1024) {
    const int b = base + threadIdx.x;
    const int v = b < B ? counts[b] : 0;
    if (b < B) mx = maxi(mx, maxi(v, pair_counts[b]));
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

// triple expansion of the selected slots at each row's offset, codes on
// the group's M
template <typename T>
__global__ void __launch_bounds__(NT)
fused_write(ScanArgs a, const int32_t* sel, const int32_t* pair_counts,
            const int64_t* starts, int kk, int64_t s_len, T* ent) {
  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const PadTable t{a.refs[s], a.N, a.M};
  const int64_t rb = (int64_t)s * a.B + b;
  const int64_t* row = a.qmats + rb * a.qcols;
  T* out = ent + (int64_t)s * s_len;
  const int n = mini(pair_counts[rb], a.kp);
  const int64_t st = starts[rb];
  const int64_t mq = a.M * a.m;
  int run = 0;
  for (int base = 0; base < n; base += NT) {
    const int rr = base + threadIdx.x;
    const int64_t j = rr < n ? sel[rb * a.kp + rr] : 0;
    const int tc = rr < n ? triple_count(t, row, a.m, j) : 0;
    int tot;
    int off = run + block_exclusive_scan<NT, int>(tc, &tot);
    if (rr < n) {
      for (int64_t c = 0; c < a.M && off < kk; ++c)
        for (int qi = 0; qi < a.m && off < kk; ++qi)
          if (row[7 + qi] <= t.hi(j, c) && t.lo(j, c) <= row[7 + a.m + qi]) {
            const int64_t pos = st + off;
            if (pos < s_len)
              out[pos] = (T)((T)j * (T)mq + (T)c * (T)a.m + (T)qi);
            ++off;
          }
    }
    run += tot;
  }
}

template <typename T>
int launch_scan(void* const* p, const int64_t* v, cudaStream_t st) {
  ScanArgs a;
  a.refs = (const StoreRef*)p[0];
  a.qmats = (const int64_t*)p[1];
  a.prunes = (const int64_t*)p[2];
  int32_t* counts = (int32_t*)p[3];
  int32_t* pair_counts = (int32_t*)p[4];
  int32_t* sel = (int32_t*)p[5];
  int64_t* starts = (int64_t*)p[6];
  int32_t* hdr = (int32_t*)p[7];
  T* ent = (T*)p[8];
  const int S = (int)v[0];
  a.B = (int)v[1];
  a.qcols = (int)v[2];
  a.m = (int)v[3];
  a.N = v[4];
  a.M = v[5];
  const int64_t s = v[7];
  const int k = (int)v[8];
  a.kp = (int)min64(k, a.N);
  const int kk = (int)min64(k, (int64_t)a.kp * a.M * a.m);
  cudaMemsetAsync(ent, 0xff, (size_t)S * s * sizeof(T), st);
  if (S > 0 && a.B > 0) {
    const dim3 rows(a.B, S);
    fused_select<<<rows, NT, 0, st>>>(a, sel, pair_counts, counts);
    fused_rows_scan<<<dim3(1, S), 1024, 0, st>>>(counts, pair_counts, a.B,
                                                 starts, hdr);
    fused_write<T><<<rows, NT, 0, st>>>(a, sel, pair_counts, starts, kk, s,
                                        ent);
  }
  return (int)cudaGetLastError();
}

// -- attribution --------------------------------------------------------------

// the store's attribution columns and index padded to the group, by rule
struct PadAttr {
  const StoreRef& r;
  int64_t N, M, F, T, L;
  __device__ int32_t dom(int64_t j) const { return j < r.n ? r.dom[j] : 1; }
  __device__ int32_t status(int64_t j) const {
    return j < r.n ? r.astatus[j] : SLOT_FREE;
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
  __device__ bool eknown(int64_t j) const {
    return j < r.n && r.eknown[j];
  }
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

// searchsorted over an accessor: left (first x >= v) or right (first x > v)
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

struct AttrArgs {
  const StoreRef* refs;
  const int64_t* rankb;     // [S, B]
  const int32_t* hdr_raw;   // [S, 2+B]
  int64_t s, N, M, F, T, L;
  int B, m, floors, elide;
};

template <typename T>
__device__ __forceinline__ int64_t pair_key(const int32_t* row_end, int B,
                                            int m, const T* ent,
                                            int64_t pos) {
  const int64_t row = min64(upper_bound(row_end, B, pos), (int64_t)B - 1);
  return row * (int64_t(1) << 40) + floordiv((int64_t)ent[pos], m);
}

// keep flag of entry (pos, store); drops per row and elision tallies
template <typename T>
__global__ void __launch_bounds__(NT)
fused_keep(AttrArgs a, const T* ent_all, int32_t* keep_all,
           unsigned long long* drops_all, unsigned long long* tallies_all) {
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t s = blockIdx.y;
  if (pos >= a.s) return;
  const PadAttr x{a.refs[s], a.N, a.M, a.F, a.T, a.L};
  const int32_t* hdr_raw = a.hdr_raw + s * (2 + a.B);
  const int32_t* row_end = hdr_raw + 2;
  const T* ent = ent_all + s * a.s;
  int32_t* keep = keep_all + s * a.s;
  unsigned long long* drops = drops_all + s * a.B;
  unsigned long long* tallies = tallies_all + 2 * s;
  const int64_t total = hdr_raw[0];
  if (pos >= total) {
    keep[pos] = 0;
    return;
  }
  const int64_t code = (int64_t)ent[pos];
  const int64_t mq = a.M * a.m;
  const int64_t slot = max64(floordiv(code, mq), 0);
  const int64_t col =
      min64(max64(floordiv(floormod(code, mq), a.m), 0), a.M - 1);
  const int64_t row = min64(upper_bound(row_end, a.B, pos), (int64_t)a.B - 1);
  const bool key_dep = x.dom(slot) == 0;
  const int32_t st = x.status(slot);
  const int64_t tok = x.tlo(slot, col);
  const int64_t dm = x.dmsb(slot), dl = x.dlsb(slot);
  const int32_t dn = x.dnode(slot);
  bool keep_floor = true;
  if (a.floors) {
    const int64_t fi =
        search<true>(a.F, tok, [&](int64_t i) { return x.fbnd(i); });
    keep_floor = !ts_lt(dm, dl, dn, x.fmsb(fi), x.flsb(fi), x.fnode(fi));
  }
  const bool el_trans = st == SLOT_TRANSITIVE;
  bool el_dec = false;
  if (a.elide) {
    const int64_t seg =
        search<false>(a.T, tok, [&](int64_t i) { return x.etok(i); });
    const int64_t seg_c = min64(seg, max64(a.T - 1, 0));
    const bool seg_ok = x.etok(seg_c) == tok;
    const int64_t base = x.eptr(seg_c);
    const int64_t key = seg_c * x.r.estride[0] + a.rankb[s * a.B + row];
    const int64_t cnt =
        search<false>(a.L, key, [&](int64_t i) { return x.erank(i); }) - base;
    const bool has_pivot = seg_ok && cnt > 0;
    const int64_t pidx = max64(base + cnt - 1, 0);
    const bool below = ts_lt(x.emsb(slot), x.elsb(slot), x.enode(slot),
                             x.exm(pidx), x.exl(pidx), x.exn(pidx));
    const bool decided = st >= SLOT_COMMITTED && st <= SLOT_APPLIED &&
                         x.eknown(slot);
    el_dec = decided && has_pivot && below;
  }
  const bool firstp =
      pos == 0 || pair_key(row_end, a.B, a.m, ent, pos) !=
                      pair_key(row_end, a.B, a.m, ent, pos - 1);
  const bool drop_key = !keep_floor || el_trans || el_dec || !firstp;
  const bool k = !key_dep || !drop_key;
  keep[pos] = k ? 1 : 0;
  if (!k) atomicAdd(drops + row, 1ULL);
  if (key_dep && firstp && keep_floor) {
    if (el_trans) atomicAdd(tallies, 1ULL);
    else if (el_dec) atomicAdd(tallies + 1, 1ULL);
  }
}

// exclusive scan of keep within each block; block sums to ``bsum``
__global__ void __launch_bounds__(NT)
fused_scan_blocks(const int32_t* keep, int64_t s_len, int32_t* local,
                  long long* bsum) {
  const int64_t s = blockIdx.y;
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int v = pos < s_len ? keep[s * s_len + pos] : 0;
  int tot;
  const int e = block_exclusive_scan<NT, int>(v, &tot);
  if (pos < s_len) local[s * s_len + pos] = e;
  if (threadIdx.x == 0) bsum[s * gridDim.x + blockIdx.x] = tot;
}

// one block per store: exclusive scan of its block sums, in place
__global__ void __launch_bounds__(1024)
fused_scan_sums(long long* bsum, int64_t nb) {
  bsum += (int64_t)blockIdx.y * nb;
  long long run = 0;
  for (int64_t base = 0; base < nb; base += 1024) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < nb ? bsum[i] : 0;
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(v, &tot);
    if (i < nb) bsum[i] = run + e;
    run += tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
fused_attr_write(const int32_t* keep, const int32_t* local,
                 const long long* bsum, const T* ent, int64_t s_len, T* out) {
  const int64_t s = blockIdx.y;
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (pos < s_len && keep[s * s_len + pos])
    out[s * s_len + bsum[s * gridDim.x + blockIdx.x] + local[s * s_len + pos]] =
        ent[s * s_len + pos];
}

// one block per store: new_end = row_end - cumsum(drops), the header
__global__ void __launch_bounds__(1024)
fused_attr_header(const int32_t* hdr_raw, const unsigned long long* drops,
                  const unsigned long long* tallies, int B, int32_t* hdr) {
  const int64_t s = blockIdx.y;
  hdr_raw += s * (2 + B);
  drops += s * B;
  tallies += 2 * s;
  hdr += s * (5 + B);
  long long run = 0;
  for (int base = 0; base < B; base += 1024) {
    const int b = base + threadIdx.x;
    const long long d = b < B ? (long long)drops[b] : 0;
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(d, &tot);
    if (b < B) hdr[5 + b] = (int32_t)((long long)hdr_raw[2 + b] - (run + e + d));
    run += tot;
  }
  if (threadIdx.x == 0) {
    hdr[0] = (int32_t)((long long)hdr_raw[2 + B - 1] - run);
    hdr[1] = hdr_raw[0];
    hdr[2] = hdr_raw[1];
    hdr[3] = (int32_t)tallies[0];
    hdr[4] = (int32_t)tallies[1];
  }
}

template <typename T>
int launch_attr(void* const* p, const int64_t* v, cudaStream_t st) {
  AttrArgs a;
  a.refs = (const StoreRef*)p[0];
  a.rankb = (const int64_t*)p[1];
  a.hdr_raw = (const int32_t*)p[2];
  const T* ent = (const T*)p[3];
  int32_t* keep = (int32_t*)p[4];
  int32_t* local = (int32_t*)p[5];
  long long* bsum = (long long*)p[6];
  unsigned long long* drops = (unsigned long long*)p[7];
  unsigned long long* tallies = (unsigned long long*)p[8];
  int32_t* hdr = (int32_t*)p[9];
  T* out = (T*)p[10];
  const int S = (int)v[0];
  a.s = v[1];
  a.B = (int)v[2];
  a.N = v[3];
  a.M = v[4];
  a.m = (int)v[5];
  a.floors = (int)v[6];
  a.elide = (int)v[7];
  a.F = v[8];
  a.T = v[9];
  a.L = v[10];
  const int64_t nb = (a.s + NT - 1) / NT;
  cudaMemsetAsync(out, 0xff, (size_t)S * a.s * sizeof(T), st);
  cudaMemsetAsync(drops, 0, (size_t)S * a.B * sizeof(unsigned long long), st);
  cudaMemsetAsync(tallies, 0, (size_t)S * 2 * sizeof(unsigned long long), st);
  if (S <= 0) return (int)cudaGetLastError();
  if (nb > 0) {
    const dim3 grid((unsigned)nb, S);
    fused_keep<T><<<grid, NT, 0, st>>>(a, ent, keep, drops, tallies);
    fused_scan_blocks<<<grid, NT, 0, st>>>(keep, a.s, local, bsum);
    fused_scan_sums<<<dim3(1, S), 1024, 0, st>>>(bsum, nb);
    fused_attr_write<T><<<grid, NT, 0, st>>>(keep, local, bsum, ent, a.s,
                                             out);
  }
  fused_attr_header<<<dim3(1, S), 1024, 0, st>>>(a.hdr_raw, drops, tallies,
                                                 a.B, hdr);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: refs StoreRef[S], qmats int64[S*B*qcols], prunes int64[S*3],
//       counts[S*B], pair_counts[S*B], sel[S*B*kp], starts[S*B],
//       hdr int32[S*(2+B)], ent[S*s]
// vals: S, B, qcols, m, n_max, m_max, wide, s, k
ACCORD_EXPORT int accord_fused_deps_dense(void* const* p, const int64_t* v,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return v[6] ? launch_scan<int64_t>(p, v, st)
              : launch_scan<int32_t>(p, v, st);
}

// ptrs: refs StoreRef[S], rankb int64[S*B], hdr_raw int32[S*(2+B)],
//       ent[S*s], keep[S*s], local[S*s], bsum[S*nb], drops[S*B],
//       tallies[S*2], hdr int32[S*(5+B)], out[S*s]
// vals: S, s, B, n_max, m_max, m, floors, elide, F, T, L, wide
ACCORD_EXPORT int accord_fused_attr_post(void* const* p, const int64_t* v,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return v[11] ? launch_attr<int64_t>(p, v, st)
               : launch_attr<int32_t>(p, v, st);
}
