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
// Bound on this card: the bucketed scan reads each touched bucket line and
// the wide list once per query (bytes), plus a per-row sort of the few
// codes that pass the predicate; the dense scan reads the whole slot table
// once per query row (bytes, L2-resident for small tables).  Design: one
// block per query row.  The bucketed row first counts its valid
// candidates, gathers them into shared memory (global scratch when the row
// has more candidates than fit), sorts them with a bitonic network and
// keeps the first of each run; the dense row compacts its mask in slot
// order with a block scan.  Both write each row's first k codes to a row
// buffer; one block then scans the row counts into the header, and a last
// pass copies each row to its offset, truncated at s, exactly as the
// reference's _compact_rows does.
#include "common.cuh"

namespace {

constexpr int NT = 256;

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

struct DenseArgs {
  const int64_t* qmat;
  const int64_t *tmsb, *tlsb, *tlo, *thi;
  const int32_t *tnode, *tkind, *tstatus;
  int qcols, m, N, m_t, kp;
  int64_t pm, pl;
  int32_t pn;
};

// the dense route's exact mask: live, not invalidated, any interval pair
// overlaps, and the entry predicate
__device__ __forceinline__ bool dense_mask(const DenseArgs& a,
                                           const int64_t* row,
                                           const Query& q, int j) {
  const int32_t st = a.tstatus[j];
  if (st < 0 || st == SLOT_INVALIDATED) return false;
  if (!entry_pred(q, a.tmsb[j], a.tlsb[j], a.tnode[j], a.tkind[j], a.pm,
                  a.pl, a.pn))
    return false;
  const int64_t* lo = a.tlo + (int64_t)j * a.m_t;
  const int64_t* hi = a.thi + (int64_t)j * a.m_t;
  for (int qi = 0; qi < a.m; ++qi) {
    const int64_t qlo = row[7 + qi], qhi = row[7 + a.m + qi];
    for (int c = 0; c < a.m_t; ++c)
      if (qlo <= hi[c] && lo[c] <= qhi) return true;
  }
  return false;
}

__device__ __forceinline__ int triple_count(const DenseArgs& a,
                                            const int64_t* row, int j) {
  const int64_t* lo = a.tlo + (int64_t)j * a.m_t;
  const int64_t* hi = a.thi + (int64_t)j * a.m_t;
  int n = 0;
  for (int c = 0; c < a.m_t; ++c)
    for (int qi = 0; qi < a.m; ++qi)
      n += row[7 + qi] <= hi[c] && lo[c] <= row[7 + a.m + qi];
  return n;
}

// per row: the first kp mask columns in slot order (sel), the full mask
// count (pair_counts) and the triple count over the selected slots
__global__ void __launch_bounds__(NT)
dense_select(DenseArgs a, int32_t* sel, int32_t* pair_counts,
             int32_t* counts) {
  __shared__ int tri;
  const int b = blockIdx.x;
  const int64_t* row = a.qmat + (int64_t)b * a.qcols;
  const Query q = load_query(row);
  if (threadIdx.x == 0) tri = 0;
  __syncthreads();
  int run = 0;
  int mine = 0;
  for (int base = 0; base < a.N; base += NT) {
    const int j = base + threadIdx.x;
    const bool f = j < a.N && dense_mask(a, row, q, j);
    int tot;
    const int r = block_exclusive_scan<NT, int>(f ? 1 : 0, &tot);
    if (f && run + r < a.kp) {
      sel[(int64_t)b * a.kp + run + r] = j;
      mine += triple_count(a, row, j);
    }
    run += tot;
  }
  if (mine) atomicAdd(&tri, mine);
  __syncthreads();
  if (threadIdx.x == 0) {
    pair_counts[b] = run;
    counts[b] = tri;
  }
}

// one block: row_end = cumsum(counts), header (total, maxc, row_end),
// starts for the write pass.  maxc also covers pair_counts (dense route).
__global__ void __launch_bounds__(1024)
rows_scan(const int32_t* counts, const int32_t* pair_counts, int B,
          int64_t* starts, int32_t* hdr) {
  __shared__ int maxc;
  if (threadIdx.x == 0) maxc = 0;
  __syncthreads();
  long long run = 0;
  int mx = 0;
  for (int base = 0; base < B; base += 1024) {
    const int b = base + threadIdx.x;
    const int v = b < B ? counts[b] : 0;
    if (b < B) {
      mx = maxi(mx, v);
      if (pair_counts) mx = maxi(mx, pair_counts[b]);
    }
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

// dense triple expansion: selected slot r of row b emits its valid
// (col, q) pairs in order at the row's running triple offset
template <typename T>
__global__ void __launch_bounds__(NT)
dense_write(DenseArgs a, const int32_t* sel, const int32_t* pair_counts,
            const int64_t* starts, int kk, int64_t s, T* ent) {
  const int b = blockIdx.x;
  const int64_t* row = a.qmat + (int64_t)b * a.qcols;
  const int n = mini(pair_counts[b], a.kp);
  const int64_t st = starts[b];
  const int64_t mq = (int64_t)a.m_t * a.m;
  int run = 0;
  for (int base = 0; base < n; base += NT) {
    const int r = base + threadIdx.x;
    const int j = r < n ? sel[(int64_t)b * a.kp + r] : 0;
    const int t = r < n ? triple_count(a, row, j) : 0;
    int tot;
    int off = run + block_exclusive_scan<NT, int>(t, &tot);
    if (r < n) {
      const int64_t* lo = a.tlo + (int64_t)j * a.m_t;
      const int64_t* hi = a.thi + (int64_t)j * a.m_t;
      for (int c = 0; c < a.m_t && off < kk; ++c)
        for (int qi = 0; qi < a.m && off < kk; ++qi)
          if (row[7 + qi] <= hi[c] && lo[c] <= row[7 + a.m + qi]) {
            const int64_t pos = st + off;
            if (pos < s)
              ent[pos] = (T)((T)j * (T)mq + (T)c * (T)a.m + (T)qi);
            ++off;
          }
    }
    run += tot;
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
  rows_scan<<<1, 1024, 0, st>>>(counts, nullptr, B, starts, hdr);
  rows_write<T><<<B, NT, 0, st>>>(counts, starts, rowbuf, a.kk, s, ent);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dense(void* const* p, const int64_t* v, cudaStream_t st) {
  DenseArgs a;
  a.qmat = (const int64_t*)p[0];
  a.tmsb = (const int64_t*)p[1];
  a.tlsb = (const int64_t*)p[2];
  a.tnode = (const int32_t*)p[3];
  a.tkind = (const int32_t*)p[4];
  a.tstatus = (const int32_t*)p[5];
  a.tlo = (const int64_t*)p[6];
  a.thi = (const int64_t*)p[7];
  int32_t* counts = (int32_t*)p[8];
  int32_t* pair_counts = (int32_t*)p[9];
  int32_t* sel = (int32_t*)p[10];
  int64_t* starts = (int64_t*)p[11];
  int32_t* hdr = (int32_t*)p[12];
  T* ent = (T*)p[13];
  const int B = (int)v[0];
  a.qcols = (int)v[1];
  a.m = (int)v[2];
  a.N = (int)v[3];
  a.m_t = (int)v[4];
  a.pm = v[5];
  a.pl = v[6];
  a.pn = (int32_t)v[7];
  const int64_t s = v[9];
  const int k = (int)v[10];
  a.kp = mini(k, a.N);
  const int kk = mini(k, a.kp * a.m_t * a.m);
  cudaMemsetAsync(ent, 0xff, (size_t)s * sizeof(T), st);
  dense_select<<<B, NT, 0, st>>>(a, sel, pair_counts, counts);
  rows_scan<<<1, 1024, 0, st>>>(counts, pair_counts, B, starts, hdr);
  dense_write<T><<<B, NT, 0, st>>>(a, sel, pair_counts, starts, kk, s, ent);
  return (int)cudaGetLastError();
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

// ptrs: qmat, msb, lsb, node, kind, status, lo, hi, counts[B],
//       pair_counts[B], sel[B*kp], starts[B], hdr[2+B], ent[s]
// vals: B, qcols, m, N, m_t, pm, pl, pn, wide, s, k
ACCORD_EXPORT int accord_deps_dense(void* const* p, const int64_t* v,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return v[8] ? launch_dense<int64_t>(p, v, st)
              : launch_dense<int32_t>(p, v, st);
}
