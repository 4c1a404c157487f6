// K11: the dense dep mask with each query's max-conflict timestamp, and the
// lexicographic max that reduces per-shard candidates.
//
// Replaces (JAX reference):
//   calc_deps <- accord_tpu/ops/deps_kernel.py:217 calculate_deps
//                (_dep_mask_and_conflict :174 + packing.masked_ts_max :84),
//                over the slot slices of one device (the local body of
//                accord_tpu/parallel/sharded.py:83 sharded_calculate_deps)
//   ts_max    <- accord_tpu/ops/packing.py:84 masked_ts_max over the
//                gathered [B, d] per-shard candidates (sharded.py:98-106,
//                mask = any field non-zero)
// Output, byte-equal to the reference: dep mask bool[B, n] per slice and,
// per (slice, query), the (msb, lsb, node) maximum over every live
// (status >= TRANSITIVE, not INVALIDATED) overlapping slot, unsigned
// lexicographic, zeros when there is none (the node never below -1: the
// reference's third pass takes the max of the tied nodes and -1).
//
// Bound on this card: bytes — the table (N x (28 + 16 m_t) bytes) read
// once and the [B, N] mask written once; at the mesh's sizes (B = 128
// queries over 2^20 slots) the mask is most of them.  Design: a CTA takes a
// tile of TILE consecutive slots of one slice, a thread SPT consecutive
// slots of it.  Each slot's status and intervals are read from HBM once
// (16-byte loads where the layout allows) and kept in registers as a live
// flag and a span (least lo, largest hi: an exact filter, as in
// dense_tile.cuh).  The queries are staged in shared memory, QC at a time,
// and the CTA loops over them: per (query, slot) one span test; only a
// slot that passes it runs the interval pairs, the predicate and the
// timestamp compares, so a dead slot costs no interval test.  The query
// batch is read where it lies (its columns by pointer and stride).  A
// thread writes its SPT mask bytes as one 16-byte streaming store, so a warp
// stores 512 contiguous bytes of a query's row (bytes one by one on a
// slice whose length or mask is not 16-byte aligned).  The max-conflict:
// a warp ballot skips a query with no conflict in the warp; otherwise a
// warp reduce, each warp's best kept in shared memory, and one candidate
// per (query, tile) written out.  The tiles' candidates of a slice are
// folded in the same launch by the slice's last CTA to finish, counted on
// a word that it sets back to zero (a second, small launch measured no
// faster: PERF.md, PR 11).  Slices travel by value in the kernel
// parameter (at most MAX_SLICES a launch).
// ts_max: a warp a row, a shuffle reduce.
#include "common.cuh"

namespace {

constexpr int NT = 256;                 // threads a CTA
constexpr int WARPS = NT / 32;
constexpr int SPT = 16;                 // consecutive slots a thread
constexpr int TILE = NT * SPT;          // slots a CTA
constexpr int QC_MAX = 128;             // queries staged at a time
constexpr int SMEM_BUDGET = 48 * 1024 - 64;
constexpr int MAX_SLICES = ACCORD_SHARDED_MAX_SLICES;  // ops/_build.py
// shared memory a staged query takes: its qmat row, its span, and each
// warp's best candidate (msb, lsb, node, valid)
__host__ __device__ constexpr int query_smem(int qcols) {
  return qcols * 8 + 16 + WARPS * (8 + 8 + 4 + 1);
}

// one slot slice of this device: the seven table columns, the mask it
// writes (bool[B, n]) and its slot count
struct SliceRef {
  const int64_t *msb, *lsb;
  const int32_t *node, *kind, *status;
  const int64_t *lo, *hi;
  uint8_t* mask;
  int64_t n;
};
static_assert(sizeof(SliceRef) == 9 * 8, "SliceRef is 9 int64 words");

// the query batch's columns where they lie (a DepsQuery: views of a qmat
// or tensors of their own), each with its strides in elements
struct QueryRef {
  const int64_t *msb, *lsb;
  const int32_t *node, *wit;
  const int64_t *lo, *hi, *smsb, *slsb;
  const int32_t* snode;
  int64_t s_msb, s_lsb, s_node, s_wit, s_lo0, s_lo1, s_hi0, s_hi1, s_smsb,
      s_slsb, s_snode;
};

// field f of query b in qmat's row layout: bound msb, lsb, node, witness
// mask, self msb, lsb, node, lo[m], hi[m]
__device__ __forceinline__ int64_t query_field(const QueryRef& q, int64_t b,
                                               int f, int m) {
  switch (f) {
    case 0: return q.msb[b * q.s_msb];
    case 1: return q.lsb[b * q.s_lsb];
    case 2: return q.node[b * q.s_node];
    case 3: return q.wit[b * q.s_wit];
    case 4: return q.smsb[b * q.s_smsb];
    case 5: return q.slsb[b * q.s_slsb];
    case 6: return q.snode[b * q.s_snode];
    default:
      return f < 7 + m ? q.lo[b * q.s_lo0 + (f - 7) * q.s_lo1]
                       : q.hi[b * q.s_hi0 + (f - 7 - m) * q.s_hi1];
  }
}

struct CalcParams {
  SliceRef s[MAX_SLICES];
  int32_t tile0[MAX_SLICES + 1];   // first tile of each slice; [S]: total
  QueryRef q;
  int64_t *pmsb, *plsb;            // candidates [S, B, T], T tiles a row
  int32_t* pnode;
  uint8_t* pvalid;
  int64_t *om, *ol;                // out [S, B]
  int32_t* on;
  uint32_t* done;                  // tiles finished, per slice
  int64_t pm, pl;                  // the prune floor
  int32_t pn;
  int S, B, qcols, m, m_t, T, qc;
};

struct Ts {
  unsigned long long m, l;
  int32_t n;
  int valid;
};

__device__ __forceinline__ bool ts_gt(const Ts& a, const Ts& b) {
  if (!a.valid) return false;
  if (!b.valid) return true;
  return a.m > b.m || (a.m == b.m && (a.l > b.l || (a.l == b.l && a.n > b.n)));
}

__device__ __forceinline__ Ts shfl_ts(const Ts& t, int o) {
  Ts r;
  r.m = __shfl_down_sync(0xffffffffu, t.m, o);
  r.l = __shfl_down_sync(0xffffffffu, t.l, o);
  r.n = __shfl_down_sync(0xffffffffu, t.n, o);
  r.valid = __shfl_down_sync(0xffffffffu, t.valid, o);
  return r;
}

// the result as the reference writes it: zeros when there is none, the
// node at least -1
__device__ __forceinline__ void put_ts(const Ts& t, int64_t* om, int64_t* ol,
                                       int32_t* on, int64_t o) {
  om[o] = t.valid ? (int64_t)t.m : 0;
  ol[o] = t.valid ? (int64_t)t.l : 0;
  on[o] = t.valid ? (t.n < -1 ? -1 : t.n) : 0;
}

// does some (query interval, slot interval) pair overlap: q is the query's
// qmat row, lo / hi the slot's table row
__device__ __forceinline__ bool overlaps(const int64_t* q, int m,
                                         const int64_t* lo,
                                         const int64_t* hi, int m_t) {
  for (int c = 0; c < m_t; ++c) {
    const int64_t tl = lo[c], th = hi[c];
    for (int qi = 0; qi < m; ++qi)
      if (q[7 + qi] <= th && tl <= q[7 + m + qi]) return true;
  }
  return false;
}

// the 4 low bits of x as 4 bytes of 0 / 1
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// the span (least lo, largest hi) of slot j's m_t intervals
template <int MT>
__device__ __forceinline__ void slot_span(const SliceRef& r, int64_t j,
                                          int m_t, bool vec, int64_t& lo,
                                          int64_t& hi) {
  lo = INT64_MAX;
  hi = INT64_MIN;
  if (MT >= 2 && MT % 2 == 0 && vec) {
    const longlong2* l2 = (const longlong2*)(r.lo + j * MT);
    const longlong2* h2 = (const longlong2*)(r.hi + j * MT);
#pragma unroll
    for (int c = 0; c < MT / 2; ++c) {
      const longlong2 a = __ldg(l2 + c), b = __ldg(h2 + c);
      lo = min64(lo, min64(a.x, a.y));
      hi = max64(hi, max64(b.x, b.y));
    }
  } else {
    const int w = MT > 0 ? MT : m_t;
    for (int c = 0; c < w; ++c) {
      lo = min64(lo, __ldg(r.lo + j * w + c));
      hi = max64(hi, __ldg(r.hi + j * w + c));
    }
  }
}

// the lexicographic max of a slice's tile candidates for query b
__device__ void fold_query(const CalcParams& p, int s, int b) {
  const int tiles = p.tile0[s + 1] - p.tile0[s];
  const int64_t row = ((int64_t)s * p.B + b) * p.T;
  Ts best{0, 0, 0, 0};
  for (int t = 0; t < tiles; ++t) {
    const int64_t e = row + t;
    if (!__ldcg(p.pvalid + e)) continue;
    const Ts c{(unsigned long long)__ldcg(p.pmsb + e),
               (unsigned long long)__ldcg(p.plsb + e), __ldcg(p.pnode + e),
               1};
    if (ts_gt(c, best)) best = c;
  }
  put_ts(best, p.om, p.ol, p.on, (int64_t)s * p.B + b);
}

template <int MT>
__global__ void __launch_bounds__(NT, 2)
calc_deps(const __grid_constant__ CalcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_cta;
  const int qc = p.qc, qcols = p.qcols, m = p.m;
  const int m_t = MT > 0 ? MT : p.m_t;
  int64_t* qrow = (int64_t*)smem;                   // [qc, qcols]
  int64_t* qspan = qrow + qc * qcols;               // [qc, 2]
  int64_t* wm = qspan + 2 * qc;                     // [qc, WARPS]
  int64_t* wl = wm + qc * WARPS;
  int32_t* wn = (int32_t*)(wl + qc * WARPS);
  uint8_t* wv = (uint8_t*)(wn + qc * WARPS);

  int s = 0;
  while ((int)blockIdx.x >= p.tile0[s + 1]) ++s;
  const SliceRef& r = p.s[s];
  const int tile = (int)blockIdx.x - p.tile0[s];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = r.n;
  const int64_t jb = (int64_t)tile * TILE + (int64_t)tid * SPT;

  // this thread's slots: live flags and spans, read once
  int32_t st[SPT];
  if (jb + SPT <= n && ((uintptr_t)(r.status + jb) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < SPT / 4; ++q) {
      const int4 v = __ldg((const int4*)(r.status + jb) + q);
      st[4 * q] = v.x;
      st[4 * q + 1] = v.y;
      st[4 * q + 2] = v.z;
      st[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      st[k] = jb + k < n ? __ldg(r.status + jb + k) : SLOT_FREE;
  }
  const bool vec_iv = (((uintptr_t)r.lo | (uintptr_t)r.hi) & 15) == 0;
  uint32_t live = 0;
  int64_t slo[SPT], shi[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    slo[k] = INT64_MAX;
    shi[k] = INT64_MIN;
    if (st[k] >= SLOT_TRANSITIVE && st[k] != SLOT_INVALIDATED) {
      live |= 1u << k;
      slot_span<MT>(r, jb + k, m_t, vec_iv, slo[k], shi[k]);
    }
  }
  const bool vec_mask = (n & 15) == 0 && ((uintptr_t)r.mask & 15) == 0;

  for (int q0 = 0; q0 < p.B; q0 += qc) {
    const int nq = mini(qc, p.B - q0);
    __syncthreads();   // the previous chunk's shared memory is read
    for (int e = tid; e < nq * qcols; e += NT) {
      const int b = e / qcols;
      qrow[e] = query_field(p.q, q0 + b, e - b * qcols, m);
    }
    for (int e = tid; e < nq * WARPS; e += NT) wv[e] = 0;
    __syncthreads();
    for (int b = tid; b < nq; b += NT) {
      int64_t lo = INT64_MAX, hi = INT64_MIN;
      for (int qi = 0; qi < m; ++qi) {
        lo = min64(lo, qrow[b * qcols + 7 + qi]);
        hi = max64(hi, qrow[b * qcols + 7 + m + qi]);
      }
      qspan[2 * b] = lo;
      qspan[2 * b + 1] = hi;
    }
    __syncthreads();
    for (int b = 0; b < nq; ++b) {
      const int64_t ql = qspan[2 * b], qh = qspan[2 * b + 1];
      uint32_t hit = 0;
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        hit |= (uint32_t)((ql <= shi[k]) & (slo[k] <= qh)) << k;
      hit &= live;
      uint32_t dep = 0;
      Ts best{0, 0, 0, 0};
      const int64_t* q = qrow + b * qcols;
      while (hit) {
        const int k = __ffs(hit) - 1;
        hit &= hit - 1u;
        const int64_t j = jb + k;
        if (!overlaps(q, m, r.lo + j * m_t, r.hi + j * m_t, m_t)) continue;
        const int64_t em = r.msb[j], el = r.lsb[j];
        const int32_t en = r.node[j];
        const Ts t{(unsigned long long)em, (unsigned long long)el, en, 1};
        if (ts_gt(t, best)) best = t;
        if (((q[3] >> r.kind[j]) & 1) &&
            ts_lt(em, el, en, q[0], q[1], (int32_t)q[2]) &&
            !ts_eq(em, el, en, q[4], q[5], (int32_t)q[6]) &&
            !ts_lt(em, el, en, p.pm, p.pl, p.pn))
          dep |= 1u << k;
      }
      uint8_t* dst = r.mask + (int64_t)(q0 + b) * n + jb;
      if (vec_mask && jb + SPT <= n) {
        uint4 v;
        v.x = nibble_bytes(dep);
        v.y = nibble_bytes(dep >> 4);
        v.z = nibble_bytes(dep >> 8);
        v.w = nibble_bytes(dep >> 12);
        __stcs((uint4*)dst, v);
      } else {
        for (int k = 0; k < SPT && jb + k < n; ++k) dst[k] = (dep >> k) & 1u;
      }
      if (__ballot_sync(0xffffffffu, best.valid)) {
        for (int o = 16; o > 0; o >>= 1) {
          const Ts u = shfl_ts(best, o);
          if (ts_gt(u, best)) best = u;
        }
        if (lane == 0) {
          const int e = b * WARPS + warp;
          wm[e] = (int64_t)best.m;
          wl[e] = (int64_t)best.l;
          wn[e] = best.n;
          wv[e] = 1;
        }
      }
    }
    __syncthreads();
    // one candidate per (query, tile)
    for (int b = tid; b < nq; b += NT) {
      Ts best{0, 0, 0, 0};
      for (int w = 0; w < WARPS; ++w) {
        const int e = b * WARPS + w;
        const Ts t{(unsigned long long)wm[e], (unsigned long long)wl[e],
                   wn[e], wv[e]};
        if (ts_gt(t, best)) best = t;
      }
      const int64_t o = ((int64_t)s * p.B + q0 + b) * p.T + tile;
      p.pmsb[o] = (int64_t)best.m;
      p.plsb[o] = (int64_t)best.l;
      p.pnode[o] = best.n;
      p.pvalid[o] = (uint8_t)best.valid;
    }
  }
  // the slice's last CTA to finish folds its tiles' candidates
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned tiles = (unsigned)(p.tile0[s + 1] - p.tile0[s]);
    last_cta = atomicAdd(p.done + s, 1u) == tiles - 1;
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  for (int b = tid; b < p.B; b += NT) fold_query(p, s, b);
  if (tid == 0) p.done[s] = 0;   // ready for the next launch
}

// out[r] = max over c of element (r, c) at r * sr + c * sc, among those
// whose fields are not all zero; zeros if none.  A warp a row: its lanes
// read the row's candidates, a shuffle reduce.
__global__ void __launch_bounds__(NT)
ts_max(const int64_t* msb, const int64_t* lsb, const int32_t* node,
       int64_t R, int64_t C, int64_t sr, int64_t sc, int64_t* om,
       int64_t* ol, int32_t* on) {
  const int64_t row = ((int64_t)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;   // whole warps exit together
  Ts best{0, 0, 0, 0};
  for (int64_t c = lane; c < C; c += 32) {
    const int64_t e = row * sr + c * sc;
    const int64_t a = msb[e], b = lsb[e];
    const int32_t k = node[e];
    const Ts t{(unsigned long long)a, (unsigned long long)b, k,
               (a != 0 || b != 0 || k != 0) ? 1 : 0};
    if (ts_gt(t, best)) best = t;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const Ts u = shfl_ts(best, o);
    if (ts_gt(u, best)) best = u;
  }
  if (lane == 0) put_ts(best, om, ol, on, row);
}

template <int MT>
int launch_calc(const CalcParams& p, unsigned grid, size_t smem,
                cudaStream_t st) {
  calc_deps<MT><<<grid, NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout of one call's candidates: [S, B, T] of msb, lsb (int64),
// node (int32) and valid (uint8) planes, T the most tiles of a slice.
ACCORD_EXPORT int64_t accord_calc_tiles(int64_t n) {
  return n > 0 ? (n + TILE - 1) / TILE : 1;
}

// ptrs: candidates (msb int64[S*B*T], lsb int64[S*B*T], node
//       int32[S*B*T], valid uint8[S*B*T]: one buffer), out msb
//       int64[S*B], lsb int64[S*B], node int32[S*B], done uint32[S]
//       (zero before the launch and after it)
// vals: S, B, m, m_t, pm, pl, pn; the query's msb, lsb, node (int32),
//       witness mask (int32), lo [B, m], hi [B, m], self msb, lsb, node
//       (int32), each its pointer and element strides (two for lo, hi);
//       then per slice its msb, lsb, node, kind, status, lo, hi, mask
//       pointers and its slot count n
ACCORD_EXPORT int accord_calc_deps(void* const* ptr, const int64_t* v,
                                   void* stream) {
  CalcParams p;
  p.S = (int)v[0];
  p.B = (int)v[1];
  p.m = (int)v[2];
  p.m_t = (int)v[3];
  p.pm = v[4];
  p.pl = v[5];
  p.pn = (int32_t)v[6];
  p.qcols = 7 + 2 * p.m;
  if (p.S < 1 || p.S > MAX_SLICES || p.B < 0 || p.m < 0 || p.m_t < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t* qv = v + 7;
  QueryRef& q = p.q;
  q.msb = (const int64_t*)qv[0];
  q.s_msb = qv[1];
  q.lsb = (const int64_t*)qv[2];
  q.s_lsb = qv[3];
  q.node = (const int32_t*)qv[4];
  q.s_node = qv[5];
  q.wit = (const int32_t*)qv[6];
  q.s_wit = qv[7];
  q.lo = (const int64_t*)qv[8];
  q.s_lo0 = qv[9];
  q.s_lo1 = qv[10];
  q.hi = (const int64_t*)qv[11];
  q.s_hi0 = qv[12];
  q.s_hi1 = qv[13];
  q.smsb = (const int64_t*)qv[14];
  q.s_smsb = qv[15];
  q.slsb = (const int64_t*)qv[16];
  q.s_slsb = qv[17];
  q.snode = (const int32_t*)qv[18];
  q.s_snode = qv[19];
  int tiles = 0, T = 1;
  for (int s = 0; s < p.S; ++s) {
    const int64_t* w = v + 27 + 9 * s;
    SliceRef& r = p.s[s];
    r.msb = (const int64_t*)w[0];
    r.lsb = (const int64_t*)w[1];
    r.node = (const int32_t*)w[2];
    r.kind = (const int32_t*)w[3];
    r.status = (const int32_t*)w[4];
    r.lo = (const int64_t*)w[5];
    r.hi = (const int64_t*)w[6];
    r.mask = (uint8_t*)w[7];
    r.n = w[8];
    const int t = (int)accord_calc_tiles(r.n);
    p.tile0[s] = tiles;
    tiles += t;
    T = maxi(T, t);
  }
  p.tile0[p.S] = tiles;
  p.T = T;
  if (p.B == 0) return (int)cudaGetLastError();
  const int per_q = query_smem(p.qcols);
  p.qc = mini(mini(QC_MAX, p.B), SMEM_BUDGET / per_q);
  if (p.qc < 1) return (int)cudaErrorInvalidValue;
  const int64_t sbt = (int64_t)p.S * p.B * T;
  p.pmsb = (int64_t*)ptr[0];
  p.plsb = p.pmsb + sbt;
  p.pnode = (int32_t*)(p.plsb + sbt);
  p.pvalid = (uint8_t*)(p.pnode + sbt);
  p.om = (int64_t*)ptr[1];
  p.ol = (int64_t*)ptr[2];
  p.on = (int32_t*)ptr[3];
  p.done = (uint32_t*)ptr[4];
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)p.qc * per_q;
  switch (p.m_t) {
    case 1: return launch_calc<1>(p, tiles, smem, st);
    case 2: return launch_calc<2>(p, tiles, smem, st);
    case 4: return launch_calc<4>(p, tiles, smem, st);
    case 8: return launch_calc<8>(p, tiles, smem, st);
    default: return launch_calc<0>(p, tiles, smem, st);
  }
}

// ptrs: msb int64, lsb int64, node int32 (element (r, c) at r*sr + c*sc),
//       out msb int64[R], lsb int64[R], node int32[R]
// vals: R, C, sr, sc
ACCORD_EXPORT int accord_ts_max(void* const* p, const int64_t* v,
                                void* stream) {
  if (v[0] > 0)
    ts_max<<<(unsigned)((v[0] * 32 + NT - 1) / NT), NT, 0,
             (cudaStream_t)stream>>>(
        (const int64_t*)p[0], (const int64_t*)p[1], (const int32_t*)p[2],
        v[0], v[1], v[2], v[3], (int64_t*)p[3], (int64_t*)p[4],
        (int32_t*)p[5]);
  return (int)cudaGetLastError();
}
