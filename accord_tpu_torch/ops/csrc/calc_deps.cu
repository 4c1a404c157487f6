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
// lexicographic, zeros when there is none.
//
// Bound on this card: bytes — the [B, N] mask is written once; the table
// (N x (28 + 16 m_t) bytes) is read once per query row but stays in L2 for
// the 256-slot tile a block scans.  Design: grid (slot tiles, B, slices);
// one thread per (query, slot) evaluates the overlap and predicates, writes
// its mask byte (coalesced along the slot axis), and the block reduces its
// conflicts' maximum by warp shuffles into a per-tile candidate; ts_max
// then reduces the tiles of each (slice, query), one block per row.
#include "common.cuh"

namespace {

constexpr int NT = 256;

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

// block-wide max; thread 0 gets the result
template <int BT>
__device__ Ts block_max(Ts t) {
  __shared__ Ts part[BT / 32];
  for (int o = 16; o > 0; o >>= 1) {
    const Ts u = shfl_ts(t, o);
    if (ts_gt(u, t)) t = u;
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) part[wid] = t;
  __syncthreads();
  if (wid == 0) {
    t = lane < BT / 32 ? part[lane] : Ts{0, 0, 0, 0};
    for (int o = 16; o > 0; o >>= 1) {
      const Ts u = shfl_ts(t, o);
      if (ts_gt(u, t)) t = u;
    }
  }
  return t;
}

__global__ void __launch_bounds__(NT)
calc_deps(const SliceRef* refs, const int64_t* qmat, int qcols, int m,
          int m_t, int64_t pm, int64_t pl, int32_t pn, int64_t nblk, int B,
          int64_t* pmsb, int64_t* plsb, int32_t* pnode, uint8_t* pvalid) {
  const SliceRef r = refs[blockIdx.z];
  const int b = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * NT + threadIdx.x;
  Ts best{0, 0, 0, 0};
  if (j < r.n) {
    const int64_t* q = qmat + (int64_t)b * qcols;
    const int32_t st = r.status[j];
    bool ov = false;
    for (int a = 0; a < m_t && !ov; ++a) {
      const int64_t tlo = r.lo[j * m_t + a], thi = r.hi[j * m_t + a];
      for (int c = 0; c < m && !ov; ++c)
        ov = q[7 + c] <= thi && tlo <= q[7 + m + c];
    }
    const bool conflict = ov && st >= SLOT_TRANSITIVE && st != SLOT_INVALIDATED;
    const int64_t em = r.msb[j], el = r.lsb[j];
    const int32_t en = r.node[j];
    bool dep = false;
    if (conflict) {
      dep = ((q[3] >> r.kind[j]) & 1) &&
            ts_lt(em, el, en, q[0], q[1], (int32_t)q[2]) &&
            !ts_eq(em, el, en, q[4], q[5], (int32_t)q[6]) &&
            !ts_lt(em, el, en, pm, pl, pn);
      best = Ts{(unsigned long long)em, (unsigned long long)el, en, 1};
    }
    r.mask[(int64_t)b * r.n + j] = dep;
  }
  best = block_max<NT>(best);
  if (threadIdx.x == 0) {
    const int64_t o = ((int64_t)blockIdx.z * B + b) * nblk + blockIdx.x;
    pmsb[o] = (int64_t)best.m;
    plsb[o] = (int64_t)best.l;
    pnode[o] = best.n;
    pvalid[o] = (uint8_t)best.valid;
  }
}

// out[r] = max over c of element (r, c) at r * sr + c * sc, among those
// whose valid byte is set (valid null: any field non-zero); zeros if none
__global__ void __launch_bounds__(NT)
ts_max(const int64_t* msb, const int64_t* lsb, const int32_t* node,
       const uint8_t* valid, int64_t C, int64_t sr, int64_t sc,
       int64_t* om, int64_t* ol, int32_t* on) {
  const int64_t row = blockIdx.x;
  Ts best{0, 0, 0, 0};
  for (int64_t c = threadIdx.x; c < C; c += NT) {
    const int64_t e = row * sr + c * sc;
    const bool ok = valid ? valid[e] != 0
                          : (msb[e] != 0 || lsb[e] != 0 || node[e] != 0);
    const Ts t{(unsigned long long)msb[e], (unsigned long long)lsb[e],
               node[e], ok ? 1 : 0};
    if (ts_gt(t, best)) best = t;
  }
  best = block_max<NT>(best);
  if (threadIdx.x == 0) {
    om[row] = best.valid ? (int64_t)best.m : 0;
    ol[row] = best.valid ? (int64_t)best.l : 0;
    on[row] = best.valid ? best.n : 0;
  }
}

}  // namespace

// ptrs: refs SliceRef[S], qmat int64[B*qcols], partial msb int64[S*B*nblk],
//       lsb, node int32, valid uint8 (same shape), out msb int64[S*B],
//       lsb, node int32[S*B]
// vals: S, B, qcols, m, m_t, n_max, pm, pl, pn
ACCORD_EXPORT int accord_calc_deps(void* const* p, const int64_t* v,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t S = v[0], B = v[1], n_max = v[5];
  const int64_t nblk = (n_max + NT - 1) / NT;
  if (S <= 0 || B <= 0) return (int)cudaGetLastError();
  if (nblk > 0)
    calc_deps<<<dim3((unsigned)nblk, (unsigned)B, (unsigned)S), NT, 0, st>>>(
        (const SliceRef*)p[0], (const int64_t*)p[1], (int)v[2], (int)v[3],
        (int)v[4], v[6], v[7], (int32_t)v[8], nblk, (int)B, (int64_t*)p[2],
        (int64_t*)p[3], (int32_t*)p[4], (uint8_t*)p[5]);
  ts_max<<<(unsigned)(S * B), NT, 0, st>>>(
      (const int64_t*)p[2], (const int64_t*)p[3], (const int32_t*)p[4],
      (const uint8_t*)p[5], nblk, nblk, 1, (int64_t*)p[6], (int64_t*)p[7],
      (int32_t*)p[8]);
  return (int)cudaGetLastError();
}

// ptrs: msb int64, lsb int64, node int32 (element (r, c) at r*sr + c*sc),
//       out msb int64[R], lsb int64[R], node int32[R]
// vals: R, C, sr, sc
ACCORD_EXPORT int accord_ts_max(void* const* p, const int64_t* v,
                                void* stream) {
  if (v[0] > 0)
    ts_max<<<(unsigned)v[0], NT, 0, (cudaStream_t)stream>>>(
        (const int64_t*)p[0], (const int64_t*)p[1], (const int32_t*)p[2],
        nullptr, v[1], v[2], v[3], (int64_t*)p[3], (int64_t*)p[4],
        (int32_t*)p[5]);
  return (int)cudaGetLastError();
}
