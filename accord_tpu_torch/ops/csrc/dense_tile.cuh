// The dense route's per-(query row, slot) predicate, its mask-word cut and
// the CSR row lookups, shared by K1b (deps_scan.cu), K2 (attr_post.cu) and
// K5 (fused_scan.cu).
//
// The predicate is the reference's dense mask (accord_tpu/ops/
// deps_kernel.py:174 _dep_mask_and_conflict): a live, not invalidated
// slot whose kind the row witnesses, strictly earlier than the row's
// bound, not the row's own id, not below the batch prune floor, and with
// at least one (query interval, slot interval) pair that overlaps.  Its
// triple count is the number of such overlapping pairs (the reference's
// _triple_codes expansion, :343).  The order of the tests is the cost
// order: per slot (status, floor), then per row the scalar tests, then
// two exact filters before the m x m_t interval pairs:
//   - the slot's span (the least lo and the largest hi over its m_t
//     columns) against the row's span: a pair (qi, c) overlaps only if
//     qlo[qi] <= hi[c] <= span_hi and span_lo <= lo[c] <= qhi[qi], so a
//     row whose every interval misses the slot's span has no pair;
//   - the same per query interval, before its m_t pairs.
// Both compare the reference's own int64 words, pads included (PAD_LO =
// INT64_MAX, PAD_HI = INT64_MIN never raise a span), so they only skip
// pairs that cannot overlap.
#pragma once

#include "common.cuh"

namespace dense_tile {

// slot intervals a thread holds in registers; a table wider than this
// reads its intervals through L1 instead
constexpr int MT_REG = 8;

// one query row's scalars, staged in shared memory (qmat row layout:
// bound msb, lsb, node, witness mask, self msb, lsb, node, lo[m], hi[m])
struct Row {
  int64_t bm, bl, sm, sl;
  int64_t span_lo, span_hi;   // least lo, largest hi over the m intervals
  int32_t bn, wit, sn, pad_;
};

__device__ __forceinline__ Row load_row(const int64_t* q, int m) {
  Row r;
  r.bm = q[0];
  r.bl = q[1];
  r.bn = (int32_t)q[2];
  r.wit = (int32_t)q[3];
  r.sm = q[4];
  r.sl = q[5];
  r.sn = (int32_t)q[6];
  int64_t lo = INT64_MAX, hi = INT64_MIN;
  for (int i = 0; i < m; ++i) {
    lo = min64(lo, q[7 + i]);
    hi = max64(hi, q[7 + m + i]);
  }
  r.span_lo = lo;
  r.span_hi = hi;
  r.pad_ = 0;
  return r;
}

// one slot in registers: its id, kind, whether it is live and above the
// prune floor, its span and (up to MT) its intervals; the register
// columns past m_t are never counted (a query interval [INT64_MIN,
// INT64_MAX] would overlap any filler)
template <int MT>
struct Slot {
  int64_t msb, lsb, span_lo, span_hi;
  int64_t lo[MT > 0 ? MT : 1], hi[MT > 0 ? MT : 1];
  const int64_t *glo, *ghi;   // the slot's row of the table's lo / hi
  int32_t node, kind;
  bool ok;
};

struct Table {
  const int64_t *msb, *lsb, *lo, *hi;
  const int32_t *node, *kind, *status;
  int64_t pm, pl;
  int32_t pn;
  int N, m_t;
};

template <int MT>
__device__ __forceinline__ Slot<MT> load_slot(const Table& t, int64_t j) {
  Slot<MT> s;
  s.ok = false;
  s.span_lo = INT64_MAX;
  s.span_hi = INT64_MIN;
  s.glo = t.lo + j * t.m_t;
  s.ghi = t.hi + j * t.m_t;
  if (j >= t.N) return s;
  const int32_t st = t.status[j];
  s.msb = t.msb[j];
  s.lsb = t.lsb[j];
  s.node = t.node[j];
  s.kind = t.kind[j];
  s.ok = st >= 0 && st != SLOT_INVALIDATED &&
         !ts_lt(s.msb, s.lsb, s.node, t.pm, t.pl, t.pn);
  if (!s.ok) return s;
  if (MT > 0) {
#pragma unroll
    for (int c = 0; c < (MT > 0 ? MT : 1); ++c) {
      s.lo[c] = c < t.m_t ? s.glo[c] : INT64_MAX;
      s.hi[c] = c < t.m_t ? s.ghi[c] : INT64_MIN;
      s.span_lo = min64(s.span_lo, s.lo[c]);
      s.span_hi = max64(s.span_hi, s.hi[c]);
    }
  } else {
    for (int c = 0; c < t.m_t; ++c) {
      s.span_lo = min64(s.span_lo, s.glo[c]);
      s.span_hi = max64(s.span_hi, s.ghi[c]);
    }
  }
  return s;
}

// the row-dependent scalar tests: witnessed kind, strictly earlier than
// the bound, not the row itself
template <int MT>
__device__ __forceinline__ bool row_admits(const Row& r, const Slot<MT>& s) {
  return s.ok && ((r.wit >> s.kind) & 1) &&
         ts_lt(s.msb, s.lsb, s.node, r.bm, r.bl, r.bn) &&
         !ts_eq(s.msb, s.lsb, s.node, r.sm, r.sl, r.sn);
}

// overlapping (query interval, slot interval) pairs; qlo / qhi are the
// row's m intervals (shared or global memory)
template <int MT>
__device__ __forceinline__ int pair_count(const Row& r, const Slot<MT>& s,
                                          const int64_t* qlo,
                                          const int64_t* qhi, int m,
                                          int m_t) {
  if (!(r.span_lo <= s.span_hi && s.span_lo <= r.span_hi)) return 0;
  int n = 0;
  for (int qi = 0; qi < m; ++qi) {
    const int64_t ql = qlo[qi], qh = qhi[qi];
    if (!(ql <= s.span_hi && s.span_lo <= qh)) continue;
    if (MT > 0) {
#pragma unroll
      for (int c = 0; c < (MT > 0 ? MT : 1); ++c)
        n += (c < m_t) & (ql <= s.hi[c]) & (s.lo[c] <= qh);
    } else {
      for (int c = 0; c < m_t; ++c)
        n += (ql <= s.ghi[c]) & (s.glo[c] <= qh);
    }
  }
  return n;
}

// does pair p = c * m + qi (slot column c, query interval qi) overlap: q
// is the query's qmat row, lo / hi the slot's table row, p < m_t * m
__device__ __forceinline__ bool pair_hit(const int64_t* q, int m,
                                         const int64_t* lo,
                                         const int64_t* hi, int p) {
  const int c = p / m, qi = p - c * m;
  return q[7 + qi] <= hi[c] && lo[c] <= q[7 + m + qi];
}

// the n lowest set bits of x (the kp cut inside a mask word)
__device__ __forceinline__ unsigned low_set_bits(unsigned x, int n) {
  unsigned r = 0;
  for (; n > 0 && x; --n) {
    const unsigned b = x & (0u - x);
    r |= b;
    x ^= b;
  }
  return r;
}

// The CSR row of position pos: the reference's min(searchsorted(row_end,
// pos, side="right"), B - 1), with row_end staged in shared memory by the
// caller where it fits.
__device__ __forceinline__ int64_t row_of(const int32_t* row_end, int64_t B,
                                          int64_t pos) {
  return min64(upper_bound(row_end, B, pos), B - 1);
}

// Python floor division by b > 0, in the codes' own width
template <typename T>
__device__ __forceinline__ T fdiv(T a, T b) {
  const T q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// first index i in [0, n) with x[i] >= v, else n
__device__ __forceinline__ int64_t first_at_least(const int32_t* x, int64_t n,
                                                  int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The attribution's new row ends (header int32[5+B]: hdr[5 + b], and
// hdr[0] for the last row) for the rows b whose X(b) = min(row_end[b],
// live_end) (live_end for the last row) lies in [p0, p1): ``kb`` kept
// entries lie below p0 and ``word`` holds the keep flags from p0 on, so
// row b ends at row_end[b] - (X(b) - kept(X(b))).
__device__ __forceinline__ void row_ends_in(int32_t* hdr, int64_t B,
                                           const int32_t* re, int64_t p0,
                                           int64_t p1, int64_t live_end,
                                           long long kb, unsigned word) {
  if (p0 > live_end) return;
  const int64_t last = B - 1;
  for (int64_t b = first_at_least(re, last, p0); b <= last; ++b) {
    const int64_t x = b == last ? live_end : min64(re[b], live_end);
    if (x >= p1) break;
    const long long kept = kb + __popc(word & ((1u << (x - p0)) - 1u));
    const int32_t ne = (int32_t)((long long)re[b] - (x - kept));
    hdr[5 + b] = ne;
    if (b == last) hdr[0] = ne;
  }
}

}  // namespace dense_tile
