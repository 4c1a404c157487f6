// K3: dirty-row set of several columns at once, in place.
//
// Replaces (JAX reference): scatter_table_rows (accord_tpu/ops/
// deps_kernel.py:156, 7 columns), scatter_attr_cols (:839, 9 columns),
// _scatter_bucket_rows (accord_tpu/local/device_index.py:226, 8 bucket
// columns) and _scatter_drain_scalars (device_index.py:1084, 4 columns).
// For every column c and dirty row p: dst_c[idx[p]] = src_c[p], a row being
// row_bytes_c bytes (int64/int32/bool scalars or whole interval rows).
// Pad rows repeat the last row with identical bytes, so concurrent writes
// to one destination row agree.  JAX's scatter is functional; this one
// writes in place, and the mirror that owns the columns copies them first
// while a launched query can still re-read them (copy on write).
//
// Bound on this card: bytes — P rows read once and written once, plus the
// index.  Most calls are small (the burn's are P = 8 rows of a few
// columns), so what a call costs is its fixed part: the launch, and on the
// live path the upload.  Design: the wrapper packs idx and every column's
// source rows from the host into one staging buffer (one copy a call) and
// passes their addresses; the columns travel by value in a
// __grid_constant__ parameter, with the prefix sums of their (row, chunk)
// work items.  One launch over a fixed grid (at most 4 CTAs an SM) strides
// over the items, 4 a thread a step with their loads issued before their
// stores: item u is column c (the first prefix above u), row p and chunk k
// of the row; a chunk is 16 bytes where the row bytes and both bases allow
// it, else 8, 4, 2 or 1 (bool rows, rows not a multiple of 16 bytes).
// The lanes of a warp that share a row read idx[p] in one transaction.
#include "common.cuh"

namespace {

constexpr int MAX_COLS = ACCORD_SCATTER_MAX_COLS;  // ops/_build.py
constexpr int NT = 256;
constexpr int CTAS_PER_SM = 4;
constexpr int U = 4;             // items a thread a step

struct ScatterParams {
  char* dst[MAX_COLS];
  const char* src[MAX_COLS];
  int64_t row_bytes[MAX_COLS];
  int64_t end[MAX_COLS];     // items of columns 0..c (P * chunks a row)
  int32_t shift[MAX_COLS];   // log2 of the column's chunk bytes
  int32_t rshift[MAX_COLS];  // log2 of its chunks a row (-1: not a power)
  const int64_t* idx;        // [P]
  int32_t n;                 // columns
};

// chunk of 2^sh bytes at s, into v (the low bytes)
__device__ __forceinline__ void load_chunk(const char* s, int sh, uint4& v) {
  switch (sh) {
    case 4: v = *reinterpret_cast<const uint4*>(s); break;
    case 3: {
      const uint2 x = *reinterpret_cast<const uint2*>(s);
      v.x = x.x;
      v.y = x.y;
      break;
    }
    case 2: v.x = *reinterpret_cast<const uint32_t*>(s); break;
    case 1: v.x = *reinterpret_cast<const uint16_t*>(s); break;
    default: v.x = *reinterpret_cast<const uint8_t*>(s); break;
  }
}

__device__ __forceinline__ void store_chunk(char* d, int sh, const uint4& v) {
  switch (sh) {
    case 4: *reinterpret_cast<uint4*>(d) = v; break;
    case 3: *reinterpret_cast<uint2*>(d) = make_uint2(v.x, v.y); break;
    case 2: *reinterpret_cast<uint32_t*>(d) = v.x; break;
    case 1: *reinterpret_cast<uint16_t*>(d) = (uint16_t)v.x; break;
    default: *reinterpret_cast<uint8_t*>(d) = (uint8_t)v.x; break;
  }
}

// each thread moves U items a step, their loads issued before their stores
__global__ void __launch_bounds__(NT)
scatter_rows(const __grid_constant__ ScatterParams a) {
  const int64_t total = a.end[a.n - 1];
  const int64_t stride = (int64_t)gridDim.x * NT * U;
  for (int64_t u0 = (int64_t)blockIdx.x * NT * U + threadIdx.x; u0 < total;
       u0 += stride) {
    char* d[U];
    int sh[U];
    uint4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t u = u0 + (int64_t)k * NT;
      sh[k] = -1;
      if (u >= total) continue;
      int c = 0;
      while (u >= a.end[c]) ++c;
      sh[k] = a.shift[c];
      const int64_t rb = a.row_bytes[c];
      const int64_t chunks = rb >> sh[k];
      const int64_t r = u - (c ? a.end[c - 1] : 0);
      // rows of a power of two chunks (nearly every column) shift
      const int rs = a.rshift[c];
      const int64_t p = rs >= 0 ? r >> rs : r / chunks;
      const int64_t off = (r - p * chunks) << sh[k];
      d[k] = a.dst[c] + a.idx[p] * rb + off;
      load_chunk(a.src[c] + p * rb + off, sh[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (sh[k] >= 0) store_chunk(d[k], sh[k], v[k]);
  }
}

// the widest chunk (log2 bytes, at most 16) that divides the row bytes and
// both bases
int chunk_shift(int64_t rb, const void* dst, const void* src) {
  const uint64_t bits =
      (uint64_t)rb | (uint64_t)(uintptr_t)dst | (uint64_t)(uintptr_t)src;
  int sh = 0;
  while (sh < 4 && !(bits & (1ull << sh))) ++sh;
  return sh;
}

}  // namespace

// ptrs: idx (int64[P]), then per column: dst, src (P rows)
// vals: n_cols, P, then per column: row_bytes
// Returns cudaErrorInvalidValue for a column count outside 1..MAX_COLS, a
// negative P or a row of no bytes.
ACCORD_EXPORT int accord_scatter_rows(void* const* p, const int64_t* v,
                                      void* stream) {
  const int n = (int)v[0];
  const int64_t P = v[1];
  if (n < 1 || n > MAX_COLS || P < 0) return (int)cudaErrorInvalidValue;
  ScatterParams a;
  a.idx = (const int64_t*)p[0];
  a.n = n;
  int64_t items = 0;
  for (int c = 0; c < n; ++c) {
    a.dst[c] = (char*)p[1 + 2 * c];
    a.src[c] = (const char*)p[2 + 2 * c];
    a.row_bytes[c] = v[2 + c];
    if (a.row_bytes[c] <= 0) return (int)cudaErrorInvalidValue;
    a.shift[c] = chunk_shift(a.row_bytes[c], a.dst[c], a.src[c]);
    const int64_t chunks = a.row_bytes[c] >> a.shift[c];
    a.rshift[c] = -1;
    for (int l = 0; l < 62; ++l)
      if (chunks == (int64_t)1 << l) a.rshift[c] = l;
    items += P * chunks;
    a.end[c] = items;
  }
  if (items > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int64_t want = (items + NT * U - 1) / (NT * U);
    const int64_t cap = (int64_t)sms * CTAS_PER_SM;
    scatter_rows<<<(unsigned)(want < cap ? want : cap), NT, 0,
                   (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// the runtime's message for a code returned by any entry point
ACCORD_EXPORT const char* accord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
