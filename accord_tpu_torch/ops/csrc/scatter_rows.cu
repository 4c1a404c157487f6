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
// Bound on this card: bytes — P rows read once from the uploaded source
// and written once.  Design: one block per (row, column), threads copy
// 8-byte words when the row is word-aligned, bytes otherwise.
#include "common.cuh"

namespace {

constexpr int MAX_COLS = 16;
constexpr int NT = 64;

struct ScatterArgs {
  char* dst[MAX_COLS];
  const char* src[MAX_COLS];
  int64_t row_bytes[MAX_COLS];
};

__global__ void __launch_bounds__(NT)
scatter_rows(ScatterArgs a, const int64_t* idx) {
  const int64_t p = blockIdx.x;
  const int c = blockIdx.y;
  const int64_t rb = a.row_bytes[c];
  char* d = a.dst[c] + idx[p] * rb;
  const char* s = a.src[c] + p * rb;
  if ((rb & 7) == 0) {
    const int64_t nw = rb >> 3;
    for (int64_t i = threadIdx.x; i < nw; i += NT)
      reinterpret_cast<int64_t*>(d)[i] =
          reinterpret_cast<const int64_t*>(s)[i];
  } else {
    for (int64_t i = threadIdx.x; i < rb; i += NT) d[i] = s[i];
  }
}

}  // namespace

// ptrs: idx (int64[P]), then per column: dst, src
// vals: n_cols, P, then per column: row_bytes
ACCORD_EXPORT int accord_scatter_rows(void* const* p, const int64_t* v,
                                      void* stream) {
  const int n = (int)v[0];
  const int64_t P = v[1];
  if (n < 1 || n > MAX_COLS) return (int)cudaErrorInvalidValue;
  ScatterArgs a;
  for (int c = 0; c < n; ++c) {
    a.dst[c] = (char*)p[1 + 2 * c];
    a.src[c] = (const char*)p[2 + 2 * c];
    a.row_bytes[c] = v[2 + c];
  }
  if (P > 0)
    scatter_rows<<<dim3((unsigned)P, (unsigned)n), NT, 0,
                   (cudaStream_t)stream>>>(a, (const int64_t*)p[0]);
  return (int)cudaGetLastError();
}

// the runtime's message for a code returned by any entry point
ACCORD_EXPORT const char* accord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
