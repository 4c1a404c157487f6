// Shared device helpers for the accord_tpu_torch kernels (sm_90a).
//
// Every entry point has the same plain C signature,
//     int fn(void* const* ptrs, const int64_t* vals, void* stream)
// so the Python side binds all of them with one ctypes argtypes list:
// ``ptrs`` holds the tensor data pointers and ``vals`` the integer
// parameters, both in the order each entry point documents.  The entry
// point enqueues its kernels on ``stream``, never synchronises, allocates
// nothing, and returns cudaGetLastError() so a refused launch surfaces in
// the wrapper.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#define ACCORD_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int SLOT_FREE = -1;
constexpr int SLOT_TRANSITIVE = 0;
constexpr int SLOT_COMMITTED = 3;
constexpr int SLOT_STABLE = 4;
constexpr int SLOT_APPLIED = 5;
constexpr int SLOT_INVALIDATED = 6;

// 128-bit timestamp order: msb and lsb compared unsigned, then the node id
// signed (the reference flips the sign bit of int64 words; comparing the
// words as unsigned long long is the same order)
__device__ __forceinline__ bool ts_lt(int64_t am, int64_t al, int32_t an,
                                      int64_t bm, int64_t bl, int32_t bn) {
  const unsigned long long uam = (unsigned long long)am;
  const unsigned long long ubm = (unsigned long long)bm;
  const unsigned long long ual = (unsigned long long)al;
  const unsigned long long ubl = (unsigned long long)bl;
  return uam < ubm || (uam == ubm && (ual < ubl || (ual == ubl && an < bn)));
}

__device__ __forceinline__ bool ts_eq(int64_t am, int64_t al, int32_t an,
                                      int64_t bm, int64_t bl, int32_t bn) {
  return am == bm && al == bl && an == bn;
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__host__ __device__ __forceinline__ int mini(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int maxi(int a, int b) {
  return a > b ? a : b;
}

// Python-style floor division / modulo (the reference's ``//`` and ``%``)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t floormod(int64_t a, int64_t b) {
  return a - floordiv(a, b) * b;
}

// searchsorted(side="left"): first index with x[i] >= v
__device__ __forceinline__ int64_t lower_bound(const int64_t* x, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// searchsorted(side="right"): first index with x[i] > v
template <typename X>
__device__ __forceinline__ int64_t upper_bound(const X* x, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Block-wide exclusive prefix sum of one value per thread; every thread of
// the block must call it.  ``*total`` receives the block sum.
template <int NT, typename V>
__device__ V block_exclusive_scan(V v, V* total) {
  static_assert(NT % 32 == 0 && NT <= 1024, "block size");
  __shared__ V warp_sums[NT / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  V x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    V w = lane < NT / 32 ? warp_sums[lane] : V(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const V prefix = wid ? warp_sums[wid - 1] : V(0);
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return prefix + x - v;
}

// In-place ascending bitonic sort of buf[0:n), n a power of two, by one
// block (buf in shared or global memory).
template <int NT, typename T>
__device__ void block_bitonic_sort(T* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += NT) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const T a = buf[lo];
        const T b = buf[hi];
        if ((a > b) == asc) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// does dep j ever gate row i's execution (the static blocking relation of
// the reference's blocking_matrix / _ell_blocking; applied deps included)
__device__ __forceinline__ bool drain_gates(const int32_t* status,
                                            const int64_t* emsb,
                                            const int64_t* elsb,
                                            const int32_t* enode,
                                            const uint8_t* awaits, int64_t i,
                                            int64_t j) {
  const int32_t sj = status[j];
  if (sj == SLOT_INVALIDATED || sj == SLOT_FREE) return false;
  const bool undecided = sj >= 0 && sj < SLOT_COMMITTED;
  return undecided || awaits[i] ||
         ts_lt(emsb[j], elsb[j], enode[j], emsb[i], elsb[i], enode[i]);
}

// the set (non-zero) bytes of a 16-byte chunk as a 16-bit mask, byte k
// at bit k
__device__ __forceinline__ uint32_t set_bytes(const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t t = w[q] | (w[q] >> 4);
    t |= t >> 2;
    t |= t >> 1;
    t &= 0x01010101u;          // bit 0 of each byte: the byte is set
    bits |= ((t * 0x01020408u) >> 24) << (4 * q);   // gather to 4 bits
  }
  return bits;
}

// The walk of one row of a bool [N, N] matrix by a warp (K4b, K6 and K7
// dense): each lane reads an aligned 16-byte chunk a step, so a warp
// covers 512 bytes; the chunks are counted from the 16-byte boundary at
// or below the matrix's start and the bytes outside the row are masked
// (a row of N bytes need not start on a chunk); the next step's chunk is
// loaded before this step's is used.  The constructor issues the first
// loads, so a caller reads the row's own fields behind them.
struct RowWalk {
  const uint4* chunks;
  int64_t r0, r1;   // the row's bytes, counted from ``chunks``
  int64_t base;     // the chunk lane 0 reads this step
  int64_t c1;       // the chunk past the row
  int lane;
  uint4 v, vn;      // this step's chunk, the next step's

  __device__ __forceinline__ RowWalk(const uint8_t* adj, int64_t n,
                                     int64_t i, int lane_)
      : lane(lane_) {
    chunks = (const uint4*)((uintptr_t)adj & ~(uintptr_t)15);
    r0 = (int64_t)((uintptr_t)adj & 15) + i * n;
    r1 = r0 + n;
    c1 = (r1 + 15) >> 4;
    base = r0 >> 4;
    v = load(base + lane);
    vn = load(base + lane + 32);
  }
  __device__ __forceinline__ uint4 load(int64_t c) const {
    return c < c1 ? __ldg(chunks + c) : make_uint4(0, 0, 0, 0);
  }
  // this lane's set bytes of the row this step (byte k of its chunk at
  // bit k), and in ``col0`` the column of bit 0
  __device__ __forceinline__ uint32_t bits(int64_t& col0) const {
    const int64_t c = base + lane;
    if (c >= c1) return 0;
    const int64_t p = c << 4;
    const int lo = (int)max64(r0 - p, 0), hi = (int)min64(r1 - p, 16);
    col0 = p - r0;
    return set_bytes(v) & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
  }
  // on to the next step: false once the row is read (in every lane)
  __device__ __forceinline__ bool next() {
    base += 32;
    if (base >= c1) return false;
    v = vn;
    vn = load(base + lane + 32);
    return true;
  }
};

// One cooperative launch of ``kernel(args)`` with ``nt`` threads and
// ``smem`` bytes of dynamic shared memory a block: ``want`` blocks, at most
// as many as fit on the card at once (grid.sync() needs every block
// resident), at least one.  The resident limit of a (kernel, device, block
// size) is asked of the runtime once and kept, so a kernel is always
// launched with the same ``smem`` (above 48 KB it is opted into first).
// Returns a cudaError_t.
template <typename Args>
inline int launch_cooperative(void (*kernel)(Args), int nt, int64_t want,
                              Args& args, cudaStream_t st, size_t smem = 0) {
  struct Cap {
    const void* kernel;
    int dev, nt;
    int64_t blocks;
  };
  static Cap caps[16];
  static int n_caps = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int64_t cap = 0;
  {
    std::lock_guard<std::mutex> g(mu);
    for (int i = 0; i < n_caps; ++i)
      if (caps[i].kernel == (const void*)kernel && caps[i].dev == dev &&
          caps[i].nt == nt)
        cap = caps[i].blocks;
  }
  if (cap == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                        smem);
    if (e != cudaSuccess) return (int)e;
    cap = (int64_t)sms * per_sm;
    if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    std::lock_guard<std::mutex> g(mu);
    if (n_caps < 16) caps[n_caps++] = Cap{(const void*)kernel, dev, nt, cap};
  }
  if (want < 1) want = 1;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(nt),
                                  argv, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
