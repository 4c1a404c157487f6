// K9: the log-depth drains' device work beside the level pass (K7).
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   level_drain <- _levels_to_drain (:427) and the depth reduction of
//                  _drain_ell_logdepth_full (:434) /
//                  _drain_dense_logdepth_full (:451); with a watermark, the
//                  prefix of drain_ell_watermark (:465) /
//                  drain_dense_watermark (:479)
//   logsq_dense <- drain_dense_logsq (:489)
//
// level_drain: applied = applied0 | (stable & lv <= w) (w = LEVEL_INF - 1
// for "lv < INF"; the watermark from a device scalar or a value), newly =
// applied & ~applied0, depth = the largest finite level (0 if none).  A
// thread per row, a warp max and one atomicMax.  Bound: bytes (status and
// levels read once, the two flags written once).
//
// logsq_dense: a Stable row is blocked forever iff it reaches, along
// blocking edges into Stable deps, a dep that never applies (``hit``) or a
// cycle.  The step relation s is squared, s <- s | s.s, until it stops
// changing (``squarings`` counts the final unchanged pass); then
// on_cycle = diag(s), targets = hit | on_cycle, and blocked = targets |
// (s . targets).  The reference multiplies 0/1 matrices in bf16 and
// tests > 0.5: a count >= 1 never rounds below 0.5, so that IS boolean
// "any", and here it is exact bit arithmetic: s is kept bit-packed twice,
// by rows (word v of row i: columns 32v..32v+31) and by columns (row j of
// the column packing is column j of s), and s.s[i][j] is the OR over v of
// rows[i][v] & cols[j][v].
// Design: one cooperative launch per call.  A squaring walks 32-row x
// 128-column output tiles (a block of 4 warps; a lane owns one column),
// staging 64-word k-chunks of the 32 rows and the 128 columns in shared
// memory (rows padded to 65 words: conflict-free); a lane accumulates its
// column's 32 output bits in one register, writes them as a column word,
// and 32 warp ballots turn them into the tile's row words.  Both packings
// ping-pong between two buffers; grid.sync() ends a squaring and a
// "changed" flag in three rotating words ends the loop on the device.
// Bound on this card: operations — squarings x N^2 x ceil(N/32) word
// AND/ORs (no tensor-core form here; a b1/int8 mma design is later work).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int32_t LEVEL_INF = 1 << 28;

// -- the level-drain epilogue ----------------------------------------------

constexpr int EPI_NT = 256;

__global__ void __launch_bounds__(EPI_NT)
level_drain_kernel(const int32_t* status, const int32_t* lv,
                   const int64_t* wptr, int64_t wval, uint8_t* applied,
                   uint8_t* newly, int32_t* depth, int64_t N) {
  const int64_t w = wptr ? *wptr : wval;
  int32_t best = 0;
  for (int64_t i = (int64_t)blockIdx.x * EPI_NT + threadIdx.x; i < N;
       i += (int64_t)gridDim.x * EPI_NT) {
    const int32_t l = lv[i];
    const int32_t s = status[i];
    const bool a0 = s == SLOT_APPLIED;
    const bool ap = a0 || (s == SLOT_STABLE && (int64_t)l <= w);
    applied[i] = ap;
    newly[i] = ap && !a0;
    if (l < LEVEL_INF) best = maxi(best, l);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = maxi(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(depth, best);
}

// -- log-squaring ------------------------------------------------------------

constexpr int NT = 128;   // 4 warps: one 32-row tile x 4 32-column tiles
constexpr int TJ = NT;    // output columns per block tile, one per lane
constexpr int KC = 64;    // k-words per shared-memory chunk
constexpr int KP = KC + 1;

struct LogsqArgs {
  const uint8_t* adj;   // bool[N*N]
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  uint32_t* rows[2];    // [NR*W] s by rows, ping-pong
  uint32_t* cols[2];    // [NR*W] s by columns, ping-pong
  uint32_t* tgt;        // [W] packed targets, zeroed before the launch
  uint8_t* hit;         // [N], zeroed before the launch
  int32_t* flags;       // [3]
  uint8_t *applied, *newly;
  int32_t* squarings;
  int64_t N, W, NR;
};

__device__ __forceinline__ bool bit(const uint32_t* words, int64_t k) {
  return (words[k >> 5] >> (k & 31)) & 1;
}

__global__ void __launch_bounds__(NT) logsq_kernel(LogsqArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint32_t s_rows[32 * KP];
  __shared__ uint32_t s_cols[TJ * KP];
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  const int lane = threadIdx.x & 31;
  const int64_t N = a.N, W = a.W, NR = a.NR;

  // the step relation by rows (edges into Stable deps) and ``hit`` (an
  // edge into a dep that is neither Stable nor Applied); rows past N are 0
  for (int64_t t = tid; t < NR * W; t += nthreads) {
    const int64_t i = t / W, j0 = (t % W) * 32;
    uint32_t word = 0;
    bool hit = false;
    if (i < N) {
      const int64_t nb = min64(32, N - j0);
      for (int64_t b = 0; b < nb; ++b) {
        const int64_t j = j0 + b;
        if (!a.adj[i * N + j] ||
            !drain_gates(a.status, a.emsb, a.elsb, a.enode, a.awaits, i, j))
          continue;
        const int32_t sj = a.status[j];
        if (sj == SLOT_STABLE) word |= 1u << b;
        else if (sj != SLOT_APPLIED) hit = true;
      }
    }
    a.rows[0][t] = word;
    if (hit) a.hit[i] = 1;
  }
  if (tid == 0) a.flags[0] = a.flags[1] = a.flags[2] = 0;
  grid.sync();
  // ... and by columns: bit b of word v of column j is s[32v + b][j]
  for (int64_t t = tid; t < NR * W; t += nthreads) {
    const int64_t j = t / W, i0 = (t % W) * 32;
    uint32_t word = 0;
    for (int b = 0; j < N && b < 32; ++b)
      if (bit(a.rows[0] + (i0 + b) * W, j)) word |= 1u << b;
    a.cols[0][t] = word;
  }
  grid.sync();

  const int64_t n_jt = NR / TJ;
  int64_t r = 0;
  bool more = true;
  while (more) {
    const uint32_t* rc = a.rows[r & 1];
    const uint32_t* cc = a.cols[r & 1];
    uint32_t* rn = a.rows[(r & 1) ^ 1];
    uint32_t* cn = a.cols[(r & 1) ^ 1];
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    bool mine = false;
    for (int64_t tile = blockIdx.x; tile < W * n_jt; tile += gridDim.x) {
      const int64_t it = tile / n_jt;
      const int64_t i0 = it * 32, j0 = (tile % n_jt) * TJ;
      uint32_t acc = 0;   // bit k: s.s[i0 + k][j0 + threadIdx.x]
      for (int64_t v0 = 0; v0 < W; v0 += KC) {
        const int kc = (int)min64(KC, W - v0);
        __syncthreads();   // the previous chunk's readers are done
        for (int e = threadIdx.x; e < 32 * kc; e += NT)
          s_rows[(e / kc) * KP + e % kc] = rc[(i0 + e / kc) * W + v0 + e % kc];
        for (int e = threadIdx.x; e < TJ * kc; e += NT)
          s_cols[(e / kc) * KP + e % kc] = cc[(j0 + e / kc) * W + v0 + e % kc];
        __syncthreads();
        const uint32_t* col = s_cols + threadIdx.x * KP;
        for (int k = 0; k < 32; ++k) {
          const uint32_t* row = s_rows + k * KP;
          uint32_t x = 0;
          for (int c = 0; c < kc; ++c) x |= row[c] & col[c];
          if (x) acc |= 1u << k;
        }
      }
      // column word: rows i0..i0+31 of this lane's column j
      const int64_t j = j0 + threadIdx.x;
      const uint32_t cnew = cc[j * W + it] | acc;
      cn[j * W + it] = cnew;
      // row words: lane k collects row i0 + k over this warp's 32 columns
      uint32_t rword = 0;
      for (int k = 0; k < 32; ++k) {
        const uint32_t w = __ballot_sync(0xffffffffu, (cnew >> k) & 1);
        if (lane == k) rword = w;
      }
      const int64_t jw = (j0 >> 5) + (threadIdx.x >> 5);
      if (jw < W) {
        const int64_t at = (i0 + lane) * W + jw;
        const uint32_t old = rc[at];
        rn[at] = old | rword;
        if ((old | rword) != old) mine = true;
      }
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    more = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  const uint32_t* closure = a.rows[r & 1];
  // targets = hit | on_cycle, packed
  for (int64_t i = tid; i < N; i += nthreads) {
    const bool tg = a.hit[i] || bit(closure + i * W, i);
    a.hit[i] = tg;
    if (tg) atomicOr(&a.tgt[i >> 5], 1u << (i & 31));
  }
  grid.sync();
  // blocked = targets | (closure . targets): a warp per row
  const int64_t warp = tid >> 5, nwarps = nthreads >> 5;
  for (int64_t i = warp; i < N; i += nwarps) {
    uint32_t any = 0;
    for (int64_t v = lane; v < W; v += 32) any |= closure[i * W + v] & a.tgt[v];
    const bool reach = __any_sync(0xffffffffu, any != 0);
    if (lane == 0) {
      const int32_t s = a.status[i];
      const bool a0 = s == SLOT_APPLIED;
      const bool ap = a0 || (s == SLOT_STABLE && !a.hit[i] && !reach);
      a.applied[i] = ap;
      a.newly[i] = ap && !a0;
    }
  }
  if (tid == 0) *a.squarings = (int32_t)r;
}

}  // namespace

// ptrs: status int32[N], levels int32[N], watermark int64[1] or null,
//       applied bool[N], newly bool[N], depth int32[1]
// vals: N, watermark (read when the pointer is null)
ACCORD_EXPORT int accord_level_drain(void* const* p, const int64_t* v,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t N = v[0];
  int32_t* depth = (int32_t*)p[5];
  cudaError_t e = cudaMemsetAsync(depth, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (N <= 0) return (int)cudaGetLastError();
  int64_t blocks = (N + EPI_NT - 1) / EPI_NT;
  if (blocks > 1024) blocks = 1024;
  level_drain_kernel<<<(unsigned)blocks, EPI_NT, 0, st>>>(
      (const int32_t*)p[0], (const int32_t*)p[1], (const int64_t*)p[2], v[1],
      (uint8_t*)p[3], (uint8_t*)p[4], depth, N);
  return (int)cudaGetLastError();
}

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       rows0, rows1, cols0, cols1 (int32[NR*W] each; W = ceil(N/32),
//       NR = N rounded up to 128), tgt int32[W], hit bool[N],
//       flags int32[3], applied bool[N], newly bool[N], squarings int32[1]
// vals: N
ACCORD_EXPORT int accord_logsq_dense(void* const* p, const int64_t* v,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  LogsqArgs a;
  a.adj = (const uint8_t*)p[0];
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  for (int k = 0; k < 2; ++k) {
    a.rows[k] = (uint32_t*)p[6 + k];
    a.cols[k] = (uint32_t*)p[8 + k];
  }
  a.tgt = (uint32_t*)p[10];
  a.hit = (uint8_t*)p[11];
  a.flags = (int32_t*)p[12];
  a.applied = (uint8_t*)p[13];
  a.newly = (uint8_t*)p[14];
  a.squarings = (int32_t*)p[15];
  a.N = v[0];
  a.W = (a.N + 31) / 32;
  a.NR = (a.N + TJ - 1) / TJ * TJ;
  cudaError_t e = cudaSuccess;
  if (a.W > 0) e = cudaMemsetAsync(a.tgt, 0, a.W * sizeof(uint32_t), st);
  if (e == cudaSuccess && a.N > 0) e = cudaMemsetAsync(a.hit, 0, a.N, st);
  if (e != cudaSuccess) return (int)e;
  // a block per output tile (as many as fit at once; they stride over the
  // rest), and enough threads for the row passes
  const int64_t tiles = a.W * (a.NR / TJ);
  const int64_t rows = (a.N * 32 + NT - 1) / NT;
  return launch_cooperative(logsq_kernel, NT, tiles > rows ? tiles : rows,
                            a, st);
}
