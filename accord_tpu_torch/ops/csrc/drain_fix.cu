// K8: the fixpoint drains, the oracles every other drain route is held to.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   drain_fix_dense <- drain_levels (:126) / drain (:115) = _drain_fix (:87)
//   drain_fix_ell   <- drain_ell_levels (:300) / drain_ell (:292)
//                      = _drain_ell_fix (:274)
// Output, equal to the reference: applied bool[N], newly bool[N] and the
// sweep count int32 (every sweep, the final empty one included).
//
// Each sweep applies every Stable, unapplied row none of whose gating deps
// is unapplied AS OF THE PREVIOUS SWEEP (a Jacobi step: the reference's
// while_loop body reads the carried applied set).  Updating in place would
// reach the same applied set in fewer sweeps, and the sweep count is part
// of the result (it prices the router), so each sweep reads a snapshot:
//   dense: applied as packed words in three rotating buffers — a sweep
//          reads one, ORs into the next (which the sweep before cleared)
//          and clears the one after;
//   ELL:   a per-row stamp, the sweep that applied the row (0 applied at
//          the start, NEVER not yet); sweep r counts a dep as applied iff
//          its stamp is below r, so a row applied during sweep r reads as
//          unapplied to the rest of that sweep, whichever order the
//          threads run in.
// The blocking relation is static for the whole drain, so it is computed
// once: dense, into a bit-packed [N, ceil(N/32)] matrix (2 MB at 4,096
// rows, resident in L2), which each sweep ANDs with the packed ~applied
// words; ELL, into an [N, D] copy of adj_idx with the non-gating edges
// set to -1.
//
// Design: ONE cooperative launch per drain (cudaLaunchCooperativeKernel,
// grid = the blocks that fit on the card at once) whose threads stride
// over the rows; grid.sync() ends each sweep and a "ready" flag in three
// rotating words (a reset never races a read) ends the loop on the device:
// no host round trip per sweep.  Dense: a warp per row, lanes striding its
// packed words; ELL: a thread per row.
//
// Bound on this card: the work a drain needs is one pass over the
// adjacency (bytes), but the fixpoint pays one sweep and one grid barrier
// per antichain: depth + 1 of them (4,097 on a 4,096-deep chain), so the
// barriers, not HBM, set its time.  The log-depth routes exist for that.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int32_t NEVER = 0x7fffffff;

struct Cols {
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
};

__device__ __forceinline__ bool gates(const Cols& c, int64_t i, int64_t j) {
  return drain_gates(c.status, c.emsb, c.elsb, c.enode, c.awaits, i, j);
}

struct DenseFixArgs {
  const uint8_t* adj;   // bool[N*N]
  Cols c;
  uint32_t* blk;        // [N*W] packed blocking rows (word v: deps 32v..)
  uint32_t* bits;       // [3*W] three packed applied sets, rotating
  int32_t* flags;       // [3]
  uint8_t *applied, *newly;
  int32_t* sweeps;
  int64_t N, W;
};

__global__ void __launch_bounds__(NT) fix_dense_kernel(DenseFixArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  const int64_t warp = tid >> 5, nwarps = nthreads >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t N = a.N, W = a.W;

  for (int64_t t = tid; t < N * W; t += nthreads) {
    const int64_t i = t / W, j0 = (t % W) * 32;
    const int64_t nb = min64(32, N - j0);
    const uint8_t* row = a.adj + i * N + j0;
    uint32_t word = 0;
    for (int64_t b = 0; b < nb; ++b)
      if (row[b] && gates(a.c, i, j0 + b)) word |= 1u << b;
    a.blk[t] = word;
  }
  for (int64_t v = tid; v < W; v += nthreads) {
    uint32_t word = 0;
    for (int64_t b = 0; b < 32 && v * 32 + b < N; ++b)
      if (a.c.status[v * 32 + b] == SLOT_APPLIED) word |= 1u << b;
    a.bits[v] = word;
    a.bits[W + v] = 0;   // sweep 0 ORs its result into the second set
  }
  if (tid == 0) a.flags[0] = a.flags[1] = a.flags[2] = 0;
  grid.sync();

  int64_t r = 0;
  bool more = true;
  while (more) {
    const uint32_t* cur = a.bits + (r % 3) * W;
    uint32_t* nxt = a.bits + ((r + 1) % 3) * W;
    uint32_t* after = a.bits + ((r + 2) % 3) * W;   // the last sweep's input
    for (int64_t v = tid; v < W; v += nthreads) {
      after[v] = 0;
      atomicOr(&nxt[v], cur[v]);
    }
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    bool mine = false;
    for (int64_t i = warp; i < N; i += nwarps) {
      // warp-uniform: every lane reads the same row state
      if (a.c.status[i] != SLOT_STABLE || ((cur[i >> 5] >> (i & 31)) & 1))
        continue;
      const uint32_t* row = a.blk + i * W;
      uint32_t wait = 0;
      for (int64_t v = lane; v < W; v += 32) wait |= row[v] & ~cur[v];
      if (!__any_sync(0xffffffffu, wait != 0) && lane == 0) {
        atomicOr(&nxt[i >> 5], 1u << (i & 31));
        mine = true;
      }
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    more = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  const uint32_t* fin = a.bits + (r % 3) * W;
  for (int64_t i = tid; i < N; i += nthreads) {
    const bool ap = (fin[i >> 5] >> (i & 31)) & 1;
    a.applied[i] = ap;
    a.newly[i] = ap && a.c.status[i] != SLOT_APPLIED;
  }
  if (tid == 0) *a.sweeps = (int32_t)r;
}

struct EllFixArgs {
  const int32_t* adj;   // int32[N*D]
  Cols c;
  int32_t* bidx;        // [N*D] the gating deps, -1 elsewhere
  int32_t* stamp;       // [N] the sweep that applied the row
  int32_t* flags;       // [3]
  uint8_t *applied, *newly;
  int32_t* sweeps;
  int64_t N, D;
};

__global__ void __launch_bounds__(NT) fix_ell_kernel(EllFixArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  const int64_t N = a.N, D = a.D;

  for (int64_t i = tid; i < N; i += nthreads) {
    for (int64_t d = 0; d < D; ++d) {
      const int32_t j = a.adj[i * D + d];
      a.bidx[i * D + d] = (j >= 0 && gates(a.c, i, j)) ? j : -1;
    }
    a.stamp[i] = a.c.status[i] == SLOT_APPLIED ? 0 : NEVER;
  }
  if (tid == 0) a.flags[0] = a.flags[1] = a.flags[2] = 0;
  grid.sync();

  int64_t r = 0;
  bool more = true;
  while (more) {
    const int32_t sweep = (int32_t)(r + 1);
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    bool mine = false;
    for (int64_t i = tid; i < N; i += nthreads) {
      if (a.c.status[i] != SLOT_STABLE || a.stamp[i] != NEVER) continue;
      bool ready = true;
      for (int64_t d = 0; ready && d < D; ++d) {
        const int32_t j = a.bidx[i * D + d];
        if (j >= 0 && a.stamp[j] >= sweep) ready = false;
      }
      if (ready) {
        a.stamp[i] = sweep;
        mine = true;
      }
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    more = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  for (int64_t i = tid; i < N; i += nthreads) {
    const bool ap = a.stamp[i] != NEVER;
    a.applied[i] = ap;
    a.newly[i] = ap && a.c.status[i] != SLOT_APPLIED;
  }
  if (tid == 0) *a.sweeps = (int32_t)r;
}

Cols cols(void* const* p) {
  return Cols{(const int32_t*)p[1], (const int64_t*)p[2],
              (const int64_t*)p[3], (const int32_t*)p[4],
              (const uint8_t*)p[5]};
}

}  // namespace

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       blk int32[N*W] (W = ceil(N/32)), bits int32[3*W], flags int32[3],
//       applied bool[N], newly bool[N], sweeps int32[1]
// vals: N
ACCORD_EXPORT int accord_drain_fix_dense(void* const* p, const int64_t* v,
                                         void* stream) {
  DenseFixArgs a;
  a.adj = (const uint8_t*)p[0];
  a.c = cols(p);
  a.blk = (uint32_t*)p[6];
  a.N = v[0];
  a.W = (a.N + 31) / 32;
  a.bits = (uint32_t*)p[7];
  a.flags = (int32_t*)p[8];
  a.applied = (uint8_t*)p[9];
  a.newly = (uint8_t*)p[10];
  a.sweeps = (int32_t*)p[11];
  // a warp per row
  return launch_cooperative(fix_dense_kernel, NT, (a.N * 32 + NT - 1) / NT,
                            a, (cudaStream_t)stream);
}

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, bidx int32[N*D], stamp int32[N], flags int32[3],
//       applied bool[N], newly bool[N], sweeps int32[1]
// vals: N, D
ACCORD_EXPORT int accord_drain_fix_ell(void* const* p, const int64_t* v,
                                       void* stream) {
  EllFixArgs a;
  a.adj = (const int32_t*)p[0];
  a.c = cols(p);
  a.bidx = (int32_t*)p[6];
  a.stamp = (int32_t*)p[7];
  a.flags = (int32_t*)p[8];
  a.applied = (uint8_t*)p[9];
  a.newly = (uint8_t*)p[10];
  a.sweeps = (int32_t*)p[11];
  a.N = v[0];
  a.D = v[1];
  // a thread per row
  return launch_cooperative(fix_ell_kernel, NT, (a.N + NT - 1) / NT, a,
                            (cudaStream_t)stream);
}
