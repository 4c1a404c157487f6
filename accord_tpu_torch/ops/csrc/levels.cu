// K7: log-depth level assignment of the execution drain.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   level_ell   <- level_assign_ell (:397) = _ell_levels (:381)
//   level_dense <- level_assign_dense (:421) = _dense_levels (:404)
// with _level_base (:321), _critical_ptr (:366) and _level_loop (:331).
// Output, equal to the reference: levels int32[N] (0 applied, 1..N the
// frontier sweep that would apply the slot, LEVEL_INF = 2^28 blocked
// forever) and the round count int32.
//
// Each round is a Bellman relax (1 + max level over the blocking deps)
// followed by a pointer jump along each row's critical-parent chain
// (level >= off + level[ptr]; then ptr <- ptr[ptr], off <- off + off[ptr]),
// until no level changes or the round count reaches N + 3 (N the padded
// row count).  The jump reads the relax's output of OTHER rows, and the
// doubling reads the old ptr/off of other rows, so every round has two
// grid-wide ordering points and double buffers for level, ptr and off.
//
// Design: ONE cooperative launch per call (cudaLaunchCooperativeKernel,
// grid = the blocks that fit on the card at once) whose threads stride
// over the rows; cooperative_groups grid.sync() is the ordering point
// (three per round), and a per-round "changed" flag (three rotating
// words, so a reset never races a read) ends the loop on the device — no
// host round trip per round.  ELL: one thread per row.  Dense: one warp
// per row, lanes striding the row, warp max-reductions.
//
// Bound on this card: bytes and latency — each round reads the adjacency
// (N*D int32 or N*N bytes) and gathers the deps' status/executeAt and
// levels; the rounds are ~2*log2(depth) + c on chains, and each costs two
// grid barriers, so for the main path's shapes the barriers, not HBM,
// set the time.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int32_t LEVEL_INF = 1 << 28;

struct LevelArgs {
  const void* adj;   // int32[N*D] (ELL) or bool[N*N] (dense)
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  int32_t *lv[2], *mid, *ptr[2], *off[2], *flags, *rounds, *out;
  int64_t N, D;
};

__device__ __forceinline__ bool gates(const LevelArgs& a, int64_t i,
                                      int64_t j) {
  return drain_gates(a.status, a.emsb, a.elsb, a.enode, a.awaits, i, j);
}

__device__ __forceinline__ int32_t base_level(const LevelArgs& a,
                                              int64_t i) {
  const int32_t s = a.status[i];
  return s == SLOT_APPLIED ? 0 : (s == SLOT_STABLE ? 1 : LEVEL_INF);
}

__device__ __forceinline__ int64_t warp_max64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max64(v, (int64_t)__shfl_xor_sync(0xffffffffu, (long long)v, o));
  return v;
}

__device__ __forceinline__ int32_t warp_max32(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = maxi(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over row i's blocking deps of key(j) (-1 when there is none);
// ELL: the calling thread alone; dense: the calling warp, every lane
// returning the result
template <bool ELL, typename Key>
__device__ __forceinline__ int64_t row_max(const LevelArgs& a, int64_t i,
                                           int lane, Key key) {
  int64_t best = -1;
  if (ELL) {
    const int32_t* adj = (const int32_t*)a.adj + i * a.D;
    for (int64_t d = 0; d < a.D; ++d) {
      const int32_t j = adj[d];
      if (j >= 0 && gates(a, i, j)) best = max64(best, key(j));
    }
    return best;
  }
  const uint8_t* row = (const uint8_t*)a.adj + i * a.N;
  for (int64_t j = lane; j < a.N; j += 32)
    if (row[j] && gates(a, i, j)) best = max64(best, key(j));
  return warp_max64(best);
}

template <bool ELL>
__global__ void __launch_bounds__(NT) level_kernel(LevelArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  // ELL: a thread per row; dense: a warp per row
  const int64_t unit = ELL ? tid : tid >> 5;
  const int64_t nunits = ELL ? nthreads : nthreads >> 5;
  const int lane = threadIdx.x & 31;
  const bool leader = ELL || lane == 0;
  const int64_t N = a.N;

  // base levels and each Stable row's critical parent: the blocking dep
  // with the largest level0 * N + slot key (keys are unique per slot)
  for (int64_t i = unit; i < N; i += nunits) {
    const int32_t lv0 = base_level(a, i);
    const int64_t best = row_max<ELL>(a, i, lane, [&](int64_t j) {
      return (int64_t)base_level(a, j) * N + j;
    });
    if (leader) {
      const bool stable = a.status[i] == SLOT_STABLE;
      const int32_t p = (best >= 0 && stable) ? (int32_t)(best % N)
                                              : (int32_t)i;
      a.lv[0][i] = lv0;
      a.ptr[0][i] = p;
      a.off[0][i] = p != i ? 1 : 0;
    }
  }
  if (tid == 0) {
    a.flags[0] = 0;
    a.flags[1] = 0;
    a.flags[2] = 0;
  }
  grid.sync();

  int64_t r = 0;
  bool changed = true;
  while (changed && r < N + 3) {
    const int c = (int)(r & 1);
    const int32_t* lv = a.lv[c];
    // relax: new = max(lv, min(relax(lv), INF)) for rows below INF
    for (int64_t i = unit; i < N; i += nunits) {
      const int32_t old = lv[i];
      int32_t nw = old;
      if (old < LEVEL_INF) {
        int32_t rel;
        if (a.status[i] == SLOT_STABLE) {
          const int64_t m = row_max<ELL>(a, i, lane, [&](int64_t j) {
            return (int64_t)lv[j];
          });
          rel = 1 + (int32_t)max64(m, 0);
        } else {
          rel = base_level(a, i);
        }
        nw = maxi(mini(rel, LEVEL_INF), old);
      }
      if (leader) a.mid[i] = nw;
    }
    if (tid == 0) a.flags[(r + 1) % 3] = 0;
    grid.sync();
    // jump along the witness walk, clamp, and double the walk
    int32_t* lv_next = a.lv[c ^ 1];
    const int32_t* ptr = a.ptr[c];
    const int32_t* off = a.off[c];
    bool mine = false;
    for (int64_t i = tid; i < N; i += nthreads) {
      const int32_t o = off[i];
      const int32_t p = ptr[i];
      int32_t nw = a.mid[i];
      if (o > 0) nw = maxi(nw, mini(o + a.mid[p], LEVEL_INF));
      if (nw > N) nw = LEVEL_INF;
      lv_next[i] = nw;
      a.off[c ^ 1][i] = mini(o + off[p], LEVEL_INF);
      a.ptr[c ^ 1][i] = ptr[p];
      mine |= nw != lv[i];
    }
    if (mine) a.flags[r % 3] = 1;
    grid.sync();
    changed = *(volatile int32_t*)&a.flags[r % 3] != 0;
    ++r;
  }
  const int32_t* fin = a.lv[r & 1];
  for (int64_t i = tid; i < N; i += nthreads) a.out[i] = fin[i];
  if (tid == 0) *a.rounds = (int32_t)r;
}

template <bool ELL>
int launch(void* const* p, const int64_t* v, cudaStream_t st) {
  LevelArgs a;
  a.adj = p[0];
  a.status = (const int32_t*)p[1];
  a.emsb = (const int64_t*)p[2];
  a.elsb = (const int64_t*)p[3];
  a.enode = (const int32_t*)p[4];
  a.awaits = (const uint8_t*)p[5];
  a.lv[0] = (int32_t*)p[6];
  a.lv[1] = (int32_t*)p[7];
  a.mid = (int32_t*)p[8];
  a.ptr[0] = (int32_t*)p[9];
  a.ptr[1] = (int32_t*)p[10];
  a.off[0] = (int32_t*)p[11];
  a.off[1] = (int32_t*)p[12];
  a.flags = (int32_t*)p[13];
  a.rounds = (int32_t*)p[14];
  a.out = (int32_t*)p[15];
  a.N = v[0];
  a.D = v[1];
  if (a.N <= 0) return (int)cudaGetLastError();
  // ELL: a thread per row; dense: a warp per row
  const int64_t want = ELL ? (a.N + NT - 1) / NT : (a.N * 32 + NT - 1) / NT;
  return launch_cooperative(level_kernel<ELL>, NT, want, a, st);
}

}  // namespace

// ptrs: adj_idx int32[N*D], status, exec_msb, exec_lsb, exec_node,
//       awaits_all, lv0, lv1, mid, ptr0, ptr1, off0, off1 (int32[N]
//       scratch each), flags int32[3], rounds int32[1], levels int32[N]
// vals: N, D
ACCORD_EXPORT int accord_level_ell(void* const* p, const int64_t* v,
                                   void* stream) {
  return launch<true>(p, v, (cudaStream_t)stream);
}

// ptrs: adj bool[N*N], then as accord_level_ell
// vals: N, N
ACCORD_EXPORT int accord_level_dense(void* const* p, const int64_t* v,
                                     void* stream) {
  return launch<false>(p, v, (cudaStream_t)stream);
}
