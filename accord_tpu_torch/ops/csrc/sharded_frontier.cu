// K13: the row-sharded frontier sweep, one sweep of the row-sharded
// fixpoint drain, and the whole fixpoint drain in one launch.
//
// Replaces (JAX reference, accord_tpu/parallel/sharded.py):
//   sharded_frontier  <- sharded_ready_frontier (:174): one sweep
//   sharded_drain     <- sharded_drain (:124): the body of its while loop,
//                        one launch a sweep (the host reads the changed
//                        flag and re-launches until no slice changes); the
//                        path of a mesh whose slices lie on several cards
//   sharded_drain_fix <- sharded_drain (:124) whole, when every slice lies
//                        on this card: one cooperative launch
// Each device sweeps the rows of its own slices (adj bool[n/d, N] each,
// row exec and awaits local); the columns' status and executeAt, and in
// the drain the applied vector, are the gathered ones.  Row i waits on
// column j when adj[i, j], j is neither invalidated nor free, j is
// undecided or executes before i or i awaits all, and j is not applied
// (the frontier: status Applied; the drain: the applied set of the
// previous sweep).  ready = Stable and not applied and not waiting; the
// drain applies ready rows and stops after a sweep that applied none.  The
// reference's bf16 matvec ``> 0.5`` is the boolean any used here.
//
// The slices are passed by value, as a __grid_constant__ kernel parameter
// (at most MAX_SLICES of them): no table is uploaded per launch.  A row's
// status and executeAt are read from its own slice's column arrays (the
// wrapper passes the same tensors for both).
//
// Bound on this card: bytes — a sweep reads the N*N adjacency once.
// sweep: one warp per row, each lane loading 16 bytes of the row at a time
// (512 bytes a warp a step) and testing only the set bytes, a warp vote
// ending the row at its first waiting edge.
// drain_fix: the frontier form of the fixpoint (drain_frontier.cuh), the
// engine of K8's drain_fix_dense: its tile loader reads row i from slice
// i / n_l's adjacency, status and executeAt and column j from slice
// j / n_l's, tests the predicate of ``gates`` below, and writes each
// slice's applied flags to its out.  One cooperative launch: counts and
// levels, the grid on a level wider than K8's handover, the first CTA
// alone on the others (config 3's 4,096-deep chain: 4,097 sweeps, its
// lists in shared memory).
#include "drain_frontier.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_SLICES = ACCORD_SHARDED_MAX_SLICES;  // ops/_build.py

// one slice: its rows (adj, awaits, out) and its columns (status, exec,
// applied of the previous sweep in the per-sweep drain)
struct SliceRef {
  const uint8_t* adj;       // [n_l, N] (null: not swept by this launch)
  const uint8_t* awaits;    // [n_l]
  const int32_t* status;    // [n_l]
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* applied;   // per-sweep drain: the previous sweep's
  uint8_t* out;             // frontier: ready; drain: applied
};

struct SweepParams {
  SliceRef s[MAX_SLICES];
  int32_t rows[MAX_SLICES];   // the slices this launch sweeps
  int32_t n_l, N;
  int32_t* changed;
};

// does column j gate row i of slice ``si`` (applied columns excluded by
// the caller)
__device__ __forceinline__ bool gates(const SliceRef* s, int32_t n_l,
                                      const SliceRef& r, int32_t il,
                                      int32_t j) {
  const SliceRef& c = s[j / n_l];
  const int32_t jl = j % n_l;
  const int32_t sj = c.status[jl];
  if (sj == SLOT_INVALIDATED || sj == SLOT_FREE) return false;
  const bool undecided = sj >= 0 && sj < SLOT_COMMITTED;
  return undecided || r.awaits[il] ||
         ts_lt(c.emsb[jl], c.elsb[jl], c.enode[jl], r.emsb[il], r.elsb[il],
               r.enode[il]);
}

template <bool DRAIN>
__device__ __forceinline__ bool col_applied(const SliceRef* s, int32_t n_l,
                                            int32_t j) {
  const SliceRef& c = s[j / n_l];
  return DRAIN ? c.applied[j % n_l] != 0
               : c.status[j % n_l] == SLOT_APPLIED;
}

template <bool DRAIN>
__global__ void __launch_bounds__(NT)
sweep(const __grid_constant__ SweepParams p) {
  const SliceRef& r = p.s[p.rows[blockIdx.y]];
  const int32_t n_l = p.n_l, N = p.N;
  const int32_t il = (int32_t)(((int64_t)blockIdx.x * NT + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (il >= n_l) return;   // whole warps exit together
  const bool done = DRAIN ? r.applied[il] != 0 : false;
  const bool stable = r.status[il] == SLOT_STABLE && !done;
  bool waiting = false;
  if (stable) {
    const uint8_t* row = r.adj + (int64_t)il * N;
    if ((N & 15) == 0 && ((uintptr_t)row & 15) == 0) {
      for (int32_t j0 = 0; j0 < N && !waiting; j0 += 512) {
        const int32_t j = j0 + lane * 16;
        bool w = false;
        if (j < N) {
          const uint4 q = *(const uint4*)(row + j);
          const uint32_t word[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if (!((word[e >> 2] >> ((e & 3) * 8)) & 0xff)) continue;
            const int32_t jj = j + e;
            if (!col_applied<DRAIN>(p.s, n_l, jj) &&
                gates(p.s, n_l, r, il, jj))
              w = true;
          }
        }
        waiting = __any_sync(0xffffffffu, w);
      }
    } else {
      for (int32_t j0 = 0; j0 < N && !waiting; j0 += 32) {
        const int32_t j = j0 + lane;
        const bool w = j < N && row[j] && !col_applied<DRAIN>(p.s, n_l, j) &&
                       gates(p.s, n_l, r, il, j);
        waiting = __any_sync(0xffffffffu, w);
      }
    }
  }
  if (lane == 0) {
    const bool ready = stable && !waiting;
    if (DRAIN) {
      r.out[il] = done || ready;
      if (ready) atomicOr(p.changed, 1);
    } else {
      r.out[il] = ready;
    }
  }
}

// ptrs per slice (8 each, slice-major): adj (null for a slice this launch
// does not sweep), awaits, status, exec_msb, exec_lsb, exec_node, applied
// (null in the frontier), out (null for a slice not swept)
int read_slices(void* const* p, int64_t d, SliceRef* s) {
  if (d < 1 || d > MAX_SLICES) return (int)cudaErrorInvalidValue;
  for (int64_t k = 0; k < d; ++k) {
    void* const* q = p + 8 * k;
    s[k] = SliceRef{(const uint8_t*)q[0], (const uint8_t*)q[1],
                    (const int32_t*)q[2], (const int64_t*)q[3],
                    (const int64_t*)q[4], (const int32_t*)q[5],
                    (const uint8_t*)q[6], (uint8_t*)q[7]};
  }
  return 0;
}

// every slice's rows and columns, for the engine's tile loader: row i is
// row i % n_l of slice i / n_l
struct SliceSrc {
  SliceRef s[MAX_SLICES];
  int32_t n_l;
  int64_t N;
  __device__ __forceinline__ const SliceRef& at(int64_t i) const {
    return s[i / n_l];
  }
  __device__ __forceinline__ const uint8_t* row(int64_t i) const {
    return at(i).adj + (i % n_l) * N;
  }
  __device__ __forceinline__ int32_t status(int64_t i) const {
    return at(i).status[i % n_l];
  }
  __device__ __forceinline__ int64_t emsb(int64_t i) const {
    return at(i).emsb[i % n_l];
  }
  __device__ __forceinline__ int64_t elsb(int64_t i) const {
    return at(i).elsb[i % n_l];
  }
  __device__ __forceinline__ int32_t enode(int64_t i) const {
    return at(i).enode[i % n_l];
  }
  __device__ __forceinline__ uint8_t awaits(int64_t i) const {
    return at(i).awaits[i % n_l];
  }
  __device__ __forceinline__ void write(int64_t i, bool ap, bool) const {
    at(i).out[i % n_l] = ap;
  }
};

}  // namespace

// ptrs: 8 per slice (see read_slices) for d slices, then changed int32[1]
//       (drain: set when a row became ready; zeroed here)
// vals: d, n_l (rows per slice), N (= d * n_l), drain, R, then the R
//       indices of the slices this launch sweeps
ACCORD_EXPORT int accord_sharded_sweep(void* const* p, const int64_t* v,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SweepParams a;
  const int64_t d = v[0], R = v[4];
  int e = read_slices(p, d, a.s);
  if (e) return e;
  if (R < 0 || R > d) return (int)cudaErrorInvalidValue;
  for (int64_t k = 0; k < R; ++k) a.rows[k] = (int32_t)v[5 + k];
  a.n_l = (int32_t)v[1];
  a.N = (int32_t)v[2];
  a.changed = (int32_t*)p[8 * d];
  if (v[3]) cudaMemsetAsync(a.changed, 0, sizeof(int32_t), st);
  if (R > 0 && a.n_l > 0) {
    const dim3 grid((unsigned)(((int64_t)a.n_l * 32 + NT - 1) / NT),
                    (unsigned)R);
    if (v[3]) sweep<true><<<grid, NT, 0, st>>>(a);
    else sweep<false><<<grid, NT, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// ptrs: 8 per slice (applied null) for d slices, then workspace
//       int32[accord_drain_fix_workspace_words(N)], sweeps int32[1]
// vals: d, n_l, N (= d * n_l), workspace words
ACCORD_EXPORT int accord_sharded_drain_fix(void* const* p, const int64_t* v,
                                           void* stream) {
  SliceSrc src;
  const int64_t d = v[0], N = v[2];
  int e = read_slices(p, d, src.s);
  if (e) return e;
  if (N < 0 || N > INT32_MAX / 2 || N != d * v[1] ||
      v[3] < tile_workspace_words(N))
    return (int)cudaErrorInvalidValue;
  src.n_l = (int32_t)v[1];
  src.N = N;
  TileLoader<SliceSrc> a = tile_loader(src, N, (uint32_t*)p[8 * d]);
  a.f.sweeps = (int32_t*)p[8 * d + 1];
  a.vec = N % 16 == 0;
  for (int64_t k = 0; k < d; ++k)
    a.vec = a.vec && (uintptr_t)src.s[k].adj % 16 == 0;
  // a warp a tile or a row, whichever is more
  const int64_t want = (max64(a.W * a.W, N) + FW - 1) / FW;
  return launch_cooperative(frontier_kernel<TileLoader<SliceSrc>>, FNT, want,
                            a, (cudaStream_t)stream, FIX_SMEM);
}
