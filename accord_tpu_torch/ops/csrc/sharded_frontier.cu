// K13: the row-sharded frontier sweep, and one sweep of the row-sharded
// fixpoint drain.
//
// Replaces (JAX reference, accord_tpu/parallel/sharded.py):
//   sharded_frontier  <- sharded_ready_frontier (:174): one sweep
//   sharded_drain     <- sharded_drain (:124): the body of its while loop
//                        (one launch a sweep; the host reads the changed
//                        flag and re-launches until no slice changes)
// Each device sweeps the rows of its own slices (adj bool[n/d, N] each,
// row exec and awaits local); the columns' status and executeAt, and in
// the drain the applied vector, are the gathered ones: the kernel reads
// every slice's column arrays through a table of per-slice pointers, all
// on this device (a slice of another device is copied here first).  Row i
// waits on column j when adj[i, j], j is neither invalidated nor free, j
// is undecided or executes before i or i awaits all, and j is not applied
// (the frontier: status Applied; the drain: the gathered applied vector of
// the previous sweep).  ready = Stable and not applied and not waiting;
// the drain writes applied | ready to the next buffer and sets the flag
// when any row became ready.  The reference's bf16 matvec ``> 0.5`` is the
// boolean any used here.
//
// Bound on this card: bytes — each sweep reads the N*N adjacency once.
// Design: one warp per row as in frontier_dense, lanes striding the row so
// reads coalesce, a warp vote for "some gating column is unapplied".
#include "common.cuh"

namespace {

constexpr int NT = 256;

// one slice whose rows this launch sweeps
struct RowRef {
  const uint8_t* adj;       // [n_l, N]
  const int32_t* status;    // [n_l]
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  const uint8_t* applied;   // drain: this slice's applied (prev sweep)
  uint8_t* out;             // frontier: ready; drain: next applied
  int64_t slice;            // the slice's index in the mesh
};
static_assert(sizeof(RowRef) == 9 * 8, "RowRef is 9 int64 words");

// every slice's column arrays, on this device
struct ColRef {
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* applied;   // drain only
};
static_assert(sizeof(ColRef) == 5 * 8, "ColRef is 5 int64 words");

__global__ void __launch_bounds__(NT)
sweep(const RowRef* rows, const ColRef* cols, int64_t n_l, int64_t N,
      int drain, int* changed) {
  const RowRef r = rows[blockIdx.y];
  const int64_t i = ((int64_t)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n_l) return;   // whole warps exit together
  const bool done = drain ? r.applied[i] != 0 : false;
  const bool stable = r.status[i] == SLOT_STABLE && !done;
  bool waiting = false;
  if (stable) {
    const int64_t im = r.emsb[i], il = r.elsb[i];
    const int32_t in = r.enode[i];
    const bool aw = r.awaits[i] != 0;
    const uint8_t* row = r.adj + i * N;
    for (int64_t j0 = 0; j0 < N && !waiting; j0 += 32) {
      const int64_t j = j0 + lane;
      bool w = false;
      if (j < N && row[j]) {
        const ColRef& c = cols[j / n_l];
        const int64_t jl = j - (j / n_l) * n_l;
        const int32_t sj = c.status[jl];
        const bool applied = drain ? c.applied[jl] != 0 : sj == SLOT_APPLIED;
        if (sj != SLOT_INVALIDATED && sj != SLOT_FREE && !applied) {
          const bool undecided = sj >= 0 && sj < SLOT_COMMITTED;
          w = undecided || aw ||
              ts_lt(c.emsb[jl], c.elsb[jl], c.enode[jl], im, il, in);
        }
      }
      waiting = __any_sync(0xffffffffu, w);
    }
  }
  if (lane == 0) {
    const bool ready = stable && !waiting;
    if (drain) {
      r.out[i] = done || ready;
      if (ready) atomicOr(changed, 1);
    } else {
      r.out[i] = ready;
    }
  }
}

}  // namespace

// ptrs: rows RowRef[R] (the slices of this device), cols ColRef[d] (every
//       slice, on this device), changed int32[1] (drain: set when a row
//       became ready; the wrapper zeroes it)
// vals: R, n_l (rows per slice), N (= d * n_l), drain
ACCORD_EXPORT int accord_sharded_sweep(void* const* p, const int64_t* v,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t R = v[0], n_l = v[1], N = v[2];
  if (v[3]) cudaMemsetAsync(p[2], 0, sizeof(int), st);
  if (R > 0 && n_l > 0)
    sweep<<<dim3((unsigned)((n_l * 32 + NT - 1) / NT), (unsigned)R), NT, 0,
            st>>>((const RowRef*)p[0], (const ColRef*)p[1], n_l, N,
                  (int)v[3], (int*)p[2]);
  return (int)cudaGetLastError();
}
