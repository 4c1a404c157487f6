// K9: the dense log-squaring drain.
//
// Replaces (JAX reference, accord_tpu/ops/drain_kernel.py):
//   logsq_dense <- drain_dense_logsq (:489)
// (K9's other part, the level-drain epilogue of the log-depth drains,
// _levels_to_drain (:427) and the depth, runs inside K7's launch:
// levels.cu.)
//
// logsq_dense: a Stable row is blocked forever iff it reaches, along
// blocking edges into Stable deps, a dep that never applies (``hit``) or a
// cycle.  The step relation s is squared, s <- s | (s.s > 0), until it
// stops changing (``squarings`` counts the final unchanged pass); then
// on_cycle = diag(s), targets = hit | on_cycle, and blocked = targets |
// (s . targets).  The reference multiplies 0/1 matrices in bf16 and
// tests > 0.5: a count >= 1 never rounds below 0.5, so that IS boolean
// "any", and here the product runs exactly on the tensor cores: 0/1
// operands and a 32-bit integer count (at most N < 2^31), ``acc > 0``:
// mma.sync m16n8k256 b1 AND-popc -> s32, whose fragments are the packed
// words as they are (a popc of AND counts the common k).  An s8 form
// (m16n8k32 on bytes unpacked from the bits) measured 1.6x slower on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
// s is kept bit-packed in device memory twice, by rows (word v of row i:
// columns 32v..32v+31) and by columns (row j of the column packing is
// column j of s): 2 MB each at N = 4,096, so the four ping-pong buffers
// stay in L2.  N is padded with zero rows and columns to NP, a multiple
// of 256 (the k-chunk); the padding stays zero under squaring.
// Design: one cooperative launch per call.  A squaring walks 128 x 128
// output tiles (a block of 8 warps, each 32 rows x 64 columns: 2 x 8 mma
// tiles), handed out by a counter so that the costly tiles, which cluster
// where the data does, spread over the blocks.  Chunk masks say which 256-bit k-chunks of a row tile's row
// words and of a column tile's column words hold a non-zero word; a tile
// stages only the chunks set in both (the next one's loads in flight
// during this one's mma), and a warp skips a chunk whose words are zero
// for its rows or its columns (exact: a zero operand adds nothing).  The
// epilogue packs (acc > 0) from the mma fragments by warp shuffles into
// the new row words and column words (OR the old ones) and sets the
// "changed" flag; a tile with no chunk to stage copies its words.
// Each tile marks the chunk masks of the next squaring where its new
// words are non-zero (masks rotate through three buffers: read, marked,
// zeroed).  grid.sync() ends a squaring and the flag in three rotating
// words ends the loop on the device.
// Bound on this card: operations — per squaring, 2 x 128 x 128 x 256 for
// each (output tile, k-chunk) pair whose row and column words are both
// non-zero (squarings x 2 N^3 on a dense input), on the int8 tensor cores
// (1,979 Tops/s dense; no b1 rate is published).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// -- log-squaring ------------------------------------------------------------

constexpr int NT = 256;     // 8 warps: 4 (32 rows each) x 2 (64 columns each)
constexpr int BT = 128;     // output tile edge
constexpr int KW = 8;       // words per k-chunk (256 bits)
constexpr int KWP = 12;     // shared row stride in words: conflict-free reads
constexpr int NPAD = 256;   // N is padded to a multiple of the k-chunk

struct LogsqArgs {
  const uint8_t* adj;   // bool[N*N]
  const int32_t* status;
  const int64_t *emsb, *elsb;
  const int32_t* enode;
  const uint8_t* awaits;
  uint32_t* rows[2];    // [NP*W] s by rows, ping-pong
  uint32_t* cols[2];    // [NP*W] s by columns, ping-pong
  uint32_t* tgt;        // [W] packed targets, zeroed before the launch
  uint8_t* hit;         // [N], zeroed before the launch
  int32_t* flags;       // [3]
  uint8_t *applied, *newly;
  int32_t* squarings;
  // chunk masks, [3 buffers][rows, columns][NP / BT tiles][MW words]: bit
  // c of a row tile's (column tile's) mask is set iff one of its row
  // (column) words in k-chunk c is non-zero; zeroed before the launch
  uint32_t* masks;
  uint32_t* next_tile;  // [3] rotating counters that hand out the tiles
  int64_t N, W, NP, MW;
};

__device__ __forceinline__ uint32_t* chunk_mask(const LogsqArgs& a, int64_t buf,
                                                int kind, int64_t tile) {
  return a.masks + ((buf * 2 + kind) * (a.NP / BT) + tile) * a.MW;
}

// set bit c of a mask
__device__ __forceinline__ void mark(uint32_t* mask, int64_t c) {
  atomicOr(&mask[c >> 5], 1u << (c & 31));
}

// the same where many threads mark few bits: a read first, as most find
// the bit set already
__device__ __forceinline__ void mark_once(uint32_t* mask, int64_t c) {
  const uint32_t b = 1u << (c & 31);
  if (!(*(volatile uint32_t*)&mask[c >> 5] & b)) atomicOr(&mask[c >> 5], b);
}

// the k-chunks set in both masks of a tile, in order; the current mask
// word is kept in a register, so a chunk's loads wait on no mask read
struct ChunkIter {
  const uint32_t *ma, *mb;
  int64_t nch, cw;
  uint32_t bits;
  __device__ ChunkIter(const uint32_t* a, const uint32_t* b, int64_t n)
      : ma(a), mb(b), nch(n), cw(-1), bits(0) {}
  // the first chunk at or after ``from``, or -1
  __device__ int64_t next(int64_t from) {
    while (from < nch) {
      const int64_t w = from >> 5;
      if (w != cw) {
        cw = w;
        bits = ma[w] & mb[w];
      }
      const uint32_t rest = bits >> (from & 31);
      if (rest) return from + __ffs(rest) - 1;
      from = (w + 1) << 5;
    }
    return -1;
  }
};

struct SquareSmem {
  uint32_t a[BT * KWP];   // the chunk's row words, [row][KWP]
  uint32_t b[BT * KWP];   // the chunk's column words, [column][KWP]
};

__device__ __forceinline__ bool bit(const uint32_t* words, int64_t k) {
  return (words[k >> 5] >> (k & 31)) & 1;
}

__device__ __forceinline__ void mma_b1(int32_t* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's 32 x 64 share of the staged 256-bit k-chunk.  Fragments
// (PTX ISA, mma.m16n8k256): lane = 4g + t; A register 0/1 = rows g/g+8 of
// the m-tile at k 32t..32t+31, 2/3 the same at k 128+32t..; B register
// 0/1 = column g of the n-tile at k 32t.., 128+32t..; C rows g, g + 8 x
// columns 2t, 2t + 1.  Within a register both operands order k alike,
// which is all a dot product needs.
__device__ __forceinline__ void chunk_mma(const SquareSmem& sm, int wm,
                                          int wn, int lane,
                                          int32_t (&acc)[2][8][4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* sa = sm.a + (wm * 32 + g) * KWP;
  const uint32_t* sb = sm.b + (wn * 64 + g) * KWP;
  uint32_t af[2][4], bf[8][2], za = 0, zb = 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint32_t* r0 = sa + mt * 16 * KWP;
    af[mt][0] = r0[t];
    af[mt][1] = r0[8 * KWP + t];
    af[mt][2] = r0[4 + t];
    af[mt][3] = r0[8 * KWP + 4 + t];
    za |= af[mt][0] | af[mt][1] | af[mt][2] | af[mt][3];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const uint32_t* c0 = sb + nt * 8 * KWP;
    bf[nt][0] = c0[t];
    bf[nt][1] = c0[4 + t];
    zb |= bf[nt][0] | bf[nt][1];
  }
  if (!__any_sync(0xffffffffu, za != 0) || !__any_sync(0xffffffffu, zb != 0))
    return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_b1(acc[mt][nt], af[mt], bf[nt]);
}

// s' = s | (s.s > 0) on one 128 x 128 output tile; true if a word
// changed.  ma / mb: this squaring's masks of the row tile and the column
// tile; na / nb: the next squaring's.
__device__ bool square_tile(const LogsqArgs& a, SquareSmem& sm,
                            const uint32_t* rc, const uint32_t* cc,
                            uint32_t* rn, uint32_t* cn, const uint32_t* ma,
                            const uint32_t* mb, uint32_t* na, uint32_t* nb,
                            int64_t i0, int64_t j0) {
  const int64_t W = a.W;
  ChunkIter chunks(ma, mb, a.NP / (32 * KW));
  int64_t c = chunks.next(0);
  bool nzr = false, nzc = false;   // a new row (column) word is non-zero
  if (c < 0) {
    // s.s adds nothing to this tile: carry its row and column words over
    // (every load issued before the first store)
    int64_t ar[2], ac[2];
    uint32_t vr[2], vc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = threadIdx.x + u * NT, x = k >> 2, w = k & 3;
      ar[u] = (i0 + x) * W + (j0 >> 5) + w;
      ac[u] = (j0 + x) * W + (i0 >> 5) + w;
      vr[u] = rc[ar[u]];
      vc[u] = cc[ac[u]];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      rn[ar[u]] = vr[u];
      cn[ac[u]] = vc[u];
      nzr |= vr[u] != 0;
      nzc |= vc[u] != 0;
    }
    const int any_r = __syncthreads_or(nzr), any_c = __syncthreads_or(nzc);
    if (threadIdx.x == 0) {
      if (any_r) mark(na, j0 / (32 * KW));
      if (any_c) mark(nb, i0 / (32 * KW));
    }
    return false;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  // the old words this lane ORs into in the epilogue, loaded now: two row
  // words (m-tile mt: row mt * 16 + g + 8 (t >> 1), word t & 1) and two
  // column words (column g * 8 + 2t + e0 of the warp's 64)
  int64_t at_r[2], at_c[2];
  uint32_t old_r[2], old_c[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    at_r[u] = (i0 + wm * 32 + u * 16 + g + 8 * (t >> 1)) * W + (j0 >> 5) +
              2 * wn + (t & 1);
    at_c[u] = (j0 + wn * 64 + g * 8 + 2 * t + u) * W + (i0 >> 5) + wm;
    old_r[u] = rc[at_r[u]];
    old_c[u] = cc[at_c[u]];
  }
  int32_t acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  // one 16-byte load of row words and one of column words per thread a
  // chunk: thread 2r + h takes words 4h..4h+3 of tile row (column) r
  const int sr = threadIdx.x >> 1, sh = threadIdx.x & 1;
  const uint4* ga = (const uint4*)(rc + (i0 + sr) * W + 4 * sh);
  const uint4* gb = (const uint4*)(cc + (j0 + sr) * W + 4 * sh);
  uint4 la = ga[2 * c], lb = gb[2 * c];
  while (c >= 0) {
    __syncthreads();   // the previous chunk's (or tile's) readers are done
    *(uint4*)(sm.a + sr * KWP + 4 * sh) = la;
    *(uint4*)(sm.b + sr * KWP + 4 * sh) = lb;
    c = chunks.next(c + 1);
    if (c >= 0) {
      la = ga[2 * c];
      lb = gb[2 * c];
    }
    __syncthreads();
    chunk_mma(sm, wm, wn, lane, acc);
  }
  // the epilogue, from the accumulator fragments: (acc > 0) | old.  A
  // row word (32 columns of one row) takes 8 bits from each lane t of its
  // group g (columns 2t, 2t + 1 of 4 n-tiles): an OR over t completes it.
  // A column word (the warp's 32 rows of one column) takes 4 bits from
  // each lane g (rows g, g + 8 of 2 m-tiles): an OR over g completes it.
  bool changed = false;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t rw[4];   // [h * 2 + q]: row mt * 16 + g + 8h, word q
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t w = 0;
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
          for (int e0 = 0; e0 < 2; ++e0)
            w |= (uint32_t)(acc[mt][4 * q + n4][2 * h + e0] > 0)
                 << (n4 * 8 + 2 * t + e0);
        w |= __shfl_xor_sync(0xffffffffu, w, 1);
        w |= __shfl_xor_sync(0xffffffffu, w, 2);
        rw[h * 2 + q] = w;
      }
    // lane t writes word (h, q) = (t >> 1, t & 1) of its rows
    const uint32_t mine = t == 0 ? rw[0] : t == 1 ? rw[1] : t == 2 ? rw[2]
                                                                   : rw[3];
    const uint32_t word = old_r[mt] | mine;
    rn[at_r[mt]] = word;
    changed |= word != old_r[mt];
    nzr |= word != 0;
  }
  uint32_t cw[16];   // [nt * 2 + e0]: column nt * 8 + 2t + e0
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e0 = 0; e0 < 2; ++e0) {
      uint32_t w = 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w |= (uint32_t)(acc[mt][nt][2 * h + e0] > 0) << (mt * 16 + 8 * h + g);
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      w |= __shfl_xor_sync(0xffffffffu, w, 8);
      w |= __shfl_xor_sync(0xffffffffu, w, 16);
      cw[nt * 2 + e0] = w;
    }
  // lane g writes the words of n-tile g
#pragma unroll
  for (int e0 = 0; e0 < 2; ++e0) {
    uint32_t mine = cw[e0];
#pragma unroll
    for (int nt = 1; nt < 8; ++nt)
      if (g == nt) mine = cw[nt * 2 + e0];
    const uint32_t word = old_c[e0] | mine;
    cn[at_c[e0]] = word;
    nzc |= word != 0;
  }
  const int any_r = __syncthreads_or(nzr), any_c = __syncthreads_or(nzc);
  if (threadIdx.x == 0) {
    if (any_r) mark(na, j0 / (32 * KW));
    if (any_c) mark(nb, i0 / (32 * KW));
  }
  return changed;
}

__global__ void __launch_bounds__(NT, 2) logsq_kernel(LogsqArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) SquareSmem sm;
  const int64_t tid = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * NT;
  const int lane = threadIdx.x & 31;
  const int64_t N = a.N, W = a.W, NP = a.NP;

  // the step relation by rows (edges into Stable deps) and ``hit`` (an
  // edge into a dep that is neither Stable nor Applied); padding is 0
  for (int64_t t = tid; t < NP * W; t += nthreads) {
    const int64_t i = t / W, j0 = (t % W) * 32;
    uint32_t word = 0;
    bool hit = false;
    if (i < N) {
      // the edges among columns j0..j0+31: two 16-byte loads where the
      // row allows (N a multiple of 16), else a byte at a time
      const int64_t nb = min64(32, N - j0);
      const uint8_t* row = a.adj + i * N + j0;
      uint32_t edges = 0;
      if (nb == 32 && (N & 15) == 0) {
        const uint4 lo = ((const uint4*)row)[0], hi = ((const uint4*)row)[1];
        const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if ((v[k >> 2] >> (8 * (k & 3))) & 0xffu) edges |= 1u << k;
      } else {
        for (int64_t b = 0; b < nb; ++b)
          if (row[b]) edges |= 1u << b;
      }
      while (edges) {
        const int b = __ffs(edges) - 1;
        edges &= edges - 1;
        const int64_t j = j0 + b;
        if (!drain_gates(a.status, a.emsb, a.elsb, a.enode, a.awaits, i, j))
          continue;
        const int32_t sj = a.status[j];
        if (sj == SLOT_STABLE) word |= 1u << b;
        else if (sj != SLOT_APPLIED) hit = true;
      }
    }
    a.rows[0][t] = word;
    if (hit) a.hit[i] = 1;
    if (word) mark_once(chunk_mask(a, 0, 0, i / BT), (t % W) / KW);
  }
  if (tid == 0) a.flags[0] = a.flags[1] = a.flags[2] = 0;
  grid.sync();
  // ... and by columns: bit b of word v of column j is s[32v + b][j].  A
  // warp transposes a 32 x 32 bit block (rows 32v.., columns 32u..) by
  // ballots: lane b holds row 32v + b's word u, lane k keeps ballot k
  for (int64_t q = tid >> 5; q < W * W; q += nthreads >> 5) {
    const int64_t v = q / W, u = q % W;
    const uint32_t rw = a.rows[0][(32 * v + lane) * W + u];
    uint32_t mine = 0;
    for (int k = 0; k < 32; ++k) {
      const uint32_t word = __ballot_sync(0xffffffffu, (rw >> k) & 1);
      if (lane == k) mine = word;
    }
    a.cols[0][(32 * u + lane) * W + v] = mine;
    if (__any_sync(0xffffffffu, mine != 0) && lane == 0)
      mark_once(chunk_mask(a, 0, 1, (32 * u) / BT), v / KW);
  }
  grid.sync();

  const int64_t n_t = NP / BT;
  __shared__ int64_t tile_slot[2];
  int64_t r = 0;
  bool more = true;
  while (more) {
    const uint32_t* rc = a.rows[r & 1];
    const uint32_t* cc = a.cols[r & 1];
    uint32_t* rn = a.rows[(r & 1) ^ 1];
    uint32_t* cn = a.cols[(r & 1) ^ 1];
    if (tid == 0) a.flags[(r + 1) % 3] = a.next_tile[(r + 1) % 3] = 0;
    for (int64_t t = tid; t < 2 * n_t * a.MW; t += nthreads)
      chunk_mask(a, (r + 2) % 3, 0, 0)[t] = 0;   // marked next squaring
    bool mine = false;
    // a counter hands out the tiles (the costly ones cluster: near the
    // diagonal of a chain); thread 0 asks for the next one while the
    // block squares the current one, and square_tile ends on a barrier
    uint32_t* ctr = a.next_tile + r % 3;
    if (threadIdx.x == 0) tile_slot[0] = atomicAdd(ctr, 1u);
    __syncthreads();
    int64_t tile = tile_slot[0];
    for (int k = 1; tile < n_t * n_t; k ^= 1) {
      if (threadIdx.x == 0) tile_slot[k] = atomicAdd(ctr, 1u);
      const int64_t ti = tile / n_t, tj = tile % n_t;
      mine |= square_tile(a, sm, rc, cc, rn, cn, chunk_mask(a, r % 3, 0, ti),
                          chunk_mask(a, r % 3, 1, tj),
                          chunk_mask(a, (r + 1) % 3, 0, ti),
                          chunk_mask(a, (r + 1) % 3, 1, tj), ti * BT,
                          tj * BT);
      tile = tile_slot[k];
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

// ptrs: adj bool[N*N], status, exec_msb, exec_lsb, exec_node, awaits_all,
//       work int32[logsq_work_words(N)], applied bool[N], newly bool[N],
//       squarings int32[1]
// vals: N
// work: rows0, rows1, cols0, cols1 (NP*W each; NP = N rounded up to 256,
// W = NP / 32), then, zeroed here: tgt [W], masks [6 * (NP / 128) * MW]
// (MW = ceil(NP / 256 / 32)), next_tile [3], flags [3], hit [ceil(N / 4)]
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
  a.N = v[0];
  a.NP = (a.N + NPAD - 1) / NPAD * NPAD;
  a.W = a.NP / 32;
  a.MW = (a.NP / NPAD + 31) / 32;
  uint32_t* work = (uint32_t*)p[6];
  for (int k = 0; k < 2; ++k) {
    a.rows[k] = work + k * a.NP * a.W;
    a.cols[k] = work + (2 + k) * a.NP * a.W;
  }
  a.tgt = work + 4 * a.NP * a.W;
  a.masks = a.tgt + a.W;
  a.next_tile = a.masks + 6 * (a.NP / BT) * a.MW;
  a.flags = (int32_t*)a.next_tile + 3;
  a.hit = (uint8_t*)(a.flags + 3);
  a.applied = (uint8_t*)p[7];
  a.newly = (uint8_t*)p[8];
  a.squarings = (int32_t*)p[9];
  const int64_t tail = a.W + 6 * (a.NP / BT) * a.MW + 6 + (a.N + 3) / 4;
  cudaError_t e = cudaMemsetAsync(a.tgt, 0, tail * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  // a block per output tile (as many as fit at once; the counter hands
  // out the rest), and enough threads for the row passes
  const int64_t tiles = (a.NP / BT) * (a.NP / BT);
  const int64_t rows = (a.N * 32 + NT - 1) / NT;
  const int64_t want = tiles > rows ? tiles : rows;
  return launch_cooperative(logsq_kernel, NT, want, a, st);
}
