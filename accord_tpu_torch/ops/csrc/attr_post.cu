// K2: post-compaction attribution over the compacted entry buffer.
//
// Replaces (JAX reference, accord_tpu/ops/deps_kernel.py): _attr_post (:921)
// with _attr_key_masks (:875), as composed by calculate_deps_flat_attr
// (:998) and bucketed_attr (:1015, jitted :1034); with ``tok=`` as the
// mesh-bucketed attribution runs it (accord_tpu/parallel/sharded.py:578),
// and attr_tok, that caller's per-entry token (:566-576, the psum's
// contributions of the slices on one device).
// Input: the raw CSR of K1 (header int32[2+B], entries[s]).  Output,
// byte-equal to the reference: header int32[5+B] = (total, raw total,
// raw maxc, n_trans, n_dec, row_end[B]) and the kept entries recompacted
// in order, -1 elsewhere.
//
// Per live entry: its row by searchsorted(row_end, pos, right); for
// key-domain deps the exact per-token RedundantBefore floor (searchsorted
// of the token in fbnd, right side), TRANSITIVE elision, decided-below-
// pivot elision (searchsorted of seg*estride + rankb in erank, left side)
// and the (row, slot, col) dedupe against the previous entry.  The static
// ``floors`` / ``elide`` switches drop whole legs, as in the reference.
//
// Bound on this card: bytes — each entry is read once and written at most
// once, with a handful of gathers (attr columns, one lo) and two short
// binary searches per entry.  Design: one thread per entry computes the
// keep flag and counts its row's drops and the elision tallies with
// integer atomics (order-free, so deterministic); a block scan plus a scan
// of the block sums places the kept entries; one block rebuilds row_end.
#include "common.cuh"

namespace {

constexpr int NT = 256;

struct AttrArgs {
  const int64_t* tlo;
  const int32_t *dom, *status, *dnode, *enode, *fnode, *eptr, *exn;
  const int64_t *dmsb, *dlsb, *emsb, *elsb, *fbnd, *fmsb, *flsb, *etok,
      *erank, *exm, *exl, *estride, *rankb;
  const uint8_t* eknown;
  const int32_t* hdr_raw;
  const int64_t* tok;   // per-entry token (mesh bucketed), or null: tlo
  int64_t s, F, T_len, L;
  int B, m_t, m, floors, elide;
};

template <typename T>
__device__ __forceinline__ int64_t pair_key(const AttrArgs& a, const T* ent,
                                            int64_t pos) {
  const int64_t row = min64(upper_bound(a.hdr_raw + 2, a.B, pos),
                          (int64_t)a.B - 1);
  return row * (int64_t(1) << 40) + floordiv((int64_t)ent[pos], a.m);
}

// keep flag of entry ``pos``; counts drops per row and the elision tallies
template <typename T>
__global__ void __launch_bounds__(NT)
attr_keep(AttrArgs a, const T* ent, int32_t* keep,
          unsigned long long* drops, unsigned long long* tallies) {
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (pos >= a.s) return;
  const int64_t total = a.hdr_raw[0];
  if (pos >= total) {
    keep[pos] = 0;
    return;
  }
  const int64_t code = (int64_t)ent[pos];
  const int64_t mq = (int64_t)a.m_t * a.m;
  const int64_t slot = max64(floordiv(code, mq), 0);
  const int64_t col =
      min64(max64(floordiv(floormod(code, mq), a.m), 0), a.m_t - 1);
  const int64_t row = min64(upper_bound(a.hdr_raw + 2, a.B, pos),
                          (int64_t)a.B - 1);
  const bool key_dep = a.dom[slot] == 0;
  const int32_t st = a.status[slot];
  const int64_t tok = a.tok ? a.tok[pos] : a.tlo[slot * a.m_t + col];
  const int64_t dm = a.dmsb[slot], dl = a.dlsb[slot];
  const int32_t dn = a.dnode[slot];
  bool keep_floor = true;
  if (a.floors) {
    const int64_t fi = upper_bound(a.fbnd, a.F, tok);
    keep_floor = !ts_lt(dm, dl, dn, a.fmsb[fi], a.flsb[fi], a.fnode[fi]);
  }
  const bool el_trans = st == SLOT_TRANSITIVE;
  bool el_dec = false;
  if (a.elide) {
    const int64_t seg = lower_bound(a.etok, a.T_len, tok);
    const int64_t seg_c = min64(seg, max64(a.T_len - 1, 0));
    const bool seg_ok = a.etok[seg_c] == tok;
    const int64_t base = a.eptr[seg_c];
    const int64_t cnt =
        lower_bound(a.erank, a.L, seg_c * a.estride[0] + a.rankb[row]) - base;
    const bool has_pivot = seg_ok && cnt > 0;
    const int64_t pidx = max64(base + cnt - 1, 0);
    const bool below = ts_lt(a.emsb[slot], a.elsb[slot], a.enode[slot],
                             a.exm[pidx], a.exl[pidx], a.exn[pidx]);
    const bool decided = st >= SLOT_COMMITTED && st <= SLOT_APPLIED &&
                         a.eknown[slot];
    el_dec = decided && has_pivot && below;
  }
  const bool firstp =
      pos == 0 || pair_key(a, ent, pos) != pair_key(a, ent, pos - 1);
  const bool drop_key = !keep_floor || el_trans || el_dec || !firstp;
  const bool k = !key_dep || !drop_key;
  keep[pos] = k ? 1 : 0;
  if (!k) atomicAdd(drops + row, 1ULL);
  if (key_dep && firstp && keep_floor) {
    if (el_trans) atomicAdd(tallies, 1ULL);
    else if (el_dec) atomicAdd(tallies + 1, 1ULL);
  }
}

// exclusive scan of keep within each block; block sums to ``bsum``
__global__ void __launch_bounds__(NT)
scan_blocks(const int32_t* keep, int64_t s, int32_t* local, long long* bsum) {
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int v = pos < s ? keep[pos] : 0;
  int tot;
  const int e = block_exclusive_scan<NT, int>(v, &tot);
  if (pos < s) local[pos] = e;
  if (threadIdx.x == 0) bsum[blockIdx.x] = tot;
}

// one block: exclusive scan of the block sums, in place
__global__ void __launch_bounds__(1024)
scan_sums(long long* bsum, int64_t nb) {
  long long run = 0;
  for (int64_t base = 0; base < nb; base += 1024) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < nb ? bsum[i] : 0;
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(v, &tot);
    if (i < nb) bsum[i] = run + e;
    run += tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
attr_write(const int32_t* keep, const int32_t* local, const long long* bsum,
           const T* ent, int64_t s, T* out) {
  const int64_t pos = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (pos < s && keep[pos]) out[bsum[blockIdx.x] + local[pos]] = ent[pos];
}

// one block: new_end = row_end - cumsum(drops) and the attributed header
__global__ void __launch_bounds__(1024)
attr_header(const int32_t* hdr_raw, const unsigned long long* drops,
            const unsigned long long* tallies, int B, int32_t* hdr) {
  long long run = 0;
  for (int base = 0; base < B; base += 1024) {
    const int b = base + threadIdx.x;
    const long long d = b < B ? (long long)drops[b] : 0;
    long long tot;
    const long long e = block_exclusive_scan<1024, long long>(d, &tot);
    if (b < B) hdr[5 + b] = (int32_t)((long long)hdr_raw[2 + b] - (run + e + d));
    run += tot;
  }
  if (threadIdx.x == 0) {
    hdr[0] = (int32_t)((long long)hdr_raw[2 + B - 1] - run);
    hdr[1] = hdr_raw[0];
    hdr[2] = hdr_raw[1];
    hdr[3] = (int32_t)tallies[0];
    hdr[4] = (int32_t)tallies[1];
  }
}

template <typename T>
int launch(void* const* p, const int64_t* v, cudaStream_t st) {
  AttrArgs a;
  a.tlo = (const int64_t*)p[0];
  a.dom = (const int32_t*)p[1];
  a.status = (const int32_t*)p[2];
  a.dmsb = (const int64_t*)p[3];
  a.dlsb = (const int64_t*)p[4];
  a.dnode = (const int32_t*)p[5];
  a.emsb = (const int64_t*)p[6];
  a.elsb = (const int64_t*)p[7];
  a.enode = (const int32_t*)p[8];
  a.eknown = (const uint8_t*)p[9];
  a.fbnd = (const int64_t*)p[10];
  a.fmsb = (const int64_t*)p[11];
  a.flsb = (const int64_t*)p[12];
  a.fnode = (const int32_t*)p[13];
  a.etok = (const int64_t*)p[14];
  a.eptr = (const int32_t*)p[15];
  a.erank = (const int64_t*)p[16];
  a.exm = (const int64_t*)p[17];
  a.exl = (const int64_t*)p[18];
  a.exn = (const int32_t*)p[19];
  a.estride = (const int64_t*)p[20];
  a.rankb = (const int64_t*)p[21];
  a.hdr_raw = (const int32_t*)p[22];
  const T* ent = (const T*)p[23];
  int32_t* keep = (int32_t*)p[24];
  int32_t* local = (int32_t*)p[25];
  long long* bsum = (long long*)p[26];
  unsigned long long* drops = (unsigned long long*)p[27];
  unsigned long long* tallies = (unsigned long long*)p[28];
  int32_t* hdr = (int32_t*)p[29];
  T* out = (T*)p[30];
  a.tok = (const int64_t*)p[31];
  a.s = v[0];
  a.B = (int)v[1];
  a.m_t = (int)v[2];
  a.m = (int)v[3];
  a.floors = (int)v[4];
  a.elide = (int)v[5];
  a.F = v[6];
  a.T_len = v[7];
  a.L = v[8];
  const int64_t nb = (a.s + NT - 1) / NT;
  cudaMemsetAsync(out, 0xff, (size_t)a.s * sizeof(T), st);
  cudaMemsetAsync(drops, 0, (size_t)a.B * sizeof(unsigned long long), st);
  cudaMemsetAsync(tallies, 0, 2 * sizeof(unsigned long long), st);
  if (nb > 0) {
    attr_keep<T><<<(unsigned)nb, NT, 0, st>>>(a, ent, keep, drops, tallies);
    scan_blocks<<<(unsigned)nb, NT, 0, st>>>(keep, a.s, local, bsum);
    scan_sums<<<1, 1024, 0, st>>>(bsum, nb);
    attr_write<T><<<(unsigned)nb, NT, 0, st>>>(keep, local, bsum, ent, a.s,
                                               out);
  }
  attr_header<<<1, 1024, 0, st>>>(a.hdr_raw, drops, tallies, a.B, hdr);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: tlo, dom, status, dmsb, dlsb, dnode, emsb, elsb, enode, eknown,
//       fbnd, fmsb, flsb, fnode, etok, eptr, erank, exm, exl, exn, estride,
//       rankb, hdr_raw, ent, keep[s], local[s], bsum[nb], drops[B],
//       tallies[2], hdr[5+B], out[s], tok[s] (null: gather lo[slot, col])
// vals: s, B, m_t, m, floors, elide, F, T, L, wide
ACCORD_EXPORT int accord_attr_post(void* const* p, const int64_t* v,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return v[9] ? launch<int64_t>(p, v, st) : launch<int32_t>(p, v, st);
}

namespace {

// tok[i*s + p]: the token lo[slot, col] of shard i's entry p, read from the
// slice that owns the slot when that slice is on this device (lo_refs[o]
// non-null), else 0 — one device's contribution to the cross-slice sum
template <typename T>
__global__ void __launch_bounds__(NT)
attr_tok(const uint64_t* ent_refs, const uint64_t* lo_refs, int64_t d,
         int64_t s, int64_t sn, int m_t, int m, int64_t* tok) {
  const int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t i = blockIdx.y;
  if (p >= s) return;
  const int64_t code = (int64_t)((const T*)ent_refs[i])[p];
  const int64_t mq = (int64_t)m_t * m;
  const int64_t slot = max64(floordiv(code, mq), 0);
  const int64_t col = min64(max64(floordiv(floormod(code, mq), m), 0),
                            m_t - 1);
  const int64_t owner = slot / sn;
  int64_t t = 0;
  if (code >= 0 && owner < d && lo_refs[owner])
    t = ((const int64_t*)lo_refs[owner])[(slot - owner * sn) * m_t + col];
  tok[i * s + p] = t;
}

}  // namespace

// ptrs: ent_refs uint64[d] (shard i's entries[s]), lo_refs uint64[d] (slice
//       o's lo[sn*m_t] on this device, or 0), tok int64[d*s]
// vals: d, s, sn, m_t, m, wide
ACCORD_EXPORT int accord_attr_tok(void* const* p, const int64_t* v,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t d = v[0], s = v[1];
  if (d > 0 && s > 0) {
    const dim3 grid((unsigned)((s + NT - 1) / NT), (unsigned)d);
    if (v[5])
      attr_tok<int64_t><<<grid, NT, 0, st>>>(
          (const uint64_t*)p[0], (const uint64_t*)p[1], d, s, v[2],
          (int)v[3], (int)v[4], (int64_t*)p[2]);
    else
      attr_tok<int32_t><<<grid, NT, 0, st>>>(
          (const uint64_t*)p[0], (const uint64_t*)p[1], d, s, v[2],
          (int)v[3], (int)v[4], (int64_t*)p[2]);
  }
  return (int)cudaGetLastError();
}
