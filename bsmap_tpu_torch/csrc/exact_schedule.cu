// K2 exact_schedule: the exact (reference-order) seed schedule.
//
// Replaces bsmap_tpu/engine/device_engine.py:_schedule_impl (:404-672) for
// one chain or both (`mode` 0 forward, 1 rc, 2 both, -n 1; the rc chain's
// words are K5's rows: `rows` under mode 1, `rows_rc` under mode 2):
// chain_schedule (:445-550) per chain, slot_desc (:574-632) per chain, the
// slots interleaved in (rank, chain, phase) order (:638-645), and the
// per-rank totals over both chains (:649-664).  With `probe` set it writes
// only the per-rank totals, the stage-1-only pre-pass of probe mode
// (:1186-1191).  With `rrbs` set each chain runs the RRBS branches instead
// (the one-probe-per-segment order below).  Under index sharding (`gcnt`
// given) the table is one region shard's, with the shard's local counts in
// .y (the slot counts, :630-632), and the schedule costs come from the
// global bucket totals `gcnt` (column 1 of the JAX shard table, :448-463),
// so every shard computes the same schedule.
//
// Per read and chain (ReorderSeed / AdjustSeedStartArray / seedindex,
// align.cpp:454-577): bucket cost cnt+2 at each of P seed positions, the
// CountSeeds sliding-window sums as differences of one wrapping uint32
// prefix sum (bit32_t in the reference), the first-minimum start offset,
// maxseg zig-zag refinement steps and the stable signed-cost segment
// order; then the NB slot rows from kmer_tab at the chosen positions.  The
// forward chain's start offset goes to `soff`, the rc chain's to `coff`
// (:665-670), 0 for an absent chain.
//
// Bound on the card: P 4-byte gathers from the 689 MB kmer_tab plus
// maxseg*I 16-byte row gathers per read and chain, each its own 32-byte
// sector, with little arithmetic between them: the latency of dependent
// gathers, not bytes, unless many are in flight.  What the design does
// about it: a group of G lanes per read (`group`: 32, a warp, or 16, two
// reads a warp; under `rrbs`, whose schedule is one probe per segment, as
// few as 4 lanes, G >= maxseg), the chains one after the other.
//
//  * The lanes compute the seeds of positions 0..L-1 and start all their
//    cost gathers before anything consumes one: G independent sectors in
//    flight per group and round where a thread per read had one.
//  * The prefix sums live in the group's slice of shared memory (cs[0 ..
//    WLEN], at most 273 words), written by a wrapping uint32 shuffle scan
//    with a carry between rounds.  uint32 adds wrap and associate, so cs
//    is what a sequential sum gives.  No local-memory stack.
//  * The minima run across lanes, lane = start offset (S <= 16 <= G): the
//    window sums of one offset in one lane, then a shuffle arg-min on
//    (value, offset) that keeps the lowest offset on ties, which is the
//    reference's first minimum (an offset out of range counts 0xFFFFFFFF
//    and offset 0 seeds the minimum).  The zig-zag steps stay sequential;
//    lane n keeps start[n] in a register and neighbours come by shuffle.
//  * The stable segment order is a rank count across lanes: rank(n) =
//    #{key_j < key_n} + #{j < n, key_j == key_n}, which is where a stable
//    insertion sort puts n.
//  * Slot (rank j, phase i) of a chain belongs to lane j*I + i (rounds of
//    G): it gathers its own kmer_tab row or tag_off pair and writes its own
//    h/off0/off3/wcnt/cnt element, neighbouring lanes on neighbouring
//    addresses.  The per-rank sums of clamped counts are shared-memory
//    atomic adds (uint32 adds commute), closed by a shuffle prefix sum
//    over the ranks.
//
// Every shuffle is executed by all 32 lanes of a warp: loop bounds depend
// only on the configuration, per-read quantities (seedseg, max_off) only
// predicate values, and a group past the last read recomputes the last
// read with its stores masked.

#include "common.cuh"

#define BSM_K2_THREADS 128
#define BSM_BIG 0xFFFFFFFFu
#define BSM_FULL 0xFFFFFFFFu

struct BsmK2 {
  const int* rows;
  const int* rows_rc;
  int m, nw;
  const int4* kmer_tab;
  const int* prof_a;
  int S, I, MS, P, mode, probe, rrbs;
  const int* tag_off;
  long long ntag;
  const int* gcnt;
  int* h;
  int* off0;
  int* off3;
  int* wcnt;
  int* cnt;
  int* soff;
  int* coff;
  int* ftot;
};

// One read's slice of shared memory (no prefix sums under RRBS).
template <bool RRBS>
struct BsmK2Group {
  // cs[t] = sum of cost[0 .. t-1], wrapping
  uint32_t cs[RRBS ? 1 : BSM_MAX_WLEN + 1];
  int row[2][BSM_MAX_NW];          // each chain's packed read words
  uint32_t rs[BSM_MAX_MS];         // per-rank sums of clamped counts
};

// Lowest lane of the group holding the smallest v.
template <int G>
static __device__ __forceinline__ int bsm_argmin(uint32_t v, int gl) {
  unsigned long long key = ((unsigned long long)v << 32) | (unsigned)gl;
  for (int o = G / 2; o > 0; o >>= 1) {
    unsigned long long other = __shfl_xor_sync(BSM_FULL, key, o, G);
    key = other < key ? other : key;
  }
  return (int)(key & 0xFFFFFFFFull);
}

// Lane j's value becomes the segment id of rank j under a stable ascending
// order of the keys of lanes 0 .. MS-1.
template <int G>
static __device__ __forceinline__ int bsm_order_by_rank(uint32_t key, int MS,
                                                        int gl) {
  int rank = 0;
  for (int j = 0; j < MS; ++j) {
    const uint32_t kj = __shfl_sync(BSM_FULL, key, j, G);
    rank += (kj < key || (kj == key && j < gl)) ? 1 : 0;
  }
  int order = 0;
  for (int n = 0; n < MS; ++n) {
    const int rn = __shfl_sync(BSM_FULL, rank, n, G);
    if (rn == gl) order = n;
  }
  return order;
}

// T(n, off) = CountSeeds of segment n at start offset off
#define BSM_T(n, off) (sh.cs[(n) * S + (off) + I] - sh.cs[(n) * S + (off)])

// chain_schedule of one WGBS chain.  Returns the chosen start offset to
// every lane; lane n (< MS) gets start[n] and the segment id of rank n.
template <int G>
static __device__ int bsm_exact_chain(const BsmK2& P, BsmK2Group<false>& sh,
                                      int c,
                                      int gl, int len, int seedseg,
                                      int* start_o, int* order_o) {
  const int S = P.S, I = P.I, MS = P.MS;
  const int WLEN = MS * S + I;
  const int L = min(P.P, WLEN);
  // every cost gather of the chain is in flight before the scan needs one
  constexpr int RL = (BSM_MAX_P + G - 1) / G;
  constexpr int RW = (BSM_MAX_WLEN + G - 1) / G;
  uint32_t cost[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const int p = r * G + gl;
    uint32_t cv = 0;
    if (p < L) {
      const int sv = bsm_seed_at(sh.row[c], P.nw, S, p);
      const int cn = P.gcnt ? __ldg(&P.gcnt[sv]) : __ldg(&P.kmer_tab[sv].y);
      cv = cn > 0 ? (uint32_t)(cn + 2) : 0u;
    }
    cost[r] = cv;
  }
  uint32_t carry = 0;
  if (gl == 0) sh.cs[0] = 0;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r * G < WLEN) {                      // the same in every lane
      uint32_t x = r < RL ? cost[r < RL ? r : 0] : 0u;
      for (int o = 1; o < G; o <<= 1) {
        const uint32_t y = __shfl_up_sync(BSM_FULL, x, o, G);
        if (gl >= o) x += y;
      }
      x += carry;
      if (r * G + gl < WLEN) sh.cs[r * G + gl + 1] = x;
      carry = __shfl_sync(BSM_FULL, x, G - 1, G);
    }
  }
  __syncwarp();

  // the first-minimum start offset over offsets < max_off
  const int max_off = bsm_floormod(len - I + 1, S);
  uint32_t v = BSM_BIG;
  if (gl < S && gl < max_off) {
    uint32_t t = 0;
    for (int n = 0; n < seedseg; ++n) t += BSM_T(n, gl);
    v = t;
  }
  const int first = bsm_argmin<G>(v, gl);
  const int s_off = max_off > 0 ? first : 0;

  // zig-zag per-segment refinement (align.cpp:506-547); lane n holds
  // start[n]
  int start = s_off;
  for (int it = 0; it < MS; ++it) {
    const int half = it / 2;
    const int ptr = (it % 2 == 0) ? half : seedseg - 1 - half;
    const int pc = bsm_clampi(ptr, 0, MS - 1);
    const int prev = __shfl_sync(BSM_FULL, start,
                                 bsm_clampi(pc - 1, 0, MS - 1), G);
    const int nxt = __shfl_sync(BSM_FULL, start,
                                bsm_clampi(pc + 1, 0, MS - 1), G);
    const int lo = pc == 0 ? 0 : prev;
    const int hi = pc == seedseg - 1 ? max_off : nxt;
    const uint32_t w = (gl < S && gl >= lo && gl <= hi) ? BSM_T(pc, gl)
                                                        : BSM_BIG;
    const int best = bsm_argmin<G>(w, gl);
    if (it < seedseg && gl == pc) start = best;
  }
  // segment order: stable ascending on (cost as signed int32), unused
  // segments last (key 0xFFFFFFFF)
  const uint32_t key = (gl < MS && gl < seedseg)
                           ? (BSM_T(gl, start) ^ 0x80000000u) : BSM_BIG;
  *order_o = bsm_order_by_rank<G>(key, MS, gl);
  *start_o = start;
  return s_off;
}

// The RRBS order of one chain (chain_schedule :464-478): one probed
// position per segment at start offset 0, shifted by `koff` (len % S on the
// rc chain, :552-562), segments in a stable order of the RAW bucket count
// (signed).  Lane n (< MS) gets the segment id of rank n.
template <int G>
static __device__ int bsm_rrbs_order(const BsmK2& P,
                                     const BsmK2Group<true>& sh, int c,
                                     int gl, int koff, int seedseg) {
  uint32_t key = BSM_BIG;
  if (gl < P.MS) {
    const int pos = bsm_clampi(__ldg(&P.prof_a[gl * P.I]) + koff, 0, P.P - 1);
    const int cn = __ldg(&P.kmer_tab[bsm_seed_at(sh.row[c], P.nw, P.S,
                                                 pos)].y);
    if (gl < seedseg) key = (uint32_t)cn ^ 0x80000000u;
  }
  return bsm_order_by_rank<G>(key, P.MS, gl);
}

// The order and, outside RRBS, the start offsets of chain c.
template <int G>
static __device__ __forceinline__ int bsm_chain(
    const BsmK2& P, BsmK2Group<true>& sh, int c, int gl, int len, int koff,
    int seedseg, int* start_o, int* order_o) {
  *start_o = 0;
  *order_o = bsm_rrbs_order<G>(P, sh, c, gl, koff, seedseg);
  return 0;
}

template <int G>
static __device__ __forceinline__ int bsm_chain(
    const BsmK2& P, BsmK2Group<false>& sh, int c, int gl, int len, int koff,
    int seedseg, int* start_o, int* order_o) {
  const int s_off = bsm_exact_chain<G>(P, sh, c, gl, len, seedseg, start_o,
                                       order_o);
  __syncwarp();                            // cs is reused by the next chain
  return s_off;
}

template <int G, bool RRBS>
__global__ void __launch_bounds__(BSM_K2_THREADS)
bsm_exact_schedule_kernel(const BsmK2 P) {
  __shared__ BsmK2Group<RRBS> groups[BSM_K2_THREADS / G];
  const int gl = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  BsmK2Group<RRBS>& sh = groups[grp];
  const int b_raw = blockIdx.x * (BSM_K2_THREADS / G) + grp;
  const bool valid = b_raw < P.m;
  const int b = valid ? b_raw : P.m - 1;   // whole warps stay alive
  const int S = P.S, I = P.I, MS = P.MS, nw = P.nw;
  const int nch = P.mode == 2 ? 2 : 1;
  const int width = 2 * nw + 4;
  const int NB = MS * nch * I;
  const int* row0 = P.rows + (size_t)b * width;
  const int len = __ldg(&row0[2 * nw]), bud = __ldg(&row0[2 * nw + 1]);
  const int maxrank = __ldg(&row0[2 * nw + 3]);
  const int seedseg = bsm_seedseg(len, bud, S, I, MS);
  for (int k = gl; k < nw; k += G) {
    sh.row[0][k] = __ldg(&row0[k]);
    if (nch == 2) sh.row[1][k] = __ldg(&P.rows_rc[(size_t)b * width + k]);
  }
  if (gl < MS) sh.rs[gl] = 0;
  __syncwarp();

  // per chain: is it the rc chain, its RRBS probe shift, its schedule
  int is_rc[2] = {0, 0}, koff[2] = {0, 0}, s_off[2] = {0, 0};
  int start[2] = {0, 0}, order[2] = {0, 0};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c < nch) {
      is_rc[c] = P.mode == 1 || c == 1;
      koff[c] = RRBS && is_rc[c] ? bsm_floormod(len, S) : 0;
      s_off[c] = bsm_chain<G>(P, sh, c, gl, len, koff[c], seedseg, &start[c],
                              &order[c]);
    }
  }
  long long J2 = 0;
  if (RRBS) {
    long long p3 = 1;
    for (int j = 0; j < S; ++j) p3 *= 3;
    J2 = (P.ntag - 1) / p3;
  }
  if (!P.probe && valid && gl == 0) {
    P.soff[b] = P.mode == 1 ? 0 : s_off[0];
    P.coff[b] = P.mode == 0 ? 0 : (nch == 2 ? s_off[1] : s_off[0]);
  }

  // the slot rows: lane (j, i) of each chain
  const int nslot = MS * I;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c < nch) {
      for (int base = 0; base < nslot; base += G) {
        const int idx = base + gl;
        const bool on = idx < nslot;
        const int j = on ? idx / I : 0;
        const int i = idx - j * I;
        const int seg = __shfl_sync(BSM_FULL, order[c], j, G);
        const int st = __shfl_sync(BSM_FULL, start[c], seg, G);
        if (!on) continue;
        const int a = __ldg(&P.prof_a[seg * I + i]);
        const int k = a + st - i + koff[c];
        const int kc = bsm_clampi(k, 0, P.P - 1);
        const bool fresh = k >= 0 && k <= len - S;
        const int sv = bsm_seed_at(sh.row[c], nw, S, kc);
        int off0, off3 = 0, wcnt = 0, cn;
        if (RRBS) {
          // the probed (segment, strand) class (slot_desc :596-609): the
          // rc chain counts segments from the read's other end
          const int want = is_rc[c] ? len / S - 1 - seg : seg;
          long long ix = (long long)sv * J2 + 2 * want + is_rc[c];
          ix = ix < 0 ? 0 : (ix > P.ntag - 2 ? P.ntag - 2 : ix);
          off0 = __ldg(&P.tag_off[ix]);
          const bool ok = fresh && want >= 0 && 2 * want + 1 < J2;
          cn = ok ? __ldg(&P.tag_off[ix + 1]) - off0 : 0;
        } else {
          const int4 r = __ldg(&P.kmer_tab[sv]);
          off0 = r.x;
          off3 = r.w;
          wcnt = r.z;
          cn = fresh ? r.y : 0;
        }
        // counts of ranks >= seedseg are zeroed, the clamped counts go
        // into the rank's sum, counts of ranks > maxrank are zeroed in the
        // output (device_engine.py:425-437, :649-664)
        const int full = j < seedseg ? cn : 0;
        const uint32_t cl = (uint32_t)full;
        atomicAdd(&sh.rs[j], cl < (uint32_t)BSM_FTOT_CLAMP
                                 ? cl : (uint32_t)BSM_FTOT_CLAMP);
        if (!P.probe && valid) {
          const size_t o = (size_t)b * NB + (j * nch + c) * I + i;
          P.h[o] = -a + i - st - koff[c];
          P.off0[o] = off0;
          P.wcnt[o] = wcnt;
          P.off3[o] = off3;
          P.cnt[o] = j <= maxrank ? full : 0;
        }
      }
    }
  }
  __syncwarp();
  // per-rank cumulative totals: an int32 wrapping prefix sum over the
  // ranks, each clamped on output
  uint32_t cum = gl < MS ? sh.rs[gl] : 0u;
  for (int o = 1; o < G; o <<= 1) {
    const uint32_t y = __shfl_up_sync(BSM_FULL, cum, o, G);
    if (gl >= o) cum += y;
  }
  if (valid && gl < MS)
    P.ftot[(size_t)b * MS + gl] = min((int)cum, BSM_FTOT_CLAMP);
}
#undef BSM_T

template <int G, bool RRBS>
static void bsm_k2_launch(const BsmK2& K, cudaStream_t stream) {
  const int per = BSM_K2_THREADS / G;
  bsm_exact_schedule_kernel<G, RRBS>
      <<<(K.m + per - 1) / per, BSM_K2_THREADS, 0, stream>>>(K);
}

// `group`: lanes per read.  WGBS: 32 or 16 (the arg-min lanes are the S <=
// 16 start offsets); RRBS: 4, 8 or 16, at least maxseg.
extern "C" int bsmap_exact_schedule(const int* rows, const int* rows_rc,
                                    int m, int nw, const int* kmer_tab,
                                    const int* prof_a, int S, int I, int MS,
                                    int P, int mode, int probe, int rrbs,
                                    const int* tag_off, long long ntag,
                                    const int* gcnt, int* h, int* off0,
                                    int* off3, int* wcnt, int* cnt,
                                    int* soff, int* coff, int* ftot,
                                    int group, cudaStream_t stream) {
  if (mode == 2 && rows_rc == nullptr) return (int)cudaErrorInvalidValue;
  const bool ok = rrbs ? (group == 4 || group == 8 || group == 16) &&
                             group >= MS
                       : group == 16 || group == 32;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const BsmK2 K = {rows, rows_rc, m, nw,
                     reinterpret_cast<const int4*>(kmer_tab), prof_a, S, I,
                     MS, P, mode, probe, rrbs, tag_off, ntag, gcnt, h, off0,
                     off3, wcnt, cnt, soff, coff, ftot};
    if (!rrbs && group == 32) bsm_k2_launch<32, false>(K, stream);
    else if (!rrbs) bsm_k2_launch<16, false>(K, stream);
    else if (group == 4) bsm_k2_launch<4, true>(K, stream);
    else if (group == 8) bsm_k2_launch<8, true>(K, stream);
    else bsm_k2_launch<16, true>(K, stream);
  }
  return (int)cudaGetLastError();
}
