// K1 fixed_schedule: fixed-schedule stage 1 of the SE alignment program.
//
// Replaces bsmap_tpu/engine/device_engine.py:_fixed_schedule_impl (:350)
// and the fixed branch of _schedule_impl (:421-439), one chain or both
// (nch = 2, -n 1: the forward rows and K5's rc rows, `rows_rc`).
//
// Per read and chain: seed values at the maxseg*I static pigeonhole offsets
// k = ceil((n*S + i)/I)*I - i (param.cpp:85-93) in that chain's words, one
// kmer_tab row per offset, the maxseg segment costs (fresh probes only,
// wrapping int32 sums) in a stable cheapest-first order per chain
// (jnp.argsort(stable=True), :384-388), then the NB = maxseg*nch*I slot
// rows in (rank, chain, phase) order with the per-rank totals summed over
// both chains; s_off and c_off are 0.
//
// Bound on the card: one random 16-byte kmer_tab gather per slot (the
// 3^S-row table is 689 MB at S=16, far beyond L2) and 20 bytes of slot
// output per slot; everything else is register arithmetic.  The gathers
// are independent of each other, so what limits a kernel that issues them
// one at a time is their latency, not the bytes.  What the design does
// about it: a group of G lanes per read (`group`: 16, two reads a warp,
// where NB <= 16; else 32, a warp a read), one lane per slot (rounds of G
// when NB > G, R rounds held in registers, R a template bound).
//
//  * Slot s = (n*nch + c)*I + i (segment n, chain c, phase i) belongs to
//    lane s % G of round s / G.  Each lane computes its seed and issues
//    its gather for every round before anything consumes one: G*R loads in
//    flight per group where a thread per read had one.  The 16-byte row
//    stays in registers; nothing is gathered twice.
//  * Segment costs: the wrapping uint32 sum over the I phases of (n, c),
//    read as int32.  Where I is a power of two a segment's I lanes are an
//    aligned run of one round and sum by xor shuffles; otherwise (-I 3)
//    the lanes add into the group's shared cost table with atomics.
//  * The stable order is a rank: rank(n, c) = #{n' : cost(n', c) <
//    cost(n, c), or equal with n' < n}, which is where a stable sort puts
//    n; each lane counts it over the MS costs of its chain in shared
//    memory.  No insertion sort, no run-time indexed local arrays: ptxas
//    reports no stack.
//  * Lane s writes its words to ((rank*nch + c)*I + i) of its read: the
//    NB words of a read are one contiguous run written by one round's
//    lanes (a permutation inside it), so the stores coalesce.
//  * Per-rank totals (device_engine.py:425-437): counts of ranks >=
//    seedseg are zeroed, the clamped counts go into the rank's
//    sum (uint32 shared-memory atomics; adds commute and wrap), a shuffle
//    scan over the MS ranks gives the cumulative totals, each clamped to
//    2^27 on output; counts of ranks > maxrank are zeroed in the output.
//
// Every shuffle is executed by all 32 lanes of a warp: loop bounds depend
// only on the configuration, and a group past the last read recomputes the
// last read with its stores masked.

#include "common.cuh"

#define BSM_K1_THREADS 128
#define BSM_FULL 0xFFFFFFFFu

static __device__ __forceinline__ int bsm_fixed_k(int n, int i, int S,
                                                  int I) {
  return ((n * S + i + I - 1) / I) * I - i;
}

struct BsmK1 {
  const int* rows;
  const int* rows_rc;
  int m, nw;
  const int4* kmer_tab;
  int S, I, MS, nch;
  int* h;
  int* off0;
  int* off3;
  int* wcnt;
  int* cnt;
  int* soff;
  int* coff;
  int* ftot;
};

// One read's slice of shared memory.
struct BsmK1Group {
  uint32_t cost[2 * BSM_MAX_MS];   // natural segment n*nch + c -> its cost
  uint32_t rs[BSM_MAX_MS];         // per-rank sums of clamped counts
};

template <int G, int R>
__global__ void __launch_bounds__(BSM_K1_THREADS)
bsm_fixed_schedule_kernel(const BsmK1 P) {
  __shared__ BsmK1Group groups[BSM_K1_THREADS / G];
  const int gl = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  BsmK1Group& sh = groups[grp];
  const int b_raw = blockIdx.x * (BSM_K1_THREADS / G) + grp;
  const bool valid = b_raw < P.m;
  const int b = valid ? b_raw : P.m - 1;   // whole warps stay alive
  const int S = P.S, I = P.I, MS = P.MS, nch = P.nch, nw = P.nw;
  const int NB = MS * nch * I;
  const int* row0 = P.rows + (size_t)b * (2 * nw + 4);
  const int* row1 = nch == 2 ? P.rows_rc + (size_t)b * (2 * nw + 4) : row0;
  const int len = __ldg(&row0[2 * nw]), bud = __ldg(&row0[2 * nw + 1]);
  const int maxrank = __ldg(&row0[2 * nw + 3]);
  const int seedseg = bsm_seedseg(len, bud, S, I, MS);
  const bool pow2 = (I & (I - 1)) == 0;
  if (gl < MS) sh.rs[gl] = 0;
  if (!pow2)
    for (int t = gl; t < MS * nch; t += G) sh.cost[t] = 0;

  // every slot's kmer_tab row, all gathers in flight before any is used;
  // a probe past len - S is not fresh and counts 0
  int4 tab[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * G + gl;
    tab[r] = make_int4(0, 0, 0, 0);
    if (s < NB) {
      const int seg = s / I, i = s - seg * I;
      const int n = seg / nch, c = seg - n * nch;
      const int k = bsm_fixed_k(n, i, S, I);
      tab[r] = __ldg(&P.kmer_tab[bsm_seed_at(c ? row1 : row0, nw, S, k)]);
      if (k > len - S) tab[r].y = 0;
    }
  }
  __syncwarp();

  // segment costs into the group's cost table
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * G + gl;
    uint32_t v = s < NB ? (uint32_t)tab[r].y : 0u;
    if (pow2) {
      for (int o = 1; o < I; o <<= 1) v += __shfl_xor_sync(BSM_FULL, v, o);
      if (s < NB && (s & (I - 1)) == 0) sh.cost[s / I] = v;
    } else if (s < NB) {
      atomicAdd(&sh.cost[s / I], v);
    }
  }
  __syncwarp();

  // each slot's rank, its stores, its clamped count into the rank's sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = r * G + gl;
    if (s < NB) {
      const int seg = s / I, i = s - seg * I;
      const int n = seg / nch, c = seg - n * nch;
      const int mine = (int)sh.cost[seg];
      int rank = 0;
      for (int n2 = 0; n2 < MS; ++n2) {
        const int o = (int)sh.cost[n2 * nch + c];
        rank += (o < mine || (o == mine && n2 < n)) ? 1 : 0;
      }
      const int full = rank < seedseg ? tab[r].y : 0;
      const uint32_t cl = (uint32_t)full;
      atomicAdd(&sh.rs[rank], cl < (uint32_t)BSM_FTOT_CLAMP
                                  ? cl : (uint32_t)BSM_FTOT_CLAMP);
      if (valid) {
        const size_t o = (size_t)b * NB + (rank * nch + c) * I + i;
        P.h[o] = -bsm_fixed_k(n, i, S, I);
        P.off0[o] = tab[r].x;
        P.wcnt[o] = tab[r].z;
        P.off3[o] = tab[r].w;
        P.cnt[o] = rank <= maxrank ? full : 0;
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
  if (valid && gl == 0) {
    P.soff[b] = 0;
    P.coff[b] = 0;
  }
}

template <int G, int R>
static void bsm_k1_launch(const BsmK1& K, cudaStream_t stream) {
  const int per = BSM_K1_THREADS / G;
  bsm_fixed_schedule_kernel<G, R>
      <<<(K.m + per - 1) / per, BSM_K1_THREADS, 0, stream>>>(K);
}

// The launch for G lanes a read: R, the rounds held in registers, is the
// least of 1, 2, 4, 8 and 16 that covers NB; false past 16 rounds.
template <int G>
static bool bsm_k1_rounds(const BsmK1& K, int NB, cudaStream_t stream) {
  const int rounds = (NB + G - 1) / G;
  if (rounds <= 1) bsm_k1_launch<G, 1>(K, stream);
  else if (rounds <= 2) bsm_k1_launch<G, 2>(K, stream);
  else if (rounds <= 4) bsm_k1_launch<G, 4>(K, stream);
  else if (rounds <= 8) bsm_k1_launch<G, 8>(K, stream);
  else if (rounds <= 16) bsm_k1_launch<G, 16>(K, stream);
  else return false;
  return true;
}

// `group`: lanes per read, 16 or 32 (16 lanes hold at most 256 slots).
extern "C" int bsmap_fixed_schedule(const int* rows, const int* rows_rc,
                                    int m, int nw, const int* kmer_tab, int S,
                                    int I, int MS, int nch, int* h, int* off0,
                                    int* off3, int* wcnt, int* cnt,
                                    int* soff, int* coff, int* ftot,
                                    int group, cudaStream_t stream) {
  if (nch == 2 && rows_rc == nullptr) return (int)cudaErrorInvalidValue;
  if (group != 16 && group != 32) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const BsmK1 K = {rows, rows_rc, m, nw,
                     reinterpret_cast<const int4*>(kmer_tab), S, I, MS, nch,
                     h, off0, off3, wcnt, cnt, soff, coff, ftot};
    const int NB = MS * nch * I;
    const bool ok = group == 16 ? bsm_k1_rounds<16>(K, NB, stream)
                                : bsm_k1_rounds<32>(K, NB, stream);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
