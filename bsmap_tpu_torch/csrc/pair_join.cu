// K6 pair_join: the K x K pair join of both mates' compacted hits.
//
// Replaces bsmap_tpu/engine/pair_device.py:_device_pair_join (:73-195),
// GetPairs (pairs.cpp:34-135) as a join: for every combo (k, l) of mate-1
// hit k and mate-2 hit l, eligibility (valid, opposite chains, same
// chromosome, both hits available at step max(na, nb), within budgets,
// insert within [min_ins, max_ins]); the winning step i* = min max(na, nb),
// the winning total, the winning set F, its count, and the reference's
// sweep order as a key (combo, chain, each mate's (chr, loc)-sorted rank,
// combo index k*K + l in the low 8 bits); the myrand-j-th smallest F key
// picks the pair.  Each mate's unpaired fallback pick is the jj-th hit of a
// stable sort by (chain, chr, loc) of its best-level hits (SortHits4PE,
// pairs.cpp:258-271).  Output: the 11 J_* columns (pair_device.py:63-70).
//
// Bound on the card: per pair, the 2K hit words and six extras of each
// mate's full row, three words of each dispatch row and the 44-byte output;
// the operations are the live combos (valid hit x valid hit: about one on
// clean data, at most K*K) and the rank loops over each mate's hits.  The
// work per pair is small and data-dependent, so instruction issue, not
// bytes, is what a design pays for.  What this one does about it: a warp
// per pair, 8 pairs per 256-thread block, no block barrier, no shared
// memory, and loops only over valid hits and live combos.
//
//  * Lane l < K holds mate 1's hit l and lane 16 + l mate 2's (K <= 16):
//    each mate's loc and w1 columns come in with one coalesced load each.
//  * The (chr, loc) rank within (level, chain) and the position in the
//    stable (chain, chr, loc, lane) order of the best-level hits are
//    shuffle loops inside each half-warp over the lanes that hold a valid
//    hit in either mate (about one on clean data, K at most): an invalid
//    hit counts in no rank, and a hit that is not best-level sorts after
//    every best one in lane order, so its position is two popcounts of
//    ballots.  The unpaired pick is the lane whose position is jj (a
//    ballot), hit 0 when jj >= K.
//  * The valid hits are two ballots; the lanes stride over the na x nb
//    combos of valid hits only (any layout: the a-th set bit of the mask,
//    not a prefix) and fetch each combo's hits by shuffle.
//  * i* and the winning total are one __reduce_min_sync of (max(na, nb)
//    << 6 | na + nb), the lexicographic minimum; F is "equal to it", cnt
//    the sum of __popc over the F ballots.
//  * Keys are unique (the combo index in the low bits), so the j-th
//    smallest F key is the F key with exactly j smaller F keys: each F key
//    is broadcast by shuffle and every lane counts it against its own.
//  * Lanes 0-10 write the 11 J_* words as one store.
//
// Edges kept from the JAX gathers: a pair index past K clamps to K - 1 (no
// pair: the key BIGJ gives 0xFF); an unpaired draw jj >= K takes hit 0;
// the outputs read hit K - 1 or hit 0 even when that hit is invalid; the
// insert wraps as int32; min(cnt, 2047) and cnt >= max_hits.

#include "common.cuh"

#define BSM_MAX_K 16
#define BSM_K6_THREADS 256
#define BSM_K6_ROUNDS (BSM_MAX_K * BSM_MAX_K / 32)   // combo rounds a lane
#define BSM_BIGJ 0x3FFFFFFF
#define BSM_FULL 0xFFFFFFFFu
// full-row extras (engine/kernels.py X_*)
#define BSM_X_FOUND 0
#define BSM_X_II 1
#define BSM_X_SSUM 2
#define BSM_X_REPLAY 9
#define BSM_X_OK 13
#define BSM_X_FTOT 16

struct BsmHit {
  int loc, w, ch, rk, cp;
  bool v;
  __device__ BsmHit(int loc_, int w1) {
    loc = loc_;
    w = w1 & 15;                 // arithmetic shifts: w1 = -1 (empty) gives
    ch = (w1 >> 4) & 1;          // w 15, ch 1, rk 15, cp 0xFFFF like the
    rk = (w1 >> 5) & 15;         // JAX int32 decode (:93-94)
    cp = (w1 >> 9) & 0xFFFF;
    v = w1 >= 0;
  }
};

static __device__ __forceinline__ int bsm_insert(const BsmHit& a,
                                                 const BsmHit& b, int la,
                                                 int lb) {
  // int32 wrap, like the JAX program (:106-109)
  const bool a_end_form = (a.cp & 1) != a.ch;
  return a_end_form ? (int)((uint32_t)a.loc + (uint32_t)la - (uint32_t)b.loc)
                    : (int)((uint32_t)b.loc + (uint32_t)lb - (uint32_t)a.loc);
}

// The lane of the a-th set bit of mask (a < popc(mask)).
static __device__ __forceinline__ int bsm_nth_bit(unsigned mask, int a) {
  for (int q = 0; q < a; ++q) mask &= mask - 1;
  return __ffs(mask) - 1;
}

__global__ void __launch_bounds__(BSM_K6_THREADS)
bsm_pair_join_kernel(const int* __restrict__ rows_a,
                     const int* __restrict__ rows_b, int n, int MS, int K,
                     const int* __restrict__ in_a,
                     const int* __restrict__ in_b, int nw, int min_ins,
                     int max_ins, int max_hits, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (BSM_K6_THREADS / 32) + (threadIdx.x >> 5);
  if (p >= n) return;                            // the whole warp
  const int base = 2 * MS + 17, width = base + 2 * K, iw = 2 * nw + 4;
  const int mate = lane >> 4, k = lane & 15;
  const int* row = (mate ? rows_b : rows_a) + (size_t)p * width;
  const int* in = (mate ? in_b : in_a) + (size_t)p * iw;
  // this lane's hit (an empty one past K) and its mate's extras and scalars
  int loc = 0, w1 = -1;
  if (k < K) {
    loc = __ldg(&row[base + k]);
    w1 = __ldg(&row[base + K + k]);
  }
  const int* x = row + 2 * MS;
  const int found = __ldg(&x[BSM_X_FOUND]), ii = __ldg(&x[BSM_X_II]);
  const int ssum = __ldg(&x[BSM_X_SSUM]), replay = __ldg(&x[BSM_X_REPLAY]);
  const int okm = __ldg(&x[BSM_X_OK]), ftot = __ldg(&x[BSM_X_FTOT]);
  const int len = __ldg(&in[2 * nw]), bud = __ldg(&in[2 * nw + 1]);
  const uint32_t rnd = (uint32_t)__ldg(&in[2 * nw + 2]);

  // the hit's (chr, loc) rank within its (level, chain) list, and its
  // position in the stable (chain, chr, loc, lane) order of the best-level
  // hits (keys of 0x7FFFFFFF for the others, pair_device.py:163-167)
  const BsmHit h(loc, w1);
  const bool best = h.v && h.w == ii;
  const unsigned valid = __ballot_sync(BSM_FULL, k < K && h.v);
  const unsigned bests = __ballot_sync(BSM_FULL, k < K && best) >>
                         (16 * mate) & 0xFFFFu;
  int rank = 0;
  uint32_t pos = 0;
  for (unsigned mm = (valid | valid >> 16) & 0xFFFFu; mm; mm &= mm - 1) {
    const int t = __ffs(mm) - 1;
    const BsmHit g(__shfl_sync(BSM_FULL, loc, t, 16),
                   __shfl_sync(BSM_FULL, w1, t, 16));
    rank += h.v && g.v && g.w == h.w && g.ch == h.ch &&
            (g.cp < h.cp || (g.cp == h.cp && g.loc < h.loc));
    pos += best && g.v && g.w == ii &&
           (g.ch < h.ch ||
            (g.ch == h.ch &&
             (g.cp < h.cp || (g.cp == h.cp && (g.loc < h.loc ||
                                               (g.loc == h.loc && t < k))))));
  }
  if (!best)
    pos = __popc(bests) + __popc(~bests & ((1u << k) - 1));
  const uint32_t jj = rnd % (uint32_t)max(ssum, 1);
  const unsigned at_jj = __ballot_sync(BSM_FULL, k < K && pos == jj);
  const int upick =
      jj >= (uint32_t)K ? 0 : __ffs((at_jj >> (16 * mate)) & 0xFFFFu) - 1;

  // the live combos: valid hit of mate 1 x valid hit of mate 2, lanes
  // striding; each combo's (i*, total) word and sort key
  const unsigned va = valid & 0xFFFFu, vb = valid >> 16;
  const int nb = __popc(vb), ncombo = __popc(va) * nb;
  const int la = __shfl_sync(BSM_FULL, len, 0);
  const int lb = __shfl_sync(BSM_FULL, len, 16);
  const int bua = __shfl_sync(BSM_FULL, bud, 0);
  const int bub = __shfl_sync(BSM_FULL, bud, 16);
  unsigned win = BSM_FULL;
  unsigned wt[BSM_K6_ROUNDS];
  int key[BSM_K6_ROUNDS];
#pragma unroll
  for (int r = 0; r < BSM_K6_ROUNDS; ++r) {
    wt[r] = BSM_FULL;
    key[r] = BSM_BIGJ;
    if (r * 32 < ncombo) {                       // the same in every lane
      const int t = r * 32 + lane;
      const bool on = t < ncombo;
      const int a = on ? t / nb : 0;
      const int ka = bsm_nth_bit(va, a);
      const int lb_ = bsm_nth_bit(vb, on ? t - a * nb : 0);
      const BsmHit A(__shfl_sync(BSM_FULL, loc, ka),
                     __shfl_sync(BSM_FULL, w1, ka));
      const BsmHit B(__shfl_sync(BSM_FULL, loc, 16 + lb_),
                     __shfl_sync(BSM_FULL, w1, 16 + lb_));
      const int ra = __shfl_sync(BSM_FULL, rank, ka);
      const int rb = __shfl_sync(BSM_FULL, rank, 16 + lb_);
      const int m = max(A.w, B.w);
      const int ins = bsm_insert(A, B, la, lb);
      const bool elig = on && (A.ch ^ B.ch) == 1 && A.cp == B.cp &&
                        A.rk <= m && B.rk <= m && A.w <= bua &&
                        B.w <= bub && ins >= min_ins && ins <= max_ins;
      if (elig) {
        wt[r] = ((unsigned)m << 6) | (unsigned)(A.w + B.w);
        win = min(win, wt[r]);
        const int combo =
            A.w == B.w ? 0 : (B.w < A.w ? 1 + 2 * B.w : 2 + 2 * A.w);
        const int sk = (((((combo << 1) | A.ch) << 6) | ra) << 6) | rb;
        key[r] = (sk << 8) | (ka * K + lb_);
      }
    }
  }
  win = __reduce_min_sync(BSM_FULL, win);
  const bool paired = win != BSM_FULL;
  unsigned fmask[BSM_K6_ROUNDS];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < BSM_K6_ROUNDS; ++r) {
    fmask[r] = __ballot_sync(BSM_FULL, paired && wt[r] == win);
    cnt += __popc(fmask[r]);
  }

  // the j-th smallest F key: the one with exactly j smaller F keys
  int sel = BSM_BIGJ;
  if (cnt > 0) {
    const uint32_t j = __shfl_sync(BSM_FULL, rnd, 0) % (uint32_t)cnt;
    int below[BSM_K6_ROUNDS];
#pragma unroll
    for (int r = 0; r < BSM_K6_ROUNDS; ++r) below[r] = 0;
#pragma unroll
    for (int r2 = 0; r2 < BSM_K6_ROUNDS; ++r2) {
      for (unsigned mm = fmask[r2]; mm; mm &= mm - 1) {
        const int kb = __shfl_sync(BSM_FULL, key[r2], __ffs(mm) - 1);
#pragma unroll
        for (int r = 0; r < BSM_K6_ROUNDS; ++r) below[r] += kb < key[r];
      }
    }
#pragma unroll
    for (int r = 0; r < BSM_K6_ROUNDS; ++r)
      if (((fmask[r] >> lane) & 1) && below[r] == (int)j) sel = key[r];
    sel = __reduce_min_sync(BSM_FULL, sel);
  }

  // the picked hits, fetched by shuffle into every lane
  const int sel_kl = sel & 0xFF;                 // 0xFF with no pair
  const int sk = min(sel_kl / K, K - 1), sl = min(sel_kl % K, K - 1);
  const BsmHit SA(__shfl_sync(BSM_FULL, loc, sk),
                  __shfl_sync(BSM_FULL, w1, sk));
  const BsmHit SB(__shfl_sync(BSM_FULL, loc, 16 + sl),
                  __shfl_sync(BSM_FULL, w1, 16 + sl));
  const int ua = __shfl_sync(BSM_FULL, upick, 0);
  const int ub = 16 + __shfl_sync(BSM_FULL, upick, 16);
  const BsmHit UA(__shfl_sync(BSM_FULL, loc, ua),
                  __shfl_sync(BSM_FULL, w1, ua));
  const BsmHit UB(__shfl_sync(BSM_FULL, loc, ub),
                  __shfl_sync(BSM_FULL, w1, ub));
  // lane 8 packs mate 1's unpaired word and lane 9 mate 2's: the mate's
  // extras come from its half-warp
  const int src = lane == 9 ? 16 : 0;
  const int fnd = __shfl_sync(BSM_FULL, found, src);
  const int mii = __shfl_sync(BSM_FULL, ii, src);
  const int mss = __shfl_sync(BSM_FULL, ssum, src);
  const int ftot_b = __shfl_sync(BSM_FULL, ftot, 16);
  const int rep_b = __shfl_sync(BSM_FULL, replay, 16);
  const int ok_b = __shfl_sync(BSM_FULL, okm, 16);
  const int uch = lane == 9 ? UB.ch : UA.ch, ucp = lane == 9 ? UB.cp : UA.cp;
  int word;
  switch (lane) {
    case 0: word = SA.loc; break;
    case 1: word = SB.loc; break;
    case 2: word = paired ? bsm_insert(SA, SB, la, lb) : 0; break;
    case 3: word = UA.loc; break;
    case 4: word = UB.loc; break;
    case 5: word = max(ftot, ftot_b); break;
    case 6:
      word = (int)((uint32_t)(paired ? (int)(win >> 6) + 1 : 0) |
                   ((uint32_t)min(cnt, 2047) << 5) |
                   ((uint32_t)(paired ? SA.ch : 0) << 16) |
                   ((uint32_t)SA.w << 17) | ((uint32_t)SB.w << 21));
      break;
    case 7: word = (int)((uint32_t)SA.cp | ((uint32_t)SB.cp << 16)); break;
    case 8:
    case 9:
      word = (int)((uint32_t)(fnd != 0) | ((uint32_t)uch << 1) |
                   ((uint32_t)mii << 2) | ((uint32_t)min(mss, 1023) << 6) |
                   ((uint32_t)ucp << 16));
      break;
    default:
      word = (replay != 0) | ((rep_b != 0) << 1) |
             ((okm != 0 && ok_b != 0) << 2) | ((cnt >= max_hits) << 3);
  }
  if (lane < 11) out[(size_t)p * 11 + lane] = word;
}

extern "C" int bsmap_pair_join(const int* rows_a, const int* rows_b, int n,
                               int MS, int K, const int* in_a,
                               const int* in_b, int nw, int min_ins,
                               int max_ins, int max_hits, int* out,
                               cudaStream_t stream) {
  if (K < 1 || K > BSM_MAX_K) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int per = BSM_K6_THREADS / 32;
    bsm_pair_join_kernel<<<(n + per - 1) / per, BSM_K6_THREADS, 0, stream>>>(
        rows_a, rows_b, n, MS, K, in_a, in_b, nw, min_ins, max_ins, max_hits,
        out);
  }
  return (int)cudaGetLastError();
}
