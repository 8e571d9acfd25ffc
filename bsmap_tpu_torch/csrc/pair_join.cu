// K6 pair_join: the K x K pair join of both mates' compacted hits.
//
// Replaces bsmap_tpu/engine/pair_device.py:_device_pair_join (:73-195),
// GetPairs (pairs.cpp:34-135) as a join: for every combo (k, l) of mate-1
// hit k and mate-2 hit l, eligibility (valid, opposite chains, same
// chromosome, both hits available at step max(na, nb), within budgets,
// insert within [min_ins, max_ins]); the winning step i* = min max(na, nb),
// the winning total, the winning set F, its count, and the reference's
// sweep order as a key (combo, chain, each mate's (chr, loc)-sorted rank,
// combo index in the low 8 bits); the myrand-j-th smallest F key picks the
// pair.  Each mate's unpaired fallback pick is the jj-th hit of a stable
// sort by (chain, chr, loc) of its best-level hits (SortHits4PE,
// pairs.cpp:258-271).  Output: the 11 J_* columns (pair_device.py:63-70).
//
// Bound on the card: reading 2 x (2MS+17+2K) + 2 x 4 int32 per pair; the
// K*K combos and two K-wide ranks are shared-memory work.  Design: one
// block per pair, one thread per combo (K <= 16, so K*K <= 256); the min
// reductions are shared-memory atomics, the count a __syncthreads_count.
// Keys are unique (combo index in the low bits), so the j-th smallest F key
// is the F key with exactly j smaller F keys: a count, not a sort.  The
// same trick with the lane index as tie-break (lexsort is stable) gives the
// unpaired picks.  Out-of-range picks follow the JAX gathers: a pair index
// past K clamps to K-1, an unpaired draw past K takes hit 0.

#include "common.cuh"

#define BSM_MAX_K 16
#define BSM_BIGJ 0x3FFFFFFF
#define BSM_KBIG 0x7FFFFFFF
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

__global__ void bsm_pair_join_kernel(const int* __restrict__ rows_a,
                                     const int* __restrict__ rows_b, int MS,
                                     int K, const int* __restrict__ in_a,
                                     const int* __restrict__ in_b, int nw,
                                     int min_ins, int max_ins, int max_hits,
                                     int* __restrict__ out) {
  const int p = blockIdx.x, tid = threadIdx.x;
  const int base = 2 * MS + 17, width = base + 2 * K, iw = 2 * nw + 4;
  const int* row[2] = {rows_a + (size_t)p * width,
                       rows_b + (size_t)p * width};
  const int* in[2] = {in_a + (size_t)p * iw, in_b + (size_t)p * iw};
  __shared__ int s_loc[2][BSM_MAX_K], s_w1[2][BSM_MAX_K], s_rank[2][BSM_MAX_K];
  __shared__ int s_key[BSM_MAX_K * BSM_MAX_K];
  __shared__ int s_istar, s_wintot, s_sel, s_upick[2];
  if (tid < 2 * K) {
    const int mate = tid / K, k = tid % K;
    s_loc[mate][k] = row[mate][base + k];
    s_w1[mate][k] = row[mate][base + K + k];
  }
  if (tid == 0) {
    s_istar = BSM_BIGJ;
    s_wintot = BSM_BIGJ;
    s_sel = BSM_BIGJ;
  }
  __syncthreads();

  // each mate's (chr, loc)-sorted rank within its (level, chain) list, and
  // its unpaired pick
  for (int t = tid; t < 4 * K; t += blockDim.x) {
    const int mate = (t / K) & 1, k = t % K;
    const BsmHit h(s_loc[mate][k], s_w1[mate][k]);
    if (t < 2 * K) {
      int r = 0;
      for (int k2 = 0; k2 < K; ++k2) {
        const BsmHit g(s_loc[mate][k2], s_w1[mate][k2]);
        r += h.v && g.v && g.w == h.w && g.ch == h.ch &&
             (g.cp < h.cp || (g.cp == h.cp && g.loc < h.loc));
      }
      s_rank[mate][k] = r;
    } else {
      const int ii = row[mate][2 * MS + BSM_X_II];
      const int ssum = row[mate][2 * MS + BSM_X_SSUM];
      const uint32_t jj =
          (uint32_t)in[mate][2 * nw + 2] % (uint32_t)max(ssum, 1);
      const bool best = h.v && h.w == ii;
      const int kch = best ? h.ch : BSM_KBIG, kcp = best ? h.cp : BSM_KBIG;
      const int klo = best ? h.loc : BSM_KBIG;
      uint32_t pos = 0;
      for (int k2 = 0; k2 < K; ++k2) {
        const BsmHit g(s_loc[mate][k2], s_w1[mate][k2]);
        const bool b2 = g.v && g.w == ii;
        const int gch = b2 ? g.ch : BSM_KBIG, gcp = b2 ? g.cp : BSM_KBIG;
        const int glo = b2 ? g.loc : BSM_KBIG;
        pos += gch < kch ||
               (gch == kch &&
                (gcp < kcp || (gcp == kcp && (glo < klo ||
                                              (glo == klo && k2 < k)))));
      }
      if (jj >= (uint32_t)K ? k == 0 : pos == jj) s_upick[mate] = k;
    }
  }
  __syncthreads();

  // one thread per combo (k, l)
  const bool act = tid < K * K;
  const int k = act ? tid / K : 0, l = act ? tid % K : 0;
  const BsmHit A(s_loc[0][k], s_w1[0][k]), B(s_loc[1][l], s_w1[1][l]);
  const int la = in[0][2 * nw], lb = in[1][2 * nw];
  const int m = max(A.w, B.w);
  const int ins = bsm_insert(A, B, la, lb);
  const bool elig = act && A.v && B.v && (A.ch ^ B.ch) == 1 &&
                    A.cp == B.cp && A.rk <= m && B.rk <= m &&
                    A.w <= in[0][2 * nw + 1] && B.w <= in[1][2 * nw + 1] &&
                    ins >= min_ins && ins <= max_ins;
  if (elig) atomicMin(&s_istar, m);
  __syncthreads();
  const int istar = s_istar;
  const bool at_win = elig && m == istar;
  const int tot = A.w + B.w;
  if (at_win) atomicMin(&s_wintot, tot);
  __syncthreads();
  const bool F = at_win && tot == s_wintot;
  const int cnt = __syncthreads_count(F);
  const int combo = A.w == B.w ? 0 : (B.w < A.w ? 1 + 2 * B.w : 2 + 2 * A.w);
  const int key = (((((combo << 1) | A.ch) << 6) | s_rank[0][k]) << 6) |
                  s_rank[1][l];
  const int keyp = (key << 8) | tid;
  if (act) s_key[tid] = F ? keyp : BSM_BIGJ;
  __syncthreads();
  if (F) {
    const uint32_t j = (uint32_t)in[0][2 * nw + 2] % (uint32_t)max(cnt, 1);
    uint32_t r = 0;
    for (int t = 0; t < K * K; ++t) r += s_key[t] < keyp;
    if (r == j) s_sel = keyp;
  }
  __syncthreads();
  if (tid != 0) return;

  const bool paired = istar < BSM_BIGJ;
  const int sel_kl = s_sel & 0xFF;                 // 0xFF with no pair
  const int sk = min(sel_kl / K, K - 1), sl = min(sel_kl % K, K - 1);
  const BsmHit SA(s_loc[0][sk], s_w1[0][sk]), SB(s_loc[1][sl], s_w1[1][sl]);
  uint32_t mate_w[2];
  int mate_loc[2];
  for (int mate = 0; mate < 2; ++mate) {
    const int u = s_upick[mate];
    const BsmHit U(s_loc[mate][u], s_w1[mate][u]);
    const int* x = row[mate] + 2 * MS;
    mate_loc[mate] = U.loc;
    mate_w[mate] = (uint32_t)(x[BSM_X_FOUND] != 0) | ((uint32_t)U.ch << 1) |
                   ((uint32_t)x[BSM_X_II] << 2) |
                   ((uint32_t)min(x[BSM_X_SSUM], 1023) << 6) |
                   ((uint32_t)U.cp << 16);
  }
  const bool ok_both = row[0][2 * MS + BSM_X_OK] != 0 &&
                       row[1][2 * MS + BSM_X_OK] != 0;
  int* o = out + (size_t)p * 11;
  o[0] = SA.loc;
  o[1] = SB.loc;
  o[2] = paired ? bsm_insert(SA, SB, la, lb) : 0;
  o[3] = mate_loc[0];
  o[4] = mate_loc[1];
  o[5] = max(row[0][2 * MS + BSM_X_FTOT], row[1][2 * MS + BSM_X_FTOT]);
  o[6] = (int)((uint32_t)(paired ? istar + 1 : 0) |
               ((uint32_t)min(cnt, 2047) << 5) |
               ((uint32_t)(paired ? SA.ch : 0) << 16) |
               ((uint32_t)SA.w << 17) | ((uint32_t)SB.w << 21));
  o[7] = (int)((uint32_t)SA.cp | ((uint32_t)SB.cp << 16));
  o[8] = (int)mate_w[0];
  o[9] = (int)mate_w[1];
  o[10] = (row[0][2 * MS + BSM_X_REPLAY] != 0) |
          ((row[1][2 * MS + BSM_X_REPLAY] != 0) << 1) | (ok_both << 2) |
          ((cnt >= max_hits) << 3);
}

extern "C" int bsmap_pair_join(const int* rows_a, const int* rows_b, int n,
                               int MS, int K, const int* in_a,
                               const int* in_b, int nw, int min_ins,
                               int max_ins, int max_hits, int* out,
                               cudaStream_t stream) {
  if (n > 0) {
    bsm_pair_join_kernel<<<n, BSM_MAX_K * BSM_MAX_K, 0, stream>>>(
        rows_a, rows_b, MS, K, in_a, in_b, nw, min_ins, max_ins, max_hits,
        out);
  }
  return (int)cudaGetLastError();
}
