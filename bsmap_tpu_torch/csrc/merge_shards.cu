// K7 merge_shards: the index-sharded per-read reduce.
//
// Replaces the shard_axis branches of bsmap_tpu/engine/device_engine.py:
// _verify_impl (:689 pmax of the totals, :911-913 pmin of the early exit,
// :930-945 psum of the counts, dedup failures and corner reads, :960-1007
// the global discovery rank and the psum picks, :1033-1038 the merged
// totals and ok/big bits, :1074-1100 the merged hit lists), which
// bsmap_tpu/parallel/index_sharded.py:_index_sharded_call (:115-142) runs
// on every region shard of the seed index.
//
// Input: D region shards' K3 output for the same window, stacked
// (`starts` (D, m*NB + 1), `chrp`/`wloc`/`info` (D, CANDS)), each shard's
// full-rank candidate total (`ftot` (D, m)) and shard 0's start offsets.
// Output: the full rows of K4's layout (counts, the 17 X_* extras, 2K hit
// columns).  Per read, the candidates of all shards are walked in GLOBAL
// discovery order (bsmap_tpu/parallel/index_sharded.py:9-14): slot by
// slot, the Watson candidates of shards 0..D-1, then the Crick candidates
// of shards D-1..0 (Crick coordinates ascend as Watson positions descend,
// so a bucket's Crick run meets the regions in descending order).  In that
// order K4's logic holds as it is: the early exit takes the best level of
// each rank over all shards (pmin), the counts, dedup failures and corner
// candidates sum over all shards (psum), the pick is the target-th hit of
// the selected level and chain (global_rank_of), the first level-0 forward
// hit is the first in this order, and the hit list is compacted in it.
// A read with no pick gets 0s (the psum of nothing).  totals sum the
// shards' totals (int32, wrapping), ok needs every shard's read end within
// CANDS, big is any shard's own total past it, ftot is the largest shard's.
//
// Bound on the card: reads of the D shards' candidate words and slot
// starts (D*(NB+1) starts and a few candidates per read on clean data);
// no arithmetic worth counting.  Design: one thread per read, as K4, so
// the in-order walk, which crosses shards inside every slot, stays
// sequential inside the thread and needs no cross-thread rank exchange
// (the JAX program's all_gather of per-slot counts); the shards' Watson
// prefix of each slot is found by its chrp parity bit (Watson entries
// precede Crick ones within a slot's run).

#include "common.cuh"

__global__ void bsm_merge_shards_kernel(
    const int* __restrict__ rows, int m, int nw, int MS, int I, int S,
    int nch, int D, int cands, const int* __restrict__ starts,
    const int* __restrict__ cchrp, const int* __restrict__ cwloc,
    const int* __restrict__ cinfo, const int* __restrict__ ftot,
    const int* __restrict__ soff, const int* __restrict__ coff,
    int max_num_hits, int rrh, int pe, int hits_k, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int* row = rows + (size_t)b * (2 * nw + 4);
  const int len = row[2 * nw], bud = row[2 * nw + 1];
  const uint32_t rand32 = (uint32_t)row[2 * nw + 2];
  const int maxrank = row[2 * nw + 3];
  const int NB = MS * nch * I, N = m * NB;
  // shard d's starts, candidate words
#define BSM_ST(d, q) starts[(size_t)(d) * (N + 1) + (q)]
#define BSM_AT(arr, d, s) arr[(size_t)(d) * cands + (s)]
  // each shard's in-capacity range of this read
  int lo[BSM_MAX_SHARDS], hi[BSM_MAX_SHARDS];
  uint32_t totals = 0;
  bool ok = true, big = false;
  int ft = 0;
  for (int d = 0; d < D; ++d) {
    const int rs = BSM_ST(d, b * NB), re = BSM_ST(d, (b + 1) * NB);
    lo[d] = rs;
    hi[d] = min(re, cands);
    totals += (uint32_t)(re - rs);
    ok = ok && re <= cands;
    big = big || re - rs > cands;
    ft = d == 0 ? ftot[b] : max(ft, ftot[(size_t)d * m + b]);
  }

  // pass 1: best level per rank over all shards -> stop rank s* (SE only)
  bool any_stop = false;
  int s_star = MS - 1;
  if (!pe) {
    int minw[BSM_MAX_MS];
    for (int r = 0; r < MS; ++r) minw[r] = BSM_BIGLEVEL;
    for (int d = 0; d < D; ++d)
      for (int s = lo[d]; s < hi[d]; ++s) {
        const int info = BSM_AT(cinfo, d, s);
        if (info & BSM_INFO_FIRST) {
          const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
          const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
          minw[rank] = min(minw[rank], wmm);
        }
      }
    int pref = BSM_BIGLEVEL;
    for (int r = 0; r < MS; ++r) {
      pref = min(pref, minw[r]);
      if (!any_stop && pref <= r && r <= maxrank) {
        any_stop = true;
        s_star = r;
      }
    }
  }
  // pass 2: counts, accepted total, dedup exhaustion, corner candidates
  int counts[BSM_MAX_MS][2];
  for (int l = 0; l < MS; ++l) counts[l][0] = counts[l][1] = 0;
  bool dd = false, corner = false;
  int nacc = 0;
  for (int d = 0; d < D; ++d)
    for (int s = lo[d]; s < hi[d]; ++s) {
      const int info = BSM_AT(cinfo, d, s);
      if (info & BSM_INFO_UNRESOLVED) dd = true;
      if (info & BSM_INFO_CORNER) corner = true;
      const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
      const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
      if ((info & BSM_INFO_FIRST) && rank <= s_star) {
        ++nacc;
        if (wmm < MS) ++counts[wmm][(info >> BSM_INFO_CHAIN_SHIFT) & 1];
      }
    }
  bool found = false, lvl_full = false;
  int ii = 0;
  for (int l = 0; l < MS; ++l) {
    const int lv = counts[l][0] + counts[l][1];
    if (lv > 0 && !found) {
      found = true;
      ii = l;
    }
    if (lv >= max_num_hits) lvl_full = true;
  }
  const int ssum = counts[ii][0] + counts[ii][1];
  const bool replay = lvl_full || dd || corner ||
                      (rrh == 0 && !pe && found && ssum > 1) ||
                      (hits_k > 0 && nacc > hits_k);
  const int j = (int)(rand32 % (uint32_t)max(ssum, 1));
  const int nfwd = counts[ii][0];
  const int sel_chain = j >= nfwd ? 1 : 0;
  const int target = (sel_chain ? j - nfwd : j) + 1;

  // pass 3, in global discovery order: the pick, the first level-0
  // forward hit, the compacted hit list
  const int W = 2 * MS + 17;
  int* o = out + (size_t)b * (W + 2 * hits_k);
  int nsel = 0, nhit = 0;
  int sel_chrp = 0, sel_wloc = 0, h00_chrp = 0, h00_wloc = 0;
  bool h00_found = false;
  auto visit = [&](int d, int s) {
    const int info = BSM_AT(cinfo, d, s);
    const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if (!(info & BSM_INFO_FIRST) || rank > s_star) return;
    const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    const int chain = (info >> BSM_INFO_CHAIN_SHIFT) & 1;
    const int chrp = BSM_AT(cchrp, d, s), wloc = BSM_AT(cwloc, d, s);
    if (wmm == ii && chain == sel_chain && ++nsel == target) {
      sel_chrp = chrp;
      sel_wloc = wloc;
    }
    if (chain == 0 && wmm == 0 && !h00_found) {
      h00_found = true;
      h00_chrp = chrp;
      h00_wloc = wloc;
    }
    if (nhit < hits_k) {
      o[W + nhit] = wloc;
      o[W + hits_k + nhit] = wmm | (chain << 4) | (rank << 5) |
                             (int)((uint32_t)chrp << 9);
      ++nhit;
    }
  };
  int split[BSM_MAX_SHARDS], end[BSM_MAX_SHARDS];
  for (int q = b * NB; q < (b + 1) * NB; ++q) {
    for (int d = 0; d < D; ++d) {           // Watson, shards ascending
      int s = BSM_ST(d, q);
      end[d] = min(BSM_ST(d, q + 1), cands);
      for (; s < end[d] && !(BSM_AT(cchrp, d, s) & 1); ++s) visit(d, s);
      split[d] = s;
    }
    for (int d = D - 1; d >= 0; --d)        // Crick, shards descending
      for (int s = split[d]; s < end[d]; ++s) visit(d, s);
  }
#undef BSM_ST
#undef BSM_AT
  for (int k = nhit; k < hits_k; ++k) {
    o[W + k] = 0;
    o[W + hits_k + k] = -1;
  }
  for (int l = 0; l < MS; ++l) {
    o[2 * l] = counts[l][0];
    o[2 * l + 1] = counts[l][1];
  }
  int* x = o + 2 * MS;
  x[0] = found;
  x[1] = ii;
  x[2] = ssum;
  x[3] = sel_chain;
  x[4] = sel_chrp;
  x[5] = sel_wloc;
  x[6] = h00_found;
  x[7] = h00_chrp;
  x[8] = h00_wloc;
  x[9] = replay;
  x[10] = (int)totals;
  x[11] = soff[b];
  x[12] = coff[b];
  x[13] = ok;
  x[14] = big;
  x[15] = pe || any_stop || maxrank >= bsm_seedseg(len, bud, S, I, MS) - 1;
  x[16] = ft;
}

extern "C" int bsmap_merge_shards(const int* rows, int m, int nw, int MS,
                                  int I, int S, int nch, int D, int cands,
                                  const int* starts, const int* cchrp,
                                  const int* cwloc, const int* cinfo,
                                  const int* ftot, const int* soff,
                                  const int* coff, int max_num_hits, int rrh,
                                  int pe, int hits_k, int* out,
                                  cudaStream_t stream) {
  if (D < 1 || D > BSM_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const int threads = 128;
    bsm_merge_shards_kernel<<<(m + threads - 1) / threads, threads, 0,
                              stream>>>(rows, m, nw, MS, I, S, nch, D, cands,
                                        starts, cchrp, cwloc, cinfo, ftot,
                                        soff, coff, max_num_hits, rrh, pe,
                                        hits_k, out);
  }
  return (int)cudaGetLastError();
}
