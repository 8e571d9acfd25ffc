// K4 reduce_reads: per-read reduction into result rows.
//
// Replaces the per-read half of bsmap_tpu/engine/device_engine.py:
// _verify_impl (:899-1067 lean rows, :1103-1112 full rows), non-RRBS,
// unsharded, hits_k = 0, forward chain.
//
// Per read, over its contiguous candidates [rstart, min(rend, CANDS)) in
// discovery order: pass 1 finds the best level per segment rank and the
// progressive-sensitivity stop rank s* (prefix minimum, align.cpp:445-449);
// pass 2 counts the accepted hits per level, and flags dedup exhaustion;
// then the replay bits (a level at max_num_hits, dedup failure, -r 0 ties),
// the reproducible draw rand32 % ssum (align.cpp:623-625) and, in pass 3,
// the target-th hit of the selected level and the first level-0 hit.  The
// lean row packs everything the SAM formatter needs into 3 int32 (BIT_*);
// the full row carries the histograms and the 17 X_* extras.
//
// Bound on the card: reads of the K3 candidate words, three passes over a
// read's few candidates (about 1 on clean data).  Design: one thread per
// read keeps the in-order selection sequential inside the thread; reads
// whose enumeration ran past the capacity see only their in-capacity
// prefix, like the JAX program, and are re-dispatched by the host.

#include "common.cuh"

__global__ void bsm_reduce_reads_kernel(
    const int* __restrict__ rows, int m, int nw, int MS, int I, int S,
    int cands, const int* __restrict__ starts, const int* __restrict__ cchrp,
    const int* __restrict__ cwloc, const int* __restrict__ cinfo,
    const int* __restrict__ ftot_rank, const int* __restrict__ soff,
    int max_num_hits, int rrh, int lean, int fixed, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int* row = rows + (size_t)b * (2 * nw + 4);
  const int len = row[2 * nw], bud = row[2 * nw + 1];
  const uint32_t rand32 = (uint32_t)row[2 * nw + 2];
  const int maxrank = row[2 * nw + 3];
  const int NB = MS * I, N = m * NB;
  const int total = starts[N];
  const int rstart = starts[b * NB];
  const int rend = b + 1 < m ? starts[(b + 1) * NB] : total;
  const int hi = min(rend, cands);

  // pass 1: best level per rank -> stop rank s*
  int minw[BSM_MAX_MS];
  for (int r = 0; r < MS; ++r) minw[r] = BSM_BIGLEVEL;
  for (int s = rstart; s < hi; ++s) {
    int info = cinfo[s];
    if (info & BSM_INFO_FIRST) {
      int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
      int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
      minw[rank] = min(minw[rank], wmm);
    }
  }
  bool any_stop = false;
  int s_star = MS - 1, pref = BSM_BIGLEVEL;
  for (int r = 0; r < MS; ++r) {
    pref = min(pref, minw[r]);
    if (!any_stop && pref <= r && r <= maxrank) {
      any_stop = true;
      s_star = r;
    }
  }
  // pass 2: per-level counts of accepted hits, dedup exhaustion
  int counts[BSM_MAX_MS];
  for (int l = 0; l < MS; ++l) counts[l] = 0;
  bool dd = false;
  for (int s = rstart; s < hi; ++s) {
    int info = cinfo[s];
    if (info & BSM_INFO_UNRESOLVED) dd = true;
    int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if ((info & BSM_INFO_FIRST) && rank <= s_star && wmm < MS) ++counts[wmm];
  }
  bool found = false, lvl_full = false;
  int ii = 0;
  for (int l = 0; l < MS; ++l) {
    if (counts[l] > 0 && !found) {
      found = true;
      ii = l;
    }
    if (counts[l] >= max_num_hits) lvl_full = true;
  }
  const int ssum = counts[ii];
  const bool replay = lvl_full || dd || (rrh == 0 && found && ssum > 1);
  const int j = (int)(rand32 % (uint32_t)max(ssum, 1));
  const int nfwd = counts[ii];
  const int sel_chain = j >= nfwd ? 1 : 0;
  const int target = (sel_chain ? j - nfwd : j) + 1;
  // pass 3: the target-th hit of level ii on the selected chain, and the
  // first level-0 forward hit
  int nsel = 0, sel_s = cands, h00_s = cands;
  for (int s = rstart; s < hi; ++s) {
    int info = cinfo[s];
    int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if (!(info & BSM_INFO_FIRST) || rank > s_star) continue;
    int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    if (wmm == ii && sel_chain == 0 && ++nsel == target && sel_s == cands)
      sel_s = s;
    if (wmm == 0 && h00_s == cands) h00_s = s;
  }
  const int ss = min(sel_s, cands - 1), hs = min(h00_s, cands - 1);
  const int totals = rend - rstart;
  const bool ok = rend <= cands, big = totals > cands;
  const bool resolved =
      any_stop || maxrank >= bsm_seedseg(len, bud, S, I, MS) - 1;
  const int ftot = ftot_rank[(size_t)b * MS + MS - 1];
  if (lean) {
    bool multi = ssum != 1 || (fixed && totals >= max_num_hits);
    int w1 = (found ? 1 : 0) | (sel_chain << 1) | ((replay ? 1 : 0) << 2) |
             ((ok ? 1 : 0) << 3) | ((big ? 1 : 0) << 4) |
             ((multi ? 1 : 0) << 5) | (ii << 6) | (cchrp[ss] << 10) |
             ((resolved ? 1 : 0) << 26);
    int* o = out + (size_t)b * 3;
    o[0] = cwloc[ss];
    o[1] = w1;
    o[2] = ftot;
    return;
  }
  int* o = out + (size_t)b * (2 * MS + 17);
  for (int l = 0; l < MS; ++l) {
    o[2 * l] = counts[l];
    o[2 * l + 1] = 0;
  }
  int* x = o + 2 * MS;
  x[0] = found;
  x[1] = ii;
  x[2] = ssum;
  x[3] = sel_chain;
  x[4] = cchrp[ss];
  x[5] = cwloc[ss];
  x[6] = h00_s < cands;
  x[7] = cchrp[hs];
  x[8] = cwloc[hs];
  x[9] = replay;
  x[10] = totals;
  x[11] = soff[b];
  x[12] = 0;
  x[13] = ok;
  x[14] = big;
  x[15] = resolved;
  x[16] = ftot;
}

extern "C" int bsmap_reduce_reads(const int* rows, int m, int nw, int MS,
                                  int I, int S, int cands, const int* starts,
                                  const int* cchrp, const int* cwloc,
                                  const int* cinfo, const int* ftot_rank,
                                  const int* soff, int max_num_hits, int rrh,
                                  int lean, int fixed, int* out,
                                  cudaStream_t stream) {
  if (m > 0) {
    const int threads = 128;
    bsm_reduce_reads_kernel<<<(m + threads - 1) / threads, threads, 0,
                              stream>>>(rows, m, nw, MS, I, S, cands, starts,
                                        cchrp, cwloc, cinfo, ftot_rank, soff,
                                        max_num_hits, rrh, lean, fixed, out);
  }
  return (int)cudaGetLastError();
}
