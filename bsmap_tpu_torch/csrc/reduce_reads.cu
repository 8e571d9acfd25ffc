// K4 reduce_reads: per-read reduction into result rows.
//
// Replaces the per-read half of bsmap_tpu/engine/device_engine.py:
// _verify_impl (:899-1067 lean rows, :1069-1112 full rows with hit
// compaction), unsharded, one chain or both (`nch`): each candidate's chain
// (0 forward, 1 reverse complement) is the INFO_CHAIN bit K3 wrote, and the
// counts, the selection, the first level-0 forward hit and the hit words
// follow it (:926, :956-958, :1089); single-end, pair-end (`pe`) or SE
// RRBS (`rrbs`: a forward-chain hit is accepted only with K3's INFO_FRAG
// bit, :897, and every segment runs, :902-906, but the -r 0 abort stays,
// :947).  The full rows carry both chains' start offsets (`soff`, `coff`,
// :1107).
//
// Per read, over its contiguous candidates [rstart, min(rend, CANDS)) in
// discovery order: pass 1 finds the best level per segment rank and the
// progressive-sensitivity stop rank s* (prefix minimum, align.cpp:445-449;
// skipped under `pe`, where every segment runs, pairs.cpp:163-172, and
// under `rrbs`, which checks only after all segments, align.cpp:450); pass 2
// counts the accepted hits per level and chain, and flags dedup
// exhaustion; then the replay bits (a level at max_num_hits, dedup failure,
// SE -r 0 ties), the reproducible draw rand32 % ssum (align.cpp:623-625:
// forward hits first, then rc) and, in pass 3, the target-th hit of the
// selected level and chain, the first level-0 forward hit, and with
// hits_k > 0 the first K accepted hits in discovery
// order (wloc + wmm | chain<<4 | rank<<5 | chrp<<9; empty slots 0 / -1;
// more than K accepted raises the replay bit).  The lean row packs what
// the SAM formatter needs into 3 int32 (BIT_*); the full row carries the
// histograms, the 17 X_* extras and the 2K hit columns.
//
// Bound on the card: reads of the K3 candidate words, three passes over a
// read's few candidates (about 1 on clean data).  Design: one thread per
// read keeps the in-order selection sequential inside the thread; reads
// whose enumeration ran past the capacity see only their in-capacity
// prefix, like the JAX program, and are re-dispatched by the host.

#include "common.cuh"

__global__ void bsm_reduce_reads_kernel(
    const int* __restrict__ rows, int m, int nw, int MS, int I, int S,
    int nch, int cands, const int* __restrict__ starts,
    const int* __restrict__ cchrp, const int* __restrict__ cwloc,
    const int* __restrict__ cinfo, const int* __restrict__ ftot_rank,
    const int* __restrict__ soff, const int* __restrict__ coff,
    int max_num_hits, int rrh, int lean, int fixed, int pe, int rrbs,
    int hits_k, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int* row = rows + (size_t)b * (2 * nw + 4);
  const int len = row[2 * nw], bud = row[2 * nw + 1];
  const uint32_t rand32 = (uint32_t)row[2 * nw + 2];
  const int maxrank = row[2 * nw + 3];
  const int NB = MS * nch * I, N = m * NB;
  const int total = starts[N];
  const int rstart = starts[b * NB];
  const int rend = b + 1 < m ? starts[(b + 1) * NB] : total;
  const int hi = min(rend, cands);
  // acc_pre: first discovery of its key, and under rrbs inside a valid
  // fragment unless on the rc chain
  auto acc_pre = [rrbs](int info) {
    const int mask = BSM_INFO_FIRST |
                     (rrbs && !((info >> BSM_INFO_CHAIN_SHIFT) & 1)
                          ? BSM_INFO_FRAG : 0);
    return (info & mask) == mask;
  };

  // pass 1: best level per rank -> stop rank s* (SE only)
  bool any_stop = false;
  int s_star = MS - 1;
  if (!pe && !rrbs) {
    int minw[BSM_MAX_MS];
    for (int r = 0; r < MS; ++r) minw[r] = BSM_BIGLEVEL;
    for (int s = rstart; s < hi; ++s) {
      int info = cinfo[s];
      if (acc_pre(info)) {
        int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
        int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
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
  // pass 2: per-level, per-chain counts of accepted hits, the accepted
  // total, dedup exhaustion
  int counts[BSM_MAX_MS][2];
  for (int l = 0; l < MS; ++l) counts[l][0] = counts[l][1] = 0;
  bool dd = false;
  int nacc = 0;
  for (int s = rstart; s < hi; ++s) {
    int info = cinfo[s];
    if (info & BSM_INFO_UNRESOLVED) dd = true;
    int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if (acc_pre(info) && rank <= s_star) {
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
  const bool replay = lvl_full || dd ||
                      (rrh == 0 && !pe && found && ssum > 1) ||
                      (hits_k > 0 && nacc > hits_k);
  const int j = (int)(rand32 % (uint32_t)max(ssum, 1));
  const int nfwd = counts[ii][0];
  const int sel_chain = j >= nfwd ? 1 : 0;
  const int target = (sel_chain ? j - nfwd : j) + 1;
  // pass 3: the target-th hit of level ii on the selected chain, the first
  // level-0 forward hit, and the compacted hit list
  const int W = 2 * MS + 17;
  int* o = out + (size_t)b * (lean ? 3 : W + 2 * hits_k);
  int nsel = 0, sel_s = cands, h00_s = cands, nhit = 0;
  for (int s = rstart; s < hi; ++s) {
    int info = cinfo[s];
    int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if (!acc_pre(info) || rank > s_star) continue;
    int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    int chain = (info >> BSM_INFO_CHAIN_SHIFT) & 1;
    if (wmm == ii && sel_chain == chain && ++nsel == target &&
        sel_s == cands)
      sel_s = s;
    if (chain == 0 && wmm == 0 && h00_s == cands) h00_s = s;
    if (nhit < hits_k && !lean) {
      o[W + nhit] = cwloc[s];
      o[W + hits_k + nhit] = wmm | (chain << 4) | (rank << 5) |
                             (int)((uint32_t)cchrp[s] << 9);
      ++nhit;
    }
  }
  const int ss = min(sel_s, cands - 1), hs = min(h00_s, cands - 1);
  const int totals = rend - rstart;
  const bool ok = rend <= cands, big = totals > cands;
  const bool resolved = pe || rrbs || any_stop ||
                        maxrank >= bsm_seedseg(len, bud, S, I, MS) - 1;
  const int ftot = ftot_rank[(size_t)b * MS + MS - 1];
  if (lean) {
    bool multi = ssum != 1 || (fixed && totals >= max_num_hits);
    int w1 = (found ? 1 : 0) | (sel_chain << 1) | ((replay ? 1 : 0) << 2) |
             ((ok ? 1 : 0) << 3) | ((big ? 1 : 0) << 4) |
             ((multi ? 1 : 0) << 5) | (ii << 6) | (cchrp[ss] << 10) |
             ((resolved ? 1 : 0) << 26);
    o[0] = cwloc[ss];
    o[1] = w1;
    o[2] = ftot;
    return;
  }
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
  x[4] = cchrp[ss];
  x[5] = cwloc[ss];
  x[6] = h00_s < cands;
  x[7] = cchrp[hs];
  x[8] = cwloc[hs];
  x[9] = replay;
  x[10] = totals;
  x[11] = soff[b];                 // X_SOFF / X_COFF: both chains' offsets
  x[12] = coff[b];
  x[13] = ok;
  x[14] = big;
  x[15] = resolved;
  x[16] = ftot;
}

extern "C" int bsmap_reduce_reads(const int* rows, int m, int nw, int MS,
                                  int I, int S, int nch, int cands,
                                  const int* starts, const int* cchrp,
                                  const int* cwloc, const int* cinfo,
                                  const int* ftot_rank, const int* soff,
                                  const int* coff, int max_num_hits, int rrh,
                                  int lean, int fixed, int pe, int rrbs,
                                  int hits_k, int* out, cudaStream_t stream) {
  if (m > 0) {
    const int threads = 128;
    bsm_reduce_reads_kernel<<<(m + threads - 1) / threads, threads, 0,
                              stream>>>(rows, m, nw, MS, I, S, nch, cands,
                                        starts, cchrp, cwloc, cinfo,
                                        ftot_rank, soff, coff, max_num_hits,
                                        rrh, lean, fixed, pe, rrbs, hits_k,
                                        out);
  }
  return (int)cudaGetLastError();
}
