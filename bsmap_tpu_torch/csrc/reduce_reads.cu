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
// discovery order: pass 1 finds the progressive-sensitivity stop rank s*
// (align.cpp:445-449; skipped under `pe`, where every segment runs,
// pairs.cpp:163-172, and under `rrbs`, which checks only after all
// segments, align.cpp:450); pass 2 counts the accepted hits per level and
// chain, and flags dedup exhaustion; then the replay bits (a level at
// max_num_hits, dedup failure, SE -r 0 ties, more than K accepted hits),
// the reproducible draw rand32 % ssum (align.cpp:623-625: forward hits
// first, then rc) and, in pass 3, the target-th hit of the selected level
// and chain, the first level-0 forward hit, and with hits_k > 0 the first
// K accepted hits in discovery order (wloc + wmm | chain<<4 | rank<<5 |
// chrp<<9; empty slots 0 / -1).  The lean row packs what the SAM formatter
// needs into 3 int32 (BIT_*); the full row carries the histograms, the 17
// X_* extras and the 2K hit columns.  Reads whose enumeration ran past the
// capacity see only their in-capacity prefix, like the JAX program, and are
// re-dispatched by the host.
//
// Bound on the card: the sectors of the reads' row scalars and slot starts
// (about one a read each), their totals (4 * maxseg bytes a read, as the
// reads' entries lie that far apart), 12 bytes per candidate, and the
// output row written once (220 bytes a read under `pe` at -v 2 with
// K = 16).  A read has about one candidate on clean data (RRBS and full-rank windows: 4-32, a tail past 100), so the
// work per read is a short chain of dependent loads and a few hundred
// instructions: latency and the instructions issued bound the lean rows,
// the stores the full rows.  Design: a warp takes 32 consecutive reads.
//
//  * A lane per read for reads with at most 32 candidates in the
//    capacity: plain loops over the candidates, which the later passes
//    find in L1.  Spreading such a read over lanes costs more instructions
//    than it saves (on the H100: 2.2x slower on lean rows at 8 lanes a
//    read), and loading a lane's candidates eight at a time gained nothing
//    measurable.
//  * The reads with more candidates by the whole warp, one after another.
//    The warp strides the read's candidates in chunks of 32 in discovery
//    order (a chunk's info words are one coalesced load) and keeps the
//    first chunk's info, chrp and wloc in registers for all passes; its
//    passes reduce by xor shuffles and ballots, its counters take shared
//    atomics, and a pick in the first chunk comes by shuffle instead of
//    another load.  Groups of 16 or 8 lanes, which take more reads this
//    way, were no faster on any window measured and lost up to 3x on
//    RRBS windows (PERF.md section 6).
//  * Pass 1 needs no per-rank table: prefmin(r) <= r holds iff some
//    accepted-before-stop candidate has max(rank, wmm) <= r, so the first
//    stopping rank is v = the least max(rank, wmm) over them, and the read
//    stops iff v <= min(maxrank, maxseg - 1): one min over the candidates.
//  * A lane alone keeps the first nonempty level (the least counted level),
//    its count and its forward count in registers as it counts; a level
//    can reach max_num_hits only with that many accepted hits, so the
//    per-level counts are needed for lean rows only then.
//  * Each read owns a slice of Wt words of shared memory (Wt odd: the
//    lanes' slices fall on distinct banks) for its 2*maxseg (level, chain)
//    counters and, for full rows, the whole row: counts, extras and hit
//    columns.  The warp then stores its 32 full rows, one contiguous span
//    of the output, 32 consecutive words a store.  No per-thread array is
//    indexed by data: ptxas reports no stack.

#include "common.cuh"

#define BSM_K4_THREADS 128

struct BsmK4 {
  const int* rows;
  int m, nw, MS, I, S, nch, cands;
  const int* starts;
  const int* cchrp;
  const int* cwloc;
  const int* cinfo;
  const int* ftot_rank;
  const int* soff;
  const int* coff;
  int max_num_hits, rrh, lean, fixed, pe, rrbs, hits_k;
  int Wt;                                   // words of a read's slice
  int* out;
};

// What a read's row needs besides its candidates, loaded at once: its
// slot span, the dispatch row's scalars, its totals, both chains' start
// offsets (full rows), and the words at CANDS-1.
struct BsmK4Read {
  int rstart, rend, len, bud, maxrank, ftot, soff, coff;
  uint32_t rand32;
  int last_chrp, last_wloc;
};

static __device__ __forceinline__ BsmK4Read bsm_k4_facts(const BsmK4& a,
                                                          int b) {
  const int NB = a.MS * a.nch * a.I;
  const int* sc = a.rows + (size_t)b * (2 * a.nw + 4) + 2 * a.nw;
  BsmK4Read r;
  r.rstart = a.starts[(size_t)b * NB];
  r.rend = a.starts[(size_t)(b + 1) * NB];
  r.len = sc[0];
  r.bud = sc[1];
  r.rand32 = (uint32_t)sc[2];
  r.maxrank = sc[3];
  r.ftot = a.ftot_rank[(size_t)b * a.MS + a.MS - 1];
  r.soff = a.lean ? 0 : a.soff[b];
  r.coff = a.lean ? 0 : a.coff[b];
  r.last_chrp = a.cchrp[a.cands - 1];
  r.last_wloc = a.cwloc[a.cands - 1];
  return r;
}

// acc_pre: first discovery of its key, and under rrbs inside a valid
// fragment unless on the rc chain
static __device__ __forceinline__ bool bsm_k4_acc_pre(int info, int rrbs) {
  const int mask = BSM_INFO_FIRST |
                   (rrbs && !((info >> BSM_INFO_CHAIN_SHIFT) & 1)
                        ? BSM_INFO_FRAG : 0);
  return (info & mask) == mask;
}

// The chrp and wloc of candidate s; CANDS-1's for none (s >= cands: JAX's
// clamped gather)
static __device__ __forceinline__ void bsm_k4_at(const BsmK4& a,
                                                 const BsmK4Read& r, int s,
                                                 int& cp, int& wl) {
  if (s >= a.cands) {
    cp = r.last_chrp;
    wl = r.last_wloc;
  } else {
    cp = a.cchrp[s];
    wl = a.cwloc[s];
  }
}

// What a read's passes found, for its row.
struct BsmK4Found {
  bool found, replay, any_stop, h00;
  int ii, ssum, sel_chain, nhit;
  int sel_chrp, sel_wloc, h00_chrp, h00_wloc;
};

// Read b's row from what its passes found: a lean row straight to the
// output, or a full row's extras and empty hit slots (0 / -1) into the
// read's slice `sl`, whose hit columns hold its first nhit hits (the warp
// stores the slices).  The calling lanes fill the empty slots from
// nhit + k0 in steps of dk; the lane with `writer` writes the rest.
static __device__ __forceinline__ void bsm_k4_write(const BsmK4& a, int b,
                                                    const BsmK4Read& r,
                                                    const BsmK4Found& f,
                                                    int* sl, bool writer,
                                                    int k0, int dk) {
  const int MS = a.MS;
  const int totals = r.rend - r.rstart;
  const bool ok = r.rend <= a.cands, big = totals > a.cands;
  const bool resolved =
      a.pe || a.rrbs || f.any_stop ||
      r.maxrank >= bsm_seedseg(r.len, r.bud, a.S, a.I, MS) - 1;
  if (a.lean) {
    if (!writer) return;
    const bool multi =
        f.ssum != 1 || (a.fixed && totals >= a.max_num_hits);
    int* o = a.out + (size_t)b * 3;
    o[0] = f.sel_wloc;
    o[1] = (f.found ? 1 : 0) | (f.sel_chain << 1) |
           ((f.replay ? 1 : 0) << 2) | ((ok ? 1 : 0) << 3) |
           ((big ? 1 : 0) << 4) | ((multi ? 1 : 0) << 5) | (f.ii << 6) |
           (f.sel_chrp << 10) | ((resolved ? 1 : 0) << 26);
    o[2] = r.ftot;
    return;
  }
  const int K = a.hits_k, W = 2 * MS + 17;
  for (int k = min(f.nhit, K) + k0; k < K; k += dk) {
    sl[W + k] = 0;
    sl[W + K + k] = -1;
  }
  if (!writer) return;
  int* x = sl + 2 * MS;                     // the X_* extras
  x[0] = f.found;
  x[1] = f.ii;
  x[2] = f.ssum;
  x[3] = f.sel_chain;
  x[4] = f.sel_chrp;
  x[5] = f.sel_wloc;
  x[6] = f.h00;
  x[7] = f.h00_chrp;
  x[8] = f.h00_wloc;
  x[9] = f.replay;
  x[10] = totals;
  x[11] = r.soff;                           // X_SOFF / X_COFF: both chains'
  x[12] = r.coff;                           // start offsets
  x[13] = ok;
  x[14] = big;
  x[15] = resolved;
  x[16] = r.ftot;
}

// The row of a read with more than 32 candidates, by the whole warp; `sl`
// is the read's slice of shared memory.
static __device__ __forceinline__ void bsm_k4_warp(const BsmK4& a, int b,
                                                   const BsmK4Read& r,
                                                   int lane, int* sl) {
  const unsigned full = 0xFFFFFFFFu, below = (1u << lane) - 1u;
  auto ballot = [&](bool p) { return __ballot_sync(full, p); };
  auto wmin = [&](int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = min(v, __shfl_xor_sync(full, v, off));
    return v;
  };
  auto wsum = [&](int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(full, v, off);
    return v;
  };

  const int MS = a.MS, cands = a.cands, rrbs = a.rrbs;
  const bool lean = a.lean;
  const int K = lean ? 0 : a.hits_k;
  const int rstart = r.rstart, maxrank = r.maxrank;
  const int hi = min(r.rend, cands);
  const int n = hi - rstart;
  const int nchunk = n > 0 ? (n + 31) / 32 : 0;
  const bool in0 = lane < n;
  const int info0 = in0 ? a.cinfo[rstart + lane] : 0;
  const int chrp0 = in0 ? a.cchrp[rstart + lane] : 0;
  const int wloc0 = in0 ? a.cwloc[rstart + lane] : 0;
  // candidate `lane` of chunk c: (in range, its info word)
  auto info_at = [&](int c, int& info) {
    const int s = rstart + c * 32 + lane;
    info = c == 0 ? info0 : (s < hi ? a.cinfo[s] : 0);
    return s < hi;
  };

  for (int l = lane; l < 2 * MS; l += 32) sl[l] = 0;

  // pass 1: the stop rank s* (SE only)
  BsmK4Found f;
  f.any_stop = false;
  int s_star = MS - 1;
  if (!a.pe && !rrbs) {
    int v = 1 << 30;
    for (int c = 0; c < nchunk; ++c) {
      int info;
      if (info_at(c, info) && bsm_k4_acc_pre(info, rrbs)) {
        const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
        const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
        v = min(v, max(rank, wmm));
      }
    }
    v = wmin(v);
    f.any_stop = v <= min(maxrank, MS - 1);
    if (f.any_stop) s_star = v;
  }
  __syncwarp();                             // counters zeroed

  // pass 2: per-level, per-chain counts of accepted hits, the accepted
  // total, dedup exhaustion
  int nacc = 0;
  bool dd = false;
  for (int c = 0; c < nchunk; ++c) {
    int info;
    if (!info_at(c, info)) continue;
    if (info & BSM_INFO_UNRESOLVED) dd = true;
    const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if (bsm_k4_acc_pre(info, rrbs) && rank <= s_star) {
      ++nacc;
      if (wmm < MS)
        atomicAdd(&sl[2 * wmm + ((info >> BSM_INFO_CHAIN_SHIFT) & 1)], 1);
    }
  }
  nacc = wsum(nacc);
  dd = __any_sync(full, dd);
  __syncwarp();                             // counts complete
  bool lvl_full = false;
  f.found = false;
  f.ii = 0;
  for (int base = 0; base < MS; base += 32) {
    const int l = base + lane;
    const int lv = l < MS ? sl[2 * l] + sl[2 * l + 1] : 0;
    const unsigned nz = ballot(lv > 0);
    if (!f.found && nz) {
      f.found = true;
      f.ii = base + __ffs(nz) - 1;
    }
    if (ballot(l < MS && lv >= a.max_num_hits)) lvl_full = true;
  }
  const int nfwd = sl[2 * f.ii];
  f.ssum = nfwd + sl[2 * f.ii + 1];
  f.replay = lvl_full || dd ||
             (a.rrh == 0 && !a.pe && f.found && f.ssum > 1) ||
             (K > 0 && nacc > K);
  const int j = (int)(r.rand32 % (uint32_t)max(f.ssum, 1));
  f.sel_chain = j >= nfwd ? 1 : 0;
  const int target = (f.sel_chain ? j - nfwd : j) + 1;

  // pass 3: the target-th hit of level ii on the selected chain, the first
  // level-0 forward hit (full rows), and the compacted hit list
  const int W = 2 * MS + 17;
  int nsel = 0, sel_s = cands, h00_s = lean ? -1 : cands, nhit = 0;
  for (int c = 0; c < nchunk; ++c) {
    if (sel_s < cands && h00_s < cands && nhit >= K) break;
    int info;
    const bool in = info_at(c, info);
    const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    const int chain = (info >> BSM_INFO_CHAIN_SHIFT) & 1;
    const bool acc = in && bsm_k4_acc_pre(info, rrbs) && rank <= s_star;
    const int s0 = rstart + c * 32;
    if (sel_s == cands) {
      const bool p = acc && wmm == f.ii && chain == f.sel_chain;
      const unsigned bs = ballot(p);
      const unsigned at =
          ballot(p && nsel + __popc(bs & below) + 1 == target);
      if (at) sel_s = s0 + __ffs(at) - 1;
      nsel += __popc(bs);
    }
    if (h00_s == cands) {
      const unsigned h = ballot(acc && wmm == 0 && chain == 0);
      if (h) h00_s = s0 + __ffs(h) - 1;
    }
    if (nhit < K) {
      const unsigned ba = ballot(acc);
      const int k = nhit + __popc(ba & below);
      if (acc && k < K) {
        const int s = s0 + lane;
        sl[W + k] = c == 0 ? wloc0 : a.cwloc[s];
        sl[W + K + k] = wmm | (chain << 4) | (rank << 5) |
                        (int)((uint32_t)(c == 0 ? chrp0 : a.cchrp[s]) << 9);
      }
      nhit += __popc(ba);
    }
  }
  // a pick in the first chunk by shuffle (s is the same on every lane)
  auto pick = [&](int s, int& cp, int& wl) {
    if (s < cands && s - rstart < 32) {
      cp = __shfl_sync(full, chrp0, s - rstart);
      wl = __shfl_sync(full, wloc0, s - rstart);
    } else {
      bsm_k4_at(a, r, s, cp, wl);
    }
  };
  pick(sel_s, f.sel_chrp, f.sel_wloc);
  f.h00 = h00_s < cands;
  if (!lean) pick(h00_s, f.h00_chrp, f.h00_wloc);
  f.nhit = nhit;
  bsm_k4_write(a, b, r, f, sl, lane == 0, lane, 32);
}

// The row of a read with few candidates, by a lane alone: plain loops over
// the candidates (their loads pipeline, the passes after the first find
// them in L1), the first nonempty level, its count and its forward count
// kept in registers while counting; the (level, chain) histogram goes to
// the read's slice only where the row carries it (full rows), or where a
// level may reach max_num_hits (at least that many accepted hits).
static __device__ __forceinline__ void bsm_k4_lane(const BsmK4& a, int b,
                                                   const BsmK4Read& r,
                                                   int* sl) {
  const int MS = a.MS, cands = a.cands, rrbs = a.rrbs;
  const bool lean = a.lean;
  const int K = lean ? 0 : a.hits_k;
  const int rstart = r.rstart, maxrank = r.maxrank;
  const int hi = min(r.rend, cands);
  // the first candidate's words, with its info (the usual pick)
  const int chrp0 = hi > rstart ? a.cchrp[rstart] : 0;
  const int wloc0 = hi > rstart ? a.cwloc[rstart] : 0;
  // pass 1: the stop rank s* (SE only)
  BsmK4Found f;
  f.any_stop = false;
  int s_star = MS - 1;
  if (!a.pe && !rrbs) {
    int v = 1 << 30;
    for (int s = rstart; s < hi; ++s) {
      const int info = a.cinfo[s];
      if (bsm_k4_acc_pre(info, rrbs))
        v = min(v, max((info >> BSM_INFO_RANK_SHIFT) & 0x1F,
                       (info >> BSM_INFO_WMM_SHIFT) & 0xFF));
    }
    f.any_stop = v <= min(maxrank, MS - 1);
    if (f.any_stop) s_star = v;
  }
  // pass 2: the accepted total, dedup exhaustion, the least counted level
  // with its count and forward count; the histogram for full rows
  if (!lean)
    for (int l = 0; l < 2 * MS; ++l) sl[l] = 0;
  int nacc = 0, ii = MS, ssum = 0, nfwd = 0;
  bool dd = false;
  for (int s = rstart; s < hi; ++s) {
    const int info = a.cinfo[s];
    if (info & BSM_INFO_UNRESOLVED) dd = true;
    const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    if (!bsm_k4_acc_pre(info, rrbs) ||
        ((info >> BSM_INFO_RANK_SHIFT) & 0x1F) > s_star)
      continue;
    ++nacc;
    if (wmm >= MS) continue;
    const int chain = (info >> BSM_INFO_CHAIN_SHIFT) & 1;
    if (wmm < ii) {
      ii = wmm;
      ssum = 0;
      nfwd = 0;
    }
    if (wmm == ii) {
      ++ssum;
      nfwd += chain == 0;
    }
    if (!lean) ++sl[2 * wmm + chain];
  }
  f.found = ii < MS;
  f.ii = f.found ? ii : 0;
  f.ssum = ssum;
  // a level at max_num_hits: only possible with that many accepted hits
  bool lvl_full = a.max_num_hits <= 0;
  if (!lvl_full && f.found && nacc >= a.max_num_hits) {
    if (lean) {                              // level counts, once
      for (int l = 0; l < MS; ++l) sl[2 * l] = sl[2 * l + 1] = 0;
      for (int s = rstart; s < hi; ++s) {
        const int info = a.cinfo[s];
        const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
        if (bsm_k4_acc_pre(info, rrbs) &&
            ((info >> BSM_INFO_RANK_SHIFT) & 0x1F) <= s_star && wmm < MS)
          ++sl[2 * wmm];
      }
    }
    for (int l = 0; l < MS; ++l)
      if (sl[2 * l] + sl[2 * l + 1] >= a.max_num_hits) lvl_full = true;
  }
  f.replay = lvl_full || dd ||
             (a.rrh == 0 && !a.pe && f.found && ssum > 1) ||
             (K > 0 && nacc > K);
  const int j = (int)(r.rand32 % (uint32_t)max(ssum, 1));
  f.sel_chain = j >= nfwd ? 1 : 0;
  const int target = (f.sel_chain ? j - nfwd : j) + 1;

  // pass 3: the target-th hit of level ii on the selected chain, the first
  // level-0 forward hit (full rows), and the compacted hit list
  const int W = 2 * MS + 17;
  int nsel = 0, sel_s = cands, h00_s = lean ? -1 : cands, nhit = 0;
  for (int s = rstart; s < hi; ++s) {
    if (sel_s < cands && h00_s < cands && nhit >= K) break;
    const int info = a.cinfo[s];
    const int rank = (info >> BSM_INFO_RANK_SHIFT) & 0x1F;
    if (!bsm_k4_acc_pre(info, rrbs) || rank > s_star) continue;
    const int wmm = (info >> BSM_INFO_WMM_SHIFT) & 0xFF;
    const int chain = (info >> BSM_INFO_CHAIN_SHIFT) & 1;
    if (wmm == f.ii && chain == f.sel_chain && ++nsel == target) sel_s = s;
    if (chain == 0 && wmm == 0 && h00_s == cands) h00_s = s;
    if (nhit < K) {
      sl[W + nhit] = a.cwloc[s];
      sl[W + K + nhit] = wmm | (chain << 4) | (rank << 5) |
                         (int)((uint32_t)a.cchrp[s] << 9);
      ++nhit;
    }
  }
  // a pick at the first candidate from registers
  auto pick = [&](int s, int& cp, int& wl) {
    if (s < cands && s == rstart) {
      cp = chrp0;
      wl = wloc0;
    } else {
      bsm_k4_at(a, r, s, cp, wl);
    }
  };
  pick(sel_s, f.sel_chrp, f.sel_wloc);
  f.h00 = h00_s < cands;
  if (!lean) pick(h00_s, f.h00_chrp, f.h00_wloc);
  f.nhit = nhit;
  bsm_k4_write(a, b, r, f, sl, true, 0, 1);
}

__global__ void __launch_bounds__(BSM_K4_THREADS)
    bsm_reduce_reads_kernel(const BsmK4 a) {
  extern __shared__ int k4_sh[];
  const int lane = threadIdx.x & 31, wbase = threadIdx.x & ~31;
  const int b0 = blockIdx.x * BSM_K4_THREADS + wbase;
  if (b0 >= a.m) return;                    // the whole warp leaves
  const int nr = min(32, a.m - b0);
  const bool live = lane < nr;
  bool lng = false;
  if (live) {
    const BsmK4Read r = bsm_k4_facts(a, b0 + lane);
    lng = min(r.rend, a.cands) - r.rstart > 32;
    if (!lng) bsm_k4_lane(a, b0 + lane, r, k4_sh + (wbase + lane) * a.Wt);
  }
  // the long reads, one after another by the whole warp
  for (unsigned todo = __ballot_sync(0xFFFFFFFFu, lng); todo;
       todo &= todo - 1) {
    const int rl = __ffs(todo) - 1;
    bsm_k4_warp(a, b0 + rl, bsm_k4_facts(a, b0 + rl), lane,
                k4_sh + (wbase + rl) * a.Wt);
  }
  if (a.lean) return;
  __syncwarp();
  // the warp's full rows, one contiguous span of the output
  const int Wout = 2 * a.MS + 17 + 2 * a.hits_k;
  int* o = a.out + (size_t)b0 * Wout;
  const int* src = k4_sh + wbase * a.Wt;
  for (int r = 0; r < nr; ++r)
    for (int c = lane; c < Wout; c += 32) o[r * Wout + c] = src[r * a.Wt + c];
}

extern "C" int bsmap_reduce_reads(const int* rows, int m, int nw, int MS,
                                  int I, int S, int nch, int cands,
                                  const int* starts, const int* cchrp,
                                  const int* cwloc, const int* cinfo,
                                  const int* ftot_rank, const int* soff,
                                  const int* coff, int max_num_hits, int rrh,
                                  int lean, int fixed, int pe, int rrbs,
                                  int hits_k, int* out, cudaStream_t stream) {
  // a read's slice (dynamic shared memory, 128 slices a block): its
  // counters and, for full rows, its row; an odd count of words
  const int need = lean ? 2 * MS : 2 * MS + 17 + 2 * hits_k;
  const int Wt = need | 1;
  const BsmK4 a{rows, m, nw, MS, I, S, nch, cands, starts, cchrp, cwloc,
                cinfo, ftot_rank, soff, coff, max_num_hits, rrh, lean,
                fixed, pe, rrbs, hits_k, Wt, out};
  if (m > 0) {
    const int blocks = (m + BSM_K4_THREADS - 1) / BSM_K4_THREADS;
    const size_t smem = sizeof(int) * BSM_K4_THREADS * Wt;
    bsm_reduce_reads_kernel<<<blocks, BSM_K4_THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
