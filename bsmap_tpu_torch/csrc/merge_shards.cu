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
// Input: D region shards' K3 output for the same window, each where it
// lies (a table of D device pointers per field: `starts` (m*NB + 1),
// `chrp`/`wloc`/`info` (CANDS)), each shard's full-rank candidate total
// (column maxseg-1 of its ftot_rank) and shard 0's start offsets.  Output:
// the full rows of K4's layout (counts, the 17 X_* extras, 2K hit columns).
// Per read, the candidates of all shards are taken in GLOBAL discovery
// order (bsmap_tpu/parallel/index_sharded.py:9-14): slot by slot, the
// Watson candidates of shards 0..D-1, then the Crick candidates of shards
// D-1..0 (Crick coordinates ascend as Watson positions descend, so a
// bucket's Crick run meets the regions in descending order).  In that
// order K4's logic holds as it is: the early exit takes the best level of
// each rank over all shards (pmin), the counts, dedup failures and corner
// candidates sum over all shards (psum), the pick is the target-th hit of
// the selected level and chain (global_rank_of), the first level-0
// forward hit is the first in this order, and the hit list is compacted
// in it.  A read with no pick gets 0s (the psum of nothing).  totals sum
// the shards' totals (int32, wrapping), ok needs every shard's read end
// within CANDS, big is any shard's own total past it, ftot is the largest
// shard's.
//
// Bound on the card: the bytes of every shard's NB+1 slot starts of a read
// (D*(NB+1) words), its ftot, one sector of its row, soff/coff, 12 bytes a
// candidate and the row written once; the operations are a few tens a
// candidate.  On the repeat-heavy windows most reads have no candidate in
// the capacity, most of the rest a few tens, and a tail hundreds to
// thousands (PERF.md section 6: 8 and 64 a read on average, up to 691
// and 2,733).  Measured on the H100 (a clock per phase of every read): a
// read's work is latency, a short chain of loads, shuffles and shared
// memory steps, and the longest reads set the kernel's length whenever
// their chunks are fetched one dependent load after another.  Design: a
// warp per read, two reads a block (measured against one and four).
//
//  * One load round takes the row's scalars, soff/coff and every shard's
//    ftot (a lane each), every shard's run ends, and every shard's NB+1
//    slot starts into shared memory (their addresses need nothing
//    loaded); totals, ok, big, ftot and the in-capacity count come from
//    single-instruction warp reductions.  A read with no candidate in the
//    capacity writes its row right there.
//  * The read's candidates of all shards form one flattened range
//    (shard-major, each shard's in index order), strided by the lanes in
//    chunks of 32.  Each of the first 1,024 gets a packed word in shared
//    memory, built once from its info and chrp words (coalesced within a
//    shard) and its slot (a binary search of its shard's staged starts):
//    the info bits the passes read, its strand (chrp & 1), shard and slot.
//    Every later pass reads only these words; a longer read rebuilds the
//    words past them.
//  * The stop rank is one min over the FIRST candidates of max(rank, wmm)
//    (as K4: prefmin(r) <= r iff some candidate has max(rank, wmm) <= r);
//    dedup failure and corner bits come from __any_sync, the (level,
//    chain) counts from a ballot per label present, the accepted total
//    from ballots.
//  * The order is a key, not a walk: a candidate's place is the twin's key
//    (slot, strand, shard in strand order, index).  The pick is the
//    accepted candidate of level ii and chain sel_chain with exactly
//    target-1 such candidates of smaller key; the hit list the accepted
//    candidates of rank below K; the first level-0 forward hit the least
//    key.
//     - With at most 32 accepted candidates (nearly every read), their
//       keys are compacted into shared memory, one a lane, and each is
//       ranked against the others by shuffles.
//     - With more, the accepted (and picked) candidates are counted per
//       (shard, slot, strand) and each shard's counts scanned: a
//       candidate's rank is its place within its own shard (a running
//       ballot count over the flattened range) plus, for every other
//       shard, that shard's count before its (slot, strand, shard)
//       position: O(candidates + D*NB) per read, whatever the count.
//    The chrp and wloc words are loaded only for what the row holds.
//  * The row is staged in shared memory and stored by the warp as one
//    contiguous span.  No per-thread array is indexed by data (0 B stack):
//    the pointer tables go to shared memory, the kernel argument is a
//    __grid_constant__ struct.

#include <algorithm>
#include <climits>

#include "common.cuh"

#define BSM_K7_WARPS 2          // warps (reads) a block, at most
#define BSM_K7_FIELDS 5         // per shard: starts, chrp, wloc, info, ftot
#define BSM_K7_CACHE 32         // chunks of packed candidate words kept in
                                // shared memory (1,024 candidates)
#define BSM_K7_SMEM_DEFAULT (48 * 1024)

enum { K7_STARTS = 0, K7_CHRP = 1, K7_WLOC = 2, K7_INFO = 3, K7_FTOT = 4 };

// A candidate's packed word: what the passes read of its info word, its
// strand (chrp & 1), its shard and its read-local slot.
#define K7_P_WMM(p) ((p) & 0xFF)
#define K7_P_RANK(p) (((p) >> 8) & 0x1F)
#define K7_P_CHAIN(p) (((p) >> 13) & 1)
#define K7_P_FIRST (1 << 14)
#define K7_P_UNRES (1 << 15)
#define K7_P_CORNER (1 << 16)
#define K7_P_CB(p) (((p) >> 17) & 1)
#define K7_P_D(p) (((p) >> 18) & 0xF)
#define K7_P_Q(p) ((int)((unsigned)(p) >> 22))

struct BsmK7 {
  const int* rows;
  int m, nw, MS, I, S, nch, D, cands;
  // field f of shard d at ptr[f * BSM_MAX_SHARDS + d]; K7_FTOT points at
  // column maxseg-1 of the shard's (m, maxseg) ftot_rank
  const int* ptr[BSM_K7_FIELDS * BSM_MAX_SHARDS];
  const int* soff;
  const int* coff;
  int max_num_hits, rrh, pe, hits_k;
  int lg_sp;                    // log2 of a shard's stride of staged starts
  int Wt;                       // words of a warp's slice of shared memory
  int* out;
};

// A read's staged state in its warp's slice: the shards' NB + 1 slot
// starts (stride 1 << lg_sp), the prefix of their in-capacity counts.
struct BsmK7Read {
  const int* st;
  const int* pre;
  int D, NB, L, lg_sp, n;
};

// Candidate t of the read's flattened range (shard-major, each shard's in
// index order): its shard d and index s; false past the range.
static __device__ __forceinline__ bool bsm_k7_cand(const BsmK7Read& r, int t,
                                                   int& d, int& s) {
  d = 0;
  for (int e = 1; e < r.D; ++e) d += r.pre[e] <= t;
  s = r.st[d << r.lg_sp] + t - r.pre[d];
  return t < r.n;
}

// The read-local slot q of candidate s of shard d: st[q] <= s < st[q + 1].
static __device__ __forceinline__ int bsm_k7_slot(const BsmK7Read& r, int d,
                                                  int s) {
  const int* x = r.st + (d << r.lg_sp);
  int lo = 0, hi = r.NB;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= s)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Candidate t's packed word (0 past the range), from its info and chrp
// words and its slot.
static __device__ __forceinline__ int bsm_k7_pack(const BsmK7Read& r,
                                                  const int* const* p_info,
                                                  const int* const* p_chrp,
                                                  int t) {
  int d, s;
  if (!bsm_k7_cand(r, t, d, s)) return 0;
  const int info = p_info[d][s], cb = p_chrp[d][s] & 1;
  return ((info >> BSM_INFO_WMM_SHIFT) & 0xFF) |
         (((info >> BSM_INFO_RANK_SHIFT) & 0x1F) << 8) |
         (((info >> BSM_INFO_CHAIN_SHIFT) & 1) << 13) |
         ((info & BSM_INFO_FIRST) ? K7_P_FIRST : 0) |
         ((info & BSM_INFO_UNRESOLVED) ? K7_P_UNRES : 0) |
         ((info & BSM_INFO_CORNER) ? K7_P_CORNER : 0) | (cb << 17) |
         (d << 18) | (bsm_k7_slot(r, d, s) << 22);
}

// The twin's order of candidates: slot q, strand cb, the shard in the
// strand's order (Watson 0..D-1, Crick D-1..0), then the index.
static __device__ __forceinline__ int bsm_k7_bucket(int D, int p) {
  const int d = K7_P_D(p), cb = K7_P_CB(p);
  return (K7_P_Q(p) * 2 + cb) * D + (cb ? D - 1 - d : d);
}

// The candidates of the set counted in H (exclusive scans per shard) that
// come before candidate p's (slot, strand) on the other shards: on a lower
// shard its slot's Watson run too, on a higher one its Crick run too where
// the candidate is a Crick one; less the lower shards' totals, which the
// flattened running count holds.
static __device__ __forceinline__ int bsm_k7_cross(const BsmK7Read& r,
                                                   const int* H, int p) {
  const int d = K7_P_D(p), q = K7_P_Q(p), cb = K7_P_CB(p);
  int x = 0;
  for (int e = 0; e < r.D; ++e) {
    if (e < d)
      x += H[e * r.L + 2 * q + 1] - H[e * r.L + 2 * r.NB];
    else if (e > d)
      x += H[e * r.L + 2 * q + 2 * cb];
  }
  return x;
}

// Read b's row by the warp; `sl` is the warp's slice of shared memory,
// `ptr` the shards' pointer table (shared memory).
static __device__ __forceinline__ void bsm_k7_read(const BsmK7& a,
                                                   const int* const* ptr,
                                                   int b, int lane, int* sl) {
  const unsigned full = 0xFFFFFFFFu, below = (1u << lane) - 1u;
  const int MS = a.MS, D = a.D, cands = a.cands, K = a.hits_k;
  const int NB = MS * a.nch * a.I, L = 2 * NB + 1, lg = a.lg_sp;
  const int W = 2 * MS + 17, Wout = W + 2 * K;
  int* st = sl;                 // D runs of the read's NB + 1 slot starts
  int* row = st + (D << lg);    // the output row
  int* pre = row + Wout;        // prefix of the shards' in-capacity counts
  int* mem = pre + D + 1;       // up to 32 accepted candidates: bucket,
                                // index, packed word
  int* pk = mem + 3 * 32;       // packed words of the first chunks
  int* hA = pk + 32 * BSM_K7_CACHE;  // per shard (slot, strand) counts of
  int* hP = hA + D * L;              // the accepted and picked candidates
  const int* const* p_info = ptr + K7_INFO * BSM_MAX_SHARDS;
  const int* const* p_chrp = ptr + K7_CHRP * BSM_MAX_SHARDS;
  const int* const* p_wloc = ptr + K7_WLOC * BSM_MAX_SHARDS;

  // one load round: the row's scalars, both start offsets and every
  // shard's ftot (a lane each), each shard's run ends (lane d), and every
  // shard's NB + 1 slot starts (used only by a read with candidates, but
  // their address needs nothing loaded)
  const int* sc = a.rows + (size_t)b * (2 * a.nw + 4) + 2 * a.nw;
  int fv = INT_MIN, rs = 0, re = 0;
  if (lane < 4)
    fv = sc[lane];
  else if (lane == 4)
    fv = a.soff[b];
  else if (lane == 5)
    fv = a.coff[b];
  else if (lane >= 8 && lane < 8 + D)
    fv = ptr[K7_FTOT * BSM_MAX_SHARDS + lane - 8][(size_t)b * MS];
  if (lane < D) {
    const int* x = ptr[K7_STARTS * BSM_MAX_SHARDS + lane] + (size_t)b * NB;
    rs = x[0];
    re = x[NB];
  }
  for (int i = lane; i < D << lg; i += 32) {
    const int k = i & ((1 << lg) - 1);
    if (k <= NB)
      st[i] = ptr[K7_STARTS * BSM_MAX_SHARDS + (i >> lg)][(size_t)b * NB + k];
  }
  const int len = __shfl_sync(full, fv, 0), bud = __shfl_sync(full, fv, 1);
  const uint32_t rand32 = (uint32_t)__shfl_sync(full, fv, 2);
  const int maxrank = __shfl_sync(full, fv, 3);
  const int soff = __shfl_sync(full, fv, 4), coff = __shfl_sync(full, fv, 5);
  const int ft = __reduce_max_sync(full, lane >= 8 ? fv : INT_MIN);

  // per shard (lane d): its in-capacity count, total, ok and big bits;
  // the prefix of the counts over the shards
  const int nd = lane < D ? max(0, min(re, cands) - rs) : 0;
  const unsigned totals =
      __reduce_add_sync(full, lane < D ? (unsigned)(re - rs) : 0u);
  const bool ok = __all_sync(full, lane >= D || re <= cands);
  const bool big = __any_sync(full, lane < D && re - rs > cands);
  int inc = nd;
  for (int off = 1; off < D; off <<= 1) {
    const int v = __shfl_up_sync(full, inc, off);
    if (lane >= off) inc += v;
  }
  const int n = __shfl_sync(full, inc, D - 1);
  const bool seeded = maxrank >= bsm_seedseg(len, bud, a.S, a.I, MS) - 1;
  // extra x of the row (X_*), but the pick's and the first level-0 forward
  // hit's words
  auto extra = [&](int x, bool found, int ii, int ssum, int sel_chain,
                   bool h00, bool replay, bool any_stop) {
    int v = x == 0 ? (int)found : 0;
    v = x == 1 ? ii : v;
    v = x == 2 ? ssum : v;
    v = x == 3 ? sel_chain : v;
    v = x == 6 ? (int)h00 : v;
    v = x == 9 ? (int)replay : v;
    v = x == 10 ? (int)totals : v;
    v = x == 11 ? soff : v;
    v = x == 12 ? coff : v;
    v = x == 13 ? (int)ok : v;
    v = x == 14 ? (int)big : v;
    v = x == 15 ? (int)(a.pe || any_stop || seeded) : v;
    return x == 16 ? ft : v;
  };
  if (n == 0) {
    // no candidate in the capacity: no pick (rand32 % 1 = 0 draws the rc
    // chain), a level "full" only at -w 0 or below; straight to the output
    int* o = a.out + (size_t)b * Wout;
    for (int i = lane; i < Wout; i += 32) {
      const int x = i - 2 * MS;
      o[i] = i >= W + K ? -1
             : x >= 0 && x < 17
                 ? extra(x, false, 0, 0, 1, false, a.max_num_hits <= 0,
                         false)
                 : 0;
    }
    return;
  }

  // the packed words of the first BSM_K7_CACHE chunks into shared memory
  // (unrolled so that several chunks' info and chrp loads can be in flight)
  if (lane < D) pre[lane + 1] = inc;
  if (lane == 0) pre[0] = 0;
  for (int i = lane; i < Wout; i += 32) row[i] = i >= W + K ? -1 : 0;
  __syncwarp();
  const BsmK7Read r{st, pre, D, NB, L, lg, n};
  const int nchunk = (n + 31) >> 5;
  const int ncache = min(nchunk, BSM_K7_CACHE);
#pragma unroll 4
  for (int c = 0; c < ncache; ++c)
    pk[c * 32 + lane] = bsm_k7_pack(r, p_info, p_chrp, c * 32 + lane);
  __syncwarp();
  auto word = [&](int c) {
    return c < BSM_K7_CACHE ? pk[c * 32 + lane]
                            : bsm_k7_pack(r, p_info, p_chrp, c * 32 + lane);
  };

  // pass 1: the stop rank s* (SE only), dedup failure, corner candidates
  int v = INT_MAX;
  bool dd = false, corner = false;
  for (int c = 0; c < nchunk; ++c) {
    const int p = word(c);
    if (p & K7_P_FIRST) v = min(v, max(K7_P_RANK(p), K7_P_WMM(p)));
    dd = dd || (p & K7_P_UNRES);
    corner = corner || (p & K7_P_CORNER);
  }
  v = __reduce_min_sync(full, v);
  dd = __any_sync(full, dd);
  corner = __any_sync(full, corner);
  const bool any_stop = !a.pe && v <= min(maxrank, MS - 1);
  // pair-end runs every segment: every FIRST candidate is accepted
  const int s_lim = a.pe ? 31 : any_stop ? v : MS - 1;
  auto accepted = [&](int p) {
    return (p & K7_P_FIRST) && K7_P_RANK(p) <= s_lim;
  };

  // pass 2: the (level, chain) counts (a ballot per label present), the
  // accepted total
  int nacc = 0;
  for (int c = 0; c < nchunk; ++c) {
    const int p = word(c);
    const bool acc = accepted(p);
    const int lab = acc && K7_P_WMM(p) < MS ? 2 * K7_P_WMM(p) + K7_P_CHAIN(p)
                                            : -1;
    for (unsigned mm = __ballot_sync(full, lab >= 0); mm;) {
      const int l = __shfl_sync(full, lab, __ffs(mm) - 1);
      const unsigned eq = __ballot_sync(full, lab == l);
      if (lane == 0) row[l] += __popc(eq);
      mm &= ~eq;
    }
    nacc += __popc(__ballot_sync(full, acc));
  }
  __syncwarp();
  const int lv = lane < MS ? row[2 * lane] + row[2 * lane + 1] : 0;
  const unsigned nz = __ballot_sync(full, lv > 0);
  const bool found = nz != 0;
  const int ii = found ? __ffs(nz) - 1 : 0;
  const bool lvl_full = __any_sync(full, lane < MS && lv >= a.max_num_hits);
  const int nfwd = row[2 * ii], ssum = nfwd + row[2 * ii + 1];
  const bool replay = lvl_full || dd || corner ||
                      (a.rrh == 0 && !a.pe && found && ssum > 1) ||
                      (K > 0 && nacc > K);
  const int j = (int)(rand32 % (uint32_t)max(ssum, 1));
  const int sel_chain = j >= nfwd ? 1 : 0;
  const int target = (sel_chain ? j - nfwd : j) + 1;
  // of the picked level and chain (P), of level 0 on the forward chain (H)
  auto picked = [&](int p) {
    return found && K7_P_WMM(p) == ii && K7_P_CHAIN(p) == sel_chain;
  };
  auto first00 = [&](int p) {
    return K7_P_WMM(p) == 0 && K7_P_CHAIN(p) == 0;
  };
  // candidate t's index, its chrp and wloc words; the row words of a hit
  auto index_of = [&](int t, int p) {
    const int d = K7_P_D(p);
    return st[d << lg] + t - pre[d];
  };
  auto hit_word = [&](int p, int cp) {
    return K7_P_WMM(p) | (K7_P_CHAIN(p) << 4) | (K7_P_RANK(p) << 5) |
           (int)((uint32_t)cp << 9);
  };

  bool h00;
  if (nacc <= 32) {
    // at most 32 accepted: their keys compacted in discovery order into
    // shared memory, member l on lane l; each member ranked against the
    // others by shuffles
    int run = 0;
    for (int c = 0; c < nchunk && run < nacc; ++c) {
      const int p = word(c);
      const bool acc = accepted(p);
      const unsigned bA = __ballot_sync(full, acc);
      if (acc) {
        const int at = run + __popc(bA & below);
        mem[at] = bsm_k7_bucket(D, p);
        mem[32 + at] = index_of(c * 32 + lane, p);
        mem[64 + at] = p;
      }
      run += __popc(bA);
    }
    __syncwarp();
    const bool mine = lane < nacc;
    const int kh = mine ? mem[lane] : 0, kl = mine ? mem[32 + lane] : 0;
    const int p = mine ? mem[64 + lane] : 0;
    const bool pkd = mine && picked(p), h0 = mine && first00(p);
    const unsigned bP = __ballot_sync(full, pkd), bH = __ballot_sync(full, h0);
    int rA = 0, rP = 0, rH = 0;
    for (int l = 0; l < nacc; ++l) {
      const int hl = __shfl_sync(full, kh, l), ll = __shfl_sync(full, kl, l);
      const bool lt = hl < kh || (hl == kh && ll < kl);
      rA += lt;
      rP += lt && ((bP >> l) & 1u);
      rH += lt && ((bH >> l) & 1u);
    }
    const bool hit = mine && rA < K, pick = pkd && rP == target - 1;
    const bool first = h0 && rH == 0;
    if (hit || pick || first) {
      const int d = K7_P_D(p);
      const int cp = p_chrp[d][kl], wl = p_wloc[d][kl];
      if (hit) {
        row[W + rA] = wl;
        row[W + K + rA] = hit_word(p, cp);
      }
      if (pick) {
        row[2 * MS + 4] = cp;               // X_CHRP, X_WLOC
        row[2 * MS + 5] = wl;
      }
      if (first) {
        row[2 * MS + 7] = cp;               // X_H00C, X_H00W
        row[2 * MS + 8] = wl;
      }
    }
    h00 = bH != 0;
  } else {
    // more: per shard (slot, strand) counts of the accepted (for the hit
    // list) and of the picked candidates, each shard's exclusive scan in
    // place (the last entry its total); a candidate's rank is its place
    // in its own shard (the flattened running count) plus the other
    // shards' counts before its (slot, strand, shard) position
    for (int i = lane; i < 2 * D * L; i += 32) hA[i] = 0;
    __syncwarp();
    for (int c = 0; c < nchunk; ++c) {
      const int p = word(c);
      if (!accepted(p)) continue;
      const int x = K7_P_D(p) * L + 2 * K7_P_Q(p) + K7_P_CB(p);
      if (K > 0) atomicAdd(&hA[x], 1);
      if (picked(p)) atomicAdd(&hP[x], 1);
    }
    __syncwarp();
    for (int h = K > 0 ? 0 : 1; h < (found ? 2 : 1); ++h) {
      int* H = h == 0 ? hA : hP;
      for (int e = 0; e < D; ++e) {
        int carry = 0;
        for (int i0 = 0; i0 < L; i0 += 32) {
          const int i = i0 + lane;
          const int x = i < L ? H[e * L + i] : 0;
          int y = x;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(full, y, off);
            if (lane >= off) y += u;
          }
          if (i < L) H[e * L + i] = carry + y - x;
          carry += __shfl_sync(full, y, 31);
        }
      }
    }
    __syncwarp();
    // the ranks; the hit list, the pick, the least key of the level-0
    // forward hits (its words loaded after the warp's min)
    unsigned long long hk = ULLONG_MAX;
    int runA = 0, runP = 0;
    for (int c = 0; c < nchunk; ++c) {
      const int p = word(c);
      const bool acc = accepted(p), pkd = acc && picked(p);
      const unsigned bA = __ballot_sync(full, acc);
      const unsigned bP = __ballot_sync(full, pkd);
      if (acc) {
        const int rA = K > 0 ? runA + __popc(bA & below) + bsm_k7_cross(r, hA, p)
                             : K;
        const bool pick = pkd && runP + __popc(bP & below) +
                                         bsm_k7_cross(r, hP, p) == target - 1;
        const int s = index_of(c * 32 + lane, p);
        if (rA < K || pick) {
          const int d = K7_P_D(p);
          const int cp = p_chrp[d][s], wl = p_wloc[d][s];
          if (rA < K) {
            row[W + rA] = wl;
            row[W + K + rA] = hit_word(p, cp);
          }
          if (pick) {
            row[2 * MS + 4] = cp;           // X_CHRP, X_WLOC
            row[2 * MS + 5] = wl;
          }
        }
        const unsigned long long key =
            ((unsigned long long)bsm_k7_bucket(D, p) << 32) | (unsigned)s;
        if (first00(p) && key < hk) hk = key;
      }
      runA += __popc(bA);
      runP += __popc(bP);
    }
    // the least key: of its high words, then of the low words beside it;
    // the bucket gives the shard, the low word the index
    const unsigned kh = __reduce_min_sync(full, (unsigned)(hk >> 32));
    const unsigned kl = __reduce_min_sync(
        full, (unsigned)(hk >> 32) == kh ? (unsigned)hk : UINT_MAX);
    h00 = kh != UINT_MAX;
    if (h00 && lane == 0) {
      const int dd_ = (int)(kh % (unsigned)D), cb = (int)(kh / D) & 1;
      const int d = cb ? D - 1 - dd_ : dd_;
      row[2 * MS + 7] = p_chrp[d][kl];      // X_H00C, X_H00W
      row[2 * MS + 8] = p_wloc[d][kl];
    }
  }
  if (lane < 17 && lane != 4 && lane != 5 && lane != 7 && lane != 8)
    row[2 * MS + lane] = extra(lane, found, ii, ssum, sel_chain, h00, replay,
                               any_stop);
  __syncwarp();
  int* o = a.out + (size_t)b * Wout;
  for (int i = lane; i < Wout; i += 32) o[i] = row[i];
}

__global__ void __launch_bounds__(32 * BSM_K7_WARPS)
    bsm_merge_shards_kernel(const __grid_constant__ BsmK7 a) {
  __shared__ const int* ptr[BSM_K7_FIELDS * BSM_MAX_SHARDS];
  extern __shared__ int k7_sh[];
  for (int i = threadIdx.x; i < BSM_K7_FIELDS * BSM_MAX_SHARDS;
       i += blockDim.x)
    ptr[i] = a.ptr[i];
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= a.m) return;                     // the whole warp leaves
  bsm_k7_read(a, ptr, b, threadIdx.x & 31, k7_sh + w * a.Wt);
}

// shard_ptrs: host array of BSM_K7_FIELDS * D device pointers, field-major
// (every shard's starts, then chrp, wloc, info, ftot column maxseg-1).
extern "C" int bsmap_merge_shards(const int* rows, int m, int nw, int MS,
                                  int I, int S, int nch, int D, int cands,
                                  const int* const* shard_ptrs,
                                  const int* soff, const int* coff,
                                  int max_num_hits, int rrh, int pe,
                                  int hits_k, int* out, cudaStream_t stream) {
  if (D < 1 || D > BSM_MAX_SHARDS || MS < 1 || MS > BSM_MAX_MS)
    return (int)cudaErrorInvalidValue;
  BsmK7 a{};
  a.rows = rows;
  a.m = m;
  a.nw = nw;
  a.MS = MS;
  a.I = I;
  a.S = S;
  a.nch = nch;
  a.D = D;
  a.cands = cands;
  for (int f = 0; f < BSM_K7_FIELDS; ++f)
    for (int d = 0; d < D; ++d)
      a.ptr[f * BSM_MAX_SHARDS + d] = shard_ptrs[f * D + d];
  a.soff = soff;
  a.coff = coff;
  a.max_num_hits = max_num_hits;
  a.rrh = rrh;
  a.pe = pe;
  a.hits_k = hits_k;
  a.out = out;
  // a warp's slice: the starts (a power-of-two stride a shard), the row,
  // the prefix, the accepted members, the packed words, two count tables
  const int NB = MS * nch * I;
  a.lg_sp = 0;
  while ((1 << a.lg_sp) < NB + 1) ++a.lg_sp;
  a.Wt = (D << a.lg_sp) + 2 * MS + 17 + 2 * hits_k + D + 1 + 3 * 32 +
         32 * BSM_K7_CACHE + 2 * D * (2 * NB + 1);
  if (m <= 0) return (int)cudaGetLastError();
  const size_t per = sizeof(int) * (size_t)a.Wt;
  const int warps = (int)std::max<size_t>(
      1, std::min<size_t>(BSM_K7_WARPS, BSM_K7_SMEM_DEFAULT / per));
  const size_t smem = per * warps;
  if (smem > BSM_K7_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsm_merge_shards_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bsm_merge_shards_kernel<<<(m + warps - 1) / warps, 32 * warps, smem,
                            stream>>>(a);
  return (int)cudaGetLastError();
}
