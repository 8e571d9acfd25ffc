// K3 verify_candidates: candidate layout, verify and dedup.
//
// Replaces the candidate stage of bsmap_tpu/engine/device_engine.py:
// _verify_impl (:692-897), unsharded, one chain or both (`mode` 0 forward,
// 1 rc, 2 both; the rc chain's words are K5's rows: `rows` under mode 1,
// `rows_rc` under mode 2).  Three parts:
//
//  1. bsm_slot_scan: saturating (2^30) exclusive scan of the B*NB slot
//     counts -> `starts` (total last), and the last non-empty slot that
//     starts inside the capacity.  One block: each of 1024 threads sums a
//     contiguous chunk, a shared-memory scan joins the chunks.
//  2. bsm_verify: one thread per candidate.  upper_bound over `starts`
//     finds the candidate's slot (replacing the scatter-max + running max
//     at :703-706), and the slot its segment rank and chain (slots run
//     (rank, chain, phase) within a read, :710-715); then the Watson/Crick
//     entry, g = entry + h (uint32), the NW+1 catcat words, the 2-bit phase
//     shift, the XOR/__popc CountMismatch lanes against the chain's words
//     (align.h:167-200, :786-790), the chromosome by binary
//     search over `anchors` (searchsorted right - 1), the Crick watson
//     coordinate, the bounds check and the budget.  The last capacity slot
//     is always evaluated, live or not, because the JAX program's
//     selection falls back to its values for reads with no pick.  The
//     chain goes into the info word (INFO_CHAIN) for K4.
//     Under `rrbs` (:724-738, :802-812) the entry is a chromosome-local loc
//     of the slot's own tag class and its tag names the chromosome and
//     strand (no search); loc + h must be >= 0.  An eligible candidate
//     then gets the SE fragment filter's verdict (CCGG_seglen, :866-897)
//     as the INFO_FRAG bit, which K4 ANDs into acceptance: the dedup below
//     still counts a filtered hit, as the reference inserts into its
//     hitset before the filter.
//     Under index sharding (`bounds` given; the tables are region
//     `shard`'s) an eligible candidate whose dedup key anchors[c] + wloc
//     (uint32) lies in another shard's region gets the INFO_CORNER bit
//     (device_engine.py:852-864): its read replays on the host engine.
//  3. the dedup cascade on (read, chr, watson loc), which has no chain: a
//     forward and an rc hit at one locus share a key and the lower
//     discovery index claims it.  Three rounds of atomicMin of the
//     candidate index into T slots, then a resolve pass, with the JAX
//     program's multipliers, table size and slot hash so the replay bits
//     match its rows.
//
// Bound on the card: per candidate, two dependent random gathers (entry,
// then NW+1 genome words of one 32-44 byte span) plus a log2(n_chr)
// search (RRBS: two log2(n_sites) searches over the sites); the dedup
// rounds are atomics into a T-word table that fits L2.
// Design: thread per candidate over the flat candidate axis, so load is
// balanced whatever the bucket sizes; neighbouring threads read
// neighbouring entries of one bucket.

#include "common.cuh"

__global__ void bsm_fill_kernel(int* __restrict__ p, long long n, int v) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = v;
}

__global__ void bsm_slot_scan_kernel(const int* __restrict__ cnt, int N,
                                     int cands, int* __restrict__ starts,
                                     int* __restrict__ lastslot) {
  __shared__ long long part[1024];
  __shared__ int lastv;
  const int t = threadIdx.x, nt = blockDim.x;
  const int per = (N + nt - 1) / nt;
  const int lo = min(N, t * per), hi = min(N, lo + per);
  long long s = 0;
  for (int k = lo; k < hi; ++k) s += min(cnt[k], BSM_SATLIM);
  part[t] = s;
  if (t == 0) lastv = -1;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    long long v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - s;
  int last = -1;
  for (int k = lo; k < hi; ++k) {
    long long st = min(run, (long long)BSM_SATLIM);
    starts[k] = (int)st;
    int c = min(cnt[k], BSM_SATLIM);
    if (c > 0 && st < cands) last = k;
    run += c;
  }
  if (t == nt - 1) starts[N] = (int)min(part[nt - 1], (long long)BSM_SATLIM);
  atomicMax(&lastv, last);
  __syncthreads();
  if (t == 0) *lastslot = lastv;
}

// CCGG_seglen's fragment length test (device_engine.py:866-897,
// dbseq.cpp:541-567): upper_bound - 1 of anchor + wloc and lower_bound of
// the read's end - tail over the GLOBAL sorted uint32 sites, each clipped
// to chromosome c's range; seg_start is the floor site (never the last),
// seg_end the first site at or after the next one whose end covers the
// read, else the last site's end; no site on c gives zl = 0.
static __device__ bool bsm_frag_ok(const uint32_t* __restrict__ sites,
                                   int ns, const int* __restrict__ site_off,
                                   uint32_t anchor, int c, int wloc, int llen,
                                   int tail, int min_ins, int max_ins) {
  const int lo_c = site_off[c], nsit = site_off[c + 1] - lo_c;
  int zl = 0;
  if (nsit > 0) {
    const uint32_t key1 = anchor + (uint32_t)max(wloc, 0);
    int lo = 0, hi = ns;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (sites[mid] <= key1) lo = mid + 1; else hi = mid;
    }
    const int left = min(max(lo - 1, lo_c), max(lo_c + nsit - 2, lo_c));
    const int seg_start = (int)(sites[bsm_clampi(left, 0, ns - 1)] - anchor);
    const int right0 = min(left + 1, lo_c + nsit - 1);
    const int end = (int)((uint32_t)wloc + (uint32_t)llen - (uint32_t)tail);
    const uint32_t key2 = anchor + (uint32_t)max(end, 0);
    lo = 0;
    hi = ns;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (sites[mid] < key2) lo = mid + 1; else hi = mid;
    }
    const int right = min(max(max(right0, lo), lo_c), lo_c + nsit - 1);
    const uint32_t seg_end =
        sites[bsm_clampi(right, 0, ns - 1)] - anchor + (uint32_t)tail;
    zl = (int)(seg_end - (uint32_t)seg_start);
  }
  return zl >= min_ins && zl <= max_ins;
}

__global__ void bsm_verify_kernel(
    const int* __restrict__ rows, const int* __restrict__ rows_rc, int nw,
    int NB, int I, int mode, int cands, int N,
    const int* __restrict__ starts, const int* __restrict__ lastslot,
    const int* __restrict__ h, const int* __restrict__ off0,
    const int* __restrict__ off3, const int* __restrict__ wcnt,
    const uint32_t* __restrict__ catcat, int W,
    const uint32_t* __restrict__ anchors, int n_chr,
    const int* __restrict__ sizes, const int* __restrict__ rcoff,
    const uint32_t* __restrict__ wlocs, long long nwl,
    const uint32_t* __restrict__ clocs, long long ncl, int rrbs,
    const int* __restrict__ tags, const uint32_t* __restrict__ sites,
    const int* __restrict__ site_off, int nsites, int tail, int min_ins,
    int max_ins, int shard, const uint32_t* __restrict__ bounds,
    int nbounds, int* __restrict__ crid, int* __restrict__ cchrp,
    int* __restrict__ cwloc, int* __restrict__ cinfo) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cands) return;
  const int total = starts[N];
  const bool live = s < total;
  int fid;
  if (live) {
    // last slot starting at or before s (always the non-empty one that
    // holds s)
    int lo = 0, hi = N;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (starts[mid] <= s) lo = mid + 1; else hi = mid;
    }
    fid = lo - 1;
  } else if (s == cands - 1) {
    fid = max(*lastslot, 0);
  } else {
    crid[s] = 0;
    cchrp[s] = 0;
    cwloc[s] = 0;
    cinfo[s] = 0;
    return;
  }
  const int rid = fid / NB;
  const int bs = fid - rid * NB;
  const int nch = mode == 2 ? 2 : 1;
  const int rank = bs / (nch * I);
  const int chain = mode == 2 ? (bs / I) % 2 : (mode == 1 ? 1 : 0);
  const int e = s - starts[fid];
  long long i0 = (int)((uint32_t)off0[fid] + (uint32_t)e);
  i0 = i0 < 0 ? 0 : (i0 >= nwl ? nwl - 1 : i0);
  bool crick;
  int c = 0, loc_local = 0;
  uint32_t g;
  if (rrbs) {
    const int chrp = tags[i0] & 0xFFFF;
    c = chrp >> 1;
    crick = (chrp & 1) != 0;
    loc_local = (int)(wlocs[i0] + (uint32_t)h[fid]);
    g = anchors[c] + (uint32_t)max(loc_local, 0);
  } else {
    const int g_wc = wcnt[fid];
    crick = e >= g_wc;
    uint32_t entry;
    if (crick) {
      long long i3 = (int)((uint32_t)off3[fid] + (uint32_t)(e - g_wc));
      entry = clocs[i3 < 0 ? 0 : (i3 >= ncl ? ncl - 1 : i3)];
    } else {
      entry = wlocs[i0];
    }
    g = entry + (uint32_t)h[fid];
  }
  const int NW = nw;
  const int wbase = bsm_clampi((int)(g >> 4) + (crick ? W : 0), 0,
                               2 * W - NW - 1);
  const uint32_t z2 = (g & 15u) * 2u;
  const int* row = (chain == 1 && mode == 2 ? rows_rc : rows) +
                   (size_t)rid * (2 * nw + 4);
  int wmm = 0;
  uint32_t cur = __ldg(&catcat[wbase]);
  for (int k = 0; k < NW; ++k) {
    uint32_t nxt = __ldg(&catcat[wbase + k + 1]);
    uint32_t sref = z2 == 0 ? cur : ((cur << z2) | (nxt >> (32u - z2)));
    uint32_t q = (uint32_t)row[k], r = (uint32_t)row[nw + k];
    uint32_t xc = ((~sref) << 1) | sref | 0x55555555u;
    uint32_t x = ((q & xc) ^ sref) & r;
    wmm += __popc((x | (x >> 1)) & 0x55555555u);
    cur = nxt;
  }
  const int llen = row[2 * nw];
  if (!rrbs) {
    int lo = 0, hi = n_chr;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (anchors[mid] <= g) lo = mid + 1; else hi = mid;
    }
    c = bsm_clampi(lo - 1, 0, n_chr - 1);
    loc_local = (int)(g - anchors[c]);
  }
  const int wloc = crick ? (int)((uint32_t)rcoff[c] - (uint32_t)llen -
                                 (uint32_t)loc_local)
                         : loc_local;
  const bool in_bounds = wloc >= 0 && loc_local >= 0 &&
                         (int)((uint32_t)wloc + (uint32_t)llen) <= sizes[c];
  // (under rrbs, in_bounds holds the tag check loc + h >= 0)
  const bool elig = live && in_bounds && wmm <= row[2 * nw + 1];
  const bool frag = rrbs && elig &&
                    bsm_frag_ok(sites, nsites, site_off, anchors[c], c, wloc,
                                llen, tail, min_ins, max_ins);
  bool corner = false;
  if (bounds != nullptr && elig) {
    const uint32_t gkey = anchors[c] + (uint32_t)max(wloc, 0);
    int lo = 0, hi = nbounds;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (bounds[mid] <= gkey) lo = mid + 1; else hi = mid;
    }
    corner = lo - 1 != shard;
  }
  crid[s] = rid;
  cchrp[s] = 2 * c + (crick ? 1 : 0);
  cwloc[s] = wloc;
  cinfo[s] = (elig ? (BSM_INFO_ELIGIBLE | BSM_INFO_UNRESOLVED) : 0) |
             (frag ? BSM_INFO_FRAG : 0) | (corner ? BSM_INFO_CORNER : 0) |
             (wmm << BSM_INFO_WMM_SHIFT) |
             (rank << BSM_INFO_RANK_SHIFT) |
             (chain << BSM_INFO_CHAIN_SHIFT);
}

__constant__ uint32_t bsm_dd_muls[3][3] = {
    {0x9E3779B1u, 0x85EBCA6Bu, 0xC2B2AE35u},
    {0x27D4EB2Fu, 0x165667B1u, 0x9E3779B1u},
    {0xC2B2AE35u, 0x27D4EB2Fu, 0x85EBCA6Bu}};

static __device__ __forceinline__ uint32_t bsm_dd_slot(int rid, int chrp,
                                                       int wloc, int round,
                                                       int shift) {
  uint32_t hh = (uint32_t)rid * bsm_dd_muls[round][0] +
                (uint32_t)(chrp >> 1) * bsm_dd_muls[round][1] +
                (uint32_t)wloc * bsm_dd_muls[round][2];
  hh ^= hh >> 16;
  return (hh * 0x9E3779B1u) >> shift;
}

__global__ void bsm_dedup_insert_kernel(const int* __restrict__ starts, int N,
                                        int cands, const int* __restrict__ crid,
                                        const int* __restrict__ cchrp,
                                        const int* __restrict__ cwloc,
                                        const int* __restrict__ cinfo,
                                        int* __restrict__ tbl, int round,
                                        int shift) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= min(starts[N], cands) || !(cinfo[s] & BSM_INFO_UNRESOLVED)) return;
  atomicMin(&tbl[bsm_dd_slot(crid[s], cchrp[s], cwloc[s], round, shift)], s);
}

__global__ void bsm_dedup_resolve_kernel(const int* __restrict__ starts,
                                         int N, int cands,
                                         const int* __restrict__ crid,
                                         const int* __restrict__ cchrp,
                                         const int* __restrict__ cwloc,
                                         int* __restrict__ cinfo,
                                         const int* __restrict__ tbl,
                                         int round, int shift) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= min(starts[N], cands)) return;
  int info = cinfo[s];
  if (!(info & BSM_INFO_UNRESOLVED)) return;
  const int rid = crid[s], chrp = cchrp[s], wloc = cwloc[s];
  const int w = min(tbl[bsm_dd_slot(rid, chrp, wloc, round, shift)],
                    cands - 1);
  const bool is_me = w == s;
  const bool same = crid[w] == rid && (cchrp[w] >> 1) == (chrp >> 1) &&
                    cwloc[w] == wloc;
  if (is_me) info |= BSM_INFO_FIRST;
  if (is_me || same) info &= ~BSM_INFO_UNRESOLVED;
  cinfo[s] = info;
}

#define BSM_CHECK()                              \
  do {                                           \
    cudaError_t err_ = cudaGetLastError();       \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

extern "C" int bsmap_verify_candidates(
    const int* rows, const int* rows_rc, int m, int nw, int MS, int I,
    int mode, int cands, const int* h,
    const int* off0, const int* off3, const int* wcnt, const int* cnt,
    const int* catcat, int W, const int* anchors, int n_chr, const int* sizes,
    const int* rcoff, const int* wlocs, long long nwl, const int* clocs,
    long long ncl, int rrbs, const int* tags, const int* sites,
    const int* site_off, long long nsites, int tail, int min_ins,
    int max_ins, int shard, const int* bounds, int nbounds, int T,
    int* starts, int* scratch, int* crid, int* cchrp,
    int* cwloc, int* cinfo, cudaStream_t stream) {
  if (mode == 2 && rows_rc == nullptr) return (int)cudaErrorInvalidValue;
  const int NB = MS * (mode == 2 ? 2 : 1) * I, N = m * NB;
  const int threads = 256;
  const long long nscr = 1 + 3LL * T;
  int* lastslot = scratch;
  int* tbl = scratch + 1;
  int shift = 32;
  for (int t = T; t > 1; t >>= 1) --shift;
  bsm_fill_kernel<<<(unsigned)((nscr + threads - 1) / threads), threads, 0,
                    stream>>>(scratch, nscr, cands);
  BSM_CHECK();
  bsm_slot_scan_kernel<<<1, 1024, 0, stream>>>(cnt, N, cands, starts,
                                               lastslot);
  BSM_CHECK();
  const unsigned cblocks = (unsigned)((cands + threads - 1) / threads);
  bsm_verify_kernel<<<cblocks, threads, 0, stream>>>(
      rows, rows_rc, nw, NB, I, mode, cands, N, starts, lastslot, h, off0,
      off3, wcnt,
      reinterpret_cast<const uint32_t*>(catcat), W,
      reinterpret_cast<const uint32_t*>(anchors), n_chr, sizes, rcoff,
      reinterpret_cast<const uint32_t*>(wlocs), nwl,
      reinterpret_cast<const uint32_t*>(clocs), ncl, rrbs, tags,
      reinterpret_cast<const uint32_t*>(sites), site_off, (int)nsites, tail,
      min_ins, max_ins, shard, reinterpret_cast<const uint32_t*>(bounds),
      nbounds, crid, cchrp, cwloc, cinfo);
  BSM_CHECK();
  for (int r = 0; r < 3; ++r) {
    int* t = tbl + (size_t)r * T;
    bsm_dedup_insert_kernel<<<cblocks, threads, 0, stream>>>(
        starts, N, cands, crid, cchrp, cwloc, cinfo, t, r, shift);
    BSM_CHECK();
    bsm_dedup_resolve_kernel<<<cblocks, threads, 0, stream>>>(
        starts, N, cands, crid, cchrp, cwloc, cinfo, t, r, shift);
    BSM_CHECK();
  }
  return 0;
}
