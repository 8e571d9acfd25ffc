// K3 verify_candidates: candidate layout, verify and dedup.
//
// Replaces the candidate stage of bsmap_tpu/engine/device_engine.py:
// _verify_impl (:692-897), unsharded, one chain or both (`mode` 0 forward,
// 1 rc, 2 both; the rc chain's words are K5's rows: `rows` under mode 1,
// `rows_rc` under mode 2).  Three parts:
//
//  1. the slot scan: saturating (2^30) exclusive scan of the N = B*NB slot
//     counts -> `starts` (total last), and the last non-empty slot that
//     starts inside the capacity.
//  2. verify, one thread per candidate.  upper_bound over `starts` finds
//     the candidate's slot (replacing the scatter-max + running max at
//     :703-706), and the slot its segment rank and chain (slots run (rank,
//     chain, phase) within a read, :710-715); then the Watson/Crick
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
//     discovery index claims it.  Three rounds, each with its own table
//     of T slots: atomicMin of the candidate index, then a resolve pass,
//     with the JAX program's multipliers, table size and slot hash so the
//     replay bits match its rows.
//
// Bound on the card: per candidate, two dependent random gathers (entry,
// then NW+1 genome words of one 32-44 byte span) plus a log2(n_chr)
// search (RRBS: two log2(n_sites) searches over the sites); the scan moves
// 8 bytes a slot and the dedup rounds are atomics into T-word tables that
// fit L2.  What the design does about it:
//
//  * The scan runs on every SM.  It is a reduce / scan-of-partials / rescan
//    inside one cooperative launch: each block sums a contiguous chunk of
//    1,024-count tiles (one coalesced 16-byte load a thread), grid.sync(),
//    then every block adds up the partials before its own (at most
//    BSM_K3_MAXGRID 64-bit words, from L2) and rescans its chunk with
//    warp-shuffle scans, writing `starts` 16 bytes a thread.  This was
//    chosen over a single-pass decoupled look-back: the launch is
//    cooperative anyway (it also fills the scratch), so the triple needs
//    no status words that a stale window could poison, no spin-waiting and
//    no tile ticket, and its second read of the counts comes from L2.  All
//    sums are 64-bit and exact, min(., 2^30) is applied to each count and
//    to each start, so any association gives the same `starts`.  The last
//    in-capacity non-empty slot is a block maximum and one atomicMax.
//  * The slot lookup is shared by a block: its 256 consecutive candidates
//    lie in one run of slots, whose two ends two threads find by binary
//    search over `starts`; the run is staged in shared memory (up to
//    BSM_K3_STAGE words) and each thread searches there.  A longer run
//    (long stretches of empty slots) searches global memory, for that
//    block only.
//  * Dedup passes are fused: a candidate's resolve of round r and insert
//    of round r + 1 run in one thread (each round has its own table), the
//    insert of round 0 in the verify thread, and a device-side count of
//    still-unresolved candidates ends the cascade as soon as it is zero.
//    Two forms, chosen by `variant`, both kept so that either can be
//    measured (chip_smoke.py times both; PERF.md has the numbers):
//      variant 0, four launches: scan (cooperative); verify + insert 0;
//        resolve 0 + insert 1; resolve 1 + insert 2, whose last block to
//        finish resolves round 2 over the compact list of candidates still
//        unresolved (kept in round 0's table, free by then);
//      variant 1, one persistent cooperative launch holding the scan, the
//        verify pass and all rounds, grid.sync() between them.
//    Cooperative launches need cudaLaunchCooperativeKernel and a grid of
//    co-resident blocks (sized by the occupancy API for the current
//    device); no relocatable device code.  Calls on one card share one
//    stream, so two cooperative grids never run at once.
//
// Data written and read again inside one launch (`starts`, the candidate
// words of other threads, the tables, the counters) is read with __ldcg
// (L2): the per-SM L1 is not coherent across blocks.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define BSM_K3_THREADS 256
#define BSM_K3_TILE (4 * BSM_K3_THREADS)   // counts per block and step
#define BSM_K3_STAGE 8192                  // staged slot starts per block
#define BSM_K3_MAXGRID 2048                // partial sums kept in scratch
// scratch layout, in ints (engine/kernels.py K3_SCRATCH_HEAD): 16 counters,
// BSM_K3_MAXGRID 64-bit partial sums, then the three dedup tables
#define BSM_K3_HDR 16
#define BSM_K3_HEAD (BSM_K3_HDR + 2 * BSM_K3_MAXGRID)
enum { H_LASTSLOT, H_UNRES1, H_UNRES2, H_NLIST, H_DONE };

struct BsmK3 {
  const int* rows;
  const int* rows_rc;
  int nw, NB, I, mode, cands, N;
  const int* h;
  const int* off0;
  const int* off3;
  const int* wcnt;
  const int* cnt;
  const uint32_t* catcat;
  int W;
  const uint32_t* anchors;
  int n_chr;
  const int* sizes;
  const int* rcoff;
  const uint32_t* wlocs;
  long long nwl;
  const uint32_t* clocs;
  long long ncl;
  int rrbs;
  const int* tags;
  const uint32_t* sites;
  const int* site_off;
  int nsites, tail, min_ins, max_ins, shard;
  const uint32_t* bounds;
  int nbounds;
  int T, shift, vec;
  int* starts;
  int* hdr;
  long long* part;
  int* tbl;
  int* crid;
  int* cchrp;
  int* cwloc;
  int* cinfo;
};

// ---------------------------------------------------------------------------
// part 1: the slot scan
// ---------------------------------------------------------------------------

static __device__ __forceinline__ long long bsm_warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread.
static __device__ long long bsm_block_sum(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = bsm_warp_sum(v);
  __syncthreads();                       // sh may still be read
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < BSM_K3_THREADS / 32; ++w) t += sh[w];
  return t;
}

// The four counts of thread t in tile `tile`, each min(., 2^30); 0 past N.
static __device__ __forceinline__ int4 bsm_tile_counts(const BsmK3& P,
                                                       long long base) {
  int4 c = make_int4(0, 0, 0, 0);
  if (P.vec && base + 3 < P.N) {
    c = __ldg(reinterpret_cast<const int4*>(P.cnt + base));
  } else {
    if (base < P.N) c.x = __ldg(P.cnt + base);
    if (base + 1 < P.N) c.y = __ldg(P.cnt + base + 1);
    if (base + 2 < P.N) c.z = __ldg(P.cnt + base + 2);
    if (base + 3 < P.N) c.w = __ldg(P.cnt + base + 3);
  }
  c.x = min(c.x, BSM_SATLIM);
  c.y = min(c.y, BSM_SATLIM);
  c.z = min(c.z, BSM_SATLIM);
  c.w = min(c.w, BSM_SATLIM);
  return c;
}

// Block `b` of `nb` owns the tiles [t0, t1).
static __device__ __forceinline__ void bsm_scan_chunk(const BsmK3& P, int b,
                                                      int nb, int* t0,
                                                      int* t1) {
  const int ntiles = (P.N + BSM_K3_TILE - 1) / BSM_K3_TILE;
  const int per = (ntiles + nb - 1) / nb;
  *t0 = min(ntiles, b * per);
  *t1 = min(ntiles, *t0 + per);
}

// Phase 1: the scratch fill (counters, dedup tables) and each block's sum
// of its chunk of counts.
static __device__ void bsm_scan_reduce(const BsmK3& P, long long* sh) {
  const int tid = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  if (b == 0 && tid < BSM_K3_HDR) P.hdr[tid] = tid == H_LASTSLOT ? -1 : 0;
  const long long ntbl = 3LL * P.T;
  for (long long i = (long long)b * BSM_K3_THREADS + tid; i < ntbl;
       i += (long long)nb * BSM_K3_THREADS)
    P.tbl[i] = P.cands;
  int t0, t1;
  bsm_scan_chunk(P, b, nb, &t0, &t1);
  long long s = 0;
  for (int t = t0; t < t1; ++t) {
    int4 c = bsm_tile_counts(P, (long long)t * BSM_K3_TILE + 4 * tid);
    s += (long long)c.x + c.y + c.z + c.w;
  }
  s = bsm_block_sum(s, sh);
  if (tid == 0) P.part[b] = s;
}

// Phase 2 (after a grid-wide sync): this block's base from the partials
// before it, then the exclusive saturating scan of its chunk.
static __device__ void bsm_scan_rescan(const BsmK3& P, long long* sh) {
  const int tid = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  long long run = 0;
  for (int i = tid; i < b; i += BSM_K3_THREADS) run += __ldcg(&P.part[i]);
  run = bsm_block_sum(run, sh);
  int t0, t1;
  bsm_scan_chunk(P, b, nb, &t0, &t1);
  int last = -1;
  for (int t = t0; t < t1; ++t) {
    const long long base = (long long)t * BSM_K3_TILE + 4 * tid;
    const int4 c = bsm_tile_counts(P, base);
    const long long mine = (long long)c.x + c.y + c.z + c.w;
    long long incl = mine;                 // inclusive scan inside the warp
    for (int o = 1; o < 32; o <<= 1) {
      long long v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += v;
    }
    __syncthreads();                       // sh may still be read
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    long long before = 0, tile_sum = 0;
    for (int w = 0; w < BSM_K3_THREADS / 32; ++w) {
      const long long v = sh[w];
      if (w < warp) before += v;
      tile_sum += v;
    }
    long long r0 = run + before + incl - mine;
    const long long r1 = r0 + c.x, r2 = r1 + c.y, r3 = r2 + c.z;
    const long long lim = BSM_SATLIM;
    const int4 st = make_int4((int)min(r0, lim), (int)min(r1, lim),
                              (int)min(r2, lim), (int)min(r3, lim));
    if (P.vec && base + 3 < P.N) {
      *reinterpret_cast<int4*>(P.starts + base) = st;
    } else {
      if (base < P.N) P.starts[base] = st.x;
      if (base + 1 < P.N) P.starts[base + 1] = st.y;
      if (base + 2 < P.N) P.starts[base + 2] = st.z;
      if (base + 3 < P.N) P.starts[base + 3] = st.w;
    }
    // counts past N are 0, so they never qualify
    if (c.x > 0 && r0 < P.cands) last = (int)base;
    if (c.y > 0 && r1 < P.cands) last = (int)base + 1;
    if (c.z > 0 && r2 < P.cands) last = (int)base + 2;
    if (c.w > 0 && r3 < P.cands) last = (int)base + 3;
    run += tile_sum;
  }
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_down_sync(0xFFFFFFFFu, last, o));
  if (lane == 0 && last >= 0) atomicMax(&P.hdr[H_LASTSLOT], last);
  // the last block's running sum is the total, whatever its chunk holds
  if (b == nb - 1 && tid == 0)
    P.starts[P.N] = (int)min(run, (long long)BSM_SATLIM);
}

__global__ void __launch_bounds__(BSM_K3_THREADS)
bsm_slot_scan_kernel(const BsmK3 P) {
  __shared__ long long sh[BSM_K3_THREADS / 32];
  bsm_scan_reduce(P, sh);
  cg::this_grid().sync();
  bsm_scan_rescan(P, sh);
}

// ---------------------------------------------------------------------------
// part 2: verify
// ---------------------------------------------------------------------------

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

// Last slot starting at or before s, over starts[0, N) in global memory.
static __device__ __forceinline__ int bsm_slot_of(const int* starts, int N,
                                                  int s) {
  int lo = 0, hi = N;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldcg(&starts[mid]) <= s) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// The block's 256 consecutive candidates from s0: finds the slot run that
// holds the live ones and stages its starts in `sh_st` when it fits.
// Returns this thread's slot (`*st0` its start), -1 for a dead candidate.
static __device__ int bsm_block_slots(const BsmK3& P, int s0, int ncand,
                                      int* sh_st, int* sh_ends, int* st0) {
  const int tid = threadIdx.x, s = s0 + tid;
  const int nlive = min(max(ncand - s0, 0), BSM_K3_THREADS);
  __syncthreads();                         // the previous chunk is done
  if (nlive > 0 && tid < 2)
    sh_ends[tid] = bsm_slot_of(P.starts, P.N, tid == 0 ? s0 : s0 + nlive - 1);
  __syncthreads();
  if (nlive == 0) return -1;
  const int f_lo = sh_ends[0], span = sh_ends[1] - f_lo + 1;
  const bool staged = span <= BSM_K3_STAGE;
  if (staged)
    for (int i = tid; i < span; i += BSM_K3_THREADS)
      sh_st[i] = __ldcg(&P.starts[f_lo + i]);
  __syncthreads();
  if (tid >= nlive) return -1;
  if (!staged) {
    const int fid = bsm_slot_of(P.starts, P.N, s);
    *st0 = __ldcg(&P.starts[fid]);
    return fid;
  }
  int lo = 0, hi = span;                   // sh_st[0] <= s0 <= s
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (sh_st[mid] <= s) lo = mid + 1; else hi = mid;
  }
  *st0 = sh_st[lo - 1];
  return f_lo + lo - 1;
}

// Candidate s of slot fid (which starts at st0): entry fetch, mismatch
// count, coordinates, flags; writes its four words and returns the info.
static __device__ int bsm_verify_one(const BsmK3& P, int s, int fid, int st0,
                                     bool live, int* rid_o, int* chrp_o,
                                     int* wloc_o) {
  const int NB = P.NB, I = P.I, mode = P.mode, nw = P.nw, W = P.W;
  const int rid = fid / NB;
  const int bs = fid - rid * NB;
  const int nch = mode == 2 ? 2 : 1;
  const int rank = bs / (nch * I);
  const int chain = mode == 2 ? (bs / I) % 2 : (mode == 1 ? 1 : 0);
  const int e = s - st0;
  long long i0 = (int)((uint32_t)__ldg(&P.off0[fid]) + (uint32_t)e);
  i0 = i0 < 0 ? 0 : (i0 >= P.nwl ? P.nwl - 1 : i0);
  const int hh = __ldg(&P.h[fid]);
  bool crick;
  int c = 0, loc_local = 0;
  uint32_t g;
  if (P.rrbs) {
    const int chrp = __ldg(&P.tags[i0]) & 0xFFFF;
    c = chrp >> 1;
    crick = (chrp & 1) != 0;
    loc_local = (int)(__ldg(&P.wlocs[i0]) + (uint32_t)hh);
    g = __ldg(&P.anchors[c]) + (uint32_t)max(loc_local, 0);
  } else {
    const int g_wc = __ldg(&P.wcnt[fid]);
    crick = e >= g_wc;
    uint32_t entry;
    if (crick) {
      long long i3 = (int)((uint32_t)__ldg(&P.off3[fid]) +
                           (uint32_t)(e - g_wc));
      entry = __ldg(&P.clocs[i3 < 0 ? 0 : (i3 >= P.ncl ? P.ncl - 1 : i3)]);
    } else {
      entry = __ldg(&P.wlocs[i0]);
    }
    g = entry + (uint32_t)hh;
  }
  const int wbase = bsm_clampi((int)(g >> 4) + (crick ? W : 0), 0,
                               2 * W - nw - 1);
  const uint32_t z2 = (g & 15u) * 2u;
  const int* row = (chain == 1 && mode == 2 ? P.rows_rc : P.rows) +
                   (size_t)rid * (2 * nw + 4);
  int wmm = 0;
  uint32_t cur = __ldg(&P.catcat[wbase]);
  for (int k = 0; k < nw; ++k) {
    uint32_t nxt = __ldg(&P.catcat[wbase + k + 1]);
    uint32_t sref = z2 == 0 ? cur : ((cur << z2) | (nxt >> (32u - z2)));
    uint32_t q = (uint32_t)__ldg(&row[k]), r = (uint32_t)__ldg(&row[nw + k]);
    uint32_t xc = ((~sref) << 1) | sref | 0x55555555u;
    uint32_t x = ((q & xc) ^ sref) & r;
    wmm += __popc((x | (x >> 1)) & 0x55555555u);
    cur = nxt;
  }
  const int llen = __ldg(&row[2 * nw]);
  if (!P.rrbs) {
    int lo = 0, hi = P.n_chr;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (__ldg(&P.anchors[mid]) <= g) lo = mid + 1; else hi = mid;
    }
    c = bsm_clampi(lo - 1, 0, P.n_chr - 1);
    loc_local = (int)(g - __ldg(&P.anchors[c]));
  }
  const int wloc = crick ? (int)((uint32_t)__ldg(&P.rcoff[c]) -
                                 (uint32_t)llen - (uint32_t)loc_local)
                         : loc_local;
  const bool in_bounds = wloc >= 0 && loc_local >= 0 &&
                         (int)((uint32_t)wloc + (uint32_t)llen) <=
                             __ldg(&P.sizes[c]);
  // (under rrbs, in_bounds holds the tag check loc + h >= 0)
  const bool elig = live && in_bounds && wmm <= __ldg(&row[2 * nw + 1]);
  const bool frag = P.rrbs && elig &&
                    bsm_frag_ok(P.sites, P.nsites, P.site_off,
                                __ldg(&P.anchors[c]), c, wloc, llen, P.tail,
                                P.min_ins, P.max_ins);
  bool corner = false;
  if (P.bounds != nullptr && elig) {
    const uint32_t gkey = __ldg(&P.anchors[c]) + (uint32_t)max(wloc, 0);
    int lo = 0, hi = P.nbounds;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (__ldg(&P.bounds[mid]) <= gkey) lo = mid + 1; else hi = mid;
    }
    corner = lo - 1 != P.shard;
  }
  const int chrp = 2 * c + (crick ? 1 : 0);
  const int info = (elig ? (BSM_INFO_ELIGIBLE | BSM_INFO_UNRESOLVED) : 0) |
                   (frag ? BSM_INFO_FRAG : 0) |
                   (corner ? BSM_INFO_CORNER : 0) |
                   (wmm << BSM_INFO_WMM_SHIFT) |
                   (rank << BSM_INFO_RANK_SHIFT) |
                   (chain << BSM_INFO_CHAIN_SHIFT);
  P.crid[s] = rid;
  P.cchrp[s] = chrp;
  P.cwloc[s] = wloc;
  P.cinfo[s] = info;
  *rid_o = rid;
  *chrp_o = chrp;
  *wloc_o = wloc;
  return info;
}

// ---------------------------------------------------------------------------
// part 3: dedup
// ---------------------------------------------------------------------------

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

static __device__ __forceinline__ void bsm_dd_insert(const BsmK3& P, int round,
                                                     int s, int rid, int chrp,
                                                     int wloc) {
  atomicMin(&P.tbl[(size_t)round * P.T +
                   bsm_dd_slot(rid, chrp, wloc, round, P.shift)], s);
}

// Round `round`'s verdict on unresolved candidate s: the lowest index in
// its table slot is s itself (first of its key) or has the same key.
static __device__ __forceinline__ int bsm_dd_resolve(const BsmK3& P, int round,
                                                     int s, int info, int rid,
                                                     int chrp, int wloc) {
  const int w = min(__ldcg(&P.tbl[(size_t)round * P.T +
                                  bsm_dd_slot(rid, chrp, wloc, round,
                                              P.shift)]),
                    P.cands - 1);
  const bool is_me = w == s;
  const bool same = __ldcg(&P.crid[w]) == rid &&
                    (__ldcg(&P.cchrp[w]) >> 1) == (chrp >> 1) &&
                    __ldcg(&P.cwloc[w]) == wloc;
  if (is_me) info |= BSM_INFO_FIRST;
  if (is_me || same) info &= ~BSM_INFO_UNRESOLVED;
  return info;
}

// The verify pass over chunk `chunk` of 256 candidates, with round 0's
// insert.
static __device__ void bsm_verify_chunk(const BsmK3& P, int chunk,
                                        int* sh_st, int* sh_ends) {
  const int s0 = chunk * BSM_K3_THREADS, s = s0 + threadIdx.x;
  const int ncand = min(__ldcg(&P.starts[P.N]), P.cands);
  int st0 = 0;
  int fid = bsm_block_slots(P, s0, ncand, sh_st, sh_ends, &st0);
  if (s >= P.cands) return;
  const bool live = fid >= 0;
  if (!live) {
    if (s != P.cands - 1) {
      P.crid[s] = 0;
      P.cchrp[s] = 0;
      P.cwloc[s] = 0;
      P.cinfo[s] = 0;
      return;
    }
    // the always-evaluated last capacity slot
    fid = max(__ldcg(&P.hdr[H_LASTSLOT]), 0);
    st0 = __ldcg(&P.starts[fid]);
  }
  int rid, chrp, wloc;
  const int info = bsm_verify_one(P, s, fid, st0, live, &rid, &chrp, &wloc);
  if (info & BSM_INFO_UNRESOLVED) bsm_dd_insert(P, 0, s, rid, chrp, wloc);
}

// Candidate s: resolve of round `round`, then (still unresolved, round < 2)
// the insert of the next round, counted in the header and, with `list`,
// appended to the compact list.
static __device__ __forceinline__ void bsm_dedup_step(const BsmK3& P,
                                                      int round, int s,
                                                      int* list) {
  if (s >= P.cands) return;
  int info = P.cinfo[s];
  if (!(info & BSM_INFO_UNRESOLVED)) return;
  const int rid = P.crid[s], chrp = P.cchrp[s], wloc = P.cwloc[s];
  info = bsm_dd_resolve(P, round, s, info, rid, chrp, wloc);
  P.cinfo[s] = info;
  if (round < 2 && (info & BSM_INFO_UNRESOLVED)) {
    bsm_dd_insert(P, round + 1, s, rid, chrp, wloc);
    atomicAdd(&P.hdr[H_UNRES1 + round], 1);
    if (list != nullptr) list[atomicAdd(&P.hdr[H_NLIST], 1)] = s;
  }
}

// variant 0, launch 2
__global__ void __launch_bounds__(BSM_K3_THREADS)
bsm_verify_kernel(const BsmK3 P) {
  __shared__ int sh_st[BSM_K3_STAGE];
  __shared__ int sh_ends[2];
  bsm_verify_chunk(P, blockIdx.x, sh_st, sh_ends);
}

// variant 0, launch 3
__global__ void __launch_bounds__(BSM_K3_THREADS)
bsm_dedup01_kernel(const BsmK3 P) {
  bsm_dedup_step(P, 0, blockIdx.x * BSM_K3_THREADS + threadIdx.x, nullptr);
}

// variant 0, launch 4: resolve 1 + insert 2 with the still-unresolved
// candidates listed in round 0's table (read for the last time by launch
// 3); the last block to finish sees every insert and resolves round 2.
__global__ void __launch_bounds__(BSM_K3_THREADS)
bsm_dedup12_kernel(const BsmK3 P) {
  __shared__ bool is_last;
  if (__ldcg(&P.hdr[H_UNRES1]) == 0) return;     // the same in every block
  int* list = P.tbl;
  bsm_dedup_step(P, 1, blockIdx.x * BSM_K3_THREADS + threadIdx.x, list);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&P.hdr[H_DONE], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n = __ldcg(&P.hdr[H_NLIST]);
  for (int i = threadIdx.x; i < n; i += BSM_K3_THREADS) {
    const int s = __ldcg(&list[i]);
    P.cinfo[s] = bsm_dd_resolve(P, 2, s, __ldcg(&P.cinfo[s]),
                                __ldcg(&P.crid[s]), __ldcg(&P.cchrp[s]),
                                __ldcg(&P.cwloc[s]));
  }
}

// variant 1: everything in one persistent cooperative launch
__global__ void __launch_bounds__(BSM_K3_THREADS)
bsm_verify_all_kernel(const BsmK3 P) {
  __shared__ int sh_st[BSM_K3_STAGE];
  __shared__ int sh_ends[2];
  __shared__ long long sh[BSM_K3_THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  bsm_scan_reduce(P, sh);
  grid.sync();
  bsm_scan_rescan(P, sh);
  grid.sync();
  const int nchunks = (P.cands + BSM_K3_THREADS - 1) / BSM_K3_THREADS;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x)
    bsm_verify_chunk(P, c, sh_st, sh_ends);
  for (int round = 0; round < 3; ++round) {
    grid.sync();
    // every thread reads the same count: the grid leaves together
    if (round > 0 && __ldcg(&P.hdr[H_UNRES1 + round - 1]) == 0) return;
    for (int c = blockIdx.x; c < nchunks; c += gridDim.x)
      bsm_dedup_step(P, round, c * BSM_K3_THREADS + threadIdx.x, nullptr);
  }
}

#define BSM_CHECK()                              \
  do {                                           \
    cudaError_t err_ = cudaGetLastError();       \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

// A grid of co-resident blocks for a cooperative launch of kernel `which`
// (0 the scan, 1 the one-launch form) on the current device, no larger than
// `want` or the partials' room.  The occupancy query runs once per kernel
// and device.
static int bsm_coop_grid(int which, const void* kernel, int want, int* grid) {
  static int resident[2][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int cached = dev < 64 ? resident[which][dev] : 0;
  if (cached == 0) {
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                        BSM_K3_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorLaunchOutOfResources;
    cached = per * sms;
    if (dev < 64) resident[which][dev] = cached;
  }
  int g = cached < want ? cached : want;
  if (g > BSM_K3_MAXGRID) g = BSM_K3_MAXGRID;
  *grid = g < 1 ? 1 : g;
  return 0;
}

// `scratch` holds BSM_K3_HEAD + 3 * T ints, 8-byte aligned, uninitialised.
// `variant` 0: four launches; 1: one cooperative launch (see the top).
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
    int* cwloc, int* cinfo, int variant, cudaStream_t stream) {
  if (mode == 2 && rows_rc == nullptr) return (int)cudaErrorInvalidValue;
  if (cands < 1 || ((uintptr_t)scratch & 7)) return (int)cudaErrorInvalidValue;
  BsmK3 P;
  P.rows = rows;
  P.rows_rc = rows_rc;
  P.nw = nw;
  P.NB = MS * (mode == 2 ? 2 : 1) * I;
  P.I = I;
  P.mode = mode;
  P.cands = cands;
  P.N = m * P.NB;
  P.h = h;
  P.off0 = off0;
  P.off3 = off3;
  P.wcnt = wcnt;
  P.cnt = cnt;
  P.catcat = reinterpret_cast<const uint32_t*>(catcat);
  P.W = W;
  P.anchors = reinterpret_cast<const uint32_t*>(anchors);
  P.n_chr = n_chr;
  P.sizes = sizes;
  P.rcoff = rcoff;
  P.wlocs = reinterpret_cast<const uint32_t*>(wlocs);
  P.nwl = nwl;
  P.clocs = reinterpret_cast<const uint32_t*>(clocs);
  P.ncl = ncl;
  P.rrbs = rrbs;
  P.tags = tags;
  P.sites = reinterpret_cast<const uint32_t*>(sites);
  P.site_off = site_off;
  P.nsites = (int)nsites;
  P.tail = tail;
  P.min_ins = min_ins;
  P.max_ins = max_ins;
  P.shard = shard;
  P.bounds = reinterpret_cast<const uint32_t*>(bounds);
  P.nbounds = nbounds;
  P.T = T;
  P.shift = 32;
  for (int t = T; t > 1; t >>= 1) --P.shift;
  P.vec = (((uintptr_t)cnt | (uintptr_t)starts) & 15) == 0;
  P.starts = starts;
  P.hdr = scratch;
  P.part = reinterpret_cast<long long*>(scratch + BSM_K3_HDR);
  P.tbl = scratch + BSM_K3_HEAD;
  P.crid = crid;
  P.cchrp = cchrp;
  P.cwloc = cwloc;
  P.cinfo = cinfo;

  const int ntiles = (P.N + BSM_K3_TILE - 1) / BSM_K3_TILE;
  const int nchunks = (cands + BSM_K3_THREADS - 1) / BSM_K3_THREADS;
  // enough blocks for the scan's tiles, the table fill and the chunks
  const long long fill = (3LL * T + BSM_K3_TILE - 1) / BSM_K3_TILE;
  int want = fill > BSM_K3_MAXGRID ? BSM_K3_MAXGRID : (int)fill;
  if (ntiles > want) want = ntiles;
  void* args[] = {&P};
  int grid = 0, err;
  if (variant == 1) {
    const void* k = reinterpret_cast<const void*>(bsm_verify_all_kernel);
    if ((err = bsm_coop_grid(1, k, nchunks > want ? nchunks : want, &grid)))
      return err;
    cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(grid),
                                                dim3(BSM_K3_THREADS), args, 0,
                                                stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const void* k = reinterpret_cast<const void*>(bsm_slot_scan_kernel);
  if ((err = bsm_coop_grid(0, k, want, &grid))) return err;
  cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(grid),
                                              dim3(BSM_K3_THREADS), args, 0,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  BSM_CHECK();
  bsm_verify_kernel<<<nchunks, BSM_K3_THREADS, 0, stream>>>(P);
  BSM_CHECK();
  bsm_dedup01_kernel<<<nchunks, BSM_K3_THREADS, 0, stream>>>(P);
  BSM_CHECK();
  bsm_dedup12_kernel<<<nchunks, BSM_K3_THREADS, 0, stream>>>(P);
  BSM_CHECK();
  return 0;
}
