// K2 exact_schedule: the exact (reference-order) seed schedule.
//
// Replaces bsmap_tpu/engine/device_engine.py:_schedule_impl (:404-672),
// forward chain: chain_schedule (:445-550), slot_desc (:574-632) and the
// per-rank totals (:649-664).  With `probe` set it writes only the per-rank
// totals, the stage-1-only pre-pass of probe mode (:1186-1191).  With
// `rrbs` set it runs the RRBS branches instead (bsm_rrbs_schedule below).
//
// Per read (ReorderSeed / AdjustSeedStartArray / seedindex,
// align.cpp:454-577): bucket cost cnt+2 at each of P seed positions, the
// CountSeeds sliding-window sums as differences of one wrapping uint32
// prefix sum (bit32_t in the reference), the first-minimum start offset,
// maxseg zig-zag refinement steps, the stable signed-cost segment order,
// and the NB slot rows from kmer_tab at the chosen positions.
//
// Bound on the card: P dependent 4-byte gathers from the 689 MB kmer_tab
// plus NB 16-byte row gathers per read, with little arithmetic between
// them.  Design: one thread per read keeps the whole sequential schedule
// (argmins, zig-zag, insertion sort over <= 16 keys) in one thread; the
// prefix sums (<= 273 words) live in local memory, which L1 caches.

#include "common.cuh"

// Stable ascending insertion sort of segment ids by key (<= 16 keys).
static __device__ __forceinline__ void bsm_order_segments(const uint32_t* key,
                                                          int MS, int* order) {
  for (int j = 0; j < MS; ++j) {
    int p = j;
    while (p > 0 && key[order[p - 1]] > key[j]) {
      order[p] = order[p - 1];
      --p;
    }
    order[p] = j;
  }
}

// The RRBS branches (chain_schedule :464-478, slot_desc :596-609), forward
// chain: one probed position per segment at start offset 0, segments in a
// stable order of the RAW bucket count (signed), and each slot's
// (segment, strand) class 2*segment looked up in the tag-partitioned
// offsets tag_off[seed * J2 + class] (J2 = (ntag - 1) / 3^S); the count is
// 0 unless the probe is fresh and the class exists.  The reference scans
// the raw bucket and filters on the tag (align.cpp:183-196); the
// partitioned table enumerates the same entries in the same order.
static __device__ void bsm_rrbs_schedule(
    const int* row, int nw, const int4* __restrict__ kmer_tab,
    const int* __restrict__ prof_a, const int* __restrict__ tag_off,
    long long ntag, int S, int I, int MS, int P, int probe, int len,
    int bud, int maxrank, size_t b, int* h_out, int* off0_out,
    int* off3_out, int* wcnt_out, int* cnt_out, int* soff_out,
    int* ftot_out) {
  const int NB = MS * I;
  const int seedseg = bsm_seedseg(len, bud, S, I, MS);
  uint32_t key[BSM_MAX_MS];
  int order[BSM_MAX_MS];
  for (int n = 0; n < MS; ++n) {
    int pos = bsm_clampi(__ldg(&prof_a[n * I]), 0, P - 1);
    int cn = __ldg(&kmer_tab[bsm_seed_at(row, nw, S, pos)].y);
    key[n] = n < seedseg ? ((uint32_t)cn ^ 0x80000000u) : 0xFFFFFFFFu;
  }
  bsm_order_segments(key, MS, order);
  long long p3 = 1;
  for (int j = 0; j < S; ++j) p3 *= 3;
  const long long J2 = (ntag - 1) / p3;
  if (!probe) soff_out[b] = 0;
  BsmRankTotals tot;
  tot.init();
  for (int j = 0; j < MS; ++j) {
    const int mode = order[j];
    uint32_t rsum = 0;
    for (int i = 0; i < I; ++i) {
      int a = __ldg(&prof_a[mode * I + i]);
      int k = a - i;
      int kc = bsm_clampi(k, 0, P - 1);
      bool fresh = k >= 0 && k <= len - S;
      long long idx = (long long)bsm_seed_at(row, nw, S, kc) * J2 + 2 * mode;
      idx = idx < 0 ? 0 : (idx > ntag - 2 ? ntag - 2 : idx);
      int off = __ldg(&tag_off[idx]);
      int cn = __ldg(&tag_off[idx + 1]) - off;
      bool ok = fresh && 2 * mode + 1 < J2;
      int c = tot.slot(j, ok ? cn : 0, seedseg, maxrank, &rsum);
      if (!probe) {
        size_t o = b * NB + j * I + i;
        h_out[o] = -a + i;
        off0_out[o] = off;
        wcnt_out[o] = 0;
        off3_out[o] = 0;
        cnt_out[o] = c;
      }
    }
    ftot_out[b * MS + j] = tot.close_rank(rsum);
  }
}

__global__ void bsm_exact_schedule_kernel(
    const int* __restrict__ rows, int m, int nw,
    const int4* __restrict__ kmer_tab, const int* __restrict__ prof_a,
    int S, int I, int MS, int P, int probe, int rrbs,
    const int* __restrict__ tag_off, long long ntag,
    int* __restrict__ h_out, int* __restrict__ off0_out,
    int* __restrict__ off3_out, int* __restrict__ wcnt_out,
    int* __restrict__ cnt_out, int* __restrict__ soff_out,
    int* __restrict__ ftot_out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int width = 2 * nw + 4;
  const int* row = rows + (size_t)b * width;
  const int len = row[2 * nw], bud = row[2 * nw + 1];
  const int maxrank = row[2 * nw + 3];
  if (rrbs) {
    bsm_rrbs_schedule(row, nw, kmer_tab, prof_a, tag_off, ntag, S, I, MS, P,
                      probe, len, bud, maxrank, (size_t)b, h_out, off0_out,
                      off3_out, wcnt_out, cnt_out, soff_out, ftot_out);
    return;
  }
  const int NB = MS * I;
  const int WLEN = MS * S + I;
  const int L = min(P, WLEN);
  const uint32_t BIG = 0xFFFFFFFFu;

  // cs[t] = sum of cost[0 .. t-1] (uint32, wrapping); cost is 0 past L
  uint32_t cs[BSM_MAX_WLEN + 1];
  cs[0] = 0;
  for (int t = 1; t <= WLEN; ++t) {
    uint32_t c = 0;
    if (t - 1 < L) {
      int cn = __ldg(&kmer_tab[bsm_seed_at(row, nw, S, t - 1)].y);
      c = cn > 0 ? (uint32_t)(cn + 2) : 0u;
    }
    cs[t] = cs[t - 1] + c;
  }
  // T(n, off) = CountSeeds of segment n at start offset off
#define BSM_T(n, off) (cs[(n) * S + (off) + I] - cs[(n) * S + (off)])

  const int seedseg = bsm_seedseg(len, bud, S, I, MS);
  const int max_off = bsm_floormod(len - I + 1, S);
  int s_off = 0;
  if (max_off > 0) {
    uint32_t best = BIG;
    for (int off = 0; off < S; ++off) {
      uint32_t t = 0;
      for (int n = 0; n < seedseg; ++n) t += BSM_T(n, off);
      uint32_t v = off < max_off ? t : BIG;
      if (off == 0 || v < best) {
        best = v;
        s_off = off;
      }
    }
  }
  // zig-zag per-segment refinement (align.cpp:506-547)
  int start[BSM_MAX_MS];
  for (int n = 0; n < MS; ++n) start[n] = s_off;
  for (int it = 0; it < MS; ++it) {
    int half = it / 2;
    int ptr = (it % 2 == 0) ? half : seedseg - 1 - half;
    int pc = bsm_clampi(ptr, 0, MS - 1);
    int prev = start[bsm_clampi(pc - 1, 0, MS - 1)];
    int nxt = start[bsm_clampi(pc + 1, 0, MS - 1)];
    int lo = pc == 0 ? 0 : prev;
    int hi = pc == seedseg - 1 ? max_off : nxt;
    int best_off = 0;
    uint32_t bestv = BIG;
    for (int off = 0; off < S; ++off) {
      uint32_t v = (off >= lo && off <= hi) ? BSM_T(pc, off) : BIG;
      if (off == 0 || v < bestv) {
        bestv = v;
        best_off = off;
      }
    }
    if (it < seedseg) start[pc] = best_off;
  }
  // segment order: stable ascending on (cost as signed int32), unused
  // segments last (key 0xFFFFFFFF)
  uint32_t key[BSM_MAX_MS];
  int order[BSM_MAX_MS];
  for (int n = 0; n < MS; ++n)
    key[n] = n < seedseg ? (BSM_T(n, start[n]) ^ 0x80000000u) : BIG;
  bsm_order_segments(key, MS, order);
#undef BSM_T

  if (!probe) soff_out[b] = s_off;
  BsmRankTotals tot;
  tot.init();
  for (int j = 0; j < MS; ++j) {
    const int mode = order[j];
    const int st = start[mode];
    uint32_t rsum = 0;
    for (int i = 0; i < I; ++i) {
      int a = __ldg(&prof_a[mode * I + i]);
      int k = a + st - i;
      int kc = bsm_clampi(k, 0, P - 1);
      bool fresh = k >= 0 && k <= len - S;
      int4 r = __ldg(&kmer_tab[bsm_seed_at(row, nw, S, kc)]);
      int c = tot.slot(j, fresh ? r.y : 0, seedseg, maxrank, &rsum);
      if (!probe) {
        size_t o = (size_t)b * NB + j * I + i;
        h_out[o] = -a + i - st;
        off0_out[o] = r.x;
        wcnt_out[o] = r.z;
        off3_out[o] = r.w;
        cnt_out[o] = c;
      }
    }
    ftot_out[(size_t)b * MS + j] = tot.close_rank(rsum);
  }
}

extern "C" int bsmap_exact_schedule(const int* rows, int m, int nw,
                                    const int* kmer_tab, const int* prof_a,
                                    int S, int I, int MS, int P, int probe,
                                    int rrbs, const int* tag_off,
                                    long long ntag, int* h, int* off0,
                                    int* off3, int* wcnt, int* cnt, int* soff,
                                    int* ftot, cudaStream_t stream) {
  if (m > 0) {
    const int threads = 128;
    bsm_exact_schedule_kernel<<<(m + threads - 1) / threads, threads, 0,
                                stream>>>(
        rows, m, nw, reinterpret_cast<const int4*>(kmer_tab), prof_a, S, I,
        MS, P, probe, rrbs, tag_off, ntag, h, off0, off3, wcnt, cnt, soff,
        ftot);
  }
  return (int)cudaGetLastError();
}
