// K2 exact_schedule: the exact (reference-order) seed schedule.
//
// Replaces bsmap_tpu/engine/device_engine.py:_schedule_impl (:404-672) for
// one chain or both (`mode` 0 forward, 1 rc, 2 both, -n 1; the rc chain's
// words are K5's rows: `rows` under mode 1, `rows_rc` under mode 2):
// chain_schedule (:445-550) per chain, slot_desc (:574-632) per chain, the
// slots interleaved in (rank, chain, phase) order (:638-645), and the
// per-rank totals over both chains (:649-664).  With `probe` set it writes
// only the per-rank totals, the stage-1-only pre-pass of probe mode
// (:1186-1191).  With `rrbs` set each chain runs the RRBS branches instead
// (bsm_rrbs_order below).  Under index sharding (`gcnt` given) the table
// is one region shard's, with the shard's local counts in .y (the slot
// counts, :630-632), and the schedule costs come from the global bucket
// totals `gcnt` (column 1 of the JAX shard table, :448-463), so every
// shard computes the same schedule.
//
// Per read and chain (ReorderSeed / AdjustSeedStartArray / seedindex,
// align.cpp:454-577): bucket cost cnt+2 at each of P seed positions, the
// CountSeeds sliding-window sums as differences of one wrapping uint32
// prefix sum (bit32_t in the reference), the first-minimum start offset,
// maxseg zig-zag refinement steps and the stable signed-cost segment
// order; then the NB slot rows from kmer_tab at the chosen positions.  The
// forward chain's start offset goes to `soff`, the rc chain's to `coff`
// (:665-670), 0 for an absent chain.
//
// Bound on the card: P dependent 4-byte gathers from the 689 MB kmer_tab
// plus maxseg*I 16-byte row gathers per read and chain, with little
// arithmetic between them.  Design: one thread per read keeps the whole
// sequential schedule (argmins, zig-zag, insertion sort over <= 16 keys)
// in one thread, the chains one after the other; the prefix sums (<= 273
// words, one chain at a time) live in local memory, which L1 caches.

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

// chain_schedule of one WGBS chain: returns the chosen start offset and
// fills the per-segment start offsets and the segment order.
static __device__ int bsm_exact_chain(const int* row, int nw,
                                      const int4* __restrict__ kmer_tab,
                                      const int* __restrict__ gcnt,
                                      int S, int I, int MS, int P, int len,
                                      int seedseg, int* start, int* order) {
  const int WLEN = MS * S + I;
  const int L = min(P, WLEN);
  const uint32_t BIG = 0xFFFFFFFFu;

  // cs[t] = sum of cost[0 .. t-1] (uint32, wrapping); cost is 0 past L
  uint32_t cs[BSM_MAX_WLEN + 1];
  cs[0] = 0;
  for (int t = 1; t <= WLEN; ++t) {
    uint32_t c = 0;
    if (t - 1 < L) {
      const int sv = bsm_seed_at(row, nw, S, t - 1);
      int cn = gcnt ? __ldg(&gcnt[sv]) : __ldg(&kmer_tab[sv].y);
      c = cn > 0 ? (uint32_t)(cn + 2) : 0u;
    }
    cs[t] = cs[t - 1] + c;
  }
  // T(n, off) = CountSeeds of segment n at start offset off
#define BSM_T(n, off) (cs[(n) * S + (off) + I] - cs[(n) * S + (off)])

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
  for (int n = 0; n < MS; ++n)
    key[n] = n < seedseg ? (BSM_T(n, start[n]) ^ 0x80000000u) : BIG;
  bsm_order_segments(key, MS, order);
#undef BSM_T
  return s_off;
}

// The RRBS order of one chain (chain_schedule :464-478): one probed
// position per segment at start offset 0, shifted by `koff` (len % S on the
// rc chain, :552-562), segments in a stable order of the RAW bucket count
// (signed).
static __device__ void bsm_rrbs_order(const int* row, int nw,
                                      const int4* __restrict__ kmer_tab,
                                      const int* __restrict__ prof_a, int S,
                                      int I, int MS, int P, int koff,
                                      int seedseg, int* order) {
  uint32_t key[BSM_MAX_MS];
  for (int n = 0; n < MS; ++n) {
    int pos = bsm_clampi(__ldg(&prof_a[n * I]) + koff, 0, P - 1);
    int cn = __ldg(&kmer_tab[bsm_seed_at(row, nw, S, pos)].y);
    key[n] = n < seedseg ? ((uint32_t)cn ^ 0x80000000u) : 0xFFFFFFFFu;
  }
  bsm_order_segments(key, MS, order);
}

__global__ void bsm_exact_schedule_kernel(
    const int* __restrict__ rows, const int* __restrict__ rows_rc, int m,
    int nw, const int4* __restrict__ kmer_tab, const int* __restrict__ prof_a,
    int S, int I, int MS, int P, int mode, int probe, int rrbs,
    const int* __restrict__ tag_off, long long ntag,
    const int* __restrict__ gcnt, int* __restrict__ h_out,
    int* __restrict__ off0_out, int* __restrict__ off3_out,
    int* __restrict__ wcnt_out,
    int* __restrict__ cnt_out, int* __restrict__ soff_out,
    int* __restrict__ coff_out, int* __restrict__ ftot_out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int nch = mode == 2 ? 2 : 1;
  const int width = 2 * nw + 4;
  const int* crow[2] = {rows + (size_t)b * width,
                        nch == 2 ? rows_rc + (size_t)b * width : nullptr};
  const int* row = crow[0];
  const int len = row[2 * nw], bud = row[2 * nw + 1];
  const int maxrank = row[2 * nw + 3];
  const int NB = MS * nch * I;
  const int seedseg = bsm_seedseg(len, bud, S, I, MS);

  // per chain: is it the rc chain, its RRBS probe shift, its schedule
  int is_rc[2], koff[2], s_off[2];
  int start[2][BSM_MAX_MS], order[2][BSM_MAX_MS];
  for (int c = 0; c < nch; ++c) {
    is_rc[c] = mode == 1 || c == 1;
    koff[c] = rrbs && is_rc[c] ? bsm_floormod(len, S) : 0;
    if (rrbs) {
      bsm_rrbs_order(crow[c], nw, kmer_tab, prof_a, S, I, MS, P, koff[c],
                     seedseg, order[c]);
      for (int n = 0; n < MS; ++n) start[c][n] = 0;
      s_off[c] = 0;
    } else {
      s_off[c] = bsm_exact_chain(crow[c], nw, kmer_tab, gcnt, S, I, MS, P,
                                 len, seedseg, start[c], order[c]);
    }
  }
  long long J2 = 0;
  if (rrbs) {
    long long p3 = 1;
    for (int j = 0; j < S; ++j) p3 *= 3;
    J2 = (ntag - 1) / p3;
  }
  if (!probe) {
    soff_out[b] = mode == 1 ? 0 : s_off[0];
    coff_out[b] = mode == 0 ? 0 : s_off[nch - 1];
  }

  BsmRankTotals tot;
  tot.init();
  for (int j = 0; j < MS; ++j) {
    uint32_t rsum = 0;
    for (int c = 0; c < nch; ++c) {
      const int seg = order[c][j];
      const int st = start[c][seg];
      for (int i = 0; i < I; ++i) {
        const int a = __ldg(&prof_a[seg * I + i]);
        const int k = a + st - i + koff[c];
        const int kc = bsm_clampi(k, 0, P - 1);
        const bool fresh = k >= 0 && k <= len - S;
        const int sv = bsm_seed_at(crow[c], nw, S, kc);
        int off0, off3 = 0, wcnt = 0, cn;
        if (rrbs) {
          // the probed (segment, strand) class (slot_desc :596-609): the
          // rc chain counts segments from the read's other end
          const int want = is_rc[c] ? len / S - 1 - seg : seg;
          long long idx = (long long)sv * J2 + 2 * want + is_rc[c];
          idx = idx < 0 ? 0 : (idx > ntag - 2 ? ntag - 2 : idx);
          off0 = __ldg(&tag_off[idx]);
          const bool ok = fresh && want >= 0 && 2 * want + 1 < J2;
          cn = ok ? __ldg(&tag_off[idx + 1]) - off0 : 0;
        } else {
          const int4 r = __ldg(&kmer_tab[sv]);
          off0 = r.x;
          off3 = r.w;
          wcnt = r.z;
          cn = fresh ? r.y : 0;
        }
        const int cs = tot.slot(j, cn, seedseg, maxrank, &rsum);
        if (!probe) {
          size_t o = (size_t)b * NB + (j * nch + c) * I + i;
          h_out[o] = -a + i - st - koff[c];
          off0_out[o] = off0;
          wcnt_out[o] = wcnt;
          off3_out[o] = off3;
          cnt_out[o] = cs;
        }
      }
    }
    ftot_out[(size_t)b * MS + j] = tot.close_rank(rsum);
  }
}

extern "C" int bsmap_exact_schedule(const int* rows, const int* rows_rc,
                                    int m, int nw, const int* kmer_tab,
                                    const int* prof_a, int S, int I, int MS,
                                    int P, int mode, int probe, int rrbs,
                                    const int* tag_off, long long ntag,
                                    const int* gcnt, int* h, int* off0,
                                    int* off3, int* wcnt, int* cnt,
                                    int* soff, int* coff, int* ftot,
                                    cudaStream_t stream) {
  if (mode == 2 && rows_rc == nullptr) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const int threads = 128;
    bsm_exact_schedule_kernel<<<(m + threads - 1) / threads, threads, 0,
                                stream>>>(
        rows, rows_rc, m, nw, reinterpret_cast<const int4*>(kmer_tab), prof_a,
        S, I, MS, P, mode, probe, rrbs, tag_off, ntag, gcnt, h, off0, off3,
        wcnt, cnt, soff, coff, ftot);
  }
  return (int)cudaGetLastError();
}
