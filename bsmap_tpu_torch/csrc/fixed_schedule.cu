// K1 fixed_schedule: fixed-schedule stage 1 of the SE alignment program.
//
// Replaces bsmap_tpu/engine/device_engine.py:_fixed_schedule_impl (:350)
// and the fixed branch of _schedule_impl (:421-439), one chain or both
// (nch = 2, -n 1: the forward rows and K5's rc rows, `rows_rc`).
//
// Per read and chain: seed values at the maxseg*I static pigeonhole offsets
// k = ceil((n*S + i)/I)*I - i (param.cpp:85-93) in that chain's words, one
// kmer_tab row per offset, the maxseg segment costs (fresh probes only)
// sorted cheapest first by a stable insertion sort per chain
// (jnp.argsort(stable=True), :384-388), then the NB = maxseg*nch*I slot rows
// written in (rank, chain, phase) order with the per-rank totals summed
// over both chains.
//
// Bound on the card: one random 16-byte kmer_tab gather per slot (the
// 3^S-row table is 689 MB at S=16, far beyond L2), i.e. NB dependent loads
// per read; everything else is register arithmetic.  Design: one thread per
// read, so a read's slots are produced without any cross-thread traffic;
// the cost pass loads only the count word and the write pass re-reads the
// row (L1/L2 hit), so no per-thread slot array is kept.

#include "common.cuh"

static __device__ __forceinline__ int bsm_fixed_k(int n, int i, int S,
                                                  int I) {
  return ((n * S + i + I - 1) / I) * I - i;
}

__global__ void bsm_fixed_schedule_kernel(
    const int* __restrict__ rows, const int* __restrict__ rows_rc, int m,
    int nw, const int4* __restrict__ kmer_tab, int S, int I, int MS, int nch,
    int* __restrict__ h_out, int* __restrict__ off0_out,
    int* __restrict__ off3_out, int* __restrict__ wcnt_out,
    int* __restrict__ cnt_out, int* __restrict__ ftot_out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int width = 2 * nw + 4;
  const int* crow[2] = {rows + (size_t)b * width,
                        nch == 2 ? rows_rc + (size_t)b * width : nullptr};
  const int* row = crow[0];
  const int len = row[2 * nw], bud = row[2 * nw + 1];
  const int maxrank = row[2 * nw + 3];
  const int NB = MS * nch * I;

  // per chain: natural-order segment costs over fresh probes (int32,
  // wrapping), then their stable ascending order
  int ord[2][BSM_MAX_MS];
  for (int c = 0; c < nch; ++c) {
    int seg_cost[BSM_MAX_MS];
    for (int n = 0; n < MS; ++n) {
      uint32_t s = 0;
      for (int i = 0; i < I; ++i) {
        int k = bsm_fixed_k(n, i, S, I);
        if (k <= len - S)
          s += (uint32_t)__ldg(&kmer_tab[bsm_seed_at(crow[c], nw, S, k)].y);
      }
      seg_cost[n] = (int)s;
    }
    for (int j = 0; j < MS; ++j) {
      int p = j;
      while (p > 0 && seg_cost[ord[c][p - 1]] > seg_cost[j]) {
        ord[c][p] = ord[c][p - 1];
        --p;
      }
      ord[c][p] = j;
    }
  }

  const int seedseg = bsm_seedseg(len, bud, S, I, MS);
  BsmRankTotals tot;
  tot.init();
  for (int j = 0; j < MS; ++j) {
    uint32_t rsum = 0;
    for (int c = 0; c < nch; ++c) {
      const int n = ord[c][j];
      for (int i = 0; i < I; ++i) {
        int k = bsm_fixed_k(n, i, S, I);
        int4 r = __ldg(&kmer_tab[bsm_seed_at(crow[c], nw, S, k)]);
        int cn = k <= len - S ? r.y : 0;
        size_t o = (size_t)b * NB + (j * nch + c) * I + i;
        h_out[o] = -k;
        off0_out[o] = r.x;
        wcnt_out[o] = r.z;
        off3_out[o] = r.w;
        cnt_out[o] = tot.slot(j, cn, seedseg, maxrank, &rsum);
      }
    }
    ftot_out[(size_t)b * MS + j] = tot.close_rank(rsum);
  }
}

extern "C" int bsmap_fixed_schedule(const int* rows, const int* rows_rc,
                                    int m, int nw, const int* kmer_tab, int S,
                                    int I, int MS, int nch, int* h, int* off0,
                                    int* off3, int* wcnt, int* cnt, int* ftot,
                                    cudaStream_t stream) {
  if (nch == 2 && rows_rc == nullptr) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const int threads = 128;
    bsm_fixed_schedule_kernel<<<(m + threads - 1) / threads, threads, 0,
                                stream>>>(
        rows, rows_rc, m, nw, reinterpret_cast<const int4*>(kmer_tab), S, I,
        MS, nch, h, off0, off3, wcnt, cnt, ftot);
  }
  return (int)cudaGetLastError();
}
