// K5 rc_words: dispatch rows of the reverse-complement read chain.
//
// Replaces bsmap_tpu/engine/device_engine.py:_rc_words (:302-347) and
// _len_mask_words (:292-299), the rc chain of ConvertBinaySeq
// (align.cpp:131-161): complement every 2-bit lane through the static
// permutation rc[] (~q when rc is (3, 2, 1, 0), the complement of every
// alphabet the CLI offers), reverse the 16 lanes of each word and the order
// of the words, funnel-shift left by 16*nw - len bases (zero words past the
// end), and force the N lanes inside the read (valid mask 00) to rc_n.
// The output has the dispatch-row layout [cqw | crw | len | budget | rand32
// | maxrank] with the four scalars copied, so K1-K4 take it as a chain's
// rows: in place of the forward rows for the rc chain alone (PE mate 2),
// beside them for both chains (-n 1).
//
// Bound on the card: the rows read once and written once, 2*(2nw+4) int32
// per read, and a few dozen bit operations per word; nothing to reuse
// between reads.  Design: a block copies a tile of BSM_K5_ROWS whole rows
// (one contiguous span of the row-major input) into shared memory with
// coalesced loads; then one thread per output word computes it from the
// tile (output word k of the rc chain reads reversed words i = k0 + k and
// i + 1 only) and writes it at its own place in the tile's span, so the
// stores coalesce as well.  What is left bounds it: the instructions per
// word, kept few (a lane reversal is a bit reversal and one swap, a row
// index a float multiply).  No per-thread arrays: nothing in local memory.

#include "common.cuh"

#define BSM_K5_THREADS 128
#define BSM_K5_ROWS 32

// the 16 2-bit lanes of w in reverse order: the bits reversed, then the
// two bits of each lane swapped back
static __device__ __forceinline__ uint32_t bsm_rev_lanes(uint32_t w) {
  w = __brev(w);
  return ((w & 0x55555555u) << 1) | ((w >> 1) & 0x55555555u);
}

// lanes of q equal to v, as 01 in each such lane
static __device__ __forceinline__ uint32_t bsm_lanes_eq(uint32_t q, int v) {
  const uint32_t x = q ^ (uint32_t)(v * 0x55555555u);
  return ~(x | (x >> 1)) & 0x55555555u;
}

__global__ void __launch_bounds__(BSM_K5_THREADS)
    bsm_rc_words_kernel(const int* __restrict__ rows, int m, int nw, int rc0,
                        int rc1, int rc2, int rc3, int rc_n,
                        int* __restrict__ out) {
  __shared__ uint32_t tile[BSM_K5_ROWS * (2 * BSM_MAX_NW + 4)];
  const int width = 2 * nw + 4;
  const int r0 = blockIdx.x * BSM_K5_ROWS;
  const int nwords = min(BSM_K5_ROWS, m - r0) * width;
  const size_t base = (size_t)r0 * width;
  for (int t = threadIdx.x; t < nwords; t += BSM_K5_THREADS)
    tile[t] = (uint32_t)rows[base + t];
  __syncthreads();
  const bool plain = rc0 == 3 && rc1 == 2 && rc2 == 1 && rc3 == 0;
  const uint32_t npat = (uint32_t)rc_n * 0x55555555u;
  // t / width by a float reciprocal: exact for t < 2^12, width <= 24 (t +
  // 0.5 lies at least 1/48 from a multiple of width)
  const float inv_width = 1.0f / (float)width;
  for (int t = threadIdx.x; t < nwords; t += BSM_K5_THREADS) {
    const int r = __float2int_rz(((float)t + 0.5f) * inv_width);
    const int c = t - r * width;
    const uint32_t* row = tile + r * width;
    uint32_t val = row[c];                       // the four scalars
    if (c < 2 * nw) {
      const int k = c < nw ? c : c - nw;
      const int len = (int)row[2 * nw];
      const int sh = 16 * nw - len;                // bases to shift out
      const int i = (sh >> 4) + k;
      const uint32_t z = (uint32_t)((sh & 15) * 2);
      // reversed word x of the valid mask / of the complement; zero past
      // the nw words (and before the first)
      auto rw_at = [&](int x) {
        return x >= 0 && x < nw ? bsm_rev_lanes(row[2 * nw - 1 - x]) : 0u;
      };
      auto cq_at = [&](int x) {
        if (x < 0 || x >= nw) return 0u;
        const uint32_t q = row[nw - 1 - x];
        const uint32_t comp =
            plain ? ~q
                  : (bsm_lanes_eq(q, 0) * (uint32_t)rc0 |
                     bsm_lanes_eq(q, 1) * (uint32_t)rc1 |
                     bsm_lanes_eq(q, 2) * (uint32_t)rc2 |
                     bsm_lanes_eq(q, 3) * (uint32_t)rc3);
        return bsm_rev_lanes(comp);
      };
      // the JAX code guards the shift by 32 - z for z == 0 (:340-341)
      const uint32_t ra = rw_at(i), rb = rw_at(i + 1);
      const uint32_t crw = z == 0 ? ra : ((ra << z) | (rb >> (32u - z)));
      val = crw;
      if (c < nw) {
        const uint32_t qa = cq_at(i), qb = cq_at(i + 1);
        const uint32_t cq0 = z == 0 ? qa : ((qa << z) | (qb >> (32u - z)));
        // lanes < len of word k: 11, beyond 00 (shift capped at 30, :298)
        const int v = bsm_clampi(len - 16 * k, 0, 16);
        const uint32_t lmask =
            v > 0 ? (0xFFFFFFFFu << (uint32_t)min(2 * (16 - v), 30)) : 0u;
        val = (cq0 & crw) | (npat & lmask & ~crw);
      }
    }
    out[base + t] = (int)val;
  }
}

extern "C" int bsmap_rc_words(const int* rows, int m, int nw, int rc0,
                              int rc1, int rc2, int rc3, int rc_n, int* out,
                              cudaStream_t stream) {
  if (m > 0) {
    bsm_rc_words_kernel<<<(m + BSM_K5_ROWS - 1) / BSM_K5_ROWS,
                          BSM_K5_THREADS, 0, stream>>>(
        rows, m, nw, rc0, rc1, rc2, rc3, rc_n, out);
  }
  return (int)cudaGetLastError();
}
