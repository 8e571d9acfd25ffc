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
// Bound on the card: 2*(2nw+4) int32 per read of traffic and a few dozen
// bit operations per word; nothing to reuse between reads.  Design: one
// thread per read; the 2*nw reversed words sit in registers/local memory.

#include "common.cuh"

static __device__ __forceinline__ uint32_t bsm_rev_lanes(uint32_t w) {
  w = ((w & 0x33333333u) << 2) | ((w >> 2) & 0x33333333u);
  w = ((w & 0x0F0F0F0Fu) << 4) | ((w >> 4) & 0x0F0F0F0Fu);
  w = ((w & 0x00FF00FFu) << 8) | ((w >> 8) & 0x00FF00FFu);
  return (w << 16) | (w >> 16);
}

__global__ void bsm_rc_words_kernel(const int* __restrict__ rows, int m,
                                    int nw, int rc0, int rc1, int rc2,
                                    int rc3, int rc_n,
                                    int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  const int width = 2 * nw + 4;
  const int* row = rows + (size_t)b * width;
  int* o = out + (size_t)b * width;
  const int rc[4] = {rc0, rc1, rc2, rc3};
  const bool plain = rc0 == 3 && rc1 == 2 && rc2 == 1 && rc3 == 0;
  // reversed complement and reversed valid-mask words, zero past nw
  uint32_t cq[2 * BSM_MAX_NW], cr[2 * BSM_MAX_NW];
  for (int k = 0; k < nw; ++k) {
    const uint32_t q = (uint32_t)row[k];
    uint32_t comp = ~q;
    if (!plain) {
      comp = 0;
      for (int v = 0; v < 4; ++v) {
        if (rc[v] == 0) continue;
        const uint32_t x = q ^ (uint32_t)(v * 0x55555555u);
        const uint32_t ind = ~(x | (x >> 1)) & 0x55555555u;  // lanes == v
        comp |= ind * (uint32_t)rc[v];
      }
    }
    cq[nw - 1 - k] = bsm_rev_lanes(comp);
    cr[nw - 1 - k] = bsm_rev_lanes((uint32_t)row[nw + k]);
    cq[nw + k] = 0;
    cr[nw + k] = 0;
  }
  const int len = row[2 * nw];
  const int sh = 16 * nw - len;                // bases to shift out
  const int k0 = sh >> 4;
  const uint32_t z = (uint32_t)((sh & 15) * 2);
  const uint32_t npat = (uint32_t)rc_n * 0x55555555u;
  for (int k = 0; k < nw; ++k) {
    const int i = k0 + k;
    const bool in0 = i >= 0 && i < 2 * nw, in1 = i + 1 >= 0 && i + 1 < 2 * nw;
    const uint32_t qa = in0 ? cq[i] : 0u, qb = in1 ? cq[i + 1] : 0u;
    const uint32_t ra = in0 ? cr[i] : 0u, rb = in1 ? cr[i + 1] : 0u;
    // the JAX code guards the shift by 32 - z for z == 0 (:340-341)
    const uint32_t cq0 = z == 0 ? qa : ((qa << z) | (qb >> (32u - z)));
    const uint32_t crw = z == 0 ? ra : ((ra << z) | (rb >> (32u - z)));
    // lanes < len of word k: 11, beyond 00 (shift capped at 30, :298)
    const int v = bsm_clampi(len - 16 * k, 0, 16);
    const uint32_t lmask =
        v > 0 ? (0xFFFFFFFFu << (uint32_t)min(2 * (16 - v), 30)) : 0u;
    o[k] = (int)((cq0 & crw) | (npat & lmask & ~crw));
    o[nw + k] = (int)crw;
  }
  for (int c = 2 * nw; c < width; ++c) o[c] = row[c];
}

extern "C" int bsmap_rc_words(const int* rows, int m, int nw, int rc0,
                              int rc1, int rc2, int rc3, int rc_n, int* out,
                              cudaStream_t stream) {
  if (m > 0) {
    const int threads = 128;
    bsm_rc_words_kernel<<<(m + threads - 1) / threads, threads, 0, stream>>>(
        rows, m, nw, rc0, rc1, rc2, rc3, rc_n, out);
  }
  return (int)cudaGetLastError();
}
