// Shared device helpers of the alignment kernels (sm_90a, plain C ABI).
//
// Dispatch rows are (m, 2*nw + 4) int32:
//   [qwords (2-bit packed read, first base in the top bits) |
//    rwords (valid-lane masks) | len | budget | rand32 | maxrank]
// exactly as bsmap_tpu/engine/device_engine.py:1128-1169 lays them out.
// All arithmetic follows the JAX program's int32/uint32 semantics: uint32
// sums wrap, int32 sums wrap (computed unsigned, then reinterpreted).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define BSM_MAX_MS 16                                  // maxseg
#define BSM_MAX_S 16                                   // seed size
#define BSM_MAX_I 16                                   // index interval
#define BSM_MAX_NW 10                                  // packed words/read
#define BSM_MAX_P 160                                  // schedule positions
#define BSM_MAX_SHARDS 16                              // index region shards
#define BSM_MAX_WLEN (BSM_MAX_MS * BSM_MAX_S + BSM_MAX_I)
#define BSM_SATLIM (1 << 30)
#define BSM_FTOT_CLAMP (1 << 27)
#define BSM_BIGLEVEL 99

// per-candidate info word (engine/kernels.py INFO_*)
#define BSM_INFO_ELIGIBLE 1
#define BSM_INFO_UNRESOLVED 2
#define BSM_INFO_FIRST 4
#define BSM_INFO_WMM_SHIFT 3
#define BSM_INFO_RANK_SHIFT 11
#define BSM_INFO_FRAG (1 << 16)   // RRBS: eligible, inside a valid fragment
#define BSM_INFO_CHAIN_SHIFT 17   // the candidate's chain: 0 forward, 1 rc
#define BSM_INFO_CORNER (1 << 18) // index-sharded: eligible, dedup key in
                                  // another region shard

static __device__ __forceinline__ int bsm_floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

static __device__ __forceinline__ int bsm_floormod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

static __device__ __forceinline__ int bsm_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// seedseg = clip(min((len - I + 1) // S, budget + 1), 0, MS)
static __device__ __forceinline__ int bsm_seedseg(int len, int bud, int S,
                                                  int I, int MS) {
  int s = min(bsm_floordiv(len - I + 1, S), bud + 1);
  return bsm_clampi(s, 0, MS);
}

// _seed_array_w (device_engine.py:266) at one read offset: funnel-shift the
// 16-lane window starting at `pos` out of the packed words (a zero word
// past the last), collapse T (11) to C (01), accumulate the top S lanes in
// base 3.  The shift by 32 - zz is guarded for zz == 0 like the JAX code.
static __device__ __forceinline__ int bsm_seed_at(const int* row, int nw,
                                                  int S, int pos) {
  int ka = pos >> 4;
  uint32_t a = ka < nw ? (uint32_t)row[ka] : 0u;
  uint32_t b = ka + 1 < nw ? (uint32_t)row[ka + 1] : 0u;
  uint32_t zz = (uint32_t)((pos & 15) * 2);
  uint32_t w = zz == 0 ? a : ((a << zz) | (b >> (32u - zz)));
  uint32_t t = w & (w >> 1) & 0x55555555u;
  uint32_t cw = w ^ (t << 1);
  int acc = 0;
  for (int j = 0; j < S; ++j)
    acc = acc * 3 + (int)((cw >> (2 * (15 - j))) & 3u);
  return acc;
}
