"""Bit-level primitives: 2-bit packing, base-3 seeds, asymmetric mismatch lanes.

This is the semantic core of the aligner (reference: param.h:123-153).  Every
function has a host (numpy) form; the device engine re-expresses the same math
in jnp inside its jitted kernels.

Encoding invariant (param.cpp:199-213): after ``Param.set_align`` the
reference-side nucleotide of the ``-M`` pair always encodes as ``01`` and the
read-side as ``11``; for the default ``-M TC`` this is the identity
A=00, C=01, G=10, T=11.

Derived lane rules:
  * XT seed collapse (param.cpp:122-137): lane 11 -> 01 (read T counts as C in
    seed space), others unchanged; seeds are then base-3 numbers.
  * XC asymmetric-match mask (param.h:125): per ref lane s,
    ``XC(s) = ((~s)<<1)|s|01`` — ref C(01) -> mask 01 (so read T(11)&mask = 01
    matches), any other ref lane -> mask 11 (exact match required).
  * mismatch word (align.h:167-200): ``((q & XC(s)) ^ s) & r`` where r is the
    per-lane valid-base mask (11 for ACGT, 00 for N / tail padding), counted by
    ``popcount((x | x>>1) & 0x5555...)`` (param.h:129-147).
"""

from __future__ import annotations

import numpy as np

from .params import SEGLEN

U32 = np.uint32
LANE_LO_32 = U32(0x55555555)


def pack_codes_u32(codes: np.ndarray, n_words: int | None = None) -> np.ndarray:
    """Pack 2-bit base codes into uint32 words, 16 bases/word, first base in
    the top bits (dbseq.cpp:58-83 BinSeq word layout).

    codes: (..., N) uint8 array of 2-bit codes.  Pads with 0 to n_words*16.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[-1]
    if n_words is None:
        n_words = (n + SEGLEN - 1) // SEGLEN
    padded = np.zeros(codes.shape[:-1] + (n_words * SEGLEN,), dtype=np.uint32)
    padded[..., :n] = codes
    lanes = padded.reshape(codes.shape[:-1] + (n_words, SEGLEN))
    shifts = np.arange(SEGLEN - 1, -1, -1, dtype=np.uint32) * 2
    return (lanes << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_u32(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_codes_u32: (..., W) uint32 -> (..., W*16) uint8 codes."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(SEGLEN - 1, -1, -1, dtype=np.uint32) * 2
    lanes = (words[..., None] >> shifts) & 3
    return lanes.reshape(words.shape[:-1] + (-1,)).astype(np.uint8)


def collapse_t2c(codes: np.ndarray) -> np.ndarray:
    """XT lane collapse: code 3 (read-nt) -> 1 (ref-nt); others unchanged."""
    codes = np.asarray(codes)
    return np.where(codes == 3, 1, codes).astype(codes.dtype)


def seed_values(codes: np.ndarray, seed_size: int) -> np.ndarray:
    """Base-3 seed value at every start position of a code array.

    Equivalent to the reference's XT() applied to each seed window
    (param.h:123, dbseq.cpp:286-291): digit weight 3^(S-1-k) for the k-th base
    of the window (the window's last base is the least-significant digit).

    codes: (N,) uint8.  Returns (N - S + 1,) int64 (empty if N < S).
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = codes.shape[0]
    if n < seed_size:
        return np.zeros(0, dtype=np.int64)
    col = collapse_t2c(codes)
    # Sliding-window polynomial evaluation via cumulative radix trick:
    # v[p] = sum_k col[p+k] * 3^(S-1-k).
    pow3 = 3 ** np.arange(seed_size - 1, -1, -1, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(col, seed_size)
    return win @ pow3


def xc_mask32(s: np.ndarray) -> np.ndarray:
    """Asymmetric T->C match mask from ref words (param.h:125)."""
    s = np.asarray(s, dtype=np.uint32)
    return ((~s) << U32(1)) | s | LANE_LO_32


def xm32(x: np.ndarray) -> np.ndarray:
    """Count mismatching 2-bit lanes in a uint32 word (param.h:129-137)."""
    x = np.asarray(x, dtype=np.uint32)
    lanes = (x | (x >> U32(1))) & LANE_LO_32
    # standard popcount on the masked bits
    v = lanes - ((lanes >> U32(1)) & U32(0x55555555))
    v = (v & U32(0x33333333)) + ((v >> U32(2)) & U32(0x33333333))
    v = (v + (v >> U32(4))) & U32(0x0F0F0F0F)
    return ((v * U32(0x01010101)) >> U32(24)).astype(np.int32)


def mismatch_words32(q: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Per-word asymmetric mismatch counts: XM(((q & XC(s)) ^ s) & r)
    (align.h:167-200), vectorized over leading dims."""
    q = np.asarray(q, dtype=np.uint32)
    r = np.asarray(r, dtype=np.uint32)
    s = np.asarray(s, dtype=np.uint32)
    return xm32(((q & xc_mask32(s)) ^ s) & r)


def count_mismatch_naive(q_codes, reg, s_codes) -> int:
    """Brute-force oracle for tests: asymmetric ungapped mismatch count in
    code space.  A lane matches iff the read lane is masked out (reg==0, i.e.
    read N or tail padding: align.cpp:100), codes are equal, or the read code
    is 3 (read-nt) and the ref code is 1 (ref-nt) — the bisulfite asymmetry.
    """
    n = 0
    for q, r, s in zip(q_codes, reg, s_codes):
        if r == 0:
            continue
        if q == s:
            continue
        if q == 3 and s == 1:
            continue
        n += 1
    return n
