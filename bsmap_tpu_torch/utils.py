"""Timers, reproducible RNG and hit orderings (utilities.cpp)."""

from __future__ import annotations

import time

import numpy as np

_U64 = np.uint64
_M1 = _U64(3935559000370003845)
_A1 = _U64(2691343689449507681)
_M2 = _U64(4768777513237032717)


def myrand_hash(read_index, randseed: int):
    """Stateless per-read hash used for reproducible multi-hit selection when
    -S != 0 (utilities.cpp:40-50): a splitmix/xorshift mix of
    (read_index + randseed*10^6).  Vectorized over read_index."""
    with np.errstate(over="ignore"):
        v = (_U64(np.uint64(randseed * 1000000)) +
             np.asarray(read_index, dtype=np.uint64)) * _M1 + _A1
        v ^= v >> _U64(21)
        v ^= (v << _U64(37)) & _U64(0xFFFFFFFFFFFFFFFF)
        v ^= v >> _U64(4)
        v = (v * _M2) & _U64(0xFFFFFFFFFFFFFFFF)
        v ^= (v << _U64(20)) & _U64(0xFFFFFFFFFFFFFFFF)
        v ^= v >> _U64(41)
        v ^= (v << _U64(5)) & _U64(0xFFFFFFFFFFFFFFFF)
    return (v & _U64(0xFFFFFFFF)).astype(np.uint32)


class RandR:
    """glibc rand_r (TYPE_0) — used only for -S 0, where the reference seeds
    from getpid()*time() and results are explicitly non-reproducible
    (README.txt:91-92)."""

    def __init__(self, seed: int):
        self.state = np.uint32(seed)

    def __call__(self) -> int:
        with np.errstate(over="ignore"):
            n = self.state
            n = n * np.uint32(1103515245) + np.uint32(12345)
            result = int((n // np.uint32(65536)) % np.uint32(2048))
            n = n * np.uint32(1103515245) + np.uint32(12345)
            result = (result << 10) ^ int((n // np.uint32(65536)) % np.uint32(1024))
            n = n * np.uint32(1103515245) + np.uint32(12345)
            result = (result << 10) ^ int((n // np.uint32(65536)) % np.uint32(1024))
            self.state = n
        return result

    def skip(self, n_draws: int) -> None:
        """Advance the stream by n_draws rand_r calls (3 LCG steps each)
        in O(log n) via affine-map composition — used by the device -S 0
        path to account for unique-hit reads whose draw value is irrelevant
        (j = draw % 1) but whose stream consumption is not."""
        if n_draws <= 0:
            return
        k = 3 * n_draws
        with np.errstate(over="ignore"):
            a, c = np.uint32(1103515245), np.uint32(12345)
            ra, rc = np.uint32(1), np.uint32(0)
            while k:
                if k & 1:
                    # compose: apply (ra, rc) then (a, c)
                    ra, rc = a * ra, a * rc + c
                a, c = a * a, a * c + c
                k >>= 1
            self.state = ra * self.state + rc


def myrand(read_index: int, randseed: int, rand_r: RandR) -> int:
    """utilities.cpp:40-50 dispatch."""
    if randseed == 0:
        return rand_r()
    return int(myrand_hash(read_index, randseed))


class StepTimer:
    """Wall-clock phase timers (utilities.cpp:10-29)."""

    def __init__(self) -> None:
        self.t0 = time.time()
        self.last = self.t0

    def step(self) -> float:
        now = time.time()
        dt = now - self.last
        self.last = now
        return dt

    def total(self) -> float:
        return time.time() - self.t0
