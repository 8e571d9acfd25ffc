"""ctypes binding of the port's pair-end block formatter (``pe_format.cpp``).

The library is compiled with g++ at first use into ``bsmap_tpu_torch/
_build/``, named by a hash of its source, so an edited source is rebuilt
and an unchanged one loaded as built.  Each process compiles into a file
of its own and moves it in place in one step.  Where it does not build,
``get_lib`` prints the compiler's error and the route taken on stderr and
returns None, and the pair-end runs take the per-pair path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "pe_format.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_u8 = ctypes.c_uint8
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def library_path() -> str:
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libbsmap_pe_format_{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    except (OSError, subprocess.CalledProcessError) as e:
        err = getattr(e, "stderr", None)
        sys.stderr.write(err.decode(errors="replace") if err
                         else f"{e}\n")
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    return True


def get_lib() -> ctypes.CDLL | None:
    """Compile (unless built) and load the formatter; None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = library_path()
        try:
            if not os.path.exists(so) and not _build(so):
                lib = None
            else:
                lib = ctypes.CDLL(so)
        except OSError as e:
            print(e, file=sys.stderr)
            lib = None
        if lib is None:
            print("engine: per-pair path (pe_format unavailable)",
                  file=sys.stderr)
            return None
        lib.bsmap_pe_format_block.restype = _i64
        lib.bsmap_pe_format_block.argtypes = [
            ctypes.c_char_p, _p_i64, ctypes.c_char_p, _p_i64, _i64,
            _p_i32, _p_i32, _p_i32, _i64, _p_i32, _p_i32,
            _p_u8, _p_i64, _i64, _p_u8, _i32, _i32, _i32, _i32, _i32,
            _u8, _u8, _p_u32, _i64, _p_i64, ctypes.c_char_p, _p_u8, _p_u8,
            _p_u8, _i64, _p_u8, _i64, _p_i64, _p_i64, _i32, _p_i32,
            _p_i64, _i64, _p_i64]
        _LIB = lib
        return _LIB


def format_pair_block(lib, bufa: bytes, reca: np.ndarray, bufb: bytes,
                      recb: np.ndarray, prow: np.ndarray, counts_a, counts_b,
                      maxseg: int, buds_a, buds_b, chrnames: np.ndarray,
                      chrname_off: np.ndarray, revc: np.ndarray, p,
                      synth_a: int, synth_b: int, refcat: np.ndarray,
                      anchors: np.ndarray, useful_nt: bytes,
                      mapseq_a: np.ndarray, mapseq_b: np.ndarray,
                      carry=None):
    """One block's pair-end SAM (``p.out_sam``, XR tags under
    ``p.out_ref``) or BSP bytes from ``prow`` (n, 24).  BSP takes each
    mate's (n, 2*maxseg) per-level counts and budgets (None under SAM).
    ``mapseq_a``/``mapseq_b`` are the persistent context buffers, left as
    the last pair left them.  ``carry``: a range's ``parallel.carry.
    ContextCarry``, which gets the block's prints from slots the range
    has not written yet.  Returns (main bytes, unpaired bytes (BSP's -2
    file; empty under SAM), (pairs, single a, single b aligned))."""
    from ..params import SEGLEN
    n = len(reca)
    bsp = not p.out_sam
    if bsp:
        ca, cb, ba, bb = (np.ascontiguousarray(x, dtype=np.int32)
                          for x in (counts_a, counts_b, buds_a, buds_b))
    else:
        ca = cb = ba = bb = np.zeros(1, np.int32)
    max_chr = int(np.diff(chrname_off).max()) if len(chrname_off) > 1 else 0
    cap = int(2 * (reca[:, 1].sum() + recb[:, 1].sum()
                   + 3 * (reca[:, 3].sum() + recb[:, 3].sum())
                   + reca[:, 5].sum() + recb[:, 5].sum())
              + (4 * max_chr + 11 * maxseg + 256) * 2 * n + 4096)
    track = carry is not None and carry.active()
    written = carry.written if track else np.zeros(4, np.int32)
    saved = (mapseq_a.copy(), mapseq_b.copy(), written.copy())
    rec_cap = 64 if track else 0
    n_rec = np.zeros(1, np.int64)
    prow = np.ascontiguousarray(prow, dtype=np.int32)
    while True:
        out = np.empty(cap, np.uint8)
        out2 = np.empty(cap if bsp else 1, np.uint8)
        lens = np.zeros(2, np.int64)
        counters = np.zeros(3, np.int64)
        rec = np.empty((max(rec_cap, 1), 3), np.int64)
        rc = lib.bsmap_pe_format_block(
            bufa, np.ascontiguousarray(reca).reshape(-1),
            bufb, np.ascontiguousarray(recb).reshape(-1), n,
            prow.reshape(-1), ca.reshape(-1), cb.reshape(-1), maxseg, ba, bb,
            chrnames, chrname_off, max_chr, revc, int(p.out_sam >= 1),
            int(p.out_ref), int(bool(p.out_unmap)), p.report_repeat_hits,
            p.max_num_hits, synth_a, synth_b,
            np.ascontiguousarray(refcat, dtype=np.uint32),
            len(refcat) * SEGLEN,
            np.ascontiguousarray(anchors, dtype=np.int64), useful_nt,
            mapseq_a, mapseq_b, out, cap, out2, len(out2), lens, counters,
            int(track), written, rec.reshape(-1), rec_cap, n_rec)
        if rc == 0:
            if track:
                carry.add_block(rec[: n_rec[0]], int(lens[0]), int(lens[1]))
            return (out[: lens[0]].data, out2[: lens[1]].data,
                    tuple(int(x) for x in counters))
        mapseq_a[:], mapseq_b[:], written[:] = saved
        if rc == -2:
            rec_cap = int(n_rec[0])
        else:
            cap *= 2
