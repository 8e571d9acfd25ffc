"""ctypes binding of the port's exact WGBS host aligner (``host_align.cpp``).

Built as ``pe_format.py`` builds its library: g++ at first use into
``bsmap_tpu_torch/_build/``, named by a hash of the source, each process
into a file of its own moved in place in one step.  Where it does not
build, ``get_lib`` prints the compiler's error on stderr and returns None,
and the engines keep the Python host engine (``engine/native_host.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "host_align.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_vp = ctypes.c_void_p


class Ctx(ctypes.Structure):
    """``Ctx`` of host_align.cpp: the genome, index and options, by
    pointer."""

    _fields_ = [("refcat", _vp), ("crefcat", _vp), ("n_words", _i64),
                ("offsets", _vp), ("locs", _vp), ("wcounts", _vp),
                ("anchors", _vp), ("sizes", _vp), ("rc_offsets", _vp),
                ("n_chr", _i64), ("alphabet", _vp), ("rev_alphabet", _vp),
                ("profile", _vp), ("seed_size", _i32),
                ("index_interval", _i32), ("max_num_hits", _i32),
                ("report_repeat_hits", _i32), ("pairend", _i32),
                ("chains", _i32), ("min_insert", _i32), ("max_insert", _i32)]


def library_path() -> str:
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libbsmap_host_align_{h.hexdigest()[:16]}.so")


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
    """Compile (unless built) and load the aligner; None on failure."""
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
            print("engine: Python host aligner (host_align unavailable)",
                  file=sys.stderr)
            return None
        ctx_p = ctypes.POINTER(Ctx)
        lib.bsmap_host_align.restype = _i64
        lib.bsmap_host_align.argtypes = [
            ctx_p, ctypes.c_char_p, _i64, _i32, _i32, _vp, _vp, _vp, _i32,
            _vp, _i64, _vp, _vp]
        lib.bsmap_host_align_pair.restype = _i64
        lib.bsmap_host_align_pair.argtypes = [
            ctx_p,
            ctypes.c_char_p, _i64, _i32, _i32, _vp, _vp, _vp,
            ctypes.c_char_p, _i64, _i32, _i32, _vp, _vp, _vp,
            _vp, _vp, _vp, _vp, _i64, _vp, _vp, _i64, _vp]
        lib.bsmap_sync_span.restype = _i64
        lib.bsmap_sync_span.argtypes = [
            ctx_p, ctypes.c_char_p, _vp, _vp, _vp, _vp, _i64, _i32, _i32,
            _vp, _vp, _i32, _vp, _vp, _vp]
        _LIB = lib
        return _LIB
