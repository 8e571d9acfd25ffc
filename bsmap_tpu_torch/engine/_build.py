"""Build and bind the CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ctypes.  The library lands in
``bsmap_tpu_torch/_build/``, named by a hash of the sources, so an edited
kernel is rebuilt and an unchanged one is loaded as built.  Nothing here
runs at import time: a machine without ``nvcc`` or a GPU imports the
package and runs the plain-torch twins.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signatures of the entry points (each returns cudaGetLastError())
_SIGNATURES = {
    "bsmap_fixed_schedule": [_P, _I, _I, _P, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P],
    "bsmap_exact_schedule": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P],
    "bsmap_verify_candidates": [_P, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P,
                                _P, _I, _P, _I, _P, _P, _P, _L, _P, _L, _I,
                                _P, _P, _P, _P, _P, _P, _P],
    "bsmap_reduce_reads": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                           _P, _I, _I, _I, _I, _P, _P],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbsmap_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this source hash is built; returns the
    library path.  The compiler's resource report (-Xptxas -v) is kept
    beside the library as ``<name>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB
