"""Build and bind the CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process
per ``.cu`` file, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes.  The library lands in
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signatures of the entry points (each returns cudaGetLastError())
_SIGNATURES = {
    "bsmap_fixed_schedule": [_P, _P, _I, _I, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "bsmap_exact_schedule": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _P, _L, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "bsmap_verify_candidates": [_P, _P, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P,
                                _P, _I, _P, _I, _P, _P, _P, _L, _P, _L,
                                _I, _P, _P, _P, _L, _I, _I, _I,
                                _I, _P, _I, _I,
                                _P, _P, _P, _P, _P, _P, _I, _P],
    "bsmap_reduce_reads": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                           _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "bsmap_rc_words": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "bsmap_pair_join": [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    "bsmap_merge_shards": [_P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _I, _I, _I, _I, _P, _P],
}


# K3's scan and its one-launch form are cooperative launches
# (cudaLaunchCooperativeKernel with a co-resident grid): grid.sync() on
# sm_90a needs no relocatable device code (-rdc) and no flag here.


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
    library path.  Every ``.cu`` compiles in its own nvcc process, all in
    parallel, then one nvcc links them.  The compiler's resource report
    (-Xptxas -v) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{so[:-3]}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(c)[:-3]}.o" for c in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, c] for c, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [pr.communicate()[0] for pr in procs]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tag}.tmp", *objs]
    r = (subprocess.run(link, capture_output=True, text=True)
         if all(pr.returncode == 0 for pr in procs) else None)
    with open(so[:-3] + ".log", "w") as f:
        for c, out in zip(cmds, outs):
            f.write(" ".join(c) + "\n" + out)
        if r is not None:
            f.write(" ".join(link) + "\n" + r.stdout + r.stderr)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c, out) for c, out, pr in zip(cus, outs, procs)
              if pr.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{os.path.basename(c)}:\n{out}" for c, out in failed))
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                           f"{r.stderr}")
    os.replace(f"{tag}.tmp", so)
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
