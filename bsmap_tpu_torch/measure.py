"""Card measurements shared by ``chip_smoke.py`` and ``genome_scale``:
a kernel call's card time (``cuda_ms``, ``queued_ms``) and its bound
(``bound``, PERF.md section 6), the launch counts and peak card memory of
processes started under ``launch_dump_env``, and ``CardMemory``, which
samples nvidia-smi's per-process card memory.  torch is imported where
a function needs it."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12                # its non-tensor (float32) peak, for int32 ops


def _sector_bytes(first, width: int) -> int:
    """The bytes of the distinct 32-byte sectors that spans of ``width``
    bytes (at most 32) at the byte offsets ``first`` touch."""
    import numpy as np
    return 32 * len(np.union1d(first // 32, (first + width - 1) // 32))


def bound(name: str, cfg, m: int, ncand: int = 0, cands: int = 0,
          live: int = 0) -> dict:
    """The least time the card could take for one call of kernel ``name``
    on this window (m reads or pairs; ncand live candidates of a capacity
    of cands; for K6 ``live`` = the sum over pairs of valid hits of mate 1
    times valid hits of mate 2): the bytes it must move (each input read
    once, each output written once, a random 16-byte or smaller gather as
    one 32-byte sector) over the memory rate, or an estimate of its int32
    lane operations over the non-tensor peak, whichever is larger."""
    row = 4 * (2 * cfg.nw + 4)
    nch, NB, MS, S = cfg.nch, cfg.NB, cfg.maxseg, cfg.S
    seed_ops = 6 * S + 20                       # one base-3 seed value
    full_w = 4 * (2 * MS + 17 + 2 * cfg.hits_k)
    out_w = 12 if cfg.lean else full_w
    if name == "fixed_schedule":
        nbytes = m * (nch * row + 32 * NB + 20 * NB + 8 + 4 * MS)
        ops = 2 * m * NB * seed_ops
    elif name == "exact_schedule":
        # cost gathers: every schedule position (the slot rows are among
        # them), or under RRBS one probe per segment plus the slots'
        # tag_off pairs
        gathers = nch * MS + NB if cfg.rrbs else nch * cfg.P
        nbytes = m * (nch * row + 32 * gathers + 20 * NB + 8 + 4 * MS)
        ops = m * ((gathers + NB) * seed_ops
                   + (0 if cfg.rrbs else 4 * nch * MS * S * MS))
    elif name == "verify_candidates":
        nbytes = (m * (nch * row + 20 * NB) + 4 * (m * NB + 1)
                  + 64 * ncand + 16 * cands)
        ops = 10 * m * NB + ncand * (12 * cfg.nw + 130)
    elif name == "reduce_reads":
        # the sectors that the reads' row scalars (len, budget, hash, rank:
        # 16 bytes, across a sector boundary in some rows), their slot
        # starts (word b * NB) and their totals (word b * MS + MS - 1,
        # 4 * MS bytes apart) fall in; soff/coff for full rows, the output,
        # and three words (chrp, wloc, info) per candidate
        import numpy as np
        b = np.arange(m, dtype=np.int64)
        nbytes = (_sector_bytes(b * row + 8 * cfg.nw, 16)
                  + _sector_bytes(4 * NB * np.arange(m + 1), 4)
                  + _sector_bytes(4 * (b * MS + MS - 1), 4)
                  + m * ((0 if cfg.lean else 8) + out_w) + 12 * ncand)
        ops = 45 * ncand + 10 * m * MS
    elif name == "rc_words":
        nbytes = 2 * m * row
        ops = 80 * m * cfg.nw
    elif name == "merge_shards":
        # one sector of the row (len, budget, hash, rank), every shard's
        # NB + 1 slot starts and ftot of a read, soff/coff, the output, and
        # three words (chrp, wloc, info) per candidate
        D = cfg.shards
        nbytes = (m * (32 + 4 * D * (NB + 1) + 4 * D + 8 + full_w)
                  + 12 * ncand)
        ops = 45 * ncand + 10 * m * NB * D
    else:                                       # pair_join
        # per mate the 2K hit words, six extras and three dispatch words
        # (len, budget, hash), the 11-word output; 40 operations per live
        # combo, 12 per step of the two K-step loops of each of 2K hits
        K = cfg.hits_k
        nbytes = m * (2 * 4 * (2 * K + 6 + 3) + 44)
        ops = 40 * live + 12 * m * 2 * K * K
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def cuda_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, reps: int = 20, holds=(40.0, 120.0, 360.0)):
    """The card's own time for one call of ``fn``, ms: ``reps`` calls are
    enqueued behind a spin kernel that holds the stream for a while, so
    the host has enqueued them all before the first one starts and the
    CUDA-event interval around them holds no wait for the host (which the
    event time of a single call does when the host is the slower side).
    A try in which the host needed longer than 0.8 of the hold (a stalled
    host) is repeated with a longer hold; None when every try was."""
    import torch
    fn()
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1_755_000)
    for hold_ms in holds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(hold_ms * khz))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if host_ms <= 0.8 * hold_ms:
            return a.elapsed_time(b) / reps
        print(f"    queued_ms: the host took {host_ms:.1f} ms to enqueue {reps} "
            f"calls behind a {hold_ms:.0f} ms hold", flush=True)
    return None


# a sitecustomize module that makes every Python process started with it
# on its path write, at exit, its kernel launch counts (a fresh process
# starts with every count at 0) and the caching allocator's peak card
# memory: the processes of chip_smoke.py's phase 27 and of genome_scale's
# step 7 report their launches through it
LAUNCH_DUMP = '''import atexit, json, os, sys


def _bsmap_launch_dump():
    k = sys.modules.get("bsmap_tpu_torch.engine.kernels")
    if k is None:
        return
    rec = {"pid": os.getpid(), "argv": sys.argv[1:],
           "launches": k.launch_counts()}
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        rec["max_allocated"] = torch.cuda.max_memory_allocated()
        rec["max_reserved"] = torch.cuda.max_memory_reserved()
    with open(os.path.join(%r, "launches.%%d.json" %% os.getpid()), "w") as f:
        json.dump(rec, f)


atexit.register(_bsmap_launch_dump)
'''


def launch_dump_env(d: str) -> dict:
    """The environment of processes whose records ``launch_dumps`` reads:
    ``d`` (holding the ``LAUNCH_DUMP`` sitecustomize, which runs an
    existing one after it) and the repository ahead of the path, and the
    CLI's own -p rule (no ``BSMAP_TPU_LOCAL_MP``).  In chip_smoke.py's
    phases 27 and 29 that keeps the RRBS run at -p 8, the pair-end BSP run
    at -p 2 and the trimmed pair-end runs at -p 8 in one process on the
    card."""
    import importlib.util
    os.makedirs(d, exist_ok=True)
    src = LAUNCH_DUMP % d
    spec = importlib.util.find_spec("sitecustomize")
    if spec is not None and spec.origin and os.path.exists(spec.origin):
        src += (f"\nexec(compile(open({spec.origin!r}).read(), "
                f"{spec.origin!r}, 'exec'))\n")
    with open(os.path.join(d, "sitecustomize.py"), "w") as f:
        f.write(src)
    path = [d, REPO] + [x for x in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if x]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    # chip_smoke.py's main() sets it to 0 for the phases before 27
    env.pop("BSMAP_TPU_LOCAL_MP", None)
    return env


def launch_dumps(d: str, workers: bool = True) -> list:
    """The records the processes of ``launch_dump_env(d)`` wrote (removed
    once read): those of worker processes (``--proc-id``) only, or with
    ``workers`` False every one."""
    recs = []
    for name in sorted(os.listdir(d)):
        if name.startswith("launches."):
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            os.remove(os.path.join(d, name))
            if "--proc-id" in rec["argv"] or not workers:
                recs.append(rec)
    return recs


class CardMemory:
    """Samples ``nvidia-smi --query-compute-apps=pid,used_memory`` every
    0.5 s in a thread while it is entered; ``peak`` is the most processes
    listed at once and the most MiB they held together (a container may list
    every process under one pid, so the processes are not told apart)."""

    def __init__(self, on: bool = True):
        import threading
        self.on, self.peak, self.stop = on, {}, threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while not self.stop.wait(0.5):
            r = subprocess.run(["nvidia-smi",
                                "--query-compute-apps=pid,used_memory",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60)
            mib = [int(x) for ln in r.stdout.splitlines()
                   for x in ln.split(",")[1:] if x.strip().isdigit()]
            self.peak["processes"] = max(self.peak.get("processes", 0),
                                         len(mib))
            self.peak["MiB"] = max(self.peak.get("MiB", 0), sum(mib))

    def __enter__(self):
        if self.on:
            self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        if self.on:
            self.thread.join()
