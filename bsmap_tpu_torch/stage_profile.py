#!/usr/bin/env python3
"""Stage breakdown of the PyTorch port's single-end path on one GPU.

    python3 -m bsmap_tpu_torch.stage_profile [--reads N] [--repeat]

Generates the headline data (2 x 5 Mb genome, fully converted 100 nt reads,
tools/genreads.generate) or, with --repeat, the chr21-class data (46.7 Mb,
8% repeats), aligns it at -v 2 -S 17 and times each stage on its own:

  parse    native parse + filter + encode of every block (one thread)
  align    DeviceEngine.align_block + finish over the pre-encoded blocks
           (rounds 1 and 2, collection, host replays), with the engine's
           h2d / launch / collect timers
  kernels  CUDA kernel time inside a second align pass (torch.profiler),
           and the device's idle share of that pass's wall time
  format   native SAM formatting + file write of the aligned blocks
  pipeline the whole CLI (cli.run: the three stages overlapped in threads)

Prints one JSON object as the last line, after the card's name and power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # tools/genreads.py lives beside the package
    sys.path.insert(0, REPO)


def _kernel_ms(prof) -> dict[str, float]:
    """Device time per kernel name (ms) from a torch.profiler run."""
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t and ev.device_type.name == "CUDA":
            out[ev.key] = out.get(ev.key, 0.0) + t / 1000.0
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stage_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--repeat", action="store_true")
    args = ap.parse_args()
    from tools.genreads import generate, generate_chr21
    from . import cli, native
    from .blockio import BlockReadStream
    from .engine import _build
    from .engine.device_engine import DeviceEngine
    from .output.sam import SamFormatter
    from .utils import RandR

    root = tempfile.mkdtemp(prefix="bsmap_prof_")
    try:
        gen = generate_chr21 if args.repeat else generate
        gpath, rpath = gen(root, n_reads=args.reads)
        flags = ["-a", rpath, "-d", gpath, "-v", "2", "-S", "17"]
        o = cli.parse_args(flags + ["-o", os.path.join(root, "x.sam")])
        p = o.param
        p.out_sam = 1
        genome = cli.load_genome(gpath, p)
        index = cli.get_index(o, genome)
        _build.lib()
        eng = DeviceEngine(genome, index, p, device="cuda")
        lib = native.get_lib()
        blk_n = 8 * eng.B

        t0 = time.perf_counter()
        stream = BlockReadStream(rpath, p, readset=0, lib=lib)
        blocks = []
        while (blk := stream.next_block(blk_n)) is not None:
            eng.encode_block(blk)
            blocks.append(blk)
        stream.close()
        t_parse = time.perf_counter() - t0

        def align_all():
            out = []
            for blk in blocks:
                live_pos, fin, buds = eng.align_block(blk)
                res = fin()
                out.append((blk, (live_pos, lambda r=res: r, buds)))
            torch.cuda.synchronize()
            return out

        align_all()                                  # warm-up pass
        for k in ("t_h2d", "t_call", "t_collect", "t_enqueue"):
            setattr(eng, k, 0.0)
        eng.n_dispatched = eng.n_replayed = eng.n_probe = 0
        t0 = time.perf_counter()
        aligned = align_all()
        t_align = time.perf_counter() - t0
        timers = {k: getattr(eng, k) for k in
                  ("t_h2d", "t_call", "t_collect", "t_enqueue")}
        counts = {k: getattr(eng, k) for k in
                  ("n_dispatched", "n_probe", "n_replayed")}

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            align_all()
            t_prof = time.perf_counter() - t0
        kms = _kernel_ms(prof)
        k_total = sum(kms.values())

        fmt = SamFormatter(genome, p, RandR(1))
        t0 = time.perf_counter()
        with open(os.path.join(root, "fmt.sam"), "wb") as f:
            for blk, al in aligned:
                f.write(eng.format_aligned_block(blk, al, fmt))
        t_fmt = time.perf_counter() - t0
        del eng, aligned
        torch.cuda.empty_cache()

        st: dict = {}
        rc = cli.run(flags + ["-o", os.path.join(root, "run.sam"),
                              "--device", "cuda"], stats=st)
        if rc != 0:
            raise RuntimeError(f"cli.run returned {rc}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n = args.reads
    res = {
        "data": "chr21_class" if args.repeat else "headline", "reads": n,
        "parse_s": t_parse, "align_s": t_align, "format_s": t_fmt,
        "align_timers_s": timers, "engine_counts": counts,
        "profiled_align_s": t_prof, "kernel_ms_total": k_total,
        "device_idle_share": 1.0 - k_total / 1000.0 / t_prof,
        "kernel_ms": dict(sorted(kms.items(), key=lambda kv: -kv[1])[:12]),
        "pipeline_align_s": st["align_s"],
        "pipeline_reads_per_s": st["reads"] / st["align_s"],
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
