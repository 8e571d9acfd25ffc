#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bsmap_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

  1. the card, the torch/CUDA versions, and the kernel build (nvcc, sm_90a);
  2. headline data: 2 x 5 Mb genome, 1,000,000 fully converted 100 nt reads
     (tools/genreads.generate), -v 2 -S 17, SAM out; genome + index;
  3. each kernel against its plain-torch twin on the card, on the first
     65,536-read window: fixed lean (round 1), exact lean at both capacity
     tiers, exact full rows, and the probe pass.  Equal bit for bit
     (int32 throughout, tolerance 0); CUDA-event medians of 7 runs;
  4. the main path: ``bsmap_tpu_torch.cli.run`` on all 1M reads on cuda;
  5. repeat-heavy data: one 46.7 Mb chromosome with 8% repeats, 100,000
     reads (probe mode and round 2);
  6. byte parity: the first 10,000 reads of both datasets, GPU run against
     the port's exact host engine.

The kernels' launch counters are zeroed right before phase 4 and read right
after phase 5; every kernel must have run there.  The last lines are the
per-kernel JSON, the card's name and power limit, and the result line.
Exits non-zero without printing a result when torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_HEADLINE = 1_000_000
N_REPEAT = 100_000
N_PARITY = 10_000
ALIGN_FLAGS = ["-v", "2", "-S", "17"]
KERNEL_SOURCES = {
    "fixed_schedule": ("bsmap_tpu_torch/csrc/fixed_schedule.cu",
                       "bsmap_tpu/engine/device_engine.py:350"),
    "exact_schedule": ("bsmap_tpu_torch/csrc/exact_schedule.cu",
                       "bsmap_tpu/engine/device_engine.py:404"),
    "verify_candidates": ("bsmap_tpu_torch/csrc/verify_candidates.cu",
                          "bsmap_tpu/engine/device_engine.py:679"),
    "reduce_reads": ("bsmap_tpu_torch/csrc/reduce_reads.cu",
                     "bsmap_tpu/engine/device_engine.py:899"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


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


def run_cli(argv: list[str]) -> dict:
    """``cli.run`` in this process with its progress lines kept quiet;
    returns the alignment stats."""
    from bsmap_tpu_torch import cli
    stats: dict = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run(argv, stats=stats)
    if rc != 0:
        raise RuntimeError(f"cli.run returned {rc}:\n{buf.getvalue()}")
    stats["log"] = buf.getvalue()
    return stats


def phase_build() -> None:
    from bsmap_tpu_torch.engine import _build
    t0 = time.time()
    so = _build.build()
    _build.lib()
    log(f"[1] kernels built in {time.time() - t0:.1f} s: {os.path.basename(so)}")
    if os.path.exists(so[:-3] + ".log"):        # written by the build
        with open(so[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("    " + line.strip())


def phase_data(root: str, gen, tag: str, **kw):
    """Generate one dataset and build its genome and index.  (Each CLI run
    below builds its own again: the memory-mapped index cache of
    ``index._mmap_npz`` does not load under numpy 2.3+.)"""
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.reference import load_genome
    d = os.path.join(root, tag)
    t0 = time.time()
    gpath, rpath = gen(d, **kw)
    t1 = time.time()
    o = parse_args(["-a", rpath, "-d", gpath, "-o", "x.sam"] + ALIGN_FLAGS)
    genome = load_genome(gpath, o.param)
    index = get_index(o, genome)
    log(f"[2] {tag}: data {t1 - t0:.1f} s, genome+index "
        f"{time.time() - t1:.1f} s ({genome.sum_length} bp, "
        f"{len(index.locs)} index entries)")
    return gpath, rpath, o, genome, index


def phase_kernels(o, genome, index, rpath: str, dev: str = "cuda") -> dict:
    """Each kernel against its twin on the first window; returns per-kernel
    {max_abs_err, ms, plain_ms}.  (``dev`` = "cpu" rehearses the plumbing
    with the twins on both sides and no timing.)"""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine

    eng = DeviceEngine(genome, index, o.param, device=dev)
    stream = BlockReadStream(rpath, o.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    MS = eng._maxseg
    rows0 = torch.from_numpy(rows_np).to(dev)              # round 1: rank 0
    rows_np = rows_np.copy()
    rows_np[:, -1] = MS - 1
    rowsF = torch.from_numpy(rows_np).to(dev)              # round 2: full rank
    cfg_lean = eng._cfg("f", lean=True, nw=nw)
    cases = [
        ("fixed lean, small tier", cfg_lean._replace(fixed=True), eng.CANDS,
         rows0),
        ("exact lean, small tier", cfg_lean, eng.CANDS, rows0),
        ("exact lean, big tier", cfg_lean, eng.CANDS_BIG, rowsF),
        ("exact full, big tier", cfg_lean._replace(lean=False),
         eng.CANDS_BIG, rowsF),
        ("probe", cfg_lean._replace(probe=True, lean=False), 1, rowsF),
    ]
    errs = {k: 0 for k in KERNEL_SOURCES}

    def check(name, case, got, want):
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape:
                raise AssertionError(f"{name} [{case}] output {i}: shape "
                                     f"{tuple(a.shape)} != {tuple(b.shape)}")
            d = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
                if a.numel() else 0
            errs[name] = max(errs[name], d)
            if d != 0:
                raise AssertionError(f"{name} [{case}] output {i} differs "
                                     f"from its twin (max |diff| {d})")

    tabs = eng.tables
    for case, cfg, cands, rows in cases:
        if cfg.probe:
            got = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                   tabs["prof_a"], probe=True)
            want = K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                          tabs["prof_a"], probe=True)
            check("exact_schedule", case, [got.ftot_rank], [want.ftot_rank])
            continue
        if cfg.fixed:
            slots = K.fixed_schedule(cfg, rows, tabs["kmer_tab"])
            want = K.fixed_schedule_plain(cfg, rows, tabs["kmer_tab"])
            check("fixed_schedule", case, slots, want)
        else:
            slots = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                     tabs["prof_a"])
            want = K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                          tabs["prof_a"])
            check("exact_schedule", case, slots, want)
        vc = K.verify_candidates(cfg, cands, rows, slots, tabs)
        check("verify_candidates", case, vc,
              K.verify_candidates_plain(cfg, cands, rows, slots, tabs))
        out = K.reduce_reads(cfg, cands, rows, vc, slots)
        check("reduce_reads", case, [out],
              [K.reduce_reads_plain(cfg, cands, rows, vc, slots)])
        n_total = int(vc.starts[-1])
        lean = out[:, 1] if cfg.lean else None
        found = int((lean & 1).sum()) if lean is not None else \
            int(out[:, 2 * MS].sum())
        log(f"[3] {case}: {rows.shape[0]} reads, {n_total} candidates, "
            f"{found} found — kernels == twins")

    # times at the main path's shapes: round 1 (fixed, small tier) for
    # K1/K3/K4, the full-rank exact schedule for K2
    cfg_f = cfg_lean._replace(fixed=True)
    s_f = K.fixed_schedule(cfg_f, rows0, tabs["kmer_tab"])
    vc_f = K.verify_candidates(cfg_f, eng.CANDS, rows0, s_f, tabs)
    timed = {
        "fixed_schedule": (
            lambda: K.fixed_schedule(cfg_f, rows0, tabs["kmer_tab"]),
            lambda: K.fixed_schedule_plain(cfg_f, rows0, tabs["kmer_tab"])),
        "exact_schedule": (
            lambda: K.exact_schedule(cfg_lean, rowsF, tabs["kmer_tab"],
                                     tabs["prof_a"]),
            lambda: K.exact_schedule_plain(cfg_lean, rowsF, tabs["kmer_tab"],
                                           tabs["prof_a"])),
        "verify_candidates": (
            lambda: K.verify_candidates(cfg_f, eng.CANDS, rows0, s_f, tabs),
            lambda: K.verify_candidates_plain(cfg_f, eng.CANDS, rows0, s_f,
                                              tabs)),
        "reduce_reads": (
            lambda: K.reduce_reads(cfg_f, eng.CANDS, rows0, vc_f, s_f),
            lambda: K.reduce_reads_plain(cfg_f, eng.CANDS, rows0, vc_f,
                                         s_f)),
    }
    res = {}
    for name, (kern, plain) in timed.items():
        if dev != "cuda":
            res[name] = {"max_abs_err": errs[name]}
            continue
        # plain, kernel, kernel, plain: both measured in turns
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        res[name] = {"max_abs_err": errs[name], "ms": min(k1, k2),
                     "plain_ms": min(p1, p2)}
        log(f"[3] {name}: kernel {k1:.3f}/{k2:.3f} ms, plain "
            f"{p1:.3f}/{p2:.3f} ms ({rows0.shape[0]} reads)")
    del eng, tabs, s_f, vc_f, rows0, rowsF
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_align(tag: str, gpath: str, rpath: str, out: str,
                n_reads: int, min_mapped: float, dev: str = "cuda") -> dict:
    """One full CLI run on the card; checks the read count and the mapped
    share, prints reads/s and the engine counters."""
    st = run_cli(["-a", rpath, "-d", gpath, "-o", out, "--device", dev]
                 + ALIGN_FLAGS)
    eng = st["engine"]
    if st["reads"] != n_reads:
        raise AssertionError(f"{tag}: aligned {st['reads']} of {n_reads}")
    with open(out, "rb") as f:
        lines = sum(1 for ln in f if not ln.startswith(b"@"))
    if not min_mapped * n_reads <= lines <= n_reads:
        raise AssertionError(f"{tag}: {lines} SAM records for {n_reads} "
                             "fully converted reads")
    rate = st["reads"] / st["align_s"]
    log(f"[{tag}] {st['reads']} reads in {st['align_s']:.3f} s = "
        f"{rate:.1f} reads/s; {lines} mapped; n_dispatched "
        f"{eng.n_dispatched}, n_probe {eng.n_probe}, n_replayed "
        f"{eng.n_replayed}, probe_mode {eng.probe_mode}")
    return {"reads_per_s": rate, "align_s": st["align_s"],
            "n_dispatched": eng.n_dispatched, "n_probe": eng.n_probe,
            "n_replayed": eng.n_replayed}


def phase_parity(tag: str, gpath: str, rpath: str, d: str,
                 dev: str = "cuda") -> None:
    outs = []
    for eng in (["--device", dev], ["--engine", "host"]):
        out = os.path.join(d, f"parity_{eng[1]}.sam")
        run_cli(["-a", rpath, "-d", gpath, "-o", out, "-E", str(N_PARITY)]
                + ALIGN_FLAGS + eng)
        with open(out, "rb") as f:
            outs.append(f.read())
    if outs[0] != outs[1]:
        a, b = outs[0].splitlines(), outs[1].splitlines()
        bad = next(i for i in range(min(len(a), len(b)) + 1)
                   if i >= min(len(a), len(b)) or a[i] != b[i])
        raise AssertionError(f"{tag}: GPU SAM differs from the host engine "
                             f"at line {bad}")
    log(f"[6] {tag}: first {N_PARITY} reads byte-identical to the host "
        f"engine ({len(outs[0])} bytes)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bsmap_tpu_torch.engine import kernels as K
    from tools.genreads import generate, generate_chr21

    card = card_line()
    import numpy
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, numpy {numpy.__version__}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    phase_build()
    root = tempfile.mkdtemp(prefix="bsmap_smoke_")
    try:
        g1, r1, o1, genome, index = phase_data(
            root, generate, "headline", n_reads=N_HEADLINE)
        kres = phase_kernels(o1, genome, index, r1)
        del genome, index
        g2, r2, _o2, _g, _i = phase_data(
            root, generate_chr21, "repeat", n_reads=N_REPEAT)
        del _g, _i

        K.reset_launch_counts()
        head = phase_align("4", g1, r1, os.path.join(root, "head.sam"),
                           N_HEADLINE, 0.9)
        counts4 = K.launch_counts()
        rep = phase_align("5", g2, r2, os.path.join(root, "rep.sam"),
                          N_REPEAT, 0.5)
        counts = K.launch_counts()
        log(f"[4] launches, headline run: {counts4}")
        log(f"[5] launches, headline + repeat-heavy runs: {counts}")
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
        from bsmap_tpu_torch import native
        if native.get_lib() is None:
            raise AssertionError("native block path not taken")

        phase_parity("headline", g1, r1, os.path.join(root, "headline"))
        phase_parity("repeat", g2, r2, os.path.join(root, "repeat"))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    log(f"[summary] headline {head['reads_per_s']:.1f} reads/s, "
        f"repeat-heavy {rep['reads_per_s']:.1f} reads/s")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep_,
         "launches": counts[k], **kres[k]}
        for k, (src, rep_) in KERNEL_SOURCES.items()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
