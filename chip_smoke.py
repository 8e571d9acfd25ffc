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
     the port's exact host engine;
  7. pair-end data: one 4.6 Mb chromosome, 200,000 pairs of 76 nt
     (tools/genreads.generate_pe, BASELINE config 2); genome + index;
  8. the pair-end kernels against their twins on the first 65,536-pair
     window: rc_words, both mates' K2/K3/K4 with cfg.pe and 16 hits at
     rank 0 and full rank on both capacity tiers, and pair_join; equal bit
     for bit, CUDA-event medians of 7 runs;
  9. the pair-end main path: ``cli.run`` with -a/-b on all 200,000 pairs
     on cuda; at least 90% properly paired;
 10. byte parity: the first 10,000 pairs, GPU run against the host engine;
 11. the pair-end paths that error-free pairs never reach: 10,000 simulated
     pairs with 2% errors (tools/simulate.py), every 8th cut to 51 nt (a
     length whose seed schedule may read stale state: host replays),
     through the block path (SAM; phase 2 at full rank) and the per-pair
     path (BSP with -2), each byte-identical to the host engine;
 12. RRBS data: BASELINE config 3 (tools/genreads.generate_rrbs defaults:
     one 10 Mb chromosome, 200,000 MspI-fragment 76 nt reads); genome and
     the tag-partitioned index;
 13. K2, K3 and K4 with cfg.rrbs against their twins on the first
     65,536-read window (trimmed, full rank, big tier), lean and full rows;
     equal bit for bit, CUDA-event medians of 7 runs;
 14. the RRBS main path: ``cli.run`` with -D C-CGG -A AGATCGGAAGAGC -q 2
     -S 17 on all 200,000 reads on cuda; at least 90% aligned;
 15. RRBS byte parity against the host engine: the first 10,000 reads of
     phase 12 (SAM, trimming), and 10,000 mixed-strand reads with
     mismatches on a two-chromosome digest (``make_rrbs_set``, the CPU
     tests' generator) as SAM with -m 100 -x 150 and as BSP.

The kernels' launch counters are zeroed right before phase 4 and read right
after phase 5 (the single-end path: K1-K4 must have run), zeroed right
before each GPU run of phases 9 and 11 and read right after it (the
pair-end paths: K2-K6 must have run in each), and zeroed right before
phase 14 and read right after it (the RRBS path: K2-K4 must have run, K1
never).  The last lines are the per-kernel JSON, the card's name and power
limit, and the result line.  Exits non-zero without printing a result when
torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import re
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
N_PAIRS = 200_000
# phase 11: (tag, flags, output suffix [, -2], the least n_dispatched and
# n_replayed that show the path's corners ran: phase 2, host replays)
PE_PATH_RUNS = (
    ("block path", ["-S", "1", "-v", "2", "-u"], ("sam",), 2, 1),
    ("per-pair path", ["-S", "3", "-v", "3"], ("bsp", "-2"), 4, 1),
)
ALIGN_FLAGS = ["-v", "2", "-S", "17"]
PE_FLAGS = ["-S", "17"]
N_RRBS = 200_000
RRBS_FLAGS = ["-D", "C-CGG", "-A", "AGATCGGAAGAGC", "-q", "2", "-S", "17"]
# phase 15 on the mixed-strand set: (flags, output suffix)
RRBS_SET_RUNS = (
    (["-D", "C-CGG", "-S", "1", "-v", "2", "-u", "-m", "100", "-x", "150"],
     "sam"),
    (["-D", "C-CGG", "-S", "2", "-v", "4", "-u"], "bsp"),
)
KERNEL_SOURCES = {
    "fixed_schedule": ("bsmap_tpu_torch/csrc/fixed_schedule.cu",
                       "bsmap_tpu/engine/device_engine.py:350"),
    "exact_schedule": ("bsmap_tpu_torch/csrc/exact_schedule.cu",
                       "bsmap_tpu/engine/device_engine.py:404"),
    "verify_candidates": ("bsmap_tpu_torch/csrc/verify_candidates.cu",
                          "bsmap_tpu/engine/device_engine.py:679"),
    "reduce_reads": ("bsmap_tpu_torch/csrc/reduce_reads.cu",
                     "bsmap_tpu/engine/device_engine.py:899"),
    "rc_words": ("bsmap_tpu_torch/csrc/rc_words.cu",
                 "bsmap_tpu/engine/device_engine.py:302"),
    "pair_join": ("bsmap_tpu_torch/csrc/pair_join.cu",
                  "bsmap_tpu/engine/pair_device.py:73"),
}
SE_PATH = ("fixed_schedule", "exact_schedule", "verify_candidates",
           "reduce_reads")
PE_PATH = ("exact_schedule", "verify_candidates", "reduce_reads", "rc_words",
           "pair_join")
RRBS_PATH = ("exact_schedule", "verify_candidates", "reduce_reads")
RRBS_ADAPTER = "AGATCGGAAGAGC"


def make_rrbs_set(d, n_reads: int, n_chr: int = 2, chr_len: int = 30000,
                  n_pairs: int = 0, seed: int = 77) -> None:
    """An MspI-digested genome ``rrbs.fa`` (``n_chr`` chromosomes of random
    30-300 bp segments joined by CCGG) and ``se.fq``: fragment-start reads
    of 60 or 76 nt from both strands, 90% of C converted, a quarter with
    one and a quarter with two random substitutions.  With ``n_pairs``,
    also ``pe1.fq``/``pe2.fq``: whole fragments with the adapter read
    through, cut to 60 nt."""
    comp = str.maketrans("ACGT", "TGCA")
    rng = random.Random(seed)
    chrs = []
    for _ in range(n_chr):
        parts, pos = [], 0
        while pos < chr_len:
            seg = "".join(rng.choice("ACGT")
                          for _ in range(rng.randint(30, 300)))
            parts += [seg, "CCGG"]
            pos += len(seg) + 4
        chrs.append("".join(parts))
    with open(os.path.join(d, "rrbs.fa"), "w") as f:
        for c, g in enumerate(chrs):
            f.write(f">chr{c + 1}\n")
            for i in range(0, len(g), 70):
                f.write(g[i:i + 70] + "\n")
    sites = [[m.start() for m in re.finditer("CCGG", g)] for g in chrs]

    def fragment():
        while True:
            c = rng.randrange(n_chr)
            i = rng.randrange(len(sites[c]) - 1)
            start = sites[c][i] + 1
            frag = chrs[c][start: sites[c][i + 1] + 3]
            if 28 <= len(frag) <= 500:
                return c, start, frag

    def conv(s):
        return "".join("T" if ch == "C" and rng.random() < 0.9 else ch
                       for ch in s)

    def qual(s):
        return "".join(chr(33 + rng.randint(20, 40)) for _ in s)

    with open(os.path.join(d, "se.fq"), "w") as f:
        for n in range(n_reads):
            c, start, frag = fragment()
            L = min(rng.choice((60, 76)), len(frag))
            s = (frag if rng.random() < 0.5
                 else frag[::-1].translate(comp))[:L]
            s = list(conv(s))
            for _ in range(rng.choice((0, 0, 1, 2))):
                s[rng.randrange(len(s))] = rng.choice("ACGT")
            s = "".join(s)
            f.write(f"@r{n}_chr{c + 1}_{start}\n{s}\n+\n{qual(s)}\n")
    if not n_pairs:
        return
    with open(os.path.join(d, "pe1.fq"), "w") as f1, \
            open(os.path.join(d, "pe2.fq"), "w") as f2:
        for n in range(n_pairs):
            c, start, frag = fragment()
            cv = conv(frag)
            r1 = (cv + RRBS_ADAPTER)[:60]
            r2 = (cv[::-1].translate(comp) + RRBS_ADAPTER)[:60]
            f1.write(f"@p{n}_{start}/1\n{r1}\n+\n{qual(r1)}\n")
            f2.write(f"@p{n}_{start}/2\n{r2}\n+\n{qual(r2)}\n")


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


def check(errs: dict, name: str, case: str, got, want) -> None:
    """Kernel outputs against twin outputs: equal shapes, max |diff| 0;
    the largest difference seen is kept in ``errs[name]``."""
    import torch
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape:
            raise AssertionError(f"{name} [{case}] output {i}: shape "
                                 f"{tuple(a.shape)} != {tuple(b.shape)}")
        d = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0
        errs[name] = max(errs.get(name, 0), d)
        if d != 0:
            raise AssertionError(f"{name} [{case}] output {i} differs "
                                 f"from its twin (max |diff| {d})")


def timed_pair(name: str, kern, plain, what: str) -> dict:
    """Kernel and twin timed in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                      cuda_ms(plain))
    log(f"    {name}: kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} "
        f"ms ({what})")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2)}


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


def check_index_cache(o, index, tag: str) -> None:
    """The index cache written by ``get_index`` memory-maps back equal."""
    import numpy as np
    from bsmap_tpu_torch.index import index_cache_key, load_index
    path = os.path.join(o.index_cache,
                        f"idx_{index_cache_key(o.ref_file, o.param)}.npz")
    mapped = load_index(path, mmap=True)
    if not (isinstance(mapped.locs, np.memmap)
            and np.array_equal(mapped.locs, index.locs)
            and np.array_equal(mapped.offsets, index.offsets)):
        raise AssertionError(f"{tag}: the memory-mapped index cache differs")


def phase_data(root: str, gen, tag: str, flags=ALIGN_FLAGS,
               phase: str = "2", **kw):
    """Generate one dataset, build its genome and index, and check that the
    index cache (``BSMAP_TPU_INDEX_CACHE``, which every CLI run below
    loads) memory-maps back equal."""
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.reference import load_genome
    d = os.path.join(root, tag)
    t0 = time.time()
    gpath, rpath = gen(d, **kw)
    t1 = time.time()
    o = parse_args(["-a", rpath, "-d", gpath, "-o", "x.sam"] + flags)
    genome = load_genome(gpath, o.param)
    index = get_index(o, genome)
    check_index_cache(o, index, tag)
    log(f"[{phase}] {tag}: data {t1 - t0:.1f} s, genome+index "
        f"{time.time() - t1:.1f} s ({genome.sum_length} bp, "
        f"{len(index.locs)} index entries; cache memory-maps)")
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
    errs = {k: 0 for k in SE_PATH}
    tabs = eng.tables
    for case, cfg, cands, rows in cases:
        if cfg.probe:
            got = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                   tabs["prof_a"], probe=True)
            want = K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                          tabs["prof_a"], probe=True)
            check(errs, "exact_schedule", case, [got.ftot_rank],
                  [want.ftot_rank])
            continue
        if cfg.fixed:
            slots = K.fixed_schedule(cfg, rows, tabs["kmer_tab"])
            want = K.fixed_schedule_plain(cfg, rows, tabs["kmer_tab"])
            check(errs, "fixed_schedule", case, slots, want)
        else:
            slots = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                     tabs["prof_a"])
            want = K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                          tabs["prof_a"])
            check(errs, "exact_schedule", case, slots, want)
        vc = K.verify_candidates(cfg, cands, rows, slots, tabs)
        check(errs, "verify_candidates", case, vc,
              K.verify_candidates_plain(cfg, cands, rows, slots, tabs))
        out = K.reduce_reads(cfg, cands, rows, vc, slots)
        check(errs, "reduce_reads", case, [out],
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
        res[name] = {"max_abs_err": errs[name]}
        if dev == "cuda":
            res[name].update(timed_pair(f"[3] {name}", kern, plain,
                                        f"{rows0.shape[0]} reads"))
    del eng, tabs, s_f, vc_f, rows0, rowsF
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_align(tag: str, gpath: str, rpath: str, out: str,
                n_reads: int, min_mapped: float, dev: str = "cuda",
                flags=ALIGN_FLAGS) -> dict:
    """One full CLI run on the card; checks the read count and the mapped
    share, prints reads/s and the engine counters."""
    st = run_cli(["-a", rpath, "-d", gpath, "-o", out, "--device", dev]
                 + flags)
    eng = st["engine"]
    if st["reads"] != n_reads:
        raise AssertionError(f"{tag}: aligned {st['reads']} of {n_reads}")
    with open(out, "rb") as f:
        lines = sum(1 for ln in f if not ln.startswith(b"@"))
    if not min_mapped * n_reads <= lines <= n_reads:
        raise AssertionError(f"{tag}: {lines} SAM records for {n_reads} "
                             f"fully converted reads (at least "
                             f"{min_mapped:.0%} expected)")
    rate = st["reads"] / st["align_s"]
    log(f"[{tag}] {st['reads']} reads in {st['align_s']:.3f} s = "
        f"{rate:.1f} reads/s; {lines} mapped; n_dispatched "
        f"{eng.n_dispatched}, n_probe {eng.n_probe}, n_replayed "
        f"{eng.n_replayed}, probe_mode {eng.probe_mode}")
    return {"reads_per_s": rate, "align_s": st["align_s"],
            "n_dispatched": eng.n_dispatched, "n_probe": eng.n_probe,
            "n_replayed": eng.n_replayed}


def assert_same_file(tag: str, got: str, want: str) -> int:
    """The GPU run's file byte-identical to the host engine's; returns its
    size."""
    with open(got, "rb") as f:
        a = f.read()
    with open(want, "rb") as f:
        b = f.read()
    if a != b:
        la, lb = a.splitlines(), b.splitlines()
        bad = next(i for i in range(min(len(la), len(lb)) + 1)
                   if i >= min(len(la), len(lb)) or la[i] != lb[i])
        raise AssertionError(f"{tag}: GPU output {os.path.basename(got)} "
                             f"differs from the host engine at line {bad}")
    return len(a)


def phase_parity(tag: str, gpath: str, rpath: str, d: str,
                 dev: str = "cuda", flags=ALIGN_FLAGS,
                 phase: str = "6") -> None:
    outs = []
    for eng in (["--device", dev], ["--engine", "host"]):
        outs.append(os.path.join(d, f"parity_{eng[1]}.sam"))
        run_cli(["-a", rpath, "-d", gpath, "-o", outs[-1], "-E",
                 str(N_PARITY)] + flags + eng)
    size = assert_same_file(tag, *outs)
    log(f"[{phase}] {tag}: first {N_PARITY} reads byte-identical to the "
        f"host engine ({size} bytes)")


def phase_pe_data(root: str):
    """Generate the pair-end dataset and build its genome and index."""
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.reference import load_genome
    from tools.genreads import generate_pe
    t0 = time.time()
    gpath, r1, r2 = generate_pe(os.path.join(root, "pe"))
    t1 = time.time()
    o = parse_args(["-a", r1, "-b", r2, "-d", gpath, "-o", "x.sam"]
                   + PE_FLAGS)
    genome = load_genome(gpath, o.param)
    index = get_index(o, genome)
    check_index_cache(o, index, "pe")
    log(f"[7] pe: data {t1 - t0:.1f} s, genome+index {time.time() - t1:.1f} "
        f"s ({genome.sum_length} bp, {len(index.locs)} index entries; "
        "cache memory-maps)")
    return gpath, r1, r2, o, genome, index


def phase_pe_kernels(o, genome, index, r1: str, r2: str,
                     dev: str = "cuda") -> dict:
    """The pair-end kernels against their twins on the first window:
    rc_words, both mates' K2/K3/K4 (cfg.pe, 16 hits) at rank 0 on the
    small tier and at full rank on both tiers, and pair_join.  Returns
    per-kernel {max_abs_err[, ms, plain_ms]} (times at the phase-1 shapes:
    rank 0, small tier; K2-K4 on mate 2, the rc chain)."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.pair_device import PairDeviceEngine

    eng = PairDeviceEngine(genome, index, o.param, device=dev)
    se = eng.se
    blks = []
    for readset, path in ((1, r1), (2, r2)):
        stream = BlockReadStream(path, o.param, readset=readset,
                                 lib=native.get_lib())
        blks.append(stream.next_block(se.B))
        stream.close()
    nw, _live, _pos, ra_np, rb_np = eng.block_pair_rows(*blks)
    cfg_a, cfg_b = eng._cfg(1, nw), eng._cfg(2, nw)
    tabs = se.tables
    MS = se._maxseg
    errs = {k: 0 for k in PE_PATH}

    def to_dev(rows_np, rank):
        r = rows_np.copy()
        r[:, -1] = rank
        return torch.from_numpy(r).to(dev)

    window = {}
    for rank, cands, case in ((0, se.CANDS, "rank 0, small tier"),
                              (MS - 1, se.CANDS, "full rank, small tier"),
                              (MS - 1, se.CANDS_BIG, "full rank, big tier")):
        da, db = to_dev(ra_np, rank), to_dev(rb_np, rank)
        rc = K.rc_words(cfg_b, db)
        check(errs, "rc_words", case, [rc], [K.rc_words_plain(cfg_b, db)])
        full, n_cand = [], []
        for cfg, rows in ((cfg_a, da), (cfg_b, rc)):
            slots = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                     tabs["prof_a"])
            check(errs, "exact_schedule", case, slots,
                  K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                         tabs["prof_a"]))
            vc = K.verify_candidates(cfg, cands, rows, slots, tabs)
            check(errs, "verify_candidates", case, vc,
                  K.verify_candidates_plain(cfg, cands, rows, slots, tabs))
            out = K.reduce_reads(cfg, cands, rows, vc, slots)
            check(errs, "reduce_reads", case, [out],
                  [K.reduce_reads_plain(cfg, cands, rows, vc, slots)])
            full.append(out)
            n_cand.append(int(vc.starts[-1]))
        j = K.pair_join(cfg_a, full[0], full[1], da, db)
        check(errs, "pair_join", case, [j],
              [K.pair_join_plain(cfg_a, full[0], full[1], da, db)])
        paired = int(((j[:, 6] & 31) > 0).sum())
        log(f"[8] {case}: {da.shape[0]} pairs, {n_cand[0]}/{n_cand[1]} "
            f"candidates (mate 1/2), {paired} paired — kernels == twins")
        window.setdefault("rows", (da, db, rc, full, cands))
    res = {k: {"max_abs_err": v} for k, v in errs.items()}
    if dev == "cuda":
        da, db, rc, full, cands = window["rows"]
        s_b = K.exact_schedule(cfg_b, rc, tabs["kmer_tab"], tabs["prof_a"])
        vc_b = K.verify_candidates(cfg_b, cands, rc, s_b, tabs)
        what = f"{da.shape[0]} pairs, mate 2, rank 0, small tier"
        timed = {
            "rc_words": (lambda: K.rc_words(cfg_b, db),
                         lambda: K.rc_words_plain(cfg_b, db)),
            "exact_schedule": (
                lambda: K.exact_schedule(cfg_b, rc, tabs["kmer_tab"],
                                         tabs["prof_a"]),
                lambda: K.exact_schedule_plain(cfg_b, rc, tabs["kmer_tab"],
                                               tabs["prof_a"])),
            "verify_candidates": (
                lambda: K.verify_candidates(cfg_b, cands, rc, s_b, tabs),
                lambda: K.verify_candidates_plain(cfg_b, cands, rc, s_b,
                                                  tabs)),
            "reduce_reads": (
                lambda: K.reduce_reads(cfg_b, cands, rc, vc_b, s_b),
                lambda: K.reduce_reads_plain(cfg_b, cands, rc, vc_b, s_b)),
            "pair_join": (
                lambda: K.pair_join(cfg_a, full[0], full[1], da, db),
                lambda: K.pair_join_plain(cfg_a, full[0], full[1], da, db)),
        }
        for name, (kern, plain) in timed.items():
            res[name].update(timed_pair(f"[8] {name}", kern, plain, what))
        del s_b, vc_b
    del eng, tabs, window
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_pe_align(gpath: str, r1: str, r2: str, out: str, n_pairs: int,
                   dev: str = "cuda") -> dict:
    """The pair-end CLI run on the card; checks the pair count and the
    properly-paired share, prints pairs/s and the engine counters."""
    st = run_cli(["-a", r1, "-b", r2, "-d", gpath, "-o", out, "--device",
                  dev] + PE_FLAGS)
    eng = st["engine"]
    if st["pairs"] != n_pairs:
        raise AssertionError(f"pe: aligned {st['pairs']} of {n_pairs} pairs")
    proper = 0
    with open(out, "rb") as f:
        for ln in f:
            if not ln.startswith(b"@") and int(ln.split(b"\t", 2)[1]) & 2:
                proper += 1
    proper //= 2                                  # two records per pair
    if proper < 0.9 * n_pairs:
        raise AssertionError(f"pe: {proper} of {n_pairs} fully converted, "
                             "error-free pairs properly paired")
    rate = st["pairs"] / st["align_s"]
    log(f"[9] {st['pairs']} pairs in {st['align_s']:.3f} s = {rate:.1f} "
        f"pairs/s; {proper} properly paired; n_dispatched "
        f"{eng.se.n_dispatched}, n_replayed {eng.n_replayed}")
    return {"pairs_per_s": rate, "align_s": st["align_s"],
            "n_dispatched": eng.se.n_dispatched,
            "n_replayed": eng.n_replayed}


def phase_pe_parity(gpath: str, r1: str, r2: str, d: str,
                    dev: str = "cuda") -> None:
    os.makedirs(d, exist_ok=True)
    outs = []
    for eng in (["--device", dev], ["--engine", "host"]):
        outs.append(os.path.join(d, f"pe_parity_{eng[1]}.sam"))
        run_cli(["-a", r1, "-b", r2, "-d", gpath, "-o", outs[-1], "-E",
                 str(N_PARITY)] + PE_FLAGS + eng)
    size = assert_same_file("pe", *outs)
    log(f"[10] pe: first {N_PARITY} pairs byte-identical to the host engine "
        f"({size} bytes)")


def phase_pe_paths(root: str, dev: str = "cuda") -> dict:
    """Phase 11: simulated pairs with errors through the block path and the
    per-pair path on ``dev``, each against the host engine byte for byte;
    returns the kernels' launch counts summed over the two GPU runs, each
    of which must have launched every pair-end kernel."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "pe_err")
    os.makedirs(d)
    g, r1, r2 = (os.path.join(d, x) for x in ("ref.fa", "r1.fq", "r2.fq"))
    t0 = time.time()
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "simulate.py"),
                    "--pe", "--n-reads", str(N_PARITY), "--read-len", "76",
                    "--n-chr", "2", "--chr-len", "1000000", "--error-rate",
                    "0.02", "--seed", "41", "--genome-out", g, "--reads-out",
                    r1, "--reads2-out", r2], check=True, timeout=600)
    for path in (r1, r2):                # every 8th pair to 51 nt
        with open(path) as f:
            lines = f.read().splitlines()
        for k in range(0, len(lines), 32):
            lines[k + 1], lines[k + 3] = lines[k + 1][:51], lines[k + 3][:51]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    log(f"[11] data: {N_PARITY} pairs of 76 nt (every 8th cut to 51 nt) "
        f"with 2% errors, 2 x 1 Mb genome, in {time.time() - t0:.1f} s")
    total = {k: 0 for k in K.launch_counts()}
    for tag, flags, (suffix, *unpaired), min_disp, min_rep in PE_PATH_RUNS:
        outs = {}
        for eng in (["--device", dev], ["--engine", "host"]):
            files = [os.path.join(d, f"{eng[1]}.{suffix}")]
            argv = ["-o", files[0]]
            if unpaired:
                files.append(os.path.join(d, f"{eng[1]}_unpaired.{suffix}"))
                argv += ["-2", files[1]]
            outs[eng[0]] = files
            if eng[0] == "--engine":
                run_cli(["-a", r1, "-b", r2, "-d", g] + flags + argv + eng)
                continue
            K.reset_launch_counts()
            st = run_cli(["-a", r1, "-b", r2, "-d", g] + flags + argv + eng)
            counts = K.launch_counts()
            missing = [k for k in PE_PATH if counts[k] == 0]
            if missing:
                raise AssertionError(f"{tag}: kernels never launched: "
                                     f"{missing}")
            for k, v in counts.items():
                total[k] += v
            engine = st["engine"]
            n_disp, n_rep = engine.se.n_dispatched, engine.n_replayed
            if n_disp < min_disp or n_rep < min_rep:
                raise AssertionError(f"{tag}: n_dispatched {n_disp}, "
                                     f"n_replayed {n_rep}: the path's "
                                     "corners did not run")
            t_gpu = st["align_s"]
        sizes = [assert_same_file(f"pe {tag}", a, b) for a, b in
                 zip(outs["--device"], outs["--engine"])]
        log(f"[11] {tag} ({' '.join(flags)}, {suffix}): {N_PARITY} pairs "
            f"in {t_gpu:.3f} s on {dev}; n_dispatched {n_disp}, n_replayed "
            f"{n_rep}; launches {counts}; byte-identical to the host engine "
            f"({' + '.join(map(str, sizes))} bytes)")
    return total


def phase_rrbs_kernels(o, genome, index, rpath: str,
                       dev: str = "cuda") -> dict:
    """Phase 13: K2, K3 and K4 with cfg.rrbs against their twins on the
    first window of the RRBS reads (native trimming, full rank, the one big
    capacity tier), lean and full rows; returns per-kernel
    {max_abs_err[, ms, plain_ms]} (times on the lean rows, the main path's
    SAM shapes)."""
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
    rows_np = rows_np.copy()
    rows_np[:, -1] = MS - 1
    rows = torch.from_numpy(rows_np).to(dev)
    cfg_lean = eng._cfg("f", lean=True, nw=nw)
    if not (cfg_lean.rrbs and eng.CANDS == eng.CANDS_BIG):
        raise AssertionError("RRBS engine without the rrbs cfg or the one "
                             "big capacity tier")
    tabs = eng.tables
    cands = eng.CANDS
    errs = {k: 0 for k in RRBS_PATH}

    def schedule(cfg, plain=False):
        fn = K.exact_schedule_plain if plain else K.exact_schedule
        return fn(cfg, rows, tabs["kmer_tab"], tabs["prof_a"],
                  tag_off=tabs["tag_off"])

    for case, cfg in (("lean, big tier", cfg_lean),
                      ("full, big tier", cfg_lean._replace(lean=False))):
        slots = schedule(cfg)
        check(errs, "exact_schedule", case, slots, schedule(cfg, True))
        vc = K.verify_candidates(cfg, cands, rows, slots, tabs)
        check(errs, "verify_candidates", case, vc,
              K.verify_candidates_plain(cfg, cands, rows, slots, tabs))
        out = K.reduce_reads(cfg, cands, rows, vc, slots)
        check(errs, "reduce_reads", case, [out],
              [K.reduce_reads_plain(cfg, cands, rows, vc, slots)])
        info = vc.info
        n_first = int(((info & K.INFO_FIRST) != 0).sum())
        n_frag = int(((info & K.INFO_FRAG) != 0).sum())
        found = int((out[:, 1] & 1).sum()) if cfg.lean else \
            int(out[:, 2 * MS].sum())
        log(f"[13] {case}: {rows.shape[0]} reads, {int(vc.starts[-1])} "
            f"candidates, {n_first} first of their key, {n_frag} inside a "
            f"valid fragment, {found} found — kernels == twins")
    res = {k: {"max_abs_err": v} for k, v in errs.items()}
    if dev == "cuda":
        s_l = schedule(cfg_lean)
        vc_l = K.verify_candidates(cfg_lean, cands, rows, s_l, tabs)
        timed = {
            "exact_schedule": (lambda: schedule(cfg_lean),
                               lambda: schedule(cfg_lean, True)),
            "verify_candidates": (
                lambda: K.verify_candidates(cfg_lean, cands, rows, s_l, tabs),
                lambda: K.verify_candidates_plain(cfg_lean, cands, rows, s_l,
                                                  tabs)),
            "reduce_reads": (
                lambda: K.reduce_reads(cfg_lean, cands, rows, vc_l, s_l),
                lambda: K.reduce_reads_plain(cfg_lean, cands, rows, vc_l,
                                             s_l)),
        }
        for name, (kern, plain) in timed.items():
            res[name].update(timed_pair(f"[13] {name}", kern, plain,
                                        f"{rows.shape[0]} RRBS reads, lean, "
                                        "big tier"))
        del s_l, vc_l
    del eng, tabs, rows
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_rrbs_set(root: str, dev: str = "cuda") -> dict:
    """Phase 15, second part: 10,000 mixed-strand reads with mismatches on a
    two-chromosome digest, SAM in a -m 100 -x 150 window and BSP, each on
    ``dev`` against the host engine byte for byte; returns the launch
    counts summed over the GPU runs, each of which must launch K2-K4 and
    never K1."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "rrbs_set")
    os.makedirs(d)
    t0 = time.time()
    make_rrbs_set(d, n_reads=N_PARITY, chr_len=300_000)
    log(f"[15] data: {N_PARITY} mixed-strand RRBS reads, 2 x 0.3 Mb "
        f"digest, in {time.time() - t0:.1f} s")
    total = {k: 0 for k in K.launch_counts()}
    for flags, suffix in RRBS_SET_RUNS:
        base = ["-a", os.path.join(d, "se.fq"), "-d",
                os.path.join(d, "rrbs.fa")] + flags
        outs = [os.path.join(d, f"{e}.{suffix}") for e in ("gpu", "host")]
        K.reset_launch_counts()
        st = run_cli(base + ["-o", outs[0], "--device", dev])
        counts = K.launch_counts()
        if [k for k in RRBS_PATH if counts[k] == 0] \
                or counts["fixed_schedule"]:
            raise AssertionError(f"RRBS set {flags}: launches {counts}")
        for k, v in counts.items():
            total[k] += v
        run_cli(base + ["-o", outs[1], "--engine", "host"])
        size = assert_same_file(f"rrbs set {suffix}", *outs)
        log(f"[15] {' '.join(flags)} ({suffix}): {N_PARITY} reads in "
            f"{st['align_s']:.3f} s on {dev}, n_replayed "
            f"{st['engine'].n_replayed}; launches {counts}; byte-identical "
            f"to the host engine ({size} bytes)")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bsmap_tpu_torch.engine import kernels as K
    from tools.genreads import generate, generate_chr21, generate_rrbs

    card = card_line()
    import numpy
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, numpy {numpy.__version__}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    phase_build()
    root = tempfile.mkdtemp(prefix="bsmap_smoke_")
    # every index below is built once and memory-mapped by each later run
    os.environ["BSMAP_TPU_INDEX_CACHE"] = os.path.join(root, "cache")
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
        se_counts = K.launch_counts()
        log(f"[4] launches, headline run: {counts4}")
        log(f"[5] launches, headline + repeat-heavy runs: {se_counts}")
        missing = [k for k in SE_PATH if se_counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the single-end "
                                 f"main path: {missing}")
        from bsmap_tpu_torch import native
        if native.get_lib() is None:
            raise AssertionError("native block path not taken")

        phase_parity("headline", g1, r1, os.path.join(root, "headline"))
        phase_parity("repeat", g2, r2, os.path.join(root, "repeat"))

        gp, p1, p2, op, genome, index = phase_pe_data(root)
        pres = phase_pe_kernels(op, genome, index, p1, p2)
        del genome, index
        K.reset_launch_counts()
        pe = phase_pe_align(gp, p1, p2, os.path.join(root, "pe.sam"),
                            N_PAIRS)
        pe_counts = K.launch_counts()
        log(f"[9] launches, pair-end run: {pe_counts}")
        missing = [k for k in PE_PATH if pe_counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the pair-end "
                                 f"main path: {missing}")
        phase_pe_parity(gp, p1, p2, os.path.join(root, "pe_parity"))
        path_counts = phase_pe_paths(root)

        gr, rr, orr, genome, index = phase_data(
            root, generate_rrbs, "rrbs", flags=RRBS_FLAGS, phase="12")
        rres = phase_rrbs_kernels(orr, genome, index, rr)
        del genome, index
        K.reset_launch_counts()
        rrbs = phase_align("14", gr, rr, os.path.join(root, "rrbs.sam"),
                           N_RRBS, 0.9, flags=RRBS_FLAGS)
        rrbs_counts = K.launch_counts()
        log(f"[14] launches, RRBS run: {rrbs_counts}")
        missing = [k for k in RRBS_PATH if rrbs_counts[k] == 0]
        if missing or rrbs_counts["fixed_schedule"]:
            raise AssertionError(f"RRBS main path: kernels never launched "
                                 f"{missing}, K1 launched "
                                 f"{rrbs_counts['fixed_schedule']} times")
        phase_parity("rrbs", gr, rr, os.path.join(root, "rrbs"),
                     flags=RRBS_FLAGS, phase="15")
        set_counts = phase_rrbs_set(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    log(f"[summary] headline {head['reads_per_s']:.1f} reads/s, "
        f"repeat-heavy {rep['reads_per_s']:.1f} reads/s, pair-end "
        f"{pe['pairs_per_s']:.1f} pairs/s, RRBS "
        f"{rrbs['reads_per_s']:.1f} reads/s")
    rows = []
    for k, (src, rep_) in KERNEL_SOURCES.items():
        se_r, pe_r, rr_r = kres.get(k, {}), pres.get(k, {}), rres.get(k, {})
        times = se_r if "ms" in se_r else pe_r     # the main path's shapes
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep_,
                     "launches": se_counts[k] + pe_counts[k]
                     + path_counts[k] + rrbs_counts[k] + set_counts[k],
                     "max_abs_err": max(r.get("max_abs_err", 0)
                                        for r in (se_r, pe_r, rr_r)),
                     "ms": times["ms"], "plain_ms": times["plain_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
