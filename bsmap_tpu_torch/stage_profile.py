#!/usr/bin/env python3
"""Stage breakdown of the PyTorch port's block paths on one GPU.

    python3 -m bsmap_tpu_torch.stage_profile [--reads N]
                                             [--repeat | --pe | --rrbs]
                                             [--chains] [--bsp]
                                             [--engine index-sharded
                                              [--shards D]]
    python3 -m bsmap_tpu_torch.stage_profile [--rrbs] --launch N1,N2,...
    python3 -m bsmap_tpu_torch.stage_profile --pe --filtered S1,S2,...

Generates the headline data (2 x 5 Mb genome, fully converted 100 nt reads,
tools/genreads.generate), with --repeat the chr21-class data (46.7 Mb, 8%
repeats), with --pe the pair-end data (4.6 Mb, 76 nt pairs,
tools/genreads.generate_pe; N is then the pair count), or with --rrbs
BASELINE config 3 (10 Mb, 200,000 MspI-fragment 76 nt reads,
tools/genreads.generate_rrbs).  It aligns at -v 2 -S 17 (SE), -S 17 (PE)
or -D C-CGG -A AGATCGGAAGAGC -q 2 -S 17 (RRBS) and times each stage on its
own.  With --chains it aligns with -n 1 (all four strands) on the
non-directional copies of chip_smoke.py's phases 16-19: every second read
reverse-complemented (SE, RRBS), every second pair's mates swapped (PE).
With --pe it profiles SAM on the pe_76nt pairs and then BSP with -2, -R
and trimming (-A AGATCGGAAGAGC -q 2) on as many pairs of chip_smoke.py's
phase 29 set (inserts of 28-500, the mates of short ones read into the
adapter, low-quality tails on some mates), and times the whole CLI at -p 1
for SAM, BSP, -R, trimming, and BSP with -R and trimming, each on the
block path (the single-device engine) and on the per-pair path
(``--engine sharded`` on one card, the first quarter of the pairs).
With --pe --filtered it runs, in place of the above, BSP with -2, -R and
trimming on the block path at -p 1 and -p 8 on a phase 29 set made for
each share S of pairs with a filtered mate (each mate filtered at
1 - sqrt(1 - S)): pairs/s, replays, filtered-mate pairs and the seconds
the host engine spends on them (``PairDeviceEngine.t_host``), so that the
cost of that route is measured at shares the synthetic set does not
have.
With --bsp the single-end stages write BSP with -u (full result rows, the
native BSP formatter, the stale hits[0][0] slot carried through each block)
in place of SAM.
With --engine index-sharded (SE WGBS only) the stages run on
``IndexShardedEngine`` over D region shards (--shards, default 4),
round-robin over the visible cards, and then once more on the
single-device engine in the same process, for the comparison; the JSON
line then holds both, each with K7's share of the kernel time.

  parse    native parse of every block (``BlockReadStream.next_block``,
           one thread: the CLI's reader thread)
  encode   native filter (trimming under --rrbs and PE BSP) + encode of
           every block (``encode_block``, ``encode_block_pair``, one
           thread; the CLI runs it on -p threads)
  align    SE: DeviceEngine.align_block + finish (rounds 1 and 2,
           collection, host replays); PE: PairDeviceEngine.align_block_pair
           + collect (phase 1, phase 2, J rows, replay flags); with the
           seconds of the engine's dispatch / h2d / launch / collect spans
           (``obs``: t_enqueue, t_h2d, t_call, t_collect)
  kernels  CUDA kernel time inside a second align pass (torch.profiler),
           and the device's idle share of that pass's wall time
  format   native SAM (BSP) formatting (ZP/ZL tags under --rrbs) + file
           write of the aligned blocks (PE: emit_block, which also runs
           the exact host replays and the pairs with a filtered mate)
  pipeline the whole CLI (cli.run: the stages overlapped in threads) at
           -p 1, and again at -p 8 (eight encode threads)

With --launch it times, in place of the stages, whole CLI runs from
launch to the finished file, each a process of its own, at -p 8 with
trimming (-A AGATCGGAAGAGC -q 2; the headline reads with -v 2 -S 17, or
--rrbs): as one process with eight encode threads (BSMAP_TPU_LOCAL_MP=0)
and as eight worker processes over read ranges (``cli._wants_local_mp``
forced true), on the first N1, N2, ... reads of one generated file (the
largest first, in the order workers, one, one, workers; each other
count workers, one).  Both ways must write the same bytes.

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

from . import obs

# align_timers_s's keys and the engine spans each sums
ALIGN_TIMERS = {"t_h2d": "engine.h2d", "t_call": "engine.launch",
                "t_collect": "engine.collect", "t_enqueue": "engine.dispatch"}

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


SE_FLAGS = ["-v", "2", "-S", "17"]
RRBS_FLAGS = ["-D", "C-CGG", "-A", "AGATCGGAAGAGC", "-q", "2", "-S", "17"]


def _se_stages(root: str, gpath: str, rpath: str, dev: str = "cuda",
               align_flags=SE_FLAGS, mesh=None, bsp: bool = False):
    """The SE engine's stages over the headline, chr21-class or RRBS
    blocks; on ``IndexShardedEngine`` over ``mesh`` when one is given;
    with ``bsp``, BSP output (full result rows, ``_format_block_full``).
    (``dev`` = "cpu" rehearses them with the kernels' twins.)"""
    import torch
    from . import cli, native
    from .blockio import BlockReadStream
    from .engine.device_engine import DeviceEngine
    from .output.sam import SamFormatter
    from .parallel import IndexShardedEngine
    from .utils import RandR

    flags = ["-a", rpath, "-d", gpath] + align_flags
    o = cli.parse_args(flags + ["-o", os.path.join(
        root, "x.bsp" if bsp else "x.sam")])
    p = o.param
    p.out_sam = int(not bsp)
    genome = cli.load_genome(gpath, p)
    index = cli.get_index(o, genome)
    eng = (DeviceEngine(genome, index, p, device=dev) if mesh is None
           else IndexShardedEngine(genome, index, p, mesh=mesh))
    t0 = time.perf_counter()
    stream = BlockReadStream(rpath, p, readset=0, lib=native.get_lib())
    blocks = []
    while (blk := stream.next_block(8 * eng.B)) is not None:
        blocks.append(blk)
    stream.close()
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    for blk in blocks:
        eng.encode_block(blk)
    t_encode = time.perf_counter() - t0

    def align_all():
        out = []
        for blk in blocks:
            live_pos, fin, buds = eng.align_block(blk)
            res = fin()
            out.append((blk, (live_pos, lambda r=res: r, buds)))
        if dev == "cuda":
            torch.cuda.synchronize()
        return out

    def fmt_all(aligned, path):
        fmt = SamFormatter(genome, p, RandR(1))
        with open(path, "wb") as f:
            for blk, al in aligned:
                f.write(eng.format_aligned_block(blk, al, fmt))

    return flags, eng, eng, (t_parse, t_encode), align_all, fmt_all


def _pe_stages(root: str, gpath: str, r1: str, r2: str, dev: str = "cuda",
               extra=(), suffix: str = "sam"):
    """The PE engine's stages over the pe_76nt block pairs, SAM or (with
    ``suffix`` "bsp") BSP with -2."""
    import torch
    from . import cli, native
    from .blockio import BlockReadStream
    from .engine.pair_device import PairDeviceEngine
    from .engine.pair_pipeline import PE_BLOCK_WINDOWS
    from .output.pair_sam import PairFormatter
    from .utils import RandR

    flags = ["-a", r1, "-b", r2, "-d", gpath, "-S", "17"] + list(extra)
    o = cli.parse_args(flags + ["-o", os.path.join(root, "x.sam")])
    p = o.param
    p.out_sam = int(suffix == "sam")
    genome = cli.load_genome(gpath, p)
    index = cli.get_index(o, genome)
    eng = PairDeviceEngine(genome, index, p, device=dev)
    if not eng.supports_pair_blocks():      # builds the native formatter
        raise RuntimeError("the pair-end block path is not available")
    lib = native.get_lib()
    t0 = time.perf_counter()
    sa = BlockReadStream(r1, p, readset=1, lib=lib)
    sb = BlockReadStream(r2, p, readset=2, lib=lib)
    blocks = []
    while (ba := sa.next_block(PE_BLOCK_WINDOWS * eng.se.B)) is not None:
        blocks.append((ba, sb.next_block(len(ba))))
    sa.close()
    sb.close()
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ba, bb in blocks:
        eng.encode_block_pair(ba, bb)
    t_encode = time.perf_counter() - t0

    def align_all():
        out = [eng.align_block_pair(ba, bb)() for ba, bb in blocks]
        if dev == "cuda":
            torch.cuda.synchronize()
        return out

    def fmt_all(aligned, path):
        fmt = PairFormatter(genome, p, RandR(1))
        with open(path, "wb") as f, open(path + ".u", "wb") as fu:
            for al in aligned:
                main, unpair = eng.emit_block(fmt, al)
                f.write(main)
                fu.write(unpair)

    return flags, eng, eng.se, (t_parse, t_encode), align_all, fmt_all


def _profile(root: str, stages, unit: str, n: int, mesh=None) -> dict:
    """Time the stages of one engine (``stages`` = _se_stages' or
    _pe_stages' result) and whole CLI runs of the same flags at -p 1 and
    -p 8 (on ``mesh``'s index-sharded engine when given); returns the JSON
    fields."""
    import torch
    from . import cli
    flags, eng, se, (t_parse, t_encode), align_all, fmt_all = stages

    align_all()                                  # warm-up pass
    se.n_dispatched = eng.n_replayed = se.n_probe = 0
    obs.start()
    t0 = time.perf_counter()
    try:
        aligned = align_all()
    finally:
        t_align = time.perf_counter() - t0
        sums = obs.totals(obs.stop())
    timers = {k: sums.get(name, (0, 0.0))[1]
              for k, name in ALIGN_TIMERS.items()}
    # SE replays run in align, PE replays in format (emit_block), where
    # the pairs with a filtered mate run too
    counts = {"n_dispatched": se.n_dispatched, "n_probe": se.n_probe,
              "n_replayed": eng.n_replayed}
    outs = ["-o", os.path.join(root, "run.sam")]
    if not eng.param.out_sam:
        outs = ["-o", os.path.join(root, "run.bsp")] + (
            ["-2", os.path.join(root, "run_u.bsp")] if unit == "pairs"
            else [])

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        align_all()
        t_prof = time.perf_counter() - t0
    kms = _kernel_ms(prof)
    k_total = sum(kms.values())

    r0 = eng.n_replayed
    t0 = time.perf_counter()
    fmt_all(aligned, os.path.join(root, "fmt.sam"))
    t_fmt = time.perf_counter() - t0
    counts["n_replayed"] += eng.n_replayed - r0
    if hasattr(eng, "n_mate_filtered"):
        counts["n_mate_filtered"] = eng.n_mate_filtered
    del eng, se, aligned, align_all, fmt_all, stages
    torch.cuda.empty_cache()

    # -p 1: the stages as timed above, one encode thread; again at -p 8,
    # the default: one process, eight encode threads
    extra = [] if mesh is None else ["--engine", "index-sharded"]
    pipe = {}
    for n_p in (1, 8):
        st: dict = {}
        rc = cli.run(flags + outs + ["--device", "cuda", "-p", str(n_p)]
                     + extra, stats=st, mesh=mesh)
        if rc != 0:
            raise RuntimeError(f"cli.run returned {rc}")
        pipe[n_p] = st
    st = pipe[1]
    k7 = sum(v for k, v in kms.items() if "merge_shards" in k)
    return {
        "parse_s": t_parse, "encode_s": t_encode, "align_s": t_align,
        "format_s": t_fmt,
        "align_timers_s": timers, "engine_counts": counts,
        "profiled_align_s": t_prof, "kernel_ms_total": k_total,
        "device_idle_share": 1.0 - k_total / 1000.0 / t_prof,
        "kernel_ms": dict(sorted(kms.items(), key=lambda kv: -kv[1])[:12]),
        "k7_ms": k7, "k7_share": k7 / k_total if k_total else 0.0,
        "pipeline_align_s": st["align_s"],
        f"pipeline_{unit}_per_s": st[unit] / st["align_s"],
        f"pipeline_p8_{unit}_per_s": pipe[8][unit] / pipe[8]["align_s"],
        "engine": st["engine_name"],
    }


TRIM_FLAGS = ["-A", "AGATCGGAAGAGC", "-q", "2"]
# --pe: (name, flags, output suffix, on the trimmed set): each runs the
# whole CLI on both pair-end paths; "sam" and "bsp_trim" also by stage
PE_RUNS = (("sam", [], "sam", False), ("bsp", [], "bsp", False),
           ("xr", ["-R"], "sam", False), ("trim", TRIM_FLAGS, "sam", True),
           ("bsp_trim", ["-R"] + TRIM_FLAGS, "bsp", True))


def _pe_paths(root: str, gpath: str, sets: dict, n: int, extra=()) -> dict:
    """Pairs/s of the whole CLI at -p 1 for each of ``PE_RUNS``: on the
    block path (the single-device engine) over all ``n`` pairs, and on the
    per-pair path (``--engine sharded``, one card) over the first n/4,
    with each run's replays and pairs with a filtered mate."""
    from . import cli
    out = {}
    for name, flags, suffix, trimmed in PE_RUNS:
        r1, r2 = sets[trimmed]
        argv = (["-a", r1, "-b", r2, "-d", gpath, "-S", "17"] + flags
                + list(extra) + ["-o", os.path.join(root, f"p.{suffix}"),
                                 "--device", "cuda", "-p", "1"])
        if suffix == "bsp":
            argv += ["-2", os.path.join(root, "p_u.bsp")]
        out[name] = {}
        for path, more, pairs in (("blocks", [], n),
                                  ("pairs", ["--engine", "sharded", "-E",
                                             str(n // 4)], n // 4)):
            st: dict = {}
            if cli.run(argv + more, stats=st) != 0 or st["pairs"] != pairs \
                    or st["pe_path"] != path:
                raise RuntimeError(f"{name}: {st.get('pairs')} pairs on "
                                   f"the {st.get('pe_path')} path")
            eng = st["engine"]
            out[name][path] = {
                "pairs": pairs, "align_s": st["align_s"],
                "pairs_per_s": pairs / st["align_s"],
                "n_replayed": eng.n_replayed,
                "n_mate_filtered": eng.n_mate_filtered}
        print(json.dumps({name: out[name]}), flush=True)
    return out
def _filtered_sweep(root: str, gpath: str, n: int, shares: list[float],
                    extra=(), dev: str = "cuda") -> list[dict]:
    """--filtered: one row a share and -p (module docstring)."""
    from chip_smoke import make_trim_pe_set
    from . import cli
    rows = []
    for share in shares:
        r1, r2 = make_trim_pe_set(os.path.join(root, f"filt{share:g}"), n,
                                  filtered=1 - (1 - share) ** 0.5)
        for procs in (1, 8):
            argv = (["-a", r1, "-b", r2, "-d", gpath, "-S", "17", "-R"]
                    + TRIM_FLAGS + list(extra)
                    + ["-o", os.path.join(root, "f.bsp"), "-2",
                       os.path.join(root, "f_u.bsp"), "--device", dev,
                       "-p", str(procs)])
            st: dict = {}
            if cli.run(argv, stats=st) != 0 or st["pairs"] != n \
                    or st["pe_path"] != "blocks":
                raise RuntimeError(f"filtered {share}: {st.get('pairs')} "
                                   f"pairs on the {st.get('pe_path')} path")
            eng = st["engine"]
            n_host = eng.n_replayed + eng.n_mate_filtered
            rows.append({
                "share": share, "procs": procs, "pairs": n,
                "align_s": st["align_s"], "pairs_per_s": n / st["align_s"],
                "n_replayed": eng.n_replayed,
                "n_mate_filtered": eng.n_mate_filtered,
                "host_s": eng.t_host,
                "host_ms_per_pair": 1e3 * eng.t_host / max(n_host, 1)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


# a CLI process that starts -p workers wherever the run allows them
WORKERS = ("import sys; from bsmap_tpu_torch import cli; "
           "cli._wants_local_mp = lambda o, genome: True; "
           "sys.exit(cli.run(sys.argv[1:]))")


def _head_fastq(src: str, dst: str, n: int) -> None:
    """The first ``n`` records of FASTQ ``src`` into ``dst``."""
    import itertools
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        fo.writelines(itertools.islice(fi, 4 * n))


def _launch(root: str, gpath: str, rpath: str, flags: list[str],
            sizes: list[int], procs: int = 8,
            device: str = "cuda") -> list[dict]:
    """Launch-to-file seconds of the CLI at ``-p procs`` as one process
    and as ``procs`` workers (module docstring), one row a run; raises
    when the two ways' outputs differ."""
    import hashlib
    rows = []
    env = dict(os.environ, PYTHONPATH=REPO)
    for i, n in enumerate(sorted(sizes, reverse=True)):
        path = os.path.join(root, f"head_{n}.fq")
        _head_fastq(rpath, path, n)
        digests = set()
        for mode in (("workers", "one", "one", "workers") if i == 0
                     else ("workers", "one")):
            out = os.path.join(root, "launch.sam")
            cmd = ([sys.executable, "-m", "bsmap_tpu_torch.cli"]
                   if mode == "one" else [sys.executable, "-c", WORKERS])
            cmd += ["-a", path, "-d", gpath, "-o", out, "-p", str(procs),
                    "--device", device] + flags
            run_env = dict(env)
            if mode == "one":
                run_env["BSMAP_TPU_LOCAL_MP"] = "0"
            else:
                run_env.pop("BSMAP_TPU_LOCAL_MP", None)
            t0 = time.perf_counter()
            r = subprocess.run(cmd, env=run_env, cwd=root, text=True,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.PIPE)
            dt = time.perf_counter() - t0
            if r.returncode:
                raise RuntimeError(f"{mode} at {n} reads: rc "
                                   f"{r.returncode}\n{r.stderr[-2000:]}")
            h = hashlib.sha1()
            with open(out, "rb") as f:
                while chunk := f.read(1 << 24):
                    h.update(chunk)
            size = os.path.getsize(out)
            os.remove(out)
            digests.add(h.hexdigest())
            rows.append({"reads": n, "mode": mode, "s": dt,
                         "reads_per_s": n / dt, "out_bytes": size,
                         "stderr": [ln for ln in r.stderr.splitlines()
                                    if ln.startswith(("-p ", "engine:"))]})
            print(json.dumps(rows[-1]), flush=True)
        if len(digests) != 1:
            raise RuntimeError(f"{n} reads: the outputs differ")
        os.remove(path)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stage_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=None,
                    help="reads (SE, default 1,000,000) or pairs (--pe, "
                    "default 200,000)")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--repeat", action="store_true")
    kind.add_argument("--pe", action="store_true")
    kind.add_argument("--rrbs", action="store_true")
    ap.add_argument("--chains", action="store_true",
                    help="-n 1 on non-directional data")
    ap.add_argument("--engine", choices=("device", "index-sharded"),
                    default="device",
                    help="index-sharded: SE WGBS on D region shards, then "
                    "the single-device engine beside it")
    ap.add_argument("--shards", type=int, default=4,
                    help="region shards of --engine index-sharded, round "
                    "robin over the visible cards (default 4)")
    ap.add_argument("--launch", default=None,
                    help="comma-separated read counts: launch-to-file "
                    "times at -p 8 with trimming, one process against "
                    "workers (module docstring)")
    ap.add_argument("--bsp", action="store_true",
                    help="single-end BSP output with -u (full result rows "
                    "and the BSP formatter) in place of SAM")
    ap.add_argument("--filtered", default=None,
                    help="with --pe: comma-separated shares of pairs with a "
                    "filtered mate, for the trimmed BSP sweep alone "
                    "(module docstring)")
    args = ap.parse_args()
    if args.filtered and not args.pe:
        ap.error("--filtered goes with --pe")
    if args.bsp and (args.pe or args.launch):
        ap.error("--bsp profiles the single-end stages (--pe profiles "
                 "BSP with -2 already)")
    sharded = args.engine == "index-sharded"
    if sharded and (args.pe or args.rrbs):
        ap.error("--engine index-sharded profiles SE WGBS (headline or "
                 "--repeat)")
    from chip_smoke import make_trim_pe_set, nondirectional, swap_mates
    from tools.genreads import (generate, generate_chr21, generate_pe,
                                generate_rrbs)
    from .engine import _build

    sizes = [int(x) for x in args.launch.split(",")] if args.launch else []
    if sizes and (args.pe or args.repeat or args.chains or sharded):
        ap.error("--launch runs the headline or --rrbs reads on one card")
    n = max(sizes) if sizes else args.reads or (
        200_000 if args.pe or args.rrbs else 1_000_000)
    unit = "pairs" if args.pe else "reads"
    _build.lib()
    root = tempfile.mkdtemp(prefix="bsmap_prof_")
    try:
        n1 = ["-n", "1"] if args.chains else []
        if sizes:
            gpath, rpath = (generate_rrbs if args.rrbs else generate)(
                root, n_reads=n)
            res = {"launch": _launch(
                root, gpath, rpath, RRBS_FLAGS if args.rrbs
                else SE_FLAGS + TRIM_FLAGS, sizes)}
        elif args.filtered:
            gpath, _r1, _r2 = generate_pe(root, n_pairs=n)
            res = {"filtered": _filtered_sweep(
                root, gpath, n, [float(x) for x in args.filtered.split(",")],
                n1)}
        elif args.pe:
            gpath, r1, r2 = generate_pe(root, n_pairs=n)
            sets = {False: (r1, r2), True: make_trim_pe_set(
                os.path.join(root, "trim"), n)}
            if args.chains:
                sets = {k: swap_mates(
                    a, b, os.path.join(root, f"sw{k:d}_1.fq"),
                    os.path.join(root, f"sw{k:d}_2.fq"))
                    for k, (a, b) in sets.items()}
            res = {"sam": _profile(root, _pe_stages(
                root, gpath, *sets[False], extra=n1), unit, n)}
            res["bsp_trim"] = _profile(root, _pe_stages(
                root, gpath, *sets[True], extra=n1 + ["-R"] + TRIM_FLAGS,
                suffix="bsp"), unit, n)
            res["paths"] = _pe_paths(root, gpath, sets, n, n1)
        else:
            if args.rrbs:
                gpath, rpath = generate_rrbs(root, n_reads=n)
            else:
                gen = generate_chr21 if args.repeat else generate
                gpath, rpath = gen(root, n_reads=n)
            if args.chains:
                rpath = nondirectional(rpath, os.path.join(root, "nd.fq"))
            flags = ((RRBS_FLAGS if args.rrbs else SE_FLAGS) + n1
                     + (["-u"] if args.bsp else []))
            meshes = [None]
            if sharded:
                ncard = torch.cuda.device_count()
                meshes = [[torch.device("cuda", k % ncard)
                           for k in range(args.shards)], None]
            res = {}
            for mesh in meshes:
                name = "device" if mesh is None else "index-sharded"
                res[name] = _profile(root, _se_stages(
                    root, gpath, rpath, align_flags=flags, mesh=mesh,
                    bsp=args.bsp), unit, n, mesh)
                if mesh is not None:
                    res[name]["shards"] = args.shards
                    res[name]["mesh"] = sorted(set(map(str, mesh)))
            if not sharded:
                res = res["device"]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    res = {"data": ("pe_76nt_trim (synthetic)" if args.filtered
                    else "pe_76nt" if args.pe
                    else "rrbs_mspi_trim" if args.rrbs
                    else "chr21_class" if args.repeat else "headline"
                    + (" with -A/-q trimming" if sizes else ""))
           + (", -n 1 non-directional" if args.chains else "")
           + (", BSP -u" if args.bsp else ""), unit: n,
           **res}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
