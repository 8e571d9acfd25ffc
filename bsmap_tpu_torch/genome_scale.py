"""The port at human-genome scale: BASELINE config 5 and the headline on a
synthetic hg38-class genome, on one card.

    python3 -m bsmap_tpu_torch.genome_scale                    # the card
    python3 -m bsmap_tpu_torch.genome_scale --device cpu --n-chr 2 \\
        --chr-len 1050000 --se-reads 3000 --pe-pairs 1500 --parity 500 \\
        --sharded-reads 1000 --workers-reads 1000 --procs 2 -s 12  # twins

The genome is ``tools/hg38_scale.py``'s: 13 chromosomes of 239,999,970
uniform random bases from seed 38 (3.12 Gb; no repeats, no N runs), written
by this module's own copy of ``gen_genome`` byte for byte.  The steps, in
order (``--steps`` picks some; the genome and the index always come first,
from the caches a step before left in ``--dir``):

  genome   the FASTA, once behind a stamp file; ``load_genome_cached``
  index    the native two-pass build, ``save_index`` into the index cache
           the CLI reads, and a ``load_index(mmap=True)`` round trip
  tables   ``DeviceEngine``'s tables on the device (the strand split chunk
           by chunk): each table's bytes, host RSS, card memory
  se       the headline config at scale: ``--se-reads`` fully converted
           100 nt reads (tools/genreads.make_reads' draws, seed 1), -v 2
           -S 17, SAM, through the CLI on the device engine; reads/s, the
           engine's dispatches, probe passes and host replays, candidates
           a read, the device's idle share over an align pass of the first
           100,000 reads (torch.profiler, CUDA time over wall time); reads
           past coordinate 2^31 at their true place on each strand (500 at
           least); the first ``--parity`` reads byte-identical to
           ``--engine host``
  pe       config 5: ``--pe-pairs`` 100 nt pairs
           (tools/genreads.make_pe_reads(38, ...)), -S 17 -v 2 -u on the
           device engine's block path, then ``methratio -u -p -q`` on the
           SAM; the first ``--parity`` pairs byte-identical to
           ``--engine host``
  sharded  the index-sharded engine at D = 2 and 4 region shards on
           one device (the mesh list repeats it) over the first
           ``--sharded-reads`` SE reads; card memory and reads/s, output
           byte-identical to the se step's; K7 on the first window (round
           1's shapes) against its twin, its card time and bound, and its
           launches in the run
  workers  ``--nprocs 2`` over the first ``--workers-reads`` SE reads:
           each process's card and host memory, launch to merged file,
           and from them how many workers one card and the host hold;
           those reads with trimming at ``-p --procs`` and as many pe pairs
           as BSP with -2 at ``-p --procs``: on the card each one process
           with -p encode threads (the block paths; its host peak, card
           memory and rate), under ``--device cpu`` the CLI's workers
           (each one's private and shared host memory from
           /proc/<pid>/smaps, the cached genome and index it maps), each
           byte-identical to its -p 1 run

Prints the card's name and power limit, then one JSON line with every
number, each step's under its name with that card line beside it.  Runs
on the card unless ``--device cpu`` is given; raises when a check fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the directory that holds the package: the methratio and worker
# processes run from it
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_CHR = 13                      # the hg38-class genome (--n-chr, --chr-len)
CHR_LEN = 239_999_970
HIGH = 1 << 31                  # the coordinate past which int32 wraps
SE_FLAGS = ["-v", "2", "-S", "17"]
SE_TRIM = ["-A", "AGATCGGAAGAGC", "-q", "2"]     # the workers step's trimming
PE_FLAGS = ["-S", "17", "-v", "2", "-u"]
STEPS = ("genome", "index", "tables", "se", "pe", "sharded", "workers")
MIN_HIGH = 500                  # reads past 2^31 on each strand, at least
PROFILE_READS = 100_000         # the idle share's align pass
SHARDS = (2, 4)                 # the sharded step's region shards

# a CLI run in a process of its own: its card memory and stats go to the
# JSON file named by the first argument
WORKER = """
import json, sys
import torch
from bsmap_tpu_torch import cli
stats = {}
rc = cli.run(sys.argv[2:], stats=stats)
rec = {"rc": rc, "align_s": stats.get("align_s"), "reads": stats.get("reads"),
       "pairs": stats.get("pairs"), "pe_path": stats.get("pe_path")}
if torch.cuda.is_initialized():
    rec["max_allocated"] = torch.cuda.max_memory_allocated()
    rec["max_reserved"] = torch.cuda.max_memory_reserved()
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
sys.exit(rc)
"""


COMP = np.zeros(256, dtype=np.uint8)       # a base's complement
COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def gen_genome(path: str, n_chr: int, chr_len: int) -> None:
    """``n_chr`` chromosomes of ``chr_len`` uniform random bases from seed
    38, 70 bases a line (tools/hg38_scale.py's genome at its N_CHR and
    CHR_LEN, the same bytes)."""
    rng = np.random.RandomState(38)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    assert chr_len % 70 == 0
    with open(path, "wb") as f:
        for c in range(n_chr):
            f.write(b">chr%d\n" % (c + 1))
            for off in range(0, chr_len, 70_000_000):
                n = min(70_000_000, chr_len - off)
                chunk = bases[rng.randint(0, 4, size=n).astype(np.uint8)]
                arr = chunk.reshape(-1, 70)
                lines = np.empty((arr.shape[0], 71), np.uint8)
                lines[:, :70] = arr
                lines[:, 70] = 10
                f.write(lines.tobytes())


def chr_arrays(path: str, n_chr: int, chr_len: int) -> list:
    """The chromosomes of ``gen_genome``'s FASTA as uint8 base arrays (its
    fixed layout: a header line, then lines of 70 bases)."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out, at = [], 0
    for c in range(n_chr):
        at += len(b">chr%d\n" % (c + 1))
        n = chr_len // 70 * 71
        out.append(np.ascontiguousarray(
            mm[at: at + n].reshape(-1, 71)[:, :70]).reshape(-1))
        at += n
    return out


def draw_se_reads(seed: int, chrs, n: int, read_len: int):
    """tools/genreads.make_reads' reads (the same draws, the same bytes)
    with where each came from: (reads, chromosome, position, crick)."""
    rng = np.random.RandomState(seed + 1)
    ci = rng.randint(0, len(chrs), size=n)
    pos = np.zeros(n, dtype=np.int64)
    out = np.empty((n, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    for c, seq in enumerate(chrs):
        sel = np.where(ci == c)[0]
        pos[sel] = rng.randint(0, len(seq) - read_len, size=len(sel))
        out[sel] = seq[pos[sel][:, None] + offs[None, :]]
    crick = rng.random_sample(n) < 0.5
    out[crick] = COMP[out[crick]][:, ::-1]
    out[out == ord("C")] = ord("T")
    return out, ci, pos, crick


def make_pe_reads(seed: int, chrs, n_pairs: int, read_len: int,
                  ins_min: int = 100, ins_max: int = 400):
    """tools/genreads.make_pe_reads' pairs (the same draws, the same
    bytes): mate 1 the fragment's start C->T, mate 2 its end reverse
    complemented and G->A, half the fragments on the Crick strand."""
    rng = np.random.RandomState(seed + 2)
    ci = rng.randint(0, len(chrs), size=n_pairs)
    ins = rng.randint(ins_min, ins_max + 1, size=n_pairs)
    r1 = np.empty((n_pairs, read_len), dtype=np.uint8)
    r2 = np.empty((n_pairs, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    for c, chrseq in enumerate(chrs):
        sel = np.where(ci == c)[0]
        pos = rng.randint(0, len(chrseq) - ins_max - 1, size=len(sel))
        insc = ins[sel]
        w1 = chrseq[pos[:, None] + offs[None, :]]
        w2 = COMP[chrseq[(pos + insc)[:, None] - 1 - offs[None, :]]]
        flip = rng.random_sample(len(sel)) < 0.5
        a = np.where(flip[:, None], w2, w1)     # sequenced mate 1
        b = np.where(flip[:, None], w1, w2)     # sequenced mate 2
        r1[sel] = np.where(a == ord("C"), ord("T"), a)
        r2[sel] = np.where(b == ord("G"), ord("A"), b)
    return r1, r2


def write_fastq(path: str, reads: np.ndarray) -> None:
    """Reads named r0, r1, ... with quality I (tools/genreads.py's)."""
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as f:
        buf = []
        for i in range(reads.shape[0]):
            buf.append(b"@r%d\n%s\n+\n%s\n" % (i, reads[i].tobytes(), qual))
            if len(buf) >= 10000:
                f.write(b"".join(buf))
                buf.clear()
        f.write(b"".join(buf))


def card_line(device: str) -> str:
    """nvidia-smi's name and power limit of the card (``cpu`` on the CPU)."""
    if device == "cpu":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def smaps(pid: int, under: str = "") -> dict | None:
    """Resident host memory of process ``pid`` from /proc/<pid>/smaps, GB:
    ``rss``, ``private`` (Private_Clean + Private_Dirty), ``shared``
    (Shared_Clean + Shared_Dirty), ``anonymous``, and with ``under`` the
    resident pages of files mapped from that directory (``mapped``) and
    their names (``files``).  None once the process is gone."""
    tot = dict.fromkeys(("Rss", "Private_Clean", "Private_Dirty",
                         "Shared_Clean", "Shared_Dirty", "Anonymous"), 0)
    mapped, files, name = 0, set(), ""
    try:
        with open(f"/proc/{pid}/smaps") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in tot:
                    kb = int(rest.split()[0])
                    tot[key] += kb
                    if key == "Rss" and name:
                        mapped += kb
                elif " " in key:             # a mapping's header line
                    path = (line.split(None, 5) + [""] * 6)[5].strip()
                    name = path if under and path.startswith(under) else ""
                    if name:
                        files.add(os.path.basename(name))
    except (OSError, ValueError, IndexError):
        return None
    return {"rss": tot["Rss"] / 1e6,
            "private": (tot["Private_Clean"] + tot["Private_Dirty"]) / 1e6,
            "shared": (tot["Shared_Clean"] + tot["Shared_Dirty"]) / 1e6,
            "anonymous": tot["Anonymous"] / 1e6, "mapped": mapped / 1e6,
            "files": sorted(files)}


def descendants(pids) -> list:
    """Every live process below ``pids`` (from each /proc/<pid>/stat's
    parent field)."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                pass
    out, todo = [], list(pids)
    while todo:
        pid = todo.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        out += kids
        todo += kids
    return out


def host_used_gb() -> float:
    """The host's memory in use: MemTotal - MemAvailable, GB."""
    m = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            m[k] = int(v.split()[0])
    return (m["MemTotal"] - m["MemAvailable"]) * 1024 / 1e9


class RssPeak:
    """Peak host memory while entered, from /proc/<pid>/smaps every 0.25 s
    in a thread: per process of ``pids`` (default this process) and, with
    ``tree``, of every process they start, the peak of each of ``smaps``'
    numbers (``peak[pid]`` the resident total; pages of files mapped from
    ``under`` counted apart), and the host's peak memory in use
    (``host_used``).  (ru_maxrss will not do: a child keeps its forking
    parent's peak across the exec, and it never falls back for a step;
    statm's shared count reads 0 on some kernels.)"""

    def __init__(self, pids=None, tree: bool = False, under: str = ""):
        self.pids = list(pids) if pids is not None else [os.getpid()]
        self.tree, self.under = tree, under
        self.seen: dict = {}                 # pid -> {number: peak}
        self.host_used = 0.0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    @property
    def peak(self) -> dict:
        return {pid: r["rss"] for pid, r in self.seen.items()}

    @property
    def private(self) -> dict:
        return {pid: r["private"] for pid, r in self.seen.items()}

    def sample(self) -> None:
        self.host_used = max(self.host_used, host_used_gb())
        pids = self.pids + (descendants(self.pids) if self.tree else [])
        for pid in pids:
            r = smaps(pid, self.under)
            if r is None:
                continue
            old = self.seen.setdefault(pid, {"files": []})
            for k, v in r.items():
                old[k] = (sorted(set(old[k]) | set(v)) if k == "files"
                          else max(old.get(k, 0.0), v))

    def _run(self) -> None:
        while not self.stop.wait(0.25):
            self.sample()

    def __enter__(self):
        self.sample()
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.thread.join()
        self.sample()

    def gb(self, pid: int | None = None):
        """The peak of ``pid`` (default the first), None if not read."""
        return self.peak.get(self.pids[0] if pid is None else pid)


def host_ram_gb() -> float:
    with open("/proc/meminfo") as f:
        return int(f.readline().split()[1]) * 1024 / 1e9


def records_before(path: str, n: int) -> bytes:
    """The header and the records of reads (pairs) r0 .. r{n-1} of a SAM
    file whose reads are named r<index> and written in order."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b"@"):
                if int(line[1: line.index(b"\t")]) >= n:
                    break
            out.append(line)
    return b"".join(out)


def same_bytes(what: str, got: bytes, want: bytes) -> int:
    if got != want:
        a, b = got.splitlines(), want.splitlines()
        bad = next(i for i in range(min(len(a), len(b)) + 1)
                   if i >= min(len(a), len(b)) or a[i] != b[i])
        raise AssertionError(f"{what}: differs at line {bad}")
    return len(got)


class Scale:
    """One run's paths, flags and device; ``cli(argv)`` runs the CLI in
    this process and returns its stats."""

    def __init__(self, a):
        self.a = a
        self.dir = a.dir
        self.cache = os.path.join(a.dir, "cache")
        self.gpath = os.path.join(a.dir, "genome_hg38s.fa")
        self.dev = a.device
        self.card = card_line(a.device)
        self.seed_flags = ["-s", str(a.seed_size)]
        os.makedirs(self.cache, exist_ok=True)

    def argv(self, *args, procs: int = 1) -> list:
        return (list(args) + ["-d", self.gpath, "--index-cache", self.cache,
                              "--device", self.dev, "-p", str(procs)]
                + self.seed_flags)

    def param(self, flags):
        from .cli import parse_args
        return parse_args(["-a", "x", "-d", self.gpath, "-o", "x.sam"]
                          + self.seed_flags + list(flags)).param

    def cli(self, argv, mesh=None) -> dict:
        import contextlib
        import io
        from . import cli
        stats: dict = {}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.run(argv, stats=stats, mesh=mesh)
        if rc != 0:
            raise RuntimeError(f"cli.run returned {rc}:\n{buf.getvalue()}")
        return stats

    def sync(self) -> None:
        if self.dev == "cuda":
            import torch
            torch.cuda.synchronize()

    def card_peak(self, reset: bool = False) -> int | None:
        """Peak bytes allocated on the card (since the last reset)."""
        if self.dev != "cuda":
            return None
        import torch
        if reset:
            gc.collect()                # engines of earlier runs
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return None
        return torch.cuda.max_memory_allocated()


def step_genome(s: Scale) -> tuple:
    """The FASTA (once, behind a stamp) and the packed genome through its
    cache.  Returns (genome, record)."""
    from .reference import load_genome_cached
    n_chr, chr_len = s.a.n_chr, s.a.chr_len
    rec = {"genome_bp": n_chr * chr_len, "n_chr": n_chr, "chr_len": chr_len}
    stamp = s.gpath + f".{n_chr}x{chr_len}.ok"
    if not os.path.exists(stamp):
        t0 = time.perf_counter()
        gen_genome(s.gpath, n_chr, chr_len)
        rec["fasta_s"] = time.perf_counter() - t0
        open(stamp, "w").close()
    t0 = time.perf_counter()
    with RssPeak() as r:
        genome = load_genome_cached(s.gpath, s.param(SE_FLAGS), s.cache)
    rec["load_s"] = time.perf_counter() - t0
    rec["peak_rss_gb"] = r.gb()
    rec["strand_top"] = int(genome.anchors[-1])
    rec["catcat_bytes"] = int(genome.refcat.nbytes + genome.crefcat.nbytes)
    return genome, rec


def index_path(s: Scale, flags) -> str:
    from .index import index_cache_key
    return os.path.join(s.cache,
                        f"idx_{index_cache_key(s.gpath, s.param(flags))}.npz")


def step_index(s: Scale, genome) -> tuple:
    """The native two-pass build, ``save_index`` where the CLI's
    ``--index-cache`` finds it, and the memory-mapped round trip; returns
    (the memory-mapped index, record)."""
    from . import native
    from .index import build_index, load_index, save_index
    path = index_path(s, SE_FLAGS)
    rec = {}
    if not os.path.exists(path):
        if native.get_lib() is None:
            raise RuntimeError("the native library did not build")
        t0 = time.perf_counter()
        with RssPeak() as r:
            built = build_index(genome, s.param(SE_FLAGS))
        rec["build_s"] = time.perf_counter() - t0
        rec["build_peak_rss_gb"] = r.gb()
        t0 = time.perf_counter()
        save_index(path + ".tmp.npz", built)
        os.replace(path + ".tmp.npz", path)
        rec["save_s"] = time.perf_counter() - t0
    else:
        built = None
    t0 = time.perf_counter()
    index = load_index(path, mmap=True)
    rec["mmap_load_s"] = time.perf_counter() - t0
    if built is not None:
        if not (np.array_equal(index.offsets, built.offsets)
                and np.array_equal(index.locs, built.locs)
                and np.array_equal(index.wcounts, built.wcounts)):
            raise AssertionError("the memory-mapped index differs")
        del built
    nw = int(np.asarray(index.wcounts, dtype=np.int64).sum())
    rec.update(entries=int(len(index.locs)), watson_entries=nw,
               crick_entries=int(len(index.locs)) - nw,
               entries_per_bucket=len(index.locs) / index.total_kmers,
               bytes=int(index.locs.nbytes + index.offsets.nbytes
                         + index.wcounts.nbytes),
               max_loc=int(index.locs.max()) if len(index.locs) else 0)
    # the WGBS index does not depend on -b: the pair-end runs (whose cache
    # key holds the pair-end flag) map this same file
    pe_path = index_path(s, ["-b", "x"] + PE_FLAGS)
    if not os.path.exists(pe_path):
        os.link(path, pe_path)
    return index, rec


def step_tables(s: Scale, genome, index) -> tuple:
    """``DeviceEngine``'s tables on the device; returns (engine, record)."""
    from .engine.device_engine import DeviceEngine
    rec = {}
    if s.dev == "cuda":
        import torch
        torch.cuda.init()
        free, total = torch.cuda.mem_get_info()
        rec["card_bytes"] = total
        # what the card holds beyond this process's caching allocator: its
        # CUDA context
        rec["context_bytes"] = total - free - torch.cuda.memory_reserved()
        s.card_peak(reset=True)
    t0 = time.perf_counter()
    with RssPeak() as r:
        eng = DeviceEngine(genome, index, s.param(SE_FLAGS), device=s.dev)
        s.sync()
    rec["engine_s"] = time.perf_counter() - t0
    rec["table_bytes"] = {k: v.numel() * v.element_size()
                          for k, v in eng.tables.items()}
    rec["tables_total_bytes"] = sum(rec["table_bytes"].values())
    rec["peak_rss_gb"] = r.gb()
    rec["peak_private_gb"] = r.private.get(os.getpid())
    rec["card_max_allocated"] = s.card_peak()
    return eng, rec


def se_reads(s: Scale, chrs) -> tuple:
    """The se step's reads (written once) and where they came from."""
    n = s.a.se_reads
    path = os.path.join(s.dir, f"se_{n}.fq")
    truth = path + ".truth.npz"
    if not os.path.exists(truth):
        reads, ci, pos, crick = draw_se_reads(1, chrs, n, 100)
        write_fastq(path, reads)
        np.savez(truth, ci=ci, pos=pos, crick=crick)
    z = np.load(truth)
    return path, z["ci"], z["pos"], z["crick"]


def placed_high(sam: str, genome, ci, pos, crick) -> dict:
    """Reads whose origin lies past 2^31 on its strand (anchor + position),
    per strand: how many, and how many the SAM holds at their true
    chromosome, position and strand."""
    names = {n.encode(): k for k, n in enumerate(genome.names)}
    anchors = genome.anchors[: genome.n_chr].astype(np.int64)
    high = anchors[ci] + pos >= HIGH
    at_truth = np.zeros(len(ci), dtype=bool)
    with open(sam, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            q, flag, rname, p = line.split(b"\t", 4)[:4]
            i = int(q[1:])
            if (names.get(rname) == ci[i] and int(p) == pos[i] + 1
                    and bool(int(flag) & 16) == bool(crick[i])):
                at_truth[i] = True
    out = {}
    for strand, m in (("watson", high & ~crick), ("crick", high & crick)):
        out[strand] = {"reads_past_2_31": int(m.sum()),
                       "at_true_place": int((m & at_truth).sum())}
    out["all_at_true_place"] = int(at_truth.sum())
    return out


def idle_share(s: Scale, eng, path: str, n: int) -> dict:
    """The device's idle share of an align pass over the first ``n`` reads
    of ``path`` on ``eng`` (after one warm-up pass): 1 - the CUDA time the
    profiler records over the pass's wall time, as ``stage_profile``."""
    import copy
    import torch
    from . import native
    from .blockio import BlockReadStream
    p = copy.copy(eng.param)
    p.read_end = n
    stream = BlockReadStream(path, p, readset=0, lib=native.get_lib())
    blocks = []
    while (blk := stream.next_block(8 * eng.B)) is not None:
        eng.encode_block(blk)
        blocks.append(blk)
    stream.close()

    def align_all():
        for blk in blocks:
            eng.align_block(blk)[1]()
        s.sync()

    align_all()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        align_all()
        wall = time.perf_counter() - t0
    busy = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t and ev.device_type.name == "CUDA":
            busy += t / 1e6
    return {"reads": n, "align_pass_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if wall else None}


def engine_counts(eng) -> dict:
    return {"n_dispatched": eng.n_dispatched, "n_probe": eng.n_probe,
            "n_replayed": eng.n_replayed, "probe_mode": eng.probe_mode,
            "cands_mean": eng.cand_sum / max(eng.cand_reads, 1),
            "cands_max": eng.cand_max}


def step_se(s: Scale, genome, chrs) -> dict:
    """The headline config at scale through the CLI: its rate and engine
    counters, the reads past 2^31, parity with the host engine."""
    a = s.a
    path, ci, pos, crick = se_reads(s, chrs)
    rec = {"reads": a.se_reads}
    s.card_peak(reset=True)
    sam = os.path.join(s.dir, "se.sam")
    with RssPeak() as r:
        st = s.cli(s.argv("-a", path, "-o", sam, "--engine", "device")
                   + SE_FLAGS)
    rec.update(align_s=st["align_s"], reads_per_s=st["reads"] / st["align_s"],
               engine=st["engine_name"], **engine_counts(st.pop("engine")),
               peak_rss_gb=r.gb(), card_max_allocated=s.card_peak())
    if st["reads"] != a.se_reads:
        raise AssertionError(f"se: {st['reads']} of {a.se_reads} reads")
    rec["high"] = placed_high(sam, genome, ci, pos, crick)
    need = MIN_HIGH if int(genome.anchors[-1]) > HIGH else 0
    for strand in ("watson", "crick"):
        if rec["high"][strand]["at_true_place"] < need:
            raise AssertionError(f"se: {rec['high'][strand]} reads past 2^31 "
                                 f"on the {strand} strand (need {need})")
    host = os.path.join(s.dir, "se_host.sam")
    t0 = time.perf_counter()
    s.cli(s.argv("-a", path, "-o", host, "--engine", "host", "-E",
                 str(a.parity)) + SE_FLAGS)
    rec["parity_host_s"] = time.perf_counter() - t0
    with open(host, "rb") as f:
        rec["parity_bytes"] = same_bytes(
            f"se: the first {a.parity} reads against --engine host",
            records_before(sam, a.parity), f.read())
    rec["parity_reads"] = a.parity
    return rec


def pe_reads(s: Scale, chrs, n: int) -> tuple:
    r1 = os.path.join(s.dir, f"pe_{n}_1.fq")
    r2 = os.path.join(s.dir, f"pe_{n}_2.fq")
    if not os.path.exists(r1 + ".ok"):
        a, b = make_pe_reads(38, chrs, n, 100)
        write_fastq(r1, a)
        write_fastq(r2, b)
        open(r1 + ".ok", "w").close()
    return r1, r2


def step_pe(s: Scale, chrs, methratio: bool = True) -> dict:
    """BASELINE config 5: the pairs through the device engine's block path,
    the first pairs against the host engine, then methratio on the SAM."""
    a = s.a
    n = a.pe_pairs
    rec = {"pairs": n}
    t0 = time.perf_counter()
    r1, r2 = pe_reads(s, chrs, n)
    rec["reads_s"] = time.perf_counter() - t0
    sam = os.path.join(s.dir, "pe.sam")
    s.card_peak(reset=True)
    t0 = time.perf_counter()
    with RssPeak() as rp:
        st = s.cli(s.argv("-a", r1, "-b", r2, "-o", sam, "--engine",
                          "device") + PE_FLAGS)
    rec["run_s"] = time.perf_counter() - t0
    eng = st.pop("engine")
    se = getattr(eng, "se", eng)
    rec.update(align_s=st["align_s"], pairs_per_s=st["pairs"] / st["align_s"],
               engine=st["engine_name"], n_dispatched=se.n_dispatched,
               n_replayed=eng.n_replayed, peak_rss_gb=rp.gb(),
               card_max_allocated=s.card_peak(),
               sam_bytes=os.path.getsize(sam))
    del eng, se
    if st["pairs"] != n:
        raise AssertionError(f"pe: {st['pairs']} of {n} pairs")
    host = os.path.join(s.dir, "pe_host.sam")
    t0 = time.perf_counter()
    s.cli(s.argv("-a", r1, "-b", r2, "-o", host, "--engine", "host", "-E",
                 str(a.parity)) + PE_FLAGS)
    rec["parity_host_s"] = time.perf_counter() - t0
    with open(host, "rb") as f:
        rec["parity_bytes"] = same_bytes(
            f"pe: the first {a.parity} pairs against --engine host",
            records_before(sam, a.parity), f.read())
    rec["parity_pairs"] = a.parity
    if methratio:
        meth = os.path.join(s.dir, "pe.meth")
        t0 = time.perf_counter()
        q = subprocess.Popen(
            [sys.executable, "-m", "bsmap_tpu_torch.methratio", "-d",
             s.gpath, "-o", meth, "-u", "-p", "-q", sam], cwd=REPO,
            stdout=subprocess.PIPE, text=True, env=dict(
                os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", "")))
        with RssPeak([q.pid]) as r:
            out = q.communicate()[0]
        if q.returncode:
            raise RuntimeError(f"methratio exited {q.returncode}")
        with open(meth, "rb") as f:
            lines = sum(1 for _ in f)
        # its summary: the valid mappings and the cytosines they cover
        # (without -z the table leaves out sites whose ratio is 0)
        rec["methratio"] = {
            "wall_s": time.perf_counter() - t0, "ratio_lines": lines,
            "summary": (out.strip().splitlines() or [""])[-1],
            "peak_rss_gb": r.gb()}
    return rec


def step_sharded(s: Scale) -> dict:
    """``--engine index-sharded`` at each D of ``--shards`` on one device
    over the first SE reads, byte-identical to the se step's output."""
    import torch
    a = s.a
    n = a.sharded_reads
    path = os.path.join(s.dir, f"se_{a.se_reads}.fq")
    want = records_before(os.path.join(s.dir, "se.sam"), n)
    from .engine import kernels as K
    rec = {"reads": n}
    for D in SHARDS:
        out = os.path.join(s.dir, f"se_is{D}.sam")
        s.card_peak(reset=True)
        t0 = time.perf_counter()
        K.reset_launch_counts()
        with RssPeak() as rp:
            st = s.cli(s.argv("-a", path, "-o", out, "--engine",
                              "index-sharded", "-E", str(n)) + SE_FLAGS,
                       mesh=[torch.device(s.dev)] * D)
        launches = K.launch_counts()["merge_shards"]
        eng = st.pop("engine")
        r = {"run_s": time.perf_counter() - t0, "align_s": st["align_s"],
             "reads_per_s": st["reads"] / st["align_s"],
             "card_max_allocated": s.card_peak(), "peak_rss_gb": rp.gb(),
             **engine_counts(eng),
             "k7": {**k7_window(s, eng, path), "launches": launches}}
        del eng
        with open(out, "rb") as f:
            r["bytes"] = same_bytes(f"index-sharded D = {D} against the se "
                                    "step", f.read(), want)
        rec[f"D{D}"] = r
    return rec


def k7_window(s: Scale, eng, path: str) -> dict:
    """K7 ``merge_shards`` on the first window of ``path``'s reads at round
    1's shapes (rank 0, the small tier; K1 and K3 on every shard before
    it), as PERF.md section 6 times it: equal to its twin, the card's time
    for a call (``queued_ms``), the wrapper's event time and the twin's,
    and the bound (bytes over the memory rate: one sector of each row,
    every shard's slot starts and totals, the output, 12 bytes a live
    candidate)."""
    import torch
    from . import native
    from .blockio import BlockReadStream
    from .engine import kernels as K
    stream = BlockReadStream(path, eng.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    c = eng._cfg("f", nw=nw)._replace(fixed=True)
    cands = eng.CANDS
    rows = torch.from_numpy(rows_np).to(eng.shard_tables[0]["kmer_tab"].device)
    vcs, slots = [], []
    for d, tabs in enumerate(eng.shard_tables):
        slots.append(K.fixed_schedule(c, rows, tabs["kmer_tab"]))
        vcs.append(K.verify_candidates(c, cands, rows, slots[-1], tabs,
                                       None, d))
    def kern():
        return K.merge_shards(c, cands, rows, vcs, slots)

    def plain():
        return K.merge_shards_plain(c, cands, rows, vcs, slots)

    if not torch.equal(kern(), plain()):
        raise AssertionError("K7 differs from its twin on the first window")
    live = sum(min(int(v.starts[-1]), cands) for v in vcs)
    rec = {"reads": int(rows.shape[0]), "live_candidates": live,
           "capacity_per_shard": cands, "max_abs_err": 0}
    if s.dev == "cuda":
        from . import measure as sm
        rec.update(sm.bound("merge_shards", c, rec["reads"], live, cands),
                   card_ms=sm.queued_ms(kern), event_ms=sm.cuda_ms(kern),
                   plain_ms=sm.cuda_ms(plain))
    return rec


def watched(s: Scale, argv: list, tag: str) -> dict:
    """The CLI on ``argv`` in a process of its own (``WORKER``), with
    ``measure``'s LAUNCH_DUMP on its path: its seconds from launch to
    exit, its own record (card memory, stats), the record of every worker
    process it starts (launches, card memory), the host memory of it and
    of every process below it (pages of the cache files apart), and
    nvidia-smi's peak of processes and MiB on the card."""
    import signal
    from . import measure as sm
    s.card_peak(reset=True)         # what this process keeps on the card
    env = sm.launch_dump_env(os.path.join(s.dir, f"dump_{tag}"))
    me = os.path.join(s.dir, f"{tag}.json")
    err = os.path.join(s.dir, f"{tag}.err")
    t0 = time.perf_counter()
    with open(err, "wb") as f:
        q = subprocess.Popen([sys.executable, "-c", WORKER, me] + argv,
                             cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                             stderr=f, start_new_session=True)
    try:
        with RssPeak([q.pid], tree=True, under=s.cache) as host, \
                sm.CardMemory(s.dev == "cuda") as card:
            q.wait()
    finally:
        if q.poll() is None:
            os.killpg(q.pid, signal.SIGKILL)
            q.wait()
    with open(err, "rb") as f:
        stderr = f.read().decode("latin1")
    if q.returncode:
        raise RuntimeError(f"{tag}: the CLI exited {q.returncode}:\n"
                           + stderr[-4000:])
    with open(me) as f:
        top = json.load(f)
    return {"wall_s": time.perf_counter() - t0, "top": top, "host": host,
            "workers": sm.launch_dumps(os.path.join(s.dir, f"dump_{tag}")),
            "card": dict(card.peak), "pid": q.pid, "stderr": stderr}


def worker_memory(s: Scale, w: dict, ctx: dict) -> list:
    """Each worker process's card memory (the caching allocator's peak
    reserve, and that plus a CUDA context) and host memory (peak resident,
    private and shared pages, anonymous pages, pages of the cache files
    and which files it maps) from ``watched``'s record."""
    out = []
    for r in sorted(w["workers"], key=lambda r: int(
            r["argv"][r["argv"].index("--proc-id") + 1])):
        h = w["host"].seen.get(r["pid"], {})
        rec = {"proc_id": int(r["argv"][r["argv"].index("--proc-id") + 1]),
               **{f"{k}_gb": h.get(k) for k in (
                   "rss", "private", "shared", "anonymous", "mapped")},
               "mapped_files": h.get("files", []),
               "launches": {k: v for k, v in r["launches"].items() if v}}
        if s.dev == "cuda":
            rec.update(max_allocated=r["max_allocated"],
                       max_reserved=r["max_reserved"],
                       card_bytes=r["max_reserved"] + ctx["context_bytes"])
        out.append(rec)
    return out


def step_workers(s: Scale, ctx: dict) -> dict:
    """Three multi-process runs, each byte-identical to its one-process
    run: ``--nprocs 2`` over the first ``--workers-reads`` SE reads (each
    process's card and host memory, launch to merged file, and the
    workers one card and this host hold at that footprint); those reads
    with trimming (-A, -q 2) at ``-p --procs``; and as many of the pe
    step's pairs as pair-end BSP with -2 at ``-p --procs``.  The CLI runs
    both as one process on the card (the block paths), and as its own
    worker processes under ``--device cpu`` (each one's private and
    shared host memory, its pages of the memory-mapped genome and index,
    and the host's peak in use)."""
    s.card_peak(reset=True)         # what this process keeps on the card
    gc.collect()
    rec = nprocs_two(s, ctx)
    print(f"# workers nprocs2: {json.dumps(rec)}", file=sys.stderr,
          flush=True)
    for name, run in (("pe_bsp", pe_bsp_procs), ("se_trim", se_trim_procs)):
        rec[name] = run(s, ctx)
        print(f"# workers {name}: {json.dumps(rec[name])}", file=sys.stderr,
              flush=True)
    return rec


def nprocs_two(s: Scale, ctx: dict) -> dict:
    a = s.a
    n, k = a.workers_reads, 2
    path = os.path.join(s.dir, f"se_{a.se_reads}.fq")
    out = os.path.join(s.dir, "se_np2.sam")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    dumps = [os.path.join(s.dir, f"worker{i}.json") for i in range(k)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, dumps[i]]
        + s.argv("-a", path, "-o", out, "--engine", "device", "-E", str(n),
                 "--nprocs", str(k), "--proc-id", str(i)) + SE_FLAGS,
        cwd=REPO, env=env, stdout=subprocess.DEVNULL)
        for i in reversed(range(k))]
    try:
        with RssPeak([q.pid for q in procs], under=s.cache) as host:
            for q in procs:
                q.wait()
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait()
    wall = time.perf_counter() - t0
    if any(q.returncode for q in procs):
        raise RuntimeError(f"workers: exit codes "
                           f"{[q.returncode for q in procs]}")
    with open(out, "rb") as f:
        nbytes = same_bytes("--nprocs 2 against the se step", f.read(),
                            records_before(os.path.join(s.dir, "se.sam"), n))
    recs = []
    for p, q in zip(dumps, reversed(procs)):
        with open(p) as f:
            h = host.seen.get(q.pid, {})
            recs.append({**json.load(f), "peak_rss_gb": h.get("rss"),
                         "peak_private_gb": h.get("private"),
                         "peak_shared_gb": h.get("shared"),
                         "mapped_gb": h.get("mapped")})
    rec = {"reads": n, "processes": k, "launch_to_merged_s": wall,
           "bytes": nbytes, "per_process": recs,
           "host_ram_gb": host_ram_gb()}
    # the mapped genome and index pages are shared through the page cache:
    # each further worker adds its private memory
    peak = max(r["peak_rss_gb"] for r in recs)
    private = max(r["peak_private_gb"] for r in recs)
    rec["host_workers"] = int((rec["host_ram_gb"] - (peak - private))
                              // private)
    if s.dev == "cuda":
        per = max(r["max_reserved"] for r in recs) + ctx["context_bytes"]
        rec["card_bytes_per_process"] = per
        rec["card_workers"] = int(ctx["card_bytes"] // per)
        rec["p8_fits_card"] = 8 * per <= ctx["card_bytes"]
    rec["p8_fits_host"] = rec["host_workers"] >= 8
    return rec


def se_trim_procs(s: Scale, ctx: dict) -> dict:
    """The first ``--workers-reads`` SE reads with trimming at ``-p
    --procs`` (the CLI's default engine and rule): on the card one process
    with no worker below it and one process's card memory, under ``--device
    cpu`` the CLI's workers; byte-identical to the same run at -p 1."""
    a = s.a
    n, k = a.workers_reads, a.procs
    path = os.path.join(s.dir, f"se_{a.se_reads}.fq")
    flags = SE_FLAGS + SE_TRIM + ["-E", str(n)]
    out = os.path.join(s.dir, "se_trim_p.sam")
    w = watched(s, s.argv("-a", path, "-o", out, procs=k) + flags,
                "se_trim")
    one = os.path.join(s.dir, "se_trim_p1.sam")
    st = s.cli(s.argv("-a", path, "-o", one) + flags)
    with open(out, "rb") as f, open(one, "rb") as g:
        nbytes = same_bytes(f"SE trimming -p {k} against -p 1", f.read(),
                            g.read())
    procs = 1 + len(w["workers"])
    rec = {"reads": n, "procs": k, "processes": procs,
           "launch_to_exit_s": w["wall_s"], "bytes": nbytes,
           "one_process_align_s": st["align_s"],
           "one_process_reads_per_s": st["reads"] / st["align_s"],
           "host_peak_rss_gb": w["host"].seen[w["pid"]]["rss"],
           "nvidia_smi_peak": w["card"]}
    if s.dev == "cuda":
        rec.update(max_allocated=w["top"]["max_allocated"],
                   max_reserved=w["top"]["max_reserved"],
                   card_bytes=w["top"]["max_reserved"]
                   + ctx["context_bytes"])
        if procs != 1:
            raise AssertionError(f"SE trimming -p {k} on the card started "
                                 f"{procs - 1} workers")
    elif procs != 1 + k:
        raise AssertionError(f"SE trimming -p {k} on the CPU ran {procs} "
                             "processes")
    return rec


def pe_bsp_procs(s: Scale, ctx: dict) -> dict:
    """The first ``--workers-reads`` of the pe step's pairs as pair-end BSP
    with -2 at ``-p --procs`` (the CLI's default engine and rule): on the
    card one process on the block path with no worker below it, its host
    peak, card memory and pairs/s; under ``--device cpu`` the CLI's
    workers, each one's host memory and the cache files it maps, and the
    host's peak in use.  Both files byte-identical to the run at -p 1."""
    a = s.a
    n, k = a.workers_reads, a.procs
    r1 = os.path.join(s.dir, f"pe_{a.pe_pairs}_1.fq")
    chrs = (None if os.path.exists(r1 + ".ok")
            else chr_arrays(s.gpath, a.n_chr, a.chr_len))
    r1, r2 = pe_reads(s, chrs, a.pe_pairs)
    del chrs
    flags = PE_FLAGS + ["-E", str(n)]
    out, up = (os.path.join(s.dir, f"pe_bsp_p{x}.bsp") for x in ("", "_u"))
    base = host_used_gb()
    w = watched(s, s.argv("-a", r1, "-b", r2, "-o", out, "-2", up, procs=k)
                + flags, "pe_bsp")
    one, one_up = (os.path.join(s.dir, f"pe_bsp_p1{x}.bsp")
                   for x in ("", "_u"))
    t0 = time.perf_counter()
    st = s.cli(s.argv("-a", r1, "-b", r2, "-o", one, "-2", one_up) + flags)
    one_s = time.perf_counter() - t0
    nbytes = 0
    for got, want in ((out, one), (up, one_up)):
        with open(got, "rb") as f, open(want, "rb") as g:
            nbytes += same_bytes(f"PE BSP -p {k} against -p 1 "
                                 f"({os.path.basename(got)})", f.read(),
                                 g.read())
    per = worker_memory(s, w, ctx)
    top = w["host"].seen.get(w["pid"], {})
    rec = {"pairs": n, "procs": k, "workers": len(per),
           "cli_rss_gb": top.get("rss"), "cli_mapped_gb": top.get("mapped"),
           "cli_mapped_files": top.get("files"),
           "launch_to_merged_s": w["wall_s"], "bytes": nbytes,
           "one_process_s": one_s,
           "one_process_pairs_per_s": st["pairs"] / st["align_s"],
           "per_worker": per, "host_ram_gb": host_ram_gb(),
           "host_used_before_gb": base,
           "host_used_peak_gb": w["host"].host_used,
           "nvidia_smi_peak": w["card"]}
    if rec["host_used_peak_gb"] > rec["host_ram_gb"]:
        raise AssertionError("PE BSP held more than the host")
    if s.dev == "cuda":
        # the block path: one process with -p encode threads
        if per or w["top"]["pe_path"] != "blocks":
            raise AssertionError(f"PE BSP -p {k} on the card: "
                                 f"{len(per)} workers, path "
                                 f"{w['top']['pe_path']}")
        rec.update(pairs_per_s=w["top"]["pairs"] / w["top"]["align_s"],
                   max_allocated=w["top"]["max_allocated"],
                   max_reserved=w["top"]["max_reserved"],
                   card_bytes=w["top"]["max_reserved"]
                   + ctx["context_bytes"])
        return rec
    # the CLI's cap names the count it starts on a stderr line (at one,
    # the run stays in its own process)
    cap = re.search(r"-p \d+: (?:(\d+) worker processes|this process "
                    r"alone), .*", w["stderr"])
    want = int(cap.group(1) or 0) if cap else k
    if len(per) != want:
        raise AssertionError(f"PE BSP -p {k}: {len(per)} worker records; "
                             f"{cap.group(0) if cap else 'no cap'}")
    for r in per:
        kinds = {f.split("_", 1)[0] for f in r["mapped_files"]}
        if not {"gen", "idx"} <= kinds:
            raise AssertionError(f"PE BSP worker {r['proc_id']} maps "
                                 f"{r['mapped_files']}: not the cached "
                                 "genome and index")
    rec.update(cap=cap.group(0) if cap else None,
               private_sum_gb=sum(r["private_gb"] or 0 for r in per),
               anonymous_sum_gb=sum(r["anonymous_gb"] or 0 for r in per))
    return rec


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m bsmap_tpu_torch.genome_scale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "bsmap_tpu_torch_hg38"))
    ap.add_argument("--n-chr", type=int, default=N_CHR)
    ap.add_argument("--chr-len", type=int, default=CHR_LEN)
    ap.add_argument("-s", "--seed-size", type=int, default=16)
    ap.add_argument("--steps", default=",".join(STEPS))
    ap.add_argument("--se-reads", type=int, default=1_000_000)
    ap.add_argument("--pe-pairs", type=int, default=2_000_000)
    ap.add_argument("--parity", type=int, default=2000)
    ap.add_argument("--no-methratio", action="store_true")
    ap.add_argument("--sharded-reads", type=int, default=100_000)
    ap.add_argument("--workers-reads", type=int, default=200_000)
    ap.add_argument("--procs", type=int, default=8,
                    help="-p of the workers step's SE trimming and PE BSP "
                    "runs")
    a = ap.parse_args(argv)
    a.steps = [x for x in a.steps.split(",") if x]
    bad = set(a.steps) - set(STEPS)
    if bad:
        ap.error(f"unknown steps {sorted(bad)}")
    return a


def run(a) -> dict:
    """Every step ``a.steps`` names, in order; returns the JSON record."""
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch sees no "
                               "CUDA device")
    os.makedirs(a.dir, exist_ok=True)
    s = Scale(a)
    out: dict = {"card": s.card, "device": a.device}
    t_all = time.perf_counter()

    def done(name, rec, t0):
        rec["step_s"] = time.perf_counter() - t0
        rec["card"] = s.card
        out[name] = rec
        print(f"# {name}: {json.dumps(rec)}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    genome, rec = step_genome(s)
    done("genome", rec, t0)
    t0 = time.perf_counter()
    index, rec = step_index(s, genome)
    done("index", rec, t0)
    eng = ctx = None
    if "tables" in a.steps or "workers" in a.steps:
        t0 = time.perf_counter()
        eng, ctx = step_tables(s, genome, index)
        done("tables", ctx, t0)
    chrs = (chr_arrays(s.gpath, a.n_chr, a.chr_len)
            if {"se", "pe"} & set(a.steps) else None)
    if "se" in a.steps:
        t0 = time.perf_counter()
        prof = None
        if eng is not None and a.device == "cuda":
            prof = idle_share(s, eng, se_reads(s, chrs)[0], PROFILE_READS)
        eng = None                  # its tables leave the card
        rec = step_se(s, genome, chrs)
        done("se", {**rec, "profile": prof}, t0)
    eng = None
    if "pe" in a.steps:
        t0 = time.perf_counter()
        done("pe", step_pe(s, chrs, not a.no_methratio), t0)
    chrs = None
    if "sharded" in a.steps:
        t0 = time.perf_counter()
        done("sharded", step_sharded(s), t0)
    if "workers" in a.steps:
        t0 = time.perf_counter()
        done("workers", step_workers(s, ctx), t0)
    out["total_s"] = time.perf_counter() - t_all
    return out


def main(argv=None) -> int:
    a = parse(sys.argv[1:] if argv is None else argv)
    out = run(a)
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
