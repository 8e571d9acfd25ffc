"""Command-line driver with the reference's option surface (main.cpp:182-289),
running the single-end and pair-end WGBS paths and single-end RRBS on
PyTorch, on the forward strands (-n 0) or all four (-n 1).

Supports both ``-x val`` and ``-x=val`` forms.  Output format is chosen by
the -o suffix: .sam = SAM, anything else = BSP (main.cpp:293-296).  The
alignment engine is ``--engine auto`` (the default, ``bsmap_tpu``'s own
choice: ``sharded`` when more than one card is visible, else ``device``;
a configuration that engine does not support -- pair-end RRBS, a genome
past 32-bit strand coordinates -- runs on the host engine, and stderr says
so), ``--engine device`` (PyTorch, on the device named by ``--device``,
CUDA kernels on a GPU), ``--engine sharded`` (stripes of reads over every
visible card), ``--engine index-sharded`` (the seed index split by genome
region over every visible card; not for RRBS) or ``--engine host`` (the
exact sequential oracle).  Under ``--device cpu`` the mesh engines run one
shard on the CPU.  A missing device or a kernel that fails to build or
launch raises under every engine, ``auto`` included; an engine named
explicitly also raises on a configuration it does not support.

A ``.bam`` output is written as SAM and converted after the run to a
sorted, indexed BAM (``output/bam.py``); ``-a`` reads FASTA, FASTQ, SAM or
BAM.  ``-p N`` is BSMAP's thread count (main.cpp:45-131): a run on the
native block path encodes its blocks on N threads in one process
(``run_single_end_blocks``, ``run_pair_end_blocks``), on the card for
RRBS, trimming, BSP and ``-R`` too: single-end on every PyTorch engine,
pair-end on the single-device engine (``device``, or ``auto`` with one
card).  Where one process cannot use the threads, ``-p N`` starts N
worker processes over contiguous read ranges (``_wants_local_mp``):
RRBS, trimming, BSP or ``-R`` (pair-end) under ``--device cpu`` or
``--engine host``, SAM/BAM input, an ``auto`` run that gives way to the
host engine (pair-end RRBS included), and the pair-end per-pair path of
the mesh engines.  ``bsmap_tpu`` starts the workers on every per-read
path (bsmap_tpu/cli.py:320-333).  ``--nprocs``/``--proc-id`` run
one range of a multi-process job by hand, ``--coordinator`` joins a
torch.distributed gloo group (``parallel/distributed.py``).  Process 0
merges the shards byte-identical to a one-process run.

    python -m bsmap_tpu_torch.cli -a reads.fq -d ref.fa -o out.sam --device cuda
    python -m bsmap_tpu_torch.cli -a r1.fq -b r2.fq -d ref.fa -o out.bam
    python -m bsmap_tpu_torch.cli -a rrbs.fq -d ref.fa -D C-CGG -o out.sam
    python -m bsmap_tpu_torch.cli -a pbat.fq -d ref.fa -n 1 -o out.sam
    python -m bsmap_tpu_torch.cli -a reads.fq -d ref.fa -o out.sam \\
        --engine index-sharded
    python -m bsmap_tpu_torch.cli -a rrbs.fq -d ref.fa -D C-CGG -A AGATCGGAAGAGC \\
        -o out.sam -p 4
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import time

from .index import (build_index, index_cache_key, load_index, save_index)
from .output.sam import SamFormatter, sam_header
from .params import MAXSNPS, Param, MAXHITS
from .readio import BATCH_NUM, open_read_stream
from .reference import load_genome
from .utils import RandR, StepTimer

USAGE = """Usage: bsmap_tpu_torch [options]
       -a  <str>   query a file, FASTA/FASTQ/SAM/BAM format
       -b  <str>   query b file (pair-end mate 2)
       -d  <str>   reference sequences file, FASTA format
       -o  <str>   output alignment file, BSP/SAM/BAM format
       -2  <str>   output file of unpaired hits (pair-end BSP output)
       -m  <int>   minimal insert size (pair-end), default 28
       -x  <int>   maximal insert size (pair-end), default 500
       -s  <int>   seed size, default=16 (WGBS), 12 (RRBS). min=8, max=16
       -v  <int>   max mismatches per read (<=15), default=2
       -w  <int>   max equal best hits to count (<=1000)
       -B  <int>   start from the Nth read
       -E  <int>   end at the Nth read
       -I  <int>   index interval, default=4 (WGBS), 1 (RRBS)
       -p  <int>   threads, default 8: a block-path run on the card
                   (single-end; pair-end on one card's device engine)
                   encodes on -p threads in one process; RRBS, trimming,
                   or pair-end BSP or -R, under --device cpu, --engine
                   host, SAM/BAM input or a pair-end mesh engine, start -p
                   worker processes over read ranges instead
                   (BSMAP_TPU_LOCAL_MP=0 keeps one process)
       -S  <int>   random seed for multi-hit selection (0 = clock)
       -M  <str>   alignment transition, default TC
       -q  <int>   quality trim threshold, default 0
       -z  <int>   base quality zero, default 33
       -f  <int>   filter reads with >n Ns, default 5
       -A  <str>   3' adapter sequence
       -L  <int>   map first N nucleotides
       -r  [0,1]   repeat-hit reporting: 0 none, 1 random one
       -D  <str>   RRBS digestion site, e.g. C-CGG
       -n  [0,1]   0: map to the 2 forward strands, 1: to all 4 strands
       -R          print reference sequence (XR tag)
       -u          report unmapped reads
       --engine {auto,device,sharded,index-sharded,host}
                               alignment engine (default auto: sharded
                               when more than one card is visible, else
                               device; the host engine where that engine
                               does not support the configuration;
                               sharded: read stripes over every visible
                               card; index-sharded: the seed index split
                               by genome region over every visible card)
       --device {cuda,cpu}     torch device of the device engines (default
                               cuda; cpu runs the kernels' plain twins,
                               one shard for the mesh engines)
       --index-cache <dir>     persist/reuse the seed index
       --nprocs <int>          multi-process: total processes (contiguous
                               read ranges; byte-exact merge on process 0)
       --proc-id <int>         multi-process: this process id (0-based)
       --coordinator <h:p>     multi-process: torch.distributed (gloo)
                               rendezvous address, process 0's host
       -h          help
   Pair-end -D runs on the host engine (auto picks it; --engine device
   refuses), and -D not on index-sharded.
"""


ENGINES = ("auto", "device", "sharded", "index-sharded", "host")


def _unported(what: str):
    sys.exit(f"{what} is unported in bsmap_tpu_torch, see ROADMAP.md")


class Options:
    def __init__(self) -> None:
        self.param = Param()
        self.query_a = ""
        self.query_b = ""
        self.ref_file = ""
        self.out_file = ""
        self.out_unpair = ""
        self.engine = "auto"
        self.device = "cuda"
        self.index_cache = os.environ.get("BSMAP_TPU_INDEX_CACHE", "")
        self.nprocs = 1
        self.proc_id = 0
        self.coordinator = ""


def parse_args(argv: list[str]) -> Options:
    o = Options()
    p = o.param
    i = 0

    def val():
        nonlocal i
        a = argv[i]
        if len(a) > 2 and a[2] == "=":
            return a[3:]
        i += 1
        return argv[i]

    def long_val(name: str):
        nonlocal i
        a = argv[i]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
        i += 1
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "--engine" or a.startswith("--engine="):
            o.engine = long_val("--engine")
            if o.engine not in ENGINES:
                _unported(f"--engine {o.engine}")
        elif a == "--device" or a.startswith("--device="):
            o.device = long_val("--device")
            if o.device not in ("cuda", "cpu"):
                sys.exit(f"unknown device: {o.device} (cuda or cpu)")
        elif a == "--index-cache" or a.startswith("--index-cache="):
            o.index_cache = long_val("--index-cache")
        elif a == "--nprocs" or a.startswith("--nprocs="):
            o.nprocs = int(long_val("--nprocs"))
        elif a == "--proc-id" or a.startswith("--proc-id="):
            o.proc_id = int(long_val("--proc-id"))
        elif a == "--coordinator" or a.startswith("--coordinator="):
            o.coordinator = long_val("--coordinator")
        elif a.startswith("-") and len(a) >= 2:
            c = a[1]
            if c == "a":
                o.query_a = val()
            elif c == "b":
                o.query_b = val()
                p.pairend = 1
            elif c == "d":
                o.ref_file = val()
            elif c == "o":
                o.out_file = val()
            elif c == "2":
                o.out_unpair = val()
            elif c == "s":
                p.set_seed_size(int(val()))
                if p.RRBS_flag:
                    p.set_seed_size(12)
            elif c == "m":
                p.min_insert = int(val())
            elif c == "x":
                p.max_insert = int(val())
            elif c == "r":
                p.report_repeat_hits = int(val())
            elif c == "I":
                p.index_interval = int(val())
                if p.RRBS_flag:
                    p.index_interval = 1
                if p.index_interval > 16:
                    sys.exit("index interval exceeds max value:16")
            elif c == "v":
                p.max_snp_num = int(val())
                if p.max_snp_num > MAXSNPS:
                    sys.exit(f"number of mismatches exceeds max value:{MAXSNPS}")
            elif c == "w":
                p.max_num_hits = int(val())
                if p.max_num_hits > MAXHITS:
                    sys.exit(f"number of multi-hits exceeds max value:{MAXHITS}")
            elif c == "q":
                p.qual_threshold = int(val())
            elif c == "f":
                p.max_ns = int(val())
            elif c == "z":
                p.zero_qual = int(val())
            elif c == "p":
                p.num_procs = int(val())
            elif c == "A":
                p.adapters.append(val())
            elif c == "R":
                p.out_ref = 1
            elif c == "u":
                p.out_unmap = 1
            elif c == "B":
                p.read_start = max(int(val()), 1)
            elif c == "E":
                p.read_end = int(val())
            elif c == "D":
                p.set_digestion_site(val())
            elif c == "M":
                v = val()
                p.set_align(v[0], v[1])
            elif c == "L":
                p.max_readlen = int(val())
            elif c == "S":
                p.randseed = int(val())
            elif c == "n":
                p.chains = 1 if int(val()) != 0 else 0
            elif c == "h":
                print(USAGE)
                sys.exit(0)
            else:
                sys.exit(f"unknown option: {a}")
        else:
            sys.exit(f"unknown option: {a}")
        i += 1
    p.init_mapping()
    return o


def index_cache_path(o: Options) -> str:
    """Where ``get_index`` keeps the index in ``o.index_cache``."""
    os.makedirs(o.index_cache, exist_ok=True)
    return os.path.join(o.index_cache,
                        f"idx_{index_cache_key(o.ref_file, o.param)}.npz")


def get_index(o: Options, genome, log=print):
    p = o.param
    if o.index_cache:
        path = index_cache_path(o)
        if os.path.exists(path):
            log(f"loading cached index {path}")
            try:
                return load_index(path, mmap=True)
            except ValueError:       # old compressed-format cache
                return load_index(path)
        idx = build_index(genome, p)
        save_index(path, idx)
        return idx
    return build_index(genome, p)


def resolve_engine(o: Options, mesh=None):
    """(engine name, mesh) with ``auto`` resolved as ``bsmap_tpu`` resolves
    it (bsmap_tpu/cli.py:224-226): ``sharded`` over ``mesh`` (default
    ``make_mesh(device=o.device)``, which raises when ``--device cuda``
    finds no card) when it has more than one entry, else ``device``."""
    if o.engine != "auto":
        return o.engine, mesh
    if mesh is None:
        from .parallel import make_mesh
        mesh = make_mesh(device=o.device)
    return ("sharded" if len(mesh) > 1 else "device"), mesh


def with_host_fallback(o: Options, build, host, stats: dict | None = None):
    """The engine of ``build()`` (``make_engine`` or ``make_pair_engine``).
    Under ``auto`` alone, an ``EngineUnsupported`` raised while that engine
    is constructed sends the run to ``host()``, as ``bsmap_tpu``'s ``auto``
    does; any other error, and ``EngineUnsupported`` under an engine named
    explicitly, propagates.  stderr says which engine runs and why;
    ``stats["engine_name"]`` records it."""
    from .engine.device_engine import EngineUnsupported
    why = f"--engine {o.engine}"
    try:
        engine = build()
        name = getattr(engine, "engine_name", "host")
    except EngineUnsupported as e:
        if o.engine != "auto":
            raise
        engine, name, why = host(), "host", f"{why}: {e}"
    print(f"engine: {name} ({why})", file=sys.stderr)
    if stats is not None:
        stats["engine_name"] = name
    return engine


def make_engine(o: Options, genome, index, mesh=None):
    """``--engine host`` is the exact host engine; ``sharded`` and
    ``index-sharded`` the mesh engines over ``mesh`` (default
    ``make_mesh(device=o.device)``: every visible card, or one CPU entry);
    ``device`` the PyTorch engine on ``o.device``; ``auto`` is
    ``resolve_engine``'s pick.  Each raises when its device is missing or
    (``EngineUnsupported``) when it does not run the configuration."""
    name, mesh = resolve_engine(o, mesh)
    if name == "host":
        from .engine.host_engine import HostEngine
        return HostEngine(genome, index, o.param)
    if name in ("sharded", "index-sharded"):
        from .parallel import IndexShardedEngine, ShardedDeviceEngine
        from .parallel import make_mesh
        cls = (ShardedDeviceEngine if name == "sharded"
               else IndexShardedEngine)
        engine = cls(genome, index, o.param, mesh=(
            mesh if mesh is not None else make_mesh(device=o.device)))
    else:
        from .engine.device_engine import DeviceEngine
        engine = DeviceEngine(genome, index, o.param, device=o.device)
    engine.engine_name = name
    return engine


def run(argv: list[str], stats: dict | None = None, mesh=None) -> int:
    """Run the CLI on ``argv``; returns the exit code.  A ``stats`` dict
    receives the alignment phase's ``reads`` (SE) or ``pairs`` (PE; of
    this process's range under ``--nprocs``; with ``pe_path``, "blocks"
    or "pairs"), ``align_s``, ``engine`` (the
    engine object), ``engine_name`` (the engine that ran: ``auto``
    resolved, ``host`` where it gave way), for ``.bam`` output the
    conversion's ``bam_s`` (not in ``align_s``) and, for single-end BSP
    or XR under ``--nprocs`` past the first range, ``walk_s``: the
    seconds that took the output state over from the reads before it
    (``distributed.reconstruct_format_state``).  ``mesh`` overrides the
    device list of the mesh engines and of ``auto``'s choice (it may
    repeat a device)."""
    if not argv:
        print(USAGE)
        return 1
    o = parse_args(argv)
    p = o.param
    timer = StepTimer()
    if o.out_file.endswith(".sam"):
        p.out_sam = 1
    elif o.out_file.endswith(".bam"):
        p.out_sam = 2
    if not o.ref_file:
        sys.exit("fatal error: failed to open ref file")
    with contextlib.ExitStack() as stack:
        if o.index_cache:
            from .reference import load_genome_cached
            genome = load_genome_cached(o.ref_file, p, o.index_cache)
        else:
            genome = load_genome(o.ref_file, p)
        local_mp = o.nprocs == 1 and _wants_local_mp(o, genome)
        p.total_ref_seq = genome.n_chr
        print(f"Load in {genome.n_chr} db seqs, total size "
              f"{genome.sum_length} bp. {timer.total():.1f} secs passed")
        index = get_index(o, genome)
        print(f"Create seed table. {timer.total():.1f} secs passed")
        if o.nprocs > 1:
            if o.query_a and o.query_b:
                run_multihost_pair(o, genome, index, stats=stats, mesh=mesh)
            else:
                run_multihost_se(o, genome, index, stats=stats, mesh=mesh)
        elif local_mp and (k := _worker_cap(o, genome, index)) > 1:
            if not o.index_cache:
                # the workers would each pack the genome and build the
                # index again: this parent saves them once into a cache
                # directory, and the workers memory-map the shared copy
                import tempfile
                from .reference import genome_cache_path, save_genome
                o.index_cache = stack.enter_context(
                    tempfile.TemporaryDirectory(prefix="bsmap_tpu_idx_",
                                                ignore_cleanup_errors=True))
                argv = list(argv) + ["--index-cache", o.index_cache]
                if path := genome_cache_path(o.ref_file, p, o.index_cache):
                    save_genome(path, genome)
                save_index(index_cache_path(o), index)
            run_local_multiprocess(o, argv, k)
        elif o.query_a and o.query_b:
            from .engine.pair_pipeline import run_pair_end
            run_pair_end(o, genome, index, stats=stats, mesh=mesh)
        else:
            run_single_end(o, genome, index, stats=stats, mesh=mesh)
    print(f"Total time consumed:  {timer.total():.1f} secs")
    return 0


def _wants_local_mp(o: Options, genome) -> bool:
    """Whether ``-p N`` (N > 1) starts N worker processes over contiguous
    read ranges (the byte-exact ``--nprocs`` range machinery).  Runs
    without RRBS, trimming, or (pair-end) BSP and ``-R`` never do.  Nor
    does a FASTA/FASTQ run on the card whose engine takes the native block
    path: single-end on any PyTorch engine (``device``, ``sharded``,
    ``index-sharded``, or ``auto`` where ``genome`` fits the device
    engines), pair-end where the single-device engine will take the
    block path (``pair_pipeline.will_take_blocks``: ``device``, or
    ``auto`` with one card, on a genome that fits, with the pair formatter
    built, the rule ``takes_blocks`` applies to the engine); one process, RRBS,
    trimming, BSP and ``-R`` included, encodes on N threads
    (``run_single_end_blocks``, ``run_pair_end_blocks``).  The rest keep
    the workers: ``--device cpu`` (where the twins are the compute),
    ``--engine host``, SAM/BAM input, ``auto`` giving way to the host
    engine (pair-end RRBS included), and the pair-end per-pair path of the
    mesh engines.  ``bsmap_tpu`` starts workers on every per-read path
    (bsmap_tpu/cli.py:320-333).  ``BSMAP_TPU_LOCAL_MP=0`` turns the
    workers off."""
    p = o.param
    if p.num_procs <= 1 or os.environ.get("BSMAP_TPU_LOCAL_MP") == "0":
        return False
    pe = bool(o.query_a and o.query_b)
    plain = (not p.RRBS_flag and not p.adapters and p.qual_threshold == 0
             and (not pe or (p.out_sam >= 1 and not p.out_ref)))
    if plain:
        return False
    if o.device != "cuda" or o.engine == "host":
        return True
    from .engine.device_engine import genome_fits
    from .readio import detect_format
    fits = o.engine != "auto" or genome_fits(genome)
    if not pe:
        return detect_format(o.query_a) >= 2 or not fits
    from .engine.pair_pipeline import will_take_blocks
    return not will_take_blocks(o, resolve_engine(o)[0], fits)


# a -p worker's peak card memory over the bytes of its device tables: 1.11
# measured on the single-end path at hg38 class (9.41 GB reserved over
# 8.49 GB of tables, on an H100 80GB HBM3 at 700 W), and room for the
# pair-end per-pair path's working set and the table build's chunks, which
# eight workers building at once did not find on that 85 GB card
CARD_PER_TABLE_BYTE = 1.25
CUDA_CONTEXT_BYTES = 600_000_000       # 0.55 GB measured there
# host bytes a -p worker's replay engine takes a packed genome byte to
# unpack it (measured at hg38 class, see _worker_cap)
UNPACK_BYTES = 16


def _host_available() -> int:
    """The host memory this process may still take, bytes: MemAvailable,
    or less where its cgroup's limit (memory.max less memory.current)
    leaves less."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read())
    except (OSError, ValueError):
        return avail
    return avail if limit == "max" else min(avail, int(limit) - used)


def _card_free() -> int:
    """The first visible card's free memory, bytes, from nvidia-smi, so
    that this process opens no CUDA context of its own while its workers
    run (torch's count where nvidia-smi gives none)."""
    import subprocess
    dev = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=memory.free",
                            "--format=csv,noheader,nounits", "-i",
                            dev or "0"], capture_output=True, text=True,
                           timeout=60, check=True)
        return int(r.stdout.split()[0]) << 20
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        import torch
        return torch.cuda.mem_get_info()[0]


def _worker_cap(o: Options, genome, index) -> int:
    """How many ``-p`` workers to start: ``p.num_procs``, or as many as
    the host's available memory (``_host_available``) and, on the card,
    its free memory hold.  On the host a worker holds the cached genome
    and index it memory-maps, private memory of about their size again,
    and, once it replays a read or pair on the exact host engine, the
    genome unpacked a byte a base through temporaries: at hg38 class a
    worker's peak RSS was 15.2 GB with 8.1 GB of mapped pages in it, and
    40.2 GB once it replayed (16 bytes a packed genome byte more), on the
    96 GiB host of an H100 80GB HBM3 (700 W), whose /proc counts the
    mapped pages in every worker.  On the card it builds its own tables
    (packed genome, index entries, k-mer table) and a CUDA context.
    Prints one stderr line when it starts fewer; the read ranges are
    byte-exact for any count."""
    n = o.param.num_procs
    packed = genome.refcat.nbytes + genome.crefcat.nbytes
    mapped = packed + index.locs.nbytes + index.offsets.nbytes
    fits = {"host": int(_host_available() // max(
        2 * mapped + UNPACK_BYTES * packed, 1))}
    if o.device == "cuda" and o.engine != "host":
        tables = packed + index.locs.nbytes + 16 * index.total_kmers
        fits["card"] = int(_card_free() // (
            CARD_PER_TABLE_BYTE * tables + CUDA_CONTEXT_BYTES))
    k = max(1, min(n, *fits.values()))
    if k < n:
        what = f"{k} worker processes" if k > 1 else "this process alone"
        print(f"-p {n}: {what}, what this host's available memory and the "
              "card's free memory hold "
              f"({', '.join(f'{w} {v}' for w, v in fits.items())})",
              file=sys.stderr)
    return k


def run_local_multiprocess(o: Options, argv: list[str],
                           n: int | None = None) -> int:
    """Spawn ``n`` (default -p) worker processes over contiguous read
    ranges (each takes the o.nprocs > 1 branch with this run's own argv,
    ``--device`` and ``--engine`` included); process 0 merges the output
    byte-identical.  Read-range shards are idempotent, so a failed worker
    is started again at once, one time; a second failure stops the other
    workers (worker 0 would otherwise wait in ``merge_shards`` for a shard
    that never comes), removes the shards and fails the run."""
    import subprocess

    n = n or o.param.num_procs

    def spawn(k: int):
        cmd = [sys.executable, "-m", "bsmap_tpu_torch.cli"] + argv + [
            "--nprocs", str(n), "--proc-id", str(k)]
        return subprocess.Popen(cmd)

    procs = {k: spawn(k) for k in range(n)}
    retried: set[int] = set()
    rc: dict[int, int] = {}
    try:
        while len(rc) < n:
            for k in list(procs):
                if k in rc:
                    continue
                r = procs[k].poll()
                if r is None:
                    continue
                if r != 0 and k not in retried:
                    print(f"retrying failed worker shard {k} "
                          "(idempotent range)")
                    retried.add(k)
                    procs[k] = spawn(k)
                else:
                    rc[k] = r
            if any(rc.values()):
                break
            time.sleep(0.2)
    finally:
        for k, q in procs.items():
            if k not in rc and q.poll() is None:
                q.kill()
                q.wait()
    if any(rc.values()) or len(rc) < n:
        _cleanup_shards(o, n)
        sys.exit(f"worker process failed after retry: {rc}")
    return 0


def _cleanup_shards(o: Options, n: int) -> None:
    """Remove partial shard litter after a failed multi-process run."""
    for base in (o.out_file, o.out_unpair):
        if not base:
            continue
        for k in range(n):
            for suf in (f".shard{k}", f".shard{k}.done", f".shard{k}.tmp",
                        f".shard{k}.ctx", f".shard{k}.ctx.tmp"):
                try:
                    os.remove(base + suf)
                except OSError:
                    pass


def _end_rendezvous(o: Options) -> None:
    """With a coordinator, every process waits for the others, then leaves
    the process group: process 0 hosts the group's TCP store, so it must
    not exit while another process still uses it."""
    if o.coordinator:
        import torch.distributed as tdist
        tdist.barrier()
        tdist.destroy_process_group()


def _to_bam(path: str, stats: dict | None) -> None:
    """Convert the SAM text written to ``path`` into a sorted BAM in place,
    with its ``.bai``; the seconds go to ``stats["bam_s"]``.  The copied
    converter passes over an index that fails to build without a word
    (bamio.sam_to_bam), so a ``.bai`` that is not there afterwards fails
    the run here."""
    from .output.bam import sam_to_bam
    t0 = time.perf_counter()
    bai = path + ".bai"
    if os.path.exists(bai):
        os.remove(bai)
    sam_to_bam(path)
    if not os.path.exists(bai):
        raise RuntimeError(f"{path}: the BAM index {bai} was not built")
    if stats is not None:
        stats["bam_s"] = time.perf_counter() - t0


def whole_file(p: Param) -> Param:
    """A copy of ``p`` that reads the whole input file, from read 1 to its
    end.  ``count_reads`` counts what the stream it opens yields, so under
    the user's ``-B``/``-E`` it would return the window's size, not the
    number of its last read, and ``plan_range`` would cut the window's
    last reads off; counted over the whole file, ``plan_range`` ends the
    window where ``-E`` (or the file) does."""
    q = copy.copy(p)
    q.read_start, q.read_end = 1, Param().read_end
    return q


def run_multihost_se(o: Options, genome, index, stats: dict | None = None,
                     mesh=None) -> int:
    """Multi-process SE: a contiguous read range per process, the MateState
    rebuilt exactly at the range boundary, the shards merged in order on
    process 0 (parallel/distributed.py), as bsmap_tpu/cli.py:393-435.  The
    engine is chosen as in a one-process run (``--engine auto`` included),
    and ``stats`` gets this range's numbers."""
    from .parallel import distributed as dist

    p = o.param
    dist.initialize(o.coordinator, o.nprocs, o.proc_id)
    try:
        total = dist.count_reads(o.query_a, whole_file(p))
        s, e = dist.plan_range(total, o.nprocs, o.proc_id,
                               p.read_start, p.read_end)
        final_out = o.out_file

        def host():
            from .engine.host_engine import HostEngine
            return HostEngine(genome, index, p)

        engine = with_host_fallback(
            o, lambda: make_engine(o, genome, index, mesh), host, stats)
        fmt = SamFormatter(genome, p, RandR(1))
        # a single process starts fresh at the user's -B (read_start)
        if s > p.read_start:
            dist.reconstruct_state(engine, o.query_a, p, s,
                                   first=p.read_start)
            if not p.out_sam or p.out_ref:
                # BSP and XR print what leaks from read to read (a QC
                # line's orientation, a context's leading bases): take it
                # over from the reads before s
                t0 = time.perf_counter()
                dist.reconstruct_format_state(engine, fmt, o.query_a, p, s,
                                              first=p.read_start)
                walk_s = time.perf_counter() - t0
                print(f"range start {s}: hits[0][0] slot {fmt.stale_h00}, "
                      f"context {bytes(fmt._mapseq[:2])} from the reads "
                      f"before it in {walk_s:.6f} s", file=sys.stderr)
                if stats is not None:
                    stats["walk_s"] = walk_s
        p.read_start, p.read_end = s, e
        # written through a .tmp and renamed: a shard that dies midway
        # never looks complete to the merger
        shard_path = final_out + f".shard{o.proc_id}"
        o.out_file = shard_path + ".tmp"
        timer = StepTimer()
        t0 = time.perf_counter()
        from .readio import detect_format
        if (getattr(engine, "supports_blocks", lambda: False)()
                and detect_format(o.query_a) < 2):
            total_n = run_single_end_blocks(o, engine, fmt, genome, timer,
                                            header=False)
        else:
            total_n = run_single_end_reads(o, engine, fmt, genome, timer,
                                           header=False)
        if stats is not None:
            stats.update(reads=total_n, align_s=time.perf_counter() - t0,
                         engine=engine)
        os.replace(o.out_file, shard_path)
        o.out_file = shard_path
        open(shard_path + ".done", "w").close()
        print(f"shard {o.proc_id}: {total_n} reads, "
              f"{fmt.n_aligned} aligned")
        o.out_file = final_out
        if o.proc_id == 0:
            dist.merge_shards(final_out, o.nprocs,
                              sam_header(genome) if p.out_sam else "")
            print(f"merged {o.nprocs} shards -> {final_out}")
            if p.out_sam == 2:
                _to_bam(final_out, stats)
    finally:
        _end_rendezvous(o)
    return total_n


def run_multihost_pair(o: Options, genome, index, stats: dict | None = None,
                       mesh=None) -> int:
    """Multi-process PE: a contiguous PAIR range per process with both
    mates' MateStates rebuilt exactly at the boundary, the shards merged in
    order on process 0, as bsmap_tpu/cli.py:438-494.  The engine is chosen
    as in a one-process run (``--engine auto`` included: the host engine
    for pair-end -D).  Where contexts print (BSP, SAM ``-R``), each range
    records the context bytes it prints from buffer slots it has not
    written yet and the merge sets them from the ranges before it
    (parallel/carry.py); ``stats`` gets the count (``ctx_patches``) and
    the seconds of the sidecar reads and patches (``patch_s``)."""
    from .engine.pair_pipeline import (HostPairBatch, make_pair_engine,
                                       run_pair_end_blocks,
                                       run_pair_end_reads, takes_blocks)
    from .output.pair_sam import PairFormatter
    from .parallel import carry as ctx
    from .parallel import distributed as dist

    p = o.param
    dist.initialize(o.coordinator, o.nprocs, o.proc_id)
    try:
        total = dist.count_reads(o.query_a, whole_file(p))
        s, e = dist.plan_range(total, o.nprocs, o.proc_id,
                               p.read_start, p.read_end)
        engine = with_host_fallback(
            o, lambda: make_pair_engine(o, genome, index, mesh),
            lambda: HostPairBatch(genome, index, p), stats)
        if s > p.read_start:    # a single process starts fresh at -B
            dist.reconstruct_pair_state(engine, o.query_a, o.query_b, p, s,
                                        first=p.read_start)
        p.read_start, p.read_end = s, e
        final_out, final_unpair = o.out_file, o.out_unpair
        if not p.out_sam and not final_unpair:
            sys.exit("failed to open output file for unpaired hits "
                     "(check -2 option)")
        fmt = PairFormatter(genome, p, RandR(1))
        shard_path = f"{final_out}.shard{o.proc_id}"
        o.out_file = shard_path + ".tmp"
        up_path = ""
        if final_unpair:
            up_path = f"{final_unpair}.shard{o.proc_id}"
            o.out_unpair = up_path + ".tmp"
        blocks = takes_blocks(engine, o)
        carry = ctx.ContextCarry() if p.out_ref or not p.out_sam else None
        t0 = time.perf_counter()
        if blocks:
            engine.carry = carry
            total_n = run_pair_end_blocks(o, genome, engine, fmt,
                                          header=False)
            mapseq = engine._mapseq
        else:
            if carry is not None:
                ctx.track_pair_formatter(fmt, carry)
            total_n = run_pair_end_reads(o, genome, engine, fmt,
                                         header=False, carry=carry)
            mapseq = (fmt.fa._mapseq, fmt.fb._mapseq)
        if stats is not None:
            stats.update(pairs=total_n, align_s=time.perf_counter() - t0,
                         engine=engine,
                         pe_path="blocks" if blocks else "pairs")
        if carry is not None:
            carry.save(ctx.sidecar_path(final_out, o.proc_id), *mapseq)
        os.replace(o.out_file, shard_path)
        open(shard_path + ".done", "w").close()
        if not p.out_sam and final_unpair:
            os.replace(o.out_unpair, up_path)
            open(up_path + ".done", "w").close()
        o.out_file, o.out_unpair = final_out, final_unpair
        print(f"shard {o.proc_id}: {total_n} pairs on the "
              f"{'block' if blocks else 'per-pair'} path, "
              f"{fmt.n_aligned_pairs} aligned pairs")
        if o.proc_id == 0:
            dist.wait_shards(final_out, o.nprocs)
            t0 = time.perf_counter()
            plan = (ctx.merge_patches(final_out, o.nprocs) if carry
                    else (None, None))
            patch_s = time.perf_counter() - t0
            n_patch, s_patch = dist.merge_shards(
                final_out, o.nprocs, sam_header(genome) if p.out_sam else "",
                patches=plan[ctx.MAIN])
            if not p.out_sam and final_unpair:
                n2, s2 = dist.merge_shards(final_unpair, o.nprocs, "",
                                           patches=plan[ctx.UNPAIRED])
                n_patch, s_patch = n_patch + n2, s_patch + s2
            merge_s = time.perf_counter() - t0
            patch_s += s_patch
            print(f"merged {o.nprocs} shards -> {final_out} in "
                  f"{merge_s:.6f} s: {n_patch} context patches in "
                  f"{patch_s:.6f} s")
            if stats is not None:
                stats.update(ctx_patches=n_patch, patch_s=patch_s,
                             merge_s=merge_s)
            if p.out_sam == 2:
                _to_bam(final_out, stats)
    finally:
        _end_rendezvous(o)
    return total_n


def _randr_seed() -> int:
    """rand_r seed for -S 0: getpid()*time() like the reference
    (explicitly non-reproducible, README.txt:91-92); BSMAP_TPU_RANDR_SEED
    pins it for parity tests."""
    env = os.environ.get("BSMAP_TPU_RANDR_SEED")
    if env is not None:
        return int(env)
    return os.getpid() * int(time.time()) & 0xFFFFFFFF


def run_single_end(o: Options, genome, index, stats: dict | None = None,
                   mesh=None) -> int:
    """Align every read of ``o.query_a`` into ``o.out_file``; returns the
    read count and, into ``stats``, the alignment phase's wall time (engine
    set-up excluded) and the engine."""
    p = o.param

    def host():
        from .engine.host_engine import HostEngine
        return HostEngine(genome, index, p)

    engine = with_host_fallback(
        o, lambda: make_engine(o, genome, index, mesh), host, stats)
    fmt = SamFormatter(genome, p, RandR(_randr_seed()))
    timer = StepTimer()
    t0 = time.perf_counter()
    from .readio import detect_format
    if (getattr(engine, "supports_blocks", lambda: False)()
            and detect_format(o.query_a) < 2):
        total = run_single_end_blocks(o, engine, fmt, genome, timer,
                                      threads=p.num_procs)
    else:
        total = run_single_end_reads(o, engine, fmt, genome, timer)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.update(reads=total, align_s=dt, engine=engine)
    denom = max(total, 1)
    print(f"Total number of aligned reads: {fmt.n_aligned} "
          f"({100.0 * fmt.n_aligned / denom:.2g}%)")
    if p.out_sam == 2:
        _to_bam(o.out_file, stats)
    return total


def run_single_end_reads(o: Options, engine, fmt, genome, timer,
                         header: bool = True) -> int:
    """Per-read path: exact for every configuration (BAM input included)."""
    p = o.param
    stream = open_read_stream(o.query_a, p, readset=0)
    with open(o.out_file, "w") as fout:
        if p.out_sam and header:
            fout.write(sam_header(genome))
        total = 0
        while True:
            batch = stream.next_batch(BATCH_NUM)
            if not batch:
                break
            fout.write(engine.format_batch(batch, fmt)
                       if hasattr(engine, "format_batch")
                       else "".join(fmt.string_align(r, engine.align(r))
                                    for r in batch))
            total += len(batch)
            print(f"{total} reads finished. {timer.total():.1f} secs passed")
    stream.close()
    return total


def run_single_end_blocks(o: Options, engine, fmt, genome, timer,
                          header: bool = True, threads: int = 1) -> int:
    """Native block pipeline: a reader thread parses blocks in file order,
    ``threads`` encode threads run ``engine.encode_block`` on them (native
    FilterReads and encode, which release the GIL), the align loop takes
    the encoded blocks strictly in file order and a writer thread formats
    them natively.  An error in the reader or in an encode thread ends the
    run with that error."""
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from . import native
    from .blockio import BlockReadStream

    p = o.param
    lib = native.get_lib()
    stream = BlockReadStream(o.query_a, p, readset=0, lib=lib)
    # dispatch windows per block: windows within a block queue on the
    # device while the encode threads work on the next blocks and the
    # writer thread formats the previous one
    blk_win = int(os.environ.get("BSMAP_TPU_BLOCK_WINDOWS", 8))
    blk_n = blk_win * getattr(engine, "B", BATCH_NUM)
    threads = max(threads, 1)
    pool = ThreadPoolExecutor(threads, thread_name_prefix="bsmap_encode")
    # the blocks' encode futures in file order: one ahead of each thread
    q_in: "queue.Queue" = queue.Queue(maxsize=threads + 1)
    q_out: "queue.Queue" = queue.Queue(maxsize=4)
    errors: list[BaseException] = []
    done = threading.Event()

    def encode(blk):
        if hasattr(engine, "encode_block"):
            engine.encode_block(blk)
        return blk

    def reader():
        # geometric ramp (1, 2, 4, ... windows): the device starts on the
        # first window after ~1/blk_win of the full-block parse time
        try:
            size = getattr(engine, "B", BATCH_NUM)
            while not done.is_set():
                blk = stream.next_block(min(size, blk_n))
                size *= 2
                if blk is None:
                    break
                q_in.put(pool.submit(encode, blk))
        except BaseException as e:   # surfaced by the align loop
            errors.append(e)
        q_in.put(None)

    def writer():
        try:
            with open(o.out_file, "wb") as fout:
                if p.out_sam and header:
                    fout.write(sam_header(genome).encode("latin1"))
                while True:
                    item = q_out.get()
                    if item is None:
                        break
                    blk, aligned = item
                    fout.write(engine.format_aligned_block(blk, aligned, fmt))
        except BaseException as e:   # surfaced after the join
            errors.append(e)
            while q_out.get() is not None:   # keep the align loop moving
                pass

    t_rd = threading.Thread(target=reader, daemon=True)
    t_wr = threading.Thread(target=writer, daemon=True)
    t_rd.start()
    t_wr.start()
    total = 0
    try:
        while True:
            fut = q_in.get()
            if fut is None:
                break
            try:
                blk = fut.result()
            except BaseException as e:   # an encode thread's error
                errors.append(e)
                break
            q_out.put((blk, engine.align_block(blk)))
            total += len(blk)
            print(f"{total} reads finished. {timer.total():.1f} secs passed")
    finally:
        done.set()
        q_out.put(None)
        t_wr.join()
        while t_rd.is_alive():       # unblock a reader parked on q_in
            try:
                q_in.get(timeout=0.1)
            except queue.Empty:
                pass
        t_rd.join()
        pool.shutdown(wait=True, cancel_futures=True)
        stream.close()
    if errors:
        raise errors[0]
    return total


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
