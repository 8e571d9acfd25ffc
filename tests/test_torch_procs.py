"""``-p`` in the PyTorch port: when it starts worker processes and when it
runs one process with ``-p`` encode threads (``cli._wants_local_mp``), the
encode pool of the single-end block pipeline (``run_single_end_blocks``)
byte-identical to ``bsmap_tpu``'s host engine with blocks encoded out of
order, and an encode error that ends the run instead of hanging it."""

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from .conftest import REPO, simulate

ADAPTER = ["-A", "AGATCGGAAGAGC"]
# (tag, flags, output suffix): single-end configurations
SE_CONFIGS = {
    "wgbs": ([], "sam"),
    "wgbs_trim": (ADAPTER + ["-q", "2"], "sam"),
    "rrbs_trim": (["-D", "C-CGG"] + ADAPTER + ["-q", "2"], "sam"),
    "rrbs": (["-D", "C-CGG"], "sam"),
    "bsp": ([], "bsp"),
    "bsp_trim": (ADAPTER, "bsp"),
    "xr": (["-R"], "sam"),
    "xr_rrbs": (["-R", "-D", "C-CGG"], "sam"),
}
# the configurations that take a per-read path in bsmap_tpu (trimming or
# RRBS): workers wherever one process cannot use -p threads
PER_READ = {"wgbs_trim", "rrbs_trim", "rrbs", "bsp_trim", "xr_rrbs"}
ENGINES = ["device", "sharded", "index-sharded", "auto"]
SMALL = types.SimpleNamespace(anchors=np.array([0, 60_000]), n_chr=1)
# a genome past the device engines' 32-bit strand coordinates: auto gives
# way to the host engine
HUGE = types.SimpleNamespace(anchors=np.array([0, 2 ** 32]), n_chr=1)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """One file of each input format (``detect_format`` reads the first
    bytes only)."""
    d = tmp_path_factory.mktemp("torch_procs")
    (d / "r.fq").write_text("@r0\nACGT\n+\nIIII\n")
    (d / "r.fa").write_text(">r0\nACGT\n")
    (d / "r.sam").write_text("r0\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")
    (d / "r.bam").write_bytes(b"\x1f\x8b\x08\x04")
    return d


def options(argv, suffix):
    """``cli.parse_args`` plus the output format that ``cli.run`` sets from
    the -o suffix."""
    from bsmap_tpu_torch import cli
    o = cli.parse_args(argv + ["-d", "ref.fa", "-o", f"x.{suffix}"])
    o.param.out_sam = {"sam": 1, "bam": 2}.get(suffix, 0)
    return o


@pytest.fixture
def one_card(monkeypatch):
    """A CUDA card as far as torch says, and the CLI's own -p rule."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("BSMAP_TPU_LOCAL_MP", raising=False)


def _cases():
    """(case id, argv without -d/-o, suffix, genome, workers expected)."""
    out = []
    for tag, (flags, suffix) in SE_CONFIGS.items():
        per_read = tag in PER_READ
        for fmt in ("fq", "fa"):
            for eng in ENGINES:
                out.append((f"{tag}-{fmt}-{eng}-cuda",
                            ["-a", f"r.{fmt}", "--engine", eng] + flags,
                            suffix, SMALL, False))
        out.append((f"{tag}-fq-device-cpu", ["-a", "r.fq", "--device", "cpu"]
                    + flags, suffix, SMALL, per_read))
        out.append((f"{tag}-fq-host", ["-a", "r.fq", "--engine", "host"]
                    + flags, suffix, SMALL, per_read))
        for fmt in ("sam", "bam"):
            out.append((f"{tag}-{fmt}-device-cuda", ["-a", f"r.{fmt}"]
                        + flags, suffix, SMALL, per_read))
        out.append((f"{tag}-fq-auto-host-genome", ["-a", "r.fq"] + flags,
                    suffix, HUGE, per_read))
    pe = ["-a", "r.fq", "-b", "r.fq"]
    # pair-end trimming, BSP and -R: one process on the card's
    # single-device engine (the block path), workers elsewhere
    for eng in ENGINES + ["host"]:
        for dev in ("cuda", "cpu"):
            run = pe + ["--engine", eng, "--device", dev]
            block = dev == "cuda" and eng in ("device", "auto")
            out += [(f"pe-trim-{eng}-{dev}", run + ADAPTER, "sam", SMALL,
                     not block),
                    (f"pe-bsp-{eng}-{dev}", run + ["-2", "u.bsp"], "bsp",
                     SMALL, not block),
                    (f"pe-xr-{eng}-{dev}", run + ["-R"], "sam", SMALL,
                     not block),
                    (f"pe-sam-{eng}-{dev}", run, "sam", SMALL, False)]
    for kind, flags, suffix in (("trim", ADAPTER + ["-q", "2"], "sam"),
                                ("bsp", ["-2", "u.bsp"], "bsp")):
        out.append((f"pe-{kind}-fa-device-cuda",
                    ["-a", "r.fa", "-b", "r.fa"] + flags, suffix, SMALL,
                    False))
        for fmt in ("sam", "bam"):     # SAM/BAM mates: the per-pair path
            out.append((f"pe-{kind}-{fmt}-device-cuda",
                        ["-a", f"r.{fmt}", "-b", f"r.{fmt}"] + flags,
                        suffix, SMALL, True))
        out.append((f"pe-{kind}-fq-auto-host-genome", pe + flags, suffix,
                    HUGE, True))
        # pair-end RRBS: auto gives way to the host engine
        out.append((f"pe-rrbs-{kind}-fq-auto-cuda",
                    pe + ["-D", "C-CGG"] + flags, suffix, SMALL, True))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wants_local_mp(reads, one_card, monkeypatch, case):
    """-p 8 starts workers only where one process cannot use -p threads:
    --device cpu, --engine host, SAM/BAM input, auto giving way to the
    host engine (on a per-read configuration, pair-end RRBS included), and
    the pair-end per-pair path of the mesh engines; single-end
    FASTA/FASTQ on a PyTorch engine on the card, and pair-end on its
    single-device engine (trimming, BSP and -R included), is one process.
    -p 1 is one process everywhere."""
    from bsmap_tpu_torch import cli
    _id, argv, suffix, genome, workers = case
    monkeypatch.chdir(reads)
    assert cli._wants_local_mp(options(argv, suffix), genome) is workers
    assert not cli._wants_local_mp(options(argv + ["-p", "1"], suffix),
                                   genome)


@pytest.mark.parametrize("engine, workers", [("auto", True),
                                             ("device", False),
                                             ("sharded", True)])
def test_wants_local_mp_pe_two_cards(reads, one_card, monkeypatch, engine,
                                     workers):
    """With two cards, pair-end BSP under auto runs the read-stripe
    engine's per-pair path: -p 8 starts workers; --engine device keeps
    one process on the block path."""
    import torch
    from bsmap_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.chdir(reads)
    o = options(["-a", "r.fq", "-b", "r.fq", "-2", "u.bsp", "--engine",
                 engine], "bsp")
    assert cli._wants_local_mp(o, SMALL) is workers


def test_formatter_build_failure_keeps_workers(reads, one_card, tmp_path,
                                               monkeypatch, capsys):
    """A pair formatter that does not compile: ``get_lib`` prints the
    compiler's error and the route on stderr and returns None, the block
    path's runtime is missing, and -p 8 pair-end BSP on the card's
    single-device engine (one process while the formatter builds) starts
    workers for the per-pair path."""
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import pair_device
    from bsmap_tpu_torch.native import pe_format
    monkeypatch.chdir(reads)
    o = options(["-a", "r.fq", "-b", "r.fq", "-2", "u.bsp", "--engine",
                 "device"], "bsp")
    assert not cli._wants_local_mp(o, SMALL)
    bad = tmp_path / "bad.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(pe_format, "SRC", str(bad))
    monkeypatch.setattr(pe_format, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pe_format, "_LIB", None)
    monkeypatch.setattr(pe_format, "_TRIED", False)
    capsys.readouterr()
    assert not pair_device.pair_block_runtime()
    err = capsys.readouterr().err
    assert "bad.cpp" in err
    assert "engine: per-pair path (pe_format unavailable)" in err
    assert cli._wants_local_mp(o, SMALL)


@pytest.fixture(scope="module")
def pool_data(tmp_path_factory):
    """RRBS reads on an MspI digest (chip_smoke's generator) and WGBS
    reads with an adapter read into, each with bsmap_tpu's host engine's
    output at -p 1."""
    d = tmp_path_factory.mktemp("torch_pool")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    chip_smoke.make_rrbs_set(d, n_reads=3000)
    simulate(d, genome_out="g.fa", reads_out="w.fq", n_reads=3000,
             read_len=60, chr_len=40000, n_chr=2, seed=31, error_rate=0.02,
             adapter="AGATCGGAAGAGC")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    for tag, (args, _) in POOL_RUNS.items():
        subprocess.run([sys.executable, "-m", "bsmap_tpu.cli"] + args
                       + ["-o", f"host_{tag}.sam", "--engine", "host", "-p",
                          "1"], cwd=d, env=env, check=True,
                       stdout=subprocess.DEVNULL, timeout=600)
    return d


POOL_RUNS = {
    "rrbs_trim": (["-a", "se.fq", "-d", "rrbs.fa", "-D", "C-CGG", "-S", "1",
                   "-v", "2", "-u"] + ADAPTER + ["-q", "2"], 3000),
    # -z 40 with -q under SAM output: FilterReads rescales the qualities,
    # so encode_block swaps the block's buffer for a written copy
    "wgbs_trim_z": (["-a", "w.fq", "-d", "g.fa", "-s", "12", "-S", "1", "-v",
                     "2", "-u", "-z", "40"] + ADAPTER + ["-q", "2"], 3000),
}


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of one 128-read window, one process."""
    from bsmap_tpu_torch.engine import device_engine
    monkeypatch.setattr(device_engine, "DEV_BATCH", 128)
    monkeypatch.setenv("BSMAP_TPU_BLOCK_WINDOWS", "1")
    monkeypatch.setenv("BSMAP_TPU_LOCAL_MP", "0")
    return device_engine.DeviceEngine


@pytest.mark.parametrize("tag", sorted(POOL_RUNS))
def test_encode_pool_matches_host_engine(pool_data, small_blocks,
                                         monkeypatch, tag):
    """-p 4 in one process: four encode threads over 24 blocks, each
    even-numbered block held back so that the blocks finish encoding out
    of file order; the align loop takes them in file order, so the output
    is byte-identical to bsmap_tpu --engine host -p 1."""
    from bsmap_tpu_torch import cli
    engine = small_blocks
    encode = engine.encode_block
    seen = []

    def slow_encode(self, block):
        if (block.start_index // 128) % 2 == 0:
            time.sleep(0.02)
        seen.append((block.start_index, threading.current_thread().name))
        return encode(self, block)

    monkeypatch.setattr(engine, "encode_block", slow_encode)
    args, n = POOL_RUNS[tag]
    out = pool_data / f"pool_{tag}.sam"
    stats = {}
    monkeypatch.chdir(pool_data)
    assert cli.run(args + ["-o", str(out), "--device", "cpu", "-p", "4"],
                   stats=stats) == 0
    assert stats["reads"] == n
    pool = [(s, t) for s, t in seen if t.startswith("bsmap_encode")]
    firsts = [s for s, _ in pool]
    assert len(firsts) == len(set(firsts)) > 20
    assert sorted(firsts) != firsts          # out of file order
    assert len({t for _, t in pool}) > 1
    assert out.read_bytes() == (pool_data / f"host_{tag}.sam").read_bytes()


def test_encode_error_ends_the_run(pool_data, small_blocks, monkeypatch):
    """An encode thread that raises on the third block ends the run with
    that error, within a time limit of its own: no thread is left waiting
    on a queue."""
    from bsmap_tpu_torch import cli
    engine = small_blocks
    encode = engine.encode_block

    def third_fails(self, block):
        if block.start_index // 128 == 2:
            raise ValueError("encode failed on the third block")
        return encode(self, block)

    monkeypatch.setattr(engine, "encode_block", third_fails)
    args, _ = POOL_RUNS["rrbs_trim"]
    monkeypatch.chdir(pool_data)
    got = []

    def run():
        try:
            cli.run(args + ["-o", "fail.sam", "--device", "cpu", "-p", "4"])
        except BaseException as e:      # noqa: BLE001 (the run's outcome)
            got.append(e)

    before = threading.active_count()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the run hung after an encode error"
    assert len(got) == 1 and isinstance(got[0], ValueError)
    assert "third block" in str(got[0])
    time.sleep(0.5)
    assert threading.active_count() <= before


def _sizes(genome_bytes: int, entries: int, seed: int = 16):
    """A genome and an index of the given sizes (``_worker_cap`` reads
    only their byte counts)."""
    g = types.SimpleNamespace(refcat=types.SimpleNamespace(
        nbytes=genome_bytes // 2), crefcat=types.SimpleNamespace(
        nbytes=genome_bytes // 2))
    i = types.SimpleNamespace(
        locs=types.SimpleNamespace(nbytes=4 * entries),
        offsets=types.SimpleNamespace(nbytes=8 * (3 ** seed + 1)),
        total_kmers=3 ** seed)
    return g, i


@pytest.mark.parametrize("avail, free, device, want", [
    (400e9, 84.4e9, "cuda", 7),     # hg38 class on the 85 GB card: card
    (200e9, 84.4e9, "cuda", 4),     # host: 41.3 GB a worker
    (100e9, 84.4e9, "cuda", 2),
    (400e9, 84.4e9, "cpu", 8),      # no card term on the CPU
    (5e9, 84.4e9, "cpu", 1),        # never fewer than one
])
def test_worker_cap_from_genome_and_index_sizes(one_card, monkeypatch,
                                                avail, free, device, want,
                                                capsys):
    """ROADMAP C2: -p 8 on a per-pair path at hg38 class (1.56 GB packed
    genome, 1.56G index entries) starts what the host's available memory
    and the card's free memory hold, and says so in one stderr line."""
    from bsmap_tpu_torch import cli
    monkeypatch.setattr(cli, "_host_available", lambda: int(avail))
    monkeypatch.setattr(cli, "_card_free", lambda: int(free))
    o = options(["-a", "r1.fq", "-b", "r2.fq", "-2", "u.bsp", "--device",
                 device], "bsp")
    assert cli._worker_cap(o, *_sizes(1_560_006_504, 1_559_999_727)) == want
    err = capsys.readouterr().err
    said = {1: "this process alone"}.get(want, f"{want} worker processes")
    assert (f"-p 8: {said}, " in err) == (want < 8)


@pytest.mark.parametrize("meminfo, limit, current, want", [
    (50 << 30, "max", 1 << 30, 50 << 30),         # no cgroup limit
    (50 << 30, str(96 << 30), 80 << 30, 16 << 30),   # the cgroup's is less
    (10 << 30, str(96 << 30), 20 << 30, 10 << 30),   # MemAvailable's is
    (50 << 30, None, None, 50 << 30),              # no cgroup v2 files
])
def test_host_available_takes_the_cgroup_limit(monkeypatch, meminfo, limit,
                                               current, want):
    """The cap's host memory is the smaller of MemAvailable and what the
    cgroup's memory.max leaves over its memory.current."""
    import io
    from bsmap_tpu_torch import cli
    files = {"/proc/meminfo": "MemTotal: 1 kB\nMemAvailable: "
             f"{meminfo >> 10} kB\n"}
    if limit is not None:
        files["/sys/fs/cgroup/memory.max"] = f"{limit}\n"
        files["/sys/fs/cgroup/memory.current"] = f"{current}\n"

    def fake_open(path, *a, **kw):
        if path not in files:
            raise FileNotFoundError(path)
        return io.StringIO(files[path])
    monkeypatch.setattr(cli, "open", fake_open, raising=False)
    assert cli._host_available() == want


@pytest.mark.parametrize("visible, asked", [(None, "0"), ("3,1", "3"),
                                             ("GPU-abc", "GPU-abc")])
def test_card_free_asks_nvidia_smi(monkeypatch, visible, asked):
    """The cap reads the first visible card's free memory from nvidia-smi
    (no CUDA context in the CLI process), and torch's count only where
    nvidia-smi gives none."""
    import subprocess
    import torch
    from bsmap_tpu_torch import cli
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    seen = []

    def smi(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "81000\n", "")
    monkeypatch.setattr(subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda: pytest.fail(
        "opened a CUDA context"))
    assert cli._card_free() == 81000 << 20
    assert seen[0][0] == "nvidia-smi" and seen[0][-2:] == ["-i", asked]

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])
    monkeypatch.setattr(subprocess, "run", missing)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda: (5, 9))
    assert cli._card_free() == 5


@pytest.mark.parametrize("cap", [2, 1])
def test_capped_workers_match_one_process(pool_data, monkeypatch, capfd,
                                          cap):
    """-p 3 on pair-end BSP with the cap at 2: two workers run on the
    genome and index that this process saved once; at 1 the run stays in
    this process and saves nothing; both files equal the one-process run
    byte for byte."""
    from bsmap_tpu_torch import cli
    d = pool_data
    if not (d / "p2.fq").exists():
        simulate(d, genome_out="gp.fa", reads_out="p1.fq",
                 reads2_out="p2.fq", pe=True, n_reads=300, read_len=60,
                 chr_len=30000, n_chr=2, seed=33, error_rate=0.02)
    monkeypatch.chdir(d)
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.delenv("BSMAP_TPU_LOCAL_MP", raising=False)
    args = ["-a", "p1.fq", "-b", "p2.fq", "-d", "gp.fa", "-s", "12", "-S",
            "1", "-u", "--device", "cpu"]
    assert cli.run(args + ["-o", "one.bsp", "-2", "one_u.bsp", "-p",
                           "1"]) == 0
    capfd.readouterr()
    monkeypatch.setattr(cli, "_worker_cap", lambda o, g, i: cap)
    saved, save_index = [], cli.save_index
    monkeypatch.setattr(cli, "save_index",
                        lambda path, idx: saved.append(path)
                        or save_index(path, idx))
    assert cli.run(args + ["-o", "cap.bsp", "-2", "cap_u.bsp", "-p",
                           "3"]) == 0
    out = capfd.readouterr().out
    if cap == 2:
        assert "shard 0: 150 pairs" in out and "shard 1: 150 pairs" in out
        assert "merged 2 shards" in out and "shard 2" not in out
        assert len(saved) == 1 and "loading cached index" in out
    else:
        assert "shard" not in out and not saved
    for a, b in (("cap.bsp", "one.bsp"), ("cap_u.bsp", "one_u.bsp")):
        assert (d / a).read_bytes() == (d / b).read_bytes()
