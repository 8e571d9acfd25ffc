"""Byte parity of the PyTorch port's CLI (``--device cpu``: the kernels'
plain twins) with ``bsmap_tpu``'s device and host engines, single-end and
pair-end, the parsing of the multi-process and BAM options, and the port's
refusal of an engine it does not know."""

import pathlib
import subprocess
import sys

import pytest

from .conftest import REPO, simulate
from .test_golden_se import assert_same
from .test_pe_corners import repeat_pe_data  # noqa: F401 (fixture)

# BSMAP_TPU_LOCAL_MP=0: one process per run in both packages (the default
# -p 8 starts worker processes on RRBS, trimming, pair-end BSP and -R;
# their merge is held to these bytes in test_torch_distributed.py and
# test_torch_multiproc.py, which run them with MP_ENV)
ENV = {"PYTHONPATH": str(REPO), "BSMAP_TPU_CPU_JIT_CACHE": "1",
       "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
       "BSMAP_TPU_DEV_BATCH": "2048", "BSMAP_TPU_CANDS_PER_READ": "16",
       "HOME": str(pathlib.Path.home()), "BSMAP_TPU_RANDR_SEED": "99",
       "BSMAP_TPU_LOCAL_MP": "0"}
MP_ENV = {k: v for k, v in ENV.items() if k != "BSMAP_TPU_LOCAL_MP"}


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    simulate(d, genome_out="ref.fa", reads_out="reads.fq", n_reads=800,
             read_len=50, chr_len=40000, seed=21, error_rate=0.02)
    simulate(d, genome_out="ref3.fa", reads_out="reads100.fq", n_reads=600,
             read_len=100, chr_len=15000, n_chr=3, seed=22, error_rate=0.02)
    # 51 nt reads ((len - I + 1) % S == 0 for -s 16 -I 4) interleaved with
    # 50 nt: stale seed-schedule state, full result rows
    simulate(d, genome_out="refm.fa", reads_out="readsm_raw.fq", n_reads=600,
             read_len=51, chr_len=30000, seed=23, error_rate=0.02)
    raw = (d / "readsm_raw.fq").read_text().splitlines()
    out = []
    for k in range(0, len(raw), 4):
        name, seq, plus, qual = raw[k: k + 4]
        if (k // 4) % 2 == 0:
            seq, qual = seq[:50], qual[:50]
        out += [name, seq, plus, qual]
    (d / "readsm.fq").write_text("\n".join(out) + "\n")
    # pairs of 76 nt, and two sets with short inserts read into the
    # adapter (trimming): pa, and pt (same genome as pe) whose reads
    # include tails that a second FilterReads pass would trim again
    simulate(d, genome_out="refpe.fa", reads_out="pe1.fq",
             reads2_out="pe2.fq", pe=True, n_reads=400, read_len=76,
             chr_len=30000, n_chr=2, seed=24, error_rate=0.02)
    for name, ref, seed in (("pa", "refpa.fa", 26), ("pt", "refpe.fa", 24)):
        simulate(d, genome_out=ref, reads_out=f"{name}1.fq",
                 reads2_out=f"{name}2.fq", pe=True, n_reads=300,
                 read_len=76, chr_len=30000, n_chr=2, seed=seed,
                 error_rate=0.02, insert_min=50, insert_max=200,
                 adapter="AGATCGGAAGAGC")
    return d


def _cli(d, module, args):
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=d,
                       capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()


def _three_way(d, base, outs, monkeypatch=None):
    """Run the port (``--device cpu``) and both bsmap_tpu engines on
    ``base``; ``outs`` maps each -o/-2 flag to a file name and every output
    file must be byte-identical across the three runs.  With
    ``monkeypatch`` (pair-end), the port runs once more on its per-pair
    path (``_per_pair``), held to the same bytes."""
    runs = {"torch": ("bsmap_tpu_torch.cli", ["--device", "cpu"]),
            "device": ("bsmap_tpu.cli", ["--engine", "device"]),
            "host": ("bsmap_tpu.cli", ["--engine", "host"])}
    for tag, (module, extra) in runs.items():
        files = [x for flag, name in outs.items()
                 for x in (flag, f"{tag}_{name}")]
        _cli(d, module, base + files + extra)
    for name in outs.values():
        assert_same(d, f"host_{name}", f"torch_{name}")
        assert_same(d, f"device_{name}", f"torch_{name}")
    if monkeypatch is not None:
        _per_pair(d, base, outs, monkeypatch)


def _per_pair(d, base, outs, monkeypatch):
    """The port in this process on its pair-end per-pair path: the
    read-stripe engine on one CPU device (``--engine sharded``; a mesh
    engine, so not the block path), which must say so in ``pe_path``;
    every output file byte-identical to the host engine's ``host_*``."""
    from bsmap_tpu_torch import cli
    monkeypatch.chdir(d)
    monkeypatch.setenv("BSMAP_TPU_RANDR_SEED", ENV["BSMAP_TPU_RANDR_SEED"])
    files = [x for flag, name in outs.items()
             for x in (flag, f"pairs_{name}")]
    st = {}
    assert cli.run(base + files + ["--device", "cpu", "--engine", "sharded",
                                   "-p", "1"], stats=st) == 0
    assert st["pe_path"] == "pairs"
    for name in outs.values():
        assert_same(d, f"host_{name}", f"pairs_{name}")


@pytest.mark.parametrize("reads,ref,flags,suffix", [
    ("reads.fq", "ref.fa", ["-S", "1", "-v", "2", "-u"], "sam"),
    ("reads.fq", "ref.fa", ["-S", "0", "-v", "2", "-u"], "sam"),
    ("readsm.fq", "refm.fa", ["-S", "1", "-v", "2", "-u"], "sam"),
    ("reads100.fq", "ref3.fa", ["-S", "3", "-v", "4", "-u"], "bsp"),
    ("reads100.fq", "ref3.fa", ["-S", "1", "-v", "2", "-R", "-u"], "sam"),
    ("reads100.fq", "ref3.fa", ["-S", "2", "-v", "3", "-q", "20",
                                "-A", "AGATCGGAAGAGC"], "sam"),
])
def test_torch_cli_matches_jax_engines(cli_data, reads, ref, flags, suffix):
    """-S 1, -S 0 (pinned rand_r seed), -u, the stale-risk mixed-length set,
    BSP output, XR tags (-R) and adapter/quality trimming: the port's
    SAM/BSP bytes equal both bsmap_tpu engines'."""
    tag = f"{reads}_{'_'.join(flags)}".replace("-", "")
    base = ["-a", reads, "-d", ref] + flags
    outs = {"torch": f"t_{tag}.{suffix}", "device": f"d_{tag}.{suffix}",
            "host": f"h_{tag}.{suffix}"}
    _cli(cli_data, "bsmap_tpu_torch.cli",
         base + ["-o", outs["torch"], "--device", "cpu"])
    for eng in ("device", "host"):
        _cli(cli_data, "bsmap_tpu.cli",
             base + ["-o", outs[eng], "--engine", eng])
    assert_same(cli_data, outs["host"], outs["torch"])
    assert_same(cli_data, outs["device"], outs["torch"])


@pytest.mark.parametrize("pairs,ref,flags,suffix", [
    ("pe", "refpe.fa", ["-S", "1", "-v", "2", "-u"], "sam"),
    ("pe", "refpe.fa", ["-S", "0", "-v", "2", "-u"], "sam"),
    ("pe", "refpe.fa", ["-S", "3", "-v", "2", "-u", "-r", "0"], "sam"),
    ("pe", "refpe.fa", ["-S", "2", "-v", "3"], "bsp"),
    ("pe", "refpe.fa", ["-S", "1", "-v", "2", "-R", "-u"], "sam"),
    ("pa", "refpa.fa", ["-S", "2", "-v", "2", "-q", "20",
                        "-A", "AGATCGGAAGAGC", "-u"], "sam"),
])
def test_torch_cli_pe_matches_jax_engines(cli_data, pairs, ref, flags,
                                          suffix, monkeypatch):
    """Pair-end (-b): SAM with -S 1, -S 0 (pinned rand_r seed) and -r 0,
    BSP with the -2 unpaired file, XR tags (-R) and adapter/quality
    trimming: the port's bytes (the single-device engine's block path)
    equal both bsmap_tpu engines'.  BSP, -R and trimming run once more on
    the per-pair path (a mesh engine), held to the same bytes."""
    tag = f"{pairs}_{'_'.join(flags)}".replace("-", "")
    base = ["-a", f"{pairs}1.fq", "-b", f"{pairs}2.fq", "-d", ref] + flags
    outs = {"-o": f"{tag}.{suffix}"}
    if suffix == "bsp":
        outs["-2"] = f"{tag}_unpaired.bsp"
    per_pair = suffix == "bsp" or "-R" in flags or "-A" in flags
    _three_way(cli_data, base, outs, monkeypatch if per_pair else None)


def test_torch_cli_pe_replays_filter_once(cli_data):
    """A replayed pair is aligned with the reads as the first FilterReads
    pass left them.  In the pt set, read r82/1 ends, after its adapter is
    cut, in AGTTCG, which the adapter scan accepts again: a second pass
    would cut 6 more bases and lose the pair.  bsmap_tpu's device engine
    runs the second pass on replayed pairs (its SAM differs at that pair);
    the port's bytes equal the host engine's, which runs it once as the
    reference does."""
    base = ["-a", "pt1.fq", "-b", "pt2.fq", "-d", "refpe.fa", "-S", "2",
            "-v", "2", "-q", "20", "-A", "AGATCGGAAGAGC", "-u"]
    _cli(cli_data, "bsmap_tpu_torch.cli",
         base + ["-o", "torch_pt.sam", "--device", "cpu"])
    _cli(cli_data, "bsmap_tpu.cli",
         base + ["-o", "host_pt.sam", "--engine", "host"])
    assert_same(cli_data, "host_pt.sam", "torch_pt.sam")
    assert b"r82_chr2_1640\t83\t" in (cli_data / "torch_pt.sam").read_bytes()


def test_torch_cli_pe_repeat_corners(repeat_pe_data):
    """The repeat-heavy pairs of test_pe_corners (multi-hit pairs, the
    (chr, loc)-sorted unpaired fallback, mates with >K hits): the port's
    SAM equals both bsmap_tpu engines'."""
    base = ["-a", "p1.fq", "-b", "p2.fq", "-d", "g.fa", "-S", "17", "-v",
            "2", "-u"]
    _three_way(repeat_pe_data, base, {"-o": "rep.sam"})


def test_torch_cli_pe_per_pair_many_hits(tmp_path, monkeypatch):
    """The per-pair path (BSP with -2, a mesh engine) under -S 1 on pairs
    whose mates have twenty equal-best hits, more than the K = 16
    compacted ones: the unpaired draw may fall past the K hits (the pair
    replays, so the pick must not fail first).  The port's bytes equal the
    host engine's there, and on the block path (the single-device
    engine) too."""
    from .test_torch_pair import _rep_genome
    _rep_genome(tmp_path)
    base = ["-a", "rep_1.fq", "-b", "rep_2.fq", "-d", "rep.fa", "-S", "1",
            "-v", "2"]
    runs = (("torch", "bsmap_tpu_torch.cli", ["--device", "cpu"]),
            ("host", "bsmap_tpu.cli", ["--engine", "host"]))
    outs = {"-o": "rep.bsp", "-2": "rep_unpaired.bsp"}
    for tag, module, extra in runs:
        _cli(tmp_path, module, base + [x for flag, name in outs.items()
                                       for x in (flag, f"{tag}_{name}")]
             + extra)
    for name in outs.values():
        assert_same(tmp_path, f"host_{name}", f"torch_{name}")
    assert (tmp_path / "torch_rep.bsp").stat().st_size > 0
    _per_pair(tmp_path, base, outs, monkeypatch)


@pytest.mark.parametrize("flags", [["--engine", "tpu"]])
def test_torch_cli_refuses_unported(flags):
    """An engine name the port does not know exits non-zero with a pointer
    to ROADMAP.md (no silent engine substitution)."""
    from bsmap_tpu_torch import cli
    argv = ["-a", "r.fq", "-d", "ref.fa", "-o", "out.sam"] + flags
    with pytest.raises(SystemExit) as e:
        cli.run(argv)
    assert "unported" in str(e.value) and "ROADMAP" in str(e.value)


class _OutSam(Exception):
    """Raised in place of the genome load, carrying ``out_sam``."""


@pytest.mark.parametrize("flags", [
    ["--proc-id", "0"], ["--coordinator", "h:1"],
    ["-b", "r2.fq", "-o", "out.bam"],
    ["-p", "2"], ["--nprocs", "2"],
    ["-o", "out.bam"],
])
def test_torch_cli_parses_like_jax(flags, monkeypatch):
    """The multi-process options (-p, --nprocs, --proc-id, --coordinator)
    and a .bam output, single-end or pair-end, parse as bsmap_tpu parses
    them, and ``run`` picks the same output format for the suffix (the
    genome load is stopped, so no file is read)."""
    import bsmap_tpu.cli as jcli
    from bsmap_tpu_torch import cli
    argv = ["-a", "r.fq", "-d", "ref.fa", "-o", "out.sam"] + flags
    monkeypatch.delenv("BSMAP_TPU_INDEX_CACHE", raising=False)
    got = []
    for mod in (cli, jcli):
        o = mod.parse_args(argv)
        got.append((o.nprocs, o.proc_id, o.coordinator, o.param.num_procs,
                    o.out_file))

        def stop(path, p):
            raise _OutSam(p.out_sam)

        monkeypatch.setattr(mod, "load_genome", stop)
        with pytest.raises(_OutSam) as e:
            mod.run(argv)
        got[-1] += (e.value.args[0],)
    assert got[0] == got[1]
    assert got[0][-1] == (2 if "out.bam" in flags else 1)


def test_torch_cli_default_engine_matches_jax_default(cli_data):
    """With no --engine both packages run their ``auto`` choice: on one
    device the single-device engine.  The port's SE WGBS bytes equal
    ``python -m bsmap_tpu.cli``'s, and the port says on stderr which engine
    ran."""
    base = ["-a", "reads.fq", "-d", "ref.fa", "-S", "1", "-v", "2", "-u"]
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu_torch.cli"] + base
                       + ["-o", "auto_t.sam", "--device", "cpu"],
                       cwd=cli_data, capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()
    assert b"engine: device (--engine auto)" in r.stderr
    _cli(cli_data, "bsmap_tpu.cli", base + ["-o", "auto_j.sam"])
    assert_same(cli_data, "auto_j.sam", "auto_t.sam")


def test_torch_cli_engine_auto_is_device_on_one_device(cli_data):
    """--engine auto on one device is --engine device: the same bytes, and
    ``stats`` holds the engine object with the name of the engine that
    ran; over a mesh of two entries auto picks the read-stripe engine."""
    import torch

    from bsmap_tpu_torch import cli
    base = ["-a", str(cli_data / "reads100.fq"), "-d",
            str(cli_data / "ref3.fa"), "-S", "1", "-v", "2", "-u", "-s", "12",
            "--device", "cpu"]
    names = {}
    for tag, extra, mesh in (("auto", ["--engine", "auto"], None),
                             ("device", ["--engine", "device"], None),
                             ("mesh", [], [torch.device("cpu")] * 2)):
        st = {}
        assert cli.run(base + ["-o", str(cli_data / f"ea_{tag}.sam")] + extra,
                       stats=st, mesh=mesh) == 0
        names[tag] = (st["engine_name"], type(st["engine"]).__name__)
    assert names == {"auto": ("device", "DeviceEngine"),
                     "device": ("device", "DeviceEngine"),
                     "mesh": ("sharded", "ShardedDeviceEngine")}
    assert_same(cli_data, "ea_device.sam", "ea_auto.sam")
    assert_same(cli_data, "ea_device.sam", "ea_mesh.sam")


def test_torch_cuda_request_without_gpu_raises(monkeypatch, cli_data):
    """--device cuda without a CUDA device raises instead of running on the
    CPU or on the host engine, on every device engine."""
    import torch

    from bsmap_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-a", str(cli_data / "reads.fq"), "-d", str(cli_data / "ref.fa"),
            "-o", str(cli_data / "never.sam"), "-S", "1", "--device", "cuda"]
    for engine in ("auto", "device", "sharded", "index-sharded"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.run(argv + ["--engine", engine])
        assert not (cli_data / "never.sam").exists()
    # pair-end too
    argv = ["-a", str(cli_data / "pe1.fq"), "-b", str(cli_data / "pe2.fq"),
            "-d", str(cli_data / "refpe.fa"), "-o",
            str(cli_data / "never_pe.sam"), "-S", "1", "--device", "cuda"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(argv)
    assert not (cli_data / "never_pe.sam").exists()
