"""A seeded differential check of the PyTorch port against ``bsmap_tpu
--engine host -p 1``, on reads ``tools/simulate.py`` never writes: N-rich,
with low-quality tails, read into the adapter, of mixed lengths
(``test_torch_qc_lines.rough_reads``), single-end, pair-end and RRBS.

The option sets were drawn once from the CLI's space (-S, -v, -s, -A, -q,
-z, -u, -n 1, -r 0, -L, -f, -w, -M GA, -m/-x, -B/-E, -I, -R, SAM or BSP,
the engine) and fixed here, each its own case; every output file must be
byte-identical.  The frozen ``bsmap_tpu`` prints single-end BSP QC lines
forward on its device engine (ROADMAP C), so its host engine is the only
oracle.  The port runs in this process (``--device cpu``), but the -p 3
case, whose CLI starts its own worker processes."""

import subprocess
import sys

import pytest
import torch

from chip_smoke import make_rrbs_set

from .conftest import simulate
from .test_golden_se import assert_same
from .test_torch_cli import ENV, MP_ENV
from .test_torch_qc_lines import ADAPTER, rough_reads

SE = ["-a", "se.fq", "-d", "ref.fa"]
PE = ["-a", "pe1.fq", "-b", "pe2.fq", "-d", "refpe.fa"]
RRBS = ["-a", "rr.fq", "-d", "rrbs.fa", "-D", "C-CGG"]
# (id, input and flags, output suffix, the port's engine: None for auto,
# or "p3" for three worker processes)
CASES = [
    ("se_bsp_trim", SE + ["-S", "1", "-v", "3", "-s", "12", "-A", ADAPTER,
                          "-q", "20", "-u"], "bsp", None),
    ("se_xr_L70_f2", SE + ["-S", "2", "-v", "4", "-s", "14", "-R", "-u",
                           "-f", "2", "-L", "70"], "sam", None),
    ("se_bsp_r0_w5_sharded", SE + ["-S", "17", "-v", "2", "-s", "12", "-r",
                                   "0", "-w", "5", "-u", "-q", "2"], "bsp",
     "sharded"),
    ("se_sam_n1_GA_index_sharded", SE + ["-S", "1", "-v", "5", "-s", "12",
                                         "-n", "1", "-M", "GA", "-u"], "sam",
     "index-sharded"),
    ("se_bsp_B37_E260_p3", SE + ["-S", "2", "-v", "3", "-s", "12", "-A",
                                 ADAPTER, "-u", "-B", "37", "-E", "260"],
     "bsp", "p3"),
    # reads with Ns in their first 61 bases, one seed short of the
    # pigeonhole count at -v 1: never on the fixed schedule
    ("se_sam_v1_L61", SE + ["-S", "17", "-v", "1", "-s", "12", "-L", "61",
                            "-u"], "sam", None),
    ("se_bsp_S0_z40", SE + ["-S", "0", "-v", "2", "-s", "12", "-u", "-z",
                            "40", "-q", "20"], "bsp", None),
    ("se_sam_I2_host", SE + ["-S", "1", "-v", "6", "-s", "12", "-I", "2",
                             "-u", "-A", ADAPTER], "sam", "host"),
    ("pe_sam_trim_mx", PE + ["-S", "1", "-v", "3", "-s", "12", "-A",
                             ADAPTER, "-q", "20", "-u", "-m", "40", "-x",
                             "300"], "sam", None),
    ("pe_bsp_xr", PE + ["-S", "2", "-v", "4", "-s", "14", "-R", "-u"],
     "bsp", None),
    ("pe_sam_n1_f3_sharded", PE + ["-S", "17", "-v", "2", "-s", "12", "-n",
                                   "1", "-u", "-f", "3"], "sam", "sharded"),
    ("rrbs_bsp_trim", RRBS + ["-S", "1", "-v", "3", "-s", "12", "-A",
                              ADAPTER, "-q", "20", "-u"], "bsp", None),
    ("rrbs_xr_mx", RRBS + ["-S", "2", "-v", "2", "-s", "10", "-R", "-u",
                           "-m", "60", "-x", "200", "-q", "2"], "sam", None),
]


@pytest.fixture(scope="module")
def rough(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_diff")
    simulate(d, genome_out="ref.fa", reads_out="raw.fq", n_reads=500,
             read_len=90, chr_len=20000, n_chr=3, seed=41, error_rate=0.01)
    rough_reads(d / "raw.fq", d / "se.fq", seed=41)
    simulate(d, genome_out="refpe.fa", reads_out="raw1.fq",
             reads2_out="raw2.fq", pe=True, n_reads=300, read_len=76,
             chr_len=20000, n_chr=2, seed=42, error_rate=0.01, insert_min=50,
             insert_max=300, adapter=ADAPTER)
    rough_reads(d / "raw1.fq", d / "pe1.fq", seed=42)
    rough_reads(d / "raw2.fq", d / "pe2.fq", seed=43)
    make_rrbs_set(str(d), n_reads=400)
    rough_reads(d / "se.fq", d / "rr.fq", seed=44)     # make_rrbs_set's
    rough_reads(d / "raw.fq", d / "se.fq", seed=41)    # written over
    return d


@pytest.mark.parametrize("case,argv,suffix,engine", CASES,
                         ids=[c[0] for c in CASES])
def test_port_matches_host_engine(rough, monkeypatch, case, argv, suffix,
                                  engine):
    """Every output file (with ``-2`` for pair-end BSP) byte-identical to
    ``bsmap_tpu --engine host -p 1``'s."""
    from bsmap_tpu_torch import cli
    d = rough
    outs = {"-o": suffix} | ({"-2": "u.bsp"} if "-b" in argv
                             and suffix == "bsp" else {})

    def files(tag):
        return [x for flag, name in outs.items()
                for x in (flag, f"{tag}_{case}.{name}")]

    r = subprocess.run([sys.executable, "-m", "bsmap_tpu.cli"] + argv
                       + files("host") + ["--engine", "host", "-p", "1"],
                       cwd=d, capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()
    if engine == "p3":
        r = subprocess.run([sys.executable, "-m", "bsmap_tpu_torch.cli"]
                           + argv + files("port") + ["--device", "cpu", "-p",
                                                     "3"], cwd=d,
                           capture_output=True, env=MP_ENV)
        assert r.returncode == 0, r.stderr.decode()
        assert r.stderr.decode().count("engine: device") == 3
    else:
        monkeypatch.chdir(d)
        monkeypatch.setenv("BSMAP_TPU_RANDR_SEED",
                           ENV["BSMAP_TPU_RANDR_SEED"])
        extra = ["--engine", engine] if engine else []
        mesh = [torch.device("cpu")] * 2 if engine in ("sharded",
                                                      "index-sharded") \
            else None
        assert cli.run(argv + files("port") + extra + ["--device", "cpu",
                                                       "-p", "1"],
                       mesh=mesh) == 0
    for name in outs.values():
        assert_same(d, f"host_{case}.{name}", f"port_{case}.{name}")


@pytest.mark.parametrize("extra", [["--device", "cpu", "-p", "3"],
                                   ["--engine", "host", "-p", "2"]],
                         ids=["workers_cpu", "workers_host"])
def test_bam_input_under_workers_matches_host(rough, monkeypatch, extra):
    """SAM/BAM input with trimming starts ``-p`` workers (the per-read
    path), whose read count and range-start state read the BAM through its
    own stream (``count_reads``, ``_reconstruct_into``): BSP ``-u`` from a
    BAM of the N-rich reads is byte-identical to ``bsmap_tpu --engine host
    -p 1`` on the same BAM."""
    from bsmap_tpu_torch import cli
    d = rough
    monkeypatch.chdir(d)
    if not (d / "in.bam").exists():
        assert cli.run(SE + ["-S", "1", "-v", "3", "-s", "12", "-u", "-o",
                             "in.bam", "--device", "cpu", "-p", "1"]) == 0
    base = ["-a", "in.bam", "-d", "ref.fa", "-S", "2", "-v", "3", "-s",
            "12", "-q", "20", "-u"]
    tag = extra[1]
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu.cli"] + base
                       + ["-o", f"host_bam_{tag}.bsp", "--engine", "host",
                          "-p", "1"], cwd=d, capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu_torch.cli"] + base
                       + ["-o", f"port_bam_{tag}.bsp"] + extra, cwd=d,
                       capture_output=True, env=MP_ENV)
    assert r.returncode == 0, r.stderr.decode()
    assert_same(d, f"host_bam_{tag}.bsp", f"port_bam_{tag}.bsp")
    assert r.stderr.decode().count("range start") == int(extra[-1]) - 1
