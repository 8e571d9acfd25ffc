"""Multi-process runs through the PyTorch port (``--device cpu``),
pair-end and the ``-p`` workers: ``--nprocs`` pair ranges with both mates'
aligner state rebuilt at each boundary, and ``-p 2`` on RRBS with trimming
(a per-read path, where -p spawns workers).  Every merged output equals the
port's one-process output and ``bsmap_tpu``'s ``--engine host`` output byte
for byte."""

import os
import subprocess
import sys

import pytest

from .conftest import REPO, simulate
from .test_torch_distributed import (nprocs, one_and_host, run, same,
                                     start, wait_all)

PE = ["-a", "ra.fq", "-b", "rb.fq", "-d", "gp.fa", "-S", "1", "-v", "2",
      "-u"]
RRBS = ["-a", "se.fq", "-d", "rrbs.fa", "-D", "C-CGG", "-S", "1", "-v", "2",
        "-u", "-A", "AGATCGGAAGAGC", "-q", "2"]


@pytest.fixture(scope="module")
def pe_data(tmp_path_factory):
    """tests/test_distributed.py's 900 pairs of 50 nt; the port's
    one-process SAM (the device engine's block path) and bsmap_tpu's host
    engine's."""
    d = tmp_path_factory.mktemp("torch_dist_pe")
    simulate(d, genome_out="gp.fa", reads_out="ra.fq", reads2_out="rb.fq",
             pe=True, n_reads=900, read_len=50, chr_len=30000, n_chr=2,
             seed=29, error_rate=0.02)
    one_and_host(d, PE, "sam", ["--device", "cpu"])
    return d


@pytest.mark.parametrize("engine", [["--device", "cpu"],
                                    ["--engine", "host"]])
def test_torch_two_process_pe_equals_one(pe_data, engine):
    """--nprocs with -b runs the pair path per range, both mates' states
    rebuilt (on the device engine: the block path)."""
    out = f"two_{engine[1]}.sam"
    nprocs(pe_data, PE + engine, out)
    same(pe_data, "one.sam", out, "host.sam")


def test_torch_p_flag_pe_bsp_unpaired(pe_data):
    """-p 2 on pair-end BSP with -2 (the per-pair path): two workers, and
    process 0 merges both the pair file and the unpaired file."""
    engine = ["--device", "cpu"]
    one_and_host(pe_data, PE, "bsp", engine, unpaired=True)
    log = run(pe_data, "bsmap_tpu_torch.cli",
              PE + engine + ["-o", "p2.bsp", "-2", "p2_u.bsp", "-p", "2"])
    assert b"shard 1: 450 pairs" in log
    same(pe_data, "one.bsp", "p2.bsp", "host.bsp")
    same(pe_data, "one_u.bsp", "p2_u.bsp", "host_u.bsp")


def test_torch_p_flag_rrbs_trim_spawns_workers(tmp_path):
    """-p 2 on RRBS with -A and -q (a per-read path): two worker processes
    on the device engine, each on its range; the merged SAM equals the
    one-process run and bsmap_tpu's host engine."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    chip_smoke.make_rrbs_set(tmp_path, n_reads=600)
    engine = ["--device", "cpu"]
    one_and_host(tmp_path, RRBS, "sam", engine)
    log = run(tmp_path, "bsmap_tpu_torch.cli",
              RRBS + engine + ["-o", "p2.sam", "-p", "2"])
    assert b"shard 0: 300 reads" in log and b"shard 1: 300 reads" in log
    assert b"merged 2 shards" in log
    same(tmp_path, "one.sam", "p2.sam", "host.sam")
    assert not [x for x in os.listdir(tmp_path) if ".shard" in x]



# ROADMAP C1's inputs: 500 simulated reads (pairs) with errors and an
# adapter; -B/-E windows cut from the middle and the end of the file
C1_SIM = dict(seed=5, n_chr=2, chr_len=30000, n_reads=500, read_len=60,
              error_rate=0.03, adapter="AGATCGGAAGAGC")
C1_RRBS = ["-a", "r.fq", "-d", "g.fa", "-D", "C-CGG", "-S", "1", "-u",
           "-A", "AGATCGGAAGAGC", "-q", "2"]
C1_PE = ["-a", "pa.fq", "-b", "pb.fq", "-d", "gp.fa", "-S", "1", "-u"]
C1_CASES = {
    "rrbs_trim_B": (C1_RRBS + ["-B", "20"], "sam"),
    "rrbs_trim_B_E": (C1_RRBS + ["-B", "20", "-E", "200"], "sam"),
    "pe_bsp_B": (C1_PE + ["-B", "50"], "bsp"),
    "pe_bsp_B_E": (C1_PE + ["-B", "50", "-E", "300"], "bsp"),
}


@pytest.fixture(scope="module")
def c1_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_c1")
    simulate(d, genome_out="g.fa", reads_out="r.fq", **C1_SIM)
    simulate(d, genome_out="gp.fa", reads_out="pa.fq", reads2_out="pb.fq",
             pe=True, **C1_SIM)
    return d


@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_torch_multiproc_keeps_the_read_window(c1_data, case):
    """ROADMAP C1: -p 3 workers and --nprocs 2 under -B (and -B/-E) write
    every read (pair) of the window, byte for byte what bsmap_tpu's host
    engine writes in one process.  Each range is planned inside the window
    over the whole file's read count; counting under -B/-E gave the
    window's size, so the last B - 1 reads (pairs) went missing."""
    args, suffix = C1_CASES[case]
    pe = "-b" in args

    def out(tag):
        return ["-o", f"{case}_{tag}.{suffix}"] + (
            ["-2", f"{case}_{tag}_u.{suffix}"] if pe else [])

    engine = ["--device", "cpu"]
    procs = [start(c1_data, "bsmap_tpu.cli",
                   args + out("host") + ["-p", "1", "--engine", "host"]),
             start(c1_data, "bsmap_tpu_torch.cli",
                   args + engine + out("p3") + ["-p", "3"])]
    procs += [start(c1_data, "bsmap_tpu_torch.cli",
                    args + engine + out("n2") + ["--nprocs", "2",
                                                 "--proc-id", str(k)])
              for k in (1, 0)]
    wait_all(procs)
    same(c1_data, *(f"{case}_{t}.{suffix}" for t in ("host", "p3", "n2")))
    if pe:
        same(c1_data, *(f"{case}_{t}_u.{suffix}"
                        for t in ("host", "p3", "n2")))
    assert not [x for x in os.listdir(c1_data) if ".shard" in x]


class _Worker:
    """A stand-in for a worker process: ``fails`` exits non-zero at once,
    otherwise it runs until killed."""

    def __init__(self, fails: bool):
        self.fails, self.killed = fails, False

    def poll(self):
        return 1 if self.fails else (-9 if self.killed else None)

    def kill(self):
        self.killed = True

    def wait(self):
        return self.poll()


def test_torch_local_workers_stop_after_a_second_failure(tmp_path,
                                                          monkeypatch):
    """-p 2: a worker that fails is started once more; when it fails
    again the run stops the other worker (which would wait for its shard
    in the merge), removes the shards and exits non-zero."""
    from bsmap_tpu_torch import cli
    started = []

    def popen(cmd, **kw):
        k = int(cmd[cmd.index("--proc-id") + 1])
        started.append(_Worker(fails=k == 1))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    out = tmp_path / "fail.sam"
    (tmp_path / "fail.sam.shard1.tmp").write_text("partial")
    o = cli.parse_args(RRBS + ["-o", str(out), "-p", "2"])
    with pytest.raises(SystemExit) as e:
        cli.run_local_multiprocess(o, RRBS + ["-o", str(out), "-p", "2"])
    assert "failed after retry" in str(e.value)
    assert [w.fails for w in started] == [False, True, True]
    assert started[0].killed
    assert not (tmp_path / "fail.sam.shard1.tmp").exists()
