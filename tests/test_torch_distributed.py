"""Multi-process runs through the PyTorch port (``--device cpu``),
single-end: ``--nprocs`` read ranges with the aligner state rebuilt at each
boundary, a real torch.distributed (gloo) coordinator, ``.bam`` output and
``-p`` on a block path.  Every merged output equals the port's one-process
output and ``bsmap_tpu``'s ``--engine host`` output byte for byte
(pair-end and the ``-p`` workers: test_torch_multiproc.py)."""

import shutil
import socket
import subprocess
import sys

import pytest

from .conftest import simulate
from .test_torch_cli import MP_ENV

TIMEOUT = 600
SE = ["-a", "rm.fq", "-d", "g.fa", "-S", "1", "-v", "2", "-u"]


@pytest.fixture(scope="module")
def dist_data(tmp_path_factory):
    """tests/test_distributed.py's set: 1,500 reads, 50 and 51 nt mixed
    (the stale-schedule corner must survive the range cut); the port's
    one-process SAM (``one.sam``, the device engine) and bsmap_tpu's host
    engine's (``host.sam``)."""
    d = tmp_path_factory.mktemp("torch_dist")
    simulate(d, genome_out="g.fa", reads_out="r.fq", n_reads=1500,
             read_len=51, chr_len=30000, n_chr=2, seed=23, error_rate=0.02)
    raw = (d / "r.fq").read_text().splitlines()
    out = []
    for k in range(0, len(raw), 4):
        name, seq, plus, qual = raw[k: k + 4]
        if (k // 4) % 2 == 0:
            seq, qual = seq[:50], qual[:50]
        out += [name, seq, plus, qual]
    (d / "rm.fq").write_text("\n".join(out) + "\n")
    one_and_host(d, SE, "sam", ["--device", "cpu"])
    return d


def start(d, module, args):
    return subprocess.Popen([sys.executable, "-m", module] + args, cwd=d,
                            env=MP_ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def wait_all(procs) -> list[bytes]:
    """Wait for every process (a timeout each); kill what is left if one
    fails or times out.  Returns their stdouts."""
    outs = []
    try:
        for q in procs:
            out, err = q.communicate(timeout=TIMEOUT)
            assert q.returncode == 0, err.decode()
            outs.append(out)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    return outs


def run(d, module, args) -> bytes:
    return wait_all([start(d, module, args)])[0]


def nprocs(d, args, out, n=2, extra=()):
    """The port's --nprocs run of ``n`` processes (the last one first)."""
    procs = [start(d, "bsmap_tpu_torch.cli",
                    args + ["-o", out, "--nprocs", str(n), "--proc-id",
                            str(k), *extra]) for k in reversed(range(n))]
    return wait_all(procs)


def same(d, *names):
    first = (d / names[0]).read_bytes()
    assert len(first) > 64
    for x in names[1:]:
        assert (d / x).read_bytes() == first, (names[0], x)


def one_and_host(d, args, suffix, engine, unpaired=False):
    """The port's one-process output ``one.<suffix>`` (-p 1) and bsmap_tpu's
    host engine's ``host.<suffix>``; with ``unpaired``, their -2 files
    ``one_u.<suffix>`` and ``host_u.<suffix>`` too."""
    for module, tag, extra in (("bsmap_tpu_torch.cli", "one", engine),
                               ("bsmap_tpu.cli", "host",
                                ["--engine", "host"])):
        out = ["-o", f"{tag}.{suffix}"] + (
            ["-2", f"{tag}_u.{suffix}"] if unpaired else [])
        run(d, module, args + out + ["-p", "1", *extra])


@pytest.mark.parametrize("engine", [["--device", "cpu"],
                                    ["--engine", "host"]])
def test_torch_two_process_equals_one(dist_data, engine):
    """SE, two processes on the device engine and on the host engine."""
    out = f"two_{engine[1]}.sam"
    nprocs(dist_data, SE + engine, out)
    same(dist_data, "one.sam", out, "host.sam")


def test_torch_two_process_with_real_coordinator(dist_data):
    """--coordinator on a local port: the two processes join one gloo
    group (process 0 hosts its store) and leave it after the merge; the
    output equals the one-process run's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    nprocs(dist_data, SE + ["--engine", "host"], "two_coord.sam",
           extra=("--coordinator", f"127.0.0.1:{port}"))
    same(dist_data, "one.sam", "two_coord.sam", "host.sam")


def test_torch_nprocs_bam(dist_data):
    """--nprocs 2 -o x.bam: process 0 merges, then converts; the BAM and
    its index equal those the port's converter makes of the one-process
    SAM and of bsmap_tpu's host-engine SAM (a one-process .bam run is that
    SAM converted: test_torch_bam.py)."""
    from bsmap_tpu_torch.bamio import sam_to_bam
    nprocs(dist_data, SE + ["--device", "cpu"], "two_x.bam")
    for tag in ("one", "host"):
        shutil.copy(dist_data / f"{tag}.sam", dist_data / f"{tag}_x.bam")
        sam_to_bam(str(dist_data / f"{tag}_x.bam"))
    for suffix in ("", ".bai"):
        same(dist_data, f"one_x.bam{suffix}", f"two_x.bam{suffix}",
             f"host_x.bam{suffix}")


def test_torch_p_flag_bsp(dist_data):
    """-p 2 on SE BSP output (a block path: -p is a no-op there, as in
    bsmap_tpu) equals -p 1 and bsmap_tpu's host engine."""
    base = SE + ["--engine", "host"]
    for module, out, extra in (("bsmap_tpu_torch.cli", "p1.bsp", ["-p", "1"]),
                               ("bsmap_tpu_torch.cli", "p2.bsp", ["-p", "2"]),
                               ("bsmap_tpu.cli", "host_p.bsp", [])):
        run(dist_data, module, base + ["-o", out] + extra)
    same(dist_data, "p1.bsp", "p2.bsp", "host_p.bsp")


def test_torch_multihost_leaves_the_group_after_the_merge(dist_data,
                                                         monkeypatch):
    """With a coordinator, each runner joins the group first and, after
    process 0's merge, waits at a barrier and destroys the group (the
    calls recorded in place of torch.distributed's); without one it calls
    none of them."""
    import torch.distributed as tdist
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.parallel import distributed as dist
    calls = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", kw["rank"])))
    monkeypatch.setattr(tdist, "barrier", lambda: calls.append("barrier"))
    monkeypatch.setattr(tdist, "destroy_process_group",
                        lambda: calls.append("destroy"))
    merge = dist.merge_shards
    monkeypatch.setattr(dist, "merge_shards",
                        lambda *a, **kw: (calls.append("merge"),
                                          merge(*a, **kw)))
    monkeypatch.chdir(dist_data)
    for extra in (["--coordinator", "127.0.0.1:1"], []):
        calls.clear()
        for k in (1, 0):
            assert cli.run(SE + ["--engine", "host", "-o", "unit.sam",
                                 "--nprocs", "2", "--proc-id", str(k)]
                           + extra) == 0
        assert calls == ([("init", 1), "barrier", "destroy",
                          ("init", 0), "merge", "barrier", "destroy"]
                         if extra else ["merge"])
        same(dist_data, "one.sam", "unit.sam")
