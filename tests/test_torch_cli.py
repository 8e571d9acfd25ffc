"""Byte parity of the PyTorch port's CLI (``--device cpu``: the kernels'
plain twins) with ``bsmap_tpu``'s device and host engines, and the port's
refusals of what it does not run yet."""

import pathlib
import subprocess
import sys

import pytest

from .conftest import REPO, simulate
from .test_golden_se import assert_same

ENV = {"PYTHONPATH": str(REPO), "BSMAP_TPU_CPU_JIT_CACHE": "1",
       "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
       "BSMAP_TPU_DEV_BATCH": "2048", "BSMAP_TPU_CANDS_PER_READ": "16",
       "HOME": str(pathlib.Path.home()), "BSMAP_TPU_RANDR_SEED": "99"}


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
    return d


def _cli(d, module, args):
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=d,
                       capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()


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


@pytest.mark.parametrize("flags", [
    ["-b", "r2.fq"], ["-D", "C-CGG"], ["-n", "1"], ["-p", "2"],
    ["--nprocs", "2"], ["--engine", "sharded"], ["-o", "out.bam"],
])
def test_torch_cli_refuses_unported(flags):
    """Pair-end, RRBS, -n 1, multi-process, the sharded engines and BAM
    output exit non-zero with a pointer to ROADMAP.md (no silent engine
    or format substitution)."""
    from bsmap_tpu_torch import cli
    argv = ["-a", "r.fq", "-d", "ref.fa", "-o", "out.sam"] + flags
    with pytest.raises(SystemExit) as e:
        cli.run(argv)
    assert "unported" in str(e.value) and "ROADMAP" in str(e.value)


def test_torch_cuda_request_without_gpu_raises(monkeypatch, cli_data):
    """--device cuda without a CUDA device raises instead of running on the
    CPU or on the host engine."""
    import torch

    from bsmap_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-a", str(cli_data / "reads.fq"), "-d", str(cli_data / "ref.fa"),
            "-o", str(cli_data / "never.sam"), "-S", "1", "--device", "cuda"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(argv)
    assert not (cli_data / "never.sam").exists()
