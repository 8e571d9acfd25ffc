"""BAM in and out through the PyTorch port's CLI (``--device cpu``: the
kernels' plain twins): the sorted, indexed ``.bam`` and its ``.bai`` equal
``bsmap_tpu``'s byte for byte, single-end, pair-end and ``-n 1``; a BAM as
``-a`` input aligns as in ``bsmap_tpu``; and the BAM holds the records of
the SAM the same run writes."""

import shutil

import pytest

from .conftest import simulate
from .test_torch_cli import _cli

SE = ["-a", "reads.fq", "-d", "ref.fa", "-S", "1", "-v", "2", "-u"]
PE = ["-a", "pe1.fq", "-b", "pe2.fq", "-d", "refpe.fa", "-S", "1", "-v",
      "2", "-u"]


@pytest.fixture(scope="module")
def bam_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bam")
    simulate(d, genome_out="ref.fa", reads_out="reads.fq", n_reads=800,
             read_len=50, chr_len=40000, n_chr=2, seed=31, error_rate=0.02)
    simulate(d, genome_out="refpe.fa", reads_out="pe1.fq",
             reads2_out="pe2.fq", pe=True, n_reads=300, read_len=76,
             chr_len=30000, n_chr=2, seed=32, error_rate=0.02)
    return d


def _port_and_jax(d, base, out):
    """The port on the CPU twins and bsmap_tpu's host engine write
    ``torch_<out>`` and ``host_<out>``."""
    _cli(d, "bsmap_tpu_torch.cli", base + ["-o", f"torch_{out}", "--device",
                                           "cpu"])
    _cli(d, "bsmap_tpu.cli", base + ["-o", f"host_{out}", "--engine",
                                     "host"])


def _same_bytes(d, a, b):
    assert (d / a).read_bytes() == (d / b).read_bytes(), (a, b)


@pytest.mark.parametrize("base,out", [(SE, "se.bam"), (PE, "pe.bam"),
                                      (SE + ["-n", "1"], "se_n1.bam")])
def test_torch_bam_output_matches_jax(bam_data, base, out):
    """SE, PE and SE -n 1 ``.bam`` output: the port's BAM and its index
    equal bsmap_tpu's byte for byte."""
    _port_and_jax(bam_data, base, out)
    for suffix in ("", ".bai"):
        _same_bytes(bam_data, f"host_{out}{suffix}", f"torch_{out}{suffix}")
    assert (bam_data / f"torch_{out}").read_bytes()[:2] == b"\x1f\x8b"


def test_torch_bam_holds_the_sam_records(bam_data):
    """``bam_sam_lines`` of the port's BAM is the body of the SAM that the
    same run writes, as a sorted multiset."""
    from bsmap_tpu_torch.bamio import bam_sam_lines
    for out in ("se.bam", "se.sam"):
        _cli(bam_data, "bsmap_tpu_torch.cli",
             SE + ["-o", f"rt_{out}", "--device", "cpu"])
    body = sorted(ln for ln in open(bam_data / "rt_se.sam")
                  if not ln.startswith("@"))
    assert len(body) > 700
    assert sorted(bam_sam_lines(str(bam_data / "rt_se.bam"))) == body


def test_torch_bam_input_matches_jax(bam_data):
    """``-a in.bam`` (single-end): a BAM made by the port's ``sam_to_bam``
    from a SAM is realigned by the port (the per-batch path of the device
    engine) as bsmap_tpu's host engine realigns it."""
    from bsmap_tpu_torch.bamio import sam_to_bam
    _cli(bam_data, "bsmap_tpu_torch.cli",
         SE + ["-o", "in_src.sam", "--device", "cpu"])
    shutil.copy(bam_data / "in_src.sam", bam_data / "in.bam")
    sam_to_bam(str(bam_data / "in.bam"))
    base = ["-a", "in.bam", "-d", "ref.fa", "-S", "1", "-v", "2", "-u"]
    _port_and_jax(bam_data, base, "from_bam.sam")
    _same_bytes(bam_data, "host_from_bam.sam", "torch_from_bam.sam")
    body = [ln for ln in open(bam_data / "torch_from_bam.sam")
            if not ln.startswith("@")]
    assert len(body) == 800


def test_torch_bam_index_failure_fails_the_run(tmp_path, monkeypatch):
    """The copied converter passes over an index build that raises
    (bamio.sam_to_bam); the port's conversion step raises instead of
    leaving a BAM without its index, or beside an older run's."""
    from bsmap_tpu_torch import bamio, cli
    sam = tmp_path / "x.bam"
    sam.write_text("@HD\tVN:1.0\n@SQ\tSN:chr1\tLN:100\n"
                   "r1\t0\tchr1\t5\t255\t4M\t*\t0\t0\tACGT\tIIII\n")
    (tmp_path / "x.bam.bai").write_bytes(b"an older run's index")

    def broken(path):
        raise OSError("disk full")

    monkeypatch.setattr(bamio, "build_bai", broken)
    with pytest.raises(RuntimeError, match="index"):
        cli._to_bam(str(sam), None)
    assert not (tmp_path / "x.bam.bai").exists()
