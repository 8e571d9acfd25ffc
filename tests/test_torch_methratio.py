"""``python -m bsmap_tpu_torch.methratio`` and ``bsmap_tpu_torch.bsp2sam``
against ``bsmap_tpu``'s: byte-identical outputs on SAM, BSP and BAM written
by the port (``--device cpu``)."""

import pytest

from .conftest import simulate
from .test_torch_cli import _cli as _run

LONG = ["-u", "-r", "-t", "3", "-g", "-m", "2", "-z"]


@pytest.fixture(scope="module")
def meth_data(tmp_path_factory):
    """600 reads of 50 nt with 1% errors aligned by the port to SAM, BSP
    and BAM (one run each)."""
    d = tmp_path_factory.mktemp("torch_meth")
    simulate(d, genome_out="ref.fa", reads_out="reads.fq", n_reads=600,
             read_len=50, chr_len=30000, n_chr=2, seed=13, error_rate=0.01)
    for out in ("out.sam", "out.bsp", "out.bam"):
        _run(d, "bsmap_tpu_torch.cli",
             ["-a", "reads.fq", "-d", "ref.fa", "-o", out, "-S", "1", "-v",
              "2", "--device", "cpu"])
    return d


@pytest.mark.parametrize("src,extra", [
    ("out.sam", []), ("out.bsp", []), ("out.bam", []),
    ("out.sam", LONG), ("out.bsp", LONG), ("out.bam", LONG),
])
def test_torch_methratio_matches_jax(meth_data, src, extra):
    """The argument sets of test_aux_tools' methratio parity (none, and
    -u -r -t 3 -g -m 2 -z) on each input format: the port's output equals
    ``python -m bsmap_tpu.methratio``'s."""
    tag = f"{src}_{len(extra)}"
    outs = []
    for module in ("bsmap_tpu_torch.methratio", "bsmap_tpu.methratio"):
        outs.append(f"{module.split('.')[0]}_{tag}.txt")
        _run(meth_data, module,
             ["-d", "ref.fa", "-o", outs[-1], "-q"] + extra + [src])
    got, want = ((meth_data / x).read_bytes() for x in outs)
    assert got == want
    assert got.count(b"\n") > 100


def test_torch_methratio_reads_bam_as_sam(meth_data):
    """methratio on the port's BAM equals methratio on the same run's SAM
    (both per-chromosome sorted)."""
    for src in ("out.sam", "out.bam"):
        _run(meth_data, "bsmap_tpu_torch.methratio",
             ["-d", "ref.fa", "-o", f"m_{src}.txt", "-q", src])
    assert (meth_data / "m_out.sam.txt").read_bytes() == \
        (meth_data / "m_out.bam.txt").read_bytes()


def test_torch_bsp2sam_matches_jax(meth_data):
    """bsp2sam on the port's BSP: the port's SAM equals bsmap_tpu's."""
    for module in ("bsmap_tpu_torch.bsp2sam", "bsmap_tpu.bsp2sam"):
        _run(meth_data, module, ["-d", "ref.fa", "-o",
                                 f"{module.split('.')[0]}_b2s.sam", "-q",
                                 "out.bsp"])
    got = (meth_data / "bsmap_tpu_torch_b2s.sam").read_bytes()
    assert got == (meth_data / "bsmap_tpu_b2s.sam").read_bytes()
    assert got.startswith(b"@HD") and got.count(b"\n") > 500
