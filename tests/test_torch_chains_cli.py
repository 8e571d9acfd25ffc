"""Byte parity of the PyTorch port's CLI with -n 1 (all four strands):
the port on ``--device cpu`` (the kernels' plain twins) against
``bsmap_tpu``'s device and host engines, single-end, pair-end and SE RRBS,
and the port's ``--engine host`` against ``bsmap_tpu``'s.

Data: ``tools/simulate.py`` reads with every second read
reverse-complemented (plus exact reads of an A/T-only chromosome, which
map on both chains at one locus), a 50/51 nt set whose schedules read stale
state, pairs with every second pair's mates swapped and every 8th pair cut
to 51 nt (host replays), and the MspI digest of
``chip_smoke.make_rrbs_set`` with every second read reverse-complemented.
"""

import pytest

from chip_smoke import make_rrbs_set

from .conftest import simulate
from .test_golden_se import assert_same
from .test_torch_chains import (add_at_chromosome, revcomp_every_second,
                                swap_every_second_pair)
from .test_torch_cli import _cli, _three_way


@pytest.fixture(scope="module")
def nd_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chains_cli")
    simulate(d, genome_out="ref.fa", reads_out="r100.fq", n_reads=400,
             read_len=100, chr_len=20000, n_chr=2, seed=42, error_rate=0.02)
    simulate(d, genome_out="ref.fa", reads_out="r51.fq", n_reads=300,
             read_len=51, chr_len=20000, n_chr=2, seed=42, error_rate=0.02)
    at = add_at_chromosome(d, "ref.fa", 20)
    revcomp_every_second(d / "r100.fq", d / "nd.fq", at)
    raw = (d / "r51.fq").read_text().splitlines()
    for k in range(0, len(raw), 8):          # every second read to 50 nt
        raw[k + 1], raw[k + 3] = raw[k + 1][:50], raw[k + 3][:50]
    (d / "ndm_raw.fq").write_text("\n".join(raw) + "\n")
    revcomp_every_second(d / "ndm_raw.fq", d / "ndm.fq")
    simulate(d, genome_out="refpe.fa", reads_out="p1r.fq",
             reads2_out="p2r.fq", pe=True, n_reads=300, read_len=76,
             chr_len=30000, n_chr=2, seed=24, error_rate=0.02)
    swap_every_second_pair(d, "p1r.fq", "p2r.fq", "p1.fq", "p2.fq",
                           cut_every=8)
    make_rrbs_set(d, n_reads=500)
    revcomp_every_second(d / "se.fq", d / "rr.fq")
    return d


@pytest.mark.parametrize("reads,flags,suffix", [
    ("nd.fq", ["-S", "1", "-v", "2", "-u"], "sam"),
    ("nd.fq", ["-S", "3", "-v", "4"], "bsp"),
    ("nd.fq", ["-S", "0", "-v", "2", "-u"], "sam"),
    ("ndm.fq", ["-S", "1", "-v", "2", "-R", "-u"], "sam"),
    ("ndm.fq", ["-S", "2", "-v", "2", "-r", "0", "-u"], "sam"),
])
def test_torch_cli_n1_matches_jax_engines(nd_data, reads, flags, suffix):
    """SE -n 1: SAM -u, BSP, -S 0 (pinned rand_r seed), and on the
    stale-schedule 50/51 nt set (full rows carrying both chains' start
    offsets into the MateState sync) XR tags and -r 0: the port's bytes
    equal both bsmap_tpu engines'."""
    tag = f"{reads}_{'_'.join(flags)}".replace("-", "")
    base = ["-a", reads, "-d", "ref.fa", "-n", "1"] + flags
    _three_way(nd_data, base, {"-o": f"{tag}.{suffix}"})


@pytest.mark.parametrize("flags,suffix", [
    (["-S", "1", "-v", "2", "-u"], "sam"),       # block path
    (["-S", "3", "-v", "3"], "bsp"),             # both paths, -2
])
def test_torch_cli_pe_n1_matches_jax_engines(nd_data, flags, suffix,
                                             monkeypatch):
    """PE -n 1 on swapped pairs, every 8th cut to 51 nt (their pairs replay
    on the host after a MateState sync of both chains): the block path
    (SAM, and BSP with -2) and the per-pair path (BSP with -2, a mesh
    engine) equal both bsmap_tpu engines' bytes."""
    tag = "pe_" + "_".join(flags).replace("-", "")
    base = ["-a", "p1.fq", "-b", "p2.fq", "-d", "refpe.fa", "-n", "1"] + flags
    outs = {"-o": f"{tag}.{suffix}"}
    if suffix == "bsp":
        outs["-2"] = f"{tag}_unpaired.bsp"
    _three_way(nd_data, base, outs,
               monkeypatch if suffix == "bsp" else None)


@pytest.mark.parametrize("flags,suffix", [
    (["-S", "1", "-v", "2", "-u"], "sam"),
    (["-S", "2", "-v", "4", "-u"], "bsp"),
])
def test_torch_cli_rrbs_n1_matches_jax_engines(nd_data, flags, suffix):
    """SE RRBS -n 1 (-D C-CGG; the rc chain's probes shifted by len % S,
    its tag classes counted from the read's other end): SAM with ZP/ZL and
    BSP equal both bsmap_tpu engines' bytes."""
    tag = "rr_" + "_".join(flags).replace("-", "")
    base = ["-a", "rr.fq", "-d", "rrbs.fa", "-D", "C-CGG", "-n", "1"] + flags
    _three_way(nd_data, base, {"-o": f"{tag}.{suffix}"})


@pytest.mark.parametrize("base", [
    ["-a", "nd.fq", "-d", "ref.fa", "-S", "1", "-v", "2", "-u"],
    ["-a", "p1.fq", "-b", "p2.fq", "-d", "refpe.fa", "-S", "1", "-v", "2"],
])
def test_torch_cli_host_engine_n1(nd_data, base):
    """--engine host -n 1, single-end and pair-end: the port's copied host
    engines equal bsmap_tpu's."""
    for name, module in (("torch", "bsmap_tpu_torch.cli"),
                         ("jax", "bsmap_tpu.cli")):
        _cli(nd_data, module, base + ["-n", "1", "-o", f"host_{name}.sam",
                                      "--engine", "host"])
    assert_same(nd_data, "host_jax.sam", "host_torch.sam")
    assert (nd_data / "host_torch.sam").stat().st_size > 10000
