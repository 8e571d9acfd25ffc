"""The genome and read generators: one seed, one set of bytes; the CpG,
adapter and quality-tail shares the configuration and mixes state."""

import json
import os

import numpy as np

from conftest import tiny_cell


def test_genome_same_seed_same_bytes_and_shares():
    import genome
    import spec
    g = spec.load_cell("wgbs_se100").config["genome"]
    a = genome.make_chromosome(g, 3, 2_000_000)
    b = genome.make_chromosome(g, 3, 2_000_000)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, genome.make_chromosome(g, 4, 2_000_000))
    comp = np.bincount(a, minlength=4) / len(a)
    assert 0.39 < comp[1] + comp[2] < 0.43
    cpg = np.mean((a[:-1] == 1) & (a[1:] == 2)) / (comp[1] * comp[2])
    assert 0.12 < cpg < 0.35


def _reads(tmp_path, workload, tag, procs, n=3000):
    import genome
    import harness
    import reads
    cell = tiny_cell(workload, str(tmp_path / "cfg"))
    cache = str(tmp_path / "cache" / harness.genome_key(cell.config))
    genome.ensure_genome(cell.config, cache)
    out = tmp_path / f"r{tag}_{procs}"
    out.mkdir()
    paths = reads.write_reads(cell.config, cell.traffic, cache, str(out),
                              n=n, procs=procs)
    return cell, [open(p, "rb").read() for p in paths]


def test_reads_same_library_same_bytes(tmp_path):
    """A configuration and mix give one file, whatever the workers, and
    its records are numbered in file order."""
    _, a = _reads(tmp_path, "wgbs_pe100_trim", "a", 1)
    _, b = _reads(tmp_path, "wgbs_pe100_trim", "b", 2)
    assert a == b and len(a) == 2
    names = a[0].split(b"\n")[0::4][:3000]
    assert names == [b"@p%09d" % i for i in range(3000)]


def test_trim_mix_shares(tmp_path):
    cell, (r1, r2) = _reads(tmp_path, "wgbs_pe100_trim", 99, 1, n=20000)
    recs = r1.split(b"\n")
    seqs, quals = recs[1::4], recs[3::4]
    adapter = np.mean([b"AGATCGGAAGAGC" in s for s in seqs])
    # inserts uniform in 28-500: 72 of 473 lengths are under 100 nt, and a
    # read shows the adapter's first 13 bases where the insert is <= 87
    assert abs(adapter - 60 / 473) < 0.015
    tail40 = np.mean([q[40:41] == b"#" for q in quals])
    tail8 = np.mean([q[8:9] == b"#" for q in quals])
    assert abs(tail40 - 0.0525) < 0.008 and abs(tail8 - 0.0025) < 0.002
    assert r2.count(b"AGATCGGAAGAGCGTCGTG") > 0
