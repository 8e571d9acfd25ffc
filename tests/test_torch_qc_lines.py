"""QC lines of single-end BSP output (``-u``) in the PyTorch port.

The reference prints a QC (filtered) read's BSP line in the orientation of
the ``hits[0][0]`` slot that leaks from the last read with a level-0
forward hit (``SamFormatter.stale_h00``, output/sam.py ``_out_bsp``): after
a read whose best exact hit lay on a Crick strand, a QC line is the read
reverse-complemented, its quality string reversed.  The port carries that
slot through the native block path in read order
(``DeviceEngine._carry_stale_h00``, ``bsmap_format_bsp_block``) and, under
``-p`` workers and ``--nprocs``, into each range from the reads before it
(``distributed.reconstruct_format_state``).  ``bsmap_tpu --engine device``
prints every QC line forward (the frozen package keeps that fault), so
each case is held to ``bsmap_tpu --engine host -p 1`` alone.

The data is N-rich, trimmed and of mixed lengths (``rough_reads``), which
``tools/simulate.py`` never writes.  Pair-end output needs none of this: a
filtered mate prints with the hit (0, 0) (output/pair_sam.py), so its
lines never take a stale strand."""

import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from chip_smoke import make_rrbs_set

from .conftest import simulate
from .test_golden_se import assert_same
from .test_torch_cli import ENV, MP_ENV

ADAPTER = "AGATCGGAAGAGC"
# mismatch budget 3, seed 12 (a small k-mer table), trimming at quality 20
WGBS = ["-S", "1", "-v", "3", "-u", "-s", "12"]
TRIM = ["-A", ADAPTER, "-q", "20"]


def rough_reads(src, dst, seed: int, adapter: str = ADAPTER) -> None:
    """Rewrite FASTQ ``src`` into ``dst`` with a numpy ``seed``: 6% of the
    reads get 6-9 Ns (QC under the default ``-f 5``), 6% get 1-5 Ns, 4%
    quality 2 from base 8 (QC under ``-q 20``: trimmed below the seed), 8%
    a quality-2 tail from base 40-75, 6% the adapter from base 30-70 and
    12% are cut to 55-89 bases."""
    rng = np.random.RandomState(seed)
    lines = src.read_text().splitlines()
    out = []
    for k in range(0, len(lines), 4):
        name, seq, plus, qual = lines[k: k + 4]
        seq, qual = list(seq), list(qual)
        kind = rng.choice(7, p=[0.06, 0.06, 0.04, 0.08, 0.06, 0.12, 0.58])
        if kind in (0, 1):
            n_ns = rng.randint(6, 10) if kind == 0 else rng.randint(1, 6)
            for i in rng.choice(len(seq), n_ns, replace=False):
                seq[i] = "N"
        elif kind in (2, 3):
            start = 8 if kind == 2 else rng.randint(40, 76)
            qual[start:] = "#" * (len(qual) - start)
        elif kind == 4:
            at = rng.randint(30, 71)
            tail = adapter + "".join(rng.choice(list("ACGT"), len(seq)))
            seq[at:] = tail[: len(seq) - at]
        elif kind == 5:
            cut = rng.randint(55, 90)
            seq, qual = seq[:cut], qual[:cut]
        out += [name, "".join(seq), plus, "".join(qual)]
    dst.write_text("\n".join(out) + "\n")


def alternating(src, dst, n: int, qc_run=()) -> None:
    """``dst``: ``n`` reads, each odd one (1-based) a Crick read of the
    error-free FASTQ ``src`` and each even one the read before it with its
    first 10 bases set to N (QC); the reads numbered in ``qc_run`` are all
    QC, so a walk back from after them passes its first window."""
    lines = src.read_text().splitlines()
    crick = [lines[k: k + 4] for k in range(0, len(lines), 4)
             if lines[k].endswith("_-")]
    out = []
    for i in range(1, n + 1):
        name, seq, plus, qual = crick[(i - 1) // 2]
        if i % 2 == 0 or i in qc_run:
            name, seq = f"{name}_qc{i}", "N" * 10 + seq[10:]
        out += [name, seq, plus, qual]
    dst.write_text("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def qc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_qc")
    simulate(d, genome_out="ref.fa", reads_out="raw.fq", n_reads=600,
             read_len=90, chr_len=20000, n_chr=3, seed=33,
             error_rate=0.005)
    rough_reads(d / "raw.fq", d / "qc.fq", seed=33)
    simulate(d, genome_out="refa.fa", reads_out="exact.fq", n_reads=500,
             read_len=90, chr_len=20000, n_chr=3, seed=34, error_rate=0)
    alternating(d / "exact.fq", d / "alt.fq", 300)
    alternating(d / "exact.fq", d / "alt298.fq", 298,
                qc_run=range(121, 150))
    # read 76, the start of -p 4's second range, aligned at chr1:1
    lines = (d / "alt.fq").read_text().splitlines()
    genome = (d / "refa.fa").read_text().split(">")[1].splitlines()
    lines[4 * 75: 4 * 76] = ["@chr1_start", "".join(genome[1:])[:90]
                             .replace("C", "T"), "+", "I" * 90]
    (d / "start.fq").write_text("\n".join(lines) + "\n")
    make_rrbs_set(str(d), n_reads=500)
    rough_reads(d / "se.fq", d / "rrqc.fq", seed=35)
    return d


def _host(d, args, out):
    """``bsmap_tpu --engine host -p 1`` (the oracle) into ``out``."""
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu.cli"] + args
                       + ["-o", out, "--engine", "host", "-p", "1"],
                       cwd=d, capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()


def _port(d, args, out, monkeypatch, mesh=None, stats=None):
    """The port in this process on the CPU (``--device cpu``, ``-p 1``)."""
    from bsmap_tpu_torch import cli
    monkeypatch.chdir(d)
    monkeypatch.setenv("BSMAP_TPU_RANDR_SEED", ENV["BSMAP_TPU_RANDR_SEED"])
    assert cli.run(args + ["-o", out, "--device", "cpu", "-p", "1"],
                   stats=stats, mesh=mesh) == 0


def _read_seqs(path):
    """Read name -> sequence of a FASTQ file."""
    lines = path.read_text().splitlines()
    return {lines[k][1:]: lines[k + 1] for k in range(0, len(lines), 4)}


@pytest.mark.parametrize("case,reads,ref,flags,engine", [
    ("device", "qc.fq", "ref.fa", WGBS, None),
    ("device_trim", "qc.fq", "ref.fa", WGBS + TRIM, None),
    ("sharded", "qc.fq", "ref.fa", WGBS + TRIM, "sharded"),
    ("index_sharded", "qc.fq", "ref.fa", WGBS + TRIM, "index-sharded"),
    ("n1", "qc.fq", "ref.fa", WGBS + TRIM + ["-n", "1"], None),
    ("rrbs", "rrqc.fq", "rrbs.fa", WGBS + TRIM + ["-D", "C-CGG"], None),
    ("sam_xr", "qc.fq", "ref.fa", WGBS + TRIM + ["-R"], None),
])
def test_block_path_qc_lines_match_host(qc_data, monkeypatch, case, reads,
                                        ref, flags, engine):
    """F1: single-end BSP ``-u`` on the native block path (the device
    engine, both mesh engines on a two-entry CPU mesh, ``-n 1``, RRBS)
    equals ``bsmap_tpu --engine host -p 1`` byte for byte, QC lines
    included; ``-R`` SAM, whose QC lines never turn, stays equal too."""
    d = qc_data
    suffix = "sam" if "-R" in flags else "bsp"
    base = ["-a", reads, "-d", ref] + flags
    _host(d, base, f"host_{case}.{suffix}")
    mesh = None
    if engine:
        base += ["--engine", engine]
        mesh = [torch.device("cpu")] * 2
    st = {}
    _port(d, base, f"port_{case}.{suffix}", monkeypatch, mesh, st)
    assert st["engine_name"] == (engine or "device")
    assert_same(d, f"host_{case}.{suffix}", f"port_{case}.{suffix}")
    # the replays ran on the native host aligner, RRBS's on the Python one
    eng = st["engine"]
    assert eng.host_native == (0 if case == "rrbs" else eng.n_replayed)
    if case == "device_trim":
        assert eng.n_replayed > 0
    if suffix == "bsp":
        # the set makes QC lines of both orientations (a trimmed read
        # prints its kept prefix, or that prefix reverse-complemented)
        raw = _read_seqs(d / reads)
        qc = [f for f in (ln.split("\t") for ln in
                          (d / f"host_{case}.bsp").read_text().splitlines())
              if f[3] == "QC"]
        turned = sum(f[1] != raw[f[0]][: len(f[1])] for f in qc)
        assert len(qc) >= 10 and 0 < turned < len(qc), (len(qc), turned)


@pytest.mark.parametrize("case,extra", [
    ("workers_cpu", ["--device", "cpu"]),
    ("workers_host", ["--engine", "host"]),
])
def test_worker_range_starts_take_the_stale_slot(qc_data, case, extra):
    """F2: ``-p 4`` workers over the alternating set (an exact Crick read,
    then a QC copy of it): the second and fourth ranges start on a QC read
    (76, 226) whose line a single process prints reverse-complemented.
    Both are byte-identical to ``bsmap_tpu --engine host -p 1``."""
    d = qc_data
    base = ["-a", "alt.fq", "-d", "refa.fa"] + WGBS + TRIM
    _host(d, base, "host_alt.bsp")
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu_torch.cli"] + base
                       + ["-o", f"{case}.bsp", "-p", "4"] + extra, cwd=d,
                       capture_output=True, env=MP_ENV)
    assert r.returncode == 0, r.stderr.decode()
    assert_same(d, "host_alt.bsp", f"{case}.bsp")
    assert r.stderr.decode().count("range start") == 3
    lines = (d / "host_alt.bsp").read_text().splitlines()
    assert lines[75].split("\t")[3] == "QC"
    assert lines[75].split("\t")[1] != _read_seqs(d / "alt.fq")[
        lines[75].split("\t")[0]]


@pytest.mark.parametrize("case,flags,suffix,extra", [
    ("bsp_host", ["-u"], "bsp", ["--engine", "host"]),
    ("xr_cpu", ["-R"], "sam", ["--device", "cpu"]),
])
def test_range_start_keeps_the_context_slots(qc_data, case, flags, suffix,
                                             extra):
    """The context string (BSP, XR) of a hit at chromosome position 0 keeps
    its two leading bases from the context before it (the reference's
    _mapseq buffer): at a ``-p 4`` range start (read 76, aligned at chr1:1)
    those are read 75's, taken over with the rest of the output state.
    Byte-identical to ``bsmap_tpu --engine host -p 1``."""
    d = qc_data
    base = ["-a", "start.fq", "-d", "refa.fa", "-S", "1", "-v", "3", "-s",
            "12", "-q", "20"] + flags
    _host(d, base, f"host_start_{case}.{suffix}")
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu_torch.cli"] + base
                       + ["-o", f"start_{case}.{suffix}", "-p", "4"] + extra,
                       cwd=d, capture_output=True, env=MP_ENV)
    assert r.returncode == 0, r.stderr.decode()
    assert_same(d, f"host_start_{case}.{suffix}", f"start_{case}.{suffix}")
    line = next(ln for ln in (d / f"host_start_{case}.{suffix}").read_text()
                .splitlines() if ln.startswith("chr1_start"))
    assert "\tchr1\t1\t" in line


def test_nprocs_range_start_walks_back_past_qc_reads(qc_data, monkeypatch):
    """F2 under ``--nprocs 2``: process 1's range starts at read 150, a QC
    read after the QC reads 120-149, so the walk back passes its first
    16-read window before it finds read 119's exact Crick hit.  The merged
    file is byte-identical to ``bsmap_tpu --engine host -p 1``."""
    d = qc_data
    base = ["-a", "alt298.fq", "-d", "refa.fa"] + WGBS + TRIM
    _host(d, base, "host_alt298.bsp")
    starts = {}
    for k in (1, 0):        # process 0 merges once process 1's shard is in
        st = {}
        _port(d, base + ["--nprocs", "2", "--proc-id", str(k)],
              "nprocs.bsp", monkeypatch, stats=st)
        starts[k] = st
    assert_same(d, "host_alt298.bsp", "nprocs.bsp")
    assert "walk_s" in starts[1] and "walk_s" not in starts[0]


def test_native_bsp_qc_line_takes_the_slot_strand():
    """``bsmap_format_bsp_block`` on rows that ``_carry_stale_h00`` filled:
    a QC row after a result row whose slot lies on a Crick strand (odd
    chrp) prints reverse-complemented, one after a Watson slot forward,
    an NM row (found 0, an odd chrp in its row) always forward; each line
    equals ``SamFormatter._out_bsp``'s for that slot."""
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine
    from bsmap_tpu_torch.engine.kernels import (N_EXTRAS, X_CHRP, X_H00C,
                                                X_H00F, X_H00W)
    from bsmap_tpu_torch.output.sam import SamFormatter
    from bsmap_tpu_torch.params import REV_CHAR, Param
    from bsmap_tpu_torch.readio import Read

    lib = native.get_lib()
    if lib is None:
        pytest.skip("g++ cannot build the native runtime")
    reads = [("a", "ACGTTGCAAN", "ABCDEFGHIJ"),   # sets the slot (1, 77)
             ("b", "GGATCCANNT", "0123456789"),   # QC: reverse-complemented
             ("c", "TTTTACGTNA", "abcdefghij"),   # sets the slot (4, 9)
             ("d", "CAGTNNACGT", "KLMNOPQRST"),   # QC: forward
             ("e", "AACCGGTTAN", "!!##$$%%&&")]   # NM, odd chrp: forward
    buf = bytearray()
    rec = np.zeros((len(reads), 6), dtype=np.int64)
    for i, (name, seq, qual) in enumerate(reads):
        for j, s in enumerate((name, seq, qual)):
            rec[i, 2 * j: 2 * j + 2] = len(buf), len(s)
            buf += s.encode()
    MS = 4
    ex = 2 * MS
    rows = np.zeros((len(reads), ex + N_EXTRAS), dtype=np.int32)
    status = np.array([0, 1, 0, 1, 2], dtype=np.int32)   # a, c: not printed
    for i, (c, w) in ((0, (1, 77)), (2, (4, 9))):
        rows[i, ex + X_H00F] = 1
        rows[i, ex + X_H00C], rows[i, ex + X_H00W] = c, w
    rows[4, ex + X_CHRP] = 3
    fmt = types.SimpleNamespace(stale_h00=(0, 0))
    DeviceEngine._carry_stale_h00(rows, status, MS, fmt, qc_strand=True)
    assert fmt.stale_h00 == (4, 9)
    p = Param()
    p.out_sam, p.out_unmap = 0, True
    out, line_off, _ = native.format_bsp_block(
        lib, bytes(buf), rec, status, rows, MS, np.zeros(1, np.uint8),
        np.zeros(2, np.int64), REV_CHAR, True, 1, 3, p.max_num_hits,
        ord("I"), np.zeros(4, np.uint32), 64, np.zeros(1, np.int64),
        b"ACGT", np.zeros(256, np.uint8), np.zeros(len(reads), np.int32))
    got = bytes(out).decode().splitlines(keepends=True)
    py = SamFormatter(types.SimpleNamespace(names=["chr1"]), p)
    want = [py._out_bsp(Read(i, 0, *reads[i]), 0, n, 0, hit, 0, None)
            for i, n, hit in ((1, -1, (1, 77)), (3, -1, (4, 9)),
                              (4, 0, (3, 0)))]
    assert got == want
    assert got[0].split("\t")[1] == "ANNTGGATCC"
    assert got[1].split("\t")[1] == "CAGTNNACGT"
    assert got[2].split("\t")[:2] == ["e", "AACCGGTTAN"]
