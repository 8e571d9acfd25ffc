"""Pair-end context bytes and the aligner state at the range starts of
``-p``/``--nprocs`` runs in the PyTorch port.

The reference's context string (XR under SAM ``-R``, the BSP context
column) keeps the two leading slots of its mate's buffer when a hit lies
at chromosome position 0 or 1, so a range that starts with fresh buffers
printed NUL bytes there.  Each range now records those prints and the
merge sets them from the ranges before it (``parallel/carry.py``).  The
data is tools/simulate.py's 300 pairs with pairs planted at the range
starts (``chip_smoke.context_plants``), run with ``-s 12`` for small
tables.  Every case is held to ``bsmap_tpu --engine host -p 1``, whose
``-p 4`` has the same fault.

The MateState rebuilt at a range start read reads before the user's
``-B``; it now starts where a single process starts
(``distributed._reconstruct_into``)."""

import copy
import json
import random
import subprocess
import sys

import numpy as np
import pytest

from chip_smoke import context_plants, plant_pairs, simulate_context_pairs

from .conftest import simulate
from .test_golden_se import assert_same
from .test_torch_cli import ENV, MP_ENV

SAM_XR = ["-S", "1", "-v", "3", "-u", "-R", "-q", "2", "-s", "12"]
BSP = ["-S", "1", "-v", "3", "-u", "-q", "2", "-s", "12"]
OUTS = {"sam_xr": (SAM_XR, ["x.sam"]), "bsp": (BSP, ["x.bsp", "x_u.bsp"]),
        "bam": (SAM_XR, ["x.bam", "x.bam.bai"])}
# the native block path (the device engine on the CPU) and the per-pair
# path (the host engine)
PATHS = {"blocks": (["--device", "cpu"], "block"),
         "pairs": (["--engine", "host"], "per-pair")}
_HOSTS: set = set()      # (directory, data, kind) the host engine has run


@pytest.fixture(scope="module")
def ctx_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ctx")
    g, r1, r2 = simulate_context_pairs(str(d))
    for name, plant in (
            # F5: pair 76, the start of -p 4's second range, mate 1 at 0
            ("f5", context_plants(g, mate1_at=76)),
            # -p 4's second, third and fourth ranges, --nprocs 2's second
            ("all", context_plants(g, mate1_at=76, mate2_at=151,
                                   pos1_at=226)),
            ("pos1", context_plants(g, pos1_at=76))):
        plant_pairs(r1, r2, str(d / f"{name}_1.fq"), str(d / f"{name}_2.fq"),
                    plant)
    return d


def _outs(kind: str, tag: str) -> list[str]:
    return [f"{tag}_{x}" for x in OUTS[kind][1]]


def _out_args(files: list[str]) -> list[str]:
    return ["-o", files[0]] + (["-2", files[1]] if files[1:2] and
                               files[1].endswith(".bsp") else [])


def _base(d, data: str, kind: str) -> list[str]:
    return ["-a", f"{data}_1.fq", "-b", f"{data}_2.fq", "-d", "ctx.fa"] \
        + OUTS[kind][0]


def _host(d, data: str, kind: str) -> str:
    """``bsmap_tpu --engine host -p 1`` on ``data`` (once a module);
    returns the tag of its files."""
    tag = f"host_{data}"
    if (d, data, kind) not in _HOSTS:
        r = subprocess.run([sys.executable, "-m", "bsmap_tpu.cli"]
                           + _base(d, data, kind)
                           + _out_args(_outs(kind, tag))
                           + ["--engine", "host", "-p", "1"],
                           cwd=d, capture_output=True, env=ENV)
        assert r.returncode == 0, r.stderr.decode()
        _HOSTS.add((d, data, kind))
    return tag


def _workers(d, data: str, kind: str, path: str, host: str) -> str:
    """The port at ``-p 4`` (four worker processes on ``path``): its files
    equal those of the host run ``host``, and every shard took ``path``.
    Returns the run's stdout."""
    extra, what = PATHS[path]
    tag = f"{data}_{kind}_{path}"
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu_torch.cli"]
                       + _base(d, data, kind) + _out_args(_outs(kind, tag))
                       + ["-p", "4"] + extra,
                       cwd=d, capture_output=True, env=MP_ENV)
    assert r.returncode == 0, r.stderr.decode()
    for a, b in zip(_outs(kind, host), _outs(kind, tag)):
        if kind == "bam":
            assert (d / a).read_bytes() == (d / b).read_bytes(), b
        else:
            assert_same(d, a, b)
    out = r.stdout.decode()
    assert out.count(f"pairs on the {what} path") == 4, out
    return out


def _sam_line(d, tag: str, name: str, flag_bit: int) -> list[str]:
    return next(f for f in ((d / f"{tag}_x.sam").read_text("latin1")
                            .splitlines())
                if f.startswith(name) and int(f.split("\t")[1]) & flag_bit
                ).split("\t")


def _patches(out: str) -> int:
    return int(out.split(" context patches")[0].rsplit(" ", 1)[1])


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kind", ["sam_xr", "bsp"])
def test_workers_carry_the_context_slots(ctx_data, kind, path):
    """F5: ``-p 4`` on F5's set, whose pair 76 (the second range's first)
    has mate 1 at chr1:1.  SAM ``-R`` and BSP with ``-2``, on the native
    block path and on the per-pair path, are byte-identical to the host
    engine at ``-p 1``: the mate-1 context's two leading bases are those of
    the context before it, where the parent tree printed two NULs."""
    d = ctx_data
    host = _host(d, "f5", kind)
    assert _patches(_workers(d, "f5", kind, path, host)) == 2
    main = (d / _outs(kind, host)[0]).read_text("latin1").splitlines()
    line = next(x for x in main if x.startswith("r75_") and
                "\tchr1\t1\t" in x)
    ctx = line.split("XR:Z:")[1] if kind == "sam_xr" else line.split("\t")[8]
    assert ctx[:2].isalpha() and ctx[:2].islower(), line


def test_nprocs_carries_mate2_context(ctx_data, monkeypatch):
    """``--nprocs 2`` on the block path (process 1, then process 0 merging,
    in this process): the second range starts on pair 151, whose mate 1 is
    all N and whose mate 2 maps alone at chr1:1, an unpaired mate-2 XR
    line; mate 2's buffer was last written in the first range (pair 10).
    Byte-identical to the host engine at ``-p 1``."""
    from bsmap_tpu_torch import cli
    d = ctx_data
    host = _host(d, "all", "sam_xr")
    monkeypatch.chdir(d)
    monkeypatch.setenv("BSMAP_TPU_RANDR_SEED", ENV["BSMAP_TPU_RANDR_SEED"])
    st = {}
    for k in (1, 0):        # process 0 merges once process 1's shard is in
        st[k] = {}
        assert cli.run(_base(d, "all", "sam_xr") + [
            "-o", "nprocs_x.sam", "--device", "cpu", "--nprocs", "2",
            "--proc-id", str(k)], stats=st[k]) == 0
        assert st[k]["pe_path"] == "blocks"
    assert_same(d, f"{host}_x.sam", "nprocs_x.sam")
    assert st[0]["ctx_patches"] == 2 and "ctx_patches" not in st[1]
    line = _sam_line(d, host, "r150_", 0x80)
    assert line[2:4] == ["chr1", "1"] and int(line[1]) & 0x2 == 0
    assert next(f for f in line if f.startswith("XR:Z:"))[5:7] == "tt"


@pytest.mark.parametrize("path", sorted(PATHS))
def test_mate2_carry_passes_a_range_that_never_wrote_it(ctx_data, path):
    """``-p 4`` SAM ``-R`` on the planted set: the third range starts on
    pair 151's unpaired mate-2 line at chr1:1.  Under SAM ``-R`` only an
    unpaired mate-2 line writes mate 2's buffer; the set has one in the
    first range (pair 10, mate 1 all N) and none in the second, so the
    value comes from two ranges back.  The fourth range starts on pair
    226, mate 1 at chr1:2, whose slot 0 alone leaks.  Byte-identical to
    the host engine at ``-p 1`` on both paths."""
    d = ctx_data
    host = _host(d, "all", "sam_xr")
    rows = [x.split("\t") for x in (d / f"{host}_x.sam").read_text(
        "latin1").splitlines() if not x.startswith("@")]
    alone = [r[0].split("_")[0] for r in rows if int(r[1]) & 0x80
             and not int(r[1]) & 0x6]
    assert alone == ["r9", "r150"], alone
    out = _workers(d, "all", "sam_xr", path, host)
    # pair 76: mate 1's slots 0, 1; pair 151: mate 2's; pair 226: slot 0
    assert _patches(out) == 5


@pytest.mark.parametrize("kind,path", [("sam_xr", "blocks"),
                                       ("bsp", "pairs")])
def test_position_one_carries_slot_zero(ctx_data, kind, path):
    """``-p 4`` with pair 76's mate 1 at chr1:2 (0-based 1): its context
    writes slot 1 and prints slot 0 as the context before it left it.
    One patch; byte-identical to the host engine at ``-p 1``."""
    d = ctx_data
    host = _host(d, "pos1", kind)
    assert _patches(_workers(d, "pos1", kind, path, host)) == 1
    main = (d / _outs(kind, host)[0]).read_text("latin1").splitlines()
    line = next(x for x in main if x.startswith("r75_") and
                "\tchr1\t2\t" in x)
    ctx = line.split("XR:Z:")[1] if kind == "sam_xr" else line.split("\t")[8]
    g = (d / "ctx.fa").read_text().split(">")[1].splitlines()[1][0]
    assert ctx[0].islower() and ctx[1] == g.lower(), line


def test_workers_bam_carries_the_context_slots(ctx_data):
    """``-o x.bam`` under ``-p 4`` on F5's set: the merged SAM is patched
    before the conversion, so the BAM and its index equal the host
    engine's at ``-p 1``."""
    d = ctx_data
    assert _patches(_workers(d, "f5", "bam", "blocks",
                             _host(d, "f5", "bam"))) == 2


def test_merge_carries_slots_across_shards(tmp_path):
    """``merge_patches`` and ``merge_shards`` on synthetic shards: shard 0
    writes mate 1's slots and mate 2's slot 1, shard 1 prints mate 1's
    slot 0 in the main file and mate 2's slot 1 in the -2 file and writes
    nothing, shard 2 prints mate 1's slots and mate 2's slot 0 (never
    written: NUL stays).  The files keep their lengths; a recorded byte
    that is not NUL fails the merge."""
    from bsmap_tpu_torch.parallel import carry as ctx
    from bsmap_tpu_torch.parallel import distributed as dist
    out, up = str(tmp_path / "m.sam"), str(tmp_path / "u.bsp")
    shards = [
        (b"ab\n", b"u0\n", [], [ord("a"), ord("b"), None, ord("z")]),
        (b"X\0Y\n", b"\0q\n", [(0, 0, 1), (1, 3, 0)], [None] * 4),
        (b"\0\0c\0", b"", [(0, 0, 0), (0, 1, 1), (0, 2, 3)],
         [ord("c"), None, None, None]),
    ]
    for k, (main, unpair, recs, final) in enumerate(shards):
        for base, data in ((out, main), (up, unpair)):
            with open(f"{base}.shard{k}", "wb") as f:
                f.write(data)
            open(f"{base}.shard{k}.done", "w").close()
        with open(ctx.sidecar_path(out, k), "w") as f:
            json.dump({"final": final, "patches": recs}, f)
    dist.wait_shards(out, 3)
    plan = ctx.merge_patches(out, 3)
    assert dist.merge_shards(out, 3, "@HD\n", patches=plan[0])[0] == 4
    assert dist.merge_shards(up, 3, patches=plan[1])[0] == 1
    assert open(out, "rb").read() == b"@HD\nab\nXaY\nabc\0"
    assert open(up, "rb").read() == b"u0\nzq\n"
    assert not list(tmp_path.glob("*.ctx"))
    with open(f"{out}.shard0", "wb") as f:
        f.write(b"A")
    open(f"{out}.shard0.done", "w").close()
    with pytest.raises(ValueError, match="not NUL"):
        dist.merge_shards(out, 1, patches=[[(0, 65)]])


def test_per_pair_marks_become_offsets(tmp_path):
    """The per-pair path's formatter marks each byte it prints from a slot
    the range has not written (``TrackedFormatter``), and the writer turns
    each mark into NUL and its byte offset in the file, past text of
    multi-byte characters."""
    from bsmap_tpu_torch.parallel import carry as ctx
    c = ctx.ContextCarry()
    main = f"é{ctx.MARK[0]}{ctx.MARK[1]}x\nñ\n"
    unpair = f"q{ctx.MARK[3]}\n"
    with open(tmp_path / "m", "w", encoding="utf-8") as fm, \
            open(tmp_path / "u", "w", encoding="utf-8") as fu:
        fm.write("ab")
        c.write(fm, "plain\n", fu, "")       # no mark pending
        c.pending = True
        c.write(fm, main, fu, unpair)
    data = (tmp_path / "m").read_bytes()
    assert data == "abplain\né\0\0x\nñ\n".encode()
    assert (tmp_path / "u").read_bytes() == b"q\0\n"
    assert c.patches == [(0, 0, 10), (0, 1, 11), (1, 3, 1)]
    assert data[10] == data[11] == 0 and not c.pending


def test_tracked_formatter_marks_only_unwritten_slots(tmp_path):
    """``TrackedFormatter._context``: a context at position 0 marks both
    slots until a context at position 2 or later writes them; one at
    position 1 writes slot 1 and marks slot 0."""
    from bsmap_tpu_torch.params import Param
    from bsmap_tpu_torch.parallel import carry as ctx
    from bsmap_tpu_torch.reference import load_genome
    (tmp_path / "g.fa").write_text(">c\n" + "ACGT" * 20 + "\n")
    genome = load_genome(str(tmp_path / "g.fa"), Param())
    c = ctx.ContextCarry()
    fa = ctx.TrackedFormatter(genome, Param(), None, c, 0)
    fb = ctx.TrackedFormatter(genome, Param(), None, c, 1)
    assert fa._context(0, 1, 4)[:2] == ctx.MARK[0] + "a"
    assert c.written.tolist() == [0, 1, 0, 0] and c.pending
    assert fb._context(0, 0, 4)[:2] == ctx.MARK[2] + ctx.MARK[3]
    assert fa._context(0, 5, 4)[:2] == "ta"
    assert fa._context(0, 0, 4)[:2] == "ta"
    assert c.written.tolist() == [1, 1, 0, 0]


# -B: reads 1-20 of 100 nt, 21-160 of 40-60 nt (they write seed-buffer
# entries 0-48 only), 161 read 20's first 63 nt (12k + 3 under -s 12) with
# a mismatch in each of its first four 12-nt segments, 162-300 of 33-100
# nt; --nprocs 2 over -B 21 starts its second range on read 161
B_FLAGS = ["-s", "12", "-v", "5", "-B", "21", "-S", "1"]


def _b_reads(src, dst, seed: int = 41) -> None:
    comp = str.maketrans("ACGT", "CGTA")
    rng = random.Random(seed)
    lines = src.read_text().splitlines()
    out = []
    for k in range(1, 301):
        name, seq, plus, qual = lines[4 * k - 4: 4 * k]
        n = (100 if k <= 20 else rng.randint(40, 60) if k <= 160
             else 63 if k == 161 else rng.randint(33, 100))
        if k == 161:
            seq = list(lines[4 * 19 + 1][:63])
            for e in (11, 23, 35, 47):
                seq[e] = seq[e].translate(comp)
            seq = "".join(seq)
        out += [name, seq[:n], plus, qual[:n]]
    dst.write_text("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def b_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ctx_b")
    simulate(d, genome_out="ref.fa", reads_out="raw.fq", n_reads=300,
             read_len=100, chr_len=30000, n_chr=2, seed=7, error_rate=0.0)
    _b_reads(d / "raw.fq", d / "b.fq")
    return d


def test_range_start_state_starts_at_B(b_data):
    """The MateState ``_reconstruct_into`` rebuilds for the range start at
    read 161 under ``-B 21`` equals the one a single process holds there
    (the host engine aligning reads 21-160 in order from a fresh state);
    rebuilt from read 1, as on the parent tree, its entries from 49 on come
    from reads 1-20."""
    from bsmap_tpu_torch.cli import parse_args
    from bsmap_tpu_torch.engine.host_engine import HostEngine, MateState
    from bsmap_tpu_torch.index import build_index
    from bsmap_tpu_torch.parallel import distributed as dist
    from bsmap_tpu_torch.readio import open_read_stream
    from bsmap_tpu_torch.reference import load_genome
    path = str(b_data / "b.fq")
    p = parse_args(["-a", path, "-d", str(b_data / "ref.fa")]
                   + B_FLAGS).param
    genome = load_genome(str(b_data / "ref.fa"), p)
    host = HostEngine(genome, build_index(genome, p), p)
    p2 = copy.copy(p)
    p2.read_start, p2.read_end = 21, 160
    s = open_read_stream(path, p2, 0)
    for rd in s.next_batch(140):
        host.align(rd)
    s.close()
    want = host.mate_state
    got, old = MateState(), MateState()
    dist._reconstruct_into(host, got, path, p, 161, first=21)
    dist._reconstruct_into(host, old, path, p, 161)
    for name in ("seed_buf", "cseed_buf"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert (got.seed_start_offset, got.cseed_start_offset) == (
        want.seed_start_offset, want.cseed_start_offset)
    differ = np.flatnonzero(old.seed_buf != want.seed_buf)
    assert len(differ) == 40 and differ.min() == 49


def test_nprocs_after_B_matches_one_process(b_data, monkeypatch):
    """``--nprocs 2`` over ``-B 21`` on the host engine: read 161 (63 nt,
    a mismatch in each of its first four segments) reads seed-buffer
    entry 52 or later through the start offset it keeps from the reads
    before it.  A single process holds nothing there; the parent tree's
    rebuild held read 20's seed, found read 161's hit and printed it,
    where ``bsmap_tpu --engine host -p 1`` prints it unmapped."""
    from bsmap_tpu_torch import cli
    d = b_data
    base = ["-a", "b.fq", "-d", "ref.fa", "-u"] + B_FLAGS
    r = subprocess.run([sys.executable, "-m", "bsmap_tpu.cli"] + base
                       + ["-o", "host.sam", "--engine", "host", "-p", "1"],
                       cwd=d, capture_output=True, env=ENV)
    assert r.returncode == 0, r.stderr.decode()
    monkeypatch.chdir(d)
    monkeypatch.setenv("BSMAP_TPU_RANDR_SEED", ENV["BSMAP_TPU_RANDR_SEED"])
    for k in (1, 0):
        assert cli.run(base + ["-o", "nprocs.sam", "--engine", "host",
                               "--nprocs", "2", "--proc-id", str(k)]) == 0
    assert_same(d, "host.sam", "nprocs.sam")
    rows = [x.split("\t") for x in (d / "host.sam").read_text().splitlines()
            if not x.startswith("@")]
    assert len(rows) == 280 and rows[140][1] == "4", rows[140][:4]
