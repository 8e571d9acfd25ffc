"""Package rules of the PyTorch port: it imports without JAX, its host
modules are byte-identical copies of ``bsmap_tpu``'s (but for the declared
differences, ``DIFFERS``), wrappers run their twins (and count
nothing) on CPU tensors, and on a CUDA machine each kernel equals its twin
bit for bit (WGBS SE and PE, and SE RRBS)."""

import ast
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from .conftest import REPO, simulate

COPIED = ["params.py", "encoding.py", "utils.py", "readio.py", "blockio.py",
          "reference.py", "index.py", "trim.py", "native/__init__.py",
          "native/bsmap_native.cpp", "output/sam.py",
          "engine/host_engine.py", "output/pair_sam.py",
          "engine/pair_host.py", "bamio.py", "output/bam.py",
          "methratio.py", "bsp2sam.py", "parallel/distributed.py"]
PORT = REPO / "bsmap_tpu_torch"
# declared differences of copied modules: (file, top-level functions)
DIFFERS = {"index.py": ("_mmap_npz",),   # numpy 2.3+ header API
           "native/__init__.py": ("_build",),   # a build file per process
           # torch.distributed; a range start's stale output state;
           # SAM/BAM input under -p workers and --nprocs; a range start's
           # MateState from the user's -B on; the merge's pair-end
           # context carry
           "parallel/distributed.py": ("initialize",
                                       "reconstruct_format_state",
                                       "count_reads", "_reconstruct_into",
                                       "reconstruct_state",
                                       "reconstruct_pair_state",
                                       "wait_shards", "merge_shards"),
           # BSP QC lines take the stale hits[0][0] slot's strand
           "native/bsmap_native.cpp": ("bsmap_format_bsp_block",),
           # the cache's file name, shared with cli.run's -p workers
           "reference.py": ("genome_cache_path", "load_genome_cached")}


def test_port_imports_without_jax():
    """Every port module imports with ``jax`` blocked, and none of them
    pulls in ``bsmap_tpu`` (whose __init__ imports JAX)."""
    mods = ["bsmap_tpu_torch.cli", "bsmap_tpu_torch.engine.device_engine",
            "bsmap_tpu_torch.engine.kernels", "bsmap_tpu_torch.engine._build",
            "bsmap_tpu_torch.blockio", "bsmap_tpu_torch.output.sam",
            "bsmap_tpu_torch.engine.pair_device",
            "bsmap_tpu_torch.engine.pair_pipeline",
            "bsmap_tpu_torch.parallel", "bsmap_tpu_torch.parallel.mesh",
            "bsmap_tpu_torch.parallel.sharded",
            "bsmap_tpu_torch.parallel.index_sharded",
            "bsmap_tpu_torch.bamio", "bsmap_tpu_torch.methratio",
            "bsmap_tpu_torch.bsp2sam",
            "bsmap_tpu_torch.parallel.distributed",
            "bsmap_tpu_torch.parallel.carry",
            "bsmap_tpu_torch.genome_scale", "bsmap_tpu_torch.measure",
            "bsmap_tpu_torch.obs", "bsmap_tpu_torch.engine.native_host",
            "bsmap_tpu_torch.native.host_align"]
    code = ("import sys; sys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'bsmap_tpu') and sys.modules[m] is not None]\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def _cpp_function_lines(lines: list[bytes], name: str):
    """(first, end) line span of the definition of top-level C++ function
    ``name``: from the line at column 0 that opens its signature to the
    line of the brace that closes its body (braces matched; the copied
    runtime has none in literals or comments), None where it has none.  A
    declaration (a ``;`` before the first ``{``) is passed over."""
    opener = re.compile(rb"^\S.*\b" + re.escape(name.encode()) + rb"\(")
    for first, line in enumerate(lines):
        if not opener.match(line):
            continue
        text = b"".join(lines[first:])
        body, semi = text.find(b"{"), text.find(b";")
        if 0 <= semi < body:
            continue
        depth = 0
        for pos in range(body, len(text)):
            depth += {ord("{"): 1, ord("}"): -1}.get(text[pos], 0)
            if depth == 0:
                return first, first + text.count(b"\n", 0, pos) + 1
    return None


def _without_function(src: bytes, name: str, missing_ok: bool = False,
                      cpp: bool = False) -> bytes:
    """``src`` with the source lines of top-level function ``name`` (a
    Python ``def``, or with ``cpp`` a C++ definition) and the blank lines
    after it cut (``src`` itself where it has none and ``missing_ok``)."""
    lines = src.splitlines(keepends=True)
    if cpp:
        span = _cpp_function_lines(lines, name)
    else:
        fn = next((n for n in ast.parse(src).body
                   if isinstance(n, ast.FunctionDef) and n.name == name),
                  None)
        span = fn and (fn.lineno - 1, fn.end_lineno)
    if span is None and missing_ok:
        return src
    first, end = span
    while end < len(lines) and not lines[end].strip():
        end += 1
    return b"".join(lines[:first] + lines[end:])


@pytest.mark.parametrize("rel", COPIED)
def test_host_module_is_identical_copy(rel):
    """The framework-free host modules are copied, not imported (importing
    any bsmap_tpu module imports JAX); the copies stay byte-identical, but
    for the functions DIFFERS declares."""
    port = (PORT / rel).read_bytes()
    ref = (REPO / "bsmap_tpu" / rel).read_bytes()
    if rel in DIFFERS:
        assert port != ref
        cpp = rel.endswith(".cpp")
        for name in DIFFERS[rel]:
            port = _without_function(port, name, cpp=cpp)
            ref = _without_function(ref, name, missing_ok=True, cpp=cpp)
    assert port == ref


def test_native_build_uses_a_file_per_process(tmp_path, monkeypatch):
    """The port's native library is compiled into a file named by the
    process and moved into place whole: another process's build in flight
    (its own temporary file) is left alone, and a failed compile leaves no
    file behind."""
    from bsmap_tpu_torch import native
    so = str(tmp_path / "_bsmap_native.so")
    other = f"{so}.{os.getpid() + 1}.tmp"
    (tmp_path / os.path.basename(other)).write_bytes(b"half")
    outs = []

    def compile_ok(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        outs.append(out)
        with open(out, "wb") as f:
            f.write(b"whole")

    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native.subprocess, "run", compile_ok)
    assert native._build()
    assert outs == [f"{so}.{os.getpid()}.tmp"]
    assert open(so, "rb").read() == b"whole"
    assert open(other, "rb").read() == b"half"

    def compile_fails(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"part")
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(native.subprocess, "run", compile_fails)
    assert not native._build()
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (so, other))


def test_index_cache_maps_without_private_numpy_header(tmp_path,
                                                       monkeypatch):
    """--index-cache's memory-mapped load reads the npy headers through
    numpy's public API: with ``np.lib.format`` reduced to its public names,
    as numpy 2.3+ ships it (no ``_read_array_header``),
    ``load_index(path, mmap=True)`` equals the plain load, member by
    member.  (Deleting the private name from this numpy's module would
    break its public readers too, which call it internally.)"""
    from bsmap_tpu_torch.index import build_index, load_index, save_index
    from bsmap_tpu_torch.params import Param
    from bsmap_tpu_torch.reference import load_genome
    simulate(tmp_path, genome_out="ref.fa", reads_out="r.fq", n_reads=10,
             chr_len=12000, n_chr=2, seed=3)
    p = Param()
    p.init_mapping()
    path = str(tmp_path / "idx.npz")
    save_index(path, build_index(load_genome(str(tmp_path / "ref.fa"), p),
                                 p))
    public = types.ModuleType(np.lib.format.__name__)
    for k in dir(np.lib.format):
        if not k.startswith("_"):
            setattr(public, k, getattr(np.lib.format, k))
    monkeypatch.setattr(np.lib, "format", public)
    assert not hasattr(np.lib.format, "_read_array_header")
    mapped, plain = load_index(path, mmap=True), load_index(path)
    assert isinstance(mapped.locs, np.memmap)
    for f in ("seed_size", "rrbs", "offsets", "locs", "wcounts", "tags"):
        a, b = getattr(mapped, f), getattr(plain, f)
        assert (a is None and b is None) or np.array_equal(a, b), f


def test_port_never_names_jax_or_bsmap_tpu_imports():
    """No module of the port, ``parallel/`` included, nor chip_smoke.py
    imports jax or bsmap_tpu."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|bsmap_tpu)\b", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert PORT / "parallel" / "index_sharded.py" in files
    for f in files:
        assert not pat.search(f.read_text()), f


def _tiny(tmp_path):
    simulate(tmp_path, genome_out="ref.fa", reads_out="r.fq", n_reads=200,
             read_len=100, chr_len=12000, n_chr=2, seed=9, error_rate=0.02)
    from bsmap_tpu_torch.engine import device_engine as T
    from bsmap_tpu_torch.index import build_index
    from bsmap_tpu_torch.params import Param
    from bsmap_tpu_torch.readio import open_read_stream
    from bsmap_tpu_torch.reference import load_genome
    from bsmap_tpu_torch.utils import myrand_hash
    p = Param()
    p.randseed = 1
    p.init_mapping()
    genome = load_genome(str(tmp_path / "ref.fa"), p)
    index = build_index(genome, p)
    eng = T.DeviceEngine(genome, index, p, device="cpu")
    s = open_read_stream(str(tmp_path / "r.fq"), p, readset=0)
    batch = s.next_batch(1000)
    s.close()
    live, buds = eng._filter_batch(batch, [None] * len(batch))
    codes, regs, lens, buds, _rs, ridx = eng._pack_host(batch, live, buds)
    rows = T._pack_inputs(codes, regs, lens, buds, myrand_hash(ridx, 1),
                          np.full(len(lens), 2, np.int32))
    rows = np.concatenate([rows[:, :7], rows[:, 10:17], rows[:, 20:]], 1)
    return eng, rows


def _tiny_pe(d):
    """A pair engine on the CPU and one block pair's dispatch rows."""
    d.mkdir()
    simulate(d, genome_out="ref.fa", reads_out="p1.fq", reads2_out="p2.fq",
             pe=True, n_reads=200, read_len=76, chr_len=12000, n_chr=2,
             seed=9, error_rate=0.02)
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine.pair_device import PairDeviceEngine
    from bsmap_tpu_torch.index import build_index
    from bsmap_tpu_torch.params import Param
    from bsmap_tpu_torch.reference import load_genome
    p = Param()
    p.randseed = 1
    p.init_mapping()
    genome = load_genome(str(d / "ref.fa"), p)
    eng = PairDeviceEngine(genome, build_index(genome, p), p, device="cpu")
    blks = []
    for readset, f in ((1, "p1.fq"), (2, "p2.fq")):
        s = BlockReadStream(str(d / f), p, readset=readset,
                            lib=native.get_lib())
        blks.append(s.next_block(1000))
        s.close()
    nw, _live, _pos, ra, rb = eng.block_pair_rows(*blks)
    return eng, nw, ra, rb


def test_wrappers_run_twins_on_cpu_and_count_nothing(tmp_path):
    """A CPU tensor takes the plain twin: same rows as calling the twins
    directly, and no kernel launch is counted."""
    from bsmap_tpu_torch.engine import kernels as K
    eng, rows = _tiny(tmp_path)
    cfg = eng._cfg("f", lean=True, nw=7)
    r = torch.from_numpy(rows)
    K.reset_launch_counts()
    out = K.align_program(cfg, eng.CANDS, eng.tables, r)
    assert K.launch_counts() == {k.__name__: 0 for k in K.KERNELS}
    slots = K.exact_schedule_plain(cfg, r, eng.tables["kmer_tab"],
                                   eng.tables["prof_a"])
    vc = K.verify_candidates_plain(cfg, eng.CANDS, r, slots, eng.tables)
    want = K.reduce_reads_plain(cfg, eng.CANDS, r, vc, slots)
    assert torch.equal(out, want)
    assert int((out[:, 1] & 1).sum()) > 0          # reads were found


@pytest.mark.gpu
def test_cuda_kernels_equal_twins(tmp_path):
    """On a CUDA device: each kernel (built from csrc/ with nvcc for
    sm_90a) against its plain-torch twin on the same device tensors, for
    fixed/exact lean and full rows at both capacity tiers and the probe
    pass, and the pair-end program (rc chain rows, both mates with cfg.pe
    and 16 hits, the pair join); exact equality, and one counted launch per
    wrapper call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    eng, rows = _tiny(tmp_path)
    tabs = {k: v.cuda() for k, v in eng.tables.items()}
    r = torch.from_numpy(rows).cuda()
    base = eng._cfg("f", lean=True, nw=7)
    K.reset_launch_counts()
    for cfg, cands in [(base._replace(fixed=True), eng.CANDS),
                       (base, eng.CANDS), (base._replace(lean=False),
                                           eng.CANDS_BIG), (base, 2)]:
        if cfg.fixed:
            s = K.fixed_schedule(cfg, r, tabs["kmer_tab"])
            w = K.fixed_schedule_plain(cfg, r, tabs["kmer_tab"])
        else:
            s = K.exact_schedule(cfg, r, tabs["kmer_tab"], tabs["prof_a"])
            w = K.exact_schedule_plain(cfg, r, tabs["kmer_tab"],
                                       tabs["prof_a"])
        assert all(torch.equal(a, b) for a, b in zip(s, w))
        vc = K.verify_candidates(cfg, cands, r, s, tabs)
        vw = K.verify_candidates_plain(cfg, cands, r, s, tabs)
        assert all(torch.equal(a, b) for a, b in zip(vc, vw))
        assert torch.equal(K.reduce_reads(cfg, cands, r, vc, s),
                           K.reduce_reads_plain(cfg, cands, r, vc, s))
    p = K.exact_schedule(base._replace(probe=True), r, tabs["kmer_tab"],
                         tabs["prof_a"], probe=True)
    assert torch.equal(p.ftot_rank, K.exact_schedule_plain(
        base, r, tabs["kmer_tab"], tabs["prof_a"]).ftot_rank)
    pe, nw, ra, rb = _tiny_pe(tmp_path / "pe")
    ra[:, -1] = rb[:, -1] = pe.MS - 1                # full rank
    tabs = {k: v.cuda() for k, v in pe.se.tables.items()}
    ca, cb = pe._cfg(1, nw), pe._cfg(2, nw)
    da, db = torch.from_numpy(ra).cuda(), torch.from_numpy(rb).cuda()
    rc = K.rc_words(cb, db)
    assert torch.equal(rc, K.rc_words_plain(cb, db))
    full = []
    for cfg, rows in ((ca, da), (cb, rc)):
        s = K.exact_schedule(cfg, rows, tabs["kmer_tab"], tabs["prof_a"])
        assert all(torch.equal(a, b) for a, b in zip(s, K.exact_schedule_plain(
            cfg, rows, tabs["kmer_tab"], tabs["prof_a"])))
        vc = K.verify_candidates(cfg, pe.se.CANDS, rows, s, tabs)
        assert all(torch.equal(a, b) for a, b in zip(
            vc, K.verify_candidates_plain(cfg, pe.se.CANDS, rows, s, tabs)))
        full.append(K.reduce_reads(cfg, pe.se.CANDS, rows, vc, s))
        assert torch.equal(full[-1], K.reduce_reads_plain(
            cfg, pe.se.CANDS, rows, vc, s))
    j = K.pair_join(ca, full[0], full[1], da, db)
    assert torch.equal(j, K.pair_join_plain(ca, full[0], full[1], da, db))
    assert int(((j[:, 6] & 31) > 0).sum()) > len(ra) // 2   # pairs found
    torch.cuda.synchronize()
    assert K.launch_counts() == {"fixed_schedule": 1, "exact_schedule": 6,
                                 "verify_candidates": 6, "reduce_reads": 6,
                                 "rc_words": 1, "pair_join": 1,
                                 "merge_shards": 0}


def _tiny_rrbs(d):
    """An RRBS DeviceEngine on the CPU over ``chip_smoke.make_rrbs_set``
    data and a function giving the reads' full-rank dispatch rows at -v v
    (with the -m/-x window ``window``) and their Cfg."""
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import device_engine as T
    from bsmap_tpu_torch.index import build_index
    from bsmap_tpu_torch.params import Param
    from bsmap_tpu_torch.reference import load_genome
    from chip_smoke import make_rrbs_set
    d.mkdir()
    make_rrbs_set(d, n_reads=400)

    def param(v, window=None):
        p = Param()
        p.set_digestion_site("C-CGG")
        p.max_snp_num = v
        p.randseed = 1
        if window:
            p.min_insert, p.max_insert = window
        p.init_mapping()
        return p

    p = param(2)
    genome = load_genome(str(d / "rrbs.fa"), p)
    index = build_index(genome, p)

    def rows_cfg(v, lean, window=None):
        eng = T.DeviceEngine(genome, index, param(v, window), device="cpu")
        s = BlockReadStream(str(d / "se.fq"), eng.param, readset=0,
                            lib=native.get_lib())
        blk = s.next_block(1000)
        s.close()
        nw, _live, rows, _b = eng.block_rows(blk)
        rows[:, -1] = eng._maxseg - 1
        return eng, rows, eng._cfg("f", lean=lean, nw=nw)

    return rows_cfg


@pytest.mark.gpu
def test_cuda_rrbs_kernels_equal_twins(tmp_path):
    """On a CUDA device: K2, K3 and K4 with cfg.rrbs (tag-partitioned
    tables) against their twins on the same device tensors, lean and full
    rows, the default and a -m 100 -x 150 fragment window; exact equality,
    one counted launch per wrapper call and no K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    rows_cfg = _tiny_rrbs(tmp_path / "rrbs")
    K.reset_launch_counts()
    for v, lean, window in ((2, True, None), (4, False, None),
                            (2, False, (100, 150))):
        eng, rows, cfg = rows_cfg(v, lean, window)
        assert cfg.rrbs and eng.CANDS == eng.CANDS_BIG
        tabs = {k: t.cuda() for k, t in eng.tables.items()}
        r = torch.from_numpy(rows).cuda()
        s = K.exact_schedule(cfg, r, tabs["kmer_tab"], tabs["prof_a"],
                             tag_off=tabs["tag_off"])
        w = K.exact_schedule_plain(cfg, r, tabs["kmer_tab"], tabs["prof_a"],
                                   tag_off=tabs["tag_off"])
        assert all(torch.equal(a, b) for a, b in zip(s, w))
        vc = K.verify_candidates(cfg, eng.CANDS, r, s, tabs)
        vw = K.verify_candidates_plain(cfg, eng.CANDS, r, s, tabs)
        assert all(torch.equal(a, b) for a, b in zip(vc, vw))
        assert int(((vc.info & K.INFO_FRAG) != 0).sum()) > 0
        assert torch.equal(K.reduce_reads(cfg, eng.CANDS, r, vc, s),
                           K.reduce_reads_plain(cfg, eng.CANDS, r, vc, s))
    torch.cuda.synchronize()
    assert K.launch_counts() == {"fixed_schedule": 0, "exact_schedule": 3,
                                 "verify_candidates": 3, "reduce_reads": 3,
                                 "rc_words": 0, "pair_join": 0,
                                 "merge_shards": 0}


@pytest.mark.gpu
def test_cuda_both_chains_kernels_equal_twins(tmp_path):
    """On a CUDA device, -n 1 (chains_mode 'b'): K5, K1, K2 (and its probe
    pass), K3 and K4 on both chains against their twins, lean and full rows
    at both capacity tiers; both mates of the pair-end program and K6; and
    SE RRBS on both chains.  Exact equality."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    eng, rows = _tiny(tmp_path)
    eng.param.chains = 1
    tabs = {k: v.cuda() for k, v in eng.tables.items()}
    r = torch.from_numpy(rows).cuda()
    base = eng._cfg("b", lean=True, nw=7)
    rc = K.rc_words(base, r)
    assert torch.equal(rc, K.rc_words_plain(base, r))
    K.reset_launch_counts()
    for cfg, cands in [(base._replace(fixed=True), eng.CANDS),
                       (base, eng.CANDS), (base._replace(lean=False),
                                           eng.CANDS_BIG), (base, 2)]:
        if cfg.fixed:
            s = K.fixed_schedule(cfg, r, tabs["kmer_tab"], rc)
            w = K.fixed_schedule_plain(cfg, r, tabs["kmer_tab"], rc)
        else:
            s = K.exact_schedule(cfg, r, tabs["kmer_tab"], tabs["prof_a"],
                                 rows_rc=rc)
            w = K.exact_schedule_plain(cfg, r, tabs["kmer_tab"],
                                       tabs["prof_a"], rows_rc=rc)
        assert all(torch.equal(a, b) for a, b in zip(s, w))
        vc = K.verify_candidates(cfg, cands, r, s, tabs, rc)
        vw = K.verify_candidates_plain(cfg, cands, r, s, tabs, rc)
        assert all(torch.equal(a, b) for a, b in zip(vc, vw))
        assert torch.equal(K.reduce_reads(cfg, cands, r, vc, s),
                           K.reduce_reads_plain(cfg, cands, r, vc, s))
    p = K.exact_schedule(base._replace(probe=True), r, tabs["kmer_tab"],
                         tabs["prof_a"], probe=True, rows_rc=rc)
    assert torch.equal(p.ftot_rank, K.exact_schedule_plain(
        base, r, tabs["kmer_tab"], tabs["prof_a"], rows_rc=rc).ftot_rank)
    pe, nw, ra, rb = _tiny_pe(tmp_path / "pe")
    pe.param.chains = 1
    ca, cb = pe._cfg(1, nw), pe._cfg(2, nw)
    assert ca.chains_mode == cb.chains_mode == "b"
    ptabs = {k: v.cuda() for k, v in pe.se.tables.items()}
    da, db = torch.from_numpy(ra).cuda(), torch.from_numpy(rb).cuda()
    full = []
    for cfg, rows_ in ((ca, da), (cb, db)):
        rrc = K.rc_words(cfg, rows_)
        s = K.exact_schedule(cfg, rows_, ptabs["kmer_tab"], ptabs["prof_a"],
                             rows_rc=rrc)
        vc = K.verify_candidates(cfg, pe.se.CANDS, rows_, s, ptabs, rrc)
        assert all(torch.equal(a, b) for a, b in zip(
            vc, K.verify_candidates_plain(cfg, pe.se.CANDS, rows_, s, ptabs,
                                          rrc)))
        full.append(K.reduce_reads(cfg, pe.se.CANDS, rows_, vc, s))
        assert torch.equal(full[-1], K.reduce_reads_plain(
            cfg, pe.se.CANDS, rows_, vc, s))
    assert torch.equal(K.pair_join(ca, full[0], full[1], da, db),
                       K.pair_join_plain(ca, full[0], full[1], da, db))
    rows_cfg = _tiny_rrbs(tmp_path / "rrbs")
    reng, rrows, rcfg = rows_cfg(2, False)
    rtabs = {k: t.cuda() for k, t in reng.tables.items()}
    rcfg = rcfg._replace(chains_mode="b")
    rr = torch.from_numpy(rrows).cuda()
    rrc = K.rc_words(rcfg, rr)
    s = K.exact_schedule(rcfg, rr, rtabs["kmer_tab"], rtabs["prof_a"],
                         tag_off=rtabs["tag_off"], rows_rc=rrc)
    assert all(torch.equal(a, b) for a, b in zip(s, K.exact_schedule_plain(
        rcfg, rr, rtabs["kmer_tab"], rtabs["prof_a"],
        tag_off=rtabs["tag_off"], rows_rc=rrc)))
    vc = K.verify_candidates(rcfg, reng.CANDS, rr, s, rtabs, rrc)
    assert all(torch.equal(a, b) for a, b in zip(vc, K.verify_candidates_plain(
        rcfg, reng.CANDS, rr, s, rtabs, rrc)))
    assert torch.equal(K.reduce_reads(rcfg, reng.CANDS, rr, vc, s),
                       K.reduce_reads_plain(rcfg, reng.CANDS, rr, vc, s))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["fixed_schedule"] == 1 and counts["rc_words"] == 3


@pytest.mark.gpu
def test_cuda_mesh_engines_on_one_card(tmp_path):
    """On a CUDA device, two virtual shards on cuda:0: the index-sharded
    program (K2 on the global counts, K3 with the corner bit, K7) equals
    its twins on the CPU bit for bit and the single-device rows in every
    column but the per-shard capacity ones (ok, big, ftot) and the picks
    of reads without one; the stripe engine equals the single-device
    program on each stripe."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import device_engine as T
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.index import build_index
    from bsmap_tpu_torch.params import Param
    from bsmap_tpu_torch.parallel import (IndexShardedEngine,
                                          ShardedDeviceEngine)
    from bsmap_tpu_torch.reference import load_genome
    _eng, rows = _tiny(tmp_path)
    p = Param()
    p.set_seed_size(12)
    p.randseed = 1
    p.init_mapping()
    genome = load_genome(str(tmp_path / "ref.fa"), p)
    index = build_index(genome, p)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    one = T.DeviceEngine(genome, index, p, device=cuda)
    K.reset_launch_counts()
    for cls, kw in ((IndexShardedEngine, {}),
                    (ShardedDeviceEngine, {"b_loc": 128})):
        on_card = cls(genome, index, p, mesh=[cuda, cuda], **kw)
        twin = cls(genome, index, p, mesh=[cpu, cpu], **kw)
        for fixed in (False, True):
            cfg = on_card._cfg("f", nw=7)._replace(fixed=fixed)
            got = on_card._dispatch(cfg, rows, 4096)
            assert got.device == cuda
            assert torch.equal(got.cpu(), twin._dispatch(cfg, rows, 4096))
            if cls is ShardedDeviceEngine:
                assert len(rows) > 128                    # two stripes
                want = torch.cat([K.align_program(
                    cfg, 4096, one.tables, torch.from_numpy(
                        rows[k: k + 128]).to(cuda)) for k in (0, 128)])
                assert torch.equal(got, want)
                continue
            want = K.align_program(cfg._replace(shards=0), 4096, one.tables,
                                   torch.from_numpy(rows).to(cuda))
            ex = 2 * cfg.maxseg
            g, w = got.cpu().numpy(), want.cpu().numpy()
            same = np.ones(g.shape[1], bool)
            same[[ex + K.X_OK, ex + K.X_BIG, ex + K.X_FTOT]] = False
            keep = g[:, ex + K.X_REPLAY] == 0
            found, h00 = g[:, ex + K.X_FOUND] != 0, g[:, ex + K.X_H00F] != 0
            for c, rowsel in ((K.X_CHRP, found), (K.X_WLOC, found),
                              (K.X_H00C, h00), (K.X_H00W, h00)):
                same[ex + c] = False
                assert (g[keep & rowsel, ex + c]
                        == w[keep & rowsel, ex + c]).all()
            assert (g[keep][:, same] == w[keep][:, same]).all()
            assert keep.sum() > len(rows) // 2 and found.sum() > 0
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["merge_shards"] == 2 and counts["fixed_schedule"] > 0


@pytest.mark.gpu
def test_cuda_verify_candidates_on_synthetic_counts(tmp_path):
    """On a CUDA device: the redesigned K3 (multi-block scan, block-shared
    slot lookup, fused dedup passes) against its twin on the synthetic slot
    counts of ``chip_smoke.k3_synthetic_counts`` (no candidates, one slot
    holding the capacity, counts at and past the 2^30 saturation limit,
    totals beside the capacity, two full slots far apart), on the whole
    window, one read and slot counts beside a multiple of the scan's tile,
    in both launch forms, twice in a row; on the forward chain and on both
    chains.  Exact equality, one counted launch per wrapper call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from chip_smoke import phase_k3_synthetic
    eng, rows = _tiny(tmp_path)
    tabs = {k: v.cuda() for k, v in eng.tables.items()}
    # the window twice over: the shapes beside a tile multiple need 341 reads
    r = torch.from_numpy(np.tile(rows, (2, 1))).cuda()
    K.reset_launch_counts()
    for mode in ("f", "b"):
        cfg = eng._cfg(mode, lean=True, nw=7)._replace(fixed=True)
        rc = K.rc_words(cfg, r) if mode == "b" else None
        slots = K.fixed_schedule(cfg, r, tabs["kmer_tab"], rc)
        errs = {}
        phase_k3_synthetic(K, cfg, 4096, r, slots, tabs, rc, errs, "gpu test")
        assert errs == {"verify_candidates": 0}
    torch.cuda.synchronize()
    counts = K.launch_counts()
    # 9 patterns x 4 shapes x 2 budgets x 2 launch forms x 2 passes x 2 modes
    assert counts["verify_candidates"] == 9 * 4 * 2 * 2 * 2 * 2
    assert counts["reduce_reads"] == counts["exact_schedule"] == 0


@pytest.mark.gpu
def test_cuda_exact_schedule_on_short_and_tying_reads(tmp_path):
    """On a CUDA device: the redesigned K2 (a group of lanes per read)
    against its twin on ``chip_smoke.k2_row_variants`` (rows as read, cut
    to 51 nt, built to tie) at -v 2, 4 and 5, slot rows and the probe
    pass, with groups of 32 and of 16 lanes, on 'f', 'r' and 'b', and with
    cfg.rrbs; exact equality."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from chip_smoke import phase_k2_cases
    eng, rows = _tiny(tmp_path)
    tabs = {k: v.cuda() for k, v in eng.tables.items()}
    errs = {}
    K.reset_launch_counts()
    for mode in ("f", "r", "b"):
        phase_k2_cases(K, eng._cfg(mode, nw=7), rows, tabs, "cuda", errs,
                       "gpu test")
    rows_cfg = _tiny_rrbs(tmp_path / "rrbs")
    reng, rrows, rcfg = rows_cfg(2, False)
    rtabs = {k: t.cuda() for k, t in reng.tables.items()}
    for mode in ("f", "b"):
        phase_k2_cases(K, rcfg._replace(chains_mode=mode), rrows, rtabs,
                       "cuda", errs, "gpu test", budgets=(2, 4))
    torch.cuda.synchronize()
    assert errs == {"exact_schedule": 0}
    # 3 variants x budgets x (slot rows + probe) x 2 group widths
    assert K.launch_counts()["exact_schedule"] == \
        3 * 3 * 3 * 4 + 2 * 3 * 2 * 4


@pytest.mark.gpu
def test_cuda_fixed_schedule_on_synthetic_tables(tmp_path):
    """On a CUDA device: the redesigned K1 (a lane per slot, rank-ordered
    stores) against its twin on ``chip_smoke.k1_synthetic_cases`` (a table
    with tying, clamped and wrapping counts; reads as read, cut, with
    seedseg < maxseg, maxrank 0 and >= maxseg) on 'f', 'r' and 'b', at -v 2
    and -v 15 (NB up to 128: lanes loop over rounds) and -v 4 -I 3, with
    every group width; exact equality, one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from chip_smoke import k2_budget_cfg, phase_k1_cases
    eng, rows = _tiny(tmp_path)
    kt = eng.tables["kmer_tab"].cuda()
    r = torch.from_numpy(rows).cuda()
    errs = {}
    K.reset_launch_counts()
    n = 0
    for mode in ("f", "r", "b"):
        for v, I in ((2, 4), (15, 4), (4, 3)):
            cfg = k2_budget_cfg(eng._cfg(mode, lean=True, nw=7), v)._replace(
                fixed=True, I=I)
            phase_k1_cases(K, cfg, r, kt, errs, "gpu test")
            n += 5 * len(K.k1_groups(cfg))
    torch.cuda.synchronize()
    assert errs == {"fixed_schedule": 0}
    assert K.launch_counts()["fixed_schedule"] == n


@pytest.mark.gpu
def test_cuda_pair_join_on_synthetic_rows(tmp_path):
    """On a CUDA device: the redesigned K6 (a warp per pair over the live
    combos) against its twin on ``chip_smoke.k6_synthetic_rows`` at K = 16,
    4 and 1 with -w as configured and K*K, and on the pair engine's mate
    rows at full rank; exact equality."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from chip_smoke import K6_HITS, phase_k6_cases
    pe, nw, ra, rb = _tiny_pe(tmp_path / "pe")
    ca, cb = pe._cfg(1, nw), pe._cfg(2, nw)
    errs = {}
    K.reset_launch_counts()
    phase_k6_cases(K, ca, 7000, "cuda", errs, "gpu test")
    ra[:, -1] = rb[:, -1] = pe.MS - 1                # full rank
    tabs = {k: v.cuda() for k, v in pe.se.tables.items()}
    da, db = torch.from_numpy(ra).cuda(), torch.from_numpy(rb).cuda()
    full = [K.align_program(c, pe.se.CANDS, tabs, d)
            for c, d in ((ca, da), (cb, db))]
    j = K.pair_join(ca, full[0], full[1], da, db)
    assert torch.equal(j, K.pair_join_plain(ca, full[0], full[1], da, db))
    assert int(((j[:, 6] & 31) > 0).sum()) > len(ra) // 2   # pairs found
    torch.cuda.synchronize()
    assert errs == {"pair_join": 0}
    assert K.launch_counts()["pair_join"] == 2 * len(K6_HITS) + 1


@pytest.mark.gpu
def test_cuda_reduce_reads_on_synthetic_counts(tmp_path):
    """On a CUDA device: the redesigned K4 (a lane per read, the whole warp
    for a read with more than 32 candidates) against its twin on the
    candidates K3 makes from ``chip_smoke.k3_synthetic_counts``
    (``phase_k4_cases``: the reads' own budgets and budget 255, -w as set
    and 2, two capacities): lean fixed and full rows on 'f' and 'b', the pair-end
    mate 2 program ('r', cfg.pe, 16 hits), and lean and full RRBS rows;
    exact equality, one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from chip_smoke import k3_synthetic_counts, phase_k4_cases
    eng, rows = _tiny(tmp_path)
    tabs = {k: v.cuda() for k, v in eng.tables.items()}
    r = torch.from_numpy(rows).cuda()
    tiers = (4096, 65536)
    cases = []
    for mode in ("f", "b"):
        cf = eng._cfg(mode, lean=True, nw=7)._replace(fixed=True)
        cx = eng._cfg(mode, nw=7)
        rc = K.rc_words(cf, r) if mode == "b" else None
        cases += [
            (f"'{mode}' lean fixed", cf, r, rc,
             K.fixed_schedule(cf, r, tabs["kmer_tab"], rc), tiers),
            (f"'{mode}' full", cx, r, rc,
             K.exact_schedule(cx, r, tabs["kmer_tab"], tabs["prof_a"],
                              rows_rc=rc), tiers)]
    errs = {}
    K.reset_launch_counts()
    phase_k4_cases(K, cases, tabs, errs, "gpu test")
    pe, nw, _ra, rb = _tiny_pe(tmp_path / "pe")
    cb = pe._cfg(2, nw)
    ptabs = {k: v.cuda() for k, v in pe.se.tables.items()}
    fwd, _ = K.chain_inputs(cb, torch.from_numpy(rb).cuda())
    cases.append(("mate 2 'r', 16 hits", cb, fwd, None, K.exact_schedule(
        cb, fwd, ptabs["kmer_tab"], ptabs["prof_a"]), tiers))
    phase_k4_cases(K, cases[-1:], ptabs, errs, "gpu test")
    reng, rrows, rcfg = _tiny_rrbs(tmp_path / "rrbs")(2, True)
    rtabs = {k: t.cuda() for k, t in reng.tables.items()}
    rr = torch.from_numpy(rrows).cuda()
    rs = K.exact_schedule(rcfg, rr, rtabs["kmer_tab"], rtabs["prof_a"],
                          tag_off=rtabs["tag_off"])
    cases += [("RRBS lean", rcfg, rr, None, rs, tiers),
              ("RRBS full", rcfg._replace(lean=False), rr, None, rs, tiers)]
    phase_k4_cases(K, cases[-2:], rtabs, errs, "gpu test")
    torch.cuda.synchronize()
    assert errs == {"reduce_reads": 0}
    n_pat = len(k3_synthetic_counts(24, 16))
    # patterns x capacities x 2 budgets x 2 -w, each case
    assert K.launch_counts()["reduce_reads"] == sum(
        n_pat * len(c[5]) * 2 * 2 for c in cases)


@pytest.mark.gpu
def test_cuda_rc_words_at_every_length(tmp_path):
    """On a CUDA device: the redesigned K5 (a tile of rows in shared
    memory, a thread per output word) against its twin on
    ``chip_smoke.k5_synthetic_rows`` at every nw from 1 to 10 and every
    length 1..16*nw, N lanes, under the three permutations of
    ``K5_PERMS`` (``phase_k5_cases``); exact equality."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from chip_smoke import K5_PERMS, phase_k5_cases
    eng, _rows = _tiny(tmp_path)
    errs = {}
    K.reset_launch_counts()
    phase_k5_cases(K, eng._cfg("r", nw=7), "cuda", errs, "gpu test")
    torch.cuda.synchronize()
    assert errs == {"rc_words": 0}
    assert K.launch_counts()["rc_words"] == K.MAX_NW * len(K5_PERMS)


@pytest.mark.gpu
def test_cuda_merge_shards_on_synthetic_cases():
    """On a CUDA device: the redesigned K7 (a warp per read, the global
    discovery order as a key, shards read in place) against its twin on
    ``chip_smoke.k7_synthetic_cases`` (D = 1 to 16, maxseg up to 16, reads
    with 0 to over 1,024 candidates, a read cut by the capacity on one
    shard, saturated totals, K = 0 and 16, pe, -r 0, -w 2) on 'f', 'r'
    and 'b'; exact equality, one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.device_engine import Cfg
    from chip_smoke import K7_SHAPES, phase_k7_cases
    base = Cfg(S=16, I=4, maxseg=3, chains_mode="f", P=40, max_num_hits=20,
               report_repeat_hits=1, W=100, n_chr=1, nw=7)
    errs = {}
    K.reset_launch_counts()
    n = sum(phase_k7_cases(K, base._replace(chains_mode=mode), "cuda", errs,
                           "gpu test") for mode in ("f", "r", "b"))
    torch.cuda.synchronize()
    assert errs == {"merge_shards": 0}
    assert K.launch_counts()["merge_shards"] == n == 3 * 2 * len(K7_SHAPES)


@pytest.mark.gpu
def test_cuda_bam_and_nprocs_on_one_card(tmp_path):
    """On a CUDA device: SE ``.bam`` output through the kernels (launches
    counted) and ``--nprocs 2`` with both processes on the one card; the
    BAM, its index and the merged SAM byte-identical to the host
    engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import kernels as K
    simulate(tmp_path, genome_out="ref.fa", reads_out="r.fq", n_reads=2000,
             read_len=100, chr_len=12000, n_chr=2, seed=9, error_rate=0.02)
    base = ["-a", str(tmp_path / "r.fq"), "-d", str(tmp_path / "ref.fa"),
            "-S", "1", "-v", "2", "-u"]
    K.reset_launch_counts()
    assert cli.run(base + ["-o", str(tmp_path / "gpu.bam")]) == 0
    counts = K.launch_counts()
    assert counts["verify_candidates"] and counts["reduce_reads"], counts
    for out in ("host.bam", "host.sam"):
        assert cli.run(base + ["-o", str(tmp_path / out), "--engine",
                               "host"]) == 0
    for suffix in ("", ".bai"):
        assert (tmp_path / f"gpu.bam{suffix}").read_bytes() == \
            (tmp_path / f"host.bam{suffix}").read_bytes()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bsmap_tpu_torch.cli"] + base
        + ["-o", str(tmp_path / "two.sam"), "--nprocs", "2", "--proc-id",
           str(k), "--device", "cuda"], env=env, cwd=tmp_path)
        for k in (1, 0)]
    try:
        assert [q.wait(timeout=600) for q in procs] == [0, 0]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    assert (tmp_path / "two.sam").read_bytes() == \
        (tmp_path / "host.sam").read_bytes()


@pytest.mark.gpu
def test_cuda_p8_rrbs_trim_is_one_process(tmp_path, monkeypatch):
    """On a CUDA device: -p 8 on single-end RRBS with trimming runs as one
    process (no child process is started) with eight encode threads,
    launches K2-K4 and never K1, and writes the bytes of -p 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the GPU machine)")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import kernels as K
    chip_smoke.make_rrbs_set(tmp_path, n_reads=20000)
    base = ["-a", str(tmp_path / "se.fq"), "-d", str(tmp_path / "rrbs.fa"),
            "-D", "C-CGG", "-A", "AGATCGGAAGAGC", "-q", "2", "-S", "1", "-u"]
    assert cli.run(base + ["-o", str(tmp_path / "p1.sam"), "-p", "1"]) == 0
    monkeypatch.delenv("BSMAP_TPU_LOCAL_MP", raising=False)

    def no_child(*a, **kw):
        raise AssertionError(f"-p 8 started a process: {a}")

    monkeypatch.setattr(subprocess, "Popen", no_child)
    K.reset_launch_counts()
    assert cli.run(base + ["-o", str(tmp_path / "p8.sam"), "-p", "8"]) == 0
    counts = K.launch_counts()
    assert all(counts[k] for k in ("exact_schedule", "verify_candidates",
                                   "reduce_reads")), counts
    assert counts["fixed_schedule"] == 0, counts
    assert (tmp_path / "p8.sam").read_bytes() == \
        (tmp_path / "p1.sam").read_bytes()
