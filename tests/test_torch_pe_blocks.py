"""The pair-end native block path of the PyTorch port with BSP (-2), -R,
adapter and quality trimming, -z, -S 0, -r 0 and -n 1 (``--device cpu``:
the kernels' plain twins): byte parity with ``bsmap_tpu``'s host and
device engines on pairs with short inserts read into the adapter, some
mates trimmed and some filtered (one mate of a pair, and both), each run
held to the block path and to one FilterReads pass a read; and the
pair-end encode pool at -p 4 with blocks finishing out of order."""

import os
import re
import subprocess
import sys
import threading
import time

import pytest

from bsmap_tpu_torch.trim import filter_read

from .conftest import REPO, simulate
from .test_golden_se import assert_same
from .test_pe_corners import repeat_pe_data  # noqa: F401 (fixture)

ADAPTER = "AGATCGGAAGAGC"
TRIM = ["-A", ADAPTER, "-q", "20"]
# -s 12: a small seed table, the same for all three engines
ENV = {"PYTHONPATH": str(REPO), "BSMAP_TPU_CPU_JIT_CACHE": "1",
       "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
       "BSMAP_TPU_DEV_BATCH": "128", "BSMAP_TPU_CANDS_PER_READ": "16",
       "HOME": os.path.expanduser("~"), "BSMAP_TPU_RANDR_SEED": "99",
       "BSMAP_TPU_LOCAL_MP": "0"}
# (flags, output suffix, pairs with a filtered mate expected)
CASES = {
    "bsp": (["-S", "2", "-v", "2"] + TRIM, "bsp", True),
    "xr": (["-S", "1", "-v", "2", "-R", "-u"], "sam", True),
    "trim": (["-S", "2", "-v", "3", "-u"] + TRIM, "sam", True),
    "z_q": (["-S", "1", "-v", "2", "-u", "-z", "40", "-q", "2"], "sam",
            True),
    "s0": (["-S", "0", "-v", "2", "-u"] + TRIM, "bsp", True),
    "r0": (["-S", "3", "-v", "2", "-u", "-r", "0"] + TRIM, "sam", True),
    "n1": (["-S", "1", "-v", "2", "-u", "-n", "1"] + TRIM, "sam", True),
}


@pytest.fixture(scope="module")
def pe_data(tmp_path_factory):
    """300 pairs of 76 nt over inserts of 30-200 with the adapter read
    into; mate 1 of every 7th pair and mate 2 of every 11th end in
    quality 2 after 8 bases (-q filters them: both mates of pairs 3, 80,
    157, 234), every 5th pair's mates after 40 (-q trims them), and mate
    1 of every 13th pair carries 8 Ns (filtered with or without -q)."""
    d = tmp_path_factory.mktemp("torch_pe_blocks")
    simulate(d, genome_out="ref.fa", reads_out="a1.fq", reads2_out="a2.fq",
             pe=True, n_reads=300, read_len=76, chr_len=30000, n_chr=2,
             seed=26, error_rate=0.02, insert_min=30, insert_max=200,
             adapter=ADAPTER)
    for name, every in (("a1.fq", 7), ("a2.fq", 11)):
        lines = (d / name).read_text().splitlines()
        for k in range(0, len(lines), 4):
            i, seq, q = k // 4, lines[k + 1], lines[k + 3]
            if i % every == 3:
                q = q[:8] + "#" * (len(q) - 8)
            elif i % 5 == 1:
                q = q[:40] + "#" * (len(q) - 40)
            if name == "a1.fq" and i % 13 == 5:
                seq = seq[:20] + "N" * 8 + seq[28:]
            lines[k + 1], lines[k + 3] = seq, q
        (d / name).write_text("\n".join(lines) + "\n")
    return d


@pytest.fixture
def block_path_only(monkeypatch):
    """The port's engine with its per-pair path and every Python
    FilterReads pass made to raise: a run that passes took the block path
    and filtered each read once, natively.  128-pair windows."""
    from bsmap_tpu_torch import trim
    from bsmap_tpu_torch.engine import device_engine, pair_device, pair_host

    def never(*_a, **_k):
        raise AssertionError("off the block path")

    for mod in (trim, pair_device, pair_host, device_engine):
        monkeypatch.setattr(mod, "filter_read", never)
    monkeypatch.setattr(pair_device.PairDeviceEngine, "align_batch", never)
    monkeypatch.setattr(pair_device.PairDeviceEngine, "format_batch", never)
    monkeypatch.setattr(device_engine, "DEV_BATCH", 128)
    monkeypatch.setattr(device_engine, "CANDS_PER_READ", 16)
    for k, v in ENV.items():
        if k.startswith("BSMAP_TPU"):
            monkeypatch.setenv(k, v)


def _start_jax(d, base, outs) -> list:
    """Start bsmap_tpu's host and device engines on ``base``, side by
    side; ``outs`` maps each -o/-2 flag to a file name (prefixed by the
    engine's name).  ``_wait`` ends them."""
    procs = []
    for eng in ("host", "device"):
        files = [x for flag, name in outs.items()
                 for x in (flag, f"{eng}_{name}")]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bsmap_tpu.cli"] + base + files
            + ["--engine", eng], cwd=d, env=ENV, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    return procs


def _wait(procs) -> None:
    for pr in procs:
        _, err = pr.communicate(timeout=600)
        assert pr.returncode == 0, err.decode()


def _port(d, argv, monkeypatch):
    from bsmap_tpu_torch import cli
    monkeypatch.chdir(d)
    st = {}
    assert cli.run(argv + ["--device", "cpu", "-p", "1"], stats=st) == 0
    return st


def _refiltered(d, argv, suffix) -> set:
    """Names (without /1, /2) of the reads on which a second FilterReads
    pass differs from the first (sequence, quality, verdict or mismatch
    budget, which the second pass takes against the trimmed length): the
    only reads where bsmap_tpu's device engine, which filters its replayed
    pairs twice (ROADMAP C), may print other bytes than its host
    engine."""
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.readio import open_read_stream
    o = cli.parse_args(argv + ["-o", f"x.{suffix}"])
    p = o.param
    p.out_sam = int(suffix == "sam")
    out = set()
    for readset, path in ((1, o.query_a), (2, o.query_b)):
        stream = open_read_stream(str(d / path), p, readset=readset)
        while batch := stream.next_batch(1000):
            for rd in batch:
                once = (*filter_read(rd, p), rd.seq, rd.qual)
                if (*filter_read(rd, p), rd.seq, rd.qual) != once:
                    out.add(_pair_name(rd.name))
        stream.close()
    return out


def _pair_name(name: str) -> str:
    """A read's name in either output: without /1 or /2, cut after its
    last digit (FixPairReadName's cut in SAM output)."""
    name = name[:-2] if name[-2:] in ("/1", "/2") else name
    m = re.match(r"(.*\d)", name)
    return m.group(1) if m else name


def _assert_same_but(d, a, b, names: set) -> None:
    """Files ``a`` and ``b`` list the same reads in the same order, and
    their lines differ only for reads in ``names``."""
    def by_read(path):
        groups: dict = {}
        for ln in (d / path).read_bytes().decode("latin1").split("\n"):
            groups.setdefault(_pair_name(ln.split("\t", 1)[0]),
                              []).append(ln)
        return groups
    ga, gb = by_read(a), by_read(b)
    assert [k for k in ga if k not in names] == \
        [k for k in gb if k not in names]
    bad = [k for k in ga if k not in names and ga[k] != gb.get(k)]
    assert not bad, f"{a} != {b} at reads {bad[:5]}"


def _three_way(d, base, outs, monkeypatch, suffix="sam"):
    """The port in this process (on the block path) while both bsmap_tpu
    engines run: every output file byte-identical to the host engine's,
    and to the device engine's but for the reads its second FilterReads
    pass changes (``_refiltered``).  Returns the port's stats."""
    procs = _start_jax(d, base, outs)
    try:
        st = _port(d, base + [x for flag, name in outs.items()
                              for x in (flag, f"torch_{name}")],
                   monkeypatch)
    finally:
        _wait(procs)
    refiltered = _refiltered(d, base, suffix)
    for name in outs.values():
        assert_same(d, f"host_{name}", f"torch_{name}")
        _assert_same_but(d, f"device_{name}", f"torch_{name}", refiltered)
    assert st["pe_path"] == "blocks"
    return st


@pytest.mark.parametrize("case", sorted(CASES))
def test_pe_block_path_matches_jax_engines(pe_data, block_path_only,
                                           monkeypatch, case):
    """Each configuration on the block path: SAM, or BSP with the -2
    file, byte-identical to both bsmap_tpu engines; the pairs with a
    filtered mate (one or both) run on the host engine from the native
    filter's reads and verdicts, counted apart from the replays."""
    flags, suffix, filtered = CASES[case]
    base = ["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12"] + flags
    outs = {"-o": f"{case}.{suffix}"}
    if suffix == "bsp":
        outs["-2"] = f"{case}_u.bsp"
    st = _three_way(pe_data, base, outs, monkeypatch, suffix)
    eng = st["engine"]
    assert (eng.n_mate_filtered > 0) is filtered
    assert st["pairs"] == 300
    # every host pair ran on the native aligner
    assert eng.host_native == eng.n_replayed + eng.n_mate_filtered > 0
    if suffix == "bsp":
        assert (pe_data / f"torch_{case}_u.bsp").stat().st_size > 0


def test_pe_block_path_python_host_fallback(pe_data, block_path_only,
                                            monkeypatch):
    """Where the native host aligner does not load, the host pairs run on
    the Python host engine: the trimmed case's bytes are those of both
    bsmap_tpu engines, and no pair is counted as native."""
    from bsmap_tpu_torch.native import host_align
    monkeypatch.setattr(host_align, "get_lib", lambda: None)
    flags, suffix, _ = CASES["trim"]
    base = ["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12"] + flags
    st = _three_way(pe_data, base, {"-o": f"fallback.{suffix}"},
                    monkeypatch, suffix)
    eng = st["engine"]
    assert eng.se.native is None
    assert eng.host_native == 0
    assert eng.n_replayed + eng.n_mate_filtered > 0


def test_pe_block_path_native_sync_matches_python_sync(pe_data,
                                                       block_path_only,
                                                       monkeypatch):
    """The trimmed case's MateState syncs in one native call a span
    (``NativeHost.sync_span``) and, with that call made to decline, on
    the Python path over Read objects: byte-identical SAM, each run's
    syncs all counted on its own side."""
    from bsmap_tpu_torch.engine.native_host import NativeHost
    flags, suffix, _ = CASES["trim"]
    base = ["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12"] + flags
    se = []
    for name, patch in (("sync_native", False), ("sync_python", True)):
        if patch:
            monkeypatch.setattr(NativeHost, "sync_span",
                                lambda *_a, **_k: False)
        st = _port(pe_data, base + ["-o", f"{name}.{suffix}"], monkeypatch)
        assert st["pe_path"] == "blocks"
        se.append(st["engine"].se)
    assert se[0].host_sync_native > 0 and se[0].host_sync_python == 0
    assert se[1].host_sync_native == 0
    assert se[1].host_sync_python == se[0].host_sync_native
    assert_same(pe_data, f"sync_native.{suffix}", f"sync_python.{suffix}")


def test_pe_block_path_repeat_corners_bsp_s0(repeat_pe_data, block_path_only,
                                              monkeypatch):
    """The repeat-heavy pairs of test_pe_corners (multi-hit pairs and
    mates, an unmappable mate in every third pair) as BSP with -2 under
    -S 0: the host replays' rand_r draws are taken in pair order while
    the native formatter writes every pair; both files byte-identical to
    both bsmap_tpu engines."""
    base = ["-a", "p1.fq", "-b", "p2.fq", "-d", "g.fa", "-s", "12", "-S",
            "0", "-v", "2", "-u"]
    st = _three_way(repeat_pe_data, base,
                    {"-o": "rep_s0.bsp", "-2": "rep_s0_u.bsp"}, monkeypatch,
                    "bsp")
    assert st["engine"].n_replayed > 0


def test_pe_encode_pool_matches_host_engine(pe_data, block_path_only,
                                            monkeypatch):
    """-p 4 in one process on the pair-end block path: four encode
    threads over blocks of one 32-pair window, every even-numbered block
    pair held back so that the pairs finish encoding out of file order;
    the align loop takes them in file order, so both BSP files are
    byte-identical to the host engine's."""
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import device_engine, pair_device
    from bsmap_tpu_torch.engine import pair_pipeline
    monkeypatch.setattr(device_engine, "DEV_BATCH", 32)
    monkeypatch.setattr(pair_pipeline, "PE_BLOCK_WINDOWS", 1)
    eng = pair_device.PairDeviceEngine
    encode = eng.encode_block_pair
    seen = []

    def slow_encode(self, ba, bb):
        if ba.enc is None and (ba.start_index // 32) % 2 == 0:
            time.sleep(0.05)
        seen.append((ba.start_index, threading.current_thread().name))
        return encode(self, ba, bb)

    monkeypatch.setattr(eng, "encode_block_pair", slow_encode)
    flags, suffix, _ = CASES["bsp"]
    base = ["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12"] + flags
    outs = {"-o": "pool.bsp", "-2": "pool_u.bsp"}
    _wait(_start_jax(pe_data, base, outs))
    monkeypatch.chdir(pe_data)
    st = {}
    assert cli.run(base + ["-o", "torch_pool.bsp", "-2", "torch_pool_u.bsp",
                           "--device", "cpu", "-p", "4"], stats=st) == 0
    assert st["pe_path"] == "blocks" and st["pairs"] == 300
    pool = [(s, t) for s, t in seen if t.startswith("bsmap_pe_encode")]
    firsts = [s for s, _ in pool]
    assert len(set(firsts)) == 10 and len({t for _, t in pool}) > 1
    for name in outs.values():
        assert_same(pe_data, f"host_{name}", f"torch_{name}")


def test_pe_encode_error_ends_the_run(pe_data, block_path_only,
                                      monkeypatch):
    """An encode thread that raises on the second block pair ends the
    run with that error within a time limit of its own: no thread is left
    waiting on a queue."""
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import pair_device
    eng = pair_device.PairDeviceEngine
    encode = eng.encode_block_pair

    def second_fails(self, ba, bb):
        if ba.start_index // 128 == 1:
            raise ValueError("encode failed on the second block pair")
        return encode(self, ba, bb)

    monkeypatch.setattr(eng, "encode_block_pair", second_fails)
    monkeypatch.chdir(pe_data)
    got = []

    def run():
        try:
            cli.run(["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s",
                     "12", "-o", "fail.bsp", "-2", "fail_u.bsp", "--device",
                     "cpu", "-p", "4"] + TRIM)
        except BaseException as e:      # noqa: BLE001 (the run's outcome)
            got.append(e)

    before = threading.active_count()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the run hung after an encode error"
    assert len(got) == 1 and isinstance(got[0], ValueError)
    assert "second block pair" in str(got[0])
    time.sleep(0.5)
    assert threading.active_count() <= before


def test_pe_bsp_without_unpaired_file_fails(pe_data, block_path_only,
                                            monkeypatch):
    """BSP output without -2 fails the block path's run as the per-pair
    path's does, before any output is written."""
    from bsmap_tpu_torch import cli
    monkeypatch.chdir(pe_data)
    with pytest.raises(SystemExit) as e:
        cli.run(["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12",
                 "-o", "no_u.bsp", "--device", "cpu", "-p", "1"])
    assert "check -2 option" in str(e.value)
    assert not (pe_data / "no_u.bsp").exists()


@pytest.mark.parametrize("suffix", ["sam", "bsp"])
def test_pair_program_counts_only_under_bsp(pe_data, block_path_only,
                                            monkeypatch, suffix):
    """The block path's ``pair_program`` returns the (n, 11) J rows alone
    under SAM; under BSP each mate's 2*maxseg per-level counts follow,
    equal to the first columns of that mate's full rows (K2-K4), and the J
    rows are the same as without them."""
    import torch
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import kernels as K
    orig = K.pair_program
    widths = []

    def pair_program(cfg_a, cfg_b, cands, tables, rows_a, rows_b,
                     counts=False):
        out = orig(cfg_a, cfg_b, cands, tables, rows_a, rows_b, counts)
        widths.append(out.shape[1])
        j = orig(cfg_a, cfg_b, cands, tables, rows_a, rows_b)
        assert torch.equal(out[:, :K.JN_COLS], j)
        w = 2 * cfg_a.maxseg if counts else 0
        for k, (cfg, rows) in enumerate(((cfg_a, rows_a), (cfg_b, rows_b))):
            full = K.align_program(cfg, cands, tables, rows)
            got = out[:, K.JN_COLS + k * w: K.JN_COLS + (k + 1) * w]
            assert torch.equal(got, full[:, :w])
        return out

    monkeypatch.setattr(K, "pair_program", pair_program)
    monkeypatch.chdir(pe_data)
    outs = ["-o", f"w.{suffix}"] + (["-2", "w_u.bsp"] if suffix == "bsp"
                                    else [])
    st = {}
    assert cli.run(["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s",
                    "12", "-S", "2", "-v", "2", "--device", "cpu", "-p",
                    "1"] + TRIM + outs, stats=st) == 0
    ms = st["engine"].MS
    want = K.JN_COLS + (4 * ms if suffix == "bsp" else 0)
    assert widths and set(widths) == {want}
