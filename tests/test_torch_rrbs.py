"""Single-end RRBS in the PyTorch port against ``bsmap_tpu``.

One MspI-digested genome (``chip_smoke.make_rrbs_set``: two chromosomes of
random 30-300 bp segments joined by CCGG, so every digestion fragment is
short and the per-chromosome site ranges are exercised) and fragment-start
reads of 60 and 76 nt from both strands, 90% converted, some with one or
two mismatches.  Checked against the JAX package on the CPU:

  * the tag-partitioned tables ``tables_from_numpy`` builds equal the JAX
    engine's device arrays;
  * K2, K3 and K4 with ``cfg.rrbs`` (plain twins, what the wrappers run on
    CPU tensors) equal ``_schedule_impl`` and ``_verify_impl`` at -v 2 and
    -v 4, lean and full rows, and in a -m 100 -x 150 fragment window in
    which the filter rejects hits;
  * ``align_program`` equals ``_align_fused_kernel``;
  * the CLI's bytes equal both ``bsmap_tpu`` engines' (SAM with ZP/ZL,
    trimming, BSP, -R, -r 0, -S 0, the fragment window); pair-end -D with no
    --engine runs the host engine as ``bsmap_tpu``'s default does, and
    under --engine device exits.

All values are int32: every comparison is exact (``np.array_equal``)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bsmap_tpu.engine import device_engine as J
from bsmap_tpu.index import build_index
from bsmap_tpu.params import Param
from bsmap_tpu.readio import open_read_stream
from bsmap_tpu.reference import load_genome
from bsmap_tpu.utils import myrand_hash
from bsmap_tpu_torch.engine import device_engine as T
from bsmap_tpu_torch.engine import kernels as K
from chip_smoke import RRBS_ADAPTER as ADAPT
from chip_smoke import make_rrbs_set

from .test_golden_se import assert_same
from .test_torch_cli import ENV
from .test_torch_kernels import (_jax_program, assert_rows_equal,
                                 jax_schedule, jax_verify,
                                 k4_on_synthetic_counts)


def _param(v: int = 2, window=None) -> Param:
    p = Param()
    p.set_digestion_site("C-CGG")
    p.max_snp_num = v
    p.randseed = 1
    if window:
        p.min_insert, p.max_insert = window
    p.init_mapping()
    return p


@pytest.fixture(scope="module")
def rrbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rrbs")
    make_rrbs_set(d, n_reads=500, n_pairs=250)
    p = _param()
    genome = load_genome(str(d / "rrbs.fa"), p)
    index = build_index(genome, p)
    je = J.DeviceEngine(genome, index, p)
    return {"dir": d, "genome": genome, "index": index, "je": je,
            "tabs": T.tables_from_numpy(genome, index, p)}


def rrbs_rows(world, v: int, maxrank: int) -> np.ndarray:
    """(n, 2*7+4) int32 dispatch rows of se.fq: budgets of -v v, -S 1
    selection hashes, the given maxrank."""
    p = _param(v)
    s = open_read_stream(str(world["dir"] / "se.fq"), p, readset=0)
    batch = s.next_batch(100000)
    s.close()
    je = world["je"]
    saved = je.param
    je.param = p
    try:
        live, buds = je._filter_batch(batch, [None] * len(batch))
        codes, regs, lens, buds, _rs, ridx = je._pack_host(batch, live, buds)
    finally:
        je.param = saved
    rows = J._pack_inputs(codes, regs, lens, buds, myrand_hash(ridx, 1),
                          np.full(len(lens), maxrank, np.int32))
    return np.concatenate([rows[:, :7], rows[:, 10:17], rows[:, 20:]], 1)


def rrbs_cfgs(world, v: int, window=None, **kw):
    je = world["je"]
    cj = J.make_cfg(_param(v, window), je.W, je.genome.n_chr, "f", v + 1,
                    nw=7)._replace(**kw)
    return cj, T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields
                   if f != "shards"})


def port_slots(world, cfg, rows):
    t = world["tabs"]
    return K.exact_schedule(cfg, torch.from_numpy(rows), t["kmer_tab"],
                            t["prof_a"], tag_off=t["tag_off"])


def test_rrbs_tables_match_jax(rrbs):
    """The tag-partitioned tables equal the JAX engine's device arrays:
    raw kmer rows, entries reordered by (bucket, tag class, position),
    their tags, the class offsets, the global sites and their ranges."""
    je, t = rrbs["je"], rrbs["tabs"]
    for k in ("kmer_tab", "wlocs", "clocs", "tags", "tag_off", "sites",
              "site_off", "catcat", "anchors", "sizes", "rcoff"):
        want = np.asarray(getattr(je, f"d_{k}"))
        got = t[k].numpy()
        assert got.shape == want.shape, k
        assert np.array_equal(got, want.view(np.int32)), k
    assert np.array_equal(t["prof_a"].numpy(), np.asarray(je.prof_a))
    assert len(t["site_off"]) == 3 and int(t["site_off"][1]) > 0


@pytest.mark.parametrize("v,rank", [(2, 0), (2, -1), (4, -1)])
def test_rrbs_schedule_twin_matches_jax(rrbs, v, rank):
    """K2 with cfg.rrbs against the RRBS branches of _schedule_impl: slot
    rows (class offsets and counts), zero start offsets, per-rank totals."""
    cj, ct = rrbs_cfgs(rrbs, v)
    rows = rrbs_rows(rrbs, v, rank % ct.maxseg)
    want, _ = jax_schedule(rrbs, cj, rows)
    got = port_slots(rrbs, ct, rows)
    for f, w in zip(("h", "off0", "off3", "wcnt", "cnt", "s_off"),
                    list(want[2:7]) + [want[8]]):
        assert_rows_equal(getattr(got, f).numpy(), w, f"K2 {f}")
    assert_rows_equal(got.ftot_rank.numpy(), want[10], "K2 ftot_rank")
    assert int(got.cnt.sum()) > 0


@pytest.mark.parametrize("v,lean,window,cands", [
    (2, True, None, 16 * J.DEV_BATCH),
    (2, False, None, 16 * J.DEV_BATCH),
    (4, True, None, 16 * J.DEV_BATCH),
    (4, False, None, 16 * J.DEV_BATCH),
    (2, False, None, 64),                  # overflowing capacity
    (2, False, (100, 150), 16 * J.DEV_BATCH),
])
def test_rrbs_reduce_twin_matches_jax(rrbs, v, lean, window, cands):
    """K3 and K4 with cfg.rrbs (on K2's slots) against _verify_impl: lean
    and full rows at -v 2 and -v 4, an overflowing capacity, and a
    -m 100 -x 150 fragment window in which the filter rejects hits that
    the default window keeps."""
    cj, ct = rrbs_cfgs(rrbs, v, window, lean=lean)
    rows = rrbs_rows(rrbs, v, ct.maxseg - 1)
    sched, scal = jax_schedule(rrbs, cj, rows)
    want = jax_verify(rrbs, cj, cands, sched, scal)
    slots = port_slots(rrbs, ct, rows)
    r = torch.from_numpy(rows)
    vc = K.verify_candidates(ct, cands, r, slots, rrbs["tabs"])
    got = K.reduce_reads(ct, cands, r, vc, slots).numpy()
    assert_rows_equal(got, want, "K4 rows")
    info = vc.info.numpy()
    first = (info & K.INFO_FIRST) != 0
    rejected = int((first & ((info & K.INFO_FRAG) == 0)).sum())
    found = (got[:, 1] & 1) if lean else got[:, 2 * ct.maxseg]
    if window:
        assert rejected > 0, "the fragment window rejected no hit"
        _, c0 = rrbs_cfgs(rrbs, v, None, lean=lean)
        base = K.reduce_reads(c0, cands, r, K.verify_candidates(
            c0, cands, r, slots, rrbs["tabs"]), slots).numpy()
        assert base[:, 2 * ct.maxseg].sum() > found.sum()
    if cands < len(rows):
        assert (got[:, 2 * ct.maxseg + K.X_OK] == 0).any()
    elif not window:
        assert found.sum() > len(rows) // 2


def test_rrbs_reduce_twin_matches_jax_on_synthetic_counts(rrbs):
    """K4 with cfg.rrbs, after K3, on chip_smoke.py's synthetic slot
    counts of 0-2 candidates a slot (reads spanning several chunks of a
    K4 group, forward hits bound to the fragment filter), full rows,
    against _verify_impl's rows, every column; exact."""
    cj, ct = rrbs_cfgs(rrbs, 2, lean=False)
    rows = rrbs_rows(rrbs, 2, ct.maxseg - 1)
    got, want = k4_on_synthetic_counts(rrbs, cj, ct, rows,
                                       port_slots(rrbs, ct, rows),
                                       "every slot 0-2", 16 * J.DEV_BATCH)
    assert_rows_equal(got, want, "K4 rrbs, every slot 0-2")
    assert got[:, 2 * ct.maxseg + K.X_FOUND].sum() > 0


@pytest.mark.parametrize("v,lean", [(2, True), (4, False)])
def test_rrbs_align_program_matches_jax(rrbs, v, lean):
    """The whole RRBS program: align_program on live rows against
    _align_fused_kernel on the rows zero-padded to B."""
    cj, ct = rrbs_cfgs(rrbs, v, lean=lean)
    rows = rrbs_rows(rrbs, v, ct.maxseg - 1)
    cands = 16 * J.DEV_BATCH
    want = _jax_program(rrbs, cj, cands, rows)
    got = K.align_program(ct, cands, rrbs["tabs"],
                          torch.from_numpy(rows)).numpy()
    assert_rows_equal(got, want, "align_program rrbs")


def _cli(d, module, args, ok=True):
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=d,
                       capture_output=True, env=ENV)
    assert (r.returncode == 0) == ok, r.stderr.decode()
    return r


@pytest.mark.parametrize("flags,suffix", [
    (["-S", "1", "-v", "2", "-u"], "sam"),
    (["-S", "1", "-v", "2", "-u", "-A", ADAPT, "-q", "2"], "sam"),
    (["-S", "2", "-v", "4", "-u"], "bsp"),
    (["-S", "1", "-v", "2", "-u", "-R"], "sam"),
    (["-S", "3", "-v", "2", "-u", "-r", "0"], "sam"),
    (["-S", "0", "-v", "2", "-u"], "sam"),
    (["-S", "1", "-v", "2", "-u", "-m", "100", "-x", "150"], "sam"),
])
def test_torch_cli_rrbs_matches_jax_engines(rrbs, flags, suffix):
    """-D C-CGG: the port's SAM (ZP/ZL tags) and BSP bytes on the CPU
    equal bsmap_tpu's device and host engines' (-S 0 with the rand_r seed
    pinned)."""
    d = rrbs["dir"]
    tag = "_".join(flags).replace("-", "")
    base = ["-a", "se.fq", "-d", "rrbs.fa", "-D", "C-CGG"] + flags
    runs = (("torch", "bsmap_tpu_torch.cli", ["--device", "cpu"]),
            ("device", "bsmap_tpu.cli", ["--engine", "device"]),
            ("host", "bsmap_tpu.cli", ["--engine", "host"]))
    for name, module, extra in runs:
        _cli(d, module, base + ["-o", f"{name}_{tag}.{suffix}"] + extra)
    assert_same(d, f"host_{tag}.{suffix}", f"torch_{tag}.{suffix}")
    assert_same(d, f"device_{tag}.{suffix}", f"torch_{tag}.{suffix}")
    if suffix == "sam":
        assert b"\tZP:i:" in (d / f"torch_{tag}.sam").read_bytes()


def test_torch_cli_rrbs_pair_end(rrbs):
    """Pair-end -D with no --engine: both packages' ``auto`` finds the
    device PE engine unsupported and runs the host engine, so the port's
    bytes equal ``python -m bsmap_tpu.cli``'s with no --engine (and its
    host engine's), stderr says which engine ran and why, and ``stats``
    names it."""
    from bsmap_tpu_torch import cli
    d = rrbs["dir"]
    base = ["-a", "pe1.fq", "-b", "pe2.fq", "-d", "rrbs.fa", "-D", "C-CGG",
            "-S", "1", "-v", "2", "-u", "-A", ADAPT]
    r = _cli(d, "bsmap_tpu_torch.cli", base + ["-o", "tpe.sam", "--device",
                                               "cpu"])
    assert (b"engine: host (--engine auto: device PE: RRBS runs on the "
            b"host engine)") in r.stderr
    _cli(d, "bsmap_tpu.cli", base + ["-o", "jpe.sam"])
    _cli(d, "bsmap_tpu.cli", base + ["-o", "hpe.sam", "--engine", "host"])
    assert_same(d, "jpe.sam", "tpe.sam")
    assert_same(d, "hpe.sam", "tpe.sam")
    assert (d / "tpe.sam").stat().st_size > 0
    st = {}     # -p 1: this process aligns (the default -p 8 starts workers)
    argv = [str(d / a) if a.endswith((".fq", ".fa")) else a for a in base]
    assert cli.run(argv + ["-o", str(d / "spe.sam"), "--device", "cpu",
                           "-p", "1"], stats=st) == 0
    assert st["engine_name"] == "host"
    assert type(st["engine"]).__name__ == "HostPairBatch"
    assert_same(d, "hpe.sam", "spe.sam")


@pytest.mark.parametrize("engine", ["device", "sharded"])
def test_torch_cli_rrbs_pair_end_named_engine_refuses(rrbs, engine):
    """Pair-end -D under an engine named explicitly still refuses, as
    bsmap_tpu's does: no silent host run, no output file."""
    d = rrbs["dir"]
    base = ["-a", "pe1.fq", "-b", "pe2.fq", "-d", "rrbs.fa", "-D", "C-CGG",
            "-S", "1", "-v", "2", "-u", "-A", ADAPT]
    r = _cli(d, "bsmap_tpu_torch.cli",
             base + ["-o", f"never_{engine}.sam", "--device", "cpu",
                     "--engine", engine], ok=False)
    assert b"device PE: RRBS runs on the host engine" in r.stderr
    assert not (d / f"never_{engine}.sam").exists()
