"""Rows of the PyTorch port's kernel twins against the JAX program.

Both packages get the same numpy inputs: one simulated genome and seed
index (built by ``bsmap_tpu``), and dispatch rows packed from simulated
reads of 50 nt, 100 nt (both nw = 7), 130 nt (nw = 10) and the mixed
50/51 nt stale-schedule set.  The JAX side runs on the CPU exactly as the
JAX package's own tests run it; the port side runs the plain-torch twins
(what every kernel wrapper runs for a CPU tensor).  All values are int32,
so every comparison is exact (``np.array_equal``)."""

import functools

import jax
import jax.numpy as jnp
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

from .conftest import simulate

HITS_K = 48


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_kernels")
    for L in (50, 100, 130):
        simulate(d, genome_out="ref.fa", reads_out=f"r{L}.fq", n_reads=300,
                 read_len=L, chr_len=12000, n_chr=3, seed=5, error_rate=0.02)
    simulate(d, genome_out="ref.fa", reads_out="rm_raw.fq", n_reads=300,
             read_len=51, chr_len=12000, n_chr=3, seed=5, error_rate=0.02)
    raw = (d / "rm_raw.fq").read_text().splitlines()
    out = []
    for k in range(0, len(raw), 4):
        name, seq, plus, qual = raw[k: k + 4]
        if (k // 4) % 2 == 0:
            seq, qual = seq[:50], qual[:50]
        out += [name, seq, plus, qual]
    (d / "rmix.fq").write_text("\n".join(out) + "\n")

    p = Param()
    p.randseed = 1
    p.init_mapping()
    genome = load_genome(str(d / "ref.fa"), p)
    index = build_index(genome, p)
    je = J.DeviceEngine(genome, index, p)
    tabs = T.tables_from_numpy(genome, index, p)
    return {"dir": d, "genome": genome, "index": index, "je": je,
            "tabs": tabs, "rows": {}}


def _param(v: int, S: int = 16, I: int = 4) -> Param:
    p = Param()
    p.max_snp_num = v
    p.randseed = 1
    if S != 16:
        p.set_seed_size(S)
    p.index_interval = I
    p.init_mapping()
    return p


def small_seed_world(world, S: int = 12, I: int = 3) -> dict:
    """A world's genome indexed at -s S -I I (at -s 12 a 3^12-row table),
    its JAX engine and port tables."""
    p = _param(2, S, I)
    index = build_index(world["genome"], p)
    return {"dir": world["dir"], "genome": world["genome"], "S": S, "I": I,
            "je": J.DeviceEngine(world["genome"], index, p),
            "tabs": T.tables_from_numpy(world["genome"], index, p),
            "rows": world["rows"]}


def rows_of(world, name: str, v: int, maxrank: int) -> np.ndarray:
    """(n, 2nw+4) int32 dispatch rows of one read set: budgets of -v v,
    myrand selection hashes (-S 1), the given maxrank."""
    key = (name, v)
    if key not in world["rows"]:
        p = _param(v)
        s = open_read_stream(str(world["dir"] / name), p, readset=0)
        batch = s.next_batch(100000)
        s.close()
        res = [None] * len(batch)
        je = world["je"]
        saved = je.param
        je.param = p                 # budgets of this -v
        try:
            live, buds = je._filter_batch(batch, res)
            codes, regs, lens, buds, _rs, ridx = je._pack_host(batch, live,
                                                               buds)
        finally:
            je.param = saved
        rows = J._pack_inputs(codes, regs, lens, buds, myrand_hash(ridx, 1),
                              np.zeros(len(lens), np.int32))
        if lens.max() <= 112:        # nw = 7 layout (native encoder's)
            rows = np.concatenate([rows[:, :7], rows[:, 10:17],
                                   rows[:, 20:]], axis=1)
        world["rows"][key] = rows
    rows = world["rows"][key].copy()
    rows[:, -1] = maxrank
    return rows


def cfgs(world, v: int, nw: int, **kw):
    """(JAX Cfg, port Cfg) of one program at the world's seed size."""
    je = world["je"]
    p = _param(v, world.get("S", 16), world.get("I", 4))
    maxseg = min(15, v) + 1
    cj = J.make_cfg(p, je.W, je.genome.n_chr, "f", maxseg, nw=nw)._replace(**kw)
    return cj, T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields
                   if f != "shards"})


@functools.lru_cache(maxsize=None)
def _jit_schedule(cfg):
    return jax.jit(functools.partial(J._schedule_impl, cfg))


@functools.lru_cache(maxsize=None)
def _jit_verify(cfg, cands):
    return jax.jit(functools.partial(J._verify_impl, cfg, cands))


def jax_schedule(world, cfg, rows, kmer_tab=None):
    """_schedule_impl on the world's tables (``kmer_tab``, a numpy table,
    in place of its own where given)."""
    a = world["je"]._engine_args()
    qw, rw, lens, buds, rand32, maxrank = J._unpack_inputs(jnp.asarray(rows))
    kt = a[1] if kmer_tab is None else jnp.asarray(kmer_tab)
    out = _jit_schedule(cfg)(a[0], kt, a[2], a[14], a[3], a[4], qw, rw,
                             lens, buds, maxrank)
    return out, (lens, buds, rand32, maxrank)


def jax_verify(world, cfg, cands, sched, scal):
    a = world["je"]._engine_args()
    qw, rw, h, off0, off3, wcnt, cnt, wantv, s_off, c_off, ftot_rank = sched
    lens, buds, rand32, maxrank = scal
    return np.asarray(_jit_verify(cfg, cands)(
        a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12], a[13],
        qw, rw, lens, buds, rand32, maxrank, h, off0, off3, wcnt, cnt,
        wantv, s_off, c_off, ftot_rank[:, -1]))


def port_schedule(world, cfg, rows):
    t = world["tabs"]
    r = torch.from_numpy(rows)
    if cfg.fixed:
        return K.fixed_schedule(cfg, r, t["kmer_tab"])
    return K.exact_schedule(cfg, r, t["kmer_tab"], t["prof_a"],
                            probe=cfg.probe)


def assert_rows_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.nonzero((got != want).reshape(len(got), -1).any(axis=1))[0]
    assert len(bad) == 0, (f"{what}: {len(bad)} rows differ, first "
                           f"{bad[:3]}: {got[bad[0]]} vs {want[bad[0]]}")


# (read set, -v, maxrank: 0 = round-1 start rank, -1 = full rank)
SCHED_CASES = [("r100.fq", 2, 0), ("r130.fq", 4, -1), ("r50.fq", 4, 0),
               ("rmix.fq", 2, -1)]


@pytest.mark.parametrize("name,v,rank", SCHED_CASES)
def test_fixed_schedule_twin_matches_jax(world, name, v, rank):
    """K1 against _fixed_schedule_impl + the fixed branch of
    _schedule_impl: slot rows and per-rank totals."""
    rows = rows_of(world, name, v, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, v, nw, fixed=True, lean=True)
    rows[:, -1] = rank % ct.maxseg
    want, _ = jax_schedule(world, cj, rows)
    got = port_schedule(world, ct, rows)
    for f, w in zip(("h", "off0", "off3", "wcnt", "cnt"), want[2:7]):
        assert_rows_equal(getattr(got, f).numpy(), w, f"K1 {f}")
    assert_rows_equal(got.ftot_rank.numpy(), want[10], "K1 ftot_rank")


@pytest.mark.parametrize("name,v,rank", SCHED_CASES)
def test_exact_schedule_twin_matches_jax(world, name, v, rank):
    """K2 against _schedule_impl's exact path: slot rows, chosen start
    offset, per-rank totals; and the probe pass's totals."""
    rows = rows_of(world, name, v, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, v, nw)
    rows[:, -1] = rank % ct.maxseg
    want, _ = jax_schedule(world, cj, rows)
    got = port_schedule(world, ct, rows)
    for f, w in zip(("h", "off0", "off3", "wcnt", "cnt", "s_off"),
                    list(want[2:7]) + [want[8]]):
        assert_rows_equal(getattr(got, f).numpy(), w, f"K2 {f}")
    assert_rows_equal(got.ftot_rank.numpy(), want[10], "K2 ftot_rank")
    probe = port_schedule(world, ct._replace(probe=True), rows)
    assert_rows_equal(probe.ftot_rank.numpy(), want[10], "K2 probe totals")


def _hit_lists(vc, n: int, NB: int, cands: int):
    """K3's output as _verify_impl's compacted hit columns: per read the
    first HITS_K candidates that are first of their dedup key, in
    discovery order, as (starts int64, hit locs, hit words)."""
    starts = vc.starts.numpy().astype(np.int64)
    info = vc.info.numpy()
    loc = np.zeros((n, HITS_K), np.int32)
    w1 = np.full((n, HITS_K), -1, np.int32)
    for r in range(n):
        lo = starts[r * NB]
        hi = min(starts[(r + 1) * NB], cands)
        acc = [s for s in range(lo, hi) if info[s] & K.INFO_FIRST]
        for j, s in enumerate(acc[:HITS_K]):
            wmm = (info[s] >> K.INFO_WMM_SHIFT) & 0xFF
            rank = (info[s] >> K.INFO_RANK_SHIFT) & 0x1F
            loc[r, j] = vc.wloc[s]
            w1[r, j] = wmm | (rank << 5) | (int(vc.chrp[s]) << 9)
    return starts, loc, w1


@pytest.mark.parametrize("name,v,cands", [("r100.fq", 2, 4096),
                                          ("r130.fq", 4, 4096),
                                          ("r100.fq", 4, 4)])
def test_verify_candidates_twin_matches_jax(world, name, v, cands):
    """K3's accepted-candidate lists against _verify_impl run with pair-end
    semantics (no early exit) and hit compaction, which returns every
    deduplicated in-budget candidate of a read in discovery order."""
    rows = rows_of(world, name, v, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, v, nw)
    rows[:, -1] = ct.maxseg - 1
    sched, scal = jax_schedule(world, cj, rows)
    full = jax_verify(world, cj._replace(pe=True, hits_k=HITS_K), cands,
                      sched, scal)
    slots = port_schedule(world, ct, rows)
    vc = K.verify_candidates(ct, cands, torch.from_numpy(rows), slots,
                             world["tabs"])
    NB, MS = ct.maxseg * ct.I, ct.maxseg
    n = len(rows)
    starts, loc, w1 = _hit_lists(vc, n, NB, cands)
    ex = 2 * MS + J.N_EXTRAS
    assert (w1 >= 0).any(), "no accepted candidates: vacuous comparison"
    assert_rows_equal(loc, full[:, ex: ex + HITS_K], "K3 hit locs")
    assert_rows_equal(w1, full[:, ex + HITS_K:], "K3 hit words")
    totals = np.diff(np.append(starts[::NB][:n], starts[-1]))
    assert_rows_equal(totals, full[:, 2 * MS + J.X_TOTAL], "K3 totals")
    if cands < 100:
        assert (totals > cands).any(), "small capacity did not overflow"


@pytest.mark.parametrize("name,v,lean,fixed,cands", [
    ("r100.fq", 2, True, True, 4096),
    ("r100.fq", 4, True, False, 4),
    ("r130.fq", 4, False, False, 4096),
    ("rmix.fq", 2, False, False, 4096),
])
def test_reduce_reads_twin_matches_jax(world, name, v, lean, fixed, cands):
    """K4 (on K3's output) against _verify_impl's per-read half: lean rows
    (with the fixed-schedule multi bit) and full rows."""
    rows = rows_of(world, name, v, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, v, nw, lean=lean, fixed=fixed)
    sched, scal = jax_schedule(world, cj, rows)
    want = jax_verify(world, cj, cands, sched, scal)
    slots = port_schedule(world, ct, rows)
    r = torch.from_numpy(rows)
    vc = K.verify_candidates(ct, cands, r, slots, world["tabs"])
    got = K.reduce_reads(ct, cands, r, vc, slots).numpy()
    assert_rows_equal(got, want, "K4 rows")


def _jax_program(world, cfg, cands, rows):
    B = J.DEV_BATCH
    pad = np.zeros((B, rows.shape[1]), np.int32)
    pad[: len(rows)] = rows
    out = J._align_fused_kernel(cfg, cands, *world["je"]._engine_args(),
                                jnp.asarray(pad))
    return np.asarray(out)[: len(rows)]


@pytest.mark.parametrize("name,v,mode,cands_per_b", [
    ("r100.fq", 2, "fixed", 2),
    ("r100.fq", 2, "exact_lean", 0),     # capacity 2: overflow rows
    ("r130.fq", 4, "exact_full", 2),
    ("rmix.fq", 2, "exact_full", 16),
    ("r50.fq", 4, "probe", 0),
    ("r130.fq", 4, "fixed", 0),
])
def test_align_program_matches_jax(world, name, v, mode, cands_per_b):
    """The whole program: align_program on live rows only against
    _align_fused_kernel on the same rows zero-padded to B, with the
    capacity a multiple of B (or tiny, so some reads overflow)."""
    rows = rows_of(world, name, v, 0)
    nw = (rows.shape[1] - 4) // 2
    kw = {"fixed": dict(fixed=True, lean=True), "exact_lean": dict(lean=True),
          "exact_full": {}, "probe": dict(probe=True)}[mode]
    cj, ct = cfgs(world, v, nw, **kw)
    cands = cands_per_b * J.DEV_BATCH or 2
    if not cands_per_b:
        rows[:, -1] = ct.maxseg - 1      # full rank: several per read
    want = _jax_program(world, cj, cands, rows)
    got = K.align_program(ct, cands, world["tabs"],
                          torch.from_numpy(rows)).numpy()
    assert_rows_equal(got, want, f"align_program {mode}")
    if ct.lean and cands == 2:
        ok = (want[:, 1] & J.BIT_OK) != 0
        big = (want[:, 1] & J.BIT_BIG) != 0
        assert (~ok).any() and big.any(), "tiny capacity did not overflow"


def _saturating_starts(cnt: np.ndarray) -> np.ndarray:
    """The exclusive saturating scan K3 writes, in numpy: each count and
    each running sum capped at ``K.SATLIM`` (2^30), the total last."""
    c = np.minimum(cnt.astype(np.int64), K.SATLIM)
    return np.minimum(np.concatenate([[0], np.cumsum(c)]), K.SATLIM)


def _synthetic_names():
    from chip_smoke import k3_synthetic_counts
    return [name for name, _ in k3_synthetic_counts(24, 16)]


@pytest.mark.parametrize("pattern", _synthetic_names())
@pytest.mark.parametrize("loose", [False, True])
def test_verify_candidates_twin_matches_jax_on_synthetic_counts(
        world, pattern, loose):
    """K3's twin on the synthetic slot counts of chip_smoke.py's phase
    (none, one slot holding the capacity, counts at and past the 2^30
    saturation limit ``SATLIM``, totals beside the capacity, two full slots
    far apart, every slot 0-2) put in place of a window's counts, against
    _verify_impl on the same counts (pair-end semantics with hit
    compaction, as in test_verify_candidates_twin_matches_jax): hit
    columns and per-read totals equal exactly, and ``starts`` equal to a
    numpy saturating cumulative sum.  ``loose`` gives every read a budget
    that no candidate exceeds, so every in-bounds candidate is eligible
    and the dedup rounds see them all.  int32 throughout: exact
    equality."""
    from chip_smoke import k3_synthetic_counts
    cands = 2048
    rows = rows_of(world, "r100.fq", 2, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, 2, nw)
    rows[:, -1] = ct.maxseg - 1
    if loose:
        rows[:, 2 * nw + 1] = 255
    n, NB, MS = len(rows), ct.maxseg * ct.I, ct.maxseg
    cnt = dict(k3_synthetic_counts(n * NB, cands))[pattern].reshape(n, NB)
    sched, scal = jax_schedule(world, cj, rows)
    sched = list(sched)
    sched[6] = jnp.asarray(cnt)
    full = jax_verify(world, cj._replace(pe=True, hits_k=HITS_K), cands,
                      sched, scal)
    slots = port_schedule(world, ct, rows)._replace(
        cnt=torch.from_numpy(cnt.copy()))
    vc = K.verify_candidates(ct, cands, torch.from_numpy(rows), slots,
                             world["tabs"])
    starts, loc, w1 = _hit_lists(vc, n, NB, cands)
    assert np.array_equal(starts, _saturating_starts(cnt.reshape(-1)))
    ex = 2 * MS + J.N_EXTRAS
    assert_rows_equal(loc, full[:, ex: ex + HITS_K], "K3 hit locs")
    assert_rows_equal(w1, full[:, ex + HITS_K:], "K3 hit words")
    totals = np.diff(starts[::NB])
    want_tot = full[:, 2 * MS + J.X_TOTAL].astype(np.int64)
    assert_rows_equal(totals.astype(np.int32), want_tot.astype(np.int32),
                      "K3 totals")
    if loose and cnt.sum() > 0:
        assert (w1 >= 0).any(), "no accepted candidate under a loose budget"
    if "2^30" in pattern:
        assert starts[-1] == K.SATLIM and cnt.max() >= K.SATLIM


@pytest.mark.parametrize("name,v,variant", [
    ("r100.fq", 5, "as read"), ("r100.fq", 5, "51 nt"),
    ("r100.fq", 5, "built to tie"), ("r100.fq", 2, "built to tie"),
    ("r130.fq", 5, "built to tie"), ("rmix.fq", 4, "51 nt"),
])
def test_exact_schedule_twin_matches_jax_on_short_and_tying_reads(
        world, name, v, variant):
    """K2's twin against _schedule_impl on the cases chip_smoke.py adds
    for the kernel (``k2_row_variants``): reads cut to 51 nt (no room for a
    start offset, fewer segments than maxseg), a -v 5 budget (six
    segments, a prefix sum of 100 words) and reads built to tie (equal
    bucket costs: every arg-min and the segment order fall to the tie
    rules), at full rank: slot rows, the chosen start offset, per-rank
    totals and the probe pass's totals.  int32 throughout: exact
    equality."""
    from chip_smoke import k2_row_variants
    rows = rows_of(world, name, v, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, v, nw)
    rows[:, -1] = ct.maxseg - 1
    rows = k2_row_variants(rows, nw)[variant]
    want, _ = jax_schedule(world, cj, rows)
    got = port_schedule(world, ct, rows)
    for f, w in zip(("h", "off0", "off3", "wcnt", "cnt", "s_off"),
                    list(want[2:7]) + [want[8]]):
        assert_rows_equal(getattr(got, f).numpy(), w, f"K2 {f}")
    assert_rows_equal(got.ftot_rank.numpy(), want[10], "K2 ftot_rank")
    probe = port_schedule(world, ct._replace(probe=True), rows)
    assert_rows_equal(probe.ftot_rank.numpy(), want[10], "K2 probe totals")
    if variant == "51 nt":
        cut = rows[:, 2 * nw] == 51          # rmix keeps its 50 nt reads
        assert cut.any() and (got.s_off.numpy()[cut] == 0).all()
        if v > 2:       # seedseg = 3 < maxseg: the upper ranks stay empty
            assert (got.cnt.numpy()[:, 3 * ct.I:] == 0).all()


def assert_k1_synthetic_matches_jax(world, cj, ct, rows):
    """K1's twin against _fixed_schedule_impl + the fixed branch of
    _schedule_impl on every case of ``chip_smoke.k1_synthetic_cases`` (a
    copy of the table with synthetic counts at the rows' probed buckets:
    ties, counts near and past the 2^27 clamp, wrapping sums; the rows as
    read, cut to random lengths, with seedseg < maxseg, maxrank 0 and
    maxrank >= maxseg): slot rows, zero offsets, per-rank totals, exact.
    Under 'b' the twin takes K5's rc rows, JAX makes its own."""
    from chip_smoke import k1_synthetic_cases
    tab, cases = k1_synthetic_cases(K, ct, torch.from_numpy(rows),
                                    world["tabs"]["kmer_tab"])
    tab_np = tab.numpy()
    clamped = 0
    for name, r in cases:
        want, _ = jax_schedule(world, cj, r.numpy(), tab_np)
        fwd, rc = K.chain_inputs(ct, r)
        got = K.fixed_schedule_plain(ct, fwd, tab, rc)
        for f, w in zip(("h", "off0", "off3", "wcnt", "cnt", "s_off",
                         "c_off"), list(want[2:7]) + list(want[8:10])):
            assert_rows_equal(getattr(got, f).numpy(), w, f"K1 {name} {f}")
        assert_rows_equal(got.ftot_rank.numpy(), want[10],
                          f"K1 {name} ftot_rank")
        clamped += int((got.ftot_rank == K.FTOT_CLAMP).sum())
    assert clamped, "no per-rank total reached the clamp"
    assert (tab_np[:, 1] >= 1 << 30).any(), "no count whose sums wrap"


@pytest.mark.parametrize("seed,v", [("-s 16 -I 4", 2), ("-s 12 -I 3", 4)])
def test_fixed_schedule_twin_matches_jax_on_synthetic_tables(world, seed, v):
    """K1 on the forward chain at the fixture's seed size and at -s 12 -I 3
    (an interval that is not a power of two), on synthetic tables."""
    w = world if seed == "-s 16 -I 4" else small_seed_world(world)
    rows = rows_of(world, "r100.fq", v, 0)
    cj, ct = cfgs(w, v, 7, fixed=True, lean=True)
    assert_k1_synthetic_matches_jax(w, cj, ct, rows)


@pytest.mark.parametrize("v,mode,I", [(2, "f", 4), (2, "b", 4), (4, "b", 3),
                                      (15, "b", 16)])
def test_k1_groups_cover_the_slots_and_cpu_wrapper_runs_twin(world, v, mode,
                                                             I):
    """``k1_groups`` offers 16 or 32 lanes a read, the default at least
    min(NB, 16) and able to hold every slot in its rounds; the wrapper on
    CPU tensors returns the twin's slots for every width and counts no
    launch."""
    _cj, ct = cfgs(world, v, 7, fixed=True, lean=True)
    ct = ct._replace(chains_mode=mode, I=I)
    groups = K.k1_groups(ct)
    assert set(groups) <= {16, 32} and groups[0] >= min(ct.NB, 16)
    assert groups[0] * K.K1_MAX_ROUNDS >= ct.NB
    r = torch.from_numpy(rows_of(world, "r100.fq", v, 0))
    fwd, rc = K.chain_inputs(ct, r)
    kt = world["tabs"]["kmer_tab"]
    want = K.fixed_schedule_plain(ct, fwd, kt, rc)
    K.reset_launch_counts()
    for g in groups:
        got = K.fixed_schedule(ct, fwd, kt, rc, group=g)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.launch_counts()["fixed_schedule"] == 0


def k4_on_synthetic_counts(world, cj, ct, rows, slots, pattern: str,
                           cands: int, rows_rc=None):
    """(port rows, JAX rows) of K4 after K3 on the slot counts ``pattern``
    of ``chip_smoke.k3_synthetic_counts`` put in place of the window's:
    the twins of K3 and K4 on the port's ``slots`` (``rows_rc``: K5's rows
    under 'b'), ``_verify_impl`` on JAX's schedule."""
    from chip_smoke import k3_synthetic_counts
    n, NB = len(rows), ct.NB
    cnt = dict(k3_synthetic_counts(n * NB, cands))[pattern].reshape(n, NB)
    sched, scal = jax_schedule(world, cj, rows)
    sched = list(sched)
    sched[6] = jnp.asarray(cnt)
    want = jax_verify(world, cj, cands, sched, scal)
    slots = slots._replace(cnt=torch.from_numpy(cnt.copy()))
    r = torch.from_numpy(rows)
    vc = K.verify_candidates(ct, cands, r, slots, world["tabs"],
                             rows_rc=rows_rc)
    return K.reduce_reads(ct, cands, r, vc, slots).numpy(), want


# K4 on synthetic slot counts: the cfg changes of each row form
K4_SYNTHETIC = {"lean fixed": dict(lean=True, fixed=True),
                "pe 16 hits": dict(pe=True, hits_k=16)}


@pytest.mark.parametrize("pattern", _synthetic_names())
@pytest.mark.parametrize("mode", list(K4_SYNTHETIC))
def test_reduce_reads_twin_matches_jax_on_synthetic_counts(world, pattern,
                                                          mode):
    """K4's twin, after K3's, on the synthetic slot counts of
    chip_smoke.py's K4 cases (reads spanning many candidates, reads cut by
    the capacity, counts past the 2^30 saturation limit) against
    _verify_impl's rows, every column: lean rows with the fixed-schedule
    multi bit, and full rows with cfg.pe and 16 compacted hits; maxrank
    cycling over 0..maxseg-1 (the stop rank at every rank).  The reads'
    own budgets: a budget past maxseg - 1 would let JAX's per-level counts
    of a read spill into the next reads' (its count index has no level
    guard; the port's twin and kernel keep a read's counts in its row).
    int32 throughout: exact equality."""
    rows = rows_of(world, "r100.fq", 2, 0)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(world, 2, nw, **K4_SYNTHETIC[mode])
    rows[:, -1] = np.arange(len(rows)) % ct.maxseg
    got, want = k4_on_synthetic_counts(world, cj, ct, rows,
                                       port_schedule(world, ct, rows),
                                       pattern, 2048)
    assert_rows_equal(got, want, f"K4 {mode}, {pattern}")


@pytest.mark.parametrize("lean", [True, False])
def test_reduce_reads_cpu_wrapper_runs_twin(world, lean):
    """K4's wrapper on CPU tensors returns the twin's rows and counts no
    launch."""
    rows = rows_of(world, "r100.fq", 2, 0)
    _cj, ct = cfgs(world, 2, 7, lean=lean)
    r = torch.from_numpy(rows)
    slots = port_schedule(world, ct, rows)
    vc = K.verify_candidates(ct, 4096, r, slots, world["tabs"])
    want = K.reduce_reads_plain(ct, 4096, r, vc, slots)
    K.reset_launch_counts()
    assert torch.equal(K.reduce_reads(ct, 4096, r, vc, slots), want)
    assert K.launch_counts()["reduce_reads"] == 0
