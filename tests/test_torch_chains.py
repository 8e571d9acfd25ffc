"""The all-four-strands programs (``chains_mode = 'b'``, -n 1) and the RRBS
rc chain of the PyTorch port's kernel twins against the JAX programs.

Data: a ``tools/simulate.py`` genome with one A/T-only chromosome appended
(its reads map unconverted to Watson on the forward chain and to Crick on
the rc chain at one locus, so a dedup key is claimed across chains), reads
of 100 nt and a mixed 50/51 nt set (stale-schedule reads), every second
read reverse-complemented so half the reads map through the rc chain;
simulated pairs with every second pair's mates swapped; and the MspI digest
of ``chip_smoke.make_rrbs_set`` with every second read reverse-complemented,
indexed with the rc entries (-n 1).  The JAX side runs on the CPU as
``tests/test_torch_kernels.py`` runs it; the port side runs the plain-torch
twins (what every kernel wrapper runs for a CPU tensor).  All values are
int32: every comparison is exact (``np.array_equal``)."""

import random

import numpy as np
import pytest
import torch

from bsmap_tpu.engine import device_engine as J
from bsmap_tpu.engine import pair_device as JP
from bsmap_tpu.index import build_index
from bsmap_tpu.params import Param
from bsmap_tpu.reference import load_genome
from bsmap_tpu_torch.engine import device_engine as T
from bsmap_tpu_torch.engine import kernels as K
from chip_smoke import make_rrbs_set

from .conftest import simulate
from .test_torch_kernels import _param as _seed_param
from .test_torch_kernels import (_jax_program, assert_k1_synthetic_matches_jax,
                                 assert_rows_equal, jax_schedule, jax_verify,
                                 k4_on_synthetic_counts, rows_of,
                                 small_seed_world)
from .test_torch_pair import _pad, rows_from

HITS_K = 16
COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp_every_second(src, dst, n_extra=()):
    """Copy a FASTQ file, reverse-complementing every second read (its
    quality reversed); ``n_extra`` records are appended first."""
    lines = src.read_text().splitlines() + list(n_extra)
    out = []
    for k in range(0, len(lines), 4):
        name, seq, plus, qual = lines[k: k + 4]
        if (k // 4) % 2:
            seq, qual = seq[::-1].translate(COMP), qual[::-1]
        out += [name, seq, plus, qual]
    dst.write_text("\n".join(out) + "\n")


def add_at_chromosome(d, ref: str, n_reads: int, read_len: int = 100):
    """Append an A/T-only chromosome to ``ref`` and return FASTQ records of
    ``n_reads`` exact reads from it."""
    rng = random.Random(3)
    chrom = "".join(rng.choice("AT") for _ in range(3000))
    with open(d / ref, "a") as f:
        f.write(">chrAT\n")
        for i in range(0, len(chrom), 60):
            f.write(chrom[i:i + 60] + "\n")
    recs = []
    for k in range(n_reads):
        pos = rng.randrange(len(chrom) - read_len)
        recs += [f"@at{k}_{pos}", chrom[pos: pos + read_len], "+",
                 "I" * read_len]
    return recs


def swap_every_second_pair(d, a, b, out_a, out_b, cut_every=0):
    """Swap the mates of every second pair (names keep /1 and /2); with
    ``cut_every`` every such pair is cut to 51 nt."""
    la, lb = (d / a).read_text().splitlines(), (d / b).read_text().splitlines()
    oa, ob = [], []
    for k in range(0, len(la), 4):
        ra, rb = la[k: k + 4], lb[k: k + 4]
        if (k // 4) % 2:
            ra, rb = [ra[0]] + rb[1:], [rb[0]] + ra[1:]
        if cut_every and (k // 4) % cut_every == 0:
            ra = [ra[0], ra[1][:51], ra[2], ra[3][:51]]
            rb = [rb[0], rb[1][:51], rb[2], rb[3][:51]]
        oa += ra
        ob += rb
    (d / out_a).write_text("\n".join(oa) + "\n")
    (d / out_b).write_text("\n".join(ob) + "\n")


def _param(**kw) -> Param:
    p = Param()
    p.randseed = 1
    p.chains = 1
    for k, v in kw.items():
        setattr(p, k, v)
    p.init_mapping()
    return p


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chains")
    simulate(d, genome_out="ref.fa", reads_out="r100_raw.fq", n_reads=300,
             read_len=100, chr_len=12000, n_chr=2, seed=8, error_rate=0.015)
    simulate(d, genome_out="ref.fa", reads_out="r51_raw.fq", n_reads=240,
             read_len=51, chr_len=12000, n_chr=2, seed=8, error_rate=0.015)
    at = add_at_chromosome(d, "ref.fa", 30)
    revcomp_every_second(d / "r100_raw.fq", d / "nd100.fq", at)
    raw = (d / "r51_raw.fq").read_text().splitlines()
    for k in range(0, len(raw), 8):          # every second read to 50 nt
        raw[k + 1], raw[k + 3] = raw[k + 1][:50], raw[k + 3][:50]
    (d / "ndmix_raw.fq").write_text("\n".join(raw) + "\n")
    revcomp_every_second(d / "ndmix_raw.fq", d / "ndmix.fq")
    simulate(d, genome_out="refpe.fa", reads_out="pe1_raw.fq",
             reads2_out="pe2_raw.fq", pe=True, n_reads=200, read_len=76,
             chr_len=12000, n_chr=2, seed=9, error_rate=0.015)
    swap_every_second_pair(d, "pe1_raw.fq", "pe2_raw.fq", "pe1.fq", "pe2.fq")
    p = _param()
    out = {"dir": d, "rows": {}}
    for name, ref in (("se", "ref.fa"), ("pe", "refpe.fa")):
        genome = load_genome(str(d / ref), p)
        index = build_index(genome, p)
        out[name] = {"dir": d, "rows": out["rows"], "genome": genome,
                     "je": J.DeviceEngine(genome, index, p),
                     "tabs": T.tables_from_numpy(genome, index, p)}
    return out


def cfgs(world, v: int, nw: int, mode: str = "b", **kw):
    """(JAX Cfg, port Cfg) of one program on ``mode``'s chains."""
    je = world["je"]
    maxseg = min(15, v) + 1
    cj = J.make_cfg(_param(max_snp_num=v), je.W, je.genome.n_chr, mode,
                    maxseg, nw=nw)._replace(**kw)
    return cj, T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields
                   if f != "shards"})


def port_slots(world, cfg, rows):
    """K5 then K1 or K2 on 'b' rows: (slots, rows_rc)."""
    t = world["tabs"]
    r = torch.from_numpy(rows)
    rc = K.rc_words(cfg, r)
    if cfg.fixed:
        return K.fixed_schedule(cfg, r, t["kmer_tab"], rows_rc=rc), rc
    return K.exact_schedule(cfg, r, t["kmer_tab"], t["prof_a"],
                            probe=cfg.probe, tag_off=t.get("tag_off"),
                            rows_rc=rc), rc


def compare_slots(got, want, what):
    for f, w in zip(("h", "off0", "off3", "wcnt", "cnt", "s_off", "c_off"),
                    list(want[2:7]) + list(want[8:10])):
        assert_rows_equal(getattr(got, f).numpy(), w, f"{what} {f}")
    assert_rows_equal(got.ftot_rank.numpy(), want[10], f"{what} ftot_rank")


# (read set, -v, maxrank: 0 = round-1 start rank, -1 = full rank)
@pytest.mark.parametrize("name,v,rank", [("nd100.fq", 2, 0),
                                         ("nd100.fq", 4, -1),
                                         ("ndmix.fq", 2, -1)])
def test_fixed_schedule_both_chains_matches_jax(world, name, v, rank):
    """K1 with nch = 2 against _fixed_schedule_impl + the fixed branch of
    _schedule_impl: per-chain cheapest-first order, (rank, chain, phase)
    slot rows, totals over both chains, zero start offsets."""
    w = world["se"]
    rows = rows_of(w, name, v, 0)
    cj, ct = cfgs(w, v, 7, fixed=True, lean=True)
    rows[:, -1] = rank % ct.maxseg
    want, _ = jax_schedule(w, cj, rows)
    got, _ = port_slots(w, ct, rows)
    assert got.h.shape[1] == ct.maxseg * 2 * ct.I
    compare_slots(got, want, "K1 'b'")


@pytest.mark.parametrize("seed,v", [("-s 16 -I 4", 2), ("-s 12 -I 3", 4)])
def test_fixed_schedule_twin_matches_jax_on_synthetic_tables(world, seed, v):
    """K1 on both chains ('b') at the fixture's seed size and at -s 12 -I 3
    (an interval that is not a power of two), on synthetic tables."""
    w = world["se"]
    if seed != "-s 16 -I 4":
        w = small_seed_world(w)
    je = w["je"]
    cj = J.make_cfg(_seed_param(v, w.get("S", 16), w.get("I", 4)), je.W,
                    je.genome.n_chr, "b", min(15, v) + 1,
                    nw=7)._replace(fixed=True, lean=True)
    ct = T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields if f != "shards"})
    assert_k1_synthetic_matches_jax(w, cj, ct,
                                    rows_of(world["se"], "nd100.fq", v, 0))


@pytest.mark.parametrize("name,v,rank", [("nd100.fq", 2, 0),
                                         ("nd100.fq", 4, -1),
                                         ("ndmix.fq", 2, -1)])
def test_exact_schedule_both_chains_matches_jax(world, name, v, rank):
    """K2 with nch = 2 against _schedule_impl: both chains' schedules
    interleaved, s_off from the forward chain and c_off from the rc chain,
    totals over both; and the probe pass's totals."""
    w = world["se"]
    rows = rows_of(w, name, v, 0)
    cj, ct = cfgs(w, v, 7)
    rows[:, -1] = rank % ct.maxseg
    want, _ = jax_schedule(w, cj, rows)
    got, _ = port_slots(w, ct, rows)
    compare_slots(got, want, "K2 'b'")
    if name == "ndmix.fq":          # 50 nt reads: start offsets 0..14
        assert (got.s_off != got.c_off).any()
    probe, _ = port_slots(w, ct._replace(probe=True), rows)
    assert_rows_equal(probe.ftot_rank.numpy(), want[10], "K2 'b' probe")


def hit_lists(ct, vc, n: int, cands: int, acc):
    """The first HITS_K candidates of each read passing ``acc(info)``, as
    (locs, hit words) in K4's compacted layout."""
    starts = vc.starts.numpy().astype(np.int64)
    info = vc.info.numpy()
    loc = np.zeros((n, HITS_K), np.int32)
    w1 = np.full((n, HITS_K), -1, np.int32)
    for r in range(n):
        lo, hi = starts[r * ct.NB], min(starts[(r + 1) * ct.NB], cands)
        for j, s in enumerate([s for s in range(lo, hi) if acc(info[s])]
                              [:HITS_K]):
            loc[r, j] = vc.wloc[s]
            w1[r, j] = (((info[s] >> K.INFO_WMM_SHIFT) & 0xFF)
                        | (((info[s] >> K.INFO_CHAIN_SHIFT) & 1) << 4)
                        | (((info[s] >> K.INFO_RANK_SHIFT) & 0x1F) << 5)
                        | (int(vc.chrp[s]) << 9))
    return loc, w1


@pytest.mark.parametrize("name,v,cands", [("nd100.fq", 2, 4096),
                                          ("ndmix.fq", 3, 4)])
def test_verify_candidates_both_chains_matches_jax(world, name, v, cands):
    """K3 with nch = 2: each read's deduplicated in-budget candidates
    (chain bit included) against _verify_impl's compacted hit list under
    pair-end semantics; rc-chain hits occur, and some dedup key is found on
    both chains and claimed by its first discovery."""
    w = world["se"]
    rows = rows_of(w, name, v, 0)
    cj, ct = cfgs(w, v, 7)
    rows[:, -1] = ct.maxseg - 1
    sched, scal = jax_schedule(w, cj, rows)
    full = jax_verify(w, cj._replace(pe=True, hits_k=HITS_K), cands, sched,
                      scal)
    slots, rc = port_slots(w, ct, rows)
    vc = K.verify_candidates(ct, cands, torch.from_numpy(rows), slots,
                             w["tabs"], rows_rc=rc)
    loc, w1 = hit_lists(ct, vc, len(rows), cands,
                        lambda i: i & K.INFO_FIRST)
    ex = 2 * ct.maxseg + J.N_EXTRAS
    assert_rows_equal(loc, full[:, ex: ex + HITS_K], "K3 'b' hit locs")
    assert_rows_equal(w1, full[:, ex + HITS_K:], "K3 'b' hit words")
    if cands < 100:
        assert (full[:, 2 * ct.maxseg + J.X_OK] == 0).any()
        return
    assert ((w1 >= 0) & ((w1 >> 4) & 1 == 1)).any(), "no rc-chain hit"
    # a key seen on both chains: eligible candidates sharing (read, chr,
    # wloc) with the first discovery on one chain and a later one on the other
    info = vc.info.numpy()[: int(vc.starts[-1])]
    elig = (info & K.INFO_ELIGIBLE) != 0
    keys = {}
    for s in np.nonzero(elig)[0]:
        key = (int(vc.rid[s]), int(vc.chrp[s]) >> 1, int(vc.wloc[s]))
        keys.setdefault(key, []).append(
            (s, (info[s] >> K.INFO_CHAIN_SHIFT) & 1,
             bool(info[s] & K.INFO_FIRST)))
    cross = [v_ for v_ in keys.values() if len({c for _, c, _ in v_}) == 2]
    assert cross, "no dedup key found on both chains"
    assert all(min(v_)[2] and not any(f for _, _, f in sorted(v_)[1:])
               for v_ in cross)


@pytest.mark.parametrize("name,v,lean,fixed,cands,pe", [
    ("nd100.fq", 2, True, True, 4096, False),
    ("nd100.fq", 2, True, False, 4, False),      # overflowing capacity
    ("nd100.fq", 4, False, False, 4096, False),
    ("ndmix.fq", 2, False, False, 4096, False),
    ("nd100.fq", 3, False, False, 4096, True),   # cfg.pe, 16 hits
])
def test_reduce_reads_both_chains_matches_jax(world, name, v, lean, fixed,
                                              cands, pe):
    """K4 with per-candidate chains (on K3's output) against _verify_impl's
    per-read half: lean rows (fixed and exact), full rows with both start
    offsets, and cfg.pe with 16 compacted hits."""
    w = world["se"]
    rows = rows_of(w, name, v, 0)
    kw = dict(lean=lean, fixed=fixed)
    if pe:
        kw.update(pe=True, hits_k=HITS_K)
        rows[:, -1] = v
    cj, ct = cfgs(w, v, 7, **kw)
    sched, scal = jax_schedule(w, cj, rows)
    want = jax_verify(w, cj, cands, sched, scal)
    slots, rc = port_slots(w, ct, rows)
    r = torch.from_numpy(rows)
    vc = K.verify_candidates(ct, cands, r, slots, w["tabs"], rows_rc=rc)
    got = K.reduce_reads(ct, cands, r, vc, slots).numpy()
    assert_rows_equal(got, want, "K4 'b' rows")
    found = (want[:, 1] & 1) if lean else want[:, 2 * ct.maxseg + J.X_FOUND]
    chain = ((want[:, 1] >> 1) & 1) if lean else \
        want[:, 2 * ct.maxseg + J.X_CHAIN]
    if cands > 100:
        assert ((found != 0) & (chain == 1)).sum() > len(rows) // 10
        assert ((found != 0) & (chain == 0)).sum() > len(rows) // 10
    if name == "ndmix.fq":          # 50 nt reads: start offsets 0..14
        assert (want[:, 2 * ct.maxseg + J.X_COFF] != 0).any()


def test_reduce_reads_both_chains_matches_jax_on_synthetic_counts(world):
    """K4 on both chains ('b'), after K3, on chip_smoke.py's synthetic slot
    counts whose total is one over the capacity (the read at the capacity
    is cut), full rows with both start offsets, against _verify_impl's
    rows, every column; exact."""
    w = world["se"]
    rows = rows_of(w, "nd100.fq", 2, 0)
    cj, ct = cfgs(w, 2, 7, lean=False)
    rows[:, -1] = ct.maxseg - 1
    slots, rc = port_slots(w, ct, rows)
    got, want = k4_on_synthetic_counts(w, cj, ct, rows, slots,
                                       "total cands + 1", 2048, rows_rc=rc)
    assert_rows_equal(got, want, "K4 'b', total cands + 1")
    ex = 2 * ct.maxseg
    assert (got[:, ex + K.X_OK] == 0).sum() == 1


@pytest.mark.parametrize("name,v,mode,cands_per_b", [
    ("nd100.fq", 2, "fixed", 2),
    ("nd100.fq", 2, "exact_lean", 0),     # capacity 2: overflow rows
    ("ndmix.fq", 2, "exact_full", 16),
    ("nd100.fq", 4, "probe", 0),
])
def test_align_program_both_chains_matches_jax(world, name, v, mode,
                                               cands_per_b):
    """The whole 'b' program: align_program (K5, K1 or K2, K3, K4) on live
    rows against _align_fused_kernel on the rows zero-padded to B."""
    w = world["se"]
    rows = rows_of(w, name, v, 0)
    kw = {"fixed": dict(fixed=True, lean=True), "exact_lean": dict(lean=True),
          "exact_full": {}, "probe": dict(probe=True)}[mode]
    cj, ct = cfgs(w, v, 7, **kw)
    cands = cands_per_b * J.DEV_BATCH or 2
    if not cands_per_b:
        rows[:, -1] = ct.maxseg - 1
    want = _jax_program(w, cj, cands, rows)
    got = K.align_program(ct, cands, w["tabs"],
                          torch.from_numpy(rows)).numpy()
    assert_rows_equal(got, want, f"align_program 'b' {mode}")


# -- pair-end: both mates on both chains ----------------------------------------

def pe_rows(world, v: int, maxrank: int):
    from bsmap_tpu.readio import open_read_stream
    seqs = []
    for f, rs in (("pe1.fq", 1), ("pe2.fq", 2)):
        s = open_read_stream(str(world["dir"] / f), _param(), readset=rs)
        seqs.append([r.seq for r in s.next_batch(100000)])
        s.close()
    p = _param(max_snp_num=v)
    from bsmap_tpu.utils import myrand_hash
    n = len(seqs[1])
    return (rows_from(seqs[0], p, maxrank=maxrank),
            rows_from(seqs[1], p, rand=myrand_hash(
                np.arange(n, dtype=np.uint64) + 1000, 1), maxrank=maxrank))


@pytest.mark.parametrize("v,rank,cands_per_b", [(2, 0, 2), (3, -1, 16)])
def test_pair_program_both_chains_matches_jax(world, v, rank, cands_per_b):
    """pair_program with both mates on 'b' (K5, K2, K3, K4 with cfg.pe and
    16 hits per mate, then K6) against _pair_fused_kernel, at rank 0 and
    full rank; the swapped pairs pair through the rc chains."""
    w = world["pe"]
    ra, rb = pe_rows(world, v, 0)
    cja, cta = cfgs(w, v, 7, pe=True, hits_k=HITS_K)
    ra[:, -1] = rb[:, -1] = rank % cta.maxseg
    cands = cands_per_b * J.DEV_BATCH
    want = np.asarray(JP._pair_fused_kernel(
        cja, cja, cands, *w["je"]._engine_args(), _pad(ra), _pad(rb)))
    got = K.pair_program(cta, cta, cands, w["tabs"], torch.from_numpy(ra),
                         torch.from_numpy(rb)).numpy()
    assert_rows_equal(got, want[: len(ra)], "pair_program 'b' J rows")
    paired = (want[: len(ra), JP.J_PAIR] & 31) > 0
    chain = (want[: len(ra), JP.J_PAIR] >> 16) & 1
    assert (paired & (chain == 1)).sum() > len(ra) // 20
    assert (paired & (chain == 0)).sum() > len(ra) // 20


# -- RRBS on the rc chain and on both chains -------------------------------------

@pytest.fixture(scope="module")
def rrbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chains_rrbs")
    make_rrbs_set(d, n_reads=400)
    revcomp_every_second(d / "se.fq", d / "nd.fq")
    p = _rrbs_param()
    genome = load_genome(str(d / "rrbs.fa"), p)
    index = build_index(genome, p)
    return {"dir": d, "genome": genome, "je": J.DeviceEngine(genome, index, p),
            "tabs": T.tables_from_numpy(genome, index, p), "rows": {}}


def _rrbs_param(v: int = 2, window=None) -> Param:
    p = Param()
    p.set_digestion_site("C-CGG")
    p.max_snp_num = v
    p.randseed = 1
    p.chains = 1
    if window:
        p.min_insert, p.max_insert = window
    p.init_mapping()
    return p


def rrbs_rows(world, v: int, maxrank: int) -> np.ndarray:
    from bsmap_tpu.readio import open_read_stream
    s = open_read_stream(str(world["dir"] / "nd.fq"), _rrbs_param(v),
                         readset=0)
    seqs = [r.seq for r in s.next_batch(100000)]
    s.close()
    return rows_from(seqs, _rrbs_param(v), maxrank=maxrank)


@pytest.mark.parametrize("mode,v,lean,window", [
    ("r", 2, False, None),
    ("b", 2, True, None),
    ("b", 4, False, None),
    ("b", 2, False, (100, 150)),
])
def test_rrbs_chains_match_jax(rrbs, mode, v, lean, window):
    """K2 (RRBS schedule with the rc chain's len % S probe shift and
    from-the-end tag classes), K3 and K4 on 'r' and 'b' against
    _schedule_impl and _verify_impl, lean and full rows, and a -m 100
    -x 150 fragment window (the filter binds forward-chain hits only); for
    'b' also align_program against _align_fused_kernel."""
    je = rrbs["je"]
    cj = J.make_cfg(_rrbs_param(v, window), je.W, je.genome.n_chr, mode,
                    v + 1, nw=7)._replace(lean=lean)
    ct = T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields
                   if f != "shards"})
    rows = rrbs_rows(rrbs, v, ct.maxseg - 1)
    cands = 16 * J.DEV_BATCH
    want_s, scal = jax_schedule(rrbs, cj, rows)
    want = jax_verify(rrbs, cj, cands, want_s, scal)
    t = rrbs["tabs"]
    r = torch.from_numpy(rows)
    fwd, rc_in = K.chain_inputs(ct, r)
    slots = K.exact_schedule(ct, fwd, t["kmer_tab"], t["prof_a"],
                             tag_off=t["tag_off"], rows_rc=rc_in)
    compare_slots(slots, want_s, f"RRBS K2 '{mode}'")
    vc = K.verify_candidates(ct, cands, fwd, slots, t, rows_rc=rc_in)
    got = K.reduce_reads(ct, cands, fwd, vc, slots).numpy()
    assert_rows_equal(got, want, f"RRBS K4 '{mode}' rows")
    info = vc.info.numpy()[: int(vc.starts[-1])]
    rc_first = ((info >> K.INFO_CHAIN_SHIFT) & 1 == 1) & \
        ((info & K.INFO_FIRST) != 0)
    assert rc_first.sum() > len(rows) // 10, "few rc-chain hits"
    if window:
        fwd_cut = ((info >> K.INFO_CHAIN_SHIFT) & 1 == 0) & \
            ((info & K.INFO_FIRST) != 0) & ((info & K.INFO_FRAG) == 0)
        assert fwd_cut.any() and (rc_first & ((info & K.INFO_FRAG) == 0)).any()
    if mode == "b":
        assert_rows_equal(
            K.align_program(ct, cands, t, r).numpy(),
            _jax_program(rrbs, cj, cands, rows), "RRBS align_program 'b'")
