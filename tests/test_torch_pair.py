"""The PyTorch port's pair-end kernel twins against the JAX PE program.

Both packages get the same numpy dispatch rows, packed from simulated pairs
(``tools/simulate.py --pe``) of 50, 76 and 130 nt with N bases planted, and
from a repeat genome whose reads have more than K hits.  The JAX side runs
on the CPU as the JAX package's own tests run it; the port side runs the
plain-torch twins (what every kernel wrapper runs for a CPU tensor).  All
values are int32, so every comparison is exact (``np.array_equal``)."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsmap_tpu.engine import device_engine as J
from bsmap_tpu.engine import pair_device as JP
from bsmap_tpu.index import build_index
from bsmap_tpu.params import FIXSIZE, REG_ALPHABET, Param
from bsmap_tpu.readio import open_read_stream
from bsmap_tpu.reference import load_genome
from bsmap_tpu.utils import myrand_hash
from bsmap_tpu_torch.engine import device_engine as T
from bsmap_tpu_torch.engine import kernels as K

from .conftest import simulate
from .test_torch_kernels import assert_rows_equal

HITS_K = 16
COMP = str.maketrans("ACGT", "TGCA")


def _param(v: int = 2, **kw) -> Param:
    p = Param()
    p.max_snp_num = v
    p.randseed = 1
    for k, val in kw.items():
        setattr(p, k, val)
    p.init_mapping()
    return p


def _rep_genome(d):
    """A random chromosome holding core A three times and core B twenty
    times (A/G-only cores: no C/T ambiguity after conversion), and 60
    pairs from the cores: multi-hit pairs, mates with more than K hits."""
    rng = random.Random(7)
    filler = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa
    core_a = "".join(rng.choice("AG") for _ in range(240))
    core_b = "".join(rng.choice("AG") for _ in range(240))
    g = filler(2000)
    for core, n in ((core_a, 3), (core_b, 20)):
        for _ in range(n):
            g += core + filler(700)
    with open(d / "rep.fa", "w") as f:
        f.write(">chrR\n")
        for i in range(0, len(g), 60):
            f.write(g[i:i + 60] + "\n")
    with open(d / "rep_1.fq", "w") as f1, open(d / "rep_2.fq", "w") as f2:
        for k in range(60):
            core = core_a if k % 2 else core_b
            ins = rng.randint(120, 200)
            pos = rng.randint(0, len(core) - ins)
            frag = core[pos: pos + ins]
            r1 = frag[:76].replace("C", "T")
            r2 = frag[::-1].translate(COMP)[:76].replace("G", "A")
            f1.write(f"@p{k}/1\n{r1}\n+\n{'I' * 76}\n")
            f2.write(f"@p{k}/2\n{r2}\n+\n{'I' * 76}\n")


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pair")
    for L in (76, 130):
        simulate(d, genome_out="ref.fa", reads_out=f"p{L}_1.fq",
                 reads2_out=f"p{L}_2.fq", pe=True, n_reads=240, read_len=L,
                 chr_len=12000, n_chr=3, seed=31, error_rate=0.02)
    _rep_genome(d)
    worlds = {}
    for name in ("ref", "rep"):
        p = _param()
        genome = load_genome(str(d / f"{name}.fa"), p)
        index = build_index(genome, p)
        worlds[name] = {"je": J.DeviceEngine(genome, index, p),
                        "tabs": T.tables_from_numpy(genome, index, p)}
    return d, worlds


def read_seqs(d, path, readset):
    s = open_read_stream(str(d / path), _param(), readset=readset)
    batch = s.next_batch(100000)
    s.close()
    return [r.seq for r in batch]


def mixed(seqs, lens, n_every: int = 3):
    """Cut read t to lens[t % len(lens)] bases and plant an N in every
    n_every-th read (two in every 2*n_every-th)."""
    out = []
    for t, s in enumerate(seqs):
        s = s[: lens[t % len(lens)]]
        if t % n_every == 0:
            k = (7 * t) % len(s)
            s = s[:k] + "N" + s[k + 1:]
        if t % (2 * n_every) == 0:
            s = s[:-3] + "N" + s[-2:]
        out.append(s)
    return out


def rows_from(seqs, p: Param, rand=None, maxrank: int = 0) -> np.ndarray:
    """(n, 2nw+4) dispatch rows of ``seqs`` under ``p`` (the layout of
    ``_pack_inputs``, cut to nw = 7 when every read is <= 112 nt)."""
    n = len(seqs)
    codes = np.zeros((n, FIXSIZE), np.uint8)
    regs = np.zeros((n, FIXSIZE), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int32)
    for t, s in enumerate(seqs):
        sb = np.frombuffer(s.encode("latin1"), np.uint8)
        codes[t, : len(s)] = p.alphabet[sb]
        regs[t, : len(s)] = REG_ALPHABET[sb]
    buds = ((p.max_snp_num + 1) * (lens - 1) // lens).astype(np.int32)
    if rand is None:
        rand = myrand_hash(np.arange(n, dtype=np.uint64), 1)
    rows = J._pack_inputs(codes, regs, lens, buds, rand,
                          np.full(n, maxrank, np.int32))
    if lens.max() <= 112:
        rows = np.concatenate([rows[:, :7], rows[:, 10:17], rows[:, 20:]],
                              axis=1)
    return rows


def cfgs(world, p: Param, mode: str, nw: int, **kw):
    """(JAX Cfg, port Cfg) of one PE mate program."""
    je = world["je"]
    maxseg = min(15, p.max_snp_num) + 1
    cj = J.make_cfg(p, je.W, je.genome.n_chr, mode, maxseg, nw=nw)._replace(
        pe=True, hits_k=HITS_K, **kw)
    return cj, T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields
                   if f != "shards"})


def mate_rows(d, world, name: str, v: int, maxrank: int, lens=None):
    """Both mates' dispatch rows of one pair set under -v v."""
    p = _param(v)
    sa = read_seqs(d, f"{name}_1.fq", 1)
    sb = read_seqs(d, f"{name}_2.fq", 2)
    if lens:
        sa, sb = mixed(sa, lens), mixed(sb, lens[::-1])
    ra = rows_from(sa, p, maxrank=maxrank)
    rb = rows_from(sb, p, rand=myrand_hash(np.arange(len(sb), dtype=np.uint64)
                                           + 1000, 1), maxrank=maxrank)
    return p, ra, rb


def _pad(rows):
    pad = np.zeros((J.DEV_BATCH, rows.shape[1]), np.int32)
    pad[: len(rows)] = rows
    return jnp.asarray(pad)


def jax_mate(world, cj, cands, rows):
    out = J._align_fused_kernel(cj, cands, *world["je"]._engine_args(),
                                _pad(rows))
    return np.array(out)[: len(rows)]


# -- K5: rc chain rows ----------------------------------------------------------

@pytest.mark.parametrize("name,lens,alphabet,rc", [
    ("p76", (76, 50), None, None),
    ("p130", (130, 76, 50), None, None),
    ("p76", (50, 76), "GA", None),
    ("p130", (130, 50), None, (1, 0, 3, 2)),
])
def test_rc_words_twin_matches_jax(pe, name, lens, alphabet, rc):
    """rc_words_plain against _rc_words: nw 7 and 10, mixed lengths, N
    bases, the default alphabet, -M GA (rc_n = 2) and a synthetic
    complement permutation (the general lane-indicator branch)."""
    d, worlds = pe
    p = _param(2)
    if alphabet:
        p.set_align(*alphabet)
        p.init_mapping()
    seqs = mixed(read_seqs(d, f"{name}_2.fq", 2), lens)
    rows = rows_from(seqs, p)
    nw = (rows.shape[1] - 4) // 2
    cj, ct = cfgs(worlds["ref"], p, "r", nw)
    if rc:
        cj, ct = cj._replace(rc=rc), ct._replace(rc=rc)
    assert ct.rc_n == (2 if alphabet else 3)
    qw, rw, ln, _b, _r, _m = J._unpack_inputs(jnp.asarray(rows))
    cqw, crw = J._rc_words(cj, qw, rw, ln)
    got = K.rc_words(ct, torch.from_numpy(rows)).numpy()
    assert_rows_equal(got[:, :nw], np.asarray(cqw).view(np.int32), "cqw")
    assert_rows_equal(got[:, nw: 2 * nw], np.asarray(crw).view(np.int32),
                      "crw")
    assert_rows_equal(got[:, 2 * nw:], rows[:, 2 * nw:], "scalars")
    assert (rows[:, :nw] != got[:, :nw]).any()


@pytest.mark.parametrize("nw", [1, 2, 5, 10])
def test_rc_words_twin_matches_jax_at_every_width(pe, nw):
    """rc_words_plain against _rc_words on chip_smoke.py's synthetic rows
    (``k5_synthetic_rows``: random bases, about one lane in ten an N) at nw
    words, each of the lengths 1, 15, 16, 17, 16*nw - 1 and 16*nw that fit
    (a shift of a multiple of 16 bases, z = 0, and one base either side),
    under the default complement, -M GA's (rc_n = 2) and a non-plain
    permutation (the lane-indicator branch); exact."""
    from chip_smoke import K5_PERMS, k5_synthetic_rows
    _d, worlds = pe
    lens = sorted({x for x in (1, 15, 16, 17, 16 * nw - 1, 16 * nw)
                   if 1 <= x <= 16 * nw})
    rows = k5_synthetic_rows(nw, lens)
    assert (rows[:, nw: 2 * nw] != -1).any()          # N lanes
    qw, rw, ln, _b, _r, _m = J._unpack_inputs(jnp.asarray(rows))
    for rc, rc_n in K5_PERMS:
        cj, ct = cfgs(worlds["ref"], _param(2), "r", nw)
        cj, ct = (c._replace(rc=rc, rc_n=rc_n) for c in (cj, ct))
        cqw, crw = J._rc_words(cj, qw, rw, ln)
        got = K.rc_words(ct, torch.from_numpy(rows)).numpy()
        what = f"nw {nw}, rc {rc}, rc_n {rc_n}"
        assert_rows_equal(got[:, :nw], np.asarray(cqw).view(np.int32),
                          f"cqw, {what}")
        assert_rows_equal(got[:, nw: 2 * nw],
                          np.asarray(crw).view(np.int32), f"crw, {what}")
        assert_rows_equal(got[:, 2 * nw:], rows[:, 2 * nw:], "scalars")


# -- K2 -> K3 -> K4 in 'r' + pe + hits_k ------------------------------------------

@pytest.mark.parametrize("name,v,rank,cands_per_b", [
    ("p76", 2, 0, 16),
    ("p76", 2, -1, 2),
    ("p130", 4, -1, 16),
    ("p130", 4, 0, 0),          # capacity 4: overflowing reads
])
def test_rc_mate_program_matches_jax(pe, name, v, rank, cands_per_b):
    """Mate 2's program (K5, K2, K3, K4 with cfg.pe and hits_k = 16, full
    rows) against _schedule_impl + _verify_impl in _align_fused_kernel, at
    rank 0 and full rank, -v 2 and -v 4, and a capacity that overflows."""
    d, worlds = pe
    w = worlds["ref"]
    p, _ra, rb = mate_rows(d, w, name, v, 0, lens=(130, 76, 50)
                           if name == "p130" else (76, 50))
    nw = (rb.shape[1] - 4) // 2
    cj, ct = cfgs(w, p, "r", nw)
    rb[:, -1] = rank % ct.maxseg
    cands = cands_per_b * J.DEV_BATCH or 4
    want = jax_mate(w, cj, cands, rb)
    got = K.align_program(ct, cands, w["tabs"], torch.from_numpy(rb)).numpy()
    assert got.shape[1] == 2 * ct.maxseg + K.N_EXTRAS + 2 * HITS_K
    assert_rows_equal(got, want, "mate-2 rows")
    ex = 2 * ct.maxseg
    assert (want[:, ex + K.X_COFF] != 0).any()
    if cands_per_b:
        assert (want[:, ex + K.X_FOUND] != 0).sum() > len(rb) // 4
    else:
        assert (want[:, ex + K.X_OK] == 0).any(), "capacity did not overflow"


@pytest.mark.parametrize("mode", ["f", "r"])
def test_more_than_k_hits_sets_replay(pe, mode):
    """Reads with more than K accepted hits (core B, twenty copies) raise
    the replay bit with K hit slots filled, in both chains, like the JAX
    rows."""
    d, worlds = pe
    w = worlds["rep"]
    p, ra, rb = mate_rows(d, w, "rep", 2, 0)
    rows = ra if mode == "f" else rb
    rows[:, -1] = 2
    cj, ct = cfgs(w, p, mode, 7)
    cands = 16 * J.DEV_BATCH
    want = jax_mate(w, cj, cands, rows)
    got = K.align_program(ct, cands, w["tabs"], torch.from_numpy(rows)).numpy()
    assert_rows_equal(got, want, f"'{mode}' rows, repeat genome")
    ex = 2 * ct.maxseg
    full = (want[:, ex + K.N_EXTRAS + 2 * HITS_K - 1] >= 0)
    assert (full & (want[:, ex + K.X_REPLAY] != 0)).sum() >= 10


# -- K6: pair join ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_join(MS, Kh, min_ins, max_ins, max_hits):
    return jax.jit(functools.partial(JP._device_pair_join, MS, Kh, min_ins,
                                     max_ins, max_hits))


def both_mates(pe, world_name, name, v, rand0=False, **pkw):
    d, worlds = pe
    w = worlds[world_name]
    p, ra, rb = mate_rows(d, w, name, v, 0)
    for k, val in pkw.items():
        setattr(p, k, val)
    if rand0:
        ra[:, -2] = 0
        rb[:, -2] = 0
    ra[:, -1] = rb[:, -1] = min(15, v)
    nw = (ra.shape[1] - 4) // 2
    (cja, cta), (cjb, ctb) = cfgs(w, p, "f", nw), cfgs(w, p, "r", nw)
    return w, p, ra, rb, (cja, cta), (cjb, ctb)


@pytest.mark.parametrize("world_name,name,v,rand0,pkw", [
    ("ref", "p76", 2, False, {}),
    ("ref", "p76", 2, True, {}),                        # -S 0: rand 0
    ("ref", "p130", 4, False, {"min_insert": 150, "max_insert": 250}),
    ("rep", "rep", 2, False, {}),
])
def test_pair_join_twin_matches_jax(pe, world_name, name, v, rand0, pkw):
    """pair_join_plain against _device_pair_join on the same JAX mate rows:
    -S 1, -S 0 (rand 0), -m 150 -x 250, and the repeat pairs (multi-hit
    pairs, more than K hits per mate)."""
    w, p, ra, rb, (cja, cta), (cjb, ctb) = both_mates(
        pe, world_name, name, v, rand0, **pkw)
    cands = 16 * J.DEV_BATCH
    fa, fb = jax_mate(w, cja, cands, ra), jax_mate(w, cjb, cands, rb)
    nw = (ra.shape[1] - 4) // 2
    MS = cta.maxseg
    ftot = np.maximum(fa[:, 2 * MS + K.X_FTOT], fb[:, 2 * MS + K.X_FTOT])
    want = np.asarray(_jit_join(MS, HITS_K, cta.min_ins, cta.max_ins,
                                cta.max_num_hits)(
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(ra[:, 2 * nw]),
        jnp.asarray(rb[:, 2 * nw]), jnp.asarray(ra[:, 2 * nw + 1]),
        jnp.asarray(rb[:, 2 * nw + 1]),
        jnp.asarray(ra[:, 2 * nw + 2].view(np.uint32)),
        jnp.asarray(rb[:, 2 * nw + 2].view(np.uint32)), jnp.asarray(ftot)))
    got = K.pair_join(cta, torch.from_numpy(fa), torch.from_numpy(fb),
                      torch.from_numpy(ra), torch.from_numpy(rb)).numpy()
    assert_rows_equal(got, want, "J rows")
    paired = want[:, JP.J_PAIR] & 31
    assert (paired > 0).sum() > len(ra) // 4
    if world_name == "rep":
        assert ((want[:, JP.J_PAIR] >> 5) & 2047 > 1).any()


@pytest.mark.parametrize("hits_k", [16, 4, 1])
def test_pair_join_twin_matches_jax_on_synthetic_rows(pe, hits_k):
    """pair_join_plain against _device_pair_join on
    ``chip_smoke.k6_synthetic_rows`` (every combo eligible, no hit on a
    mate, scattered hits, unpaired draws past K, inserts at the bounds and
    across the int32 wrap, random hits) at K = 16, 4 and 1, with the
    default -w and with -w K*K (the max_hits bit)."""
    from chip_smoke import k6_synthetic_rows
    _, worlds = pe
    _cj, ct = cfgs(worlds["ref"], _param(2), "f", 7)
    MS, nw = ct.maxseg, ct.nw
    for max_hits in (ct.max_num_hits, hits_k * hits_k):
        c = ct._replace(hits_k=hits_k, max_num_hits=max_hits)
        ra, rb, ia, ib = k6_synthetic_rows(c, 700)
        ftot = np.maximum(ra[:, 2 * MS + K.X_FTOT], rb[:, 2 * MS + K.X_FTOT])
        want = np.asarray(_jit_join(MS, hits_k, c.min_ins, c.max_ins,
                                    max_hits)(
            jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(ia[:, 2 * nw]),
            jnp.asarray(ib[:, 2 * nw]), jnp.asarray(ia[:, 2 * nw + 1]),
            jnp.asarray(ib[:, 2 * nw + 1]),
            jnp.asarray(ia[:, 2 * nw + 2].view(np.uint32)),
            jnp.asarray(ib[:, 2 * nw + 2].view(np.uint32)),
            jnp.asarray(ftot)))
        got = K.pair_join_plain(c, *(torch.from_numpy(x)
                                     for x in (ra, rb, ia, ib))).numpy()
        assert_rows_equal(got, want, f"J rows, K = {hits_k}, -w {max_hits}")
        cnt = (want[:, JP.J_PAIR] >> 5) & 2047
        assert cnt.max() == hits_k * hits_k and (cnt == 0).any()
        capped = (want[:, JP.J_FLAGS] >> 3) & 1
        assert capped.any() == (max_hits == hits_k * hits_k)


@pytest.mark.parametrize("world_name,name,v,rank,cands_per_b", [
    ("ref", "p76", 2, 0, 2),
    ("rep", "rep", 3, -1, 16),
])
def test_pair_program_matches_jax(pe, world_name, name, v, rank,
                                  cands_per_b):
    """pair_program (both mates, then the join) on the CPU against
    _pair_fused_kernel end to end."""
    w, p, ra, rb, (cja, cta), (cjb, ctb) = both_mates(pe, world_name, name,
                                                      v)
    ra[:, -1] = rb[:, -1] = rank % cta.maxseg
    cands = cands_per_b * J.DEV_BATCH
    want = np.asarray(JP._pair_fused_kernel(
        cja, cjb, cands, *w["je"]._engine_args(), _pad(ra), _pad(rb)))
    got = K.pair_program(cta, ctb, cands, w["tabs"], torch.from_numpy(ra),
                         torch.from_numpy(rb)).numpy()
    assert_rows_equal(got, want[: len(ra)], "pair_program J rows")
