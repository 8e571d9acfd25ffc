"""The PyTorch port's multi-device engines against ``bsmap_tpu``'s on a CPU
mesh: ``--engine index-sharded`` (region shards of the seed index, K7's
merge) and ``--engine sharded`` (read stripes).

The port's mesh is a list of torch devices (``[cpu] * D`` here, the plain
twins on every shard); the JAX side runs on D of conftest's 8 virtual CPU
devices, as the JAX package's own tests run it.  Inputs are the same numpy
rows; every comparison is exact.  Seeds of 12 bases keep the 3^S-row shard
tables small."""

import random

import numpy as np
import pytest
import torch

from bsmap_tpu import cli as jcli
from bsmap_tpu.engine import device_engine as J
from bsmap_tpu.index import build_index
from bsmap_tpu.parallel import IndexShardedEngine as JIndexSharded
from bsmap_tpu.parallel import ShardedDeviceEngine as JSharded
from bsmap_tpu.parallel import index_sharded as jis
from bsmap_tpu.parallel import mesh as jmesh
from bsmap_tpu.params import Param
from bsmap_tpu.readio import open_read_stream
from bsmap_tpu.reference import load_genome
from bsmap_tpu.utils import myrand_hash
from bsmap_tpu_torch import cli as tcli
from bsmap_tpu_torch import obs
from bsmap_tpu_torch.engine import device_engine as T
from bsmap_tpu_torch.engine import kernels as K
from bsmap_tpu_torch.parallel import (IndexShardedEngine, ShardedDeviceEngine,
                                      make_mesh)
from bsmap_tpu_torch.parallel.index_sharded import (region_shards,
                                                    shard_kmer_tab)

from .conftest import simulate
from .test_torch_kernels import assert_rows_equal

CPU = torch.device("cpu")
SEED = 12                        # -s 12: 3^12-row bucket tables
CANDS = 4096


def _param(rrbs: bool = False) -> Param:
    """-v 2 -S 1, WGBS with 12-base seeds or RRBS (-D C-CGG)."""
    p = Param()
    if rrbs:
        p.set_digestion_site("C-CGG")
    else:
        p.set_seed_size(SEED)
    p.randseed = 1
    p.init_mapping()
    return p


def _rows(eng, path: str, p: Param, readset: int = 0,
          maxrank: int = 0) -> np.ndarray:
    """(n, 2nw+4) dispatch rows of a read file (JAX's packing, -S 1 hashes),
    in the nw = 7 layout when every read fits."""
    s = open_read_stream(path, p, readset=readset)
    batch = s.next_batch(100000)
    s.close()
    live, buds = eng._filter_batch(batch, [None] * len(batch))
    codes, regs, lens, buds, _rs, ridx = eng._pack_host(batch, live, buds)
    rows = J._pack_inputs(codes, regs, lens, buds, myrand_hash(ridx, 1),
                          np.full(len(lens), maxrank, np.int32))
    if lens.max() <= 112:
        rows = np.concatenate([rows[:, :7], rows[:, 10:17], rows[:, 20:]], 1)
    return np.ascontiguousarray(rows)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded")
    simulate(d, genome_out="ref.fa", reads_out="r.fq", n_reads=300,
             read_len=100, chr_len=12000, n_chr=3, seed=5, error_rate=0.02)
    simulate(d, genome_out="pe.fa", reads_out="p1.fq", reads2_out="p2.fq",
             pe=True, n_reads=120, read_len=76, chr_len=12000, n_chr=3,
             seed=5, error_rate=0.02)
    p = _param()
    genome = load_genome(str(d / "ref.fa"), p)
    index = build_index(genome, p)
    return {"dir": d, "genome": genome, "index": index, "p": p,
            "jis": {}, "tis": {}}


def engines(world, D: int):
    """(JAX, port) IndexShardedEngine over D shards, made once per D."""
    if D not in world["jis"]:
        g, i, p = world["genome"], world["index"], world["p"]
        world["jis"][D] = JIndexSharded(g, i, p, mesh=jmesh.make_mesh(D))
        world["tis"][D] = IndexShardedEngine(g, i, p, mesh=[CPU] * D)
    return world["jis"][D], world["tis"][D]


def port_cfg(cj) -> T.Cfg:
    return T.Cfg(**{f: getattr(cj, f) for f in T.Cfg._fields
                    if f != "shards"})


def jax_layout(g, i, ndev: int):
    """``bsmap_tpu``'s shard layout assembled from the port's
    ``region_shards``: (bounds, kmer_tab[ndev, tk, 6] with rows [local_w_off,
    GLOBAL_total, local_w_cnt, local_c_off, local_c_cnt, 0], wlocs, clocs
    zero-padded to the longest shard's)."""
    bounds, counts, shards = region_shards(g, i, ndev)
    tabs = np.zeros((ndev, len(counts), 6), dtype=np.int32)
    tabs[:, :, 1] = counts
    for d, (lwc, lcc, _lw, _lc) in enumerate(shards):
        tabs[d, :, [0, 4, 2, 3]] = shard_kmer_tab(lwc, lcc).T
        tabs[d, :, 5] = lcc
    ents = []
    for k in (2, 3):
        e = np.zeros((ndev, max(1, max(len(sh[k]) for sh in shards))),
                     dtype=np.uint32)
        for d, sh in enumerate(shards):
            e[d, : len(sh[k])] = sh[k]
        ents.append(e)
    return (bounds, tabs, *ents)


@pytest.mark.parametrize("ndev", [2, 4])
def test_build_region_shards_matches_jax(world, ndev):
    """The port's pure-numpy region split (``region_shards``, and each
    shard's bucket table ``shard_kmer_tab``) holds the numbers of
    ``bsmap_tpu``'s ``build_region_shards``, array for array, and the
    shards partition the index."""
    g, i = world["genome"], world["index"]
    got = jax_layout(g, i, ndev)
    want = jis.build_region_shards(g, i, ndev)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tab = got[1]
    assert (tab[:, :, 4].sum(axis=0) == np.diff(i.offsets)).all()
    assert (tab[:, :, 2].sum(axis=0) == i.wcounts).all()


# case: (chains, maxrank, cfg changes, mate 2): K1 full rows at the round-1
# rank, the exact schedule at full rank, the probe pass, -n 1 'b', and the
# PE mate-2 cfg with 16 hits, on the reads' reverse complements (mate-2
# reads, which the program turns back with K5)
CASES = {
    "fixed": ("f", 0, dict(fixed=True), False),
    "exact": ("f", -1, {}, False),
    "probe": ("f", -1, dict(probe=True), False),
    "both_chains": ("b", -1, {}, False),
    "pe_hits": ("r", -1, dict(pe=True, hits_k=16), True),
}


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_index_sharded_program_matches_jax(world, case, D):
    """``kernels.index_sharded_program`` (the twins of K1/K2 on the shard
    tables, K3 with the corner bit, K7) against ``_index_sharded_call`` on
    a D-device mesh: the same full rows (the probe pass's per-rank totals)
    bit for bit."""
    je, te = engines(world, D)
    chains, rank, kw, mate2 = CASES[case]
    rows = _rows(te, str(world["dir"] / "r.fq"), world["p"])
    cj = je._cfg(chains, nw=7)._replace(**kw)
    ct = te._cfg(chains, nw=7)._replace(**kw)
    assert ct == port_cfg(cj)._replace(shards=D)
    if mate2:
        rows = K.rc_words_plain(ct, torch.from_numpy(rows)).numpy()
    rows[:, -1] = rank % ct.maxseg
    want = np.asarray(je._dispatch(cj, rows, CANDS))
    got = te._dispatch(ct, rows, CANDS).numpy()
    assert_rows_equal(got, want, f"index-sharded {case}, D={D}")
    if not ct.probe:
        ex = 2 * ct.maxseg
        assert got[:, ex + K.X_FOUND].sum() > len(rows) // 2
        if ct.hits_k:
            assert (got[:, ex + K.N_EXTRAS + ct.hits_k:] >= 0).any()
            assert (got[:, ex + K.N_EXTRAS + ct.hits_k:] < 0).any()


def _write_fasta(path, chrs: dict) -> None:
    path.write_text("".join(
        f">{name}\n" + "\n".join(seq[i: i + 60]
                                 for i in range(0, len(seq), 60)) + "\n"
        for name, seq in chrs.items()))


@pytest.fixture(scope="module")
def repeat_world(tmp_path_factory):
    """Three 7.2 kb chromosomes of random bases (numpy, seed 23) with one
    120-base segment planted 25 times in each (75 copies, spread over
    every region of the genome), and 50 fully converted 100 nt reads, half
    from copies of the segment, half from elsewhere, on both strands."""
    d = tmp_path_factory.mktemp("torch_sharded_repeat")
    rng = np.random.default_rng(23)
    bases = np.array(list("ACGT"))
    seg = "".join(rng.choice(bases, 120))
    chrs = {}
    for c in range(3):
        s = list("".join(rng.choice(bases, 7200)))
        for k in range(25):
            at = 40 + k * 270 + int(rng.integers(0, 100))
            s[at: at + 120] = seg
        chrs[f"chr{c + 1}"] = "".join(s)
    _write_fasta(d / "rep.fa", chrs)
    comp = str.maketrans("ACGT", "TGCA")
    names = list(chrs)
    reads = []
    for k in range(50):
        g = chrs[names[k % 3]]
        if k % 2 == 0:                  # inside a copy of the segment
            at = g.find(seg, int(rng.integers(0, 6500)))
            at = (g.find(seg) if at < 0 else at) + int(rng.integers(0, 21))
        else:
            at = int(rng.integers(0, len(g) - 100))
        s = g[at: at + 100]
        if k % 4 >= 2:                  # the Crick strand
            s = s.translate(comp)[::-1]
        reads.append(s.replace("C", "T"))
    (d / "rep.fq").write_text("".join(
        f"@r{k}\n{s}\n+\n{'I' * 100}\n" for k, s in enumerate(reads)))
    p = _param()
    genome = load_genome(str(d / "rep.fa"), p)
    return {"dir": d, "genome": genome, "index": build_index(genome, p),
            "p": p, "jis": {}, "tis": {}}


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("case", ["fixed", "exact", "pe_hits"])
def test_index_sharded_many_candidates_match_jax(repeat_world, monkeypatch,
                                                 case, D):
    """``index_sharded_program`` (twins) against ``_index_sharded_call`` on
    reads with many candidates spread over the shards (the planted
    repeat): the same full rows bit for bit.  The case must reach what it
    is there for: a read with more than 64 candidates summed over the
    shards, and picks on more than one shard."""
    je, te = engines(repeat_world, D)
    chains, rank, kw, mate2 = CASES[case]
    rows = _rows(te, str(repeat_world["dir"] / "rep.fq"), repeat_world["p"])
    cj = je._cfg(chains, nw=7)._replace(**kw)
    ct = te._cfg(chains, nw=7)._replace(**kw)
    if mate2:
        rows = K.rc_words_plain(ct, torch.from_numpy(rows)).numpy()
    rows[:, -1] = rank % ct.maxseg
    seen = []
    real = K.merge_shards

    def merge(cfg, cands, r, vcs, slots):
        seen.append(vcs)
        return real(cfg, cands, r, vcs, slots)

    monkeypatch.setattr(K, "merge_shards", merge)
    want = np.asarray(je._dispatch(cj, rows, CANDS))
    got = te._dispatch(ct, rows, CANDS).numpy()
    assert_rows_equal(got, want, f"index-sharded {case}, D={D}, repeats")
    (vcs,) = seen
    NB, ex = ct.NB, 2 * ct.maxseg
    per = sum(np.minimum(v.starts.numpy()[NB::NB], CANDS)
              - np.minimum(v.starts.numpy()[:-1:NB], CANDS) for v in vcs)
    assert per.max() > 64
    shards = set()
    for b in np.nonzero(got[:, ex + K.X_FOUND])[0]:
        for d, v in enumerate(vcs):
            lo, hi = (min(int(v.starts[(b + i) * NB]), CANDS)
                      for i in (0, 1))
            if ((v.chrp[lo:hi].numpy() == got[b, ex + K.X_CHRP])
                    & (v.wloc[lo:hi].numpy() == got[b, ex + K.X_WLOC])).any():
                shards.add(d)
    assert len(shards) > 1


def test_k7_synthetic_cases_reach_their_edges():
    """``chip_smoke.k7_synthetic_cases``, which holds K7 against its twin on
    the card, builds what it promises, on each chain mode: reads with no,
    one and over 1,024 candidates summed over the shards, Watson entries
    before Crick ones in every slot, a read cut by the capacity on shard 0
    alone, a shard's total past the capacity, the totals' int32 wrap at D
    >= 4, and picks, replays and first level-0 forward hits in the twin's
    rows."""
    from chip_smoke import K7_SHAPES, k7_cands_per_read, k7_synthetic_cases
    base = T.Cfg(S=16, I=4, maxseg=3, chains_mode="f", P=40,
                 max_num_hits=20, report_repeat_hits=1, W=100, n_chr=1, nw=7)
    for mode in ("f", "r", "b"):
        cases = k7_synthetic_cases(K, base._replace(chains_mode=mode))
        assert len(cases) == 2 * len(K7_SHAPES)
        for name, c, cands, rows, vcs, slots in cases:
            NB, ex = c.NB, 2 * c.maxseg
            assert len(vcs) == len(slots) == c.shards
            per = [np.minimum(v.starts.numpy()[NB::NB], cands)
                   - np.minimum(v.starts.numpy()[:-1:NB], cands)
                   for v in vcs]
            tot = sum(per)
            assert (tot == 0).any() and (tot == 1).any(), name
            assert k7_cands_per_read(c, cands, vcs, "cpu")[1] > 1024, name
            for v in vcs:
                st = v.starts.numpy().astype(np.int64)
                n = min(int(st[-1]), cands)
                q = np.searchsorted(st[1:], np.arange(n), side="right")
                crick = v.chrp.numpy()[:n] & 1
                assert (np.diff(crick)[q[1:] == q[:-1]] >= 0).all(), name
            cut = [(v.starts.numpy()[(len(rows) - 2) * NB] < cands
                    < v.starts.numpy()[(len(rows) - 1) * NB]) for v in vcs]
            assert cut[0] and not any(cut[1:]), name
            want = K.merge_shards_plain(c, cands, rows, vcs, slots)
            x = want[:, ex:].numpy()
            assert x[:, K.X_FOUND].sum() > len(rows) // 2, name
            assert x[:, K.X_BIG].any() and not x[:, K.X_OK].all(), name
            assert x[:, K.X_REPLAY].any() and x[:, K.X_H00F].any(), name
            assert (x[:, K.X_SSUM] > 1).any(), name
            if c.shards >= 4:
                assert (x[:, K.X_TOTAL] < 0).any(), name


def _boundary_read(world, D: int) -> str:
    """A fully converted 100 nt Watson read starting 10 bases before an
    interior region boundary: its dedup key lies left of the boundary,
    the entries of its later seeds right of it."""
    g = world["genome"]
    bounds = region_shards(g, world["index"], D)[0].astype(np.int64)
    anchors = g.anchors[: g.n_chr].astype(np.int64)
    seqs = {}
    name = None
    for line in (world["dir"] / "ref.fa").read_text().splitlines():
        if line.startswith(">"):
            name = line[1:].split()[0]
            seqs[name] = []
        else:
            seqs[name].append(line.strip().upper())
    chrs = ["".join(seqs[n]) for n in g.names]
    for b in bounds[1:-1]:
        c = int(np.searchsorted(anchors, b, side="right") - 1)
        loc = int(b - anchors[c]) - 10
        if 0 <= loc and loc + 100 <= len(chrs[c]):
            read = chrs[c][loc: loc + 100].replace("C", "T")
            path = world["dir"] / f"corner{D}.fq"
            path.write_text(f"@corner\n{read}\n+\n{'I' * 100}\n")
            return str(path)
    raise AssertionError("no region boundary inside a chromosome")


@pytest.mark.parametrize("D", [2, 4])
def test_planted_corner_read_replays(world, D):
    """A read whose dedup key and seed entries sit in two regions: K3 marks
    its candidates INFO_CORNER on the entries' shard, and the merged row
    raises replay, as the JAX program's corner test does."""
    je, te = engines(world, D)
    rows = _rows(te, _boundary_read(world, D), world["p"],
                 maxrank=world["p"].max_snp_num)         # full rank
    for fixed in (False, True):
        cj = je._cfg("f", nw=7)._replace(fixed=fixed)
        ct = te._cfg("f", nw=7)._replace(fixed=fixed)
        want = np.asarray(je._dispatch(cj, rows, CANDS))
        got = te._dispatch(ct, rows, CANDS).numpy()
        assert_rows_equal(got, want, f"corner read, D={D}")
        ex = 2 * ct.maxseg
        assert got[0, ex + K.X_FOUND] == 1 and got[0, ex + K.X_REPLAY] == 1
    r = torch.from_numpy(rows)
    marked = 0
    for d, tabs in enumerate(te.shard_tables):
        s = K.exact_schedule(ct._replace(fixed=False), r, tabs["kmer_tab"],
                             tabs["prof_a"], gcnt=tabs["gcnt"])
        vc = K.verify_candidates(ct._replace(fixed=False), CANDS, r, s, tabs,
                                 shard=d)
        marked += int(((vc.info & K.INFO_CORNER) != 0).sum())
    assert marked > 0


def _rrbs_world(world):
    if "rrbs" not in world:
        from chip_smoke import make_rrbs_set
        d = world["dir"] / "rrbs"
        d.mkdir()
        make_rrbs_set(d, n_reads=300)
        p = _param(rrbs=True)
        g = load_genome(str(d / "rrbs.fa"), p)
        world["rrbs"] = (str(d / "se.fq"), p, g, build_index(g, p))
    return world["rrbs"]


@pytest.mark.parametrize("data", ["wgbs", "rrbs"])
def test_stripe_dispatch_matches_jax(world, data):
    """``ShardedDeviceEngine._dispatch`` (4 stripes of 128 reads, live rows
    only: the last stripe is padding alone and not launched) against
    ``_sharded_fused`` on the window zero-padded to 512 rows: the live
    rows and the psum'd found count."""
    if data == "wgbs":
        path, p = str(world["dir"] / "r.fq"), world["p"]
        g, i = world["genome"], world["index"]
    else:
        path, p, g, i = _rrbs_world(world)
    je = JSharded(g, i, p, mesh=jmesh.make_mesh(4), b_loc=128)
    te = ShardedDeviceEngine(g, i, p, mesh=[CPU] * 4, b_loc=128)
    assert te.B == 512 and te.C_loc == te.CANDS and not te._probe_ok
    rows = _rows(te, path, p, maxrank=p.max_snp_num)
    assert 256 < len(rows) <= 384
    for lean in (True, False):
        cj = je._cfg("f", lean=lean, nw=7)
        ct = te._cfg("f", lean=lean, nw=7)
        want = np.asarray(je._dispatch(
            cj, je._pad_rows(rows, np.arange(len(rows))), te.C_loc))
        got = te._dispatch(ct, rows, te.C_loc).numpy()
        assert_rows_equal(got, want[: len(rows)], f"stripes {data}")
        n_j = int(np.asarray(je.last_n_aligned)[0])
        assert int(te.last_n_aligned) == n_j > len(rows) // 2


def _cli_runs(world, tmp_path, monkeypatch, argv, engine: str, suffix: str):
    """Output bytes of one configuration: the port's engine on a 4-entry
    CPU mesh (in process, dispatch windows of 128 reads per stripe or
    shard), bsmap_tpu's same engine on 4 virtual devices, and bsmap_tpu's
    host engine.  Returns {name: [bytes of each output file]}."""
    if T.DEV_BATCH > 128:
        monkeypatch.setattr(T, "DEV_BATCH", 128)
    real = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda n_devices=None, axis="dp": real(4, axis))
    outs = {}
    for name in ("port", "jax", "host"):
        files = [str(tmp_path / f"{name}.{suffix}")]
        extra = ["-o", files[0]]
        if "-b" in argv and suffix == "bsp":
            files.append(str(tmp_path / f"{name}_u.{suffix}"))
            extra += ["-2", files[1]]
        if name == "port":       # -p 1: the mesh is this process's
            assert tcli.run(argv + extra + ["--engine", engine, "--device",
                                            "cpu", "-p", "1"],
                            mesh=[CPU] * 4) == 0
        else:
            assert jcli.run(argv + extra + [
                "--engine", engine if name == "jax" else "host"]) == 0
        outs[name] = [open(f, "rb").read() for f in files]
    return outs


SE_RUNS = {
    "sam": ["-S", "1", "-v", "2", "-u"],
    "bsp": ["-S", "2", "-v", "3", "-u"],
}


@pytest.mark.parametrize("engine", ["index-sharded", "sharded"])
@pytest.mark.parametrize("suffix", list(SE_RUNS))
def test_se_block_path_bytes(world, tmp_path, monkeypatch, engine, suffix):
    """SE through the port's mesh engine (the native block path) equals
    bsmap_tpu's host engine and its engine of the same name, byte for
    byte, as SAM and as BSP."""
    d = world["dir"]
    argv = ["-a", str(d / "r.fq"), "-d", str(d / "ref.fa"), "-s",
            str(SEED)] + SE_RUNS[suffix]
    outs = _cli_runs(world, tmp_path, monkeypatch, argv, engine, suffix)
    assert outs["port"] == outs["host"]
    assert outs["jax"] == outs["host"]
    assert outs["port"][0].count(b"\n") > 250


@pytest.mark.parametrize("engine", ["index-sharded", "sharded"])
def test_pe_per_pair_path_bytes(world, tmp_path, monkeypatch, engine):
    """PE through the port's mesh engine: the block path is off (the SE
    engine overrides _dispatch), each mate dispatches through the mesh
    engine and K6 joins; BSP with -2 equals both bsmap_tpu engines."""
    d = world["dir"]
    argv = ["-a", str(d / "p1.fq"), "-b", str(d / "p2.fq"), "-d",
            str(d / "pe.fa"), "-s", str(SEED), "-S", "1", "-v", "2"]
    outs = _cli_runs(world, tmp_path, monkeypatch, argv, engine, "bsp")
    assert outs["port"] == outs["host"]
    assert outs["jax"] == outs["host"]
    assert outs["port"][0].count(b"\n") > 100


def _twin_copies(d) -> tuple[str, str]:
    """200 A/G cores of 100 nt, each twice in the genome with one
    substitution per copy, and the exact cores as reads: every read has
    two level-1 hits, found in an order that depends on the seed schedule
    (a copy's substitution hides it from the segment that covers it)."""
    rng = random.Random(11)
    fill = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa
    g, reads = fill(500), []
    for _ in range(200):
        core = "".join(rng.choice("AG") for _ in range(100))
        for _ in range(2):
            c = list(core)
            i = rng.randrange(100)
            c[i] = "G" if c[i] == "A" else "A"
            g += "".join(c) + fill(300)
        reads.append(core)
    (d / "twin.fa").write_text(">chrX\n" + "\n".join(
        g[i: i + 60] for i in range(0, len(g), 60)) + "\n")
    (d / "twin.fq").write_text("".join(
        f"@r{k}\n{s}\n+\n{'I' * 100}\n" for k, s in enumerate(reads)))
    return str(d / "twin.fq"), str(d / "twin.fa")


def _load_jax_native(monkeypatch) -> None:
    """Load bsmap_tpu's native library for this test.  That package builds
    its library at first use through one shared temporary file, and a
    process whose first load met another process's build in flight keeps
    None (and so the per-batch CLI path, not the block path) for its
    lifetime: retry that load once the build is done.  The port builds
    through a file of each process's own and needs no retry."""
    from bsmap_tpu import native as jnative
    if jnative.get_lib() is None:
        monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.get_lib() is not None


def _block_ranks(cls, monkeypatch) -> list:
    """Record (reads, rank_start) at every align_block call of ``cls``."""
    seen, real = [], cls.align_block

    def align_block(self, block):
        seen.append((len(block), self.rank_start))
        return real(self, block)

    monkeypatch.setattr(cls, "align_block", align_block)
    return seen


def test_fixed_round_multi_hits_match_host(world, tmp_path, monkeypatch):
    """The index-sharded engine's fixed-schedule round returns full rows;
    its multi-hit reads must re-dispatch on the exact schedule, as the
    single-device engine's lean multi bit makes them.  With windows of 32
    reads the second block starts at full rank (most reads of the first
    escalated), so the fixed round meets level-1 multi-hit reads: the port
    equals the host engine, while bsmap_tpu's index-sharded engine, which
    reads the multi bit from column 1 of the full rows, picks the other
    hit of some reads (ROADMAP C).  Both CLIs must take the native block
    path for that, and both engines must have tuned block 2 to full rank;
    the test sees to the first and asserts the second."""
    from bsmap_tpu_torch import native as tnative
    _load_jax_native(monkeypatch)
    assert tnative.get_lib() is not None
    reads, ref = _twin_copies(tmp_path)
    monkeypatch.setattr(J, "DEV_BATCH", 32)
    monkeypatch.setattr(T, "DEV_BATCH", 32)
    ranks = {"jax": _block_ranks(JIndexSharded, monkeypatch),
             "port": _block_ranks(IndexShardedEngine, monkeypatch)}
    argv = ["-a", reads, "-d", ref, "-s", str(SEED), "-S", "1", "-v", "2",
            "-u"]
    outs = _cli_runs(world, tmp_path, monkeypatch, argv, "index-sharded",
                     "sam")
    full = min(T.MAXSNPS, 2)                  # maxseg - 1 at -v 2
    for name, seen in ranks.items():
        assert [b for b, _ in seen] == [32, 64, 104], name
        assert [r for _, r in seen][:2] == [0, full], name
    assert outs["port"] == outs["host"]
    assert outs["jax"] != outs["host"]


@pytest.mark.parametrize("engine", ["device", "sharded", "index-sharded",
                                    "host"])
def test_cli_engine_wiring(world, tmp_path, engine):
    """Each --engine value builds its engine (the mesh engines over one CPU
    entry under --device cpu) and writes the host engine's bytes."""
    d = world["dir"]
    argv = ["-a", str(d / "r.fq"), "-d", str(d / "ref.fa"), "-s", str(SEED),
            "-S", "1", "-u", "--device", "cpu"]
    st = {}
    out = str(tmp_path / "o.sam")
    assert tcli.run(argv + ["-o", out, "--engine", engine], stats=st) == 0
    eng = st["engine"]
    want = {"device": T.DeviceEngine, "sharded": ShardedDeviceEngine,
            "index-sharded": IndexShardedEngine}.get(engine)
    if want is None:
        assert not isinstance(eng, T.DeviceEngine)
    else:
        assert type(eng) is want
        assert getattr(eng, "mesh", [CPU]) == [CPU]
    ref = str(tmp_path / "h.sam")
    assert tcli.run(argv + ["-o", ref, "--engine", "host"]) == 0
    assert open(out, "rb").read() == open(ref, "rb").read()


def test_mesh_devices(world):
    """make_mesh: n CPU entries; on CUDA the visible cards, more than those
    a ValueError; with none visible the mesh engines' default mesh raises
    instead of falling back to the CPU."""
    assert make_mesh(3, "cpu") == [CPU] * 3
    assert make_mesh(device="cpu") == [CPU]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError):
        make_mesh(n + 1)
    if n:
        assert make_mesh() == [torch.device("cuda", k) for k in range(n)]
        return
    g, i, p = world["genome"], world["index"], world["p"]
    for cls in (IndexShardedEngine, ShardedDeviceEngine):
        with pytest.raises(RuntimeError):
            cls(g, i, p)


def test_index_sharded_refuses_rrbs(world):
    _path, p, g, i = _rrbs_world(world)
    with pytest.raises(T.EngineUnsupported):
        IndexShardedEngine(g, i, p, mesh=[CPU] * 2)


def _stripe_window(world, b_loc: int, n: int):
    """A ShardedDeviceEngine over 4 CPU entries with ``b_loc``-row stripes,
    a lean cfg and the first ``n`` dispatch rows of the read file."""
    g, i, p = world["genome"], world["index"], world["p"]
    te = ShardedDeviceEngine(g, i, p, mesh=[CPU] * 4, b_loc=b_loc)
    rows = _rows(te, str(world["dir"] / "r.fq"), p, maxrank=p.max_snp_num)
    assert len(rows) >= n
    return te, te._cfg("f", lean=True, nw=7), rows[:n]


def _traced_dispatch(te, ct, rows) -> list:
    obs.start()
    try:
        te._collect([te._dispatch(ct, rows, te.C_loc)])
    finally:
        recs = obs.stop()["records"]
    return recs


def test_stripe_spans_name_their_cards(world):
    """Under obs each stripe is an ``engine.stripe`` span with its card
    and rows, around its h2d, launch and gather (the copy of its rows to
    the first device); no stripe of this window is padding alone."""
    te, ct, rows = _stripe_window(world, 64, 256)
    recs = _traced_dispatch(te, ct, rows)
    stripes = [k for k, r in enumerate(recs) if r["name"] == "engine.stripe"]
    assert [recs[k]["attrs"] for k in stripes] == [
        {"rows": 64, "card": d} for d in range(4)]
    for name in ("engine.h2d", "engine.launch", "engine.gather"):
        inner = [r["parent"] for r in recs if r["name"] == name]
        assert inner == stripes, name
    assert not [r for r in recs if r["name"].startswith("mesh.")]


def test_padding_stripe_leaves_mesh_skip(world):
    """A window of 150 live rows over 4 stripes of 64: stripe 3 is
    padding alone, is not launched and leaves ``mesh.skip`` with its
    card."""
    te, ct, rows = _stripe_window(world, 64, 150)
    recs = _traced_dispatch(te, ct, rows)
    assert [r["attrs"] for r in recs if r["name"] == "engine.stripe"] == [
        {"rows": 64, "card": 0}, {"rows": 64, "card": 1},
        {"rows": 22, "card": 2}]
    skips = [r for r in recs if r["name"] == "mesh.skip"]
    assert [(r["kind"], r["attrs"]) for r in skips] == [
        ("instant", {"card": 3})]


class _CountingEvent:
    """Counts the CUDA timing events made."""

    made = 0

    def __init__(self, **_kw):
        type(self).made += 1


def test_untraced_dispatch_creates_no_event(world, monkeypatch):
    """With obs off ``_dispatch`` and ``_collect`` record nothing; traced
    or not, they create no CUDA event: a stripe's time on its card is the
    profiler's to read, not the engine's."""
    monkeypatch.setattr(torch.cuda, "Event", _CountingEvent)
    monkeypatch.setattr(_CountingEvent, "made", 0)
    te, ct, rows = _stripe_window(world, 64, 150)
    obs.stop()
    te._collect([te._dispatch(ct, rows, te.C_loc)])
    assert obs.stop()["records"] == []
    recs = _traced_dispatch(te, ct, rows)
    assert [r["name"] for r in recs if r["name"] == "engine.stripe"] == [
        "engine.stripe"] * 3
    assert _CountingEvent.made == 0


@pytest.mark.parametrize("n", [64, 150, 256])
def test_traced_dispatch_gives_the_untraced_rows(world, n):
    """Tracing changes no row: a window of one stripe, one whose last
    stripe is padding alone, and a full one give the same rows with obs
    on and off."""
    te, ct, rows = _stripe_window(world, 64, n)
    obs.stop()
    off = te._collect([te._dispatch(ct, rows, te.C_loc)])[0]
    obs.start()
    try:
        on = te._collect([te._dispatch(ct, rows, te.C_loc)])[0]
    finally:
        obs.stop()
    assert off.shape[0] == n
    np.testing.assert_array_equal(on, off)


def test_stage_profile_sharded_on_a_cpu_mesh(world, tmp_path, monkeypatch):
    """``stage_profile --engine sharded``'s profile on a 4-entry CPU mesh:
    the stages of the sharded engine, then the single-device engine
    beside it, each with its whole-CLI runs; no device reading on the
    CPU."""
    from bsmap_tpu_torch import stage_profile
    monkeypatch.setenv("BSMAP_TPU_LOCAL_MP", "0")
    monkeypatch.setattr(T, "DEV_BATCH", 128)
    d = world["dir"]
    res = stage_profile.profile_se(
        str(tmp_path), str(d / "ref.fa"), str(d / "r.fq"),
        ["-s", str(SEED), "-v", "2", "-S", "17"], "sharded", [CPU] * 4,
        300, dev="cpu")
    assert list(res) == ["sharded", "device"]
    assert res["sharded"]["engine"] == "sharded"
    assert res["sharded"]["mesh"] == ["cpu"]
    assert res["device"]["engine"] == "device"
    for r in res.values():
        assert r["align_s"] > 0 and r["pipeline_reads_per_s"] > 0
        assert r["align_timers_s"]["t_h2d"] > 0
        assert r["device_idle_share"] is None and r["kernel_ms"] is None
