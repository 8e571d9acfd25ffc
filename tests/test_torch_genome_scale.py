"""``bsmap_tpu_torch.genome_scale`` at a CPU size, and the chunked strand
and region splits it needs at human scale: its genome is
``tools/hg38_scale.py``'s byte for byte, its steps run end to end on the
twins with every parity check held, and the splits keep the tables and
shards of the whole-array constructions they replace (and of
``bsmap_tpu``'s) on indexes whose coordinates lie past 2^31."""

import pickle

import numpy as np
import pytest
import torch

from bsmap_tpu.engine import device_engine as J
from bsmap_tpu.parallel import index_sharded as jis
from bsmap_tpu_torch import genome_scale as gs
from bsmap_tpu_torch.engine import device_engine as T
from bsmap_tpu_torch.index import SeedIndex, build_index
from bsmap_tpu_torch.parallel.index_sharded import region_shards
from bsmap_tpu_torch.params import Param
from bsmap_tpu_torch.reference import PackedGenome, load_genome

from .test_torch_sharded import jax_layout

SMALL = ["--device", "cpu", "--n-chr", "2", "--chr-len", "1050000",
         "--se-reads", "3000", "--pe-pairs", "1500", "--parity", "600",
         "--sharded-reads", "1000", "--workers-reads", "1000", "--procs",
         "2", "-s", "12"]


def test_gen_genome_matches_hg38_scale(tmp_path, monkeypatch):
    """The port's copy of gen_genome writes tools/hg38_scale.py's FASTA,
    at the tool's sizes and at a small one."""
    from tools import hg38_scale
    assert (gs.N_CHR, gs.CHR_LEN) == (hg38_scale.N_CHR, hg38_scale.CHR_LEN)
    monkeypatch.setattr(hg38_scale, "N_CHR", 3)
    monkeypatch.setattr(hg38_scale, "CHR_LEN", 7000)
    gs.gen_genome(str(tmp_path / "port.fa"), 3, 7000)
    hg38_scale.gen_genome(str(tmp_path / "tool.fa"))
    port = (tmp_path / "port.fa").read_bytes()
    assert port == (tmp_path / "tool.fa").read_bytes()
    assert port.count(b">chr") == 3 and len(port) > 3 * 7000
    chrs = gs.chr_arrays(str(tmp_path / "port.fa"), 3, 7000)
    assert [len(c) for c in chrs] == [7000] * 3
    assert b"".join(c.tobytes() for c in chrs) == b"".join(
        x for x in port.split(b"\n") if not x.startswith(b">"))


def test_draw_se_reads_are_genreads_reads():
    """draw_se_reads makes tools/genreads.make_reads' reads, and each one
    is the (reverse-complemented, for Crick) window it names, converted."""
    from tools.genreads import COMP, make_genome, make_reads
    chrs = make_genome(5, 3, 20000)
    reads, ci, pos, crick = gs.draw_se_reads(1, chrs, 500, 100)
    assert np.array_equal(reads, make_reads(1, chrs, 500, 100))
    for i in range(0, 500, 7):
        w = chrs[ci[i]][pos[i]: pos[i] + 100]
        if crick[i]:
            w = COMP[w][::-1]
        assert np.array_equal(np.where(w == ord("C"), ord("T"), w), reads[i])
    assert 0.3 < crick.mean() < 0.7


def test_pe_reads_and_fastq_are_genreads(tmp_path):
    """The port's copies of make_pe_reads and write_fastq make
    tools/genreads.py's pairs and FASTQ bytes."""
    from tools import genreads
    chrs = genreads.make_genome(5, 3, 20000)
    got = gs.make_pe_reads(38, chrs, 700, 100)
    want = genreads.make_pe_reads(38, chrs, 700, 100)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    gs.write_fastq(str(tmp_path / "port.fq"), got[0])
    genreads.write_fastq(str(tmp_path / "tool.fq"), want[0])
    assert (tmp_path / "port.fq").read_bytes() == \
        (tmp_path / "tool.fq").read_bytes()
    assert np.array_equal(gs.COMP, genreads.COMP)


def test_genome_scale_steps_end_to_end_on_the_cpu(tmp_path):
    """Every step at 2 x 1,050,000 bases on the twins: the JSON record has
    every number, the reads sit at their true places, and the host-engine,
    index-sharded and two-process outputs are byte-identical."""
    a = gs.parse(SMALL + ["--dir", str(tmp_path)])
    out = gs.run(a)
    assert set(gs.STEPS) <= set(out)
    assert out["genome"]["genome_bp"] == 2_100_000
    ix = out["index"]
    assert ix["entries"] == ix["watson_entries"] + ix["crick_entries"] > 0
    for k in ("build_s", "save_s", "mmap_load_s", "bytes", "max_loc"):
        assert k in ix
    tb = out["tables"]
    assert tb["tables_total_bytes"] == sum(tb["table_bytes"].values())
    assert tb["table_bytes"]["wlocs"] == 4 * ix["watson_entries"]
    se = out["se"]
    for k in ("align_s", "reads_per_s", "n_dispatched", "n_probe",
              "n_replayed", "cands_mean", "cands_max", "high",
              "parity_bytes", "profile", "peak_rss_gb"):
        assert k in se
    assert se["high"]["all_at_true_place"] >= 0.99 * 3000
    assert se["parity_reads"] == 600 and se["parity_bytes"] > 0
    pe = out["pe"]
    assert pe["pairs"] == 1500 and pe["parity_bytes"] > 0
    assert pe["methratio"]["ratio_lines"] >= 1
    assert "valid mappings" in pe["methratio"]["summary"]
    for D in (2, 4):
        assert out["sharded"][f"D{D}"]["bytes"] > 0
        k7 = out["sharded"][f"D{D}"]["k7"]
        assert k7["max_abs_err"] == 0 and k7["live_candidates"] > 0
    wk = out["workers"]
    assert wk["bytes"] == out["sharded"]["D2"]["bytes"]
    assert len(wk["per_process"]) == 2 and wk["host_workers"] >= 1
    # --procs 2 on the CPU: trimming starts the CLI's two workers there
    assert wk["se_trim"]["processes"] == 3 and wk["se_trim"]["bytes"] > 0
    pb = wk["pe_bsp"]
    assert pb["workers"] == 2 and pb["bytes"] > 0
    for r in pb["per_worker"]:
        assert any(f.startswith("gen_") for f in r["mapped_files"])
        assert any(f.startswith("idx_") for f in r["mapped_files"])
    for name in gs.STEPS:
        assert out[name]["card"] == "cpu" and out[name]["step_s"] >= 0
    # a second run takes the genome and index from the caches
    again = gs.run(gs.parse(SMALL + ["--dir", str(tmp_path),
                                     "--steps", "genome,index"]))
    assert "fasta_s" not in again["genome"]
    assert "build_s" not in again["index"]
    assert again["index"]["entries"] == ix["entries"]


def high_world(seed: int):
    """A PackedGenome and WGBS SeedIndex of a few hundred entries whose
    anchors and entries lie past 2^31 (the genome words are a stub: the
    splits read only the coordinates)."""
    rng = np.random.RandomState(seed)
    sizes = np.array([90_000, 1_000_000_000, 600_000_000], dtype=np.int64)
    n_words = (sizes + 15) // 16 + 2
    rcoff = n_words * 16
    anchors = np.zeros(4, dtype=np.int64)
    anchors[0] = (1 << 31) - 60_000
    anchors[1:] = anchors[0] + np.cumsum(rcoff)
    genome = PackedGenome(
        names=["c1", "c2", "c3"], sizes=sizes, n_words=n_words,
        rc_offsets=rcoff, anchors=anchors,
        refcat=rng.randint(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32),
        crefcat=rng.randint(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32),
        block_id=np.zeros(0, np.int64), block_begin=np.zeros(0, np.int64),
        block_end=np.zeros(0, np.int64))
    S = 4
    tk = 3 ** S
    counts = rng.randint(0, 9, tk) * (rng.random_sample(tk) < 0.8)
    wc = np.minimum(rng.randint(0, 9, tk), counts)
    offsets = np.zeros(tk + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    locs = np.zeros(int(offsets[-1]), dtype=np.uint32)
    for b in range(tk):
        run = []
        for n in (wc[b], counts[b] - wc[b]):
            c = rng.randint(0, 3, n)
            run.append(np.sort(anchors[c] + (rng.random_sample(n) * sizes[c])
                               .astype(np.int64)))
        locs[offsets[b]: offsets[b + 1]] = np.concatenate(run)
    index = SeedIndex(seed_size=S, rrbs=False, offsets=offsets, locs=locs,
                      wcounts=wc.astype(np.int32), tags=None)
    assert int(locs.max()) > 3_000_000_000 and len(locs) > 200
    return genome, index


def whole_split(index):
    """The strand split the chunked one replaced: an int8 +1/-1 diff array
    over every entry, its cumsum, a mask."""
    total = len(index.locs)
    wc = index.wcounts.astype(np.int64)
    diff = np.zeros(total + 1, dtype=np.int8)
    nz = wc > 0
    np.add.at(diff, index.offsets[:-1][nz], 1)
    np.add.at(diff, (index.offsets[:-1] + wc)[nz], -1)
    is_w = np.cumsum(diff[:total], dtype=np.int8) > 0
    return index.locs[is_w], index.locs[~is_w]


@pytest.mark.parametrize("chunk", [7, 64, 1 << 24])
@pytest.mark.parametrize("seed", [3, 4])
def test_chunked_splits_keep_every_bit_past_2_31(monkeypatch, seed, chunk):
    """In chunks that cut buckets, the strand split gives the entries of
    the whole-array split, and region_shards bsmap_tpu's
    build_region_shards, on coordinates past 2^31."""
    monkeypatch.setattr(T, "SPLIT_CHUNK", chunk)
    genome, index = high_world(seed)
    p = Param()
    p.init_mapping()
    tabs = T.tables_from_numpy(genome, index, p)
    wl, cl = whole_split(index)
    assert np.array_equal(tabs["wlocs"].numpy().view(np.uint32), wl)
    assert np.array_equal(tabs["clocs"].numpy().view(np.uint32), cl)
    assert tabs["wlocs"].numpy().view(np.uint32).max() > 2 ** 31
    for ndev in (2, 3, 4):
        got = jax_layout(genome, index, ndev)
        want = jis.build_region_shards(genome, index, ndev)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        _b, counts, shards = region_shards(genome, index, ndev)
        assert sum(len(sh[2]) for sh in shards) == len(wl)
        assert sum(len(sh[3]) for sh in shards) == len(cl)


@pytest.mark.parametrize("chunk", [1000, 1 << 24])
def test_chunked_tables_equal_jax_engine_tables(tmp_path, monkeypatch, chunk):
    """On a real (small) genome at -s 12, the chunked tables equal
    bsmap_tpu's DeviceEngine device arrays."""
    monkeypatch.setattr(T, "SPLIT_CHUNK", chunk)
    gs.gen_genome(str(tmp_path / "g.fa"), 2, 70_000)
    p = Param()
    p.set_seed_size(12)
    p.init_mapping()
    genome = load_genome(str(tmp_path / "g.fa"), p)
    index = build_index(genome, p)
    je = J.DeviceEngine(genome, index, p)
    got = T.tables_from_numpy(genome, index, p, device=torch.device("cpu"))
    for k in ("kmer_tab", "wlocs", "clocs", "catcat", "anchors", "sizes",
              "rcoff"):
        want = np.asarray(getattr(je, f"d_{k}"))
        assert got[k].shape == want.shape, k
        assert np.array_equal(got[k].numpy(), want.view(np.int32)), k


def test_replay_host_unpacks_its_codes_at_first_use(tmp_path):
    """The device engines' replay host holds what HostEngine holds but
    the unpacked codes, makes those on first use equal to HostEngine's,
    and aligns a read as HostEngine does."""
    from bsmap_tpu_torch.engine.host_engine import HostEngine
    from bsmap_tpu_torch.readio import Read
    gs.gen_genome(str(tmp_path / "g.fa"), 2, 7000)
    p = Param()
    p.set_seed_size(12)
    p.init_mapping()
    genome = load_genome(str(tmp_path / "g.fa"), p)
    index = build_index(genome, p)
    h, r = HostEngine(genome, index, p), T.ReplayHost(genome, index, p)
    assert set(vars(h)) == set(vars(r)) | {"refcodes", "crefcodes"}
    assert not {"refcodes", "crefcodes"} & set(vars(r))
    chrs = gs.chr_arrays(str(tmp_path / "g.fa"), 2, 7000)
    seq = chrs[1][3000: 3100].tobytes().decode().replace("C", "T")
    read = Read(index=0, readset=0, name="r0", seq=seq, qual="I" * 100)
    want = h.run_align(read, 2)
    assert any(len(x) for x in want.hits)
    assert pickle.dumps(r.run_align(read, 2)) == pickle.dumps(want)
    assert "refcodes" in vars(r)         # made by the replay above
    for k in ("refcodes", "crefcodes"):
        assert np.array_equal(getattr(r, k), vars(h)[k])
    with pytest.raises(AttributeError):
        r.no_such_attribute
