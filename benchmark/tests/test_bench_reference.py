"""The plain reference on reads planted in a small genome: FilterReads'
trims, every hit within the budget on both strands, BSMAP's mismatch
count, and the verdicts of the check on lines it writes itself."""

import numpy as np
import pytest

import compare
import refalign as ra

ACGT = "ACGT"


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 60_000).astype(np.uint8)
    b = rng.integers(0, 4, 40_000).astype(np.uint8)
    b[10_000:10_300] = a[20_000:20_300]        # a 300 bp repeat
    tg = ra.Targets([("chrA", a), ("chrB", b)], "cpu")
    return tg, a, b


def _seq(codes):
    return "".join(ACGT[c] for c in codes)


def _bs(seq):        # a fully converted Watson read
    return seq.replace("C", "T")


def test_filter_read_trims_adapter_and_quality():
    o = ra.Options(max_snp=5, adapters=("AGATCGGAAGAGC",), qual_threshold=2)
    body = "ACGTTGCA" * 5
    kept, seq, qual, budget, raw = ra.filter_read(
        body + "AGATCGGAAGAGCACACGTCTGAACTCC"[:60], "I" * 68, o)
    assert kept and seq == body and budget == 6 * 39 // 68 and raw == 68
    kept, seq, *_ = ra.filter_read(body * 2 + "A" * 20, "I" * 40 + "#" * 60,
                                   o)
    assert kept and seq == (body * 2)[:40]
    kept, *_ = ra.filter_read(body * 2 + "A" * 20, "I" * 8 + "#" * 92, o)
    assert not kept
    kept, *_ = ra.filter_read("N" * 6 + body * 2, "I" * 86, o)
    assert not kept


def _queries(records, chain=0, v=5):
    o = ra.Options(max_snp=v)
    return o, ra.prepare(records, o, chain)


def test_search_finds_planted_hits(world):
    tg, a, b = world
    w1 = _bs(_seq(a[1000:1100]))
    mm = list(_seq(a[5000:5100]))
    mm[10], mm[40] = ("A" if mm[10] != "A" else "G"), \
        ("A" if mm[40] != "A" else "G")
    w2 = _bs("".join(mm))
    crick = _bs(ra.revcomp(_seq(b[30000:30100])))
    rep = _bs(_seq(a[20_100:20_200]))
    o, qs = _queries([("r0", w1, "I" * 100), ("r1", w2, "I" * 100),
                      ("r2", crick, "I" * 100), ("r3", rep, "I" * 100)])
    ra.search(tg, qs, o)
    lv = [compare.best(q) for q in qs]
    assert (lv[0][0], [(h.chr, h.parity, h.wloc) for h in lv[0][1]]) == \
        (0, [(0, 0, 1000)])
    assert lv[1][0] == 2 and lv[1][1][0].wloc == 5000
    assert lv[2][0] == 0 and (lv[2][1][0].chr, lv[2][1][0].parity,
                              lv[2][1][0].wloc) == (1, 1, 30000)
    assert sorted((h.chr, h.wloc) for h in lv[3][1]) == [(0, 20_100),
                                                          (1, 10_100)]
    assert [compare.exact_se(q) for q in qs] == [True] * 4, [
        (q.nseg, [(h.w, h.broken) for h in q.hits]) for q in qs]


def test_read_t_over_reference_c_is_no_mismatch(world):
    tg, a, _ = world
    s = _seq(a[2000:2100])
    o, qs = _queries([("r", s.replace("C", "T"), "I" * 100),
                      ("c", s, "I" * 100)])
    q = qs[0]
    assert ra.count_at(tg, q, 0, 2000, 0) == 0
    # a read C over a reference T counts, under BSMAP's count alone
    g = list(_bs(s))
    t_at = [i for i, c in enumerate(s) if c == "T"][:3]
    for i in t_at:
        g[i] = "C"
    q3 = ra.prepare([("x", "".join(g), "I" * 100)], o, 0)[0]
    assert ra.count_at(tg, q3, 0, 2000, 0) == 3
    assert ra.count_at(tg, q3, 0, 2000, 0, rule="3l") == 0


def test_check_accepts_bsmap_lines_and_refuses_altered(world):
    tg, a, b = world
    recs = [(f"r{i}", _bs(_seq(a[p: p + 100])), "I" * 100)
            for i, p in enumerate(range(100, 40_000, 3_000))]
    o, qs = _queries(recs)
    ra.search(tg, qs, o)
    for q in qs:
        lv, top = compare.best(q)
        line = compare.se_line(q, top[0], len(top) > 1, tg.names)
        assert compare.judge_se(q, [line], tg) is None
        f = line.split("\t")
        f[3] = str(int(f[3]) + 1)
        assert compare.judge_se(q, ["\t".join(f)], tg) is not None
        assert compare.judge_se(q, [], tg) is not None
        f = line.split("\t")
        f[11] = "NM:i:1"
        assert compare.judge_se(q, ["\t".join(f)], tg) is not None


def test_pair_lines_judged(world):
    tg, a, _ = world
    o = ra.Options(max_snp=5)
    frag = _seq(a[7000:7250])
    m1 = _bs(frag[:100])
    m2 = ra.revcomp(_bs(frag))[:100]
    qa = ra.prepare([("p0", m1, "I" * 100)], o, 0)
    qb = ra.prepare([("p0", m2, "I" * 100)], o, 1)
    ra.search(tg, qa + qb, o)
    pairs = compare.proper_pairs(qa[0], qb[0], o)
    assert [(p[4], p[2].wloc, p[3].wloc) for p in pairs] == [(250, 7000,
                                                               7150)]
    lines = compare.pair_lines(qa[0], qb[0], pairs[0][2], pairs[0][3], 250,
                               False, tg.names).splitlines(True)
    assert compare.judge_pe(qa[0], qb[0], lines, tg, o) is None
    assert lines[0].split("\t")[1] == "99" and lines[1].split("\t")[1] == "147"
    assert compare.judge_pe(qa[0], qb[0], lines[:1], tg, o) is not None
    assert compare.judge_pe(qa[0], qb[0], [], tg, o) is not None
