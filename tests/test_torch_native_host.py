"""The host route's native WGBS aligner (``engine/native_host.py`` over
``native/host_align.cpp``) against the port's copied Python engines
(``HostEngine.run_align``/``sync_schedule``, ``PairHostEngine._run_pair``),
read by read and pair by pair, each side through its own ``MateState``
sequence: every hits/chits list in order, the counts, the pairhits
buckets in order, ``paired`` and the ``MateState`` after every read.

The genome plants repeat families (exact copies and copies a few
mismatches off) so that buckets pass ``max_num_hits`` (-w): the level-0
return and the snp_thres tightening both fire.  Reads come from both
strands, near chromosome ends, at lengths with ``max_offset == 0`` (the
stale seed buffers and start offsets are read) and with Ns."""

from __future__ import annotations

import io
import random

import numpy as np
import pytest

from bsmap_tpu_torch.engine.host_engine import HostEngine, MateState
from bsmap_tpu_torch.engine.native_host import NativeHost
from bsmap_tpu_torch.engine.pair_host import PairHostEngine
from bsmap_tpu_torch.index import build_index
from bsmap_tpu_torch.params import Param
from bsmap_tpu_torch.readio import Read
from bsmap_tpu_torch.reference import load_genome

COMP = str.maketrans("ACGTN", "TGCAN")
_WORLDS: dict = {}


def _genome_fasta(rng: random.Random) -> tuple[str, list[str]]:
    """Three chromosomes of random filler with two repeat families: a
    120-base core copied exactly six times and a 90-base core copied
    eight times with one or two mismatches, some copies reversed."""
    filler = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa
    core_a = filler(120)
    core_b = filler(90)

    def mutate(s: str, k: int) -> str:
        s = list(s)
        for pos in rng.sample(range(len(s)), k):
            s[pos] = rng.choice([c for c in "ACGT" if c != s[pos]])
        return "".join(s)

    copies = [core_a] * 6 + [mutate(core_b, rng.randint(1, 2))
                             for _ in range(8)]
    rng.shuffle(copies)
    chrs = [[filler(rng.randint(200, 900))] for _ in range(3)]
    for k, c in enumerate(copies):
        if k % 3 == 1:
            c = c.translate(COMP)[::-1]
        chrs[k % 3] += [c, filler(rng.randint(100, 600))]
    seqs = ["".join(parts) for parts in chrs]
    fa = "".join(f">chr{i + 1}\n{s}\n" for i, s in enumerate(seqs))
    return fa, seqs


def _param(S: int, I: int, **kw) -> Param:
    p = Param()
    p.set_seed_size(S)
    p.index_interval = I
    for k, v in kw.items():
        setattr(p, k, v)
    p.init_mapping()
    return p


def _world(S: int, I: int):
    if (S, I) not in _WORLDS:
        rng = random.Random(1000 * S + I)
        fa, seqs = _genome_fasta(rng)
        p = _param(S, I)
        genome = load_genome(io.StringIO(fa), p)
        _WORLDS[S, I] = (genome, build_index(genome, p), seqs)
    return _WORLDS[S, I]


def _bisulfite(frag: str, rng: random.Random) -> str:
    """Watson-strand conversion (C to T), a few sequencing errors, Ns in
    one read of eight."""
    s = list(frag.replace("C", "T"))
    for _ in range(rng.choice([0, 0, 1, 2, 3])):
        k = rng.randrange(len(s))
        s[k] = rng.choice("ACGT")
    if rng.random() < 0.125:
        for _ in range(rng.randint(1, 3)):
            s[rng.randrange(len(s))] = "N"
    return "".join(s)


def _lengths(S: int, I: int, rng: random.Random, long: bool = False) -> int:
    """Read lengths: one in three with max_offset == 0; ``long``: up to
    the longest whose seeds fit the MateState buffers, where a deep
    segment's probes pass their end."""
    if long:
        return rng.randint(140, MateState.SEEDBUF + S - 1)
    if rng.random() < 0.34:
        return S * rng.randint(3, 7) + I - 1
    return rng.randint(S + 4, 110)


def _fragment(seqs, rng: random.Random, n: int) -> str:
    """``n`` bases from a chromosome: at an end one time in five, else
    anywhere (the repeats included); from the Crick strand half the
    time."""
    s = rng.choice(seqs)
    n = min(n, len(s))
    r = rng.random()
    pos = (0 if r < 0.1 else len(s) - n if r < 0.2
           else rng.randint(0, len(s) - n))
    frag = s[pos: pos + n]
    return frag.translate(COMP)[::-1] if rng.random() < 0.5 else frag


def _budget(p: Param, L: int, rng: random.Random) -> int:
    """FilterReads' budget of a read trimmed to ``L`` from a raw length at
    or above it."""
    return p.read_max_snp_num(L, L + rng.choice([0, 0, 0, 5, 20, 60]))


def _same_state(a: MateState, b: MateState) -> None:
    assert np.array_equal(a.seed_buf, b.seed_buf)
    assert np.array_equal(a.cseed_buf, b.cseed_buf)
    assert (a.seed_start_offset, a.cseed_start_offset) == \
        (b.seed_start_offset, b.cseed_start_offset)


def _same_result(a, b) -> None:
    assert a.filtered == b.filtered
    assert a.read_max_snp_num == b.read_max_snp_num
    assert a.seedseg_num == b.seedseg_num
    assert a.aborted_repeat == b.aborted_repeat
    assert a.hits == b.hits
    assert a.chits == b.chits
    assert np.array_equal(a.n_hit, b.n_hit)
    assert np.array_equal(a.n_chit, b.n_chit)
    assert a.n_hit.dtype == b.n_hit.dtype


def _engines(S: int, I: int, **kw):
    genome, index, seqs = _world(S, I)
    p = _param(S, I, **kw)
    py = HostEngine(genome, index, p)
    nat = NativeHost.create(py)
    assert nat is not None, "host_align did not build"
    return p, py, nat, seqs


# (seed size, interval, options, long reads): -r 0 and -r 1, -n 0 and
# -n 1, -w small enough that the repeat buckets fill it
SE_CASES = {
    "r1_n0": (12, 4, dict(report_repeat_hits=1, chains=0), False),
    "r0_n0": (12, 4, dict(report_repeat_hits=0, chains=0), False),
    "r1_n1": (12, 4, dict(report_repeat_hits=1, chains=1), False),
    "r0_n1": (12, 4, dict(report_repeat_hits=0, chains=1), False),
    "s11_i3": (11, 3, dict(report_repeat_hits=1, chains=0), False),
    "v15_long": (12, 4, dict(report_repeat_hits=1, chains=0,
                             max_snp_num=15), True),
}


@pytest.mark.parametrize("case", sorted(SE_CASES))
def test_native_single_end_matches_host_engine(case):
    """Single-end reads (readset 0), with a sync_schedule between some:
    the native aligner leaves what HostEngine leaves, read by read."""
    S, I, kw, long = SE_CASES[case]
    p, py, nat, seqs = _engines(S, I, **{"max_snp_num": 4,
                                         "max_num_hits": 4, **kw})
    rng = random.Random(sorted(SE_CASES).index(case))
    st_py, st_nat = MateState(), MateState()
    fills = aborts = levels = 0
    for k in range(260):
        L = _lengths(S, I, rng, long)
        rd = Read(index=k, readset=0, name=f"r{k}",
                  seq=_bisulfite(_fragment(seqs, rng, L), rng), qual="I" * L)
        bud = _budget(p, len(rd.seq), rng)
        if k % 9 == 4:
            py.sync_schedule(rd, bud, st_py)
            nat.sync_schedule(rd, bud, st_nat)
        else:
            a = py.run_align(rd, bud, st_py)
            b = nat.run_align(rd, bud, st_nat)
            _same_result(a, b)
            fills += int(a.n_hit[0] + a.n_chit[0]) >= p.max_num_hits
            aborts += a.aborted_repeat
            levels += any(a.n_hit[1:] + a.n_chit[1:])
        _same_state(st_py, st_nat)
    # -r 0 aborts at a second best hit before a level can fill; the
    # repeats are shorter than the long reads
    assert levels and (fills or long if p.report_repeat_hits else aborts)
    assert (aborts > 0) is (p.report_repeat_hits == 0)


PE_CASES = {
    "n0": dict(chains=0),
    "n1": dict(chains=1),
    "n0_v6": dict(chains=0, max_snp_num=6),
    "n0_r0": dict(chains=0, report_repeat_hits=0),
}


@pytest.mark.parametrize("case", sorted(PE_CASES))
def test_native_pairs_match_pair_host_engine(case):
    """Pairs (mate 1 readset 1, mate 2 readset 2) through PairHostEngine's
    lockstep and the native one, with one mate of every seventh pair
    filtered (the other aligned SE-style on its mate's state): paired,
    every pairhits bucket in order, both mates' hits and both MateStates
    after every pair.  Under -n 1 every second pair comes with its mates
    swapped (a non-directional library).  -r 0 aborts nothing here: the
    mates are pair-end reads."""
    kw = {"max_snp_num": 4, **PE_CASES[case]}
    p, py, nat, seqs = _engines(12, 4, pairend=1, max_num_hits=4,
                                min_insert=28, max_insert=400, **kw)
    ph = PairHostEngine(py)
    sa, sb = MateState(), MateState()
    rng = random.Random(100 + sorted(PE_CASES).index(case))
    paired = unpaired = full = 0
    for k in range(200):
        ins = rng.randint(30, 300)
        frag = _fragment(seqs, rng, ins)
        la, lb = _lengths(12, 4, rng), _lengths(12, 4, rng)
        ca = _bisulfite(frag, rng)
        ra = Read(index=k, readset=1, name=f"p{k}", seq=ca[:la],
                  qual="I" * min(la, len(ca)))
        rb_seq = _bisulfite(frag, rng).translate(COMP)[::-1][:lb]
        rb = Read(index=k, readset=2, name=f"p{k}", seq=rb_seq,
                  qual="I" * len(rb_seq))
        if min(len(ra.seq), len(rb.seq)) < 12 + 4:
            continue
        if p.chains and k % 2:
            ra.seq, rb.seq = rb.seq, ra.seq
            ra.qual, rb.qual = rb.qual, ra.qual
        ba = _budget(p, len(ra.seq), rng)
        bb = _budget(p, len(rb.seq), rng)
        if k % 7 == 3:
            mate, bud, st_py, st_nat = ((ra, ba, ph.state_a, sa) if k % 2
                                        else (rb, bb, ph.state_b, sb))
            _same_result(py.run_align(mate, bud, st_py),
                         nat.run_align(mate, bud, st_nat))
        else:
            a = ph._run_pair(ra, rb, ba, bb)
            b = nat.run_pair(ra, rb, ba, bb, sa, sb)
            assert a.paired == b.paired
            assert [list(x) for x in a.pairhits] == \
                [list(x) for x in b.pairhits]
            _same_result(a.res_a, b.res_a)
            _same_result(a.res_b, b.res_b)
            paired += a.paired > 0
            unpaired += a.paired == 0
            full += any(len(x) >= p.max_num_hits for x in a.pairhits)
        _same_state(ph.state_a, sa)
        _same_state(ph.state_b, sb)
    assert paired and unpaired and full
