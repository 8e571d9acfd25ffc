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


ADAPTER = "AGATCGGAAGAGC"
# chain mode -> (chains, the mates whose blocks sync under it)
SYNC_MODES = {"f": (0, (1,)), "r": (0, (2,)), "b": (1, (1, 2))}
SYNC_CASES = ("empty", "short_newest", "replayed_offset", "stale_start",
              "device_offsets")


def _trimmed_pair_blocks(p: Param, seqs, tmp_path, n: int = 300,
                         R: int = 76):
    """Both mates' ReadBlocks of ``n`` pairs trimmed as under ``-A
    AGATCGGAAGAGC -q 2`` (native FilterReads, in place): inserts of 6-200
    read into the adapter, Q2 (``#``) tails on one mate in three.
    FilterReads keeps no read shorter than the seed, so every ninth live
    mate's record is then cut to fewer bases by hand: the live mates run
    from below the seed size to the full ``R``.  Returns (blocks by
    readset, live_pos)."""
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine.device_engine import filter_block
    rng = random.Random(77)
    lines: dict[int, list[str]] = {1: [], 2: []}
    for k in range(n):
        ins = rng.randint(6, 30) if rng.random() < 0.4 else \
            rng.randint(30, 200)
        frag = _fragment(seqs, rng, ins)
        mates = (_bisulfite(frag, rng),
                 _bisulfite(frag, rng).translate(COMP)[::-1])
        for rs, s in zip((1, 2), mates):
            s = (s + ADAPTER + "".join(rng.choice("ACGT")
                                       for _ in range(R)))[:R]
            q = "I" * R
            if rng.random() < 0.34:
                cut = rng.randint(4, R)
                q = q[:cut] + "#" * (R - cut)
            lines[rs] += [f"@p{k}/{rs}", s, "+", q]
    lib = native.get_lib()
    assert lib is not None, "bsmap_native did not build"
    blocks, live = {}, np.ones(n, dtype=bool)
    for rs in (1, 2):
        path = tmp_path / f"m{rs}.fq"
        path.write_text("\n".join(lines[rs]) + "\n")
        stream = BlockReadStream(str(path), p, rs, lib)
        blk = stream.next_block(n)
        stream.close()
        info = filter_block(p, blk)
        live &= info[:, 0] == 0
        blocks[rs] = blk
    live_pos = np.nonzero(live)[0]
    for rs in (1, 2):
        for i in live_pos[rs::9]:
            blocks[rs].rec[i, 3] = rng.randint(p.index_interval,
                                               p.seed_size - 1)
    return blocks, live_pos


def _spans(rng: random.Random, lens: np.ndarray, case: str, S: int):
    """(lo, hi) spans in batch order, as the engines sync them between
    host reads; ``short_newest``: each ends on a read shorter than an
    earlier one of its span, so the fill walks back over several reads."""
    n = len(lens)
    if case == "empty":
        return [(t, t) for t in rng.sample(range(n + 1), 20)]
    if case == "short_newest":
        out = []
        for hi in range(2, n + 1):
            lo = max(0, hi - rng.randint(2, 12))
            if lens[hi - 1] < lens[lo:hi].max() and (
                    lens[hi - 1] < S or rng.random() < 0.3):
                out.append((lo, hi))
        return out
    out, cursor = [], 0
    while cursor < n:
        hi = min(n, cursor + rng.choice([0, 1, 2, 5, 20, 60]))
        out.append((cursor, hi))
        cursor = hi + 1
    return out


@pytest.mark.parametrize("case", SYNC_CASES)
@pytest.mark.parametrize("mode", sorted(SYNC_MODES))
def test_native_sync_span_matches_python_sync(mode, case, tmp_path):
    """``NativeHost.sync_span`` on trimmed pair-end blocks against the
    Python path it replaces (``sync_state_python``: ``fill_seed_buffers``
    over Read objects, then ``HostEngine.sync_schedule``), span by span
    with the state carried on: both seed buffers and both start offsets
    exactly."""
    from bsmap_tpu_torch.engine.device_engine import (BlockReads,
                                                      sync_state_python)
    chains, mates = SYNC_MODES[mode]
    S, I = 12, 4
    p, py, nat, seqs = _engines(
        S, I, pairend=1, chains=chains, max_snp_num=4,
        adapters=[ADAPTER], qual_threshold=2)
    blocks, live_pos = _trimmed_pair_blocks(p, seqs, tmp_path)
    rng = random.Random(SYNC_CASES.index(case) * 10 + len(mode) + chains)
    walked = offsets_kept = n_spans = 0
    for rs in mates:
        blk = blocks[rs]
        lens = blk.rec[live_pos, 3].astype(np.int64)
        assert lens.min() < S and lens.max() == 76
        reads = BlockReads(blk, live_pos)
        n = len(lens)
        replay = np.array([rng.random() < 0.05 for _ in range(n)])
        soff = coff = None
        if case == "device_offsets":
            soff = np.array([rng.randrange(S) for _ in range(n)], np.int32)
            coff = np.array([rng.randrange(S) for _ in range(n)], np.int32)
        st_py, st_nat = MateState(), MateState()
        if case == "stale_start":
            for st in (st_py, st_nat):
                st.seed_buf[:] = np.arange(MateState.SEEDBUF) * 7919 % 3 ** S
                st.cseed_buf[:] = np.arange(MateState.SEEDBUF) * 104729 % 3 ** S
                st.seed_start_offset, st.cseed_start_offset = 5, 9
        for lo, hi in _spans(rng, lens, case, S):
            rf = replay
            if case == "replayed_offset":
                nz = np.nonzero((lens[lo:hi] - I + 1) % S > 0)[0]
                if len(nz) == 0:
                    continue
                rf = replay.copy()
                rf[lo + nz[-1]] = True
            before = (st_nat.seed_start_offset, st_nat.cseed_start_offset)
            assert nat.sync_span(reads, lo, hi, lens, rf, soff, coff, mode,
                                 st_nat)
            if hi > lo:
                sync_state_python(p, py, st_py, reads, lo, hi, soff, coff,
                                  lens, rf, mode)
                walked += lens[hi - 1] < lens[lo:hi].max()
            _same_state(st_py, st_nat)
            n_spans += 1
            offsets_kept += before == (st_nat.seed_start_offset,
                                       st_nat.cseed_start_offset)
    if case == "empty":
        assert not walked
        _same_state(st_nat, MateState())
    else:
        assert walked
    if case == "replayed_offset":
        # a replayed last offset read leaves the offsets as they were
        assert offsets_kept == n_spans
