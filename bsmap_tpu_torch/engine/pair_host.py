"""Pair-end alignment engine — exact sequential semantics (pairs.cpp).

Mismatch-level lockstep escalation (pairs.cpp:137-190): at step i both mates
seed-align their i-th cheapest segment, each level-i hit list is sorted by
(chr, loc), and pair combos GetPairs(i,i), then (i,j)/(j,i) for j<i sweep the
sorted lists for same-packed-chr hits with insert in [min,max].  The first
step with any pair wins.  Unpaired mates fall back to SE-style selection with
mate cross-reference flags (pairs.cpp:244-286,426-498).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import MAXSNPS, Param
from ..readio import Read
from ..trim import filter_read
from .host_engine import HostEngine, SEResult, _AlignState


@dataclasses.dataclass
class PairHit:
    chain: int    # 0: a-fwd x b-rc; 1: a-rc x b-fwd (pairs.cpp:60,88)
    na: int
    nb: int
    insert: int
    a: tuple[int, int]   # (chr_packed, watson_loc)
    b: tuple[int, int]


@dataclasses.dataclass
class PairResult:
    paired: int                      # 0 or winning step+1 (pairs.cpp:171)
    pairhits: list[list[PairHit]]    # by total mismatch level na+nb
    res_a: SEResult
    res_b: SEResult
    filtered_a: bool
    filtered_b: bool


def fix_pair_read_name(ra: Read, rb: Read, param: Param) -> None:
    """FixPairReadName (pairs.cpp:535-555): truncate both names to their
    common prefix ending at the last digit within it (SAM mode only)."""
    if not param.out_sam:
        return
    if ra.name == rb.name:
        return
    d = -1
    i0 = min(len(ra.name), len(rb.name))
    i = 0
    while i < i0 and ra.name[i] == rb.name[i]:
        if ra.name[i].isdigit():
            d = i
        i += 1
    if i > 0:
        if d < 0:
            d = i - 1
        ra.name = ra.name[: d + 1]
        rb.name = rb.name[: d + 1]
    else:
        raise ValueError(
            f"Paired reads name not match:\n{ra.name}\n{rb.name}")


class PairHostEngine:
    """PairAlign equivalent: owns one HostEngine used for both mates."""

    def __init__(self, genine_or_engine, index=None, param=None):
        if isinstance(genine_or_engine, HostEngine):
            self.single = genine_or_engine
        else:
            self.single = HostEngine(genine_or_engine, index, param)
        self.param = self.single.param
        from .host_engine import MateState
        self.state_a = MateState()    # PairAlign owns _sa and _sb
        self.state_b = MateState()

    def align_pair(self, ra: Read, rb: Read) -> PairResult:
        """Do_Batch per-pair flow (pairs.cpp:198-217)."""
        p = self.param
        fa, budget_a = filter_read(ra, p)
        fb, budget_b = filter_read(rb, p)
        fix_pair_read_name(ra, rb, p)
        if not fa and not fb:
            return self._run_pair(ra, rb, budget_a, budget_b)
        res_a = (SEResult(filtered=True) if fa
                 else self.single.run_align(ra, budget_a, self.state_a))
        res_b = (SEResult(filtered=True) if fb
                 else self.single.run_align(rb, budget_b, self.state_b))
        return PairResult(paired=0, pairhits=[], res_a=res_a, res_b=res_b,
                          filtered_a=fa, filtered_b=fb)

    def _run_pair(self, ra: Read, rb: Read, budget_a: int,
                  budget_b: int) -> PairResult:
        """PairAlign::RunAlign (pairs.cpp:137-190)."""
        p = self.param
        s = self.single
        La, Lb = len(ra.seq), len(rb.seq)
        seg_a = p.seedseg_num(La, budget_a)
        seg_b = p.seedseg_num(Lb, budget_b)

        conv_a = s._convert(ra, self.state_a)
        conv_b = s._convert(rb, self.state_b)
        st_a, st_b = _AlignState(budget_a), _AlignState(budget_b)
        res_a = SEResult(filtered=False, read_max_snp_num=budget_a,
                         seedseg_num=seg_a,
                         hits=[[] for _ in range(MAXSNPS + 1)],
                         chits=[[] for _ in range(MAXSNPS + 1)])
        res_b = SEResult(filtered=False, read_max_snp_num=budget_b,
                         seedseg_num=seg_b,
                         hits=[[] for _ in range(MAXSNPS + 1)],
                         chits=[[] for _ in range(MAXSNPS + 1)])
        flag_a = bool(p.chains or ra.readset < 2)
        cflag_a = bool(p.chains or ra.readset == 2)
        flag_b = bool(p.chains or rb.readset < 2)
        cflag_b = bool(p.chains or rb.readset == 2)
        sched_a = s._reorder(conv_a[4], conv_a[5], seg_a, La, flag_a,
                             cflag_a, self.state_a)
        sched_b = s._reorder(conv_b[4], conv_b[5], seg_b, Lb, flag_b,
                             cflag_b, self.state_b)

        pairhits: list[list[PairHit]] = [[] for _ in range(2 * MAXSNPS + 1)]
        maxi = max(budget_a, budget_b)
        paired = 0
        for i in range(maxi + 1):
            if i < seg_a:
                s._snp_align(ra, i, sched_a, st_a, res_a, *conv_a[:4],
                             conv_a[4], conv_a[5], flag_a, cflag_a)
            if i < seg_b:
                s._snp_align(rb, i, sched_b, st_b, res_b, *conv_b[:4],
                             conv_b[4], conv_b[5], flag_b, cflag_b)
            if i <= budget_a:
                res_a.hits[i].sort()    # SortHits4PE: (chr, loc) order
                res_a.chits[i].sort()
            if i <= budget_b:
                res_b.hits[i].sort()
                res_b.chits[i].sort()
            n = self._get_pairs(res_a, res_b, i, i, La, Lb, pairhits,
                                budget_a, budget_b)
            for j in range(i):
                n += self._get_pairs(res_a, res_b, i, j, La, Lb, pairhits,
                                     budget_a, budget_b)
                n += self._get_pairs(res_a, res_b, j, i, La, Lb, pairhits,
                                     budget_a, budget_b)
            if n > 0:
                paired = i + 1
                break

        res_a.n_hit = np.array([len(h) for h in res_a.hits], dtype=np.int64)
        res_a.n_chit = np.array([len(h) for h in res_a.chits], dtype=np.int64)
        res_b.n_hit = np.array([len(h) for h in res_b.hits], dtype=np.int64)
        res_b.n_chit = np.array([len(h) for h in res_b.chits], dtype=np.int64)
        return PairResult(paired=paired, pairhits=pairhits, res_a=res_a,
                          res_b=res_b, filtered_a=False, filtered_b=False)

    def _get_pairs(self, res_a, res_b, na, nb, La, Lb, pairhits,
                   budget_a, budget_b) -> int:
        """GetPairs (pairs.cpp:34-135): chr-matched two-pointer sweep."""
        p = self.param
        if na > budget_a or nb > budget_b:
            return 0
        total = na + nb
        found = 0

        def sweep(alist, blist, chain, lena_first):
            nonlocal found
            chra = None
            bstart = bend = 0
            nb_len = len(blist)
            for ah in alist:
                if chra != ah[0]:
                    chra = ah[0]
                    bstart = bend
                    while bstart < nb_len and blist[bstart][0] < chra:
                        bstart += 1
                    bend = bstart
                    while bend < nb_len and blist[bend][0] <= chra:
                        bend += 1
                for j in range(bstart, bend):
                    bh = blist[j]
                    # orientation by packed-genome parity (pairs.cpp:72,99)
                    if chain == 0:
                        if chra & 1:
                            seg_start, seg_end = bh[1], ah[1] + La
                        else:
                            seg_start, seg_end = ah[1], bh[1] + Lb
                    else:
                        if (chra & 1) == 0:
                            seg_start, seg_end = bh[1], ah[1] + La
                        else:
                            seg_start, seg_end = ah[1], bh[1] + Lb
                    insert = seg_end - seg_start
                    if p.min_insert <= insert <= p.max_insert:
                        pairhits[total].append(PairHit(
                            chain=chain, na=na, nb=nb, insert=insert,
                            a=ah, b=bh))
                        if len(pairhits[total]) >= p.max_num_hits:
                            return True
            return False

        if sweep(res_a.hits[na], res_b.chits[nb], 0, True):
            return 1
        if sweep(res_a.chits[na], res_b.hits[nb], 1, False):
            return 1
        # pairhits[total] may hold pairs appended by an earlier combo with
        # the same total at this step (pairs.cpp:133)
        return 1 if pairhits[total] else 0
