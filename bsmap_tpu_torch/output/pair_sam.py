"""Pair-end output: proper-pair SAM/BSP lines, overlap trimming, unpaired
fallback with mate cross-references (pairs.cpp:222-498)."""

from __future__ import annotations

from ..params import Param, revcomp
from ..readio import Read
from ..reference import PackedGenome, ccgg_seglen
from ..utils import RandR, myrand
from .sam import CHAIN_FLAG, SamFormatter


class PairFormatter:
    """PairAlign's output half.  Owns the pair-level RNG and two per-mate
    SamFormatter instances (for the BSP s_OutHit paths and their stale
    buffers)."""

    def __init__(self, genome: PackedGenome, param: Param,
                 rand_r: RandR | None = None):
        self.genome = genome
        self.param = param
        self.rand_r = rand_r or RandR(1)
        self.fa = SamFormatter(genome, param, self.rand_r)
        self.fb = SamFormatter(genome, param, self.rand_r)
        self._mapseq = bytearray(256)
        self.n_aligned_pairs = 0
        self.n_aligned_a = 0
        self.n_aligned_b = 0

    # -- paired output (pairs.cpp:222-242) -----------------------------------

    def string_align_pair(self, ra: Read, rb: Read, pres):
        """Returns (text, fell_through): fell_through=1 means no unique pair
        under the reporting mode -> unpaired fallback also runs."""
        p = self.param
        for t in range(2 * p.max_snp_num + 1):   # pairs.cpp:229
            cnt = len(pres.pairhits[t])
            if cnt == 0:
                continue
            if cnt == 1:
                return self.out_hit_pair(ra, rb, pres.pairhits[t][0], 1,
                                         pres), 0
            if p.report_repeat_hits == 1:
                j = myrand(ra.index, p.randseed, self.rand_r) % cnt
                return self.out_hit_pair(ra, rb, pres.pairhits[t][j], cnt,
                                         pres), 0
            return "", 1
        return "", 1

    def _xr(self, chrp: int, loc: int, read_len: int) -> str:
        fmt = self.fa
        return fmt._context(chrp, loc, read_len)

    def out_hit_pair(self, ra: Read, rb: Read, pp, n: int, pres) -> str:
        """s_OutHitPair (pairs.cpp:288-424): overlap trimming + two SAM
        lines (or two BSP s_OutHit lines)."""
        p = self.param
        self.n_aligned_pairs += 1
        a_chr, a_loc = pp.a
        b_chr, b_loc = pp.b
        ins = pp.insert
        # adapter run-through removal at output time (pairs.cpp:296-306)
        if ins < len(ra.seq):
            if pp.chain ^ (a_chr % 2):
                a_loc += len(ra.seq) - ins
            ra.seq = ra.seq[:ins]
            if len(ra.qual) > ins:
                ra.qual = ra.qual[:ins]
        if ins < len(rb.seq):
            if (1 - pp.chain) ^ (b_chr % 2):
                b_loc += len(rb.seq) - ins
            rb.seq = rb.seq[:ins]
            if len(rb.qual) > ins:
                rb.qual = rb.qual[:ins]

        if not p.out_sam:
            out = self.fa.s_out_hit(ra, pp.chain, n, pp.na,
                                    (a_chr, a_loc), ins, pres.res_a)
            out += self.fb.s_out_hit(rb, 1 - pp.chain, n, pp.nb,
                                     (b_chr, b_loc), ins, pres.res_b)
            return out

        out = []
        for (rd, chain, chrp, loc, mloc, nm, res) in (
                (ra, pp.chain, a_chr, a_loc, b_loc, pp.na, pres.res_a),
                (rb, 1 - pp.chain, b_chr, b_loc, a_loc, pp.nb, pres.res_b)):
            flag = 0x3
            if n > 1:
                flag |= 0x100
            seq, qual = rd.seq, rd.qual
            if chain ^ (chrp % 2):
                flag |= 0x10
                seg_start = mloc + 1
                pp_insert = -ins
                seq, qual = revcomp(seq), qual[::-1]
            else:
                flag |= 0x20
                seg_start = loc + 1
                pp_insert = ins
            flag |= 0x40 * rd.readset
            name = self.genome.names[chrp // 2]
            line = (f"{rd.name}\t{flag}\t{name}\t{loc + 1}\t255\t"
                    f"{len(seq)}M\t=\t{mloc + 1}\t{pp_insert}\t{seq}\t"
                    f"{qual}\tNM:i:{nm}")
            if p.out_ref:
                line += f"\tXR:Z:{self._xr(chrp, loc, len(seq))}"
            if p.RRBS_flag:
                line += f"\tZP:i:{seg_start}\tZL:i:{ins}"
            line += f"\tZS:Z:{CHAIN_FLAG[chrp % 2]}{CHAIN_FLAG[chain]}\n"
            out.append(line)
        return "".join(out)

    # -- unpaired fallback (pairs.cpp:244-286) -------------------------------

    def string_align_unpair(self, ra: Read, rb: Read, fa: bool, fb: bool,
                            pres) -> str:
        p = self.param
        if p.RRBS_flag:
            if not fa:
                self._fix_short_fragment(ra, pres.res_a)
            if not fb:
                self._fix_short_fragment(rb, pres.res_b)

        ma = mb = -1
        na = nb = 0
        ra_idx = rb_idx = 0
        ha = hb = (0, 0)
        if not fa:
            res = pres.res_a
            ma = 0
            for na in range(res.read_max_snp_num + 1):
                ma = int(res.n_hit[na] + res.n_chit[na])
                if ma > 0:
                    break
            else:
                na = res.read_max_snp_num + 1
            if ma:
                if ma > 1:
                    ra_idx = myrand(ra.index, p.randseed, self.rand_r) % ma
                ha = (res.hits[na][ra_idx] if ra_idx < res.n_hit[na]
                      else res.chits[na][ra_idx - int(res.n_hit[na])])
            na %= (res.read_max_snp_num + 1)
        if not fb:
            res = pres.res_b
            mb = 0
            for nb in range(res.read_max_snp_num + 1):
                mb = int(res.n_hit[nb] + res.n_chit[nb])
                if mb > 0:
                    break
            else:
                nb = res.read_max_snp_num + 1
            if mb:
                if mb > 1:
                    rb_idx = myrand(rb.index, p.randseed, self.rand_r) % mb
                hb = (res.hits[nb][rb_idx] if rb_idx < res.n_hit[nb]
                      else res.chits[nb][rb_idx - int(res.n_hit[nb])])
            nb %= (res.read_max_snp_num + 1)

        chain_a = 0 if ma <= 0 else int(ra_idx >= pres.res_a.n_hit[na])
        chain_b = 0 if mb <= 0 else int(rb_idx >= pres.res_b.n_hit[nb])
        out = self.out_hit_unpair(0, chain_a, chain_b, ma, na, ha, mb, hb,
                                  ra, pres.res_a)
        out += self.out_hit_unpair(1, chain_b, chain_a, mb, nb, hb, ma, ha,
                                   rb, pres.res_b)
        return out

    def _fix_short_fragment(self, rd: Read, res) -> None:
        """Fix_Unpaired_Short_Fragment (align.cpp:768-791): drop RRBS hits in
        invalid fragments, level by level, stopping at the first level that
        retains hits."""
        p = self.param
        if len(rd.seq) >= p.min_insert or res.n_hit is None:
            return
        for lev in range(res.read_max_snp_num + 1):
            for lst in (res.hits[lev], res.chits[lev]):
                k = 0
                while k < len(lst):
                    chrp, loc = lst[k]
                    _, zl = ccgg_seglen(self.genome, p, chrp, loc,
                                        len(rd.seq))
                    if zl < p.min_insert or zl > p.max_insert:
                        del lst[k]
                    else:
                        k += 1
            res.n_hit[lev] = len(res.hits[lev])
            res.n_chit[lev] = len(res.chits[lev])
            if res.n_hit[lev] + res.n_chit[lev] > 0:
                break

    def out_hit_unpair(self, readinpair, chain_a, chain_b, ma, na, ha,
                       mb, hb, rd: Read, res) -> str:
        """s_OutHitUnpair (pairs.cpp:426-498)."""
        p = self.param
        fmt = self.fa if readinpair == 0 else self.fb
        if not p.out_sam:
            return fmt.s_out_hit(rd, chain_a, ma, na, ha, 0, res)

        flag = 1 | 0x40 * rd.readset
        mate_bad = (mb <= 0) or (mb > 1 and p.report_repeat_hits == 0)
        if ma <= 0 or (ma > 1 and p.report_repeat_hits == 0):
            if not p.out_unmap:
                return ""
            if ma < 0:
                flag |= 0x204
            elif ma == 0:
                flag |= 0x004
            else:
                flag |= 0x104
            if mate_bad:
                flag |= 0x008
                return (f"{rd.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                        f"{rd.seq}\t{rd.qual}\n")
            if chain_b ^ (hb[0] % 2):
                flag |= 0x020
            mname = self.genome.names[hb[0] // 2]
            return (f"{rd.name}\t{flag}\t*\t0\t0\t*\t{mname}\t{hb[1] + 1}"
                    f"\t0\t{rd.seq}\t{rd.qual}\n")

        if readinpair == 0:
            self.n_aligned_a += 1
        else:
            self.n_aligned_b += 1
        if ma > 1:
            flag |= 0x100
        chrp, loc = ha
        seq, qual = rd.seq, rd.qual
        if chain_a ^ (chrp % 2):
            flag |= 0x010
            seq, qual = revcomp(seq), qual[::-1]
        name = self.genome.names[chrp // 2]
        if mate_bad:
            flag |= 0x008
            line = (f"{rd.name}\t{flag}\t{name}\t{loc + 1}\t255\t"
                    f"{len(seq)}M\t*\t0\t0\t{seq}\t{qual}\tNM:i:{na}")
        else:
            if chain_b ^ (hb[0] % 2):
                flag |= 0x020
            mname = self.genome.names[hb[0] // 2]
            line = (f"{rd.name}\t{flag}\t{name}\t{loc + 1}\t255\t"
                    f"{len(seq)}M\t{mname}\t{hb[1] + 1}\t0\t{seq}\t{qual}"
                    f"\tNM:i:{na}")
        if p.out_ref:
            line += f"\tXR:Z:{fmt._context(chrp, loc, len(seq))}"
        if p.RRBS_flag:
            zp, zl = ccgg_seglen(self.genome, p, chrp, loc, len(seq))
            line += f"\tZP:i:{zp}\tZL:i:{zl}"
        line += f"\tZS:Z:{CHAIN_FLAG[chrp % 2]}{CHAIN_FLAG[chain_a]}\n"
        return line
