"""Hit selection + SAM/BSP output formatting (align.cpp:610-765).

Read classes (README.txt:112-117): QC (filtered), NM (no hit), UM (unique),
MA (2..max_num_hits-1 equal best), OF (>= max_num_hits).  SAM flags:
QC=0x204, NM=0x4, suppressed-multi=0x104, mapped adds 0x100 for non-unique
and 0x10 when the stored sequence is reverse-complemented for output
(align.cpp:638-665); +0x40*readset identifies the PE mate (align.cpp:636).
ZS:Z: strand tag: first char '+'/'-' for the packed-genome parity (Watson or
Crick reference), second for the read chain (align.cpp:690): ++ BSW, +- BSWC,
-+ BSC, -- BSCC.
"""

from __future__ import annotations

import numpy as np

from ..params import Param, SEGLEN, revcomp
from ..readio import Read
from ..reference import PackedGenome, ccgg_seglen
from ..utils import RandR, myrand

CHAIN_FLAG = "+-"  # param.cpp:234-237


def sam_header(genome: PackedGenome, pg_id: str = "BSMAP_2.6") -> str:
    """main.cpp:344-352,405-413."""
    lines = ["@HD\tVN:1.0"]
    for name, size in zip(genome.names, genome.sizes):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(size)}")
    lines.append(f"@PG\tID:{pg_id}")
    return "\n".join(lines) + "\n"


class SamFormatter:
    """Stateful formatter equivalent to one SingleAlign instance's output
    path (stateful because the reference's _mapseq context buffer and the
    hits[0][0] slot leak across reads; align.h:132, align.cpp:599)."""

    def __init__(self, genome: PackedGenome, param: Param,
                 rand_r: RandR | None = None):
        self.genome = genome
        self.param = param
        self.rand_r = rand_r or RandR(1)
        self._mapseq = bytearray(256)   # stale across reads (align.h:132)
        self.stale_h00 = (0, 0)         # hits[0][0] leak for BSP QC lines
        self.n_aligned = 0
        # lazily unpacked Watson codes for context strings
        self._refcodes = None

    # -- helpers -------------------------------------------------------------

    def _watson_code(self, chr_packed: int, pos: int) -> int:
        """2-bit code at chr-local pos of the Watson packing, reading straight
        through into the concatenated genome like the reference does
        (align.cpp:674-678 pointer arithmetic past bfa[chr].n)."""
        if self._refcodes is None:
            from ..encoding import unpack_u32
            self._refcodes = unpack_u32(self.genome.refcat)
        g = int(self.genome.anchors[chr_packed // 2]) + pos
        if 0 <= g < len(self._refcodes):
            return int(self._refcodes[g])
        return 0

    def _context(self, chr_packed: int, loc: int, read_len: int) -> str:
        """The XR / BSP reference-context string: 2 lowercase flanks + read
        span + 2 lowercase, with the reference's quirk that when loc < 2 the
        leading slots keep their previous (stale) content (align.cpp:670-680:
        ptr advances on `continue`)."""
        un = self.param.useful_nt
        ptr = 0
        for ii in (2, 1):
            if loc >= ii:
                self._mapseq[ptr] = ord(un[self._watson_code(
                    chr_packed, loc - ii)]) + 32
            ptr += 1
        for ii in range(read_len + 2):
            self._mapseq[ptr] = ord(un[self._watson_code(chr_packed,
                                                         loc + ii)])
            ptr += 1
        self._mapseq[ptr - 1] += 32
        self._mapseq[ptr - 2] += 32
        return self._mapseq[:ptr].decode("latin1")

    # -- SE selection + output (StringAlign: align.cpp:610-627) --------------

    def string_align(self, read: Read, res) -> str:
        p = self.param
        if res.filtered:
            if p.report_repeat_hits:
                return self.s_out_hit(read, chain=0, n=-1, nsnps=0,
                                      hit=self.stale_h00, insert_size=0,
                                      res=res)
            return ""
        if len(res.hits[0]) > 0:
            self.stale_h00 = res.hits[0][0]
        ii = 0
        ssum = 0
        for ii in range(res.read_max_snp_num + 1):
            ssum = int(res.n_hit[ii] + res.n_chit[ii])
            if ssum > 0:
                break
        if ssum == 0:
            return self.s_out_hit(read, chain=0, n=0, nsnps=ii,
                                  hit=self.stale_h00, insert_size=0, res=res)
        j = myrand(read.index, p.randseed, self.rand_r) % ssum
        if j < res.n_hit[ii]:
            return self.s_out_hit(read, chain=0, n=ssum, nsnps=ii,
                                  hit=res.hits[ii][j], insert_size=0, res=res)
        return self.s_out_hit(read, chain=1, n=ssum, nsnps=ii,
                              hit=res.chits[ii][j - int(res.n_hit[ii])],
                              insert_size=0, res=res)

    def emit_device(self, read: Read, v) -> str:
        """StringAlign equivalent for a device fast-path result whose hit
        selection already happened on device (same myrand hash).  Under
        -S 0 every found read still consumes one sequential rand_r draw
        (align.cpp:623: myrand fires for sum==1 too); device-handled reads
        are all unique there, so the value is discarded but the stream
        position stays exact for the replayed multi-hit reads."""
        if v.h00_found:
            self.stale_h00 = v.h00
        if not v.found:
            return self.s_out_hit(read, chain=0, n=0, nsnps=v.level,
                                  hit=self.stale_h00, insert_size=0, res=v)
        if self.param.randseed == 0:
            self.rand_r()
        return self.s_out_hit(read, chain=v.chain, n=v.ssum, nsnps=v.level,
                              hit=v.hit, insert_size=0, res=v)

    # -- s_OutHit (align.cpp:631-765) ----------------------------------------

    def s_out_hit(self, read: Read, chain: int, n: int, nsnps: int,
                  hit: tuple[int, int], insert_size: int, res) -> str:
        p = self.param
        if p.out_sam:
            return self._out_sam(read, chain, n, nsnps, hit, res)
        return self._out_bsp(read, chain, n, nsnps, hit, insert_size, res)

    def _out_sam(self, read, chain, n, nsnps, hit, res) -> str:
        p = self.param
        flag = 0x40 * read.readset
        if n < 0:
            if not p.out_unmap:
                return ""
            return (f"{read.name}\t{flag | 0x204}\t*\t0\t0\t*\t*\t0\t0\t"
                    f"{read.seq}\t{read.qual}\n")
        if n == 0:
            if not p.out_unmap:
                return ""
            return (f"{read.name}\t{flag | 0x4}\t*\t0\t0\t*\t*\t0\t0\t"
                    f"{read.seq}\t{read.qual}\n")
        if n > 1 and p.report_repeat_hits == 0:
            if not p.out_unmap:
                return ""
            return (f"{read.name}\t{flag | 0x104}\t*\t0\t0\t*\t*\t0\t0\t"
                    f"{read.seq}\t{read.qual}\n")

        self.n_aligned += 1
        chrp, loc = hit
        flag |= 0x0 if n == 1 else 0x100
        seq, qual = read.seq, read.qual
        if (chain ^ (chrp % 2)) and n:
            flag |= 0x10
            seq, qual = revcomp(seq), qual[::-1]
        name = self.genome.names[chrp // 2]
        out = (f"{read.name}\t{flag}\t{name}\t{loc + 1}\t255\t"
               f"{len(seq)}M\t*\t0\t0\t{seq}\t{qual}\tNM:i:{nsnps}")
        if p.out_ref:
            out += f"\tXR:Z:{self._context(chrp, loc, len(seq))}"
        if p.RRBS_flag:
            zp, zl = ccgg_seglen(self.genome, p, chrp, loc, len(seq))
            out += f"\tZP:i:{zp}\tZL:i:{zl}"
        out += f"\tZS:Z:{CHAIN_FLAG[chrp % 2]}{CHAIN_FLAG[chain]}\n"
        return out

    def _out_bsp(self, read, chain, n, nsnps, hit, insert_size, res) -> str:
        p = self.param
        if not p.out_unmap and (n <= 0 or (n > 1
                                           and p.report_repeat_hits == 0)):
            return ""
        chrp, loc = hit
        seq, qual = read.seq, read.qual
        if (chain ^ (chrp % 2)) and n:
            seq, qual = revcomp(seq), qual[::-1]
        if n < 0:
            cls = "QC"
        elif n == 0:
            cls = "NM"
        elif n == 1:
            cls = "UM"
        elif n >= p.max_num_hits:
            cls = "OF"
        else:
            cls = "MA"
        out = f"{read.name}\t{seq}\t{qual}\t{cls}"
        if ((n > 0 and p.report_repeat_hits == 1)
                or (n == 1 and p.report_repeat_hits == 0)):
            self.n_aligned += 1
            ctx = self._context(chrp, loc, len(seq))
            out += (f"\t{self.genome.names[chrp // 2]}\t{loc + 1}\t"
                    f"{CHAIN_FLAG[chrp % 2]}{CHAIN_FLAG[chain]}\t"
                    f"{insert_size}\t{ctx}\t{nsnps}\t")
            hist = [str(int(res.n_hit[ii] + res.n_chit[ii]))
                    for ii in range(res.read_max_snp_num + 1)]
            out += ":".join(hist)
        return out + "\n"
