"""Read filter/trim pipeline (C10): adapter trim, quality trim, N filter.

Replicates FilterReads (align.cpp:579-589) and its parts in order:
TrimAdapter (align.cpp:371-425) -> TrimLowQual (align.cpp:59-79) ->
min-length check -> N-count check -> mismatch-budget rescale
(align.cpp:586).  Returns True when the read is filtered out (QC class).
"""

from __future__ import annotations

import numpy as np

from .params import Param, REG_ALPHABET
from .readio import Read


def trim_adapter(read: Read, param: Param) -> int:
    """align.cpp:371-425.  Sets read.raw_len; trims 3' adapter in place.

    Non-RRBS: slide the adapter over positions [seed_size, len-5]; compare up
    to min(adapter_len, 15) chars, abandoning after >4 mismatches; accept when
    compared_chars >= 5*mismatches and compared_chars > 3.
    RRBS: positions [seed_size, len-6]; additionally re-scores the digestion
    site prefix ending at pos with C->T tolerance (and G->A for pair-end).
    """
    seq = read.seq
    read.raw_len = len(seq)
    if not param.adapters:
        return 0
    if param.RRBS_flag:
        site = param.digest_site
        prefix = site[: len(site) - param.digest_pos]
        for adapter in param.adapters:
            for pos in range(param.seed_size, len(seq) - 5):
                m0 = 0
                k = 0
                limit = min(len(adapter), 15, len(seq) - pos)
                while k < limit:
                    if adapter[k] != seq[pos + k]:
                        m0 += 1
                        if m0 > 4:
                            break
                    k += 1
                if k < m0 * 5:
                    continue
                # digestion-site prefix re-match, C->T tolerant (align.cpp:384-387)
                start = pos - len(site) + param.digest_pos
                m = m0
                for t, a in enumerate(prefix):
                    r = seq[start + t]
                    if a != r and not (a == "C" and r == "T"):
                        m += 1
                if k >= m * 5:
                    read.seq = seq[:pos]
                    read.qual = read.qual[:pos]
                    return 1
                if param.pairend:  # G->A tolerant variant (align.cpp:394-405)
                    m = m0
                    for t, a in enumerate(prefix):
                        r = seq[start + t]
                        if a != r and not (a == "G" and r == "A"):
                            m += 1
                    if k >= m * 5:
                        read.seq = seq[:pos]
                        read.qual = read.qual[:pos]
                        return 1
    else:
        for adapter in param.adapters:
            for pos in range(param.seed_size, len(seq) - 4):
                m0 = 0
                k = 0
                limit = min(len(adapter), 15, len(seq) - pos)
                while k < limit:
                    if adapter[k] != seq[pos + k]:
                        m0 += 1
                        if m0 > 4:
                            break
                    k += 1
                if k >= m0 * 5 and k > 3:
                    read.seq = seq[:pos]
                    read.qual = read.qual[:pos]
                    return 1
    return 0


def trim_low_qual(read: Read, param: Param) -> int:
    """align.cpp:59-79.  Returns 1 = keep (possibly trimmed), 0 = QC.

    Side effect: in SAM mode with -z != 33 the whole quality string is
    rescaled to Sanger zero before trimming (align.cpp:63-67) — note this
    rescale only happens when -q > 0 (quirk preserved)."""
    if param.qual_threshold == 0 or len(read.qual) == 1:
        return 1
    zq = param.zero_qual
    if param.out_sam and zq != ord("!"):
        delta = zq - ord("!")
        read.qual = "".join(chr(ord(q) - delta) for q in read.qual)
        zq = ord("!")
    cutoff = zq + param.qual_threshold
    # largest i with qual[i-1] > cutoff
    for i in range(len(read.qual), 0, -1):
        if ord(read.qual[i - 1]) > cutoff:
            if i >= param.seed_size:
                read.qual = read.qual[:i]
                read.seq = read.seq[:i]
                return 1
            return 0
    return 0


def count_ns(seq: str) -> int:
    """align.cpp:48-55: bases that are not ACGTacgt."""
    sb = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
    return int((REG_ALPHABET[sb] == 0).sum())


def filter_read(read: Read, param: Param) -> tuple[bool, int]:
    """FilterReads (align.cpp:579-589).

    Returns (filtered, read_max_snp_num)."""
    trim_adapter(read, param)
    if trim_low_qual(read, param) == 0:
        return True, 0
    if len(read.seq) < param.min_read_size:
        return True, 0
    if count_ns(read.seq) > param.max_ns:
        return True, 0
    budget = param.read_max_snp_num(len(read.seq), read.raw_len)
    return False, budget
