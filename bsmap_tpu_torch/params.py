"""Runtime configuration for bsmap_tpu (reference: param.h/param.cpp).

Holds every user-visible option of the reference aligner plus the derived
constants (seed profiles, alphabet code tables) that the rest of the
framework consumes.  Semantics cited as file:line into the reference tree.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Compile-time constants of the reference build (makefile:4, param.h:15-27).
SEGLEN = 16                 # bases per 32-bit word (param.h:4)
FIXELEMENT = 10             # words per read, READ_144 build (param.h:23-25)
FIXSIZE = SEGLEN * FIXELEMENT  # 160 bases of padded read window (align.h:17)
MAXSNPS = 15                # max mismatches supported (param.h:27)
MAXHITS = 1000              # equal-best-hit cap (makefile:4 -DMAXHITS)
MAX_READLEN = (FIXELEMENT - 1) * SEGLEN  # 144 (param.cpp:80)
REF_MARGIN = 400            # guard words either side of refcat (dbseq.h:15)

NT_CODE = "ACGT"            # param.cpp:181-184
REVNT_CODE = "TGCA"         # param.cpp:240-243

# alphabet0: plain A/C/G/T(upper+lower) -> 0/1/2/3, everything else 0
# (param.cpp:141-151).  Used only to interpret the -M argument.
_ALPHABET0 = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(NT_CODE):
    _ALPHABET0[ord(_c)] = _i
    _ALPHABET0[ord(_c.lower())] = _i

# reg_alphabet: 3 for acgtACGT else 0 — "is a real base" mask (param.cpp:153-163)
REG_ALPHABET = np.zeros(256, dtype=np.uint8)
for _c in "ACGTacgt":
    REG_ALPHABET[ord(_c)] = 3

# rev_char: complement base chars preserving case, unknown -> 'N'
# (param.cpp:166-177)
REV_CHAR = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip("ACGTacgt", "TGCAtgca"):
    REV_CHAR[ord(_a)] = ord(_b)

# Translation table for reverse-complementing python strings quickly.
_REV_TRANS = bytes(REV_CHAR).decode("latin1")
REV_TRANS = str.maketrans(
    "".join(chr(i) for i in range(256)), _REV_TRANS
)


def revcomp(seq: str) -> str:
    """Reverse-complement with the reference's rev_char table (param.cpp:246-249)."""
    return seq.translate(REV_TRANS)[::-1]


@dataclasses.dataclass
class SeedProfile:
    """Offset profile of one seed segment at one interval phase (param.h:39-44)."""

    a: int   # offset of the probed seed start within the read


class Param:
    """All runtime options + derived tables (param.cpp:6-83 defaults)."""

    def __init__(self) -> None:
        self.num_procs = 8
        self.chains = 0            # -n: 0 = forward strands only (param.cpp:78)
        self.max_ns = 5            # -f (param.cpp:33)
        self.trim_lowQ = 0
        self.zero_qual = ord("!")  # -z (param.cpp:36)
        self.qual_threshold = 0    # -q (param.cpp:37)
        self.default_qual = 40     # synthetic FASTA quality (param.cpp:38)
        self.min_insert = 28       # -m (param.cpp:40)
        self.max_insert = 500      # -x (param.cpp:41)
        self.seed_size = 16        # -s (param.cpp:44)
        self.max_snp_num = 2       # -v (param.cpp:49)
        self.max_num_hits = MAXHITS  # -w (param.cpp:50)
        self.min_read_size = self.seed_size
        self.adapters: list[str] = []   # -A
        self.report_repeat_hits = 1     # -r (param.cpp:56)
        self.out_sam = 0           # 0 BSP, 1 SAM, 2 BAM (main.cpp:293-296)
        self.read_start = 1        # -B (param.cpp:69)
        self.read_end = 0xFFFFFFFF  # -E (param.cpp:70)
        self.out_ref = 0           # -R
        self.out_unmap = 0         # -u
        self.RRBS_flag = 0         # -D given?
        self.index_interval = 4    # -I (param.cpp:76)
        self.randseed = 0          # -S (param.cpp:77)
        self.pairend = 0
        self.max_readlen = MAX_READLEN  # -L (param.cpp:80)
        self.digest_site = ""      # e.g. "CCGG" after '-' removal
        self.digest_pos = 0        # position of '-' marker (param.cpp:98-102)
        self.max_seedseg_num = MAX_READLEN // self.seed_size  # dbseq.cpp:217
        self.total_ref_seq = 0
        # -M dependent tables, set by set_align (param.cpp:187-231)
        self.read_nt = "T"
        self.ref_nt = "C"
        self.set_align("T", "C")
        self.profile: list[list[SeedProfile]] | None = None

    # ---- option setters with reference side-effects -------------------------

    def set_seed_size(self, n: int) -> None:
        """-s handler (param.cpp:108-119)."""
        self.seed_size = n
        self.min_read_size = n
        self.max_seedseg_num = MAX_READLEN // n

    def set_digestion_site(self, site: str) -> None:
        """-D handler: RRBS mode, forces seed 12 / interval 1 (param.cpp:95-106)."""
        pos = site.find("-")
        if pos < 0:
            raise ValueError(
                "Digestion position not marked, use '-' to mark. example: 'C-CGG'"
            )
        self.digest_pos = pos
        self.digest_site = site[:pos] + site[pos + 1:]
        self.RRBS_flag = 1
        self.index_interval = 1
        self.set_seed_size(12)

    def set_align(self, readnt: str, refnt: str) -> None:
        """-M handler: remap the 2-bit alphabet so that ref_nt encodes as 01
        and read_nt as 11 (param.cpp:187-231).  Default -M TC is the identity
        A=0,C=1,G=2,T=3."""
        readnt, refnt = readnt.upper(), refnt.upper()
        if REG_ALPHABET[ord(readnt)] == 0 or REG_ALPHABET[ord(refnt)] == 0:
            raise ValueError("Unknown nucleotide.")
        if readnt == refnt:
            raise ValueError(
                "Must specify different nucleotides for additional alignment."
            )
        self.read_nt, self.ref_nt = readnt, refnt
        bit_nt = [100, 100, 100, 100]
        bit_nt[_ALPHABET0[ord(readnt)]] = 3
        bit_nt[_ALPHABET0[ord(refnt)]] = 1
        # remaining two letters get codes 0 then 2 in A,C,G,T order
        # (param.cpp:199-206)
        tmp = 0
        for i, c in enumerate(NT_CODE):
            if c != refnt and c != readnt:
                bit_nt[i] = tmp
                tmp = 2
        self.bit_nt = bit_nt

        # alphabet: every byte -> bit_nt[0] except c/g/t (param.cpp:210-213)
        alphabet = np.full(256, bit_nt[0], dtype=np.uint8)
        for ch, idx in (("c", 1), ("g", 2), ("t", 3)):
            alphabet[ord(ch)] = bit_nt[idx]
            alphabet[ord(ch.upper())] = bit_nt[idx]
        self.alphabet = alphabet

        # rev_alphabet: complement codes; unknown -> bit_nt[3] (param.cpp:215-218)
        rev_alphabet = np.full(256, bit_nt[3], dtype=np.uint8)
        for ch, idx in (("c", 2), ("g", 1), ("t", 0)):
            rev_alphabet[ord(ch)] = bit_nt[idx]
            rev_alphabet[ord(ch.upper())] = bit_nt[idx]
        self.rev_alphabet = rev_alphabet

        # useful_nt: code -> display char (param.cpp:220-221); also the char
        # set accepted by the unmasked-region scanner (dbseq.cpp:123)
        useful = list("ACGTacgt")
        for i in range(4):
            useful[bit_nt[i]] = NT_CODE[i]
            useful[bit_nt[i] + 4] = NT_CODE[i].lower()
        self.useful_nt = "".join(useful)
        self.nx_nt = "NXnx"

    def init_mapping(self) -> None:
        """Build per-(segment, interval-phase) seed offset profiles
        (param.cpp:85-93): profile[j][i].a = ceil((j*seed+i)/I)*I."""
        I, S = self.index_interval, self.seed_size
        self.profile = [
            [SeedProfile(a=((j * S + i + I - 1) // I) * I) for i in range(I)]
            for j in range(MAXSNPS + 1)
        ]

    # ---- derived helpers ----------------------------------------------------

    @property
    def total_kmers(self) -> int:
        return 3 ** self.seed_size

    def read_max_snp_num(self, trimmed_len: int, raw_len: int) -> int:
        """Mismatch budget rescaled after trimming (align.cpp:586)."""
        return (self.max_snp_num + 1) * (trimmed_len - 1) // raw_len

    def seedseg_num(self, read_len: int, budget: int) -> int:
        """Number of non-overlapping seed segments (align.cpp:440)."""
        return min(
            (read_len - self.index_interval + 1) // self.seed_size, budget + 1
        )
