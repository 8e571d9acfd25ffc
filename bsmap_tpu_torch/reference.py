"""Reference-genome pipeline: FASTA -> packed 2-bit Watson/Crick arrays.

Replicates the reference's genome representation (dbseq.cpp:18-282) as flat
numpy arrays ready for device upload:

  * per input sequence: Watson 2-bit packed words and the reverse-complement
    (Crick) packing of the *padded* sequence (dbseq.cpp:58-111);
  * ``refcat``/``crefcat``: all sequences concatenated with REF_MARGIN guard
    words on both ends plus per-sequence anchor offsets (dbseq.cpp:252-273);
  * unmasked-region blocks (runs of ACGTacgt >= 30bp, terminated by N/X) for
    Watson and mirrored Crick coordinates (dbseq.cpp:114-142);
  * RRBS digestion-site tables when enabled (dbseq.cpp:144-211).

Coordinate conventions (must match exactly, SURVEY.md section 8):
  * a sequence of length L packs into n = ceil(L/16)+2 words ('N'-padded);
  * ``rc_offset`` = n*16; Crick position p <-> Watson position rc_offset-1-p;
  * global ("int") coordinate of (chr, loc) = anchors[chr] + loc where
    anchors[0] = REF_MARGIN*16 (dbseq.cpp:253-255, hit2int dbseq.cpp:570).
"""

from __future__ import annotations

import dataclasses
import io
import os

import numpy as np

from .encoding import pack_codes_u32
from .params import Param, REF_MARGIN, SEGLEN

MIN_BLOCK_LEN = 30  # dbseq.cpp:127


def parse_fasta(path_or_handle) -> list[tuple[str, str]]:
    """Stream a multi-FASTA exactly like LoadNextSeq (dbseq.cpp:18-54):
    the sequence name is the first whitespace token after '>'; sequence
    lines are concatenated with all whitespace removed."""
    if isinstance(path_or_handle, (str, os.PathLike)):
        fh = open(path_or_handle, "r")
        close = True
    else:
        fh, close = path_or_handle, False
    out: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    try:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif name is not None:
                # fin>>s reads whitespace-separated tokens; interior spaces
                # in a sequence line are dropped just like the reference.
                chunks.extend(line.split())
    finally:
        if close:
            fh.close()
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


@dataclasses.dataclass
class PackedGenome:
    """Device-ready packed genome (the RefSeq analogue)."""

    names: list[str]            # one per input sequence (Watson title)
    sizes: np.ndarray           # (n_chr,) int64 — original lengths
    n_words: np.ndarray         # (n_chr,) int64 — padded words per sequence
    rc_offsets: np.ndarray      # (n_chr,) int64 — n_words*16
    anchors: np.ndarray         # (n_chr+1,) int64 — global base offsets
    refcat: np.ndarray          # (total_words,) uint32 Watson concatenation
    crefcat: np.ndarray         # (total_words,) uint32 Crick concatenation
    # blocks: structured as parallel arrays sorted by (id, begin)
    # (dbseq.cpp:213,249). id = 2*chr for Watson, 2*chr+1 for Crick.
    block_id: np.ndarray        # (n_blocks,) int64
    block_begin: np.ndarray     # (n_blocks,) int64
    block_end: np.ndarray       # (n_blocks,) int64
    # RRBS tables (empty unless param.RRBS_flag)
    ccgg_sites: list[np.ndarray] | None = None      # per chr, Watson coords
    # ccgg_index[j][2c] = Watson seed coords, [j][2c+1] = Crick seed coords
    ccgg_index: list[list[np.ndarray]] | None = None

    @property
    def n_chr(self) -> int:
        return len(self.names)

    @property
    def sum_length(self) -> int:
        return int(self.sizes.sum())

    def chr_of_global(self, p) -> np.ndarray:
        """int2hit chromosome lookup (dbseq.cpp:585-595): the largest chr c
        with anchors[c] <= p, clamped to [0, n_chr-1]."""
        idx = np.searchsorted(self.anchors[: self.n_chr], p, side="right") - 1
        return np.clip(idx, 0, self.n_chr - 1)

    def codes_window(self, chr_idx: int, start: int, length: int,
                     crick: bool = False) -> np.ndarray:
        """Unpack `length` 2-bit codes starting at chr-local position `start`
        (may extend into pads/margins; out-of-array reads are zeros)."""
        cat = self.crefcat if crick else self.refcat
        g0 = int(self.anchors[chr_idx]) + int(start)
        w0, w1 = g0 // SEGLEN, (g0 + length - 1) // SEGLEN + 1
        words = cat[max(w0, 0): w1]
        from .encoding import unpack_u32
        codes = unpack_u32(words)
        off = g0 - max(w0, 0) * SEGLEN
        return codes[off: off + length]


def _find_blocks(seq_bytes: np.ndarray, length: int, total_len: int,
                 chr_idx: int, param: Param):
    """UnmaskRegion (dbseq.cpp:114-142).

    Scans the padded char sequence: a block starts at the next ACGTacgt char
    and ends at the next N/X/n/x (other IUPAC letters do NOT terminate a
    block — they encode as code bit_nt[0]).  Blocks < 30bp are dropped.  The
    <5bp-gap merge in the reference is dead code (the last pushed block is
    always the Crick mirror, so its id never matches: dbseq.cpp:128-130).
    Every kept Watson block [b,e) also yields the mirrored Crick block
    [total_len-e, total_len-b) with id 2*chr+1 (dbseq.cpp:134-136).
    """
    useful = np.frombuffer(param.useful_nt.encode(), dtype=np.uint8)
    nx = np.frombuffer(param.nx_nt.encode(), dtype=np.uint8)
    is_useful = np.isin(seq_bytes, useful)
    is_nx = np.isin(seq_bytes, nx)
    u_pos = np.flatnonzero(is_useful)
    x_pos = np.flatnonzero(is_nx)
    blocks = []
    end = 0
    while end < length:
        i = np.searchsorted(u_pos, end)
        if i == len(u_pos):
            break
        begin = int(u_pos[i])
        if begin > length:
            break
        j = np.searchsorted(x_pos, begin)
        e = int(x_pos[j]) if j < len(x_pos) else length
        e = e if e <= length else length  # dbseq.cpp:126
        if e - begin >= MIN_BLOCK_LEN:
            blocks.append((2 * chr_idx, begin, e))
            blocks.append((2 * chr_idx + 1, total_len - e, total_len - begin))
        end = e if e > end else end + 1  # e==end cannot happen (begin>=end)
    return blocks


def _find_ccgg(seq_upper: str, length: int, size: int, rc_offset: int,
               param: Param):
    """find_CCGG (dbseq.cpp:144-211): digestion sites and the RRBS seed
    positions derived from them.

    Returns (sites, bsw_lists, bsc_lists) where bsw_lists[j] are Watson seed
    coords (site + j*seed) for sites whose *right* neighbour is within
    max_insert, and bsc_lists[j] are Crick coords (rc_offset - seed - wloc)
    for sites whose *left* neighbour is within max_insert.
    """
    S = param.seed_size
    site_str = param.digest_site
    tmp_offset = rc_offset - S
    tmp_max = size - S
    sites = []
    pos = seq_upper.find(site_str)
    while 0 <= pos < length:
        sites.append(pos + param.digest_pos)
        pos = seq_upper.find(site_str, pos + 1)
    sites_arr = np.asarray(sites, dtype=np.int64)
    nseg = param.max_seedseg_num
    bsw = [[] for _ in range(nseg)]
    bsc = [[] for _ in range(nseg)]
    if len(sites) > 1:
        for k in range(len(sites) - 1):
            if sites[k + 1] - sites[k] <= param.max_insert:
                loc = sites[k]
                for j in range(nseg):
                    if loc > tmp_max:
                        break
                    bsw[j].append(loc)
                    loc += S
        tail = len(site_str) - 2 * param.digest_pos
        for k in range(1, len(sites)):
            if sites[k] - sites[k - 1] <= param.max_insert:
                loc = sites[k] + tail - S
                for j in range(nseg):
                    if loc < 0:
                        break
                    bsc[j].append(tmp_offset - loc)
                    loc -= S
    bsw_arr = [np.asarray(b, dtype=np.int64) for b in bsw]
    bsc_arr = [np.asarray(b, dtype=np.int64) for b in bsc]
    return sites_arr, bsw_arr, bsc_arr


def load_genome(path_or_handle, param: Param) -> PackedGenome:
    """Run_ConvertBinseq equivalent (dbseq.cpp:215-282)."""
    seqs = parse_fasta(path_or_handle)
    names, sizes, n_words_l, rc_offsets = [], [], [], []
    watson_words, crick_words = [], []
    blocks: list[tuple[int, int, int]] = []
    ccgg_sites: list[np.ndarray] = []
    nseg = param.max_seedseg_num
    ccgg_index: list[list[np.ndarray]] = [[] for _ in range(nseg)]

    for chr_idx, (name, seq) in enumerate(seqs):
        length = len(seq)
        n = (length + SEGLEN - 1) // SEGLEN + 2   # dbseq.cpp:60
        total_len = n * SEGLEN
        padded = seq + "N" * (total_len - length)
        sb = np.frombuffer(padded.encode("latin1"), dtype=np.uint8)
        wcodes = param.alphabet[sb]
        # Crick: rev_alphabet over the reversed padded chars (dbseq.cpp:85-111)
        ccodes = param.rev_alphabet[sb[::-1]]
        names.append(name)
        sizes.append(length)
        n_words_l.append(n)
        rc_offsets.append(total_len)
        watson_words.append(pack_codes_u32(wcodes, n))
        crick_words.append(pack_codes_u32(ccodes, n))
        blocks.extend(_find_blocks(sb, length, total_len, chr_idx, param))
        if param.RRBS_flag:
            sites, bsw, bsc = _find_ccgg(padded.upper(), length, length,
                                         total_len, param)
            ccgg_sites.append(sites)
            for j in range(nseg):
                ccgg_index[j].append(bsw[j])
                ccgg_index[j].append(bsc[j])

    n_chr = len(names)
    n_words = np.asarray(n_words_l, dtype=np.int64)
    total_words = int(n_words.sum()) + 2 * REF_MARGIN
    anchors = np.zeros(n_chr + 1, dtype=np.int64)
    anchors[0] = REF_MARGIN * SEGLEN
    np.cumsum(n_words * SEGLEN, out=anchors[1:])
    anchors[1:] += REF_MARGIN * SEGLEN

    refcat = np.zeros(total_words, dtype=np.uint32)
    crefcat = np.zeros(total_words, dtype=np.uint32)
    w = REF_MARGIN
    for ww, cw in zip(watson_words, crick_words):
        refcat[w: w + len(ww)] = ww
        crefcat[w: w + len(cw)] = cw
        w += len(ww)

    blocks.sort(key=lambda b: (b[0], b[1]))  # BlockComp (dbseq.cpp:213)
    block_arr = (np.asarray(blocks, dtype=np.int64).reshape(-1, 3)
                 if blocks else np.zeros((0, 3), dtype=np.int64))
    return PackedGenome(
        names=names,
        sizes=np.asarray(sizes, dtype=np.int64),
        n_words=n_words,
        rc_offsets=np.asarray(rc_offsets, dtype=np.int64),
        anchors=anchors,
        refcat=refcat,
        crefcat=crefcat,
        block_id=block_arr[:, 0],
        block_begin=block_arr[:, 1],
        block_end=block_arr[:, 2],
        ccgg_sites=ccgg_sites if param.RRBS_flag else None,
        ccgg_index=ccgg_index if param.RRBS_flag else None,
    )


def genome_cache_key(fasta_path: str, param: Param) -> str:
    import hashlib
    st = os.stat(fasta_path)
    h = hashlib.sha256()
    h.update(f"{os.path.abspath(fasta_path)}:{st.st_size}:{st.st_mtime_ns}:"
             f"M{param.read_nt}{param.ref_nt}".encode())
    return h.hexdigest()[:24]


def save_genome(path: str, g: PackedGenome) -> None:
    """Persist the packed genome (uncompressed .npz: memory-mappable, so
    N local -p workers share one page-cached copy).  WGBS only — RRBS runs
    rebuild their digestion tables from FASTA."""
    np.savez(path, names="\n".join(g.names), sizes=g.sizes,
             n_words=g.n_words, rc_offsets=g.rc_offsets, anchors=g.anchors,
             refcat=g.refcat, crefcat=g.crefcat, block_id=g.block_id,
             block_begin=g.block_begin, block_end=g.block_end)


def load_genome_npz(path: str, mmap: bool = True) -> PackedGenome:
    if mmap:
        from .index import _mmap_npz
        z = _mmap_npz(path)
        names = str(np.load(path)["names"])
    else:
        z = np.load(path)
        names = str(z["names"])
    return PackedGenome(
        names=names.split("\n"), sizes=np.asarray(z["sizes"]),
        n_words=np.asarray(z["n_words"]),
        rc_offsets=np.asarray(z["rc_offsets"]),
        anchors=np.asarray(z["anchors"]), refcat=z["refcat"],
        crefcat=z["crefcat"], block_id=np.asarray(z["block_id"]),
        block_begin=np.asarray(z["block_begin"]),
        block_end=np.asarray(z["block_end"]),
        ccgg_sites=None, ccgg_index=None)


def genome_cache_path(fasta_path: str, param: Param,
                      cache_dir: str) -> str | None:
    """Where ``load_genome_cached`` keeps the packed genome of
    ``fasta_path`` in ``cache_dir`` (made if missing); None under RRBS,
    whose runs rebuild their digestion tables from FASTA."""
    if param.RRBS_flag:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir,
                        f"gen_{genome_cache_key(fasta_path, param)}.npz")


def load_genome_cached(fasta_path: str, param: Param,
                       cache_dir: str, log=print) -> PackedGenome:
    """load_genome through an on-disk packed cache (the reference re-packs
    the FASTA on every run, main.cpp:457-464; at human scale that is
    minutes of wall per process)."""
    path = genome_cache_path(fasta_path, param, cache_dir)
    if path is None:
        return load_genome(fasta_path, param)
    if os.path.exists(path):
        try:
            return load_genome_npz(path)
        except Exception:
            pass
    g = load_genome(fasta_path, param)
    try:
        save_genome(path, g)
    except Exception:
        pass
    return g


def ccgg_seglen(genome: PackedGenome, param: Param, chr_packed: int,
                pos: int, readlen: int) -> tuple[int, int]:
    """CCGG_seglen (dbseq.cpp:541-567): locate the digestion fragment
    containing Watson position `pos`.  Returns (1-based fragment start,
    fragment length).  `chr_packed` is the packed-genome id (chr*2+c)."""
    sites = genome.ccgg_sites[chr_packed // 2]
    nsites = len(sites)
    tail = len(param.digest_site) - 2 * param.digest_pos
    if nsites == 0:
        return (1, 0)
    left, right = 0, nsites - 1
    while left < right - 1:
        mid = (left + right) // 2
        mv = sites[mid]
        if mv == pos:
            left, right = mid, mid + 1
            break
        elif mv < pos:
            left = mid
        else:
            right = mid
    seg_start = int(sites[left])
    # dbseq.cpp:562 advances `right` until the fragment end covers the read;
    # the reference reads one past the array when right hits the end — we
    # stop with the last real site's end instead (documented deviation).
    while right < nsites:
        seg_end = int(sites[right]) + tail
        if seg_end >= pos + readlen:
            break
        right += 1
    else:
        seg_end = int(sites[nsites - 1]) + tail
    if right < nsites:
        seg_end = int(sites[right]) + tail
    return (seg_start + 1, seg_end - seg_start)
