"""PyTorch alignment engine: the port of ``bsmap_tpu.engine.device_engine``.

The genome and seed index live on one torch device as int32 tensors
(uint32 tables hold the same bits).  Reads are encoded by the native host
runtime into (n, 2*nw + 4) int32 dispatch rows, aligned in windows of at
most ``DEV_BATCH`` reads by ``kernels.align_program`` (hand-written CUDA
kernels on a GPU, their plain-torch twins on the CPU), and formatted by the
native SAM/BSP formatter.  The orchestration is the JAX engine's:

  * round 1 runs the fixed-schedule program with lean rows at the small
    candidate capacity when every read of the block is eligible
    (``_fx_eligible``), else the exact-schedule program;
  * reads whose candidates overflowed, that did not resolve at the start
    rank, or whose result depends on the schedule re-dispatch once at full
    rank on the exact program, exactly bin-packed by the per-rank candidate
    totals the kernels return;
  * repeat-heavy genomes switch to a stage-1-only totals probe followed by
    packed verify dispatches (probe mode);
  * reads flagged by the kernels (level overflow, dedup exhaustion, -r 0
    ties, -S 0 multi-hits) and stale-schedule reads replay on the exact
    host engine (WGBS: its C++ form, ``native_host.NativeHost``) with a
    reconstructed MateState, so the output is byte-identical to
    ``bsmap_tpu`` and to the reference.

Dispatch windows carry only live rows (the JAX program pads to B rows);
the candidate capacities stay multiples of B so the result rows match the
JAX rows bit for bit.  Dispatches are enqueued in order on the device's
current stream and collected in order.
"""

from __future__ import annotations

import os as _os
from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..encoding import unpack_u32
from ..index import SeedIndex
from ..params import (FIXELEMENT, FIXSIZE, MAXSNPS, Param, REG_ALPHABET,
                      REV_CHAR, SEGLEN)
from ..readio import Read
from ..reference import PackedGenome
from ..trim import filter_read
from ..utils import myrand_hash
from . import kernels
from .host_engine import HostEngine, MateState, SEResult, fill_seed_buffers
from .native_host import NativeHost
# full result row layout: counts, then the X_* extras K4 writes
from .kernels import (N_EXTRAS, X_CHAIN, X_CHRP, X_COFF, X_FOUND, X_FTOT,
                      X_H00C, X_H00F, X_H00W, X_II, X_OK, X_REPLAY,
                      X_RESOLVED, X_SOFF, X_SSUM, X_TOTAL, X_WLOC)

# reads per dispatch window / candidate capacity per read of the window's B
# (the same environment variables as bsmap_tpu, so one test configuration
# drives both packages)
DEV_BATCH = int(_os.environ.get("BSMAP_TPU_DEV_BATCH", 65536))
CANDS_PER_READ = int(_os.environ.get("BSMAP_TPU_CANDS_PER_READ", 2))
CANDS_BIG_PER_READ = int(_os.environ.get("BSMAP_TPU_CANDS_BIG_PER_READ", 16))

# why a read (or pair) went to the exact host engine, each counted once
# under the first that holds: a pair with a filtered mate (pair-end); the
# kernels' replay bit, a pairhits bucket at max_num_hits or a capacity
# overflow; a stale seed schedule; a -r 0 multi-pair past step 0; a -S 0
# sequential draw
HOST_CAUSES = ("filtered_mate", "device", "stale", "multi", "draw")


class EngineUnsupported(RuntimeError):
    """The configuration needs a part of the device program that is not
    ported yet; there is no fallback to another engine."""


def genome_fits(genome) -> bool:
    """Whether the device engines hold ``genome``: per-strand uint32
    coordinates (genomes up to ~4.2 Gb per strand) and fewer than 2^15
    chromosomes."""
    return (int(genome.anchors[-1]) < 2 ** 32 - (FIXSIZE + SEGLEN)
            and genome.n_chr < 1 << 15)


def rc_tuple_of(param) -> tuple:
    """Static 2-bit complement permutation + RC 'N' code for a Param."""
    rc = tuple(int(param.alphabet[REV_CHAR[ord(param.useful_nt[c])]])
               for c in range(4))
    return rc, int(param.rev_alphabet[ord("N")])


def make_cfg(param, W: int, n_chr: int, chains_mode: str, maxseg: int,
             lean: bool = False, nw: int = FIXELEMENT) -> "Cfg":
    """Kernel Cfg from a Param + genome shape facts alone."""
    S, I = param.seed_size, param.index_interval
    P = min(16 * nw - S + 1, maxseg * S + 2 * I)
    rc, rc_n = rc_tuple_of(param)
    return Cfg(S=S, I=I, maxseg=maxseg, chains_mode=chains_mode, P=P,
               max_num_hits=param.max_num_hits,
               report_repeat_hits=param.report_repeat_hits,
               W=W, n_chr=n_chr, lean=lean, rrbs=bool(param.RRBS_flag),
               min_ins=param.min_insert, max_ins=param.max_insert,
               tail=len(param.digest_site) - 2 * param.digest_pos
               if param.RRBS_flag else 0,
               rc=rc, rc_n=rc_n, nw=nw)


class Cfg(NamedTuple):
    """Static configuration of one device program: the fields of
    ``bsmap_tpu``'s Cfg that the unsharded programs read."""

    S: int
    I: int
    maxseg: int            # seed segments per read: min(MAXSNPS, -v) + 1
    chains_mode: str       # 'f' fwd-only, 'r' rc-only, 'b' both (-n 1)
    P: int                 # seed positions in the schedule table
    max_num_hits: int
    report_repeat_hits: int
    W: int                 # words per catcat half
    n_chr: int
    lean: bool = False     # 3-int32 packed rows (SAM fast path) vs full rows
    pe: bool = False       # pair-end enumeration: no progressive early exit
                           # (PairAlign runs every segment, pairs.cpp:163),
                           # no -r 0 abort (align.cpp:210 pairend guard)
    hits_k: int = 0        # also emit up to K compacted hits per read
    rrbs: bool = False     # digestion-site index: tag-partitioned slots,
                           # chr-local entries, SE fragment filter
                           # (align.cpp:175-251, dbseq.cpp:541-567)
    min_ins: int = 0       # PE insert window (-m/-x) of the pair join; the
    max_ins: int = 0       # fragment-length window under rrbs
    tail: int = 0          # RRBS: len(digest_site) - 2*digest_pos
    rc: tuple = (3, 2, 1, 0)   # 2-bit complement permutation (rc_code)
    rc_n: int = 3          # rev_alphabet['N'] code for RC-chain N lanes
    probe: bool = False    # totals-only pre-pass: stage 1 alone, returns
                           # the (B, maxseg) per-rank candidate totals
    fixed: bool = False    # fixed-schedule stage 1 (pigeonhole covering at
                           # offset 0, cheapest segment first)
    nw: int = FIXELEMENT   # packed words per read: 7 for reads <= 112 nt
    shards: int = 0        # region shards of an index-sharded program (the
                           # counterpart of shard_axis; 0 = unsharded): K2
                           # costs come from the global counts `gcnt`, K3
                           # marks corner candidates, merge_shards reduces

    @property
    def nch(self) -> int:
        """Read chains in one dispatch."""
        return 2 if self.chains_mode == "b" else 1

    @property
    def NB(self) -> int:
        """Slots per read: maxseg ranks x nch chains x I phases."""
        return self.maxseg * self.nch * self.I


# lean row bit layout (word 1; word 0 = watson loc), shared with the native
# formatter (bsmap_native.cpp)
BIT_FOUND, BIT_CHAIN, BIT_REPLAY, BIT_OK, BIT_BIG, BIT_MULTI = (
    1, 2, 4, 8, 16, 32)
LEAN_II_SHIFT, LEAN_CHRP_SHIFT = 6, 10
BIT_RESOLVED = 1 << 26

# packed input row: int32 columns
# [qwords (2-bit packed read) | rwords (valid-mask lanes) |
#  len | budget | rand32 | maxrank]
ROW_I32 = 2 * FIXELEMENT + 4
SC_LEN, SC_BUD, SC_RAND, SC_RANK = (2 * FIXELEMENT, 2 * FIXELEMENT + 1,
                                    2 * FIXELEMENT + 2, 2 * FIXELEMENT + 3)


def pack_words_np(codes_or_regs: np.ndarray) -> np.ndarray:
    """(B, FIXSIZE) uint8 -> (B, FIXELEMENT) uint32 words, first base in the
    top bits of each word (dbseq.cpp:71-75 layout)."""
    B = codes_or_regs.shape[0]
    lanes = codes_or_regs.reshape(B, FIXELEMENT, SEGLEN).astype(np.uint32)
    shifts = (np.arange(SEGLEN - 1, -1, -1, dtype=np.uint32) * 2)
    return (lanes << shifts[None, None, :]).sum(axis=-1, dtype=np.uint32)


def _pack_inputs(codes, regs, lens, buds, rand32, maxrank):
    """(B, ROW_I32) int32 dispatch rows from per-base codes/regs."""
    B = len(lens)
    buf = np.empty((B, ROW_I32), dtype=np.int32)
    buf[:, :FIXELEMENT] = pack_words_np(codes).view(np.int32)
    buf[:, FIXELEMENT: 2 * FIXELEMENT] = pack_words_np(regs).view(np.int32)
    buf[:, SC_LEN] = lens
    buf[:, SC_BUD] = buds
    buf[:, SC_RAND] = rand32.astype(np.uint32).view(np.int32)
    buf[:, SC_RANK] = maxrank
    return buf


def _i32(a, dtype=np.int32) -> torch.Tensor:
    """``a`` as ``dtype``, as a contiguous int32 CPU tensor of the same
    bits."""
    arr = np.ascontiguousarray(np.asarray(a).astype(dtype, copy=False))
    if not arr.flags.writeable:          # memory-mapped caches
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32))


def genome_tables(genome: PackedGenome, param: Param) -> dict:
    """The index-free device tables (catcat, anchors, sizes, rcoff, prof_a
    of ``tables_from_numpy``) as CPU int32 tensors."""
    if param.profile is None:
        param.init_mapping()
    I = param.index_interval
    prof_a = [[param.profile[n][i].a for i in range(I)]
              for n in range(MAXSNPS + 1)]
    return {
        "catcat": _i32(np.concatenate([genome.refcat, genome.crefcat]),
                       np.uint32),
        "anchors": _i32(genome.anchors[:genome.n_chr], np.uint32),
        "sizes": _i32(genome.sizes),
        "rcoff": _i32(genome.rc_offsets),
        "prof_a": _i32(prof_a),
    }


# entries the strand and region splits take at a time: their temporaries
# stay some hundred MB whatever the genome's size (at human scale the index
# holds about 1.56G entries)
SPLIT_CHUNK = 1 << 24


def strand_chunks(index: SeedIndex):
    """The WGBS index's entries in bucket order, ``SPLIT_CHUNK`` at a
    time: yields (lo, locs, b0, nb, wend) for locs =
    index.locs[lo: lo + len], where the chunk's entries fall in buckets
    b0, b0 + 1, ... with nb[j] of them in bucket b0 + j, and wend[j] is
    the index position where bucket b0 + j's Watson entries end (each
    bucket's run holds its wcounts[b] Watson entries first, then its
    Crick ones).  ``watson_mask`` marks the Watson entries of a chunk."""
    offs, wc = index.offsets, index.wcounts
    total = int(offs[-1])
    for lo in range(0, total, SPLIT_CHUNK):
        hi = min(lo + SPLIT_CHUNK, total)
        b0 = int(np.searchsorted(offs, lo, side="right")) - 1
        b1 = int(np.searchsorted(offs, hi - 1, side="right")) - 1
        o = np.asarray(offs[b0: b1 + 2], dtype=np.int64)
        nb = np.diff(np.clip(o, lo, hi))
        wend = o[:-1] + np.asarray(wc[b0: b1 + 1], dtype=np.int64)
        yield lo, np.asarray(index.locs[lo: hi]), b0, nb, wend


def watson_mask(lo: int, nb: np.ndarray, wend: np.ndarray) -> np.ndarray:
    """The Watson entries of a ``strand_chunks`` chunk starting at ``lo``."""
    return np.arange(lo, lo + int(nb.sum()), dtype=np.int64) < np.repeat(
        wend, nb)


def tables_from_numpy(genome: PackedGenome, index: SeedIndex,
                      param: Param, device="cpu") -> dict[str, torch.Tensor]:
    """The device tables of ``bsmap_tpu``'s DeviceEngine
    (device_engine.py:1229-1331) as int32 tensors on ``device`` (default
    the CPU); uint32 arrays keep their bits.

      catcat   (2W,)      refcat ++ crefcat, 2-bit packed, 16 bases/word
      anchors  (n_chr,)   global per-strand base offset of each chromosome
      sizes    (n_chr,)   chromosome lengths
      rcoff    (n_chr,)   Crick coordinate offsets (n_words * 16)
      kmer_tab (3^S, 4)   per-bucket [watson_off, total, watson_count,
                          crick_off]
      wlocs    (nw,)      Watson entries, bucket order
      clocs    (nc,)      Crick entries, bucket order
      prof_a   (16, I)    seed profile start positions

    The entries are split by strand ``SPLIT_CHUNK`` at a time
    (``strand_chunks``), each chunk on ``device``, straight into their
    tensors there: the host holds no whole-index temporary beside the
    index itself, and on a card the split runs there.

    Under RRBS (:1239-1286) the index is tag-partitioned instead:

      kmer_tab (3^S, 4)   [raw offset, raw count, 0, 0]
      wlocs    (n,)       chr-local entries ordered by (bucket, tag class
                          2*segment + rc, original position)
      tags     (n,)       their packed chrp | j << 16 | rc << 24 tags
      tag_off  (3^S*J2+1,) class offsets, J2 = 2 * max_seedseg_num
      sites    (ns,)      global (anchor + local) digestion sites, uint32
      site_off (n_chr+1,) each chromosome's range of ``sites``
      clocs    (1,)       unused
    """
    dev = torch.device(device)
    base = {k: v.to(dev) for k, v in genome_tables(genome, param).items()}
    t, one = _i32, np.zeros(1, dtype=np.uint32)
    tk = index.total_kmers
    counts = np.diff(index.offsets)
    if param.RRBS_flag:
        return {**base, **{k: v.to(dev) for k, v in _rrbs_tables(
            genome, index, param, t, one).items()}}
    wc = index.wcounts.astype(np.int64)
    cc = counts - wc
    kmer_tab = np.zeros((tk, 4), dtype=np.int32)
    kmer_tab[:, 1] = counts
    kmer_tab[:, 2] = wc
    np.cumsum(wc[:-1], out=kmer_tab[1:, 0])
    np.cumsum(cc[:-1], out=kmer_tab[1:, 3])
    # each strand's entries, in bucket order (an empty strand: one 0)
    wl = torch.zeros(max(int(wc.sum()), 1), dtype=torch.int32, device=dev)
    cl = torch.zeros(max(int(cc.sum()), 1), dtype=torch.int32, device=dev)
    iw = ic = 0
    for lo, locs, _b0, nb, wend in strand_chunks(index):
        n = len(locs)
        ent = torch.from_numpy(np.array(locs, dtype=np.uint32).view(
            np.int32)).to(dev)
        is_w = torch.arange(lo, lo + n, device=dev) < torch.repeat_interleave(
            torch.from_numpy(wend).to(dev), torch.from_numpy(nb).to(dev),
            output_size=n)
        w, c = ent[is_w], ent[~is_w]
        wl[iw: iw + len(w)] = w
        cl[ic: ic + len(c)] = c
        iw, ic = iw + len(w), ic + len(c)
    return {**base, "kmer_tab": torch.from_numpy(kmer_tab).to(dev),
            "wlocs": wl, "clocs": cl}


def _rrbs_tables(genome: PackedGenome, index: SeedIndex, param: Param, t,
                 one) -> dict[str, torch.Tensor]:
    """The tag-partitioned RRBS tables (device_engine.py:1239-1286): each
    probe enumerates exactly its (segment, strand) class, and within a
    class the original bucket order (the reference's discovery order) is
    kept."""
    tk = index.total_kmers
    counts = np.diff(index.offsets)
    kmer_tab = np.zeros((tk, 4), dtype=np.int32)
    kmer_tab[:, 0] = index.offsets[:-1]
    kmer_tab[:, 1] = counts              # RAW size: schedule cost parity
    J2 = 2 * param.max_seedseg_num
    tag_off = np.zeros(tk * J2 + 1, dtype=np.int32)
    wlocs, tags = one, one
    if len(index.locs):
        tags_u = index.tags.astype(np.uint32)
        cls = (((tags_u >> 16) & 0xFF) * 2
               + ((tags_u >> 24) & 1)).astype(np.int64)
        bucket_id = np.repeat(np.arange(tk, dtype=np.int64), counts)
        order = np.lexsort((np.arange(len(cls)), cls, bucket_id))
        key2 = bucket_id[order] * J2 + cls[order]
        tag_off[1:] = np.cumsum(np.bincount(key2, minlength=tk * J2))
        wlocs, tags = index.locs[order], tags_u[order]
    site_off = np.zeros(genome.n_chr + 1, dtype=np.int32)
    np.cumsum([len(s) for s in genome.ccgg_sites], out=site_off[1:])
    sites = (np.concatenate([s + genome.anchors[c]
                             for c, s in enumerate(genome.ccgg_sites)])
             if site_off[-1] else one)
    return {
        "kmer_tab": torch.from_numpy(kmer_tab),
        "wlocs": t(wlocs, np.uint32),
        "clocs": t(one, np.uint32),
        "tags": t(tags, np.uint32),
        "tag_off": t(tag_off),
        "sites": t(sites, np.uint32),
        "site_off": t(site_off),
    }


class ReplayHost(HostEngine):
    """The exact host engine the device engines replay reads on.  Its
    unpacked genome codes (``refcodes``/``crefcodes``: a byte a base and
    strand, 6.24 GB at human scale, made through some 25 GB of
    temporaries) are made at the first replay that reads them, not when
    the engine is built; a run that replays no read never makes them."""

    def __init__(self, genome: PackedGenome, index: SeedIndex,
                 param: Param):
        # HostEngine.__init__ but the two unpack_u32 calls
        self.genome = genome
        self.index = index
        self.param = param
        if param.profile is None:
            param.init_mapping()
        self.anchors = genome.anchors
        self.n_chr = genome.n_chr
        self.mate_state = MateState()
        self._chr_codes_cache = {}

    def __getattr__(self, name: str):
        if name not in ("refcodes", "crefcodes"):
            raise AttributeError(name)
        codes = unpack_u32(self.genome.refcat if name == "refcodes"
                           else self.genome.crefcat)
        setattr(self, name, codes)
        return codes


def pack_spans(demand, B: int, cands: int, cands_big: int):
    """Exact bin-packing of reads in order: (start, end, capacity) spans of
    at most B reads whose summed per-read candidate demand (each at least
    1) fits ``cands_big``; a span that fits ``cands`` gets the small tier."""
    csum = np.cumsum(np.maximum(np.asarray(demand, dtype=np.int64), 1))
    spans = []
    s = 0
    base = 0
    for k in range(len(csum)):
        if k - s == B or csum[k] - base > cands_big:
            spans.append((s, k))
            s = k
            base = csum[k - 1]
    spans.append((s, len(csum)))
    return [(a, b, cands if csum[b - 1] - (csum[a - 1] if a else 0) <= cands
             else cands_big) for a, b in spans]


class DeviceEngine:
    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param,
                 device: torch.device | str = "cuda"):
        # -S 0 (the reference default): selection draws a sequential glibc
        # rand_r per FOUND read (align.cpp:623-625).  Unique reads are
        # rand-independent (j = draw % 1), so the kernels run with
        # rand32 = 0, the formatter keeps the stream position, and only
        # genuinely multi-hit reads replay on the exact host engine.
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch sees no "
                               "CUDA device")
        self.genome = genome
        self.index = index
        self.param = param
        if param.profile is None:
            param.init_mapping()
        self.host = ReplayHost(genome, index, param)  # exact replay path
        # the replay path's WGBS alignment in C++ (None: the Python engine)
        self.native = NativeHost.create(self.host)
        if not genome_fits(genome):
            raise EngineUnsupported("genome exceeds 32-bit per-strand "
                                    "coordinates")
        self.W = len(genome.refcat)
        self.tables = self._place_tables()
        self.B = DEV_BATCH             # reads per dispatch window
        self._set_tiers(self.B)
        self._probe_ok = True          # False where _dispatch cannot return
                                       # the probe pass's totals
        self.n_replayed = 0
        self.host_causes = dict.fromkeys(HOST_CAUSES, 0)
        self.host_native = 0           # replays the native aligner ran
        # MateState syncs of a device span: one native call, or Python
        self.host_sync_native = self.host_sync_python = 0
        self.n_dispatched = 0
        # full-rank candidate totals the kernels report (X_FTOT), over the
        # reads aligned: their sum, count and maximum
        self.cand_sum = self.cand_reads = self.cand_max = 0
        self._maxseg = min(MAXSNPS, param.max_snp_num) + 1
        self._amax_cache: dict[int, int] = {}
        # chromosome-name table for the native SAM block formatter
        name_bytes = [n.encode("latin1") for n in genome.names]
        self._chrname_buf = np.frombuffer(b"".join(name_bytes), dtype=np.uint8)
        self._chrname_off = np.zeros(len(name_bytes) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in name_bytes], out=self._chrname_off[1:])
        # persistent context buffer for native XR/BSP formatting (the
        # reference's _mapseq is stateful across reads: align.h:132)
        self._mapseq_buf = np.zeros(256, dtype=np.uint8)
        self._anchors_i64 = genome.anchors[: genome.n_chr].astype(np.int64)
        # chr-local digestion sites for the native ZP/ZL tags
        # (dbseq.cpp:541); none outside RRBS
        self._sites_local = np.zeros(1, np.int64)
        self._site_off_l = np.zeros(genome.n_chr + 1, np.int64)
        self._rr_tail = 0
        if param.RRBS_flag and genome.ccgg_sites is not None:
            np.cumsum([len(s) for s in genome.ccgg_sites],
                      out=self._site_off_l[1:])
            if self._site_off_l[-1]:
                self._sites_local = np.concatenate(
                    genome.ccgg_sites).astype(np.int64)
            self._rr_tail = len(param.digest_site) - 2 * param.digest_pos

    def _set_tiers(self, b: int) -> None:
        """Two candidate capacities: a SMALL one for optimistic round-1
        windows and a BIG one for exactly bin-packed re-dispatches.  RRBS
        gets the big one alone: its demand is about 10-20 candidates per
        read even tag-partitioned, so a small round would overflow
        wholesale."""
        mults = sorted({CANDS_PER_READ, max(CANDS_BIG_PER_READ,
                                            CANDS_PER_READ)})
        if self.param.RRBS_flag:
            mults = mults[-1:]
        self.cands_tiers = [m * b for m in mults]
        self.CANDS = self.cands_tiers[0]
        self.CANDS_BIG = self.cands_tiers[-1]
        # probe mode (repeat-heavy genomes, self-tuned): round 1 becomes a
        # stage-1-only totals pre-pass and ALL verify dispatches are exactly
        # bin-packed
        self.probe_mode = False
        self.n_probe = 0
        # progressive-sensitivity start rank: 0 = probe only the cheapest
        # segment first; bumped to maxseg-1 when a first round leaves most
        # reads rank-unresolved
        self.rank_start = 0

    def _place_tables(self) -> dict:
        """The tables of ``tables_from_numpy`` on the engine's device; the
        mesh engines place theirs on their devices instead."""
        return tables_from_numpy(self.genome, self.index, self.param,
                                 device=self.device)

    def _cfg(self, chains_mode: str, lean: bool = False,
             nw: int = FIXELEMENT) -> Cfg:
        return make_cfg(self.param, self.W, self.genome.n_chr, chains_mode,
                        self._maxseg, lean=lean, nw=nw)

    def _chains_mode(self, rsets: np.ndarray) -> str:
        if self.param.chains:
            return "b"
        if (rsets == 2).all():
            return "r"
        if (rsets < 2).all():
            return "f"
        return "b"

    # -- stale-schedule (MateState) detection --------------------------------

    def _probe_amax(self, seedseg: int) -> int:
        """Max over (segment, phase) of profile.a - phase for the last
        segment: bounds how far probe positions reach past seedseg*S."""
        if seedseg not in self._amax_cache:
            p = self.param
            if seedseg <= 0:
                self._amax_cache[seedseg] = 0
            else:
                self._amax_cache[seedseg] = max(
                    p.profile[seedseg - 1][i].a - i
                    for i in range(p.index_interval))
        return self._amax_cache[seedseg]

    def _fx_eligible(self, lens: np.ndarray, budgets: np.ndarray,
                     ncnt: np.ndarray) -> bool:
        """True when EVERY read supports the fixed-schedule fast path:
        full sensitivity (seedseg == budget+1, so the pigeonhole hit set is
        schedule-independent), all offset-0 probes within the fresh seed
        range, and no N (``ncnt``, the reads' non-ACGT bases): an N costs
        no mismatch but a seed over it matches no index entry, so which
        hits a read with one finds depends on where its seeds lie."""
        p = self.param
        if p.RRBS_flag or len(lens) == 0 or np.any(ncnt):
            return False
        S, I = p.seed_size, p.index_interval
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        seedseg = np.clip(np.minimum((lens - I + 1) // S, budgets + 1),
                          0, self._maxseg)
        full_sens = ((lens - I + 1) // S >= budgets + 1) & (seedseg >= 1)
        amax = np.array([self._probe_amax(int(m))
                         for m in range(self._maxseg + 1)], dtype=np.int64)
        return bool((full_sens & (amax[seedseg] <= lens - S)).all())

    def _stale_risk(self, lens: np.ndarray, budgets: np.ndarray) -> np.ndarray:
        """True for reads whose schedule may read stale per-instance state
        (previous reads' seed buffers / start offsets, align.cpp:454-469):
        max_offset == 0, or any probed / cost position can exceed len - S.
        RRBS never reads that state (fixed zero offsets, in-range probes)."""
        p = self.param
        if p.RRBS_flag:
            return np.zeros(len(lens), dtype=bool)
        S, I = p.seed_size, p.index_interval
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        max_off = (lens - I + 1) % S
        seedseg = np.clip(np.minimum((lens - I + 1) // S, budgets + 1),
                          0, self._maxseg)
        amax = np.array([self._probe_amax(int(m))
                         for m in range(self._maxseg + 1)], dtype=np.int32)
        probe_max = amax[seedseg] + max_off
        cost_max = (seedseg - 1) * S + max_off + I - 1
        reach = np.maximum(probe_max, cost_max)
        return (max_off == 0) | (reach > lens - S)

    def _sync_state_span(self, read_of, lo: int, hi: int,
                         dev_soff, dev_coff, lens, replay_flag, mode: str,
                         state=None):
        """Apply the MateState effects of device-handled reads [lo, hi) (batch
        order) before a host replay that may read stale state.  Seed buffers:
        last-writer-wins backward fill; start offsets: last read with
        max_offset > 0 (align.cpp:458-468).  Reads of a ``BlockReads`` sync
        in one native call (``NativeHost.sync_span``) where the native
        aligner loaded and the reads fit its buffers; elsewhere
        ``sync_state_python``."""
        if hi <= lo:
            return
        with obs.span("host.sync", rows=hi - lo, cpu=False):
            st = state if state is not None else self.host.mate_state
            if (self.native is not None and isinstance(read_of, BlockReads)
                    and self.native.sync_span(read_of, lo, hi, lens,
                                              replay_flag, dev_soff,
                                              dev_coff, mode, st)):
                self.host_sync_native += 1
                return
            self.host_sync_python += 1
            obs.instant("host.sync_python", rows=hi - lo)
            sync_state_python(self.param, self.native or self.host, st,
                              read_of, lo, hi, dev_soff, dev_coff, lens,
                              replay_flag, mode)

    # -- batch orchestration -------------------------------------------------

    def _filter_batch(self, batch: list[Read], results):
        """Trim/filter; returns (live indices, budgets) (FilterReads
        align.cpp:579-589)."""
        p = self.param
        live_idx, budgets = [], []
        if not p.adapters and p.qual_threshold == 0:
            for i, rd in enumerate(batch):
                L = len(rd.seq)
                rd.raw_len = L
                if L < p.min_read_size:
                    results[i] = SEResult(filtered=True)
                    continue
                sb = np.frombuffer(rd.seq.encode("latin1"), dtype=np.uint8)
                if int((REG_ALPHABET[sb] == 0).sum()) > p.max_ns:
                    results[i] = SEResult(filtered=True)
                    continue
                live_idx.append(i)
                budgets.append((p.max_snp_num + 1) * (L - 1) // L)
            return live_idx, budgets
        for i, rd in enumerate(batch):
            filtered, budget = filter_read(rd, p)
            if filtered:
                results[i] = SEResult(filtered=True)
            else:
                live_idx.append(i)
                budgets.append(budget)
        return live_idx, budgets

    def _pack_host(self, batch, idxs, budgets):
        """Encode reads into padded fixed-shape numpy arrays."""
        p = self.param
        n = len(idxs)
        codes = np.zeros((n, FIXSIZE), dtype=np.uint8)
        regs = np.zeros((n, FIXSIZE), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        ridx = np.zeros(n, dtype=np.uint64)
        rsets = np.zeros(n, dtype=np.int32)
        buds = np.asarray(budgets, dtype=np.int32)
        seqs = [batch[i].seq for i in idxs]
        if n and len(set(map(len, seqs))) == 1:
            L = len(seqs[0])
            sb = np.frombuffer("".join(seqs).encode("latin1"),
                               dtype=np.uint8).reshape(n, L)
            codes[:, :L] = p.alphabet[sb]
            regs[:, :L] = REG_ALPHABET[sb]
            lens[:] = L
        else:
            for t, s in enumerate(seqs):
                sb = np.frombuffer(s.encode("latin1"), dtype=np.uint8)
                codes[t, :len(sb)] = p.alphabet[sb]
                regs[t, :len(sb)] = REG_ALPHABET[sb]
                lens[t] = len(sb)
        ridx[:] = [batch[i].index for i in idxs]
        rsets[:] = [batch[i].readset for i in idxs]
        return codes, regs, lens, buds, rsets, ridx

    def _dispatch(self, cfg: Cfg, packed: np.ndarray, cands: int | None = None):
        """Enqueue one program on a (m <= B, 2nw+4) window; returns the
        device result tensor (collected later with ``_collect``)."""
        cap = self.CANDS if cands is None else cands
        with obs.span("engine.h2d", nbytes=packed.nbytes, cpu=False):
            rows = torch.from_numpy(packed).to(self.device)
        with obs.span("engine.launch", rows=len(packed), cpu=False):
            return kernels.align_program(cfg, cap, self.tables, rows)

    def _collect(self, outs) -> list[np.ndarray]:
        """The rows of ``outs`` on the host: the copies and the wait for
        the device work queued before them."""
        with obs.span("engine.collect", nbytes=(
                sum(o.nbytes for o in outs) if obs.enabled() else -1)):
            return [o.cpu().numpy() for o in outs]

    def _window_rows(self, rows, sel, ranks=None):
        """Dispatch rows `sel` (live rows only), with the per-read
        enumeration rank written into the maxrank column."""
        out = np.ascontiguousarray(rows[sel])
        out[:, -1] = (self._maxseg - 1 if ranks is None else ranks[sel])
        return out

    def align_batch(self, batch: list[Read]):
        results: list = [None] * len(batch)
        live_idx, budgets = self._filter_batch(batch, results)
        n = len(live_idx)
        if n == 0:
            return results
        codes, regs, lens, buds, rsets, ridx = self._pack_host(
            batch, live_idx, budgets)
        rand32 = (np.zeros(n, np.uint32) if self.param.randseed == 0
                  else myrand_hash(ridx, self.param.randseed))
        cfg = self._cfg(self._chains_mode(rsets))
        rows = _pack_inputs(codes, regs, lens, buds, rand32,
                            np.zeros(n, np.int32))
        out_rows, replays = self._align_arrays(
            cfg, rows, lambda t: batch[live_idx[t]])
        for t, res in replays.items():
            results[live_idx[t]] = res
        MS = cfg.maxseg
        for t in range(n):
            if t not in replays:
                results[live_idx[t]] = DeviceView(out_rows[t], MS,
                                                  int(buds[t]))
        return results

    def _align_arrays(self, cfg: Cfg, rows, read_of, risk=None,
                      fx_ok: bool = False, defer: bool = False):
        """Core orchestration over pre-encoded live reads: windowed
        optimistic dispatches, overflow retry with candidate-capacity
        escalation, exact host replay with MateState maintenance.  ``rows``
        is the (n, 2nw+4) dispatch buffer (maxrank column ignored);
        ``read_of(t)`` lazily materializes live row t as a Read.  Returns
        (out_rows, {row: SEResult for replayed rows}), or with ``defer`` a
        function returning them that collects round 2 and replays."""
        in_w = rows.shape[1]
        lens = rows[:, in_w - 4]
        buds = rows[:, in_w - 3]
        n = len(lens)
        if risk is None:
            risk = self._stale_risk(lens, buds)

        MS = cfg.maxseg
        width = 3 if cfg.lean else 2 * MS + N_EXTRAS
        out_rows = np.zeros((n, width), dtype=np.int32)
        done = np.zeros(n, dtype=bool)
        served = np.zeros(n, dtype=bool)         # enumerated within capacity
        ftot = np.zeros(n, dtype=np.int64)       # full-rank candidate totals
        full_rank = MS - 1
        FTOT_CLAMP = 1 << 27

        def mark_replay(sel):
            out_rows[sel] = 0
            if cfg.lean:
                out_rows[sel, 1] = BIT_REPLAY | BIT_RESOLVED
            else:
                out_rows[sel, 2 * MS + X_REPLAY] = 1

        def collect(sel, orows, fx: bool = False):
            """Commit one collected window; returns (#done, #unresolved)."""
            # a read's result is exact iff its whole candidate range fit in
            # the dispatch capacity (ok bit, computed on device)
            if cfg.lean:
                ok = (orows[:, 1] & BIT_OK) != 0
                res = (orows[:, 1] & BIT_RESOLVED) != 0
                ftot[sel] = orows[:, 2]
            else:
                ok = orows[:, 2 * MS + X_OK] != 0
                res = orows[:, 2 * MS + X_RESOLVED] != 0
                ftot[sel] = orows[:, 2 * MS + X_FTOT]
            fin = ok & res
            if fx:
                # fixed-schedule round: only schedule-independent results
                # commit; the rest re-dispatch on the exact program.  Full
                # rows (the index-sharded engine's) carry the lean row's
                # multi bit as ssum and totals; bsmap_tpu reads their
                # column 1 there instead (ROADMAP C)
                if cfg.lean:
                    multi = (orows[:, 1] & BIT_MULTI) != 0
                else:
                    ex = orows[:, 2 * MS:]
                    multi = ((ex[:, X_SSUM] != 1)
                             | (ex[:, X_TOTAL] >= cfg.max_num_hits))
                fin = fin & ~multi
            out_rows[sel[fin]] = orows[fin]
            done[sel[fin]] = True
            served[sel[ok]] = True
            return int(fin.sum()), int((ok & ~res).sum())

        # RRBS runs every segment (align.cpp:450): no probe, full rank
        probing = self.probe_mode and self._probe_ok and not cfg.rrbs
        init_rank = full_rank if cfg.rrbs else min(self.rank_start, full_rank)
        cap_max = min(self.CANDS_BIG, FTOT_CLAMP - 1)

        def dispatch_packs(rem, demand, maxrank, collect_now=True):
            """Exactly bin-packed dispatches over reads `rem` (batch order)
            whose per-read candidate demand at this maxrank is `demand`.
            With collect_now=False the pending list is returned."""
            pend = []
            with obs.span("engine.dispatch"):
                ranks = np.full(n, maxrank, dtype=np.int32)
                for a, b, cap in pack_spans(demand, self.B, self.CANDS,
                                            self.CANDS_BIG):
                    sel = rem[a: b]
                    out = self._dispatch(
                        cfg, self._window_rows(rows, sel, ranks), cap)
                    pend.append((sel, out))
                    self.n_dispatched += 1
            if not collect_now:
                return pend
            nd = ne = 0
            arrs = self._collect([o for _, o in pend])
            with obs.span("engine.commit"):
                for (sel, _), arr in zip(pend, arrs):
                    d_, e_ = collect(sel, arr)
                    nd += d_
                    ne += e_
            return nd, ne

        def probe_rank_totals(rem):
            """(len(rem), maxseg) per-rank cumulative candidate totals from
            the stage-1-only probe program."""
            pend = []
            with obs.span("engine.dispatch"):
                pcfg = cfg._replace(probe=True, lean=False)
                for i in range(0, len(rem), self.B):
                    sel = rem[i: i + self.B]
                    pend.append((i, sel, self._dispatch(
                        pcfg, self._window_rows(rows, sel, None), 1)))
                    self.n_probe += 1
            ftr = np.zeros((len(rem), MS), dtype=np.int64)
            arrs = self._collect([o for _, _, o in pend])
            with obs.span("engine.commit"):
                for (i, sel, _), arr in zip(pend, arrs):
                    ftr[i: i + len(sel)] = arr
            return ftr

        def packed_rank_rounds(rem, ftr):
            """Round A at the progressive start rank, exactly packed; the
            full-rank round 2 below picks up whatever escalates."""
            nonlocal n_done, n_esc
            ftot[rem] = ftr[:, -1]
            too_big = rem[ftr[:, init_rank] >= cap_max]
            if len(too_big):
                mark_replay(too_big)
                done[too_big] = True
            live = ~done[rem]
            rem = rem[live]
            if len(rem):
                d, e = dispatch_packs(rem, ftr[live, init_rank], init_rank)
                n_done += d
                n_esc += e

        n_done = n_esc = 0
        n_win = (n + self.B - 1) // self.B
        if probing:
            rem0 = np.arange(n, dtype=np.int64)
            ftr = probe_rank_totals(rem0)
            if ftr[:, -1].sum() < n_win * self.CANDS // 2:
                self.probe_mode = False      # genome turned out clean
            packed_rank_rounds(rem0, ftr)
        else:
            # round 1: optimistic full windows at the small capacity, on the
            # fixed-schedule program when every read is eligible
            pend1 = []
            with obs.span("engine.dispatch"):
                rcfg = cfg._replace(fixed=True) if fx_ok else cfg
                ranks = np.full(n, init_rank, dtype=np.int32)
                for i in range(0, n, self.B):
                    sel = np.arange(i, min(i + self.B, n), dtype=np.int64)
                    pend1.append((sel, self._dispatch(
                        rcfg, self._window_rows(rows, sel, ranks),
                        self.CANDS)))
                    self.n_dispatched += 1
            arrs = self._collect([o for _, o in pend1])
            with obs.span("engine.commit"):
                for (sel, _), arr in zip(pend1, arrs):
                    d, e = collect(sel, arr, fx=fx_ok)
                    n_done += d
                    n_esc += e
            if n:
                rem_mass = int(ftot[~done].sum())
                if (rem_mass > 2 * n_win * self.CANDS and self._probe_ok
                        and not cfg.rrbs):
                    # most of the demand overflowed the optimistic round:
                    # repeat-heavy genome — switch to probe + exact packing,
                    # for this call's overflowed reads too
                    self.probe_mode = True
                    rem = np.nonzero(~done & ~served)[0]
                    if len(rem):
                        packed_rank_rounds(rem, probe_rank_totals(rem))

        # self-tuning (future calls): when rank escalation dominates, start
        # at full enumeration instead of paying the extra round
        if n and init_rank < full_rank and n_done + n_esc > 0 \
                and n_esc > n_done:
            self.rank_start = full_rank

        # round 2: everything unresolved re-dispatches ONCE at full rank
        # (always exact), exactly bin-packed; collected by finish()
        rem = np.nonzero(~done)[0]
        if len(rem):
            too_big = rem[ftot[rem] >= cap_max]
            if len(too_big):
                # one read exceeding the big capacity: exact host replay
                mark_replay(too_big)
                done[too_big] = True
                rem = rem[ftot[rem] < cap_max]
        pend2 = (dispatch_packs(rem, ftot[rem], full_rank, collect_now=False)
                 if len(rem) else [])

        def finish():
            arrs = self._collect([o for _, o in pend2]) if pend2 else []
            with obs.span("engine.commit"):
                for (sel, _), arr in zip(pend2, arrs):
                    collect(sel, arr)
                left = np.nonzero(~done)[0]
                if len(left):      # defensive: packed dispatches always fit
                    mark_replay(left)
                    done[left] = True

            self.cand_sum += int(ftot.sum())
            self.cand_reads += n
            self.cand_max = max(self.cand_max, int(ftot.max(initial=0)))

            # --- in-order collection with exact MateState maintenance -------
            if cfg.lean:
                dev_flag = (out_rows[:, 1] & BIT_REPLAY) != 0
                dev_soff = dev_coff = None
            else:
                dev_flag = out_rows[:, 2 * MS + X_REPLAY] != 0
                dev_soff = out_rows[:, 2 * MS + X_SOFF]
                dev_coff = out_rows[:, 2 * MS + X_COFF]
            replay_flag = dev_flag | risk
            if self.param.randseed == 0:
                # -S 0: the kernel selected with rand32=0; only unique-hit
                # reads are draw-independent — multi-hit reads replay so the
                # formatter's sequential rand_r picks the real j-th hit
                if cfg.lean:
                    multi = (((out_rows[:, 1] & BIT_FOUND) != 0)
                             & ((out_rows[:, 1] & BIT_MULTI) != 0))
                else:
                    multi = ((out_rows[:, 2 * MS + X_FOUND] != 0)
                             & (out_rows[:, 2 * MS + X_SSUM] != 1))
                replay_flag = replay_flag | multi
            replay_pos = np.nonzero(replay_flag)[0]
            replays: dict[int, SEResult] = {}
            cursor = 0
            with obs.span("host.route", rows=len(replay_pos)):
                for rpos in replay_pos:
                    rpos = int(rpos)
                    if risk[rpos]:
                        # replay may READ stale state: sync it first
                        self._sync_state_span(read_of, cursor, rpos,
                                              dev_soff, dev_coff, lens,
                                              replay_flag, cfg.chains_mode)
                        cursor = rpos + 1   # run_align updates the state
                    with obs.span("host.align", cpu=False):
                        replays[rpos] = (self.native or self.host).run_align(
                            read_of(rpos), int(buds[rpos]))
                    self.n_replayed += 1
                    self.host_native += self.native is not None
                    self.host_causes["device" if dev_flag[rpos] else
                                     "stale" if risk[rpos] else "draw"] += 1
                # keep the state current through the batch tail: a LATER
                # batch may contain stale-schedule reads whose replay reads
                # this state
                self._sync_state_span(read_of, cursor, n, dev_soff, dev_coff,
                                      lens, replay_flag, cfg.chains_mode)
            return out_rows, replays

        return finish if defer else finish()

    def format_batch(self, batch: list[Read], fmt) -> str:
        results = self.align_batch(batch)
        out = []
        for rd, res in zip(batch, results):
            if isinstance(res, DeviceView):
                out.append(fmt.emit_device(rd, res))
            else:
                out.append(fmt.string_align(rd, res))
        return "".join(out)

    # -- block fast path (no per-read Python objects) -------------------------

    def supports_blocks(self) -> bool:
        """Every SE configuration of the port runs on the native block path
        (SAM, BSP, -R, trimming) when the native runtime builds."""
        from .. import native
        return native.get_lib() is not None

    def encode_block(self, block):
        """Native filter + encode for one ReadBlock; runs in the
        parse-ahead thread (the native calls release the GIL).  Caches and
        returns (nw, rows, info) on the block."""
        if block.enc is not None:
            return block.enc
        from .. import native
        p = self.param
        lib = native.get_lib()
        info = filter_block(p, block)
        # word count per read: 7 covers reads <= 112 nt
        max_len = int(block.rec[:, 3].max()) if len(block) else 0
        nw = 7 if min(max_len, p.max_readlen) <= 112 else FIXELEMENT
        rows = native.encode_block_words(
            lib, block.buf, block.rec, p.alphabet, REG_ALPHABET, nw)
        block.enc = (nw, rows, info)
        return block.enc

    def block_rows(self, block):
        """Dispatch rows of one ReadBlock's live reads: (nw, live_pos, rows,
        buds_all) where rows is (len(live_pos), 2nw+4) int32 with budget and
        selection hash filled in and the maxrank column 0, and buds_all is
        each block read's post-trim mismatch budget."""
        p = self.param
        buds_all = np.zeros(len(block), dtype=np.int32)
        nw, rows, info = self.encode_block(block)
        lens = rows[:, 2 * nw]
        if info is not None:
            live = info[:, 0] == 0
        else:
            ncnt = rows[:, 2 * nw + 3]   # encoder parks the N count here
            live = (lens >= p.min_read_size) & (ncnt <= p.max_ns)
        live_pos = np.nonzero(live)[0]
        rows_l = rows[live_pos]
        lens_l = rows_l[:, 2 * nw]
        if info is not None:
            buds = info[live_pos, 1].astype(np.int32)
        else:
            buds = ((p.max_snp_num + 1) * (lens_l - 1)
                    // lens_l).astype(np.int32)
        buds_all[live_pos] = buds
        rows_l[:, 2 * nw + 1] = buds
        rows_l[:, 2 * nw + 2] = (0 if p.randseed == 0 else myrand_hash(
            block.indices[live_pos], p.randseed).astype(np.uint32).view(
            np.int32))
        rows_l[:, 2 * nw + 3] = 0
        return nw, live_pos, rows_l, buds_all

    def align_block(self, block):
        """Align one ReadBlock.  Returns (live_pos, finish, buds_all): round
        1 is dispatched AND collected here, round 2 is dispatched and only
        collected by finish() — the block pipeline calls finish() from the
        writer thread.  finish() -> (rows, replays) where row t is block
        read live_pos[t] in the lean layout (BIT_*) for plain SAM, else the
        full layout, and replays maps row -> exact SEResult; buds_all is
        each block read's post-trim mismatch budget."""
        with obs.span("engine.align", rows=len(block)):
            p = self.param
            with obs.span("engine.rows"):
                nw, live_pos, rows_l, buds_all = self.block_rows(block)
                if len(live_pos) == 0:
                    return (live_pos,
                            lambda: (np.zeros((0, 3), np.int32), {}),
                            buds_all)
                lens_l = rows_l[:, 2 * nw]
                buds = rows_l[:, 2 * nw + 1]
                risk = self._stale_risk(lens_l, buds)
                # BSP needs the per-level histograms and XR reads the
                # selection context — both ride the FULL result rows; plain
                # SAM uses lean rows
                plain_sam = p.out_sam >= 1 and not p.out_ref
                lean = plain_sam and not risk.any()
                cfg = self._cfg("b" if p.chains
                                else ("r" if block.readset == 2 else "f"),
                                lean=lean, nw=nw)
                fx_ok = lean and self._fx_eligible(
                    lens_l, buds,
                    self.encode_block(block)[1][live_pos, 2 * nw + 3])
            fin = self._align_arrays(
                cfg, rows_l, BlockReads(block, live_pos),
                risk=risk, fx_ok=fx_ok, defer=True)

            def finish():
                with obs.span("engine.finish", rows=len(block)):
                    out_rows, replays = fin()
                    if not cfg.lean and plain_sam:
                        return _pack_rows_lean(out_rows, cfg.maxseg), replays
                    return out_rows, replays

            return live_pos, finish, buds_all

    def format_block(self, block, fmt) -> bytes:
        """Align + format one ReadBlock as SAM/BSP bytes."""
        return self.format_aligned_block(block, self.align_block(block), fmt)

    def _select_vals(self, read, res, fmt):
        """string_align's selection half (align.cpp:610-627) without the
        formatting: first nonempty level, reproducible draw (consumed HERE,
        so the sequential -S 0 stream stays exact), selected hit."""
        from ..utils import myrand
        p = self.param
        ii = ssum = 0
        for ii in range(res.read_max_snp_num + 1):
            ssum = int(res.n_hit[ii] + res.n_chit[ii])
            if ssum > 0:
                break
        if ssum == 0:
            return (0, ii, 0, 0, 0, 0)
        j = myrand(read.index, p.randseed, fmt.rand_r) % ssum
        if j < res.n_hit[ii]:
            chain, hit = 0, res.hits[ii][j]
        else:
            chain, hit = 1, res.chits[ii][j - int(res.n_hit[ii])]
        return (1, ii, ssum, chain, int(hit[0]), int(hit[1]))

    @staticmethod
    def _carry_stale_h00(rows_all, status, MS: int, fmt,
                         qc_strand: bool) -> None:
        """Carry the hits[0][0] slot through one block in read order, as
        ``string_align``/``emit_device`` do (``fmt.stale_h00``): a result
        row with ``X_H00F`` sets it, a QC row (status 1, all zeros) takes
        it as it stands.  With ``qc_strand`` (BSP) each QC row gets the
        slot's ``X_CHRP`` and ``X_CHAIN = 0``: its line is
        reverse-complemented when the slot lies on a Crick strand
        (``_out_bsp``, align.cpp:723-760)."""
        ex = 2 * MS
        set_at = np.flatnonzero(rows_all[:, ex + X_H00F])
        slot_cols = [ex + X_H00C, ex + X_H00W]
        qc = np.flatnonzero(status == 1) if qc_strand else set_at[:0]
        if len(qc):
            # the last row before each QC row that set the slot; -1 where
            # none in this block did (the slot the block started with)
            k = np.searchsorted(set_at, qc) - 1
            slot = np.tile(np.array(fmt.stale_h00, dtype=np.int32),
                           (len(qc), 1))
            slot[k >= 0] = rows_all[set_at[k[k >= 0]]][:, slot_cols]
            rows_all[qc, ex + X_CHRP] = slot[:, 0]
            rows_all[qc, ex + X_WLOC] = slot[:, 1]
            rows_all[qc, ex + X_CHAIN] = 0
        if len(set_at):
            c, w = rows_all[set_at[-1], slot_cols]
            fmt.stale_h00 = (int(c), int(w))

    def _format_block_full(self, block, live_pos, buds_all, out_rows,
                           replays, fmt) -> bytes:
        """BSP / -R SAM native block formatting over FULL result rows.
        Host-replayed reads are not text-spliced: their selection runs in
        Python and the result is synthesized into a row, so the stateful
        reference-context buffer advances in one place — the native side."""
        from .. import native
        p = self.param
        lib = native.get_lib()
        MS = self._maxseg
        width = 2 * MS + N_EXTRAS
        n_all = len(block)
        status = np.ones(n_all, dtype=np.int32)          # 1 = QC-filtered
        rows_all = np.zeros((n_all, width), dtype=np.int32)
        status[live_pos] = 2
        if len(live_pos):
            rows_all[live_pos] = out_rows[:, :width]
        rep = sorted((int(live_pos[t]), t) for t in replays)
        is_replay = np.zeros(n_all, dtype=bool)
        for pos, _ in rep:
            is_replay[pos] = True
        fcum = None
        if p.randseed == 0:
            found_dev = ((status == 2) & ~is_replay
                         & (rows_all[:, 2 * MS + X_FOUND] != 0))
            fcum = np.concatenate([[0], np.cumsum(found_dev)])
        prev = 0
        for pos, t in rep:
            if fcum is not None:
                fmt.rand_r.skip(int(fcum[pos] - fcum[prev]))
                prev = pos
            res = replays[t]
            found, ii, ssum, chain, chrp, wloc = self._select_vals(
                block.read_obj(pos), res, fmt)
            row = np.zeros(width, dtype=np.int32)
            row[0: 2 * MS: 2] = res.n_hit[:MS]
            row[1: 2 * MS: 2] = res.n_chit[:MS]
            ex = 2 * MS
            row[ex + X_FOUND] = found
            row[ex + X_II] = ii
            row[ex + X_SSUM] = ssum
            row[ex + X_CHAIN] = chain
            row[ex + X_CHRP] = chrp
            row[ex + X_WLOC] = wloc
            if res.hits[0]:
                row[ex + X_H00F] = 1
                row[ex + X_H00C], row[ex + X_H00W] = res.hits[0][0]
            rows_all[pos] = row
        if fcum is not None:
            fmt.rand_r.skip(int(fcum[n_all] - fcum[prev]))
        self._carry_stale_h00(rows_all, status, MS, fmt,
                              qc_strand=p.out_sam == 0)
        un = self.param.useful_nt[:4].encode("latin1")
        total_codes = len(self.genome.refcat) * SEGLEN
        if p.out_sam >= 1:
            out, _lo, na = native.format_sam_block_xr(
                lib, block.buf, block.rec, status,
                _pack_rows_lean(rows_all, MS)[:, :2],
                self._chrname_buf, self._chrname_off, REV_CHAR,
                0x40 * block.readset, bool(p.out_unmap),
                p.report_repeat_hits, block.synth_qual,
                self.genome.refcat, total_codes, self._anchors_i64, un,
                self._mapseq_buf, int(p.RRBS_flag), self._sites_local,
                self._site_off_l, self._rr_tail)
        else:
            out, _lo, na = native.format_bsp_block(
                lib, block.buf, block.rec, status, rows_all, MS,
                self._chrname_buf, self._chrname_off, REV_CHAR,
                bool(p.out_unmap), p.report_repeat_hits, p.max_snp_num,
                p.max_num_hits, block.synth_qual,
                self.genome.refcat, total_codes, self._anchors_i64, un,
                self._mapseq_buf, buds_all)
        fmt.n_aligned += na
        return out

    def format_aligned_block(self, block, aligned, fmt):
        """Format one aligned ReadBlock as SAM bytes via the native
        formatter; replayed reads are formatted exactly in Python and
        spliced back in order.  Collects the block first (its finish)."""
        live_pos, fin, buds_all = aligned
        out_rows, replays = fin()
        with obs.span("format", rows=len(block)):
            if self.param.out_sam == 0 or self.param.out_ref:
                return self._format_block_full(block, live_pos, buds_all,
                                               out_rows, replays, fmt)
            return self._format_block_sam(block, live_pos, out_rows,
                                          replays, fmt)

    def _format_block_sam(self, block, live_pos, out_rows, replays, fmt):
        from .. import native
        p = self.param
        lib = native.get_lib()
        n_all = len(block)
        status = np.ones(n_all, dtype=np.int32)          # 1 = QC-filtered
        rows_all = np.zeros((n_all, 2), dtype=np.int32)
        status[live_pos] = 2
        rows_all[live_pos] = out_rows[:, :2]
        replay_pos = sorted(int(live_pos[t]) for t in replays)
        rmap = {int(live_pos[t]): t for t in replays}
        status[replay_pos] = 0                           # Python-formatted
        out, line_off, na = native.format_sam_block(
            lib, block.buf, block.rec, status, rows_all,
            self._chrname_buf, self._chrname_off, REV_CHAR,
            0x40 * block.readset, bool(p.out_unmap), p.report_repeat_hits,
            block.synth_qual, int(p.RRBS_flag), self._sites_local,
            self._site_off_l, self._rr_tail)
        fmt.n_aligned += na
        fcum = None
        if p.randseed == 0:
            # -S 0: every found device-handled read consumed one rand_r
            # draw in the reference (align.cpp:623); keep the formatter's
            # sequential stream in sync for the replayed multi-hit reads
            found_dev = (status == 2) & ((rows_all[:, 1] & BIT_FOUND) != 0)
            fcum = np.concatenate([[0], np.cumsum(found_dev)])
        if not replay_pos:
            if fcum is not None:
                fmt.rand_r.skip(int(fcum[-1]))
            return out
        pieces, prev = [], 0
        prev_read = 0
        for i in replay_pos:
            cut = int(line_off[i])
            pieces.append(out[prev:cut])
            if fcum is not None:
                fmt.rand_r.skip(int(fcum[i] - fcum[prev_read]))
                prev_read = i + 1
            res = replays[rmap[i]]
            pieces.append(fmt.string_align(block.read_obj(i), res)
                          .encode("latin1"))
            prev = cut
        pieces.append(out[prev:])
        if fcum is not None:
            fmt.rand_r.skip(int(fcum[n_all] - fcum[prev_read]))
        return b"".join(pieces)


class BlockReads:
    """``read_of`` over a ReadBlock's live reads: row t is block read
    ``live_pos[t]``, made a Read on call.  The native MateState sync reads
    the block's arrays instead, at the addresses ``addr`` keeps for the
    block's life."""

    __slots__ = ("block", "live_pos", "_addrs")

    def __init__(self, block, live_pos: np.ndarray):
        self.block = block
        self.live_pos = live_pos
        self._addrs: dict[int, tuple] = {}

    def __call__(self, t: int) -> Read:
        return self.block.read_obj(int(self.live_pos[t]))

    def addr(self, a: np.ndarray, dtype) -> int:
        """The address of ``a``'s values as a C-contiguous ``dtype`` array:
        its own data, or a copy made at the first call.  ``a`` is one of
        the block's arrays, not written while the block syncs; both are
        held here, so its ``id`` stays its own."""
        hit = self._addrs.get(id(a))
        if hit is None:
            c = np.ascontiguousarray(a, dtype=dtype)
            hit = self._addrs[id(a)] = (a, c, c.ctypes.data)
        return hit[2]


def sync_state_python(p: Param, aligner, st, read_of, lo: int, hi: int,
                      dev_soff, dev_coff, lens, replay_flag,
                      mode: str) -> None:
    """``DeviceEngine._sync_state_span``'s effects on ``st`` through Read
    objects: ``fill_seed_buffers``, then the start offsets from the device
    rows or, where they do not carry them, ``aligner.sync_schedule``."""
    S, I = p.seed_size, p.index_interval
    mo = (lens[lo:hi] - I + 1) % S
    nz = np.nonzero(mo > 0)[0]
    offset_read = None
    if len(nz):
        k = lo + int(nz[-1])
        if not replay_flag[k]:
            if dev_soff is None:
                # lean rows don't carry the chosen offsets; recompute them
                # with the exact host schedule after the buffer fill below
                offset_read = k
            else:
                if mode in ("f", "b"):
                    st.seed_start_offset = int(dev_soff[k])
                if mode in ("r", "b"):
                    st.cseed_start_offset = int(dev_coff[k])
    cover = max(0, int(lens[lo:hi].max()) - S + 1)
    fill_seed_buffers(p, st, read_of, lo, hi, cover)
    if offset_read is not None:
        rd = read_of(offset_read)
        aligner.sync_schedule(rd, int(
            (p.max_snp_num + 1) * (len(rd.seq) - 1) // len(rd.seq)),
            state=st)


def filter_block(p: Param, block):
    """Native FilterReads over one ReadBlock (align.cpp:579-589): trims its
    rec in place and returns the (n, 3) int32 [filtered, budget, raw_len]
    rows; None when the run trims nothing (no -A, no -q).  The -z SAM
    rescale quirk rewrites quality bytes, so the block's buffer is swapped
    for a written copy exactly when that branch can fire."""
    if not p.adapters and p.qual_threshold == 0:
        return None
    from .. import native
    rescale = bool(p.out_sam and p.zero_qual != ord("!")
                   and p.qual_threshold > 0)
    if rescale:
        mbuf = np.frombuffer(bytearray(block.buf), dtype=np.uint8)
    else:
        mbuf = np.frombuffer(block.buf, dtype=np.uint8)
    info = native.filter_block(native.get_lib(), mbuf, block.rec, p,
                               block.synth_qual)
    if rescale:
        block.buf = mbuf.tobytes()
        if block.is_fasta:
            # synthetic quality is rescaled too (align.cpp:63-67)
            block.synth_qual = ord("!") + p.default_qual
    return info


def _pack_rows_lean(rows: np.ndarray, maxseg: int) -> np.ndarray:
    """Repack full kernel rows into the lean 3-int32 layout (BIT_*) for the
    native SAM formatter."""
    ex = 2 * maxseg
    w1 = ((rows[:, ex + X_FOUND] != 0).astype(np.int32) * BIT_FOUND
          | (rows[:, ex + X_CHAIN] << 1)
          | (rows[:, ex + X_REPLAY] != 0).astype(np.int32) * BIT_REPLAY
          | BIT_OK
          | (rows[:, ex + X_SSUM] != 1).astype(np.int32) * BIT_MULTI
          | (rows[:, ex + X_II] << LEAN_II_SHIFT)
          | (rows[:, ex + X_CHRP] << LEAN_CHRP_SHIFT))
    return np.stack([rows[:, ex + X_WLOC], w1,
                     rows[:, ex + X_FTOT]], axis=1).astype(np.int32)


class DeviceView:
    """Per-read result of the device fast path, duck-typing the fields the
    output formatter needs (SEResult-compatible subset + preselected hit)."""

    filtered = False

    def __init__(self, row: np.ndarray, maxseg: int, budget: int):
        counts = row[: 2 * maxseg].reshape(maxseg, 2)
        ex = row[2 * maxseg:]
        # pad histograms to MAXSNPS+1 (BSP prints 0..read_max_snp_num)
        self.n_hit = np.zeros(MAXSNPS + 1, dtype=np.int32)
        self.n_chit = np.zeros(MAXSNPS + 1, dtype=np.int32)
        self.n_hit[:maxseg] = counts[:, 0]
        self.n_chit[:maxseg] = counts[:, 1]
        self.read_max_snp_num = budget
        self.found = bool(ex[X_FOUND])
        self.level = int(ex[X_II])
        self.ssum = int(ex[X_SSUM])
        self.chain = int(ex[X_CHAIN])
        self.hit = (int(ex[X_CHRP]), int(ex[X_WLOC]))
        self.h00_found = bool(ex[X_H00F])
        self.h00 = (int(ex[X_H00C]), int(ex[X_H00W]))
