"""Exact sequential alignment engine (the correctness oracle).

Replicates SingleAlign / PairAlign control flow (align.cpp, pairs.cpp)
read-by-read in plain Python/numpy, including every order-dependent detail:
frequency-adaptive seed scheduling (align.cpp:454-577), per-segment
progressive-sensitivity early exit (align.cpp:445-449), hitset dedup by
(chr, Watson-loc) shared across chains (align.cpp:201,274), snp_thres
tightening when a mismatch level fills (align.cpp:211-212,277-278), and the
-r 0 second-best-hit abort (align.cpp:210).

This engine is the bit-parity reference for the vectorized device engine and
the production fallback for reads the device fast path flags as control-flow
sensitive (bucket overflow / repeat aborts).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..encoding import unpack_u32
from ..index import SeedIndex
from ..params import MAXSNPS, Param, SEGLEN
from ..readio import Read
from ..reference import PackedGenome, ccgg_seglen
from ..trim import filter_read


class MateState:
    """Per-SingleAlign-instance state that leaks across reads in the
    reference and is semantically visible for reads whose
    ``(len - interval + 1) % seed_size == 0`` (``max_offset == 0``):
    ReorderSeed then skips its initial scan (align.cpp:458-468 loop bound),
    so ``seed_start_offset`` keeps the previous read's value and the
    scheduling may index ``seed_array`` entries beyond this read's prefix —
    stale values from earlier (longer) reads.  Fresh heap in the reference
    zero-initializes both, which this emulation mirrors."""

    SEEDBUF = 160  # generous upper bound on touched entries

    def __init__(self) -> None:
        self.seed_buf = np.zeros(self.SEEDBUF, dtype=np.int64)
        self.cseed_buf = np.zeros(self.SEEDBUF, dtype=np.int64)
        self.seed_start_offset = 0
        self.cseed_start_offset = 0


def fill_seed_buffers(param, state: MateState, read_of, lo: int, hi: int,
                      cover_upto: int) -> None:
    """Apply the seed-buffer writes of reads [lo, hi) (in batch order) to
    ``state``: last-writer-wins backward fill, materializing reads lazily
    from newest to oldest and stopping once entries [0, cover_upto) are
    covered."""
    from ..encoding import seed_values
    S = param.seed_size
    need = np.ones(MateState.SEEDBUF, dtype=bool)
    for k in range(hi - 1, lo - 1, -1):
        rd = read_of(k)
        L = len(rd.seq)
        if L < S:
            continue
        n_ent = L - S + 1
        fillm = need[:n_ent]
        if fillm.any():
            sb = np.frombuffer(rd.seq.encode("latin1"), dtype=np.uint8)
            codes = param.alphabet[sb].astype(np.int8)
            state.seed_buf[:n_ent][fillm] = seed_values(codes, S)[fillm]
            ccodes = param.rev_alphabet[sb[::-1]].astype(np.int8)
            state.cseed_buf[:n_ent][fillm] = seed_values(ccodes, S)[fillm]
            need[:n_ent] = False
        if not need[:cover_upto].any():
            break


@dataclasses.dataclass
class SEResult:
    """Everything StringAlign / pair logic needs about one aligned read."""

    filtered: bool
    read_max_snp_num: int = 0
    seedseg_num: int = 0
    # hits[w] = list of (chr_packed, watson_loc) in insertion order
    hits: list[list[tuple[int, int]]] = dataclasses.field(default_factory=list)
    chits: list[list[tuple[int, int]]] = dataclasses.field(default_factory=list)
    n_hit: np.ndarray | None = None    # (MAXSNPS+1,) discovered counts
    n_chit: np.ndarray | None = None
    aborted_repeat: bool = False       # -r 0 early return fired


class HostEngine:
    """SingleAlign-equivalent per-read aligner (exact semantics)."""

    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param):
        self.genome = genome
        self.index = index
        self.param = param
        if param.profile is None:
            param.init_mapping()
        # Unpacked code caches for window compares.
        self.refcodes = unpack_u32(genome.refcat)
        self.crefcodes = unpack_u32(genome.crefcat)
        self.anchors = genome.anchors
        self.n_chr = genome.n_chr
        self.mate_state = MateState()   # SE: one SingleAlign instance
        # per-chromosome unpacked codes for RRBS chr-local verify
        self._chr_codes_cache: dict[int, np.ndarray] = {}

    # -- per-read precompute (ConvertBinaySeq: align.cpp:90-162) -------------

    def _convert(self, read: Read, state: MateState):
        p = self.param
        sb = np.frombuffer(read.seq.encode("latin1"), dtype=np.uint8)
        codes = p.alphabet[sb].astype(np.int8)
        reg = np.zeros(len(sb), dtype=np.int8)
        from ..params import REG_ALPHABET
        reg[:] = REG_ALPHABET[sb]
        ccodes = p.rev_alphabet[sb[::-1]].astype(np.int8)
        creg = reg[::-1].copy()
        from ..encoding import seed_values
        # write this read's seed prefix into the persistent buffers; entries
        # beyond len-S keep earlier reads' values (see MateState)
        sv = seed_values(codes, p.seed_size)
        state.seed_buf[: len(sv)] = sv
        csv = seed_values(ccodes, p.seed_size)
        state.cseed_buf[: len(csv)] = csv
        return codes, reg, ccodes, creg, state.seed_buf, state.cseed_buf

    def _count_mismatch(self, qcodes, reg, cat_codes, g: int) -> int:
        """CountMismatch (align.h:167-200): asymmetric lane count of the read
        against cat_codes[g : g+len].  Out-of-array lanes read as code 0
        (margins are zeroed; values never affect accepted hits)."""
        L = len(qcodes)
        lo, hi = g, g + L
        n = len(cat_codes)
        if lo >= 0 and hi <= n:
            s = cat_codes[lo:hi]
        else:
            s = np.zeros(L, dtype=np.int8)
            a, b = max(lo, 0), min(hi, n)
            if a < b:
                s[a - lo: b - lo] = cat_codes[a:b]
        mism = (reg != 0) & (qcodes != s) & ~((qcodes == 3) & (s == 1))
        return int(mism.sum())

    # -- seed scheduling (align.cpp:454-577) ---------------------------------

    def _bucket_count(self, seed: int) -> int:
        """WGBS candidate-count cost of one seed bucket.  The reference sums
        index2[s][0] which stores count+2 (AllocIndex dbseq.cpp:381-382), so
        each non-empty bucket costs its size + 2 (align.cpp:480,553)."""
        o = self.index.offsets
        c = int(o[seed + 1] - o[seed])
        return c + 2 if c > 0 else 0

    def _count_seeds(self, seed_array, n: int, start: int) -> int:
        p = self.param
        total = 0
        for i in range(p.index_interval):
            a = p.profile[n][i].a
            idx = a + start - i
            if 0 <= idx < len(seed_array):
                total += self._bucket_count(int(seed_array[idx]))
            else:
                # reference reads stale seed_array memory here; offsets that
                # index out of range only arise in the max_offset==0 corner
                total += 0
        return total

    def _adjust_start_array(self, seed_array, seedseg_num: int,
                            start_offset: int, max_offset: int) -> list[int]:
        """AdjustSeedStartArray zig-zag refinement (align.cpp:506-547)."""
        p = self.param
        arr = [start_offset] * seedseg_num
        if p.RRBS_flag:
            return arr
        for i in range(seedseg_num):
            ptr = i // 2 if i % 2 == 0 else seedseg_num - 1 - i // 2
            start = 0 if ptr == 0 else arr[ptr - 1]
            end = max_offset if ptr == seedseg_num - 1 else arr[ptr + 1]
            best, total = start, 0xFFFFFFFF
            arr[ptr] = start
            for ii in range(start, end + 1):
                tt = self._count_seeds(seed_array, ptr, ii) & 0xFFFFFFFF
                if tt < total:
                    total, best = tt, ii
            arr[ptr] = best
        return arr

    def _reorder(self, seed_array, cseed_array, seedseg_num: int,
                 read_len: int, flag_chain: bool, cflag_chain: bool,
                 state: MateState):
        """ReorderSeed (align.cpp:454-504): choose global start offsets, then
        per-segment offsets, then order segments cheapest-bucket-first."""
        p = self.param
        if p.RRBS_flag:
            s_off = c_off = 0
            max_offset = 0
        else:
            max_offset = (read_len - p.index_interval + 1) % p.seed_size
            # max_offset == 0 -> the scan below never runs and the offsets
            # keep their previous-read values (align.cpp:458; see MateState)
            s_off, c_off = state.seed_start_offset, state.cseed_start_offset
            best = cbest = 0xFFFFFFFF
            for i in range(max_offset):
                if flag_chain:
                    tt = sum(self._count_seeds(seed_array, n, i)
                             for n in range(seedseg_num)) & 0xFFFFFFFF
                    if tt < best:
                        best, s_off = tt, i
                if cflag_chain:
                    tt = sum(self._count_seeds(cseed_array, n, i)
                             for n in range(seedseg_num)) & 0xFFFFFFFF
                    if tt < cbest:
                        cbest, c_off = tt, i
            if flag_chain:
                state.seed_start_offset = s_off
            if cflag_chain:
                state.cseed_start_offset = c_off

        result = {}
        if flag_chain:
            arr = self._adjust_start_array(seed_array, seedseg_num, s_off,
                                           max_offset)
            costs = []
            for n in range(seedseg_num):
                if p.RRBS_flag:
                    a = p.profile[n][0].a
                    sd = int(seed_array[a + arr[n]])
                    o = self.index.offsets
                    s = int(o[sd + 1] - o[sd])
                else:
                    s = self._count_seeds(seed_array, n, arr[n])
                costs.append((s, n))
            costs.sort()
            result["fwd"] = (arr, costs)
        if cflag_chain:
            carr = self._adjust_start_array(cseed_array, seedseg_num, c_off,
                                            max_offset)
            costs = []
            for n in range(seedseg_num):
                if p.RRBS_flag:
                    a = p.profile[n][0].a
                    cseed_offset = read_len % p.seed_size
                    sd = int(cseed_array[a + cseed_offset + carr[n]])
                    o = self.index.offsets
                    s = int(o[sd + 1] - o[sd])
                else:
                    s = self._count_seeds(cseed_array, n, carr[n])
                costs.append((s, n))
            costs.sort()
            result["rc"] = (carr, costs)
        return result

    # -- the per-segment seed-and-verify pass (SnpAlign: align.cpp:168-347) --

    def _chr_local_codes(self, chr_packed: int) -> np.ndarray:
        if chr_packed not in self._chr_codes_cache:
            c = chr_packed // 2
            w0 = int(self.anchors[c]) // SEGLEN
            n = int(self.genome.n_words[c])
            cat = self.crefcodes if chr_packed % 2 else self.refcodes
            self._chr_codes_cache[chr_packed] = cat[w0 * SEGLEN:
                                                    (w0 + n) * SEGLEN]
        return self._chr_codes_cache[chr_packed]

    def align(self, read: Read) -> SEResult:
        p = self.param
        filtered, budget = filter_read(read, p)
        if filtered:
            return SEResult(filtered=True)
        return self.run_align(read, budget)

    def run_align(self, read: Read, budget: int,
                  state: MateState | None = None) -> SEResult:
        """Align an already-filtered read with the given mismatch budget."""
        return self._run_align(read, budget, state or self.mate_state)

    def sync_schedule(self, read: Read, budget: int,
                      state: MateState | None = None) -> None:
        """Apply only the MateState side effects of aligning ``read``:
        seed-buffer prefix write (_convert) and the ReorderSeed start-offset
        update — used by the device engine to keep the stale-state emulation
        exact when its lean output rows don't carry the chosen offsets."""
        p = self.param
        state = state or self.mate_state
        L = len(read.seq)
        seedseg_num = p.seedseg_num(L, budget)
        codes, reg, ccodes, creg, sa, csa = self._convert(read, state)
        flag_chain = bool(p.chains or read.readset < 2)
        cflag_chain = bool(p.chains or read.readset == 2)
        self._reorder(sa, csa, seedseg_num, L, flag_chain, cflag_chain,
                      state)

    def _run_align(self, read: Read, budget: int,
                   state: MateState) -> SEResult:
        """RunAlign (align.cpp:435-452)."""
        p = self.param
        L = len(read.seq)
        seedseg_num = p.seedseg_num(L, budget)
        codes, reg, ccodes, creg, seed_array, cseed_array = \
            self._convert(read, state)
        flag_chain = bool(p.chains or read.readset < 2)
        cflag_chain = bool(p.chains or read.readset == 2)

        st = _AlignState(budget)
        res = SEResult(filtered=False, read_max_snp_num=budget,
                       seedseg_num=seedseg_num,
                       hits=[[] for _ in range(MAXSNPS + 1)],
                       chits=[[] for _ in range(MAXSNPS + 1)])

        if True:  # ReorderSeed runs even with zero segments (align.cpp:444)
            sched = self._reorder(seed_array, cseed_array, seedseg_num, L,
                                  flag_chain, cflag_chain, state)
            for mode in range(seedseg_num):
                self._snp_align(read, mode, sched, st, res, codes, reg,
                                ccodes, creg, seed_array, cseed_array,
                                flag_chain, cflag_chain)
                # a mid-SnpAlign return only ends that segment scan; the
                # WGBS progressive check below is what stops the read
                # (align.cpp:445-449).  For WGBS any such return implies a
                # nonzero count at a level <= mode, so breaking is
                # equivalent; RRBS continues through all segments.
                if not p.RRBS_flag:
                    if st.returned or any(
                            len(res.hits[ii]) or len(res.chits[ii])
                            for ii in range(mode + 1)):
                        break

        res.n_hit = np.array([len(h) for h in res.hits], dtype=np.int64)
        res.n_chit = np.array([len(h) for h in res.chits], dtype=np.int64)
        res.aborted_repeat = st.aborted_repeat
        return res

    def _snp_align(self, read, mode, sched, st, res, codes, reg, ccodes,
                   creg, seed_array, cseed_array, flag_chain, cflag_chain):
        p = self.param
        st.returned = False   # returns are per-SnpAlign-call, not sticky
        L = len(read.seq)
        if p.RRBS_flag:
            if flag_chain:
                arr, order = sched["fwd"]
                modeindex = order[mode][1]
                self._rrbs_scan(read, res, st, codes, reg, seed_array,
                                arr, modeindex, chain=0, L=L, mode=mode)
                if st.returned:
                    return
            if cflag_chain:
                arr, order = sched["rc"]
                modeindex = order[mode][1]
                self._rrbs_scan(read, res, st, ccodes, creg, cseed_array,
                                arr, modeindex, chain=1, L=L, mode=mode)
            return
        if flag_chain:
            arr, order = sched["fwd"]
            modeindex = order[mode][1]
            self._wgbs_scan(read, res, st, codes, reg, seed_array, arr,
                            modeindex, chain=0, L=L, mode=mode)
            if st.returned:
                return
        if cflag_chain:
            arr, order = sched["rc"]
            modeindex = order[mode][1]
            self._wgbs_scan(read, res, st, ccodes, creg, cseed_array, arr,
                            modeindex, chain=1, L=L, mode=mode)

    def _wgbs_scan(self, read, res, st, qcodes, qreg, sarr, start_arr,
                   modeindex, chain, L, mode):
        """One segment x all interval phases against the WGBS CSR index
        (align.cpp:253-345)."""
        p = self.param
        idx = self.index
        g0 = self.anchors
        for i in range(p.index_interval):
            a = p.profile[modeindex][i].a
            k = a + start_arr[modeindex] - i
            if not (0 <= k < len(sarr)):
                continue  # stale-memory corner; see _count_seeds
            seed = int(sarr[k])
            o0, o1 = int(idx.offsets[seed]), int(idx.offsets[seed + 1])
            if o1 == o0:
                continue
            wc = int(idx.wcounts[seed])
            h = -a + i - start_arr[modeindex]
            entries = idx.locs[o0:o1].astype(np.int64)
            for j in range(o1 - o0):
                crick_ref = j >= wc
                g = int(entries[j]) + h
                cat = self.crefcodes if crick_ref else self.refcodes
                w = self._count_mismatch(qcodes, qreg, cat, g)
                if w > st.snp_thres:
                    continue
                c = int(np.clip(np.searchsorted(
                    g0[: self.n_chr], g, side="right") - 1, 0,
                    self.n_chr - 1))
                loc_local = g - int(g0[c])
                if crick_ref:
                    wloc = int(self.genome.rc_offsets[c]) - L - loc_local
                    chrp = 2 * c + 1
                else:
                    wloc = loc_local
                    chrp = 2 * c
                if wloc < 0 or wloc + L > int(self.genome.sizes[c]):
                    continue
                if (c, wloc) in st.hitset:
                    continue
                st.hitset.add((c, wloc))
                (res.hits if chain == 0 else res.chits)[w].append((chrp, wloc))
                nsum = len(res.hits[w]) + len(res.chits[w])
                if (w == mode and not p.pairend
                        and p.report_repeat_hits == 0 and nsum > 1):
                    st.returned = True
                    st.aborted_repeat = True
                    return
                if nsum >= p.max_num_hits:
                    if w == 0:
                        st.returned = True
                        return
                    st.snp_thres = w - 1

    def _rrbs_scan(self, read, res, st, qcodes, qreg, sarr, start_arr,
                   modeindex, chain, L, mode):
        """RRBS segment scan (align.cpp:175-251)."""
        p = self.param
        idx = self.index
        a = p.profile[modeindex][0].a
        if chain == 0:
            k = a + start_arr[modeindex]
            h = a
            want = modeindex          # (tag>>16)==modeindex: rc=0, j==mode
            xor = 0
        else:
            cseed_offset = L % p.seed_size
            k = a + cseed_offset + start_arr[modeindex]
            h = a + cseed_offset
            want = L // p.seed_size - 1 - modeindex
            xor = 0x1000000
        if not (0 <= k < len(sarr)):
            return
        seed = int(sarr[k])
        o0, o1 = int(idx.offsets[seed]), int(idx.offsets[seed + 1])
        for j in range(o1 - o0):
            tag = int(idx.tags[o0 + j])
            if ((tag ^ xor) >> 16) != want:
                continue
            chrp = tag & 0xFFFF
            loc = int(idx.locs[o0 + j])
            if loc < h:
                continue
            loc -= h
            cat = self._chr_local_codes(chrp)
            w = self._count_mismatch(qcodes, qreg, cat, loc)
            if w > st.snp_thres:
                continue
            c = chrp // 2
            if chrp % 2:
                wloc = int(self.genome.rc_offsets[c]) - L - loc
            else:
                wloc = loc
            if wloc < 0 or wloc + L > int(self.genome.sizes[c]):
                continue
            if (c, wloc) in st.hitset:
                continue
            st.hitset.add((c, wloc))
            if chain == 0 and not p.pairend:
                # SE RRBS fragment-size filter (align.cpp:202-207).  NOTE the
                # reference inserts into hitset BEFORE this filter.
                zp, zl = ccgg_seglen(self.genome, p, chrp, wloc, L)
                if zl > p.max_insert or zl < p.min_insert:
                    continue
            (res.hits if chain == 0 else res.chits)[w].append((chrp, wloc))
            nsum = len(res.hits[w]) + len(res.chits[w])
            # -r 0 abort on second equal-best hit (align.cpp:210,246)
            if (w == mode and not p.pairend and p.report_repeat_hits == 0
                    and nsum > 1):
                st.returned = True
                st.aborted_repeat = True
                return
            if nsum >= p.max_num_hits:
                if w == 0:
                    st.returned = True
                    return
                st.snp_thres = w - 1


class _AlignState:
    def __init__(self, budget: int):
        self.snp_thres = budget
        self.hitset: set[tuple[int, int]] = set()
        self.returned = False
        self.aborted_repeat = False
