"""PyTorch pair-end engine: the port of ``bsmap_tpu.engine.pair_device``.

The reference's lockstep escalation (pairs.cpp:137-190) is a pure function
of the complete per-mate hit enumerations: a hit with w mismatches found at
segment rank r is available for pairing at step i iff r <= i, and GetPairs
at step i sweeps the (na, nb) combos with max(na, nb) == i, so the winning
step is

    i* = min over valid pairs of max(na, nb)   with rank_a, rank_b <= max(na, nb).

Both mates therefore run the SE program once with ``cfg.pe`` (every
segment, no early exit, no -r 0 abort) and ``hits_k`` compacted hits per
read; mate 2 runs on the reverse-complement chain.  The pairing is a K x K
join.

  * Block path (the single-device engine on FASTA/FASTQ: SAM or BSP with
    -2, -R, trimming): native FilterReads and encode, then
    ``kernels.pair_program`` runs both mates and the join on the device
    (K5, K2, K3, K4, K6) and only the (n, 11) J_* rows come back, with
    each mate's per-level counts under BSP.  Phase 1 enumerates rank 0 for
    every pair and commits the pairs with i* == 0 (the reference stops at
    step 0 with exactly the rank-0 hits); phase 2 re-dispatches the rest
    at full rank, bin-packed by the per-pair candidate totals of phase 1.
    One native formatter call writes every pair of a block.
  * Per-pair path (the mesh engines of ``parallel``, SAM/BAM input): two
    SE dispatches per window (K5, K2, K3, K4, or the SE engine's own
    program) whose full rows come back to the host for the Python
    formatter, then K6 on those rows.

Sequential corners replay the PAIR on the exact host engine
(PairHostEngine) with the per-mate MateState kept bit-exact: per-mate
bucket-cap tightening and more than K hits (the K4 replay bit), a pairhits
bucket reaching max_num_hits, stale seed-schedule reads and -S 0 draws
(``n_replayed``).  A pair with a filtered mate runs there too: its
surviving mate aligns single-end (pairs.cpp:206-212) with the reads as
the one FilterReads pass left them (``n_mate_filtered``).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .. import obs
from ..index import SeedIndex
from ..params import FIXELEMENT, MAXSNPS, Param, REG_ALPHABET, REV_CHAR
from ..readio import Read
from ..reference import PackedGenome
from ..trim import filter_read
from ..utils import myrand, myrand_hash
from . import kernels
from .device_engine import (HOST_CAUSES, DeviceEngine, EngineUnsupported,
                            _pack_inputs, filter_block, pack_spans)
from .host_engine import SEResult
from .kernels import (JN_COLS, N_EXTRAS, X_COFF, X_FTOT, X_OK, X_REPLAY,
                      X_SOFF)
from .pair_host import PairHit, PairHostEngine, PairResult, fix_pair_read_name

PAIR_HITS_K = 16

# compact join row layout, int32 x 11 (pair_device.py:63-70)
(J_ALOC, J_BLOC, J_INS, J_WLOC_A, J_WLOC_B, J_FTOT, J_PAIR, J_CHRS,
 J_MATE_A, J_MATE_B, J_FLAGS) = range(JN_COLS)
# J_PAIR: paired(5b) | cnt<<5 (11b, clamped 2047) | chain<<16 | na<<17 (4b)
#         | nb<<21 (4b)
# J_CHRS: a_chr | b_chr<<16
# J_MATE_*: found | sch<<1 | ii<<2 (4b) | min(ssum,1023)<<6 | chrp<<16
# J_FLAGS: replay_a | replay_b<<1 | ok_both<<2 | cap_join<<3
# the native pair formatter's row (native/pe_format.cpp P_*): the 22
# columns of _prow_from_jrows (the pair's 10, then each mate's 6 from
# P_FND_A and P_FND_B), then each mate's FilterReads verdict
P_FND_A, P_FND_B, P_FLT_A, P_FLT_B, P_NCOL = 10, 16, 22, 23, 24


class _SelList:
    """Stand-in for a per-level hit list when only the reproducibly-selected
    element will ever be indexed (string_align_unpair's myrand pick)."""

    def __init__(self, n: int, hit):
        self._n = n
        self._hit = hit

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k):
        return self._hit


class PairSEView:
    """SEResult-compatible view of one mate's full kernel row (counts +
    the exact sorted-order selection), for the unpaired-fallback formatter.
    The hit-list views are built lazily: properly-paired pairs never touch
    them."""

    filtered = False
    aborted_repeat = False
    __slots__ = ("n_hit", "n_chit", "read_max_snp_num", "_hit",
                 "_hits", "_chits")

    def __init__(self, row: np.ndarray, maxseg: int, budget: int, hit):
        counts = row[: 2 * maxseg].reshape(maxseg, 2)
        self.n_hit = np.zeros(MAXSNPS + 1, dtype=np.int64)
        self.n_chit = np.zeros(MAXSNPS + 1, dtype=np.int64)
        self.n_hit[:maxseg] = counts[:, 0]
        self.n_chit[:maxseg] = counts[:, 1]
        self.read_max_snp_num = budget
        # `hit` is the exact draw: the myrand-index-th entry of the
        # concatenated fwd-then-rc (chr, loc)-sorted best-level lists,
        # recomputed by K6 from the K compacted hits
        self._hit = hit
        self._hits = None
        self._chits = None

    @property
    def hits(self):
        if self._hits is None:
            self._hits = [_SelList(int(h), self._hit) for h in self.n_hit]
        return self._hits

    @property
    def chits(self):
        if self._chits is None:
            self._chits = [_SelList(int(h), self._hit) for h in self.n_chit]
        return self._chits


def pair_block_runtime() -> bool:
    """Whether the pair-end block path's host code loads: the native
    runtime and the pair formatter (``native/pe_format.py``, compiled at
    first use; a failed build says so on stderr)."""
    from .. import native
    from ..native import pe_format
    return native.get_lib() is not None and pe_format.get_lib() is not None


class PairDeviceEngine:
    """Batch PE aligner: one ``pair_program`` per window on the block path
    (the single-device engine), two SE dispatches + K6 per window on the
    per-pair path (any engine, the mesh engines of ``parallel`` included:
    ``se_engine``)."""

    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param,
                 device: torch.device | str = "cuda",
                 se_engine: DeviceEngine | None = None):
        if param.RRBS_flag:
            raise EngineUnsupported("device PE: RRBS runs on the host engine")
        # -S 0 (the reference default) is handled like the SE engine does:
        # the sequential rand_r draws fire only for a multi-hit pair
        # (pairs.cpp:235) or an unpaired mate with >1 best hits
        # (pairs.cpp:258,271) — those pairs replay on the exact host engine;
        # draw-free pairs stay on the device and consume nothing
        self.param = param
        self.se = (se_engine if se_engine is not None
                   else DeviceEngine(genome, index, param, device=device))
        self.pair_host = PairHostEngine(self.se.host)   # exact replay path
        self.K = PAIR_HITS_K
        self.MS = self.se._maxseg
        self.n_replayed = 0
        self.n_mate_filtered = 0      # pairs with a filtered mate
        # each of those pairs under the first of HOST_CAUSES that holds
        self.host_causes = dict.fromkeys(HOST_CAUSES, 0)
        # block path: seconds in the replays, the filtered-mate pairs and
        # the MateState syncs between them (emit_block)
        self.t_host = 0.0
        # the persistent context buffers of each mate's SingleAlign (the
        # reference's _mapseq, align.h:132) for the native formatter
        self._mapseq = (np.zeros(256, np.uint8), np.zeros(256, np.uint8))
        # a -p/--nprocs range's record of the context bytes it prints from
        # slots it has not written yet (parallel/carry.py), None otherwise
        self.carry = None

    def _chains(self) -> tuple[str, str]:
        """Each mate's chains: both under -n 1, else forward for mate 1
        and rc for mate 2 (pair_device.py:319, :832-833)."""
        return ("b", "b") if self.param.chains else ("f", "r")

    def _cfg(self, readset: int, nw: int = FIXELEMENT):
        return self.se._cfg(self._chains()[readset - 1], nw=nw)._replace(
            pe=True, hits_k=self.K, min_ins=self.param.min_insert,
            max_ins=self.param.max_insert)

    def supports_pair_blocks(self) -> bool:
        """Every output of this engine (SAM or BSP, -R, trimming) runs on
        the native block path on the single-device engine, when the native
        runtime and the pair formatter load (``pair_block_runtime``); the
        mesh engines (which override ``_dispatch``) use the per-pair path,
        each mate dispatching through the SE engine."""
        return (type(self.se)._dispatch is DeviceEngine._dispatch
                and pair_block_runtime())

    # -- dispatch core ---------------------------------------------------------

    def _pair_join(self, cfg, rows_a, rows_b, in_a, in_b) -> np.ndarray:
        """K6 on host full rows: uploads them to the engine's device and
        returns the (n, 11) J_* rows."""
        dev = self.se.device
        host = [np.ascontiguousarray(x) for x in (rows_a, rows_b, in_a, in_b)]
        with obs.span("engine.dispatch"):
            with obs.span("engine.h2d", cpu=False,
                          nbytes=sum(x.nbytes for x in host)):
                t = [torch.from_numpy(x).to(dev) for x in host]
            with obs.span("engine.launch", rows=len(rows_a), cpu=False):
                out = kernels.pair_join(cfg, *t)
        return self.se._collect([out])[0]

    def _align_join(self, rows_in_a, rows_in_b, cfg_a, cfg_b):
        """Two-phase dispatch over both mates' dispatch rows, then K6 on the
        collected full rows (the per-pair path).

        Phase 1 enumerates RANK 0 ONLY: the reference's step-0 pairing
        sweeps exactly the hits its cheapest segments discovered
        (pairs.cpp:163-172 breaks at the first step with a pair), so a
        complete rank-0 enumeration fully determines every i*==0 pair —
        the winning set, count, sweep order AND the mates' hit lists as the
        reference's formatter sees them.  Pairs without a step-0 pair
        re-dispatch ONCE at full rank, exactly bin-packed by the rank-0
        round's full-rank totals.

        Returns (rows_a, rows_b, jrows)."""
        se = self.se
        MS, K = self.MS, self.K
        n = rows_in_a.shape[0]
        width = 2 * MS + N_EXTRAS + 2 * K
        rows_a = np.zeros((n, width), dtype=np.int32)
        rows_b = np.zeros((n, width), dtype=np.int32)
        okp = np.zeros(n, dtype=bool)
        ftot = np.zeros(n, dtype=np.int64)

        def collect_pair(sel, ra_, rb_, into_ok):
            okb = (ra_[:, 2 * MS + X_OK] != 0) & \
                  (rb_[:, 2 * MS + X_OK] != 0)
            # per-dispatch capacity must hold BOTH mates' enumerations
            ftot[sel] = np.maximum(ra_[:, 2 * MS + X_FTOT],
                                   rb_[:, 2 * MS + X_FTOT])
            rows_a[sel[okb]] = ra_[okb]
            rows_b[sel[okb]] = rb_[okb]
            into_ok[sel[okb]] = True

        def dispatch_all(spans, rank, into_ok):
            ranks = np.full(n, rank, dtype=np.int32)
            pend = []
            with obs.span("engine.dispatch"):
                for sel, cap in spans:
                    for cfg, rows in ((cfg_a, rows_in_a),
                                      (cfg_b, rows_in_b)):
                        pend.append(se._dispatch(
                            cfg, se._window_rows(rows, sel, ranks), cap))
                        se.n_dispatched += 1
            arrs = se._collect(pend)
            for k, (sel, _) in enumerate(spans):
                collect_pair(sel, arrs[2 * k], arrs[2 * k + 1], into_ok)

        def replay(ks):
            rows_a[ks] = 0
            rows_a[ks, 2 * MS + X_REPLAY] = 1    # -> J_FLAGS replay_a
            rows_b[ks] = 0

        def join(sel):
            return self._pair_join(cfg_a, rows_a[sel], rows_b[sel],
                                   rows_in_a[sel], rows_in_b[sel])

        # --- phase 1: rank-0 windows at the small capacity ------------------
        dispatch_all([(np.arange(i, min(i + se.B, n), dtype=np.int64),
                       se.CANDS) for i in range(0, n, se.B)], 0, okp)
        jrows = join(np.arange(n))
        commit = okp & ((jrows[:, J_PAIR] & 31) == 1)   # i* == 0: exact

        # --- phase 2: full rank for the rest, exactly bin-packed -----------
        redo = np.nonzero(~commit)[0]
        cap_max = min(se.CANDS_BIG, (1 << 27) - 1)
        replay(redo[ftot[redo] >= cap_max])
        rem = redo[ftot[redo] < cap_max]
        if len(rem):
            ok2 = np.zeros(n, dtype=bool)
            dispatch_all([(rem[a0: b0], cap) for a0, b0, cap in pack_spans(
                ftot[rem], se.B, se.CANDS, se.CANDS_BIG)], MS - 1, ok2)
            replay(rem[~ok2[rem]])               # defensive
        if len(redo):
            jrows[redo] = join(redo)
        return rows_a, rows_b, jrows

    def _dispatch_pair(self, cfg_a, cfg_b, rows_a, rows_b, cap: int,
                       counts: bool = False):
        """Enqueue ``pair_program`` on two (m <= B, 2nw+4) windows; returns
        the device (m, 11) J_* rows, with both mates' (m, 2*maxseg) count
        columns after them under ``counts``."""
        se = self.se
        with obs.span("engine.h2d", nbytes=rows_a.nbytes + rows_b.nbytes,
                      cpu=False):
            da = torch.from_numpy(rows_a).to(se.device)
            db = torch.from_numpy(rows_b).to(se.device)
        with obs.span("engine.launch", rows=len(rows_a), cpu=False):
            out = kernels.pair_program(cfg_a, cfg_b, cap, se.tables, da, db,
                                       counts=counts)
        se.n_dispatched += 1
        return out

    def _align_join_fused(self, rows_in_a, rows_in_b, cfg_a, cfg_b,
                          counts: bool = False):
        """Two-phase dispatch of ``pair_program``: phase 1 at rank 0
        (enqueued here; commits every i*==0 pair), phase 2 full-rank
        bin-packed for the rest.  Returns finish() -> (n, 11) J_* rows,
        under ``counts`` followed by each mate's per-level counts from the
        phase that decided the pair (phase 1's for an i* == 0 commit)."""
        se = self.se
        MS = self.MS
        n = rows_in_a.shape[0]
        jrows = np.zeros((n, JN_COLS + (4 * MS if counts else 0)),
                         dtype=np.int32)

        def dispatch(sel, cap, rank):
            ranks = np.full(n, rank, dtype=np.int32)
            return sel, self._dispatch_pair(
                cfg_a, cfg_b, se._window_rows(rows_in_a, sel, ranks),
                se._window_rows(rows_in_b, sel, ranks), cap, counts)

        with obs.span("engine.dispatch"):
            pend1 = [dispatch(np.arange(i, min(i + se.B, n), dtype=np.int64),
                              se.CANDS, 0)
                     for i in range(0, n, se.B)]

        def collect(pend):
            arrs = se._collect([o for _, o in pend])
            with obs.span("engine.commit"):
                for (sel, _), arr in zip(pend, arrs):
                    jrows[sel] = arr

        def finish():
            collect(pend1)
            with obs.span("engine.commit"):
                ok = (jrows[:, J_FLAGS] >> 2) & 1
                paired = jrows[:, J_PAIR] & 31
                commit = (ok == 1) & (paired == 1)      # i* == 0: exact
                ftot = jrows[:, J_FTOT].astype(np.int64)
                rem = np.nonzero(~commit)[0]
                cap_max = min(se.CANDS_BIG, (1 << 27) - 1)
                too_big = rem[ftot[rem] >= cap_max]
                jrows[too_big] = 0
                jrows[too_big, J_FLAGS] = 1             # replay
                rem = rem[ftot[rem] < cap_max]
            if len(rem):
                with obs.span("engine.dispatch"):
                    pend2 = [dispatch(rem[a0: b0], cap, MS - 1)
                             for a0, b0, cap in pack_spans(
                                 ftot[rem], se.B, se.CANDS, se.CANDS_BIG)]
                collect(pend2)
                bad = rem[((jrows[rem, J_FLAGS] >> 2) & 1) == 0]
                jrows[bad] = 0
                jrows[bad, J_FLAGS] = 1             # replay (defensive)
            return jrows

        return finish

    def _replay_cause(self, jrows, risk):
        """Per pair, the index in ``HOST_CAUSES`` of the first reason its
        exact output needs the sequential host engine, 0 for none: a
        mate's K4 replay bit (bucket cap, more than K hits), a pairhits
        bucket at max_num_hits or a capacity overflow ('device'), stale
        seed-schedule reads ('stale'), -r 0 multi-pairs past step 0, whose
        fallback hit lists froze at step i* ('multi'), and under -S 0
        every pair whose output consumes a sequential rand_r draw
        ('draw')."""
        p = self.param
        flags = jrows[:, J_FLAGS]
        paired = jrows[:, J_PAIR] & 31
        cnt = (jrows[:, J_PAIR] >> 5) & 2047
        # written from the last cause to the first: the first that holds
        # is the one left
        code = HOST_CAUSES.index
        cause = np.zeros(len(jrows), dtype=np.int8)
        if p.randseed == 0:
            fnd_a = (jrows[:, J_MATE_A] & 1) != 0
            fnd_b = (jrows[:, J_MATE_B] & 1) != 0
            ss_a = (jrows[:, J_MATE_A] >> 6) & 1023
            ss_b = (jrows[:, J_MATE_B] >> 6) & 1023
            cause[((paired > 0) & (cnt > 1))
                  | ((paired == 0) & ((fnd_a & (ss_a != 1))
                                      | (fnd_b & (ss_b != 1))))] = \
                code("draw")
        if p.report_repeat_hits == 0:
            cause[(paired > 1) & (cnt > 1)] = code("multi")
        cause[risk] = code("stale")
        cause[((flags & 3) != 0) | (((flags >> 3) & 1) != 0)] = \
            code("device")
        return cause

    @staticmethod
    def _prow_from_jrows(jrows):
        """Decode compact join rows into the native formatter's 22-col
        prow layout: paired, cnt, chain, na, nb, insert, a_chr, a_loc,
        b_chr, b_loc, then per mate found, ii, ssum, chain, chrp, wloc."""
        j = jrows
        pairw = j[:, J_PAIR]
        ma, mb = j[:, J_MATE_A], j[:, J_MATE_B]
        return np.stack([
            pairw & 31, (pairw >> 5) & 2047, (pairw >> 16) & 1,
            (pairw >> 17) & 15, (pairw >> 21) & 15, j[:, J_INS],
            j[:, J_CHRS] & 0xFFFF, j[:, J_ALOC],
            (j[:, J_CHRS] >> 16) & 0xFFFF, j[:, J_BLOC],
            ma & 1, (ma >> 2) & 15, (ma >> 6) & 1023, (ma >> 1) & 1,
            (ma >> 16) & 0xFFFF, j[:, J_WLOC_A],
            mb & 1, (mb >> 2) & 15, (mb >> 6) & 1023, (mb >> 1) & 1,
            (mb >> 16) & 0xFFFF, j[:, J_WLOC_B],
        ], axis=1).astype(np.int32)

    # -- per-pair path ---------------------------------------------------------

    def _host_pair(self, ra: Read, rb: Read, fa: bool, fb: bool,
                   bud_a: int, bud_b: int) -> PairResult:
        """PairHostEngine.align_pair (pairs.cpp:198-217) on a pair this
        engine has already filtered.  FilterReads trims in place, so a
        second pass could trim again (an adapter-like tail left by the
        first cut, the -z quality rescale); bsmap_tpu's device engine runs
        it twice on replayed pairs, the reference and its host engine
        once."""
        ph = self.pair_host
        if not fa and not fb:
            return ph._run_pair(ra, rb, bud_a, bud_b)
        return PairResult(
            paired=0, pairhits=[],
            res_a=(SEResult(filtered=True) if fa
                   else ph.single.run_align(ra, bud_a, ph.state_a)),
            res_b=(SEResult(filtered=True) if fb
                   else ph.single.run_align(rb, bud_b, ph.state_b)),
            filtered_a=fa, filtered_b=fb)

    def align_batch(self, batch_a: list[Read], batch_b: list[Read]):
        p = self.param
        se = self.se
        n0 = len(batch_a)
        results: list = [None] * n0

        filt_a = np.zeros(n0, dtype=bool)
        filt_b = np.zeros(n0, dtype=bool)
        buds_a0 = np.zeros(n0, dtype=np.int32)
        buds_b0 = np.zeros(n0, dtype=np.int32)
        for i, (ra, rb) in enumerate(zip(batch_a, batch_b)):
            fa, ba = filter_read(ra, p)
            fb, bb = filter_read(rb, p)
            fix_pair_read_name(ra, rb, p)
            filt_a[i], filt_b[i] = fa, fb
            buds_a0[i], buds_b0[i] = ba, bb

        live = ~(filt_a | filt_b)
        live_pos = np.nonzero(live)[0]
        n = len(live_pos)
        MS = self.MS

        if n:
            idxs = [int(i) for i in live_pos]
            arrs_a = se._pack_host(batch_a, idxs, buds_a0[live_pos])
            arrs_b = se._pack_host(batch_b, idxs, buds_b0[live_pos])
            ca, ga, la, ba_, _, ridx_a = arrs_a
            cb, gb, lb, bb_, _, ridx_b = arrs_b
            if p.randseed == 0:
                # draw-dependent pairs replay below; j = 0 % 1 for the rest
                rand_a = np.zeros(n, dtype=np.uint32)
                rand_b = np.zeros(n, dtype=np.uint32)
            else:
                rand_a = myrand_hash(ridx_a, p.randseed)
                rand_b = myrand_hash(ridx_b, p.randseed)
            rows_in_a = _pack_inputs(ca, ga, la, ba_, rand_a,
                                     np.full(n, MS - 1, np.int32))
            rows_in_b = _pack_inputs(cb, gb, lb, bb_, rand_b,
                                     np.full(n, MS - 1, np.int32))
            cfg_a, cfg_b = self._cfg(1), self._cfg(2)
            risk = se._stale_risk(la, ba_) | se._stale_risk(lb, bb_)
            rows_a, rows_b, jrows = self._align_join(rows_in_a, rows_in_b,
                                                     cfg_a, cfg_b)
            cause = self._replay_cause(jrows, risk)
            replay_flag = cause != 0
            prow = self._prow_from_jrows(jrows)
        else:
            replay_flag = np.zeros(0, dtype=bool)
            la = lb = None
            rows_a = rows_b = np.zeros((0, 1), dtype=np.int32)

        # --- in-order assembly with exact dual MateState maintenance --------
        # All host-path pairs (replays, and pairs with a filtered mate whose
        # surviving mate runs SE-style: pairs.cpp:206-212) must mutate the
        # per-mate states in BATCH order; device spans in between are synced
        # lazily before any host pair that may read stale state.
        st_a, st_b = self.pair_host.state_a, self.pair_host.state_b
        read_a = lambda t: batch_a[int(live_pos[t])]  # noqa: E731
        read_b = lambda t: batch_b[int(live_pos[t])]  # noqa: E731
        live_row = np.full(n0, -1, dtype=np.int64)
        live_row[live_pos] = np.arange(n)

        mode_a, mode_b = self._chains()

        def sync_to(cursor: int, t: int) -> int:
            se._sync_state_span(read_a, cursor, t,
                                rows_a[:, 2 * MS + X_SOFF],
                                rows_a[:, 2 * MS + X_COFF], la,
                                replay_flag, mode_a, state=st_a)
            se._sync_state_span(read_b, cursor, t,
                                rows_b[:, 2 * MS + X_SOFF],
                                rows_b[:, 2 * MS + X_COFF], lb,
                                replay_flag, mode_b, state=st_b)
            return t

        cursor = 0
        next_live = 0
        for i in range(n0):
            t = int(live_row[i])
            if t >= 0:
                next_live = t + 1
                if not replay_flag[t]:
                    continue
                if risk[t]:
                    cursor = sync_to(cursor, t) + 1
                self.n_replayed += 1
                self.host_causes[HOST_CAUSES[cause[t]]] += 1
            else:
                # filtered-mate pair: the surviving mate's run_align may
                # read schedule state -> sync the preceding device span
                cursor = sync_to(cursor, next_live)
                self.n_mate_filtered += 1
                self.host_causes["filtered_mate"] += 1
            results[i] = self._host_pair(batch_a[i], batch_b[i], filt_a[i],
                                         filt_b[i], int(buds_a0[i]),
                                         int(buds_b0[i]))
        if n:
            sync_to(cursor, n)

        for t in range(n):
            if replay_flag[t]:
                continue
            i = int(live_pos[t])
            # prow layout: see _prow_from_jrows
            pr = [int(x) for x in prow[t]]
            paired, cnt, chain, na, nb, ins = pr[:6]
            pairhits: list = [[] for _ in range(2 * MAXSNPS + 1)]
            if paired:
                ph = PairHit(chain=chain, na=na, nb=nb, insert=ins,
                             a=(pr[6], pr[7]), b=(pr[8], pr[9]))
                # the winning bucket is the selected pair's total na + nb
                pairhits[na + nb] = _SelList(cnt, ph)
            hit_a, hit_b = (pr[14], pr[15]), (pr[20], pr[21])
            results[i] = PairResult(
                paired=paired, pairhits=pairhits,
                res_a=PairSEView(rows_a[t], MS, int(buds_a0[i]), hit_a),
                res_b=PairSEView(rows_b[t], MS, int(buds_b0[i]), hit_b),
                filtered_a=False, filtered_b=False)
        return results

    def format_batch(self, batch_a, batch_b, fmt):
        """Same contract as pair_pipeline.HostPairBatch.format_batch."""
        p = self.param
        results = self.align_batch(batch_a, batch_b)
        main_parts: list[str] = []
        unpair_parts: list[str] = []
        for ra, rb, pres in zip(batch_a, batch_b, results):
            fell = 1
            if pres.paired:
                text, fell = fmt.string_align_pair(ra, rb, pres)
                main_parts.append(text)
            if fell == 1 or not pres.paired:
                up = fmt.string_align_unpair(
                    ra, rb, pres.filtered_a, pres.filtered_b, pres)
                (main_parts if p.out_sam else unpair_parts).append(up)
        return "".join(main_parts), "".join(unpair_parts)

    # -- native block path ----------------------------------------------------

    def encode_block_pair(self, blk_a, blk_b):
        """Native FilterReads (under -A/-q), name fix (SAM) and encode of
        one block pair; runs in an encode thread of the block pipeline (the
        native calls release the GIL).  Caches on blk_a and returns (nw,
        rows_a, rows_b, filt_a, filt_b, buds_a, buds_b): each mate's
        dispatch rows, FilterReads verdict and post-trim mismatch budget,
        one row a pair."""
        if blk_a.enc is not None:
            return blk_a.enc
        from .. import native
        p = self.param
        lib = native.get_lib()
        if len(blk_b) != len(blk_a):
            raise ValueError("PE block length mismatch")
        if p.out_sam:                       # FixPairReadName: SAM only
            bad = native.fix_pair_names(lib, blk_a.buf, blk_a.rec,
                                        blk_b.buf, blk_b.rec)
            if bad >= 0:
                raise ValueError("Paired reads name not match:\n"
                                 f"{blk_a.name(bad)}\n{blk_b.name(bad)}")
        infos = [filter_block(p, blk) for blk in (blk_a, blk_b)]
        max_len = max(int(blk_a.rec[:, 3].max()),
                      int(blk_b.rec[:, 3].max())) if len(blk_a) else 0
        nw = 7 if min(max_len, p.max_readlen) <= 112 else FIXELEMENT
        rows, filt, buds = [], [], []
        for blk, info in zip((blk_a, blk_b), infos):
            r = native.encode_block_words(lib, blk.buf, blk.rec, p.alphabet,
                                          REG_ALPHABET, nw)
            if info is None:        # FilterReads' length and N checks
                ln = r[:, 2 * nw].astype(np.int64)
                filt.append((ln < p.min_read_size)
                            | (r[:, 2 * nw + 3] > p.max_ns))
                buds.append(((p.max_snp_num + 1) * (ln - 1)
                             // np.maximum(ln, 1)).astype(np.int32))
            else:
                filt.append(info[:, 0] != 0)
                buds.append(info[:, 1].copy())
            rows.append(r)
        blk_a.enc = (nw, *rows, *filt, *buds)
        return blk_a.enc

    def block_pair_rows(self, blk_a, blk_b):
        """Dispatch rows of one block pair's live pairs (neither mate
        filtered): (nw, live, live_pos, rows_a, rows_b), each (n, 2nw+4)
        int32 with the post-trim budgets and selection hashes filled in
        and the maxrank column 0."""
        p = self.param
        nw, rows_a0, rows_b0, fa, fb, buds_a, buds_b = \
            self.encode_block_pair(blk_a, blk_b)
        live = ~(fa | fb)
        live_pos = np.nonzero(live)[0]
        rows = []
        for r, buds, blk in ((rows_a0, buds_a, blk_a),
                             (rows_b0, buds_b, blk_b)):
            r = r[live_pos]
            r[:, 2 * nw + 1] = buds[live_pos]
            r[:, 2 * nw + 2] = (0 if p.randseed == 0 else myrand_hash(
                blk.indices[live_pos].astype(np.uint64), p.randseed).astype(
                np.uint32).view(np.int32))
            r[:, 2 * nw + 3] = 0
            rows.append(r)
        return nw, live, live_pos, rows[0], rows[1]

    def align_block_pair(self, blk_a, blk_b):
        """Encode one pair of ReadBlocks and ENQUEUE the phase-1 (rank-0)
        dispatches; returns collect() -> the aligned block for
        ``emit_block``.  The block pipeline calls collect() for block N
        only after block N+1's phase 1 is on the device, so phase 2, the
        replay flags and the formatting overlap kernel time.  Under BSP
        the mates' per-level counts come back with the J rows."""
        with obs.span("engine.align", rows=len(blk_a)):
            se = self.se
            counts = not self.param.out_sam
            with obs.span("engine.rows"):
                nw, live, live_pos, rows_in_a, rows_in_b = \
                    self.block_pair_rows(blk_a, blk_b)
                n = len(live_pos)
                la = rows_in_a[:, 2 * nw].astype(np.int64)
                lb = rows_in_b[:, 2 * nw].astype(np.int64)
                risk = (se._stale_risk(la, rows_in_a[:, 2 * nw + 1])
                        | se._stale_risk(lb, rows_in_b[:, 2 * nw + 1]))
            fin = (self._align_join_fused(rows_in_a, rows_in_b,
                                          self._cfg(1, nw), self._cfg(2, nw),
                                          counts)
                   if n else None)

            def collect():
                with obs.span("engine.finish", rows=len(blk_a)):
                    if n:
                        jr = fin()
                        cause = self._replay_cause(jr, risk)
                        prow_live = self._prow_from_jrows(jr)
                        counts_live = jr[:, JN_COLS:]
                    else:
                        cause = np.zeros(0, dtype=np.int8)
                        prow_live = np.zeros((0, 22), dtype=np.int32)
                        counts_live = np.zeros((0, 4 * self.MS),
                                               dtype=np.int32)
                return (blk_a, blk_b, live, live_pos, la, lb, risk, cause,
                        prow_live, counts_live)

            return collect

    def _host_row(self, ra: Read, rb: Read, pres: PairResult, fmt, row,
                  counts) -> None:
        """Fill the formatter row (and, under BSP, each mate's per-level
        counts) of a pair the host engine aligned: string_align_pair's and
        string_align_unpair's selections (output/pair_sam.py), whose rand_r
        draws (-S 0) are taken here in pair order."""
        p = self.param
        MS = self.MS
        if counts is not None:
            for k, res in enumerate((pres.res_a, pres.res_b)):
                if not res.filtered:
                    base = 2 * MS * k
                    counts[base: base + 2 * MS: 2] = res.n_hit[:MS]
                    counts[base + 1: base + 2 * MS: 2] = res.n_chit[:MS]
        if pres.paired:
            for t in range(2 * p.max_snp_num + 1):   # pairs.cpp:229
                cnt = len(pres.pairhits[t])
                if cnt == 0:
                    continue
                if cnt == 1 or p.report_repeat_hits == 1:
                    j = (0 if cnt == 1 else
                         myrand(ra.index, p.randseed, fmt.rand_r) % cnt)
                    ph = pres.pairhits[t][j]
                    row[:P_FND_A] = (pres.paired, cnt, ph.chain, ph.na,
                                     ph.nb, ph.insert, *ph.a, *ph.b)
                    return
                break                 # more than one pair under -r 0
        for k, (rd, res) in enumerate(((ra, pres.res_a), (rb, pres.res_b))):
            if res.filtered:
                continue
            m = lev = 0
            for lev in range(res.read_max_snp_num + 1):
                m = int(res.n_hit[lev] + res.n_chit[lev])
                if m > 0:
                    break
            if m == 0:
                continue
            idx = myrand(rd.index, p.randseed, fmt.rand_r) % m if m > 1 else 0
            nh = int(res.n_hit[lev])
            hit = res.hits[lev][idx] if idx < nh else res.chits[lev][idx - nh]
            base = P_FND_A if k == 0 else P_FND_B
            row[base: base + 6] = (1, lev, m, int(idx >= nh), *hit)

    def emit_block(self, fmt, aligned) -> tuple[bytes, bytes]:
        """The output of one collected block: (main bytes, BSP's -2 bytes,
        empty under SAM).  The pairs the host engine runs (replays, and
        pairs with a filtered mate, aligned with the native filter's reads
        and verdicts) go in pair order with MateState sync (the J_* rows
        carry no start offsets: the sync recomputes them), each synthesized
        into a formatter row; then one native call formats every pair, so
        the context buffers advance in one place and in pair order."""
        (blk_a, blk_b, live, live_pos, la, lb, risk, cause,
         prow_live, counts_live) = aligned
        replay_flag = cause != 0
        from ..native import pe_format
        p = self.param
        se = self.se
        MS = self.MS
        _nw, _ra, _rb, filt_a, filt_b, buds_a, buds_b = blk_a.enc
        n_all = len(blk_a)
        n = len(live_pos)
        st_a, st_b = self.pair_host.state_a, self.pair_host.state_b
        read_a = lambda t: blk_a.read_obj(int(live_pos[t]))  # noqa: E731
        read_b = lambda t: blk_b.read_obj(int(live_pos[t]))  # noqa: E731

        mode_a, mode_b = self._chains()

        def sync_to(cursor: int, t: int) -> int:
            se._sync_state_span(read_a, cursor, t, None, None, la,
                                replay_flag, mode_a, state=st_a)
            se._sync_state_span(read_b, cursor, t, None, None, lb,
                                replay_flag, mode_b, state=st_b)
            return t

        prow = np.zeros((n_all, P_NCOL), dtype=np.int32)
        prow[:, P_FLT_A] = filt_a
        prow[:, P_FLT_B] = filt_b
        counts = (None if p.out_sam
                  else np.zeros((n_all, 4 * MS), dtype=np.int32))
        host = ~live
        if n:
            prow[live_pos, :22] = prow_live
            if counts is not None:
                counts[live_pos] = counts_live
            host[live_pos[replay_flag]] = True
        lcum = np.concatenate([[0], np.cumsum(live)])
        hosts = np.nonzero(host)[0]
        cursor = 0
        t0 = _time.perf_counter()
        with obs.span("host.route", rows=len(hosts)):
            for i in hosts:
                i = int(i)
                t = int(lcum[i])          # live row of this pair (if live)
                if live[i]:
                    if risk[t]:
                        cursor = sync_to(cursor, t) + 1
                    self.n_replayed += 1
                    self.host_causes[HOST_CAUSES[cause[t]]] += 1
                else:
                    cursor = sync_to(cursor, t)
                    self.n_mate_filtered += 1
                    self.host_causes["filtered_mate"] += 1
                with obs.span("host.align", cpu=False):
                    ra, rb = blk_a.read_obj(i), blk_b.read_obj(i)
                    pres = self._host_pair(ra, rb, bool(filt_a[i]),
                                           bool(filt_b[i]), int(buds_a[i]),
                                           int(buds_b[i]))
                with obs.span("host.select", cpu=False):
                    prow[i, :P_FLT_A] = 0
                    self._host_row(ra, rb, pres, fmt, prow[i],
                                   None if counts is None else counts[i])
            if n:
                sync_to(cursor, n)
        self.t_host += _time.perf_counter() - t0
        un = p.useful_nt[:4].encode("latin1")
        with obs.span("format", rows=n_all):
            main, unpair, (npair, na_, nb_) = pe_format.format_pair_block(
                pe_format.get_lib(), blk_a.buf, blk_a.rec, blk_b.buf,
                blk_b.rec, prow,
                None if counts is None else counts[:, :2 * MS],
                None if counts is None else counts[:, 2 * MS:], MS, buds_a,
                buds_b, se._chrname_buf, se._chrname_off, REV_CHAR, p,
                blk_a.synth_qual, blk_b.synth_qual, se.genome.refcat,
                se._anchors_i64, un, *self._mapseq, carry=self.carry)
        fmt.n_aligned_pairs += npair
        fmt.n_aligned_a += na_
        fmt.n_aligned_b += nb_
        return main, unpair
