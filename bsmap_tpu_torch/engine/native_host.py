"""The host route's exact WGBS aligner in C++ (``native/host_align.cpp``)
behind the Python host engine's interface.

``NativeHost`` answers ``run_align`` and ``sync_schedule`` as
``HostEngine`` does, ``run_pair`` as ``PairHostEngine._run_pair``, and
``sync_span`` as ``device_engine.sync_state_python``: the same ``SEResult``
and ``PairResult`` objects with their lists in the same order, and the
same ``MateState`` left behind.  The C++ reads the packed
genome, the index and the ``MateState`` buffers by pointer; the call
releases the GIL.  WGBS only: ``create`` returns None under RRBS, or where
the library does not build, and the engines keep the Python host engine.
"""

from __future__ import annotations

import ctypes
import threading
from collections.abc import Sequence

import numpy as np

from ..params import MAXSNPS
from ..readio import Read
from .host_engine import HostEngine, MateState, SEResult
from .pair_host import PairHit, PairResult

NLEV = MAXSNPS + 1
NPAIR = 2 * MAXSNPS + 1


class PairHitRows(Sequence):
    """One pairhits bucket as the C++ left it, (n, 8) rows of chain, na,
    nb, insert, a's (chr, loc), b's (chr, loc); a ``PairHit`` is made for
    the element read."""

    __slots__ = ("_rows",)

    def __init__(self, rows: np.ndarray):
        self._rows = rows

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [self[i] for i in range(*k.indices(len(self)))]
        ch, na, nb, ins, ac, al, bc, bl = self._rows[k].tolist()
        return PairHit(chain=ch, na=na, nb=nb, insert=ins, a=(ac, al),
                       b=(bc, bl))


class _Buffers:
    """One thread's output arrays, sized for the most hits a call can
    leave: a level holds at most max_num_hits + one a step (a level-0 fill
    returns after its hit), a bucket max_num_hits + 1, and one step's
    buckets hold every pair."""

    def __init__(self, cap: int, cap_pairs: int):
        self.hits = (np.empty(2 * cap, np.int64), np.empty(2 * cap, np.int64))
        self.counts = (np.zeros(2 * NLEV, np.int32),
                       np.zeros(2 * NLEV, np.int32))
        self.pairs = np.empty(8 * cap_pairs, np.int64)
        self.pcounts = np.zeros(NPAIR, np.int32)
        self.offs = (np.zeros(2, np.int64), np.zeros(2, np.int64))
        self.flags = np.zeros(1, np.int32)
        self.paired = np.zeros(1, np.int32)
        self.ptr = {k: v.ctypes.data for k, v in (
            ("hits_a", self.hits[0]), ("hits_b", self.hits[1]),
            ("counts_a", self.counts[0]), ("counts_b", self.counts[1]),
            ("pairs", self.pairs), ("pcounts", self.pcounts),
            ("offs_a", self.offs[0]), ("offs_b", self.offs[1]),
            ("flags", self.flags), ("paired", self.paired))}


class NativeHost:
    """``HostEngine``'s WGBS alignment in C++ over ``host``'s genome,
    index and options; ``host`` answers what the C++ does not take (a read
    whose seeds overrun the ``MateState`` buffers)."""

    def __init__(self, host: HostEngine, lib: ctypes.CDLL):
        from ..native.host_align import Ctx
        g, ix, p = host.genome, host.index, host.param
        self.host = host
        self.param = p
        self.lib = lib
        u32 = lambda a: np.ascontiguousarray(a, dtype=np.uint32)  # noqa: E731
        i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)   # noqa: E731
        n_chr = g.n_chr
        arrs = {
            "refcat": u32(g.refcat), "crefcat": u32(g.crefcat),
            "offsets": i64(ix.offsets), "locs": u32(ix.locs),
            "wcounts": np.ascontiguousarray(ix.wcounts, dtype=np.int32),
            "anchors": i64(g.anchors[:n_chr]), "sizes": i64(g.sizes),
            "rc_offsets": i64(g.rc_offsets),
            "alphabet": np.ascontiguousarray(p.alphabet, dtype=np.uint8),
            "rev_alphabet": np.ascontiguousarray(p.rev_alphabet,
                                                 dtype=np.uint8),
            "profile": np.array([[pr.a for pr in row] for row in p.profile],
                                dtype=np.int32),
        }
        self._arrs = arrs           # the Ctx points into these
        self.ctx = Ctx(
            n_words=len(arrs["refcat"]), n_chr=n_chr,
            seed_size=p.seed_size, index_interval=p.index_interval,
            max_num_hits=p.max_num_hits,
            report_repeat_hits=p.report_repeat_hits, pairend=p.pairend,
            chains=p.chains, min_insert=p.min_insert,
            max_insert=p.max_insert,
            **{k: v.ctypes.data for k, v in arrs.items()})
        self._ctx = ctypes.byref(self.ctx)
        per = max(p.max_num_hits, 1)
        self._cap = NLEV * (per + NLEV)
        self._cap_pairs = NLEV * (per + 1)
        self._max_len = MateState.SEEDBUF + p.seed_size - 1
        self._tls = threading.local()
        self._state_addrs: dict[int, tuple] = {}

    @classmethod
    def create(cls, host: HostEngine) -> NativeHost | None:
        """The native aligner over ``host``, or None under RRBS or where
        the library does not build (the Python host engine then runs)."""
        if host.param.RRBS_flag:
            return None
        from ..native import host_align
        lib = host_align.get_lib()
        return None if lib is None else cls(host, lib)

    def _bufs(self) -> _Buffers:
        b = getattr(self._tls, "bufs", None)
        if b is None:
            b = self._tls.bufs = _Buffers(self._cap, self._cap_pairs)
        return b

    def _state_in(self, state: MateState, offs: np.ndarray):
        """``state``'s start offsets into ``offs``; the addresses of its
        seed buffers, taken once a state (they are written in place,
        never replaced; the state is held, so its ``id`` stays its own)."""
        offs[0] = state.seed_start_offset
        offs[1] = state.cseed_start_offset
        hit = self._state_addrs.get(id(state))
        if hit is None:
            if len(self._state_addrs) >= 16:
                self._state_addrs.clear()
            hit = self._state_addrs[id(state)] = (
                state, state.seed_buf.ctypes.data,
                state.cseed_buf.ctypes.data)
        return hit[1], hit[2]

    @staticmethod
    def _state_out(state: MateState, offs: np.ndarray) -> None:
        state.seed_start_offset, state.cseed_start_offset = offs.tolist()

    def _result(self, read: Read, budget: int, hits: np.ndarray,
                counts: np.ndarray, aborted: bool) -> SEResult:
        c = counts.tolist()
        vals = hits[: 2 * sum(c)].tolist()
        flat = list(zip(vals[0::2], vals[1::2]))
        lists = []
        o = 0
        for k in c:
            lists.append(flat[o: o + k])
            o += k
        return SEResult(
            filtered=False, read_max_snp_num=budget,
            seedseg_num=self.param.seedseg_num(len(read.seq), budget),
            hits=lists[:NLEV], chits=lists[NLEV:],
            n_hit=np.array(c[:NLEV], dtype=np.int64),
            n_chit=np.array(c[NLEV:], dtype=np.int64),
            aborted_repeat=aborted)

    def _call_se(self, read: Read, budget: int, state: MateState,
                 sync_only: bool) -> _Buffers:
        b = self._bufs()
        sb, csb = self._state_in(state, b.offs[0])
        rc = self.lib.bsmap_host_align(
            self._ctx, read.seq.encode("latin1"), len(read.seq), budget,
            read.readset, sb, csb, b.ptr["offs_a"], int(sync_only),
            b.ptr["hits_a"], self._cap, b.ptr["counts_a"], b.ptr["flags"])
        self._state_out(state, b.offs[0])
        if rc != 0:
            raise RuntimeError("host_align: hits past their bound")
        return b

    def run_align(self, read: Read, budget: int,
                  state: MateState | None = None) -> SEResult:
        """``HostEngine.run_align``: align a filtered read."""
        state = state or self.host.mate_state
        if len(read.seq) > self._max_len:
            return self.host.run_align(read, budget, state)
        b = self._call_se(read, budget, state, False)
        return self._result(read, budget, b.hits[0], b.counts[0],
                            bool(b.flags[0]))

    def sync_schedule(self, read: Read, budget: int,
                      state: MateState | None = None) -> None:
        """``HostEngine.sync_schedule``: the MateState effects alone."""
        state = state or self.host.mate_state
        if len(read.seq) > self._max_len:
            self.host.sync_schedule(read, budget, state)
            return
        self._call_se(read, budget, state, True)

    def sync_span(self, reads, lo: int, hi: int, lens: np.ndarray,
                  replay_flag: np.ndarray, dev_soff, dev_coff, mode: str,
                  state: MateState) -> bool:
        """``DeviceEngine._sync_state_span`` of live rows [lo, hi) in one
        call, read straight from the arrays of ``reads`` (a
        ``device_engine.BlockReads``: row t is its block's read
        ``live_pos[t]``).  False, with ``state`` untouched, where a read's
        seeds overrun the ``MateState`` buffers: the caller's Python path
        runs then."""
        blk = reads.block
        at = reads.addr
        b = self._bufs()
        sb, csb = self._state_in(state, b.offs[0])
        rc = self.lib.bsmap_sync_span(
            self._ctx, blk.buf, at(blk.rec, np.int64),
            at(reads.live_pos, np.int64) + 8 * lo, at(lens, np.int64) + 8 * lo,
            at(replay_flag, np.uint8) + lo, hi - lo, blk.readset,
            self.param.max_snp_num,
            None if dev_soff is None else at(dev_soff, np.int32) + 4 * lo,
            None if dev_coff is None else at(dev_coff, np.int32) + 4 * lo,
            (mode in ("f", "b")) | 2 * (mode in ("r", "b")), sb, csb,
            b.ptr["offs_a"])
        if rc != 0:
            return False
        self._state_out(state, b.offs[0])
        return True

    def run_pair(self, ra: Read, rb: Read, budget_a: int, budget_b: int,
                 state_a: MateState, state_b: MateState) -> PairResult:
        """``PairHostEngine._run_pair`` with its per-mate states."""
        if max(len(ra.seq), len(rb.seq)) > self._max_len:
            from .pair_host import PairHostEngine
            ph = PairHostEngine(self.host)
            ph.state_a, ph.state_b = state_a, state_b
            return ph._run_pair(ra, rb, budget_a, budget_b)
        b = self._bufs()
        sa, csa = self._state_in(state_a, b.offs[0])
        sb, csb = self._state_in(state_b, b.offs[1])
        rc = self.lib.bsmap_host_align_pair(
            self._ctx,
            ra.seq.encode("latin1"), len(ra.seq), budget_a, ra.readset, sa,
            csa, b.ptr["offs_a"],
            rb.seq.encode("latin1"), len(rb.seq), budget_b, rb.readset, sb,
            csb, b.ptr["offs_b"],
            b.ptr["hits_a"], b.ptr["counts_a"], b.ptr["hits_b"],
            b.ptr["counts_b"], self._cap, b.ptr["pairs"], b.ptr["pcounts"],
            self._cap_pairs, b.ptr["paired"])
        self._state_out(state_a, b.offs[0])
        self._state_out(state_b, b.offs[1])
        if rc != 0:
            raise RuntimeError("host_align: hits past their bound")
        res_a = self._result(ra, budget_a, b.hits[0], b.counts[0], False)
        res_b = self._result(rb, budget_b, b.hits[1], b.counts[1], False)
        pc = b.pcounts.tolist()
        pairhits: list = [[] for _ in range(NPAIR)]
        if any(pc):
            rows = b.pairs[: 8 * sum(pc)].reshape(-1, 8).copy()
            o = 0
            for t, k in enumerate(pc):
                if k:
                    pairhits[t] = PairHitRows(rows[o: o + k])
                    o += k
        return PairResult(paired=int(b.paired[0]), pairhits=pairhits,
                          res_a=res_a, res_b=res_b, filtered_a=False,
                          filtered_b=False)
