"""The device kernels of the SE and PE alignment programs, each in two forms.

``bsmap_tpu``'s device work is one jitted XLA program per configuration
(``_align_fused_kernel``, bsmap_tpu/engine/device_engine.py:1172, and
``_pair_fused_kernel``, bsmap_tpu/engine/pair_device.py:258).  Here their
stages are hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by
``_build.py``, bound with ctypes):

  K1 ``fixed_schedule``     fixed-schedule stage 1 (``_fixed_schedule_impl``)
  K2 ``exact_schedule``     exact seed schedule (``_schedule_impl``), also the
                            totals-only probe pass and the RRBS schedule
  K3 ``verify_candidates``  candidate layout scan, entry fetch + bisulfite
                            mismatch count, coordinates, dedup cascade,
                            the RRBS fragment filter
  K4 ``reduce_reads``       per-read early exit, counts, replay bits,
                            selection, lean or full result rows, PE hit
                            compaction
  K5 ``rc_words``           reverse-complement chain rows (``_rc_words``)
  K6 ``pair_join``          the K x K pair join + unpaired picks
                            (``_device_pair_join``)
  K7 ``merge_shards``       the index-sharded per-read reduce over every
                            region shard's candidates in global discovery
                            order (the ``shard_axis`` collectives of
                            ``_verify_impl`` and ``_index_sharded_call``)

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
its plain-torch twin (``*_plain``) for CPU tensors only.  The twins are the
CPU tests' link to the JAX programs and the kernels' oracle on the card: the
JAX int32/uint32 arithmetic is emulated in int64 with an explicit
``& 0xFFFFFFFF`` wherever it wraps, logical shifts and a SWAR popcount.
Every wrapper counts its launches in ``<wrapper>.launches``.

A program runs one chain or both (``cfg.chains_mode``: 'f' forward, 'r'
reverse complement, 'b' both, the -n 1 all-four-strands mode).  The rc
chain's words are K5's output: dispatch rows of the same layout.  Under 'r'
they stand in for the forward rows; under 'b' the kernels take them beside
the forward rows (``rows_rc``), and K1/K2 lay the slots of both chains out
in JAX's discovery order (rank, chain, phase), NB = maxseg * nch * I per
read.  K3 reads each candidate's chain from its slot and writes it into
the info word (``INFO_CHAIN``), which K4 reads back for the counts, the
selection and the hit list.  Under ``cfg.rrbs`` (single-end) K2 looks up
each slot's tag class in the tag-partitioned index (the rc chain's probes
shifted by len % S, its classes counted from the read's other end), K3
fetches chromosome-local entries and marks the candidates inside a
digestion fragment of valid length, and K4 runs every segment and binds
the fragment filter to forward-chain hits.

``index_sharded_program`` is the region-sharded program (``cfg.shards``
= D): each shard's table (``bsmap_tpu_torch.parallel.index_sharded``)
holds its region's entries and per-bucket LOCAL counts in the unsharded
layout, so K1 runs on it unchanged and K2 reads the schedule costs from
the replicated GLOBAL counts ``gcnt``; K3 runs per shard and marks
candidates whose dedup key lies in another shard's region
(``INFO_CORNER``); K7 ranks all shards' candidates of a read in global
discovery order (per slot: Watson entries of shards 0..D-1, then Crick
entries of shards D-1..0) and writes the merged full rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
SATLIM = 1 << 30          # saturating candidate scan (device_engine.py:91)
BIGLEVEL = 99
FTOT_CLAMP = 1 << 27
# dedup hash multipliers (device_engine.py:832-834)
DEDUP_MULS = ((0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35),
              (0x27D4EB2F, 0x165667B1, 0x9E3779B1),
              (0xC2B2AE35, 0x27D4EB2F, 0x85EBCA6B))
# per-candidate info word written by K3 and read by K4
INFO_ELIGIBLE, INFO_UNRESOLVED, INFO_FIRST = 1, 2, 4
INFO_WMM_SHIFT, INFO_RANK_SHIFT = 3, 11
INFO_FRAG = 1 << 16       # RRBS: eligible and inside a valid fragment
INFO_CHAIN_SHIFT = 17     # the candidate's chain: 0 forward, 1 rc
INFO_CORNER = 1 << 18     # index-sharded: eligible, dedup key in another
                          # shard's region (device_engine.py:852-864)
# kernel limits (csrc/common.cuh); MAX_K keeps the pair join's combo index
# in the 8 low bits of its sort key (pair_device.py:136-141)
MAX_MS, MAX_S, MAX_I, MAX_NW, MAX_P, MAX_K = 16, 16, 16, 10, 160, 16
MAX_SHARDS = 16
N_EXTRAS = 17
(X_FOUND, X_II, X_SSUM, X_CHAIN, X_CHRP, X_WLOC, X_H00F, X_H00C, X_H00W,
 X_REPLAY, X_TOTAL, X_SOFF, X_COFF, X_OK, X_BIG, X_RESOLVED,
 X_FTOT) = range(N_EXTRAS)
JN_COLS = 11              # pair join rows (pair_device.py:63-70)
BIGJ = 0x3FFFFFFF


class Slots(NamedTuple):
    """Stage-1 slot tensors, (m, NB) int32 in (rank, chain, phase) discovery
    order, plus the per-read schedule facts."""

    h: torch.Tensor
    off0: torch.Tensor
    off3: torch.Tensor
    wcnt: torch.Tensor
    cnt: torch.Tensor
    s_off: torch.Tensor       # (m,) forward chain's start offset, c_off the
    c_off: torch.Tensor       # rc chain's (0 for an absent chain, fixed, RRBS)
    ftot_rank: torch.Tensor   # (m, maxseg) per-rank cumulative totals


class Cands(NamedTuple):
    """K3 output.  ``starts`` is the (m*NB + 1,) saturating exclusive scan
    of the slot counts with the total last; the other four are (CANDS,)
    per-candidate words.  Entries past the live candidates are zero except
    index CANDS-1, which always holds what the JAX program computes there
    (its selection falls back to that index for reads with no pick)."""

    starts: torch.Tensor
    rid: torch.Tensor
    chrp: torch.Tensor
    wloc: torch.Tensor
    info: torch.Tensor


# ---------------------------------------------------------------------------
# int32/uint32 emulation helpers (int64 tensors)
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the uint32 value."""
    return x.to(torch.int64) & M32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int64 holding the int32 value of its low 32 bits."""
    return ((x & M32) ^ 0x80000000) - 0x80000000


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) without int64 overflow."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _unpack(rows: torch.Tensor):
    """(m, 2nw+4) int32 dispatch rows -> unsigned words and scalars (int64),
    the layout of ``_unpack_inputs`` (device_engine.py:1161)."""
    nw = (rows.shape[1] - 4) // 2
    r = rows.to(torch.int64)
    qw = r[:, :nw] & M32
    rw = r[:, nw: 2 * nw] & M32
    return (nw, qw, rw, r[:, 2 * nw], r[:, 2 * nw + 1],
            r[:, 2 * nw + 2] & M32, r[:, 2 * nw + 3])


def _seedseg(cfg, lens, buds):
    s = torch.minimum(_floordiv(lens - cfg.I + 1, cfg.S), buds + 1)
    return s.clamp(0, cfg.maxseg)


def _seeds(qw: torch.Tensor, pos: np.ndarray, S: int) -> torch.Tensor:
    """``_seed_array_w`` (device_engine.py:266): base-3 T->C-collapsed seed
    value at read offsets ``pos`` from the 2-bit packed words."""
    m, nw = qw.shape
    dev = qw.device
    qwp = torch.cat([qw, torch.zeros((m, 1), dtype=torch.int64, device=dev)],
                    dim=1)
    pos = np.asarray(pos, dtype=np.int64)
    ka = torch.as_tensor(np.minimum(pos >> 4, nw), device=dev)
    kb = torch.as_tensor(np.minimum((pos >> 4) + 1, nw), device=dev)
    zz = torch.as_tensor((pos & 15) * 2, device=dev)[None, :]
    a = qwp[:, ka]
    b = qwp[:, kb]
    w = torch.where(zz == 0, a, ((a << zz) | (b >> (32 - zz))) & M32)
    t = w & (w >> 1) & 0x55555555
    cw = w ^ (t << 1)
    acc = torch.zeros((m, len(pos)), dtype=torch.int64, device=dev)
    for j in range(S):
        acc = acc * 3 + ((cw >> (2 * (15 - j))) & 3)
    return acc


def _rank_totals(cfg, cnt, seedseg, maxrank):
    """Per-rank cumulative clamped totals over both chains' slots and the
    maxrank-masked counts (device_engine.py:425-437 and :649-664); int32
    sums wrap."""
    m = cnt.shape[0]
    MS, NB = cfg.maxseg, cfg.NB
    slot_rank = torch.arange(NB, device=cnt.device) // (NB // MS)
    cnt_full = torch.where(slot_rank[None, :] < seedseg[:, None], cnt, 0)
    cnt_cl = torch.clamp(cnt_full & M32, max=FTOT_CLAMP)
    per_rank = _wrap32(cnt_cl.reshape(m, MS, NB // MS).sum(dim=2))
    ftot = torch.clamp(_wrap32(torch.cumsum(per_rank, dim=1)),
                       max=FTOT_CLAMP)
    cnt = torch.where(slot_rank[None, :] <= maxrank[:, None], cnt_full, 0)
    return cnt, ftot


def _i32(*ts):
    return [t.to(torch.int32) for t in ts]


def _chain_rows(cfg, rows, rows_rc) -> list:
    """(dispatch rows, is the rc chain) of each chain of the program: the
    given rows alone for 'f' and 'r' (K5's rows under 'r'), the forward
    rows and K5's ``rows_rc`` for 'b'."""
    if (cfg.chains_mode == "b") != (rows_rc is not None):
        raise ValueError("rows_rc comes with chains_mode 'b' and only then")
    if cfg.chains_mode == "b":
        return [(rows, False), (rows_rc, True)]
    return [(rows, cfg.chains_mode == "r")]


def _interleave(per_chain, m: int) -> torch.Tensor:
    """(m, maxseg, I) slot tensors of each chain -> (m, NB) in (rank,
    chain, phase) order."""
    return torch.stack(per_chain, dim=2).reshape(m, -1)


def _fixed_probe_offsets(cfg) -> np.ndarray:
    """Static pigeonhole probe offsets in natural (segment, phase) order:
    a = ceil((n*S + i) / I) * I (param.cpp:85-93), k = a - i."""
    S, I = cfg.S, cfg.I
    return np.array([-(-(n * S + i) // I) * I - i
                     for n in range(cfg.maxseg) for i in range(I)],
                    dtype=np.int64)


# ---------------------------------------------------------------------------
# K1: fixed-schedule stage 1
# ---------------------------------------------------------------------------

def fixed_schedule_plain(cfg, rows, kmer_tab, rows_rc=None) -> Slots:
    """Plain twin of K1 (``_fixed_schedule_impl`` + the fixed branch of
    ``_schedule_impl``, device_engine.py:350-439): each chain probes the
    same static offsets in its own words and orders its own segments by a
    stable sort of their costs."""
    _nw, _qw, _rw, lens, buds, _rand, maxrank = _unpack(rows)
    m = rows.shape[0]
    dev = rows.device
    S, MS, I = cfg.S, cfg.maxseg, cfg.I
    k_nat = _fixed_probe_offsets(cfg)
    kt = torch.as_tensor(k_nat, device=dev).reshape(1, MS, 1, I)
    kr = torch.stack([kmer_tab[_seeds(_unpack(r)[1], k_nat, S)].to(
        torch.int64).reshape(m, MS, I, 4) for r, _ in
        _chain_rows(cfg, rows, rows_rc)], dim=2)            # (m, MS, nch, I, 4)
    nch = kr.shape[2]
    fresh = kt <= (lens - S)[:, None, None, None]
    cnt_nat = torch.where(fresh, kr[..., 1], 0)
    seg_cost = _wrap32(cnt_nat.sum(dim=3))                   # (m, MS, nch)
    order = torch.argsort(seg_cost, dim=1, stable=True)
    idx = order[..., None].expand(m, MS, nch, I)

    def permute(nat):
        return nat.expand(m, MS, nch, I).gather(1, idx).reshape(m, -1)

    cnt, ftot = _rank_totals(cfg, permute(cnt_nat), _seedseg(cfg, lens, buds),
                             maxrank)
    zero = torch.zeros(m, dtype=torch.int32, device=dev)
    return Slots(*_i32(permute(-kt), permute(kr[..., 0]), permute(kr[..., 3]),
                       permute(kr[..., 2]), cnt), zero, zero,
                 ftot.to(torch.int32))


# ---------------------------------------------------------------------------
# K2: exact seed schedule
# ---------------------------------------------------------------------------

def _gcnt_given(cfg, gcnt) -> None:
    if bool(cfg.shards) != (gcnt is not None):
        raise ValueError("the global counts gcnt come with cfg.shards and "
                         "only then")


def exact_schedule_plain(cfg, rows, kmer_tab, prof_a, probe: bool = False,
                         tag_off=None, rows_rc=None, gcnt=None) -> Slots:
    """Plain twin of K2: one ``chain_schedule`` + ``slot_desc`` per chain,
    interleaved in (rank, chain, phase) order, and the per-rank totals of
    ``_schedule_impl`` (device_engine.py:445-672).  ``s_off`` is the
    forward chain's chosen start offset and ``c_off`` the rc chain's, 0 for
    an absent chain.  Under ``cfg.rrbs`` the slots index ``tag_off``.
    Under ``cfg.shards`` the schedule costs are the global bucket totals
    ``gcnt`` (column 1 of the JAX shard table, :448-463) and the slots take
    the shard's local counts from ``kmer_tab`` (column 4, :630-632)."""
    _gcnt_given(cfg, gcnt)
    _nw, _qw, _rw, lens, buds, _rand, maxrank = _unpack(rows)
    m = rows.shape[0]
    S, P = cfg.S, cfg.P
    seedseg = _seedseg(cfg, lens, buds)
    pa = prof_a.to(torch.int64)
    descs, offs = [], []
    for r, is_rc in _chain_rows(cfg, rows, rows_rc):
        sarr = _seeds(_unpack(r)[1], np.arange(P), S)          # (m, P)
        rows_p = kmer_tab[sarr].to(torch.int64)                # (m, P, 4)
        if cfg.rrbs:
            descs.append(_rrbs_desc(cfg, sarr, rows_p[..., 1], lens, seedseg,
                                    pa, tag_off, is_rc))
            offs.append(torch.zeros_like(lens))
            continue
        cost = rows_p[..., 1] if gcnt is None else \
            gcnt[sarr].to(torch.int64)
        start, order, s_off = _exact_order(cfg, cost, lens, seedseg)
        descs.append(_exact_desc(cfg, start, order, rows_p, lens, pa))
        offs.append(s_off)
    h, off0, off3, wcnt, cnt = (_interleave([d[k] for d in descs], m)
                                for k in range(5))
    cnt, ftot = _rank_totals(cfg, cnt, seedseg, maxrank)
    zero = torch.zeros_like(lens)
    s_off = zero if cfg.chains_mode == "r" else offs[0]
    c_off = zero if cfg.chains_mode == "f" else offs[-1]
    return Slots(*_i32(h, off0, off3, wcnt, cnt, s_off, c_off, ftot))


def _exact_order(cfg, cntp, lens, seedseg):
    """``chain_schedule`` (device_engine.py:479-550) of one chain: the
    first-minimum start offset, the zig-zag refinement and the stable
    signed-cost segment order.  Cost sums wrap as uint32 like the
    reference's bit32_t.  Returns (start (m, MS), order (m, MS), s_off)."""
    m = cntp.shape[0]
    dev = cntp.device
    S, I, P, MS = cfg.S, cfg.I, cfg.P, cfg.maxseg
    cost = torch.where(cntp > 0, cntp + 2, 0) & M32
    WLEN = MS * S + I
    L = min(P, WLEN)
    cost_p = torch.zeros((m, WLEN + 1), dtype=torch.int64, device=dev)
    cost_p[:, 1: L + 1] = cost[:, :L]
    cs = torch.cumsum(cost_p, dim=1)
    Ws = (cs[:, I:] - cs[:, :-I]) & M32
    T = Ws[:, : MS * S].reshape(m, MS, S)

    max_off = torch.remainder(lens - I + 1, S)
    n_i = torch.arange(MS, device=dev)
    off_i = torch.arange(S, device=dev)
    seg_mask = n_i[None, :] < seedseg[:, None]
    tot = torch.where(seg_mask[:, :, None], T, 0).sum(dim=1) & M32
    tot_m = torch.where(off_i[None, :] < max_off[:, None], tot, M32)
    s_off = torch.where(max_off > 0, torch.argmin(tot_m, dim=1), 0)

    start = s_off[:, None].expand(m, MS).clone()
    ar = torch.arange(m, device=dev)
    for it in range(MS):
        half = it // 2
        ptr = (torch.full_like(seedseg, half) if it % 2 == 0
               else seedseg - 1 - half)
        active = it < seedseg
        ptr_c = ptr.clamp(0, MS - 1)
        prev = start.gather(1, (ptr_c - 1).clamp(0, MS - 1)[:, None])[:, 0]
        nxt = start.gather(1, (ptr_c + 1).clamp(0, MS - 1)[:, None])[:, 0]
        costs = T[ar, ptr_c]                                 # (m, S)
        lo = torch.where(ptr_c == 0, 0, prev)
        hi = torch.where(ptr_c == seedseg - 1, max_off, nxt)
        rng_ok = (off_i[None, :] >= lo[:, None]) & \
            (off_i[None, :] <= hi[:, None])
        best = torch.argmin(torch.where(rng_ok, costs, M32), dim=1)
        onehot = (n_i[None, :] == ptr_c[:, None]) & active[:, None]
        start = torch.where(onehot, best[:, None], start)
    cost_n = T.gather(2, start[:, :, None])[..., 0]          # (m, MS)
    key = torch.where(seg_mask, cost_n ^ 0x80000000, M32)
    return start, torch.argsort(key, dim=1, stable=True), s_off


def _exact_desc(cfg, start, order, rows_p, lens, pa):
    """``slot_desc`` (device_engine.py:574-632) of one WGBS chain: the
    (m, maxseg, I) slot rows (h, off0, off3, wcnt, fresh count) in (rank,
    phase) order, kmer_tab rows at the chosen positions."""
    m = start.shape[0]
    S, I, P, MS = cfg.S, cfg.I, cfg.P, cfg.maxseg
    phase = torch.arange(I, device=start.device)[None, None, :]
    mode = order[:, :, None]
    a = pa.reshape(-1)[mode * I + phase]                     # (m, MS, I)
    st = start.gather(1, order)[:, :, None]
    k = a + st - phase
    k_c = k.clamp(0, P - 1).reshape(m, MS * I)
    fresh = (k >= 0) & (k <= (lens - S)[:, None, None])
    rs = rows_p.gather(1, k_c[:, :, None].expand(m, MS * I, 4)).reshape(
        m, MS, I, 4)
    return (-a + phase - st, rs[..., 0], rs[..., 3], rs[..., 2],
            torch.where(fresh, rs[..., 1], 0))


def _rrbs_desc(cfg, sarr, cntp, lens, seedseg, pa, tag_off, is_rc: bool):
    """The RRBS branches of ``_schedule_impl`` (device_engine.py:464-478,
    :552-562, :596-609) for one chain: one probed position per segment at
    start offset 0 (shifted by len % S on the rc chain, align.cpp:175-251
    ``cseed_offset``), segments ordered by a stable sort of the RAW bucket
    count, and each slot's (segment, strand) class looked up in the
    tag-partitioned offsets: 2*segment forward, 2*(len//S - 1 - segment) + 1
    on the rc chain; the count is 0 unless the probe is fresh and the class
    exists."""
    m = sarr.shape[0]
    dev = sarr.device
    S, I, P, MS = cfg.S, cfg.I, cfg.P, cfg.maxseg
    koff = torch.remainder(lens, S) if is_rc else torch.zeros_like(lens)
    pos = (pa[:MS, 0][None, :] + koff[:, None]).clamp(0, P - 1)
    cost_n = cntp.gather(1, pos) & M32                       # (m, MS)
    seg_mask = torch.arange(MS, device=dev)[None, :] < seedseg[:, None]
    key = torch.where(seg_mask, cost_n ^ 0x80000000, M32)
    mode = torch.argsort(key, dim=1, stable=True)[:, :, None]
    phase = torch.arange(I, device=dev)[None, None, :]
    koff = koff[:, None, None]
    a = pa.reshape(-1)[mode * I + phase]                     # (m, MS, I)
    k = a - phase + koff
    k_c = k.clamp(0, P - 1).reshape(m, MS * I)
    fresh = (k >= 0) & (k <= (lens - S)[:, None, None])
    want = (_floordiv(lens, S)[:, None, None] - 1 - mode) if is_rc else mode
    to = tag_off.to(torch.int64)
    J2 = (to.numel() - 1) // 3 ** S
    sv = sarr.gather(1, k_c).reshape(m, MS, I)
    idx = (sv * J2 + want * 2 + int(is_rc)).clamp(0, to.numel() - 2)
    off = to[idx]
    ok = fresh & (want >= 0) & (want * 2 + 1 < J2)
    zero = torch.zeros_like(off)
    return (-a + phase - koff, off, zero, zero,
            torch.where(ok, to[idx + 1] - off, 0))


# ---------------------------------------------------------------------------
# K3: candidate layout + verify + dedup
# ---------------------------------------------------------------------------

def _eval_cands(cfg, sidx, fid, live, starts, slots, chain_words, lens,
                buds, tables):
    """Per-candidate entry fetch, bisulfite CountMismatch and coordinates
    (device_engine.py:700-812) for candidate indices ``sidx`` owned by slot
    ``fid``; ``chain_words`` holds each chain's (qw, rw).  Returns int64 (rid,
    c, crick, wloc, wmm, rank, chain, eligible)."""
    NB, I, NW, W = cfg.NB, cfg.I, cfg.nw, cfg.W
    rid = fid // NB
    b = fid - rid * NB
    rank = b // (cfg.nch * I)
    # slots run (rank, chain, phase) within a read (device_engine.py:710-715)
    chain = ((b // I) % 2 if cfg.nch == 2
             else torch.full_like(b, int(cfg.chains_mode == "r")))
    e = sidx - starts[fid]
    g_off0 = slots.off0.reshape(-1).to(torch.int64)[fid]
    g_h = slots.h.reshape(-1).to(torch.int64)[fid]
    wl = tables["wlocs"]
    anchors = _u32(tables["anchors"])
    eidx = _wrap32(g_off0 + e).clamp(0, wl.numel() - 1)
    if cfg.rrbs:
        # chr-local entries of the slot's own tag class (:724-738): the
        # tag names the chromosome and strand, no search over anchors
        chrp_t = tables["tags"][eidx].to(torch.int64) & 0xFFFF
        c = chrp_t >> 1
        crick = (chrp_t & 1) == 1
        loc_local = _wrap32(wl[eidx].to(torch.int64) + g_h)
        g = (anchors[c] + loc_local.clamp(min=0)) & M32
    else:
        g_off3 = slots.off3.reshape(-1).to(torch.int64)[fid]
        g_wc = slots.wcnt.reshape(-1).to(torch.int64)[fid]
        crick = e >= g_wc
        cl = tables["clocs"]
        w_entry = _u32(wl[eidx])
        c_entry = _u32(cl[_wrap32(g_off3 + e - g_wc).clamp(0,
                                                          cl.numel() - 1)])
        g = (torch.where(crick, c_entry, w_entry) + g_h) & M32
    wbase = ((g >> 4) + torch.where(crick, W, 0)).clamp(0, 2 * W - NW - 1)
    ks = torch.arange(NW + 1, device=g.device)
    words = _u32(tables["catcat"][wbase[:, None] + ks[None, :]])
    z2 = ((g & 15) * 2)[:, None]
    sref = torch.where(z2 == 0, words[:, :NW],
                       ((words[:, :NW] << z2) | (words[:, 1:] >> (32 - z2)))
                       & M32)
    qw, rw = chain_words[0]
    q, r = qw[rid], rw[rid]
    if cfg.nch == 2:
        # the rc chain's rows for its candidates (device_engine.py:786-790)
        rc = (chain == 1)[:, None]
        q = torch.where(rc, chain_words[1][0][rid], q)
        r = torch.where(rc, chain_words[1][1][rid], r)
    xc = (((~sref) << 1) | sref | 0x55555555) & M32
    x = ((q & xc) ^ sref) & r
    lanes = (x | (x >> 1)) & 0x55555555
    wmm = _popcount32(lanes).sum(dim=1)
    llen = lens[rid]
    if not cfg.rrbs:
        c = (torch.searchsorted(anchors, g, right=True) - 1).clamp(
            0, cfg.n_chr - 1)
        loc_local = _wrap32(g - anchors[c])
    rcoff = tables["rcoff"].to(torch.int64)[c]
    wloc = _wrap32(torch.where(crick, rcoff - llen - loc_local, loc_local))
    in_bounds = ((wloc >= 0) & (loc_local >= 0)
                 & (_wrap32(wloc + llen) <= tables["sizes"].to(torch.int64)[c]))
    eligible = live & in_bounds & (wmm <= buds[rid])
    return rid, c, crick, wloc, wmm, rank, chain, eligible


def _frag_ok(cfg, c, wloc, llen, tables):
    """The SE RRBS fragment filter (``CCGG_seglen``, device_engine.py:
    866-897, dbseq.cpp:541-567): both binary searches run over the global
    uint32 ``sites`` and are clipped to the chromosome's range; seg_start
    is the floor site (never the last), seg_end the first site at or
    after the next one whose end covers the read (else the last site's
    end), and a chromosome without sites has zl = 0."""
    sites = _u32(tables["sites"])
    so = tables["site_off"].to(torch.int64)
    a_c = _u32(tables["anchors"])[c]
    ns = sites.numel()
    lo_c = so[c]
    nsit = so[c + 1] - lo_c
    key1 = (a_c + wloc.clamp(min=0)) & M32
    left = torch.clamp(torch.searchsorted(sites, key1, right=True) - 1,
                       lo_c, torch.maximum(lo_c + nsit - 2, lo_c))
    seg_start = _wrap32(sites[left.clamp(0, ns - 1)] - a_c)
    right0 = torch.minimum(left + 1, lo_c + nsit - 1)
    key2 = (a_c + _wrap32(wloc + llen - cfg.tail).clamp(min=0)) & M32
    first = torch.searchsorted(sites, key2)
    right = torch.clamp(torch.maximum(right0, first), lo_c,
                        lo_c + (nsit - 1).clamp(min=0))
    seg_end = _wrap32(sites[right.clamp(0, ns - 1)] - a_c + cfg.tail)
    zl = torch.where(nsit > 0, _wrap32(seg_end - seg_start), 0)
    return (zl >= cfg.min_ins) & (zl <= cfg.max_ins)


def dedup_slot(rid, c, wloc, muls, shift: int):
    """Dedup hash-table slot of (read, chr, watson loc) keys
    (device_engine.py:836-839)."""
    m1, m2, m3 = muls
    h = (_mul32(rid, m1) + _mul32(c, m2) + _mul32(wloc & M32, m3)) & M32
    h = h ^ (h >> 16)
    return _mul32(h, 0x9E3779B1) >> shift


def dedup_table_size(cands: int) -> int:
    return 1 << (2 * cands - 1).bit_length()


def _corner(c, wloc, elig, tables, shard: int):
    """Eligible candidates whose dedup key ``anchors[c] + max(wloc, 0)``
    (uint32) lies outside region ``shard`` of the uint32 ``bounds``
    (device_engine.py:859-864): their read replays on the host engine."""
    gkey = (_u32(tables["anchors"])[c] + wloc.clamp(min=0)) & M32
    reg = torch.searchsorted(_u32(tables["bounds"]), gkey, right=True) - 1
    return elig & (reg != shard)


def verify_candidates_plain(cfg, cands: int, rows, slots: Slots,
                            tables, rows_rc=None, shard: int = 0) -> Cands:
    """Plain twin of K3 (``_verify_impl``, device_engine.py:692-849, lean
    and full alike): saturating scan of the B*NB slot counts, candidate ->
    slot map, verify of every live candidate against its chain's words,
    then the 3-table cascaded scatter-min dedup on (rid, chr, wloc), which
    has no chain: a forward and an rc hit at one locus share a key, and
    discovery order decides which claims it.  Each candidate's chain is
    the INFO_CHAIN bit.  Under ``cfg.rrbs`` the fragment filter's verdict
    on each eligible candidate is the INFO_FRAG bit: a filtered hit still
    claims its dedup key, as in the reference.  Under ``cfg.shards`` the
    tables are region ``shard``'s and the INFO_CORNER bit marks
    ``_corner``'s candidates; dedup stays inside the shard."""
    _nw, _qw, _rw, lens, buds, _rand, _mr = _unpack(rows)
    chain_words = [_unpack(r)[1:3] for r, _ in
                   _chain_rows(cfg, rows, rows_rc)]
    dev = rows.device
    cnt = slots.cnt.reshape(-1).to(torch.int64)
    incl = torch.cumsum(torch.clamp(cnt, max=SATLIM), dim=0).clamp(max=SATLIM)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), incl])
    total = int(starts[-1])
    ncand = min(total, cands)
    sidx = torch.arange(ncand, device=dev)
    fid = torch.searchsorted(incl, sidx, right=True)
    live = torch.ones(ncand, dtype=torch.bool, device=dev)
    if ncand < cands:
        # the dead last candidate: the JAX running max hands it the last
        # non-empty slot (slot 0 when there is none)
        nz = torch.nonzero((cnt > 0) & (starts[:-1] < cands))
        last = int(nz[-1, 0]) if len(nz) else 0
        sidx = torch.cat([sidx, torch.tensor([cands - 1], device=dev)])
        fid = torch.cat([fid, torch.tensor([last], device=dev)])
        live = torch.cat([live, torch.zeros(1, dtype=torch.bool,
                                            device=dev)])
    rid, c, crick, wloc, wmm, rank, chain, elig = _eval_cands(
        cfg, sidx, fid, live, starts, slots, chain_words, lens, buds,
        tables)
    frag = (elig & _frag_ok(cfg, c, wloc, lens[rid], tables) if cfg.rrbs
            else torch.zeros_like(elig))
    corner = (_corner(c, wloc, elig, tables, shard) if cfg.shards
              else torch.zeros_like(elig))

    T = dedup_table_size(cands)
    shift = 32 - (T.bit_length() - 1)
    unres = elig.clone()
    first = torch.zeros_like(elig)
    for muls in DEDUP_MULS:
        slot = dedup_slot(rid, c, wloc, muls, shift)
        tbl = torch.full((T,), cands, dtype=torch.int64, device=dev)
        tbl.scatter_reduce_(0, slot[unres], sidx[unres], "amin")
        u = torch.nonzero(unres)[:, 0]
        w = tbl[slot[u]]                  # an unresolved candidate's index
        same = (rid[w] == rid[u]) & (c[w] == c[u]) & (wloc[w] == wloc[u])
        is_me = w == sidx[u]
        first[u[is_me]] = True
        unres[u[is_me | same]] = False

    info = (elig.to(torch.int64) * INFO_ELIGIBLE
            | unres.to(torch.int64) * INFO_UNRESOLVED
            | first.to(torch.int64) * INFO_FIRST
            | frag.to(torch.int64) * INFO_FRAG
            | corner.to(torch.int64) * INFO_CORNER
            | (wmm << INFO_WMM_SHIFT) | (rank << INFO_RANK_SHIFT)
            | (chain << INFO_CHAIN_SHIFT))

    def full(v):
        out = torch.zeros(cands, dtype=torch.int32, device=dev)
        out[sidx] = v.to(torch.int32)
        return out

    return Cands(starts.to(torch.int32), full(rid), full(2 * c + crick),
                 full(wloc), full(info))


# ---------------------------------------------------------------------------
# K4: per-read reduce
# ---------------------------------------------------------------------------

class _Reduced(NamedTuple):
    """``_reduce_core``'s per-read results (int64 / bool tensors)."""

    counts: torch.Tensor      # (m, maxseg, 2) accepted hits per level, chain
    found: torch.Tensor
    ii: torch.Tensor
    ssum: torch.Tensor
    sel_chain: torch.Tensor
    replay: torch.Tensor      # level overflow, dedup, -r 0 tie, > K hits
    resolved: torch.Tensor
    sel: torch.Tensor         # position of the selected hit, -1 for none
    h00: torch.Tensor         # position of the first level-0 forward hit
    hit_cols: list            # [hits_loc, hits_w1], each (m, K), full rows


def _reduce_core(cfg, rows, rid, info, chrp, wloc, rpos) -> _Reduced:
    """The per-read half of ``_verify_impl`` (device_engine.py:899-1101)
    over candidates in discovery order, K4's and K7's common part:
    ``rid``/``info``/``chrp``/``wloc`` per candidate (int64, ``rid``
    ascending), ``rpos[r]`` the position of read r's first candidate.
    SE, ``cfg.pe`` or ``cfg.rrbs``, each candidate on the chain K3 wrote
    into its info word."""
    _nw, _qw, _rw, lens, buds, rand32, maxrank = _unpack(rows)
    m = rows.shape[0]
    dev = rows.device
    MS = cfg.maxseg
    n = rid.shape[0]
    chain = (info >> INFO_CHAIN_SHIFT) & 1
    acc_pre = (info & INFO_FIRST) != 0
    if cfg.rrbs:
        # the fragment filter binds forward-chain hits only (:897)
        acc_pre = acc_pre & (((info & INFO_FRAG) != 0) | (chain != 0))
    dd_fail = (info & INFO_UNRESOLVED) != 0
    wmm = (info >> INFO_WMM_SHIFT) & 0xFF
    rank = (info >> INFO_RANK_SHIFT) & 0x1F

    if cfg.pe or cfg.rrbs:
        # PairAlign runs every segment of both mates (pairs.cpp:163-172);
        # RRBS checks only after all segments (align.cpp:450)
        accepted = acc_pre
        resolved = torch.ones(m, dtype=torch.bool, device=dev)
    else:
        # progressive-sensitivity early exit (align.cpp:445-449)
        lev = torch.where(acc_pre, wmm, BIGLEVEL)
        minw = torch.full((m * MS,), BIGLEVEL, dtype=torch.int64, device=dev)
        minw.scatter_reduce_(0, rid * MS + rank, lev, "amin")
        prefmin = torch.cummin(minw.reshape(m, MS), dim=1).values
        r_i = torch.arange(MS, device=dev)
        stopped = (prefmin <= r_i[None, :]) & (r_i[None, :] <= maxrank[:, None])
        any_stop = stopped.any(dim=1)
        s_star = torch.where(any_stop, torch.argmax(stopped.to(torch.int64),
                                                    dim=1), MS - 1)
        accepted = acc_pre & (rank <= s_star[rid])
        resolved = any_stop | (maxrank >= _seedseg(cfg, lens, buds) - 1)

    # per-level/chain counts; budgets keep wmm below maxseg, the guard only
    # keeps a malformed row inside its own read
    label = torch.where(accepted & (wmm < MS), wmm * 2 + chain, 2 * MS)
    counts = torch.zeros(m * (2 * MS + 1), dtype=torch.int64, device=dev)
    counts.index_add_(0, rid * (2 * MS + 1) + label, torch.ones_like(label))
    counts = counts.reshape(m, 2 * MS + 1)[:, : 2 * MS].reshape(m, MS, 2)
    lev_sums = counts.sum(dim=2)
    found = lev_sums.sum(dim=1) > 0
    ii = torch.argmax((lev_sums > 0).to(torch.int64), dim=1)
    ssum = lev_sums.gather(1, ii[:, None])[:, 0]

    dd = torch.zeros(m, dtype=torch.int64, device=dev)
    dd.scatter_reduce_(0, rid, dd_fail.to(torch.int64), "amax")
    replay = (lev_sums >= cfg.max_num_hits).any(dim=1) | (dd > 0)
    if cfg.report_repeat_hits == 0 and not cfg.pe:
        # the -r 0 second-equal-best abort is SE-only (align.cpp:210)
        replay = replay | (found & (ssum > 1))

    # reproducible multi-hit selection (align.cpp:623-625)
    j = rand32 % torch.clamp(ssum, min=1)
    nfwd = counts[:, :, 0].gather(1, ii[:, None])[:, 0]
    sel_chain = (j >= nfwd).to(torch.int64)
    target = torch.where(sel_chain == 1, j - nfwd, j) + 1
    ind = accepted & (wmm == ii[rid]) & (sel_chain[rid] == chain)
    rs_c = rpos[rid]

    def read_rank(mask):
        """1-based rank of each candidate among its read's ``mask``
        candidates, in discovery order."""
        cs = torch.cumsum(mask.to(torch.int64), dim=0)
        return cs - torch.where(rs_c > 0, cs[(rs_c - 1).clamp(min=0)], 0)

    def first_of(mask):
        out = torch.full((m,), n, dtype=torch.int64, device=dev)
        out.scatter_reduce_(0, rid, torch.where(
            mask, torch.arange(n, device=dev), n), "amin")
        return torch.where(out == n, -1, out)

    sel = first_of(ind & (read_rank(ind) == target[rid]))
    h00 = first_of(accepted & (wmm == 0) & (chain == 0))
    hit_cols = []
    if cfg.hits_k and not cfg.lean:
        # compacted per-read hit list in discovery order (:1069-1101):
        # wloc + (wmm | chain<<4 | rank<<5 | chrp<<9), empty slots 0 / -1
        K = cfg.hits_k
        hrank = read_rank(accepted) - 1
        keep = accepted & (hrank < K)
        slot = rid[keep] * K + hrank[keep]
        hits_loc = torch.zeros(m * K, dtype=torch.int64, device=dev)
        hits_w1 = torch.full((m * K,), -1, dtype=torch.int64, device=dev)
        hits_loc[slot] = wloc[keep]
        hits_w1[slot] = (wmm | (chain << 4) | (rank << 5) | (chrp << 9))[keep]
        nacc = torch.zeros(m, dtype=torch.int64, device=dev)
        nacc.index_add_(0, rid, accepted.to(torch.int64))
        replay = replay | (nacc > K)
        hit_cols = [hits_loc.reshape(m, K), hits_w1.reshape(m, K)]
    return _Reduced(counts, found, ii, ssum, sel_chain, replay, resolved, sel,
                    h00, hit_cols)


def _full_rows(cfg, r: _Reduced, picks, totals, s_off, c_off, ok_all,
               big_any, ftot) -> torch.Tensor:
    """The full result rows: counts, the 17 X_* extras, the hit columns.
    ``picks`` = (sel_chrp, sel_wloc, h00_chrp, h00_wloc)."""
    m = r.found.shape[0]
    b = lambda t: t.to(torch.int64)   # noqa: E731
    sel_chrp, sel_wloc, h00_chrp, h00_wloc = picks
    extras = torch.stack(
        [b(r.found), r.ii, r.ssum, r.sel_chain, sel_chrp, sel_wloc,
         b(r.h00 >= 0), h00_chrp, h00_wloc, b(r.replay), totals, b(s_off),
         b(c_off), b(ok_all), b(big_any), b(r.resolved), ftot], dim=1)
    return torch.cat([r.counts.reshape(m, 2 * cfg.maxseg), extras]
                     + r.hit_cols, dim=1).to(torch.int32)


def reduce_reads_plain(cfg, cands: int, rows, vc: Cands,
                       slots: Slots) -> torch.Tensor:
    """Plain twin of K4: the per-read half of ``_verify_impl`` (unsharded,
    device_engine.py:899-1067 lean rows, :1069-1112 full rows with
    ``cfg.hits_k`` compacted hits) over one program's candidates.  A read
    with no pick takes the values of candidate CANDS-1, as JAX's clamped
    gather does."""
    m = rows.shape[0]
    dev = rows.device
    starts = vc.starts.to(torch.int64)
    ncand = min(int(starts[-1]), cands)
    chrp_all = vc.chrp.to(torch.int64)
    wloc_all = vc.wloc.to(torch.int64)
    rstart = starts[torch.arange(m, device=dev) * cfg.NB]
    r = _reduce_core(cfg, rows, vc.rid.to(torch.int64)[:ncand],
                     vc.info.to(torch.int64)[:ncand], chrp_all[:ncand],
                     wloc_all[:ncand], rstart)
    sel_s = torch.where(r.sel < 0, cands - 1, r.sel)
    h00_s = torch.where(r.h00 < 0, cands - 1, r.h00)
    rend = torch.cat([rstart[1:], starts[-1:]])
    totals = rend - rstart
    ok_all = rend <= cands
    big_any = totals > cands
    ftot = slots.ftot_rank[:, -1].to(torch.int64)
    if cfg.lean:
        multi = r.ssum != 1
        if cfg.fixed:
            multi = multi | (totals >= cfg.max_num_hits)
        w1 = (r.found.to(torch.int64) | (r.sel_chain << 1)
              | (r.replay.to(torch.int64) << 2)
              | (ok_all.to(torch.int64) << 3)
              | (big_any.to(torch.int64) << 4) | (multi.to(torch.int64) << 5)
              | (r.ii << 6) | (chrp_all[sel_s] << 10)
              | (r.resolved.to(torch.int64) << 26))
        return torch.stack([wloc_all[sel_s], _wrap32(w1), ftot],
                           dim=1).to(torch.int32)
    return _full_rows(cfg, r, (chrp_all[sel_s], wloc_all[sel_s],
                               chrp_all[h00_s], wloc_all[h00_s]),
                      totals, slots.s_off, slots.c_off, ok_all, big_any, ftot)


# ---------------------------------------------------------------------------
# K7: index-sharded merging reduce
# ---------------------------------------------------------------------------

def merge_shards_plain(cfg, cands: int, rows, vcs: list,
                       slots: list) -> torch.Tensor:
    """Plain twin of K7: the full rows of ``_index_sharded_call``
    (index_sharded.py:115-142), i.e. the ``shard_axis`` branches of
    ``_verify_impl`` (device_engine.py:689, :911-1038, :1074-1100), from
    each region shard's K3 output ``vcs[d]`` and stage-1 ``slots[d]``.  All
    shards' in-capacity candidates are sorted into global discovery order
    (per slot: Watson entries of shards 0..D-1, then Crick entries of
    shards D-1..0, index_sharded.py:9-14), where K4's reduction holds as it
    is: the early exit's minimum, the counts and the dedup bits over all
    shards (pmin, psum), the pick by global rank (global_rank_of).  A corner
    candidate on any shard raises replay; a read with no pick gets 0s;
    totals sum the shards', ok needs every shard's read end within
    ``cands``, big any shard's total past it; ftot is the largest shard's
    (pmax); the start offsets are shard 0's."""
    _check_merge(cfg, vcs, slots)
    m = rows.shape[0]
    dev = rows.device
    NB, D = cfg.NB, len(vcs)
    r_i = torch.arange(m, device=dev)
    keys, infos, chrps, wlocs = [], [], [], []
    totals = torch.zeros(m, dtype=torch.int64, device=dev)
    ok_all = torch.ones(m, dtype=torch.bool, device=dev)
    big_any = torch.zeros(m, dtype=torch.bool, device=dev)
    for d, vc in enumerate(vcs):
        starts = vc.starts.to(dev, torch.int64)
        n = min(int(starts[-1]), cands)
        sidx = torch.arange(n, device=dev)
        fid = torch.searchsorted(starts[1:], sidx, right=True)
        chrp = vc.chrp.to(dev, torch.int64)[:n]
        crick = chrp & 1
        keys.append(((fid * 2 + crick) * D
                     + torch.where(crick == 1, D - 1 - d, d)) * cands + sidx)
        infos.append(vc.info.to(dev, torch.int64)[:n])
        chrps.append(chrp)
        wlocs.append(vc.wloc.to(dev, torch.int64)[:n])
        rstart, rend = starts[r_i * NB], starts[(r_i + 1) * NB]
        totals = totals + (rend - rstart)
        ok_all = ok_all & (rend <= cands)
        big_any = big_any | (rend - rstart > cands)
    key, order = torch.sort(torch.cat(keys))
    info = torch.cat(infos)[order]
    chrp = torch.cat(chrps)[order]
    wloc = torch.cat(wlocs)[order]
    rid = key // (2 * D * cands) // NB
    r = _reduce_core(cfg, rows, rid, info, chrp, wloc,
                     torch.searchsorted(rid, r_i))
    corner = torch.zeros(m, dtype=torch.int64, device=dev)
    corner.scatter_reduce_(0, rid, (info & INFO_CORNER) // INFO_CORNER,
                           "amax")
    r = r._replace(replay=r.replay | (corner > 0))

    def pick(pos, vals):
        return torch.where(pos < 0, 0, vals[pos.clamp(min=0)]) \
            if len(vals) else torch.zeros_like(pos)

    ftot = torch.stack([s.ftot_rank[:, -1].to(dev, torch.int64)
                        for s in slots]).amax(dim=0)
    return _full_rows(cfg, r, (pick(r.sel, chrp), pick(r.sel, wloc),
                               pick(r.h00, chrp), pick(r.h00, wloc)),
                      _wrap32(totals), slots[0].s_off.to(dev),
                      slots[0].c_off.to(dev), ok_all, big_any, ftot)


# ---------------------------------------------------------------------------
# K5: reverse-complement chain rows
# ---------------------------------------------------------------------------

def _rev_lanes(w: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit lanes of each uint32 word (int64 holding)."""
    w = ((w & 0x33333333) << 2) | ((w >> 2) & 0x33333333)
    w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return ((w << 16) | (w >> 16)) & M32


def _len_mask_words(lens: torch.Tensor, nw: int) -> torch.Tensor:
    """``_len_mask_words`` (device_engine.py:292): lane mask 11 for read
    lanes < len, 00 beyond."""
    j = torch.arange(nw, device=lens.device)[None, :]
    v = torch.clamp(lens[:, None] - 16 * j, 0, 16)
    sh = torch.clamp(2 * (16 - v), max=30)
    return torch.where(v > 0, (M32 << sh) & M32, 0)


def rc_words_plain(cfg, rows) -> torch.Tensor:
    """Plain twin of K5, ``_rc_words`` (device_engine.py:302-347): the
    dispatch rows of the reverse-complement chain.  Per lane complement
    through the static ``cfg.rc`` permutation, lane and word order
    reversed, a funnel shift left by 16*nw - len bases (zero words past
    the end), N lanes forced to ``cfg.rc_n``; the len/budget/rand/maxrank
    columns are copied."""
    nw, qw, rw, lens, *_ = _unpack(rows)
    m = rows.shape[0]
    dev = rows.device
    if tuple(cfg.rc) == (3, 2, 1, 0):
        comp = ~qw & M32
    else:
        comp = torch.zeros_like(qw)
        for v in range(4):
            if cfg.rc[v] == 0:
                continue
            x = qw ^ ((v * 0x55555555) & M32)
            ind = ~(x | (x >> 1)) & 0x55555555
            comp = comp | ind * cfg.rc[v]
    zpad = torch.zeros((m, nw), dtype=torch.int64, device=dev)
    sh = 16 * nw - lens
    z = ((sh & 15) * 2)[:, None]
    idx = (sh >> 4)[:, None] + torch.arange(nw, device=dev)[None, :]

    def word(tab, i):
        """tab[:, i], zero outside the 2nw reversed words"""
        ok = (i >= 0) & (i < 2 * nw)
        return torch.where(ok, tab.gather(1, i.clamp(0, 2 * nw - 1)), 0)

    def funnel(w):
        tab = torch.cat([_rev_lanes(w).flip(1), zpad], dim=1)
        a, b = word(tab, idx), word(tab, idx + 1)
        return torch.where(z == 0, a, ((a << z) | (b >> (32 - z))) & M32)

    cqw0 = funnel(comp)
    crw = funnel(rw)
    npat = (cfg.rc_n * 0x55555555) & M32
    cqw = (cqw0 & crw) | (npat & _len_mask_words(lens, nw) & ~crw & M32)
    out = rows.clone()
    out[:, :nw] = _wrap32(cqw).to(torch.int32)
    out[:, nw: 2 * nw] = _wrap32(crw).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# K6: pair join
# ---------------------------------------------------------------------------

def _hits(rows, MS: int, K: int):
    """The K compacted hits of full rows: (loc, w, chain, rank, chrp,
    valid), int32 shifts (pair_device.py:89-94)."""
    base = 2 * MS + N_EXTRAS
    loc = rows[:, base: base + K]
    w1 = rows[:, base + K: base + 2 * K]
    return (loc, w1 & 15, (w1 >> 4) & 1, (w1 >> 5) & 15, (w1 >> 9) & 0xFFFF,
            w1 >= 0)


def _stable_lexsort(keys, K: int) -> torch.Tensor:
    """(n, K) index order of a stable sort by ``keys`` (primary last,
    ``np.lexsort``'s convention)."""
    order = torch.arange(K, device=keys[0].device).expand(
        keys[0].shape[0], K).contiguous()
    for k in keys:
        _, o = torch.sort(k.gather(1, order), dim=1, stable=True)
        order = order.gather(1, o)
    return order


def pair_join_plain(cfg, rows_a, rows_b, in_a, in_b) -> torch.Tensor:
    """Plain twin of K6, ``_device_pair_join`` (pair_device.py:73-195):
    the K x K GetPairs join (eligibility, winning step i*, winning total,
    reference sweep order, reproducible selection) and each mate's
    sorted-order unpaired pick, packed into (n, 11) J_* rows.  ``rows_*``
    are the mates' full K4 rows, ``in_*`` their dispatch rows (lengths,
    budgets, selection hashes)."""
    MS, K = cfg.maxseg, cfg.hits_k
    n = rows_a.shape[0]
    dev = rows_a.device
    ra, rb = rows_a.to(torch.int64), rows_b.to(torch.int64)
    _, _, _, la, buds_a, rand_a, _ = _unpack(in_a)
    _, _, _, lb, buds_b, rand_b, _ = _unpack(in_b)
    locA, wA, chA, rkA, cpA, vA = _hits(ra, MS, K)
    locB, wB, chB, rkB, cpB, vB = _hits(rb, MS, K)
    aloc, bloc = locA[:, :, None], locB[:, None, :]
    wa, wb = wA[:, :, None], wB[:, None, :]
    mx = torch.maximum(wa, wb)
    pchain = chA[:, :, None]
    chain_ok = (chA[:, :, None] ^ chB[:, None, :]) == 1
    same_chr = cpA[:, :, None] == cpB[:, None, :]
    avail = (rkA[:, :, None] <= mx) & (rkB[:, None, :] <= mx)
    a_end_form = (cpA[:, :, None] & 1) != pchain
    ins = _wrap32(torch.where(a_end_form, aloc + la[:, None, None] - bloc,
                              bloc + lb[:, None, None] - aloc))
    elig = (vA[:, :, None] & vB[:, None, :] & chain_ok & same_chr & avail
            & (wa <= buds_a[:, None, None]) & (wb <= buds_b[:, None, None])
            & (ins >= cfg.min_ins) & (ins <= cfg.max_ins))
    i_star = torch.where(elig, mx, BIGJ).amin(dim=(1, 2))
    paired = i_star < BIGJ
    at_win = elig & (mx == i_star[:, None, None])
    tot = wa + wb
    win_total = torch.where(at_win, tot, BIGJ).amin(dim=(1, 2))
    F = at_win & (tot == win_total[:, None, None])
    cnt = F.sum(dim=(1, 2))
    combo = torch.where(wa == wb, 0,
                        torch.where(wb < wa, 1 + 2 * wb, 2 + 2 * wa))

    def sorted_rank(loc, w, ch, cp, v):
        same = (v[:, :, None] & v[:, None, :]
                & (w[:, :, None] == w[:, None, :])
                & (ch[:, :, None] == ch[:, None, :]))
        less = ((cp[:, None, :] < cp[:, :, None])
                | ((cp[:, None, :] == cp[:, :, None])
                   & (loc[:, None, :] < loc[:, :, None])))
        return (same & less).sum(dim=2)

    raA = sorted_rank(locA, wA, chA, cpA, vA)
    raB = sorted_rank(locB, wB, chB, cpB, vB)
    key = ((((combo << 1) | pchain) << 6 | raA[:, :, None]) << 6) \
        | raB[:, None, :]
    kidx = torch.arange(K * K, device=dev).reshape(1, K, K)
    keyp = torch.where(F, (key << 8) | kidx, BIGJ).reshape(n, K * K)
    keyp, _ = torch.sort(keyp, dim=1)
    j = rand_a % torch.clamp(cnt, min=1)
    sel_kl = keyp.gather(1, j[:, None])[:, 0] & 0xFF
    # JAX clamps out-of-range gather indices (K < 16 with no pair)
    sel_k = torch.clamp(sel_kl // K, max=K - 1)[:, None]
    sel_l = torch.clamp(sel_kl % K, max=K - 1)[:, None]

    def at(t, i):
        return t.gather(1, i)[:, 0]

    s_chain = torch.where(paired, at(chA, sel_k), 0)
    s_ins = torch.where(paired, at(ins.reshape(n, K * K), sel_k * K + sel_l),
                        0)

    def unpaired_sel(loc, w, ch, cp, v, rows, rand):
        ii = rows[:, 2 * MS + X_II]
        ssum = rows[:, 2 * MS + X_SSUM]
        best = v & (w == ii[:, None])
        kbig = 0x7FFFFFFF
        order = _stable_lexsort([torch.where(best, x, kbig)
                                 for x in (loc, cp, ch)], K)
        jj = rand % torch.clamp(ssum, min=1)
        # past the K hits the JAX take_along_axis fills INT32_MIN, which
        # the next gather clamps to hit 0
        sel = torch.where(jj < K, order.gather(
            1, jj.clamp(max=K - 1)[:, None])[:, 0], 0)[:, None]
        fnd = (rows[:, 2 * MS + X_FOUND] != 0).to(torch.int64)
        packed = (fnd | (at(ch, sel) << 1) | (ii << 2)
                  | (torch.clamp(ssum, max=1023) << 6) | (at(cp, sel) << 16))
        return at(loc, sel), packed

    swl_a, pack_a = unpaired_sel(locA, wA, chA, cpA, vA, ra, rand_a)
    swl_b, pack_b = unpaired_sel(locB, wB, chB, cpB, vB, rb, rand_b)
    ok_both = (ra[:, 2 * MS + X_OK] != 0) & (rb[:, 2 * MS + X_OK] != 0)
    flags = ((ra[:, 2 * MS + X_REPLAY] != 0).to(torch.int64)
             | ((rb[:, 2 * MS + X_REPLAY] != 0).to(torch.int64) << 1)
             | (ok_both.to(torch.int64) << 2)
             | ((cnt >= cfg.max_num_hits).to(torch.int64) << 3))
    jpair = (torch.where(paired, i_star + 1, 0)
             | (torch.clamp(cnt, max=2047) << 5) | (s_chain << 16)
             | (at(wA, sel_k) << 17) | (at(wB, sel_l) << 21))
    ftot = torch.maximum(ra[:, 2 * MS + X_FTOT], rb[:, 2 * MS + X_FTOT])
    out = torch.stack([
        at(locA, sel_k), at(locB, sel_l), s_ins, swl_a, swl_b, ftot, jpair,
        at(cpA, sel_k) | (at(cpB, sel_l) << 16), pack_a, pack_b, flags],
        dim=1)
    return _wrap32(out).to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers: kernel for CUDA tensors, twin for CPU tensors
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_MODES = {"f": 0, "r": 1, "b": 2}     # chains_mode as the kernels take it


def _check_cuda(cfg, rows, *tensors) -> None:
    if cfg.chains_mode not in _MODES:
        raise ValueError(f"unknown chains_mode {cfg.chains_mode!r}")
    if cfg.rrbs and cfg.pe:
        raise ValueError("RRBS kernels cover single-end reads only")
    if not (cfg.maxseg <= MAX_MS and cfg.S <= MAX_S and cfg.I <= MAX_I
            and cfg.nw <= MAX_NW and cfg.P <= MAX_P
            and cfg.hits_k <= MAX_K):
        raise ValueError(f"cfg outside the kernels' limits: {cfg}")
    if rows.shape[1] != 2 * cfg.nw + 4:
        raise ValueError(f"rows width {rows.shape[1]} != 2*nw+4")
    for t in (rows,) + tensors:
        if t.device != rows.device or not t.is_contiguous() \
                or t.dtype != torch.int32:
            raise ValueError("kernel inputs must be contiguous int32 "
                             "tensors on one CUDA device")


def _run(t: torch.Tensor, fn, *args) -> int:
    """``fn(*args)`` with ``t``'s CUDA device current: a kernel launches on
    the calling thread's current device, whatever stream it is handed."""
    with torch.cuda.device(t.device):
        return fn(*args)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.int32, device=dev)


def _opt_ptr(on: bool, t) -> ctypes.c_void_p:
    """A table the kernel reads only under a flag: NULL when it is off."""
    return _ptr(t) if on else ctypes.c_void_p(None)


def _rc_rows(cfg, rows, rows_rc) -> list:
    """``rows_rc`` checked against ``cfg`` (as the twins check it), as the
    list of extra tensors for ``_check_cuda``."""
    _chain_rows(cfg, rows, rows_rc)
    if rows_rc is not None and rows_rc.shape != rows.shape:
        raise ValueError("rows_rc must have the shape of rows")
    return [] if rows_rc is None else [rows_rc]


K1_MAX_ROUNDS = 16        # slot rounds K1 holds in registers per lane


def k1_groups(cfg) -> tuple:
    """The group widths (lanes per read, one lane per slot) K1 takes for
    ``cfg``, the default first: 16 (two reads a warp) where a read's NB
    slots fit in 16 lanes, else 32 (a warp a read, lanes looping over the
    slots); the other width second where it holds the slots in at most
    ``K1_MAX_ROUNDS`` rounds."""
    if cfg.NB <= 16:
        return (16, 32)
    return (32, 16) if cfg.NB <= 16 * K1_MAX_ROUNDS else (32,)


def fixed_schedule(cfg, rows, kmer_tab, rows_rc=None,
                   group: int | None = None) -> Slots:
    """K1 (csrc/fixed_schedule.cu) on CUDA tensors, the twin on CPU.
    ``group`` is the kernel's lanes per read (one of ``k1_groups(cfg)``,
    default its first); every width writes the same words."""
    if not rows.is_cuda:
        return fixed_schedule_plain(cfg, rows, kmer_tab, rows_rc)
    from . import _build
    _check_cuda(cfg, rows, kmer_tab, *_rc_rows(cfg, rows, rows_rc))
    g = k1_groups(cfg)[0] if group is None else group
    if g not in k1_groups(cfg):
        raise ValueError(f"K1 takes {k1_groups(cfg)} lanes per read at "
                         f"NB {cfg.NB}, not {g}")
    m, NB, MS = rows.shape[0], cfg.NB, cfg.maxseg
    # one allocation: the five slot tensors, s_off and c_off (the kernel
    # writes their zeros), the per-rank totals
    buf = _empty(rows.device, m * (5 * NB + 2 + MS))
    outs = list(buf[: 5 * m * NB].view(5, m, NB).unbind(0))
    offs = list(buf[5 * m * NB: m * (5 * NB + 2)].view(2, m).unbind(0))
    ftot = buf[m * (5 * NB + 2):].view(m, MS)
    err = _run(
        rows, _build.lib().bsmap_fixed_schedule,
        _ptr(rows), _opt_ptr(rows_rc is not None, rows_rc), m, cfg.nw,
        _ptr(kmer_tab), cfg.S, cfg.I, MS, cfg.nch,
        *[_ptr(o) for o in outs + offs], _ptr(ftot), g, _stream(rows))
    _launched("fixed_schedule", err)
    fixed_schedule.launches += 1
    return Slots(*outs, *offs, ftot)


def k2_groups(cfg) -> tuple:
    """The group widths (lanes per read) K2 takes for ``cfg``, the default
    first.  WGBS: 32 (a warp a read) and 16 (two reads a warp; its arg-min
    lanes are the S <= 16 start offsets), 32 first on one chain and 16
    first on both ('b'), as measured on the H100 (PERF.md section 6).
    RRBS, whose schedule is one probe per segment: the smallest of 4,
    8 and 16 that holds maxseg lanes, and 16."""
    if not cfg.rrbs:
        return (16, 32) if cfg.chains_mode == "b" else (32, 16)
    least = next(g for g in (4, 8, 16) if g >= cfg.maxseg)
    return (least,) if least == 16 else (least, 16)


def exact_schedule(cfg, rows, kmer_tab, prof_a, probe: bool = False,
                   tag_off=None, rows_rc=None, gcnt=None,
                   group: int | None = None) -> Slots:
    """K2 (csrc/exact_schedule.cu) on CUDA tensors, the twin on CPU.  With
    ``probe`` only ``ftot_rank`` is written (the other tensors are left
    uninitialised).  ``cfg.rrbs`` needs the ``tag_off`` table, chains
    mode 'b' K5's ``rows_rc``, ``cfg.shards`` the global counts ``gcnt``.
    ``group`` is the kernel's lanes per read (one of ``k2_groups(cfg)``,
    default its first); every width writes the same words."""
    if not rows.is_cuda:
        return exact_schedule_plain(cfg, rows, kmer_tab, prof_a, probe,
                                    tag_off, rows_rc, gcnt)
    from . import _build
    _gcnt_given(cfg, gcnt)
    _check_cuda(cfg, rows, kmer_tab, prof_a,
                *([tag_off] if cfg.rrbs else []),
                *([gcnt] if cfg.shards else []),
                *_rc_rows(cfg, rows, rows_rc))
    m, NB, MS = rows.shape[0], cfg.NB, cfg.maxseg
    dev = rows.device
    # one allocation per shape: the five slot tensors, the two offsets
    outs = list(_empty(dev, 5, m, NB).unbind(0))
    offs = list(_empty(dev, 2, m).unbind(0))
    ftot = _empty(dev, m, MS)
    err = _run(
        rows, _build.lib().bsmap_exact_schedule,
        _ptr(rows), _opt_ptr(rows_rc is not None, rows_rc), m, cfg.nw,
        _ptr(kmer_tab), _ptr(prof_a), cfg.S, cfg.I, MS, cfg.P,
        _MODES[cfg.chains_mode], int(probe), int(cfg.rrbs),
        _opt_ptr(cfg.rrbs, tag_off), tag_off.numel() if cfg.rrbs else 0,
        _opt_ptr(gcnt is not None, gcnt),
        *[_ptr(o) for o in outs + offs], _ptr(ftot),
        k2_groups(cfg)[0] if group is None else group, _stream(rows))
    _launched("exact_schedule", err)
    exact_schedule.launches += 1
    return Slots(*outs, *offs, ftot)


# K3's scratch ahead of its three dedup tables, in ints: 16 counters and
# 2,048 64-bit partial sums (csrc/verify_candidates.cu BSM_K3_HEAD)
K3_SCRATCH_HEAD = 16 + 2 * 2048
# K3's launch form: 0 = four launches (cooperative scan; verify + insert;
# two fused dedup passes), 1 = one persistent cooperative launch, the
# faster on the H100 in every configuration measured (PERF.md section 6);
# the four-launch form stays as the measurable decomposition (its kernels
# are the scan, verify and dedup parts that chip_smoke.py times by name)
K3_VARIANT = 1


def verify_candidates(cfg, cands: int, rows, slots: Slots,
                      tables, rows_rc=None, shard: int = 0,
                      variant: int | None = None) -> Cands:
    """K3 (csrc/verify_candidates.cu) on CUDA tensors, the twin on CPU.
    ``cfg.shards`` needs region ``shard``'s tables with the ``bounds``.
    ``variant`` picks the kernel's launch form (default ``K3_VARIANT``);
    both write the same words."""
    if not rows.is_cuda:
        return verify_candidates_plain(cfg, cands, rows, slots, tables,
                                       rows_rc, shard)
    from . import _build
    tk = ("catcat", "anchors", "sizes", "rcoff", "wlocs", "clocs")
    rk = (("tags", "sites", "site_off") if cfg.rrbs else ()) + \
        (("bounds",) if cfg.shards else ())
    _check_cuda(cfg, rows, slots.h, slots.off0, slots.off3, slots.wcnt,
                slots.cnt, *[tables[k] for k in tk + rk],
                *_rc_rows(cfg, rows, rows_rc))
    m, NB = rows.shape[0], cfg.NB
    dev = rows.device
    T = dedup_table_size(cands)
    starts = _empty(dev, m * NB + 1)
    scratch = _empty(dev, K3_SCRATCH_HEAD + 3 * T)
    out = list(_empty(dev, 4, cands).unbind(0))
    err = _run(
        rows, _build.lib().bsmap_verify_candidates,
        _ptr(rows), _opt_ptr(rows_rc is not None, rows_rc), m, cfg.nw,
        cfg.maxseg, cfg.I, _MODES[cfg.chains_mode], cands,
        _ptr(slots.h), _ptr(slots.off0), _ptr(slots.off3), _ptr(slots.wcnt),
        _ptr(slots.cnt), _ptr(tables["catcat"]), cfg.W,
        _ptr(tables["anchors"]), cfg.n_chr, _ptr(tables["sizes"]),
        _ptr(tables["rcoff"]), _ptr(tables["wlocs"]),
        tables["wlocs"].numel(), _ptr(tables["clocs"]),
        tables["clocs"].numel(), int(cfg.rrbs),
        *[_opt_ptr(cfg.rrbs, tables.get(k)) for k in
          ("tags", "sites", "site_off")],
        tables["sites"].numel() if cfg.rrbs else 0, cfg.tail, cfg.min_ins,
        cfg.max_ins, shard, _opt_ptr(bool(cfg.shards), tables.get("bounds")),
        cfg.shards + 1 if cfg.shards else 0, T, _ptr(starts), _ptr(scratch),
        *[_ptr(o) for o in out],
        K3_VARIANT if variant is None else variant, _stream(rows))
    _launched("verify_candidates", err)
    verify_candidates.launches += 1
    return Cands(starts, *out)


def reduce_reads(cfg, cands: int, rows, vc: Cands,
                 slots: Slots) -> torch.Tensor:
    """K4 (csrc/reduce_reads.cu) on CUDA tensors, the twin on CPU."""
    if not rows.is_cuda:
        return reduce_reads_plain(cfg, cands, rows, vc, slots)
    from . import _build
    _check_cuda(cfg, rows, vc.starts, vc.chrp, vc.wloc, vc.info,
                slots.ftot_rank, slots.s_off, slots.c_off)
    m, MS = rows.shape[0], cfg.maxseg
    width = 3 if cfg.lean else 2 * MS + N_EXTRAS + 2 * cfg.hits_k
    out = _empty(rows.device, m, width)
    err = _run(
        rows, _build.lib().bsmap_reduce_reads,
        _ptr(rows), m, cfg.nw, MS, cfg.I, cfg.S, cfg.nch, cands,
        _ptr(vc.starts), _ptr(vc.chrp), _ptr(vc.wloc), _ptr(vc.info),
        _ptr(slots.ftot_rank), _ptr(slots.s_off), _ptr(slots.c_off),
        cfg.max_num_hits, cfg.report_repeat_hits, int(cfg.lean),
        int(cfg.fixed), int(cfg.pe), int(cfg.rrbs), cfg.hits_k, _ptr(out),
        _stream(rows))
    _launched("reduce_reads", err)
    reduce_reads.launches += 1
    return out


def rc_words(cfg, rows) -> torch.Tensor:
    """K5 (csrc/rc_words.cu) on CUDA tensors, the twin on CPU."""
    if not rows.is_cuda:
        return rc_words_plain(cfg, rows)
    from . import _build
    _check_cuda(cfg, rows)
    if sorted(cfg.rc) != [0, 1, 2, 3] or not 0 <= cfg.rc_n <= 3:
        raise ValueError(f"not a 2-bit complement permutation: {cfg.rc}")
    out = torch.empty_like(rows)
    err = _run(
        rows, _build.lib().bsmap_rc_words,
        _ptr(rows), rows.shape[0], cfg.nw, *cfg.rc, cfg.rc_n, _ptr(out),
        _stream(rows))
    _launched("rc_words", err)
    rc_words.launches += 1
    return out


def pair_join(cfg, rows_a, rows_b, in_a, in_b) -> torch.Tensor:
    """K6 (csrc/pair_join.cu) on CUDA tensors, the twin on CPU."""
    if not rows_a.is_cuda:
        return pair_join_plain(cfg, rows_a, rows_b, in_a, in_b)
    from . import _build
    _check_cuda(cfg, in_a, in_b, rows_a, rows_b)
    width = 2 * cfg.maxseg + N_EXTRAS + 2 * cfg.hits_k
    n = rows_a.shape[0]
    if not (cfg.hits_k >= 1 and rows_a.shape == rows_b.shape == (n, width)
            and in_a.shape == in_b.shape and in_a.shape[0] == n):
        raise ValueError("pair_join takes both mates' full rows with hits "
                         "and their dispatch rows")
    out = _empty(rows_a.device, n, JN_COLS)
    err = _run(
        rows_a, _build.lib().bsmap_pair_join,
        _ptr(rows_a), _ptr(rows_b), n, cfg.maxseg, cfg.hits_k, _ptr(in_a),
        _ptr(in_b), cfg.nw, cfg.min_ins, cfg.max_ins, cfg.max_num_hits,
        _ptr(out), _stream(rows_a))
    _launched("pair_join", err)
    pair_join.launches += 1
    return out


def _check_merge(cfg, vcs: list, slots: list) -> None:
    if not cfg.shards or cfg.lean or cfg.rrbs or cfg.probe:
        raise ValueError("merge_shards writes the full rows of an "
                         "index-sharded WGBS program")
    if not len(vcs) == len(slots) == cfg.shards <= MAX_SHARDS:
        raise ValueError(f"{len(vcs)} shards' candidates for cfg.shards "
                         f"{cfg.shards} (at most {MAX_SHARDS})")


def merge_shards(cfg, cands: int, rows, vcs: list,
                 slots: list) -> torch.Tensor:
    """K7 (csrc/merge_shards.cu) on CUDA tensors, the twin on CPU.  Each
    shard's K3 output and stage-1 totals are read where they lie, through
    a table of device pointers (the totals as column maxseg-1 of each
    ``ftot_rank``); only a shard on another device is copied to ``rows``'
    device first."""
    if not rows.is_cuda:
        return merge_shards_plain(cfg, cands, rows, vcs, slots)
    from . import _build
    _check_merge(cfg, vcs, slots)
    dev = rows.device

    def here(t):
        return t if t.device == dev else t.to(dev)

    fields = [[here(getattr(v, f)) for v in vcs]
              for f in ("starts", "chrp", "wloc", "info")]
    ftot = [here(s.ftot_rank) for s in slots]
    soff, coff = here(slots[0].s_off), here(slots[0].c_off)
    flat = [t for f in fields for t in f]
    _check_cuda(cfg, rows, *flat, *ftot, soff, coff)
    m, MS = rows.shape[0], cfg.maxseg
    if any(t.shape != (m * cfg.NB + 1,) for t in fields[0]) \
            or any(t.shape != (cands,) for f in fields[1:] for t in f) \
            or any(t.shape != (m, MS) for t in ftot) \
            or soff.shape != (m,) or coff.shape != (m,):
        raise ValueError("candidates of another window or capacity")
    if cfg.shards * cands >= 1 << 31:
        raise ValueError(f"{cfg.shards} shards x {cands} candidates pass "
                         "the kernel's int32 candidate range")
    ptrs = [t.data_ptr() for t in flat] + \
        [t.data_ptr() + 4 * (MS - 1) for t in ftot]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    out = _empty(dev, m, 2 * MS + N_EXTRAS + 2 * cfg.hits_k)
    err = _run(
        rows, _build.lib().bsmap_merge_shards,
        _ptr(rows), m, cfg.nw, MS, cfg.I, cfg.S, cfg.nch, cfg.shards, cands,
        ctypes.cast(table, ctypes.c_void_p), _ptr(soff), _ptr(coff),
        cfg.max_num_hits, cfg.report_repeat_hits, int(cfg.pe), cfg.hits_k,
        _ptr(out), _stream(rows))
    _launched("merge_shards", err)
    merge_shards.launches += 1
    return out


KERNELS = (fixed_schedule, exact_schedule, verify_candidates, reduce_reads,
           rc_words, pair_join, merge_shards)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def chain_inputs(cfg, rows):
    """(rows, rows_rc) as K1-K4 take them for ``cfg``'s chains: K5's rc
    chain rows replace the forward rows under 'r' and join them under 'b'
    (``rows_rc`` is None otherwise)."""
    if cfg.chains_mode == "f":
        return rows, None
    rc = rc_words(cfg, rows)
    return (rc, None) if cfg.chains_mode == "r" else (rows, rc)


def align_program(cfg, cands: int, tables, rows) -> torch.Tensor:
    """The port of ``_align_fused_kernel`` (device_engine.py:1172) on
    (m, 2nw+4) int32 dispatch rows: K5 for the rc chain (its rows replace
    the forward ones under 'r' and join them under 'b'), K1 or K2 (K2 alone
    under ``cfg.probe``, returning the (m, maxseg) per-rank totals; K2 on
    the tag-partitioned tables under ``cfg.rrbs``), then K3 and K4, both
    chains of 'b' in each launch.  ``cands`` is the JAX program's capacity
    (its B rows, padding included), so the ok/overflow bits and the dedup
    table size match its rows."""
    if cfg.shards:
        raise ValueError("a sharded cfg runs index_sharded_program")
    rows, rows_rc = chain_inputs(cfg, rows)
    if cfg.fixed and not cfg.probe:
        slots = fixed_schedule(cfg, rows, tables["kmer_tab"], rows_rc)
    else:
        slots = exact_schedule(cfg, rows, tables["kmer_tab"],
                               tables["prof_a"], probe=cfg.probe,
                               tag_off=tables.get("tag_off"),
                               rows_rc=rows_rc)
    if cfg.probe:
        return slots.ftot_rank
    vc = verify_candidates(cfg, cands, rows, slots, tables, rows_rc)
    return reduce_reads(cfg, cands, rows, vc, slots)


def pair_program(cfg_a, cfg_b, cands: int, tables, rows_a, rows_b,
                 counts: bool = False) -> torch.Tensor:
    """The port of ``_pair_fused_kernel`` (pair_device.py:258): both mates'
    programs (mate 2 on the rc chain, both mates on both chains under -n 1;
    ``cfg.pe`` with ``hits_k`` hits, full rows), then K6 on their rows;
    returns the (n, 11) J_* rows.  With ``counts`` (BSP output, whose lines
    print each mate's per-level hit histogram) each mate's 2*maxseg count
    columns follow, mate 1's then mate 2's.  All launches go to the current
    stream with no host sync between them."""
    full = [align_program(cfg, cands, tables, rows)
            for cfg, rows in ((cfg_a, rows_a), (cfg_b, rows_b))]
    j = pair_join(cfg_a, full[0], full[1], rows_a, rows_b)
    if not counts:
        return j
    w = 2 * cfg_a.maxseg
    return torch.cat([j, full[0][:, :w], full[1][:, :w]], dim=1)


def index_sharded_program(cfg, cands: int, shard_tables: list,
                          rows) -> torch.Tensor:
    """The port of ``_index_sharded_call`` (index_sharded.py:115-142) with
    ``_align_fused_kernel``'s ``bounds`` branches: the same (m, 2nw+4)
    dispatch rows through every region shard (``shard_tables[d]``, on the
    shard's device; ``cfg.shards`` = D), then K7 on shard 0's device, where
    the result lies.  Per device: the rows copied there once, K5 for the rc
    chain once; per shard: K1, or K2 on the global counts ``gcnt``, then K3
    with the shard's corner test.  ``cands`` is the capacity of each shard.
    Under ``cfg.probe`` the result is the elementwise maximum of the
    shards' per-rank totals (the pmax, device_engine.py:1189-1190).  Each
    shard enqueues on its device's current stream, with no synchronisation
    between shards."""
    if cfg.shards != len(shard_tables):
        raise ValueError(f"cfg.shards {cfg.shards} for {len(shard_tables)} "
                         "shard tables")
    placed = {}                 # device -> (rows, (rows, rows_rc) for K1-K3)
    slots, vcs = [], []
    for d, tabs in enumerate(shard_tables):
        dev = tabs["kmer_tab"].device
        if dev not in placed:
            r = rows.to(dev)
            placed[dev] = (r, chain_inputs(cfg, r))
        r, rc = placed[dev][1]
        if cfg.fixed and not cfg.probe:
            s = fixed_schedule(cfg, r, tabs["kmer_tab"], rc)
        else:
            s = exact_schedule(cfg, r, tabs["kmer_tab"], tabs["prof_a"],
                               probe=cfg.probe, rows_rc=rc,
                               gcnt=tabs["gcnt"])
        slots.append(s)
        if not cfg.probe:
            vcs.append(verify_candidates(cfg, cands, r, s, tabs, rc, d))
    rows0 = placed[shard_tables[0]["kmer_tab"].device][0]
    if cfg.probe:
        return torch.stack([s.ftot_rank.to(rows0.device)
                            for s in slots]).amax(dim=0)
    return merge_shards(cfg, cands, rows0, vcs, slots)
