"""Index-sharded alignment (the port of ``bsmap_tpu.parallel.
index_sharded``, ``--engine index-sharded``).

The seed index, the dominant memory consumer, is split by genome region
across the mesh; every shard scans the same (replicated) read window
against its own region:

  * Watson entries are owned by the region of their Watson coordinate,
    Crick entries by the region of their Watson-projected coordinate
    (anchors[c] + rc_off[c] - crick_loc).  Within a bucket, entries ascend
    in coordinate, so each shard holds a contiguous slice of every bucket's
    Watson run and Crick run, and the global discovery order can be
    rebuilt: per slot, Watson entries of shards 0..D-1, then Crick entries
    of shards D-1..0.
  * Each shard's table has the unsharded layout over its own entries
    ([w_off, total, w_cnt, c_off], LOCAL counts); the global bucket totals
    ``gcnt`` are replicated, so every shard computes the same exact seed
    schedule (K2 reads its costs there).
  * ``kernels.index_sharded_program`` runs K1/K2 and K3 per shard and the
    K7 kernel merges: the early exit over all shards, the exact per-level
    histograms, the reproducible pick at its global discovery rank, the
    compacted hit lists.
  * Same-dedup-key candidates are co-located by the region ownership, so
    dedup stays local; a key within one read length of a region boundary
    raises the replay bit (K3's INFO_CORNER) and the read runs on the exact
    host engine.

Memory: a shard's ``kmer_tab`` is 3^S x 16 B (689 MB at -s 16) beside its
entries; ``gcnt`` (3^S x 4 B), the genome words and the small tables go
once on each distinct device.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..engine import kernels
from ..engine.device_engine import (DeviceEngine, EngineUnsupported, _i32,
                                    genome_tables, strand_chunks,
                                    watson_mask)
from ..index import SeedIndex
from ..params import FIXELEMENT, FIXSIZE
from ..reference import PackedGenome
from .mesh import make_mesh


def region_shards(genome: PackedGenome, index: SeedIndex, ndev: int):
    """Split the WGBS CSR index into ndev region shards.

    Returns (bounds[ndev+1] uint32, counts[tk] int64 global bucket totals,
    [(lwc, lcc, wlocs uint32, clocs uint32) per shard]) where lwc/lcc are
    the shard's per-bucket Watson/Crick entry counts and the entries keep
    their in-bucket order.  Two passes over the entries, ``SPLIT_CHUNK`` at
    a time (``strand_chunks``): the first finds each entry's region (one
    byte an entry) and counts the shards' buckets, the second fills each
    shard's entry arrays; no temporary spans the whole index, which at
    human scale holds some 1.56G entries."""
    tk = index.total_kmers
    counts = np.diff(index.offsets).astype(np.int64)
    anchors = genome.anchors[: genome.n_chr].astype(np.uint64)
    rcoff = genome.rc_offsets.astype(np.uint64)
    top = int(anchors[-1]) + int(rcoff[-1]) + FIXSIZE + 1
    bounds = np.linspace(0, top, ndev + 1).astype(np.uint64)
    bounds[0], bounds[-1] = 0, top

    # pass 1: ownership regions -- Watson entries by their coordinate,
    # Crick entries by their Watson-projected one -- and the shards'
    # per-bucket counts
    region = np.empty(int(index.offsets[-1]), dtype=np.uint8)
    lwc = np.zeros((ndev, tk), dtype=np.int64)
    lcc = np.zeros((ndev, tk), dtype=np.int64)
    for lo, locs, b0, nb, wend in strand_chunks(index):
        is_w = watson_mask(lo, nb, wend)
        bucket = np.repeat(np.arange(len(nb), dtype=np.int64), nb)
        wl = locs[is_w].astype(np.uint64)
        cl = locs[~is_w].astype(np.uint64)
        reg_w = np.searchsorted(bounds, wl, side="right") - 1
        ci = np.searchsorted(anchors, cl, side="right") - 1
        y = anchors[ci] + rcoff[ci] - (cl - anchors[ci])
        reg_c = np.searchsorted(bounds, y, side="right") - 1
        reg = region[lo: lo + len(locs)]
        reg[is_w], reg[~is_w] = reg_w, reg_c
        bw, bc = bucket[is_w], bucket[~is_w]
        for d in range(ndev):
            lwc[d, b0: b0 + len(nb)] += np.bincount(bw[reg_w == d],
                                                    minlength=len(nb))
            lcc[d, b0: b0 + len(nb)] += np.bincount(bc[reg_c == d],
                                                    minlength=len(nb))

    # pass 2: each shard's entries, in index order within each strand
    wls = [np.empty(int(lwc[d].sum()), dtype=np.uint32) for d in range(ndev)]
    cls = [np.empty(int(lcc[d].sum()), dtype=np.uint32) for d in range(ndev)]
    at = np.zeros((ndev, 2), dtype=np.int64)
    for lo, locs, _b0, nb, wend in strand_chunks(index):
        is_w = watson_mask(lo, nb, wend)
        reg = region[lo: lo + len(locs)]
        for d in range(ndev):
            mine = reg == d
            for k, (dst, sel) in enumerate(((wls[d], mine & is_w),
                                            (cls[d], mine & ~is_w))):
                part = locs[sel]
                dst[at[d, k]: at[d, k] + len(part)] = part
                at[d, k] += len(part)
    return bounds.astype(np.uint32), counts, [
        (lwc[d], lcc[d], wls[d], cls[d]) for d in range(ndev)]


def shard_kmer_tab(lwc: np.ndarray, lcc: np.ndarray) -> np.ndarray:
    """One shard's (tk, 4) int32 bucket table in the unsharded layout
    [w_off, total, w_cnt, c_off] over its own entries (``bsmap_tpu``'s
    6-column shard rows hold the same numbers in columns 0, 4, 2, 3)."""
    tab = np.empty((len(lwc), 4), dtype=np.int32)
    tab[0, 0] = tab[0, 3] = 0
    np.cumsum(lwc[:-1], out=tab[1:, 0])
    tab[:, 1] = lwc + lcc
    tab[:, 2] = lwc
    np.cumsum(lcc[:-1], out=tab[1:, 3])
    return tab


class IndexShardedEngine(DeviceEngine):
    """DeviceEngine whose seed index is region-sharded across the mesh.

    The base class's orchestration (windowing, capacity escalation, probe
    mode, exact host replay with MateState maintenance, block path) is
    inherited; the table placement, the Cfg and the dispatch differ.
    Capacity (CANDS) is PER SHARD: the ok/big bits are K7's merges.  Full
    rows only: the block path repacks them to lean rows after."""

    def __init__(self, genome: PackedGenome, index: SeedIndex, param,
                 mesh=None):
        if param.RRBS_flag:
            raise EngineUnsupported("index-sharded engine: RRBS uses the "
                                    "single-device or sharded engines")
        self.mesh = list(mesh) if mesh is not None else make_mesh()
        self.ndev = len(self.mesh)
        if not 1 <= self.ndev <= kernels.MAX_SHARDS:
            raise ValueError(f"{self.ndev} index shards (1 to "
                             f"{kernels.MAX_SHARDS})")
        # the base class's capacity tiers are each shard's capacity
        super().__init__(genome, index, param, device=self.mesh[0])

    def _place_tables(self) -> dict:
        """Per shard, its region's bucket table (``shard_kmer_tab``) and
        entries on the shard's device; the replicated tables, the global
        counts ``gcnt`` and the region ``bounds`` once per distinct device.
        Keeps the bounds (uint32) as ``self.bounds``; returns shard 0's
        tables."""
        bounds, counts, shards = region_shards(self.genome, self.index,
                                               self.ndev)
        self.bounds = bounds
        rep = genome_tables(self.genome, self.param)
        rep["gcnt"] = _i32(counts)
        rep["bounds"] = _i32(bounds, np.uint32)
        on_dev = {dev: {k: v.to(dev) for k, v in rep.items()}
                  for dev in dict.fromkeys(self.mesh)}
        one = np.zeros(1, np.uint32)
        self.shard_tables = [
            {**on_dev[dev],
             "kmer_tab": _i32(shard_kmer_tab(lwc, lcc)).to(dev),
             "wlocs": _i32(lw if len(lw) else one, np.uint32).to(dev),
             "clocs": _i32(lc if len(lc) else one, np.uint32).to(dev)}
            for dev, (lwc, lcc, lw, lc) in zip(self.mesh, shards)]
        return self.shard_tables[0]

    def _cfg(self, chains_mode: str, lean: bool = False,
             nw: int = FIXELEMENT):
        # full rows only (the lean layout lacks the fields the replay and
        # state machinery read); the block path repacks to lean after
        return super()._cfg(chains_mode, lean=False, nw=nw)._replace(
            shards=self.ndev)

    def _dispatch(self, cfg, packed, cands: int | None = None):
        cap = self.CANDS if cands is None else cands
        t0 = _time.time()
        out = kernels.index_sharded_program(cfg, cap, self.shard_tables,
                                            torch.from_numpy(packed))
        self.t_call += _time.time() - t0
        return out
