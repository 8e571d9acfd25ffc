#!/usr/bin/env python3
"""K7 (``merge_shards``) on the two real windows of ``chip_smoke.py``'s
phase 20, for the checkout at --root (this one by default).

    python3 tools/k7_window_times.py [--root DIR] [--data DIR]

Generates (or finds in --data) phase 5's repeat-heavy data (46.7 Mb, 8%
repeats, 100,000 reads), builds D = 4 region shards on cuda:0 and runs the
index-sharded program of that checkout on the first window twice: the
fixed round at rank 0 on the small tier, and the exact schedule at full
rank on the big tier, on both chain modes ('f', and 'b' for -n 1).  For
each it takes K7's inputs, checks the kernel against its twin, and times
the kernel's own card time (``queued_ms``), the wrapper call's CUDA-event
time and the twin, with the checkout's own ``chip_smoke.py`` helpers, so
two checkouts (a parent and a change) can be compared in one call, in
turns.  Prints the card's name and power limit, then one JSON line.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose K7 is timed")
    ap.add_argument("--data", default=None,
                    help="directory for the generated data and index cache "
                    "(default: a temporary one); reused when it holds them")
    args = ap.parse_args()
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("k7_window_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    data = args.data or tempfile.mkdtemp(prefix="k7_windows_")
    os.makedirs(data, exist_ok=True)
    os.environ["BSMAP_TPU_INDEX_CACHE"] = os.path.join(data, "cache")
    import chip_smoke as cs
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.parallel import IndexShardedEngine
    from bsmap_tpu_torch.reference import load_genome
    from tools.genreads import generate_chr21

    cs.phase_build()
    gpath, rpath = generate_chr21(os.path.join(data, "repeat"),
                                  n_reads=cs.N_REPEAT)
    o = parse_args(["-a", rpath, "-d", gpath, "-o", "x.sam"]
                   + cs.ALIGN_FLAGS)
    genome = load_genome(gpath, o.param)
    eng = IndexShardedEngine(genome, get_index(o, genome), o.param,
                             mesh=[torch.device("cuda", 0)] * cs.N_SHARDS)
    stream = BlockReadStream(rpath, o.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    rows0 = torch.from_numpy(rows_np.copy())              # round 1: rank 0
    rows_np[:, -1] = eng._maxseg - 1
    rowsF = torch.from_numpy(rows_np)                     # full rank
    out = {"root": root}
    real = K.merge_shards
    for mode in ("f", "b"):
        cfg = eng._cfg(mode, nw=nw)
        for case, c, cands, rows in (
                ("fixed", cfg._replace(fixed=True), eng.CANDS, rows0),
                ("exact", cfg, eng.CANDS_BIG, rowsF)):
            seen = []

            def take(*a):
                seen.append(a)
                return real(*a)

            take.launches = 0
            K.merge_shards = take         # K7's inputs, as the program
            try:                          # passes them
                K.index_sharded_program(c, cands, eng.shard_tables, rows)
            finally:
                K.merge_shards = real
            cc, cap, r0, vcs, slots = seen[0]
            want = K.merge_shards_plain(cc, cap, r0, vcs, slots)
            if not torch.equal(K.merge_shards(cc, cap, r0, vcs, slots), want):
                raise AssertionError(f"K7 differs from its twin ('{mode}' "
                                     f"{case})")
            per = (sum(torch.clamp(v.starts[cc.NB::cc.NB].long(), max=cap)
                       - torch.clamp(v.starts[:-1:cc.NB].long(), max=cap)
                       for v in vcs)).double()
            kern = lambda: K.merge_shards(cc, cap, r0, vcs, slots)  # noqa
            plain = lambda: K.merge_shards_plain(cc, cap, r0, vcs,  # noqa
                                                 slots)
            res = {"cands_per_read": [round(float(per.mean()), 2),
                                      int(per.max())],
                   "card_ms": cs.queued_ms(kern)}
            res.update(cs.timed_pair(f"'{mode}' {case} merge_shards", kern,
                                     plain, f"{r0.shape[0]} reads"))
            out[f"{mode} {case}"] = res
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
