"""Multi-host data-parallel launch (first-class -B/-E sharding).

The reference's multi-node story is manual: the user splits the input with
-B/-E and runs N processes (README.txt:83-86, reads.cpp:54-75), with FRESH
per-process aligner state — so its multi-process output differs from a
single-process run on the stale-seed-schedule corner reads.  This module
makes sharding first-class AND byte-exact:

  * ``initialize()`` wires ``jax.distributed`` when a coordinator is given
    (multi-host TPU pods); pure filesystem coordination otherwise (CPU
    tests, single-node multi-process).
  * Each process takes a contiguous read range (computed from a fast native
    count pass), aligns it, and writes ``<out>.shard<k>``; process 0 merges
    the shards in order — identical bytes to a single-process run.
  * ``reconstruct_state()`` rebuilds the aligner's cross-read MateState at
    a range boundary from the *preceding* reads' content (seed-buffer
    last-writer-wins fill + the ReorderSeed offset recompute), so the
    stale-schedule corner reads still match the single-process run —
    something the reference itself does not achieve.
"""

from __future__ import annotations

import os
import time

import numpy as np


def initialize(coordinator: str | None, num_processes: int,
               process_id: int) -> None:
    """torch.distributed bring-up, the counterpart of
    ``jax.distributed.initialize``: with a coordinator (``host:port``) every
    process joins one gloo process group whose TCP store process 0 hosts,
    so process 0 must outlive the others' use of it (the CLI's runners end
    with a barrier and ``destroy_process_group``).  A no-op without a
    coordinator: single-node multi-process runs coordinate via files, and
    the shard merge below needs no collective either way."""
    if coordinator:
        import torch.distributed as tdist
        tdist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                 world_size=num_processes, rank=process_id)


def count_reads(path: str, param) -> int:
    """Fast full-file read count with the native tokenizer (one pass)."""
    from .. import native
    from ..blockio import BlockReadStream
    lib = native.get_lib()
    if lib is None:
        from ..readio import ReadStream
        s = ReadStream(path, param, 0)
        n = 0
        while True:
            b = s.next_batch(50000)
            if not b:
                break
            n += len(b)
        s.close()
        return n
    s = BlockReadStream(path, param, 0, lib)
    n = 0
    while True:
        blk = s.next_block(1 << 18)
        if blk is None:
            break
        n += len(blk)
    s.close()
    return n


def plan_range(total: int, num_processes: int, process_id: int,
               read_start: int = 1, read_end: int | None = None):
    """Contiguous per-process (read_start, read_end) 1-based inclusive range
    within the user's own -B/-E window."""
    lo = read_start
    hi = min(read_end if read_end else total, total)
    n = max(0, hi - lo + 1)
    per = (n + num_processes - 1) // num_processes
    s = lo + process_id * per
    e = min(lo + (process_id + 1) * per - 1, hi)
    return s, e


def _reconstruct_into(host, state, path: str, param, range_start: int,
                      readset: int = 0, window: int = 4096) -> None:
    """Rebuild one MateState exactly as if reads [1, range_start) of the
    given stream had been aligned, from read content alone.

    Buffers are content-pure (last-writer-wins of each read's seed values);
    the chosen start offsets are those of the last read with max_offset > 0,
    computed against the buffer state at ITS point in the stream (a second,
    temporary fill).  The window doubles until it contains such a read (or
    reaches the start of the file)."""
    from ..engine.host_engine import MateState, fill_seed_buffers
    from ..readio import ReadStream
    from ..trim import filter_read

    if range_start <= 1:
        return
    p = param
    S, I = p.seed_size, p.index_interval
    while True:
        w0 = max(1, range_start - window)
        import copy
        p2 = copy.copy(p)
        p2.read_start = w0
        p2.read_end = range_start - 1
        s = ReadStream(path, p2, readset)
        reads = s.next_batch(range_start - w0)
        s.close()
        live = []
        for rd in reads:
            filtered, _ = filter_read(rd, p)
            if not filtered:
                live.append(rd)
        mo = [(len(r.seq) - I + 1) % S for r in live]
        has_offset_read = any(m > 0 for m in mo)
        if has_offset_read or w0 == 1:
            break
        window *= 2

    n = len(live)
    fill_seed_buffers(p, state, lambda k: live[k], 0, n, MateState.SEEDBUF)
    if has_offset_read:
        L = max(k for k in range(n) if mo[k] > 0)
        tmp = MateState()
        fill_seed_buffers(p, tmp, lambda k: live[k], 0, L + 1,
                          MateState.SEEDBUF)
        rd = live[L]
        budget = p.read_max_snp_num(len(rd.seq), rd.raw_len or len(rd.seq))
        host.sync_schedule(rd, budget, state=tmp)
        state.seed_start_offset = tmp.seed_start_offset
        state.cseed_start_offset = tmp.cseed_start_offset


def reconstruct_state(engine, path: str, param, range_start: int,
                      window: int = 4096) -> None:
    """SE: rebuild the engine's single MateState at a range boundary."""
    host = getattr(engine, "host", engine)
    _reconstruct_into(host, host.mate_state, path, param, range_start,
                      readset=0, window=window)


def reconstruct_pair_state(pair_engine, path_a: str, path_b: str, param,
                           range_start: int, window: int = 4096) -> None:
    """PE: rebuild both per-mate MateStates (PairAlign owns _sa and _sb,
    pairs.h:50-51) at a pair-range boundary."""
    ph = getattr(pair_engine, "pair_host", None) or pair_engine.engine
    host = ph.single
    _reconstruct_into(host, ph.state_a, path_a, param, range_start,
                      readset=1, window=window)
    _reconstruct_into(host, ph.state_b, path_b, param, range_start,
                      readset=2, window=window)


def merge_shards(out_file: str, num_processes: int, header: str = "",
                 timeout_s: float = 3600.0) -> None:
    """Process 0: wait for every shard's .done sentinel, then concatenate
    shards in process order (byte-identical to the single-process output)."""
    t0 = time.time()
    for k in range(num_processes):
        while not os.path.exists(f"{out_file}.shard{k}.done"):
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"shard {k} did not finish")
            time.sleep(0.2)
    with open(out_file, "wb") as out:
        if header:
            out.write(header.encode("latin1"))
        for k in range(num_processes):
            with open(f"{out_file}.shard{k}", "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    out.write(chunk)
    for k in range(num_processes):
        os.remove(f"{out_file}.shard{k}")
        os.remove(f"{out_file}.shard{k}.done")
