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
    """Fast full-file read count with the native tokenizer (one pass);
    SAM/BAM input, which the tokenizer does not read, through its own
    stream."""
    from .. import native
    from ..blockio import BlockReadStream
    from ..readio import detect_format, open_read_stream
    lib = native.get_lib()
    if lib is None or detect_format(path) >= 2:
        s = open_read_stream(path, param, 0)
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
                      readset: int = 0, window: int = 4096,
                      first: int = 1) -> None:
    """Rebuild one MateState exactly as if reads [first, range_start) of
    the given stream had been aligned, from read content alone: ``first``
    is the user's -B, where a single process starts fresh.

    Buffers are content-pure (last-writer-wins of each read's seed values);
    the chosen start offsets are those of the last read with max_offset > 0,
    computed against the buffer state at ITS point in the stream (a second,
    temporary fill).  The window doubles until it contains such a read (or
    reaches ``first``)."""
    from ..engine.host_engine import MateState, fill_seed_buffers
    from ..readio import open_read_stream
    from ..trim import filter_read

    if range_start <= first:
        return
    p = param
    S, I = p.seed_size, p.index_interval
    while True:
        w0 = max(first, range_start - window)
        import copy
        p2 = copy.copy(p)
        p2.read_start = w0
        p2.read_end = range_start - 1
        s = open_read_stream(path, p2, readset)
        reads = s.next_batch(range_start - w0)
        s.close()
        live = []
        for rd in reads:
            filtered, _ = filter_read(rd, p)
            if not filtered:
                live.append(rd)
        mo = [(len(r.seq) - I + 1) % S for r in live]
        has_offset_read = any(m > 0 for m in mo)
        if has_offset_read or w0 == first:
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
                      window: int = 4096, first: int = 1) -> None:
    """SE: rebuild the engine's single MateState at a range boundary, as
    a single process from read ``first`` (the user's -B) holds it."""
    host = getattr(engine, "host", engine)
    _reconstruct_into(host, host.mate_state, path, param, range_start,
                      readset=0, window=window, first=first)


def reconstruct_format_state(engine, fmt, path: str, param,
                             range_start: int, first: int = 1,
                             window: int = 16) -> None:
    """SE: set the output state that leaks from read to read (the
    reference's hits[0][0] slot and _mapseq context buffer) in ``fmt``, a
    fresh SamFormatter, and in ``engine``'s native context buffer, as a
    single-process run from read ``first`` (the user's -B) holds them at
    ``range_start``.  BSP QC lines print in the slot's orientation
    (``stale_h00``: that of the last read with a level-0 forward hit, (0, 0)
    where none has one; output/sam.py ``_out_bsp``), and a context string
    (BSP, XR) at a hit at chromosome position 0 or 1 keeps the buffer's
    leading slots from the context before it (``_context``).  The reads
    of a window before the boundary are aligned and formatted in order by
    ``engine`` itself (its per-read path, output dropped) on a MateState
    rebuilt at the window's start (fresh at ``first``), so every alignment
    and context is the one the single-process run made; the window
    doubles until it holds a context at position 2 or later and, where
    QC lines print (BSP with -u), the slot's read, or starts at
    ``first``.  The engine's own MateState is left as it was.  Pair-end
    prints a filtered mate with the hit (0, 0) (output/pair_sam.py), but
    its context buffers leak the same way; the merge carries them
    (parallel/carry.py)."""
    import copy
    from ..engine.host_engine import MateState
    from ..output.sam import SamFormatter
    from ..readio import open_read_stream
    from ..utils import RandR

    class Walk(SamFormatter):
        """Records whether a context wrote the buffer's leading slots."""

        full_context = False

        def _context(self, chr_packed, loc, read_len):
            self.full_context |= loc >= 2
            return super()._context(chr_packed, loc, read_len)

    if range_start <= first:
        return
    unset = (-1, -1)
    need_h00 = (not param.out_sam and param.out_unmap
                and param.report_repeat_hits)
    host = getattr(engine, "host", engine)
    kept = host.mate_state
    try:
        while True:
            w0 = max(first, range_start - window)
            host.mate_state = MateState()
            if w0 > first:
                _reconstruct_into(host, host.mate_state, path, param, w0,
                                  first=first)
            p2 = copy.copy(param)
            p2.read_start, p2.read_end = w0, range_start - 1
            s = open_read_stream(path, p2, 0)
            reads = s.next_batch(range_start - w0)
            s.close()
            walk = Walk(fmt.genome, param, RandR(1))
            walk.stale_h00 = unset
            if hasattr(engine, "format_batch"):
                engine.format_batch(reads, walk)
            else:
                for rd in reads:
                    walk.string_align(rd, engine.align(rd))
            if (walk.full_context and (walk.stale_h00 != unset
                                       or not need_h00)) or w0 == first:
                break
            window *= 2
    finally:
        host.mate_state = kept
    if walk.stale_h00 != unset:
        fmt.stale_h00 = walk.stale_h00
    fmt._mapseq[:] = walk._mapseq
    if hasattr(engine, "_mapseq_buf"):
        engine._mapseq_buf[:] = np.frombuffer(bytes(walk._mapseq), np.uint8)


def reconstruct_pair_state(pair_engine, path_a: str, path_b: str, param,
                           range_start: int, window: int = 4096,
                           first: int = 1) -> None:
    """PE: rebuild both per-mate MateStates (PairAlign owns _sa and _sb,
    pairs.h:50-51) at a pair-range boundary, as a single process from pair
    ``first`` (the user's -B) holds them."""
    ph = getattr(pair_engine, "pair_host", None) or pair_engine.engine
    host = ph.single
    _reconstruct_into(host, ph.state_a, path_a, param, range_start,
                      readset=1, window=window, first=first)
    _reconstruct_into(host, ph.state_b, path_b, param, range_start,
                      readset=2, window=window, first=first)


def wait_shards(out_file: str, num_processes: int,
                timeout_s: float = 3600.0) -> None:
    """Wait for every shard's .done sentinel."""
    t0 = time.time()
    for k in range(num_processes):
        while not os.path.exists(f"{out_file}.shard{k}.done"):
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"shard {k} did not finish")
            time.sleep(0.2)


def merge_shards(out_file: str, num_processes: int, header: str = "",
                 timeout_s: float = 3600.0, patches=None):
    """Process 0: wait for every shard's .done sentinel, then concatenate
    shards in process order (byte-identical to the single-process output).
    ``patches``: each shard's (offset in the shard, byte) list, bytes the
    shard printed as NUL and the merge sets (the pair-end context carry,
    parallel/carry.py).  Returns (bytes patched, seconds spent on them)."""
    wait_shards(out_file, num_processes, timeout_s)
    n_patched, patch_s = 0, 0.0
    with open(out_file, "wb") as out:
        if header:
            out.write(header.encode("latin1"))
        for k in range(num_processes):
            todo = sorted(patches[k], reverse=True) if patches else []
            n_patched += len(todo)
            at = 0
            with open(f"{out_file}.shard{k}", "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    if todo and todo[-1][0] < at + len(chunk):
                        t1 = time.perf_counter()
                        chunk = bytearray(chunk)
                        while todo and todo[-1][0] < at + len(chunk):
                            off, byte = todo.pop()
                            if chunk[off - at] != 0:
                                raise ValueError(
                                    f"shard {k}: byte {off} is not NUL")
                            chunk[off - at] = byte
                        patch_s += time.perf_counter() - t1
                    out.write(chunk)
                    at += len(chunk)
            if todo:
                raise ValueError(f"shard {k}: patch past its end")
    for k in range(num_processes):
        os.remove(f"{out_file}.shard{k}")
        os.remove(f"{out_file}.shard{k}.done")
    return n_patched, patch_s
