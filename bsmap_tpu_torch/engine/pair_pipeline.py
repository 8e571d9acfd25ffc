"""Pair-end batch driver (Do_PairAlign equivalent, main.cpp:116-131): the
port of ``bsmap_tpu.engine.pair_pipeline``.

SAM mode writes paired + unpaired lines into one file; BSP mode writes pairs
to -o and unpaired hits to the -2 file (main.cpp:103-107).

The native PE block pipeline (the single-device engine on FASTA/FASTQ:
SAM or BSP, -R, trimming) streams both mates through chunked native
parsing, native FilterReads and encode on ``-p`` threads, one
``pair_program`` per window and the native pair formatter, with a reader
and a writer thread like the SE block path.  The mesh engines and SAM/BAM
input take the per-pair path."""

from __future__ import annotations

import contextlib
import queue
import threading
import time

from .. import obs
from ..output.pair_sam import PairFormatter
from ..output.sam import sam_header
from ..readio import BATCH_NUM, detect_format, open_read_stream
from ..utils import RandR, StepTimer

# windows per PE block: smaller blocks than SE, because the deferred-finish
# overlap (phase 2 + join + format of block N under block N+1's phase 1)
# needs several blocks in flight to engage
PE_BLOCK_WINDOWS = 2


def run_pair_end(o, genome, index, stats: dict | None = None,
                 mesh=None) -> int:
    """Align every pair of ``o.query_a``/``o.query_b``; returns the pair
    count and, into ``stats``, the alignment phase's wall time (engine
    set-up and the ``.bam`` conversion excluded), the engine and the path
    taken (``pe_path``: "blocks" or "pairs").  ``mesh``: the device list
    of the mesh engines (``cli.make_engine``)."""
    p = o.param
    from ..cli import _randr_seed, _to_bam, with_host_fallback
    engine = with_host_fallback(
        o, lambda: make_pair_engine(o, genome, index, mesh),
        lambda: HostPairBatch(genome, index, p), stats)
    fmt = PairFormatter(genome, p, RandR(_randr_seed()))
    blocks = takes_blocks(engine, o)     # builds the native formatter
    t0 = time.perf_counter()
    if blocks:
        total = run_pair_end_blocks(o, genome, engine, fmt,
                                    threads=p.num_procs)
    else:
        total = run_pair_end_reads(o, genome, engine, fmt)
    if stats is not None:
        stats.update(pairs=total, align_s=time.perf_counter() - t0,
                     engine=engine, pe_path="blocks" if blocks else "pairs")
    denom = max(total, 1)
    print("Total number of aligned reads: \n"
          f"pairs:       {fmt.n_aligned_pairs} "
          f"({100.0 * fmt.n_aligned_pairs / denom:.2g}%)\n"
          f"single a:    {fmt.n_aligned_a} "
          f"({100.0 * fmt.n_aligned_a / denom:.2g}%)\n"
          f"single b:    {fmt.n_aligned_b} "
          f"({100.0 * fmt.n_aligned_b / denom:.2g}%)")
    if p.out_sam == 2:
        _to_bam(o.out_file, stats)
    return total


def takes_blocks(engine, o) -> bool:
    """Whether a pair-end run takes the native block path: an engine that
    supports it (the single-device engine, any output) on FASTA/FASTQ
    mates; else the per-pair path."""
    return (getattr(engine, "supports_pair_blocks", lambda: False)()
            and _fastx_mates(o))


def will_take_blocks(o, engine_name: str, fits: bool) -> bool:
    """``takes_blocks`` before the engine is built (``cli._wants_local_mp``
    decides on it): ``engine_name`` (``cli.resolve_engine``'s pick) is
    ``device`` on a genome it holds (``fits``) and without RRBS, so
    ``make_pair_engine`` builds the single-device engine, whose
    ``supports_pair_blocks`` asks ``pair_block_runtime``."""
    from .pair_device import pair_block_runtime
    return (engine_name == "device" and fits and not o.param.RRBS_flag
            and _fastx_mates(o) and pair_block_runtime())


def _fastx_mates(o) -> bool:
    return detect_format(o.query_a) < 2 and detect_format(o.query_b) < 2


def _check_unpaired(o) -> None:
    """BSP output needs the -2 file for the unpaired lines."""
    if not o.param.out_sam and not o.out_unpair:
        raise SystemExit("failed to open output file for unpaired hits "
                         "(check -2 option)")


def run_pair_end_reads(o, genome, engine, fmt, header: bool = True,
                       carry=None) -> int:
    """Per-pair path (the mesh engines, SAM/BAM mates, the host engine):
    exact for every configuration.  ``header``: write the SAM header (a
    ``--nprocs`` shard does not).  ``carry``: a range's
    ``parallel.carry.ContextCarry`` (``fmt``'s mates track into it),
    which writes the text and records its marked context bytes."""
    p = o.param
    _check_unpaired(o)
    timer = StepTimer()
    total = 0
    with contextlib.ExitStack() as stack:
        sa = stack.enter_context(contextlib.closing(
            open_read_stream(o.query_a, p, readset=1)))
        sb = stack.enter_context(contextlib.closing(
            open_read_stream(o.query_b, p, readset=2)))
        fout = stack.enter_context(open(o.out_file, "w"))
        fout_unpair = (fout if p.out_sam
                       else stack.enter_context(open(o.out_unpair, "w")))
        if p.out_sam and header:
            fout.write(sam_header(genome))
        while True:
            batch_a = sa.next_batch(BATCH_NUM)
            batch_b = sb.next_batch(BATCH_NUM)
            if not batch_a or len(batch_a) != len(batch_b):
                break
            paired_out, unpair_out = engine.format_batch(batch_a, batch_b,
                                                         fmt)
            if carry is None:
                fout.write(paired_out)
                fout_unpair.write(unpair_out)
            else:
                carry.write(fout, paired_out, fout_unpair, unpair_out)
            total += len(batch_a)
            print(f"{total} reads finished. {timer.total():.1f} secs passed")
    return total


def run_pair_end_blocks(o, genome, engine, fmt, header: bool = True,
                        threads: int = 1) -> int:
    """Native PE block pipeline: a reader thread parses block pairs in
    file order, ``threads`` encode threads run ``encode_block_pair`` on
    them (native FilterReads and encode, which release the GIL), the align
    loop takes the encoded pairs strictly in file order and finishes block
    N after block N+1's phase 1 is enqueued, and a writer thread writes
    the SAM (or BSP and -2) bytes.  An error in the reader, an encode
    thread or the writer ends the run with that error.  ``header``: write
    the SAM header (a ``--nprocs`` shard does not).  Under ``obs`` each
    thread's work and waits are spans (``pipe.*``), each carrying its
    block pair's sequence number."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from ..cli import _put
    from ..blockio import BlockReadStream

    p = o.param
    _check_unpaired(o)
    lib = native.get_lib()
    sa = BlockReadStream(o.query_a, p, readset=1, lib=lib)
    sb = BlockReadStream(o.query_b, p, readset=2, lib=lib)
    blk_n = PE_BLOCK_WINDOWS * engine.se.B
    threads = max(threads, 1)
    pool = ThreadPoolExecutor(threads, thread_name_prefix="bsmap_pe_encode")
    # the block pairs' encode futures in file order: one ahead of each
    # thread
    q_in: "queue.Queue" = queue.Queue(maxsize=threads + 1)
    q_out: "queue.Queue" = queue.Queue(maxsize=4)
    errors: list[BaseException] = []
    done = threading.Event()

    def encode(ba, bb, seq):
        with obs.block(seq), obs.span("pipe.encode", rows=len(ba)):
            engine.encode_block_pair(ba, bb)
        return ba, bb

    def reader():
        # geometric first-block ramp, as in the SE pipeline: the device
        # starts on a one-window block instead of idling through the full
        # first parse
        try:
            size = engine.se.B
            seq = 0
            while not done.is_set():
                with obs.block(seq):
                    with obs.span("pipe.parse"):
                        ba = sa.next_block(min(size, blk_n))
                        bb = sb.next_block(min(size, blk_n))
                    size *= 2
                    if ba is None or bb is None or len(ba) != len(bb):
                        break
                    _put(q_in, pool.submit(encode, ba, bb, seq),
                         "pipe.read_wait")
                seq += 1
        except BaseException as e:   # surfaced by the align loop
            errors.append(e)
        q_in.put(None)

    def writer():
        try:
            with contextlib.ExitStack() as stack:
                fout = stack.enter_context(open(o.out_file, "wb"))
                fout_unpair = (None if p.out_sam else stack.enter_context(
                    open(o.out_unpair, "wb")))
                if p.out_sam and header:
                    fout.write(sam_header(genome).encode("latin1"))
                while True:
                    with obs.span("pipe.writer_wait"):
                        item = q_out.get()
                    if item is None:
                        break
                    seq, main, unpair = item
                    with obs.block(seq), obs.span(
                            "pipe.write", nbytes=len(main) + len(unpair)):
                        fout.write(main)
                        if fout_unpair is not None:
                            fout_unpair.write(unpair)
        except BaseException as e:   # surfaced after the join
            errors.append(e)
            while q_out.get() is not None:   # keep the align loop moving
                pass

    t_rd = threading.Thread(target=reader, name="bsmap_reader", daemon=True)
    t_wr = threading.Thread(target=writer, name="bsmap_writer", daemon=True)
    timer = StepTimer()
    total = 0

    def finish(prev) -> None:
        # block N-1: collected, run through the host route and formatted
        # only after block N's phase 1 is on the device
        nonlocal total
        collect, n, seq = prev
        with obs.block(seq):
            main, unpair = engine.emit_block(fmt, collect())
            _put(q_out, (seq, main, unpair), "pipe.output_wait")
        total += n
        print(f"{total} read pairs finished. "
              f"{timer.total():.1f} secs passed")

    prev = None            # (collect, n, seq) of block N-1
    with obs.span("pipe.pass"):
        t_rd.start()
        t_wr.start()
        try:
            seq = 0
            while True:
                with obs.block(seq):
                    with obs.span("pipe.input_wait"):
                        fut = q_in.get()
                        if fut is None:
                            break
                        try:
                            ba, bb = fut.result()
                        except BaseException as e:   # an encode error
                            errors.append(e)
                            break
                    cur = engine.align_block_pair(ba, bb)
                if prev is not None:
                    finish(prev)
                prev = (cur, len(ba), seq)
                seq += 1
            if prev is not None and not errors:
                finish(prev)
        finally:
            done.set()
            with obs.span("pipe.output_wait"):   # the writer's last block
                q_out.put(None)
                t_wr.join()
            while t_rd.is_alive():       # unblock a reader parked on q_in
                try:
                    q_in.get(timeout=0.1)
                except queue.Empty:
                    pass
            t_rd.join()
            pool.shutdown(wait=True, cancel_futures=True)
            sa.close()
            sb.close()
    if errors:
        raise errors[0]
    return total


def make_pair_engine(o, genome, index, mesh=None):
    """``--engine host`` is the exact per-pair host engine; anything else
    is the PyTorch PE engine on ``o.device`` (which raises when that device
    is missing, and ``EngineUnsupported`` on pair-end RRBS), over the SE
    engine that ``--engine sharded`` or ``index-sharded`` names, or that
    ``auto`` picks when more than one card is visible
    (``cli.resolve_engine``, as bsmap_tpu's make_pair_engine)."""
    from ..cli import make_engine, resolve_engine
    name, mesh = resolve_engine(o, mesh)
    if name == "host":
        return HostPairBatch(genome, index, o.param)
    from .pair_device import PairDeviceEngine
    se = None
    if name in ("sharded", "index-sharded"):
        se = make_engine(o, genome, index, mesh)
    engine = PairDeviceEngine(genome, index, o.param, device=o.device,
                              se_engine=se)
    engine.engine_name = name
    return engine


class HostPairBatch:
    """Batch wrapper over the exact per-pair engine."""

    def __init__(self, genome, index, param):
        from .pair_host import PairHostEngine
        self.engine = PairHostEngine(genome, index, param)
        self.param = param

    def format_batch(self, batch_a, batch_b, fmt: PairFormatter):
        p = self.param
        main_parts = []
        unpair_parts = []
        # the reference appends pair + unpaired lines per read, in read
        # order; in SAM mode both go to the same stream (pairs.cpp:213-217)
        for ra, rb in zip(batch_a, batch_b):
            pres = self.engine.align_pair(ra, rb)
            fell = 1
            if pres.paired:
                text, fell = fmt.string_align_pair(ra, rb, pres)
                main_parts.append(text)
            if fell == 1 or not pres.paired:
                up = fmt.string_align_unpair(
                    ra, rb, pres.filtered_a, pres.filtered_b, pres)
                (main_parts if p.out_sam else unpair_parts).append(up)
        return "".join(main_parts), "".join(unpair_parts)
