"""The system under test: ``bsmap_tpu_torch`` set up as a user with
``--index-cache DIR`` sets it up, and driven pass by pass through the CLI's
own block pipelines (``cli.run_single_end_blocks``,
``engine.pair_pipeline.run_pair_end_blocks``).  The only module of this
benchmark that imports the port."""

from __future__ import annotations

import contextlib
import io
import os
import time

MAX_READ_END = 0xFFFFFFFF


def randseed(seed: int) -> int:
    """The ``-S`` of a run: nonzero, below 2^31, from ``--seed``."""
    return 1 + int(seed) % 2147483646


def card_mesh(device: str, chips: int):
    """The engine's mesh: the first ``chips`` visible cards (None on the
    CPU, the engines' one CPU entry)."""
    import torch
    if device != "cuda":
        return None
    return [torch.device(device, i) for i in range(chips)]


def card_peak_bytes(device: str, chips: int) -> int:
    """The largest ``max_memory_allocated`` over the mesh's cards (0 on
    the CPU)."""
    import torch
    if device != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips))


class Port:
    """Genome, index and engine of one cell, and its passes."""

    def __init__(self, cfg: dict, traffic: dict, reads: list[str],
                 fasta: str, cache_dir: str, out: str, seed: int,
                 device: str = "cuda", chips: int = 1):
        import torch
        from bsmap_tpu_torch import cli
        from bsmap_tpu_torch.reference import load_genome_cached
        self.pe = cfg["layout"] == "pe"
        argv = ["-a", reads[0]] + (["-b", reads[1]] if self.pe else [])
        argv += (["-d", fasta, "-o", out] + list(cfg["options"])
                 + list(traffic["options"])
                 + ["-S", str(randseed(seed)), "--index-cache", cache_dir,
                    "--device", device])
        self.argv = argv
        self.out = out
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            o = cli.parse_args(argv)
            p = o.param
            p.out_sam = 1
            self.genome = load_genome_cached(o.ref_file, p, o.index_cache)
            p.total_ref_seq = self.genome.n_chr
            self.index = cli.get_index(o, self.genome)
        self.load_s = time.perf_counter() - t0
        self.o, self.p = o, p
        mesh = card_mesh(device, chips)
        t0 = time.perf_counter()
        if self.pe:
            from bsmap_tpu_torch.engine import pair_pipeline
            self.engine = pair_pipeline.make_pair_engine(
                o, self.genome, self.index, mesh)
            ok = pair_pipeline.takes_blocks(self.engine, o)
        else:
            self.engine = cli.make_engine(o, self.genome, self.index, mesh)
            ok = self.engine.supports_blocks()
        if device == "cuda":
            torch.cuda.synchronize()
        self.engine_s = time.perf_counter() - t0
        if not ok:
            raise RuntimeError("the engine does not take the block path")

    @property
    def se(self):
        """The single-end engine (the PE engine's, for pair-end)."""
        return self.engine.se if self.pe else self.engine

    def run_pass(self, out: str | None = None, read_end: int | None = None):
        """One pass of the pipeline over the read file(s) into ``out``
        (default: the run's sink), with a fresh formatter; returns the
        reads or pairs it took."""
        from bsmap_tpu_torch import cli
        from bsmap_tpu_torch.utils import RandR, StepTimer
        o, p = self.o, self.p
        o.out_file = out or self.out
        p.read_end = read_end or MAX_READ_END
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                if self.pe:
                    from bsmap_tpu_torch.engine import pair_pipeline
                    from bsmap_tpu_torch.output.pair_sam import PairFormatter
                    fmt = PairFormatter(self.genome, p, RandR(1))
                    return pair_pipeline.run_pair_end_blocks(
                        o, self.genome, self.engine, fmt,
                        threads=p.num_procs)
                from bsmap_tpu_torch.output.sam import SamFormatter
                fmt = SamFormatter(self.genome, p, RandR(1))
                return cli.run_single_end_blocks(
                    o, self.engine, fmt, self.genome, StepTimer(),
                    threads=p.num_procs)
        finally:
            o.out_file = self.out
            p.read_end = MAX_READ_END

    def counters(self) -> dict:
        """The engine's counters, by name: reads (pairs) replayed and
        with a filtered mate, the host engine's seconds, the host route's
        units by cause (``host_causes.<cause>``) and those the native
        aligner ran (``host_native``)."""
        eng = self.engine
        out = {"n_replayed": int(eng.n_replayed),
               "n_mate_filtered": int(getattr(eng, "n_mate_filtered", 0)),
               "t_host": float(getattr(eng, "t_host", 0.0)),
               "host_native": int(getattr(eng, "host_native", 0))}
        for cause, n in getattr(eng, "host_causes", {}).items():
            out["host_causes." + cause] = int(n)
        return out

    @staticmethod
    def start_spans() -> None:
        """Turn the port's own spans (``bsmap_tpu_torch.obs``) on."""
        from bsmap_tpu_torch import obs
        obs.start()

    @staticmethod
    def stop_spans() -> dict:
        """Turn them off; returns ``obs.stop()``'s anchor and records."""
        from bsmap_tpu_torch import obs
        return obs.stop()

    def stage_times(self, device: str) -> dict:
        """Each layer's call timed alone over one pass's blocks (the
        method of ``bsmap_tpu_torch.stage_profile``): parse, encode, align
        (SE: align_block + finish; PE: align_block_pair + collect, ending
        in a device synchronise), and format + write (PE: emit_block, with
        the host engine's seconds apart)."""
        import torch
        from bsmap_tpu_torch import native
        from bsmap_tpu_torch.blockio import BlockReadStream
        from bsmap_tpu_torch.utils import RandR
        p, eng = self.p, self.engine
        lib = native.get_lib()

        def sync():
            if device == "cuda":
                torch.cuda.synchronize()

        out = {}
        t0 = time.perf_counter()
        if self.pe:
            from bsmap_tpu_torch.engine.pair_pipeline import PE_BLOCK_WINDOWS
            sa = BlockReadStream(self.o.query_a, p, readset=1, lib=lib)
            sb = BlockReadStream(self.o.query_b, p, readset=2, lib=lib)
            blocks = []
            while (ba := sa.next_block(PE_BLOCK_WINDOWS * eng.se.B)) \
                    is not None:
                blocks.append((ba, sb.next_block(len(ba))))
            sa.close()
            sb.close()
        else:
            stream = BlockReadStream(self.o.query_a, p, readset=0, lib=lib)
            blocks = []
            while (blk := stream.next_block(8 * eng.B)) is not None:
                blocks.append(blk)
            stream.close()
        out["parse_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in blocks:
            if self.pe:
                eng.encode_block_pair(*b)
            else:
                eng.encode_block(b)
        out["encode_s"] = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        if self.pe:
            aligned = [eng.align_block_pair(ba, bb)() for ba, bb in blocks]
        else:
            aligned = []
            for blk in blocks:
                live_pos, fin, buds = eng.align_block(blk)
                res = fin()
                aligned.append((blk, (live_pos, lambda r=res: r, buds)))
        sync()
        out["align_s"] = time.perf_counter() - t0
        host0 = float(getattr(eng, "t_host", 0.0))
        t0 = time.perf_counter()
        with open(os.devnull, "wb") as f:
            if self.pe:
                from bsmap_tpu_torch.output.pair_sam import PairFormatter
                fmt = PairFormatter(self.genome, p, RandR(1))
                for al in aligned:
                    main, unpair = eng.emit_block(fmt, al)
                    f.write(main)
                    f.write(unpair)
            else:
                from bsmap_tpu_torch.output.sam import SamFormatter
                fmt = SamFormatter(self.genome, p, RandR(1))
                for blk, al in aligned:
                    f.write(eng.format_aligned_block(blk, al, fmt))
        out["format_s"] = time.perf_counter() - t0
        out["host_s"] = float(getattr(eng, "t_host", 0.0)) - host0
        return out

    def close(self) -> None:
        """Drop the engine, index and genome, and the card's cache."""
        import torch
        self.engine = self.index = self.genome = None
        import gc
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
