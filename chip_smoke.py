#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bsmap_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

  1. the card, the torch/CUDA versions, and the kernel build (nvcc, sm_90a);
  2. headline data: 2 x 5 Mb genome, 1,000,000 fully converted 100 nt reads
     (tools/genreads.generate), -v 2 -S 17, SAM out; genome + index;
  3. each kernel against its plain-torch twin on the card, on the first
     65,536-read window: fixed lean (round 1), exact lean at both capacity
     tiers, exact full rows, and the probe pass.  Equal bit for bit
     (int32 throughout, tolerance 0); CUDA-event medians of 7 runs;
     Then what no real window reaches.  K3 on synthetic slot counts put
     in place of the window's (``k3_synthetic_counts``: none; one slot
     holding the capacity; a count past the 2^30 saturation limit and a
     run of them; totals one under, at and one over the capacity; two full
     slots with only empty ones between, past what a block stages in
     shared memory; every slot 0-2), on the window, on one read and on slot
     counts beside a multiple of the scan's tile, with the reads' budgets
     and with every candidate eligible (all dedup rounds run), in both
     launch forms, the whole set twice in a row.  K2 on the reads cut to
     51 nt and on reads built to tie, at -v 2, 4 and 5 (prefix sums of
     several scan rounds), slot rows and the probe pass, at both group
     widths.  The same K2 cases run under cfg.rrbs in phases 13 and 19, on
     both chains in 16, on the global counts in 20.  K1 on a copy of the
     table with synthetic counts at the window's buckets
     (``k1_synthetic_cases``: tying segment costs, counts near and past the
     2^27 clamp, wrapping sums) and on rows cut short, with seedseg <
     maxseg, maxrank 0 and maxrank >= maxseg, at both group widths; again
     on both chains in 16, on shard 0's table in 20, at -s 12 -I 2 in 24.
     K4 on the candidates K3 makes from the synthetic slot counts at both
     capacity tiers (``phase_k4_cases``: lean fixed rows and full rows,
     the reads' own budgets and budget 255, -w as set and 2; reads whose
     candidates span several chunks of a group, reads cut by the
     capacity); again on both chains in 16, on the pair-end mate 2 program in 8 and 18, under
     cfg.rrbs in 13 and 19.
     Times: each kernel's wrapper call by CUDA events and its card time
     (``queued_ms``), K3's parts from a profiler trace, the other launch
     form / group width in turns (K1's widths by card time), and one
     ``torch.cumsum`` of the clamped counts as a yardstick for K3's scan
     part (the port never calls it);
  4. the main path: ``bsmap_tpu_torch.cli.run`` on all 1M reads on cuda
     (no --engine: ``auto``, the single-device engine on one card);
  5. repeat-heavy data: one 46.7 Mb chromosome with 8% repeats, 100,000
     reads (probe mode and round 2);
  6. byte parity: the first 5,000 reads of both datasets, GPU run against
     the port's exact host engine;
  7. pair-end data: one 4.6 Mb chromosome, 200,000 pairs of 76 nt
     (tools/genreads.generate_pe, BASELINE config 2); genome + index;
  8. the pair-end kernels against their twins on the first 65,536-pair
     window: rc_words, both mates' K2/K3/K4 with cfg.pe and 16 hits at
     rank 0 and full rank on both capacity tiers, and pair_join; K6 on
     14,000 synthetic pairs (``k6_synthetic_rows``: every combo eligible,
     no hit on a mate, scattered hits, unpaired draws past K, inserts at
     the bounds and across the int32 wrap) at K = 16, 4 and 1; equal bit
     for bit, CUDA-event medians of 7 runs and card times, and K6's card
     time on windows of synthetic pairs with 0, 1 and K valid hits a mate;
     K5 on synthetic rows (``phase_k5_cases``: every nw from 1 to 10,
     every length 1..16*nw, N lanes, the default complement, -M GA's and
     the permutation (1, 0, 3, 2));
  9. the pair-end main path: ``cli.run`` with -a/-b on all 200,000 pairs
     on cuda; at least 90% properly paired;
 10. byte parity: the first 5,000 pairs, GPU run against the host engine;
 11. the pair-end paths that error-free pairs never reach: 5,000 simulated
     pairs with 2% errors (tools/simulate.py), every 8th cut to 51 nt (a
     length whose seed schedule may read stale state: host replays),
     through the block path (SAM; phase 2 at full rank) and the per-pair
     path (BSP with -2 through ``--engine sharded`` on the one card: the
     single-device engine runs BSP on the block path), each byte-identical
     to the host engine;
 12. RRBS data: BASELINE config 3 (tools/genreads.generate_rrbs defaults:
     one 10 Mb chromosome, 200,000 MspI-fragment 76 nt reads); genome and
     the tag-partitioned index;
 13. K2, K3 and K4 with cfg.rrbs against their twins on the first
     65,536-read window (trimmed, full rank, big tier), lean and full rows;
     equal bit for bit, CUDA-event medians of 7 runs;
 14. the RRBS main path: ``cli.run`` with -D C-CGG -A AGATCGGAAGAGC -q 2
     -S 17 on all 200,000 reads on cuda; at least 90% aligned;
 15. RRBS byte parity against the host engine: the first 5,000 reads of
     phase 12 (SAM, trimming), and 5,000 mixed-strand reads with
     mismatches on a two-chromosome digest (``make_rrbs_set``, the CPU
     tests' generator) as SAM with -m 100 -x 150 and as BSP.
 16. -n 1 (all four strands), non-directional headline data: the reads of
     phase 2 with every second read reverse-complemented.  K5, K1 (fixed
     lean, round 1), K2 (exact lean at both tiers, exact full, probe), K3
     and K4 on both chains ('b') against their twins on the first
     65,536-read window; equal bit for bit, CUDA-event medians of 7 runs;
 17. the -n 1 main path: ``cli.run -n 1 -v 2 -S 17`` on all 1,000,000 of
     them on cuda; at least 90% aligned, both chains among the picks; the
     first 5,000 reads byte-identical to the host engine;
 18. PE -n 1 on the 200,000 pairs of phase 7 with every second pair's
     mates swapped: K5, both mates' K2/K3/K4 on 'b' with cfg.pe and 16 hits
     and K6 (and K6's synthetic pairs) against their twins; ``cli.run``
     with at least 90% properly paired; phase 11's error set with -n 1
     through the block path and the per-pair path, each byte-identical to
     the host engine;
 19. RRBS -n 1 on phase 12's reads with every second read
     reverse-complemented (the index with rc entries): K5, K2, K3 and K4 on
     'b' against their twins; ``cli.run`` (K1 never launches, at least 45%
     aligned: a reversed fragment-start read begins at no site, so it maps
     only where it spans its fragment); phase 15's mixed-strand set with
     every second read
     reverse-complemented, -n 1, byte-identical to the host engine (SAM
     -m 100 -x 150, and BSP).
 20. index-sharded kernels on the first window of phase 5's repeat-heavy
     reads, D = 4 region shards round-robin over the visible cards (one
     card holds all four): per shard K1 (its local-count table) and K2 (on
     the global counts), K3 with the corner bit, then K7 merge_shards, each
     against its twin on the same card, at -n 0 and -n 1 (and K5 there);
     fixed at rank 0 on the small tier, exact at full rank on the big tier,
     the probe pass; equal bit for bit.  The merged rows are also held
     against ``align_program`` on the unsharded tables, column by column:
     they differ by design only in the per-shard capacity columns (X_OK,
     X_BIG, X_FTOT) and, for reads without a pick, in the pick columns
     (JAX's psum of nothing is 0) -- and for corner and per-shard dedup
     replays, which are left out.  K7 also on synthetic shard candidates
     (``k7_synthetic_cases``: D = 1 to 16, maxseg up to 16, reads with 0 to
     over 1,024 candidates, a read cut by the capacity on one shard,
     saturated totals, K = 0 and 16, pe, -r 0, -w 2), and K7's times on
     both real cases (fixed and exact) with their candidates per read;
 21. SE through ``IndexShardedEngine`` (``--engine index-sharded``, the D =
     4 mesh of phase 20) on phase 5's 100,000 reads: the SAM byte-identical
     to phase 5's, its first 5,000 reads to phase 6's host-engine output;
     reads/s, replays, and the replays past the single-device run's (corner
     reads and per-shard dedup failures); then both engines timed at -v 5
     (BASELINE config 4's budget), byte-identical;
 22. SE through ``ShardedDeviceEngine`` (``--engine sharded``, D = 2 read
     stripes) on phase 4's 1,000,000 reads, byte-identical to phase 4's SAM;
 23. PE through both mesh engines on phase 11's 5,000 error pairs (the
     per-pair path; their SE engine overrides the dispatch): D = 2 with
     phase 11's SAM flags, D = 4 with its BSP -2 flags, each byte-identical
     to phase 11's host-engine output.
 24. K2 at -s 12 -I 2 (after phase 11, on its reads' first mates): the K2
     and K1 cases of phase 3 on 'f' and 'b', then K3 and K4 on the -v 4
     slots.
 25. BAM out and in: the 1,000,000 headline reads and the 200,000 pairs
     with -o *.bam (no --engine), the conversion timed apart from the
     alignment phase; each BAM's records, read back by ``bamio`` in a
     process of its own, equal to the body of phase 4's or 9's SAM as a
     sorted multiset, and its .bai there; the first 5,000 reads and pairs
     as .bam byte-identical (BAM and .bai) to the host engine's; a
     5,000-read BAM (the CLI's conversion of a card SAM with -u)
     realigned with -a in.bam, byte-identical to the host engine;
 26. ``python -m bsmap_tpu_torch.methratio -z`` on phase 25's pair-end BAM
     and on phase 9's SAM, the two processes at once, outputs identical;
     ``bsp2sam`` on the card's BSP of the first 5,000 headline reads equal
     to ``bsp2sam`` on the host engine's;
 27. -p and --nprocs on the one card, each byte-identical to its
     one-process run: --nprocs 2 on the headline reads (phase 4) and on
     the pairs (phase 9), process 0 in this process through ``cli.run``
     and process 1 a process of its own; -p 8 on the RRBS reads (phase
     14's output), which the CLI runs as one process with eight encode
     threads (exactly one process reports: K2-K4, never K1), its rate
     beside phase 14's at -p 1; and -p 2 on the first 20,000 pairs as
     pair-end BSP with -2, which the CLI runs as one process on the block
     path with two encode threads (exactly one process reports: K2-K6),
     both files against a -p 1 run here.  Every process reports
     its kernel launches and its peak of allocated card memory at exit
     (``measure.LAUNCH_DUMP``, a sitecustomize on its path); ``nvidia-smi
     --query-compute-apps`` is sampled while they run; each run's rate
     from launch to the (merged) file beside the one-process rate.  Every
     process has a time limit and is killed with its workers past it.
 28. human-genome scale (``bsmap_tpu_torch.genome_scale``): the 3.12 Gb
     hg38-class genome (13 x 239,999,970 uniform random bases, seed 38)
     written, packed and indexed (the native two-pass build, saved and
     memory-mapped back equal) by a process of its own that the script
     starts after the kernel build and phase 28 waits for (some eight
     minutes of one host core, beside the earlier phases, whose rates are
     then taken with that load on the host), and its tables
     placed on the card; K1-K4
     against their twins on the first 65,536 reads (round 1 at the small
     tier, the probe pass, the first exactly packed span) and K2-K6 on the
     first 65,536 pairs at rank 0, each with its card time and its bound
     (the tables now lie in DRAM: a random gather is one 32-byte
     sector); the device's idle share over an align pass of 100,000
     reads; 1,000,000 headline-config reads through the CLI (K1-K4 must
     launch), every read past coordinate 2^31 counted at its true place on
     each strand (at least 500 each), the first 2,000 byte-identical to
     the host engine; 200,000 pairs through the block path (K2-K6), the
     first 2,000 byte-identical to the host engine.  Prints the card
     memory, reads/s, idle share, probe passes, replays and the phase's
     seconds.  A genome or table that cannot be placed fails the run.
 29. pair-end trimming on the block path (before phase 28's wait):
     200,000 pe_76nt-class pairs on phase 7's genome, a synthetic mix
     (``make_trim_pe_set``): inserts uniform in 28-500 (BASELINE config
     2's range, not its distribution; the mates of inserts under 76 nt
     read into the adapter) and low-quality tails on some mates (-q 2
     trims them, and filters a mate left under 16 nt: one mate of a pair,
     now and then both), as BSP with -2 and -R, and as SAM with -R -u,
     each with -A AGATCGGAAGAGC -q 2 -S 17: at -p 1 in this process (the
     block path, K2-K6), its first 5,000 pairs of each file
     byte-identical to the host engine, its pairs/s beside phase 9's SAM
     rate, host replays and pairs with a filtered mate counted apart;
     then at -p 8 in a process of its own, which the CLI keeps one
     process (exactly one LAUNCH_DUMP record, K2-K6), each file
     byte-identical to the -p 1 run's.
 30. QC lines of single-end BSP (after 29, before phase 28's wait): the
     first 5,000 headline reads with Ns put into every 16th read (8 Ns,
     a QC read, in every second of them; ``make_qc_set``), -S 17 -v 2 -u
     -A AGATCGGAAGAGC -q 20, on the block path at -p 1 in this process
     (K2-K4, never K1: BSP takes full rows), byte-identical to the host
     engine, which prints a QC line in the orientation of the hits[0][0]
     slot of the last read with a level-0 forward hit; the count of QC
     lines and how many are reverse-complemented (both orientations must
     occur); then at -p 8 (one process, exactly one LAUNCH_DUMP record) and
     under --nprocs 2, whose second range starts on a QC read (its slot
     taken over from the reads before it: the seconds that took, from
     process 1's log), each byte-identical to the host engine.
 31. pair-end context bytes at range starts (after 30, before phase 28's
     wait): tools/simulate.py's 300 pairs of 76 nt on 2 x 20 kb (seed 5)
     with pair 151, the first of --nprocs 2's second range, planted
     (``context_plants``): mate 1 at chr1:1 (F5's pair), or mate 1 all N
     and mate 2 alone at chr1:1 (an unpaired mate-2 line, the only kind
     that writes mate 2's context buffer under SAM -R).  The reference's
     context there keeps the two leading bases the contexts before it
     wrote; each range records the bytes it prints from buffer slots it
     has not written and the merge sets them (bsmap_tpu_torch/parallel/
     carry.py).  SAM -R and BSP -u -2 (-S 1 -v 3 -q 2) on mate 1's set and
     SAM -R on mate 2's, under --nprocs 2 on the block path (process 1 a
     process of its own, process 0 here), and BSP and mate 2's SAM under
     --engine sharded -p 2 (two workers, the per-pair path), all started
     at once: each byte-identical to the host engine at -p 1, with its
     count of patched bytes (2) and their seconds in the merge.

The CLI's default -p 8 starts worker processes on the pair-end per-pair
path of the mesh engines and under --device cpu; every phase but 27, the
-p 8 runs of 29 and the other processes of 30 and 31 runs in this process
(``BSMAP_TPU_LOCAL_MP=0``), with
the default -p 8 encode threads but phases 14, 29 and 30 (-p 1).

The kernels' launch counters are zeroed right before each run of a main
path and read right after it: phase 4 to 5 (the single-end path: K1-K4
must have run), each GPU run of phases 9 and 11 (the pair-end paths: K2-K6),
phase 14 and each GPU run of phase 15 (the RRBS path: K2-K4, never K1),
phase 17 (-n 1: K1-K5), each GPU run of phase 18 (K2-K6) and phase 19 and
each GPU run of its set (K2-K5, never K1), phase 21's runs (K2, K3, K7,
never K4), phase 22 (K1-K4, never K7), each run of phase 23 (K2, K3,
K5, K6 and, index-sharded, K7 in place of K4), phase 25's .bam runs (the
SE and PE paths) and its -a in.bam run (K3, K4), every process of
phase 27 (what phase 4 launched, K2-K6, the RRBS path) and its
one-process pair-end BSP run (K2-K6), counted in the processes
themselves, phase 29's runs (K2-K6, in this process and in its -p 8
processes), phase 30's runs (K2-K4, never K1, in this process and in
each of its other processes), each process of phase 31's runs (K2-K6)
and phase 28's two runs (K1-K4, K2-K6).
Every kernel's JSON row has its launches summed over those runs, its
error against the twin, its time and the twin's at the single-end
headline window (the pair-end one for K5 and K6), and its bound there: the bytes it must move over the card's memory
rate, or its int32 operations over the card's non-tensor peak, whichever
is larger (K6's on the window's live combos).  No single PyTorch call
computes any of these functions, so ``library_ms`` is null.  Every row
also carries ``device_ms`` (the card's own time for a call) and
``ptxas`` (registers, shared memory, stack and spills of each entry
function of its source, also printed at the build); K3's ``parts_ms``
(by kernel name); K2's and K3's launch form or group width in use with
the other one's times, K1's both widths by card time (``card_group``),
K4's and K5's card time on 32 reads
(``card_floor_ms``: launch and one warp's chain of loads), and K3's
``scan_cumsum_ms``, and ``hg38``: phase 28's card time, bound and
launches for the kernel on the hg38-class windows (``se``, ``pe``).  The
last lines are the per-kernel JSON, the card's name and power limit, and
the result line.  Exits non-zero without
printing a result when torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

from bsmap_tpu_torch.measure import (CardMemory, bound, cuda_ms,
                                     launch_dump_env, launch_dumps,
                                     queued_ms)

REPO = os.path.dirname(os.path.abspath(__file__))
N_HEADLINE = 1_000_000
N_REPEAT = 100_000
N_PARITY = 5_000
N_PAIRS = 200_000
# phase 11: (tag, flags, output suffix [, -2], the least n_dispatched and
# n_replayed that show the path's corners ran: phase 2, host replays, the
# engine: BSP with -2 runs on the block path on the single-device engine,
# so the per-pair run takes the read-stripe engine on the one card)
PE_PATH_RUNS = (
    ("block path", ["-S", "1", "-v", "2", "-u"], ("sam",), 2, 1, []),
    ("per-pair path", ["-S", "3", "-v", "3"], ("bsp", "-2"), 4, 1,
     ["--engine", "sharded"]),
)
ALIGN_FLAGS = ["-v", "2", "-S", "17"]
N1 = ["-n", "1"]
PE_FLAGS = ["-S", "17"]
N_RRBS = 200_000
RRBS_FLAGS = ["-D", "C-CGG", "-A", "AGATCGGAAGAGC", "-q", "2", "-S", "17"]
# phase 15 on the mixed-strand set: (flags, output suffix)
RRBS_SET_RUNS = (
    (["-D", "C-CGG", "-S", "1", "-v", "2", "-u", "-m", "100", "-x", "150"],
     "sam"),
    (["-D", "C-CGG", "-S", "2", "-v", "4", "-u"], "bsp"),
)
KERNEL_SOURCES = {
    "fixed_schedule": ("bsmap_tpu_torch/csrc/fixed_schedule.cu",
                       "bsmap_tpu/engine/device_engine.py:350"),
    "exact_schedule": ("bsmap_tpu_torch/csrc/exact_schedule.cu",
                       "bsmap_tpu/engine/device_engine.py:404"),
    "verify_candidates": ("bsmap_tpu_torch/csrc/verify_candidates.cu",
                          "bsmap_tpu/engine/device_engine.py:679"),
    "reduce_reads": ("bsmap_tpu_torch/csrc/reduce_reads.cu",
                     "bsmap_tpu/engine/device_engine.py:899"),
    "rc_words": ("bsmap_tpu_torch/csrc/rc_words.cu",
                 "bsmap_tpu/engine/device_engine.py:302"),
    "pair_join": ("bsmap_tpu_torch/csrc/pair_join.cu",
                  "bsmap_tpu/engine/pair_device.py:73"),
    "merge_shards": ("bsmap_tpu_torch/csrc/merge_shards.cu",
                     "bsmap_tpu/parallel/index_sharded.py:115"),
}
SE_PATH = ("fixed_schedule", "exact_schedule", "verify_candidates",
           "reduce_reads")
PE_PATH = ("exact_schedule", "verify_candidates", "reduce_reads", "rc_words",
           "pair_join")
RRBS_PATH = ("exact_schedule", "verify_candidates", "reduce_reads")
N_SHARDS = 4                     # phases 20, 21 and 23's D = 4 runs
N_SCALE_PAIRS = 200_000          # phase 28's pairs on the hg38-class genome
PREP_TIMEOUT = 1100              # seconds: phase 28's genome and index build
INDEX_SHARDED_PATH = ("exact_schedule", "verify_candidates", "merge_shards")
RRBS_ADAPTER = "AGATCGGAAGAGC"
N_NPROCS = 2                     # phase 27's processes on the one card
N_PE_BSP = 20_000                # phase 27's pair-end BSP pairs (-E)
N_TRIM_PAIRS = 200_000           # phase 29's pairs
TRIM_PE_FLAGS = ["-S", "17", "-A", RRBS_ADAPTER, "-q", "2"]
# phase 29: (tag, flags, output suffix [, -2])
TRIM_PE_RUNS = (("bsp", ["-R"], ("bsp", "-2")),
                ("sam_xr", ["-R", "-u"], ("sam",)))
PROC_TIMEOUT = 900               # seconds: phases 25-27's other processes
# phase 30: single-end BSP -u with trimming on reads with Ns; a read k
# (1-based) with k % N_QC_EVERY == N_QC_AT gets Ns, so --nprocs 2's second
# range (read N_PARITY / 2 + 1) starts on one
QC_FLAGS = ["-S", "17", "-v", "2", "-u", "-A", RRBS_ADAPTER, "-q", "20"]
N_QC_EVERY, N_QC_AT = 16, 5
N_CTX_PAIRS = 300                # phase 31's pairs
# phase 31: F5's flags (SAM -R; BSP -u with -2)
CTX_SAM = ["-S", "1", "-v", "3", "-u", "-R", "-q", "2"]
CTX_BSP = ["-S", "1", "-v", "3", "-u", "-q", "2"]
# phase 31: tag -> (planted set, flags, output files, how: --nprocs 2 on
# the block path, or --engine sharded -p 2 workers on the per-pair path)
CTX_RUNS = {
    "sam_xr": ("mate1", CTX_SAM, 1, "nprocs"),
    "bsp": ("mate1", CTX_BSP, 2, "nprocs"),
    "mate2": ("mate2", CTX_SAM, 1, "nprocs"),
    "sharded_bsp": ("mate1", CTX_BSP, 2, "workers"),
    "sharded_mate2": ("mate2", CTX_SAM, 1, "workers"),
}
# per-kernel extras of the JSON line: the launch form or group width in use
# and the other one's time, K3's parts by kernel name, the library scan
FORM_KEYS = ("device_ms", "parts_ms", "variant", "variant_ms",
             "other_variant", "other_variant_ms", "group", "group_ms",
             "other_group", "other_group_ms", "other_device_ms",
             "card_group", "card_group_ms", "other_card_group",
             "other_card_group_ms", "card_floor_ms",
             "card_by_valid_hits_ms", "scan_cumsum_ms",
             "fixed_cands_per_read", "exact_cands_per_read", "exact_ms",
             "exact_plain_ms", "exact_device_ms", "exact_bound_ms")
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def make_rrbs_set(d, n_reads: int, n_chr: int = 2, chr_len: int = 30000,
                  n_pairs: int = 0, seed: int = 77) -> None:
    """An MspI-digested genome ``rrbs.fa`` (``n_chr`` chromosomes of random
    30-300 bp segments joined by CCGG) and ``se.fq``: fragment-start reads
    of 60 or 76 nt from both strands, 90% of C converted, a quarter with
    one and a quarter with two random substitutions.  With ``n_pairs``,
    also ``pe1.fq``/``pe2.fq``: whole fragments with the adapter read
    through, cut to 60 nt."""
    comp = str.maketrans("ACGT", "TGCA")
    rng = random.Random(seed)
    chrs = []
    for _ in range(n_chr):
        parts, pos = [], 0
        while pos < chr_len:
            seg = "".join(rng.choice("ACGT")
                          for _ in range(rng.randint(30, 300)))
            parts += [seg, "CCGG"]
            pos += len(seg) + 4
        chrs.append("".join(parts))
    with open(os.path.join(d, "rrbs.fa"), "w") as f:
        for c, g in enumerate(chrs):
            f.write(f">chr{c + 1}\n")
            for i in range(0, len(g), 70):
                f.write(g[i:i + 70] + "\n")
    sites = [[m.start() for m in re.finditer("CCGG", g)] for g in chrs]

    def fragment():
        while True:
            c = rng.randrange(n_chr)
            i = rng.randrange(len(sites[c]) - 1)
            start = sites[c][i] + 1
            frag = chrs[c][start: sites[c][i + 1] + 3]
            if 28 <= len(frag) <= 500:
                return c, start, frag

    def conv(s):
        return "".join("T" if ch == "C" and rng.random() < 0.9 else ch
                       for ch in s)

    def qual(s):
        return "".join(chr(33 + rng.randint(20, 40)) for _ in s)

    with open(os.path.join(d, "se.fq"), "w") as f:
        for n in range(n_reads):
            c, start, frag = fragment()
            L = min(rng.choice((60, 76)), len(frag))
            s = (frag if rng.random() < 0.5
                 else frag[::-1].translate(comp))[:L]
            s = list(conv(s))
            for _ in range(rng.choice((0, 0, 1, 2))):
                s[rng.randrange(len(s))] = rng.choice("ACGT")
            s = "".join(s)
            f.write(f"@r{n}_chr{c + 1}_{start}\n{s}\n+\n{qual(s)}\n")
    if not n_pairs:
        return
    with open(os.path.join(d, "pe1.fq"), "w") as f1, \
            open(os.path.join(d, "pe2.fq"), "w") as f2:
        for n in range(n_pairs):
            c, start, frag = fragment()
            cv = conv(frag)
            r1 = (cv + RRBS_ADAPTER)[:60]
            r2 = (cv[::-1].translate(comp) + RRBS_ADAPTER)[:60]
            f1.write(f"@p{n}_{start}/1\n{r1}\n+\n{qual(r1)}\n")
            f2.write(f"@p{n}_{start}/2\n{r2}\n+\n{qual(r2)}\n")


def nondirectional(src: str, dst: str) -> str:
    """Copy a FASTQ file with every second read reverse-complemented (its
    quality reversed): half the reads then come from the rc strands, as in
    a non-directional library.  Returns ``dst``."""
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")
    for k in range(4, len(lines) - 3, 8):
        lines[k + 1] = lines[k + 1][::-1].translate(_COMP)
        lines[k + 3] = lines[k + 3][::-1]
    with open(dst, "wb") as f:
        f.write(b"\n".join(lines))
    return dst


def swap_mates(r1: str, r2: str, d1: str, d2: str) -> tuple[str, str]:
    """Copy a FASTQ pair with the mates of every second pair swapped (the
    names stay): those pairs map with mate 1 on the rc chains."""
    with open(r1, "rb") as f:
        a = f.read().split(b"\n")
    with open(r2, "rb") as f:
        b = f.read().split(b"\n")
    for k in range(4, min(len(a), len(b)) - 3, 8):
        for j in (1, 3):
            a[k + j], b[k + j] = b[k + j], a[k + j]
    for path, lines in ((d1, a), (d2, b)):
        with open(path, "wb") as f:
            f.write(b"\n".join(lines))
    return d1, d2


def rc_chain_share(sam: str) -> tuple[int, int]:
    """(records, records whose pick is on the rc chain: ZS:Z:?-)."""
    n = rc = 0
    with open(sam, "rb") as f:
        for ln in f:
            i = ln.find(b"\tZS:Z:")
            if i >= 0:
                n += 1
                rc += ln[i + 7: i + 8] == b"-"
    return n, rc


def k3_synthetic_counts(N: int, cands: int, seed: int = 7) -> list:
    """Slot-count patterns for K3's scan and slot lookup that real windows
    never reach, as (name, (N,) int32 numpy array): no candidate at all; one
    slot holding the whole capacity; one count past the 2^30 saturation
    limit in the middle, and a run of them (their sum passes 2^31); totals
    one under, at and one over ``cands``; two full slots with every slot
    between them empty (a block of candidates then spans more slots than
    the kernel stages in shared memory); and every slot holding 0-2."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sat = 1 << 30

    def sparse(total: int):
        """``total`` candidates over about a tenth of the slots."""
        c = np.zeros(N, np.int64)
        k = max(1, min(N, total, N // 10))
        idx = rng.choice(N, size=k, replace=False)
        c[idx] = 1 + rng.multinomial(total - k, np.full(k, 1.0 / k))
        return c

    zero = np.zeros(N, np.int64)
    one = zero.copy()
    one[N // 3] = cands
    sat1 = sparse(cands // 2)
    sat1[N // 2] = sat + 5
    run = sparse(cands // 4)
    run[N // 2: N // 2 + 4] = sat
    far = zero.copy()
    first = max(cands // 2 - 100, 1)
    far[min(5, N - 1)] = first
    far[max(N - 7, 0)] += cands - first
    cases = [("all zero", zero), ("one slot holds all", one),
             ("a count past 2^30", sat1), ("a run of 2^30 counts", run),
             ("total cands - 1", sparse(cands - 1)),
             ("total cands", sparse(cands)),
             ("total cands + 1", sparse(cands + 1)),
             ("two full slots far apart", far),
             ("every slot 0-2", rng.integers(0, 3, size=N))]
    return [(name, c.astype(np.int32)) for name, c in cases]


def k3_near_tile_shapes(nch: int, tile: int = 1024) -> list:
    """(maxseg, I, reads) whose slot count maxseg*nch*I*reads lies one (or,
    where parity forbids it, two) under and over a multiple of the scan's
    tile."""
    out = []
    for sign in (-1, 1):
        for d in (1, 2):
            hit = [(ms, i, (tile + sign * d) // (ms * nch * i))
                   for ms in range(2, 17) for i in (1, 2, 3, 4)
                   if (tile + sign * d) % (ms * nch * i) == 0]
            if hit:
                out.append(hit[0])
                break
    return out


def phase_k3_synthetic(K, cfg, cands: int, rows, slots, tabs, rc, errs: dict,
                       tag: str, repeats: int = 2) -> None:
    """K3 on synthetic slot counts against its twin: every pattern of
    ``k3_synthetic_counts`` on the whole window, on a window of one read
    and on windows whose slot count lies beside a multiple of the scan's
    tile; each with the reads' own budgets and with a budget no candidate
    exceeds (every in-bounds candidate eligible: all three dedup rounds
    and the compact list run); both launch forms of the kernel; the whole
    set ``repeats`` times in a row, so each call finds the previous call's
    scratch."""
    import torch
    nw = cfg.nw
    shapes = [(cfg, rows.shape[0]), (cfg, 1)] + [
        (cfg._replace(maxseg=ms, I=i), m)
        for ms, i, m in k3_near_tile_shapes(cfg.nch)]
    if max(m for _, m in shapes) > rows.shape[0]:
        raise ValueError(f"the window holds {rows.shape[0]} reads, fewer "
                         "than the shapes beside a tile multiple need")
    n_cases = n_round2 = 0
    for rep in range(repeats):
        for c, m in shapes:
            NB = c.NB
            r = rows[:m].contiguous()
            rcm = None if rc is None else rc[:m].contiguous()
            loose = r.clone()
            loose[:, 2 * nw + 1] = 255
            rc_loose = None if rcm is None else rcm.clone()
            if rc_loose is not None:
                rc_loose[:, 2 * nw + 1] = 255    # K5 copies the budget
            base = [t[:m, :NB].contiguous() for t in slots[:4]]
            for name, cnt in k3_synthetic_counts(m * NB, cands):
                sl = K.Slots(*base, torch.from_numpy(cnt).to(r.device)
                             .reshape(m, NB), slots.s_off[:m],
                             slots.c_off[:m], slots.ftot_rank[:m])
                for rr, rrc, budget in ((r, rcm, "own budgets"),
                                        (loose, rc_loose, "budget 255")):
                    want = K.verify_candidates_plain(c, cands, rr, sl, tabs,
                                                     rrc)
                    for variant in (0, 1):
                        got = K.verify_candidates(c, cands, rr, sl, tabs, rrc,
                                                  variant=variant)
                        check(errs, "verify_candidates",
                              f"synthetic, {name}, {m} reads x {NB} slots, "
                              f"{budget}, variant {variant}, pass {rep}",
                              got, want)
                    n_cases += 1
                    n_round2 = max(n_round2, int(
                        ((want.info & K.INFO_UNRESOLVED) != 0).sum()))
    log(f"[{tag}] K3 synthetic slot counts: {n_cases} cases x 2 launch "
        f"forms over shapes {[(c.maxseg, c.I, m) for c, m in shapes]} "
        f"(maxseg, I, reads), {repeats} passes; up to {n_round2} candidates "
        "unresolved after three dedup rounds — kernels == twins")


def phase_k4_cases(K, cases: list, tabs, errs: dict, tag: str) -> None:
    """K4 against its twin on the candidates K3 makes from the slot counts
    of ``k3_synthetic_counts`` put in place of a window's, for each
    (name, cfg, rows, rows_rc, slots, capacities) of ``cases``: with the
    reads' own budgets and with budget 255 (every candidate eligible: more
    accepted hits than K, dedup exhaustion), at the cfg's -w and at -w 2 (a
    level at max_num_hits).  The patterns give reads whose candidates span
    several chunks of a warp (one slot holding the capacity, two full slots far apart, 0-2 a slot)
    and reads cut by the capacity (totals one over it)."""
    import torch
    n_calls = long_reads = cut_reads = 0
    for name, cfg, rows, rc, slots, tiers in cases:
        nw, m, NB = cfg.nw, rows.shape[0], cfg.NB
        loose, rc_loose = rows.clone(), None if rc is None else rc.clone()
        for t in (loose, rc_loose):
            if t is not None:
                t[:, 2 * nw + 1] = 255
        for cands in tiers:
            for pname, cnt in k3_synthetic_counts(m * NB, cands):
                sl = slots._replace(cnt=torch.from_numpy(cnt).to(rows.device)
                                    .reshape(m, NB))
                for rr, rrc, budget in ((rows, rc, "own budgets"),
                                        (loose, rc_loose, "budget 255")):
                    vc = K.verify_candidates(cfg, cands, rr, sl, tabs, rrc)
                    st = vc.starts[::NB].to(torch.int64)
                    span = torch.clamp(st[1:], max=cands) - st[:-1]
                    long_reads += int((span > 32).sum())
                    cut_reads += int(((st[:-1] < cands)
                                      & (st[1:] > cands)).sum())
                    for c in (cfg, cfg._replace(max_num_hits=2)):
                        want = K.reduce_reads_plain(c, cands, rr, vc, sl)
                        got = K.reduce_reads(c, cands, rr, vc, sl)
                        check(errs, "reduce_reads",
                              f"{name}, synthetic {pname}, {budget}, -w "
                              f"{c.max_num_hits}, capacity {cands}",
                              [got], [want])
                        n_calls += 1
    log(f"[{tag}] K4 on synthetic slot counts: {n_calls} calls over "
        f"{', '.join(c[0] for c in cases)} x both budgets x -w as set and 2; "
        f"{long_reads} reads with more than 32 "
        f"candidates, {cut_reads} cut by the capacity — kernels == twins")


# K7's synthetic shapes: (D shards, maxseg, I, hits_k, pe,
# report_repeat_hits); every shape runs at the cfg's -w and at -w 2
K7_SHAPES = ((1, 3, 4, 0, 0, 1), (2, 3, 4, 16, 1, 1), (4, 3, 4, 0, 0, 0),
             (4, 6, 4, 16, 0, 1), (16, 16, 2, 16, 1, 0), (16, 16, 1, 0, 0, 1))


def k7_synthetic_cases(K, cfg, m: int = 40, seed: int = 19) -> list:
    """Index-sharded K3 outputs built directly, for K7 against its twin,
    as (name, cfg, cands, rows, vcs, slots) with CPU tensors: for each
    shape of ``K7_SHAPES`` on ``cfg``'s chains, ``m`` reads with 0, 1,
    2-32, 33-300 and two with 1,030-1,400 candidates summed over the
    shards, spread over random slots and shards, Watson entries before
    Crick ones in each slot; shard 0 holds 60 more on the second-to-last
    read and the capacity cuts that read on shard 0 alone; the last read
    has 2^30 more on every shard (the saturated scan's limit: past the
    capacity, big, the totals' int32 sum wraps from D = 3); info words
    with and without FIRST, UNRESOLVED and CORNER (rare), wmm at and past
    maxseg, every rank, both chains; rows with random budgets and hashes,
    maxrank 0, mid, maxseg-1 and past the seed segments; random ftot_rank
    and start offsets."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nw = cfg.nw
    out = []
    for D, MS, I, hits_k, pe, rrh in K7_SHAPES:
        c = cfg._replace(maxseg=MS, I=I, hits_k=hits_k, pe=bool(pe),
                         report_repeat_hits=rrh, shards=D, fixed=False,
                         probe=False, lean=False, rrbs=False)
        NB = c.NB
        # candidates per read over all shards, then per shard
        tot = np.select([np.arange(m) % 10 == 0, np.arange(m) % 10 == 1,
                         np.arange(m) % 10 < 6],
                        [0, 1, rng.integers(2, 33, m)],
                        rng.integers(33, 301, m))
        tot[[m // 3, m - 5]] = rng.integers(1030, 1401, 2)
        per = np.stack([rng.multinomial(t, rng.dirichlet(np.ones(D)))
                        for t in tot], axis=1)            # (D, m)
        per[0, m - 2] += 60
        # the capacity: every shard but 0 whole, shard 0 cut inside read
        # m-2 (its earlier reads at least as many as any other shard's)
        short = per[1:].sum(axis=1).max(initial=0) - per[0, : m - 2].sum()
        per[0, m // 3] += max(0, short)
        cands = int(per[0, : m - 2].sum()) + 30
        per[:, m - 1] += 1 << 30
        vcs, slots = [], []
        for d in range(D):
            cnt = np.zeros((m, NB), np.int64)
            for b in range(m):
                if per[d, b]:
                    used = rng.choice(NB, size=rng.integers(1, NB + 1),
                                      replace=False)
                    cnt[b, used] = rng.multinomial(
                        per[d, b], rng.dirichlet(np.ones(len(used))))
            flat = cnt.reshape(-1)
            starts = np.minimum(np.concatenate([[0], np.cumsum(flat)]),
                                K.SATLIM)
            n = min(int(starts[-1]), cands)     # the words K3 would store
            # a slot's Watson entries first, then its Crick ones
            q = np.searchsorted(starts[1:], np.arange(n), side="right")
            crick = (np.arange(n) - starts[q]
                     >= rng.binomial(flat, 0.5)[q]).astype(np.int64)
            chrp = (rng.integers(0, 1 << 29, n) << 1) | crick
            wloc = rng.integers(0, 1 << 31, n)
            info = ((rng.random(n) < 0.6) * K.INFO_FIRST
                    | (rng.random(n) < 0.004) * K.INFO_UNRESOLVED
                    | (rng.random(n) < 0.003) * K.INFO_CORNER
                    | K.INFO_ELIGIBLE
                    | (rng.integers(0, MS + 3, n) << K.INFO_WMM_SHIFT)
                    | (rng.integers(0, MS, n) << K.INFO_RANK_SHIFT)
                    | (rng.integers(0, 2, n) << K.INFO_CHAIN_SHIFT))
            rid = q // NB

            def cap(x):
                y = np.zeros(cands, np.int64)
                y[:n] = x
                return torch.from_numpy(y.astype(np.int32))

            vcs.append(K.Cands(torch.from_numpy(starts.astype(np.int32)),
                               cap(rid), cap(chrp), cap(wloc), cap(info)))
            ft = np.sort(rng.integers(0, 1 << 27, (m, MS)), axis=1)
            z = torch.zeros((m, NB), dtype=torch.int32)
            slots.append(K.Slots(
                z, z, z, z, torch.from_numpy(cnt.astype(np.int32)),
                torch.from_numpy(rng.integers(-50, 50, m).astype(np.int32)),
                torch.from_numpy(rng.integers(-50, 50, m).astype(np.int32)),
                torch.from_numpy(ft.astype(np.int32))))
        rows = rng.integers(-(1 << 31), 1 << 31, (m, 2 * nw + 4))
        rows[:, 2 * nw] = rng.integers(20, 16 * nw + 1, m)       # len
        rows[:, 2 * nw + 1] = rng.integers(0, MS + 2, m)         # budget
        rows[:, 2 * nw + 3] = rng.choice([0, MS // 2, MS - 1, MS + 3], m)
        rows = torch.from_numpy(rows.astype(np.int32))
        name = (f"D={D} maxseg={MS} I={I} '{c.chains_mode}' K={hits_k} "
                f"pe={pe} -r {rrh}")
        for w in (c.max_num_hits, 2):
            out.append((f"{name} -w {w}", c._replace(max_num_hits=w), cands,
                        rows, vcs, slots))
    return out


def phase_k7_cases(K, cfg, dev, errs: dict, tag: str) -> int:
    """K7 against its twin, bit for bit, on ``k7_synthetic_cases`` for
    ``cfg``'s chains, every case's tensors moved to ``dev``; returns the
    number of kernel calls."""
    n_long = n_calls = 0
    for name, c, cands, rows, vcs, slots in k7_synthetic_cases(K, cfg):
        mv = lambda t: t.to(dev)     # noqa: E731
        r = mv(rows)
        v = [K.Cands(*map(mv, x)) for x in vcs]
        s = [K.Slots(*map(mv, x)) for x in slots]
        got = K.merge_shards(c, cands, r, v, s)
        check(errs, "merge_shards", f"synthetic K7 case {name}", [got],
              [K.merge_shards_plain(c, cands, r, v, s)])
        n_calls += 1
        n_long = max(n_long, k7_cands_per_read(c, cands, vcs, "cpu")[1])
    log(f"[{tag}] K7 on synthetic shard candidates: {n_calls} cases "
        f"(D 1-16, maxseg 3-16, K 0/16, pe, -r 0/1, -w as set and 2; up to "
        f"{n_long} candidates a read) — kernels == twins")
    return n_calls


# K5's complement permutations: the default alphabet, -M GA (rc_n 2) and a
# non-plain permutation (the lane-indicator branch)
K5_PERMS = (((3, 2, 1, 0), 3), ((3, 2, 1, 0), 2), ((1, 0, 3, 2), 3))


def k5_synthetic_rows(nw: int, lens, reps: int = 5, seed: int = 17):
    """Dispatch rows (numpy, (len(lens) * reps, 2nw+4) int32) of random
    reads of each length in ``lens`` (``reps`` each, in turn): random bases
    inside the read with about one lane in ten an N (valid mask 00, a
    random code under it), zero lanes past the end, and random budgets,
    hashes and ranks."""
    import numpy as np
    rng = np.random.default_rng(seed + nw)
    ln = np.tile(np.asarray(lens, np.int64), reps)
    m, L = len(ln), 16 * nw
    inside = np.arange(L)[None, :] < ln[:, None]
    codes = np.where(inside, rng.integers(0, 4, size=(m, L)), 0)
    masks = np.where(inside & (rng.random((m, L)) > 0.1), 3, 0)
    shift = (2 * (15 - np.arange(16))).astype(np.uint64)

    def pack(x):
        w = (x.reshape(m, nw, 16).astype(np.uint64) << shift).sum(axis=2)
        return w.astype(np.uint32).view(np.int32)

    rows = np.zeros((m, 2 * nw + 4), np.int32)
    rows[:, :nw], rows[:, nw: 2 * nw] = pack(codes), pack(masks)
    rows[:, 2 * nw] = ln
    rows[:, 2 * nw + 1] = rng.integers(0, 16, size=m)
    rows[:, 2 * nw + 2] = rng.integers(-2 ** 31, 2 ** 31, size=m)
    rows[:, 2 * nw + 3] = rng.integers(0, 16, size=m)
    return rows


def phase_k5_cases(K, cfg, dev, errs: dict, tag: str) -> None:
    """K5 against its twin on ``k5_synthetic_rows`` at every nw from 1 to
    the kernels' limit, every length from 1 to 16*nw (z = 0 and the
    multiples of 16 among them), N lanes, under each of ``K5_PERMS``."""
    import torch
    n = 0
    for nw in range(1, K.MAX_NW + 1):
        rows = torch.from_numpy(k5_synthetic_rows(
            nw, range(1, 16 * nw + 1))).to(dev)
        for rc, rc_n in K5_PERMS:
            c = cfg._replace(nw=nw, rc=rc, rc_n=rc_n)
            check(errs, "rc_words", f"synthetic rows, nw {nw}, rc {rc}, "
                  f"rc_n {rc_n}", [K.rc_words(c, rows)],
                  [K.rc_words_plain(c, rows)])
            n += rows.shape[0]
    log(f"[{tag}] K5 on {n} synthetic rows: nw 1-{K.MAX_NW}, every length "
        f"1..16*nw, N lanes, rc {' / '.join(str(p) for p in K5_PERMS)} — "
        "kernels == twins")


def k2_row_variants(rows_np, nw: int) -> dict:
    """Dispatch rows that stress K2's tie rules and short schedules, from a
    window's rows (numpy, (m, 2nw+4) int32): the rows as read; the reads
    cut to 51 nt (no room for a start offset: (len - I + 1) % S == 0 at
    -s 16 -I 4, and fewer segments than maxseg at -v 4 and up); and reads
    built to tie: every second read one repeated base (equal bucket costs
    at every position, so every arg-min and the segment order tie), every
    fourth a 16-base pattern repeated (segments tie, offsets do not)."""
    import numpy as np
    cut = rows_np.copy()
    lane = np.arange(16 * nw).reshape(nw, 16)
    keep = np.where(lane < 51, 3, 0).astype(np.uint64)
    mask = (keep << (2 * (15 - np.arange(16, dtype=np.uint64)))[None, :]
            ).sum(axis=1).astype(np.uint32).view(np.int32)
    cut[:, : 2 * nw] &= np.concatenate([mask, mask])[None, :]
    cut[:, 2 * nw] = np.minimum(cut[:, 2 * nw], 51)
    ties = rows_np.copy()
    ties[::2, :nw] = -1                                  # all one base
    ties[1::4, :nw] = np.int32(0x1B1B6C93)               # one word repeated
    return {"as read": rows_np, "51 nt": cut, "built to tie": ties}


def k2_budget_cfg(cfg, v: int):
    """``cfg`` at a budget of ``v`` mismatches (-v v): v + 1 segments and
    the schedule table that goes with them (device_engine.make_cfg)."""
    ms = v + 1
    return cfg._replace(maxseg=ms, P=min(16 * cfg.nw - cfg.S + 1,
                                         ms * cfg.S + 2 * cfg.I))


def phase_k2_cases(K, cfg, rows_np, tabs, dev, errs: dict, tag: str,
                   budgets=(2, 4, 5), gcnt=None) -> None:
    """K2 against its twin beyond the main path's windows: the row
    variants of ``k2_row_variants`` at each budget (more segments: at -v 5
    the prefix sum of a -s 16 read spans 100 words, several scan rounds),
    at full rank, slot rows and the probe pass, with both group widths of
    the kernel; ``cfg`` carries the chains ('f', 'r' or 'b') and the index
    sharding (``gcnt``)."""
    import torch
    nw = cfg.nw
    n = 0
    for v in budgets:
        c = k2_budget_cfg(cfg, v)
        for name, r_np in k2_row_variants(rows_np, nw).items():
            r_np = r_np.copy()
            r_np[:, 2 * nw + 1] = v
            r_np[:, 2 * nw + 3] = c.maxseg - 1
            rows, rc = K.chain_inputs(c, torch.from_numpy(r_np).to(dev))
            kw = dict(tag_off=tabs.get("tag_off"), rows_rc=rc, gcnt=gcnt)
            want = K.exact_schedule_plain(c, rows, tabs["kmer_tab"],
                                          tabs["prof_a"], **kw)
            for group in K.k2_groups(c):
                got = K.exact_schedule(c, rows, tabs["kmer_tab"],
                                       tabs["prof_a"], group=group, **kw)
                check(errs, "exact_schedule",
                      f"{name}, -v {v}, group {group}", got, want)
                got = K.exact_schedule(c._replace(probe=True), rows,
                                       tabs["kmer_tab"], tabs["prof_a"],
                                       probe=True, group=group, **kw)
                check(errs, "exact_schedule",
                      f"{name}, -v {v}, probe, group {group}",
                      [got.ftot_rank], [want.ftot_rank])
            n += 1
    log(f"[{tag}] K2 '{cfg.chains_mode}' -s {cfg.S} -I {cfg.I}"
        f"{' on global counts' if gcnt is not None else ''}: {n} cases "
        f"(rows as read, cut to 51 nt, built to tie; -v "
        f"{'/'.join(map(str, budgets))}) x slot rows and probe x groups of "
        f"{' and '.join(map(str, K.k2_groups(cfg)))} lanes — kernels == "
        "twins")


def k1_synthetic_cases(K, cfg, rows, kmer_tab, seed: int = 11):
    """K1's cases beyond what real windows reach, on ``rows`` (a window's
    dispatch rows, torch, on kmer_tab's device): a copy of ``kmer_tab``
    whose rows at the window's probed buckets (both chains under 'b') get
    synthetic counts, read by read in turn: every probe of a read one count
    (all segment costs tie), segments equal in pairs, counts near and past
    the 2^27 total clamp, counts of 2^30 and 2^31 - 1 and negative ones
    (segment costs and per-rank sums that wrap int32), and the read's own
    counts.  Returns (table, [(name, rows), ...]): the rows as read; cut to
    random lengths (probes past len - S are not fresh, fewer segments);
    budgets that give seedseg < maxseg; maxrank 0; maxrank >= maxseg."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    m, MS, I, S, nw = rows.shape[0], cfg.maxseg, cfg.I, cfg.S, cfg.nw
    shape = (m, MS, I)
    pairs = rng.integers(0, 40, size=(m, MS, I))
    pairs = pairs[:, np.arange(MS) // 2 * 2]              # segments 2j, 2j+1
    patterns = [
        np.broadcast_to(rng.integers(0, 60, size=(m, 1, 1)), shape),
        pairs,
        (1 << 27) + rng.integers(-2, 3, size=shape)
        * rng.choice([1, 1 << 26], size=shape),
        rng.choice([1 << 30, (1 << 30) + 7, (1 << 31) - 1, -5, 3], size=shape),
    ]
    counts = np.zeros(shape, np.int64)
    for p, pat in enumerate(patterns):
        counts[p::len(patterns) + 1] = pat[p::len(patterns) + 1]
    own = np.arange(m) % (len(patterns) + 1) == len(patterns)
    tab = kmer_tab.clone()
    k_nat = K._fixed_probe_offsets(cfg)
    fwd, rc = K.chain_inputs(cfg, rows)
    vals = torch.from_numpy(counts.reshape(m, -1)[~own].astype(np.int32))
    for r in [fwd] + ([rc] if rc is not None else []):
        buckets = K._seeds(K._unpack(r)[1], k_nat, S)[torch.from_numpy(~own)
                                                       .to(r.device)]
        tab[buckets.reshape(-1), 1] = vals.to(tab.device).reshape(-1)
    r_np = rows.cpu().numpy()
    lens = r_np[:, 2 * nw]
    cut = r_np.copy()
    cut[:, 2 * nw] = rng.integers(np.minimum(S, lens), lens + 1)
    low = r_np.copy()
    low[:, 2 * nw + 1] = rng.integers(0, max(MS - 1, 1), size=m)
    rank0 = r_np.copy()
    rank0[:, 2 * nw + 3] = 0
    past = r_np.copy()
    past[:, 2 * nw + 3] = MS + rng.integers(0, 4, size=m)
    dev = rows.device
    return tab, [(name, torch.from_numpy(x).to(dev)) for name, x in (
        ("as read", r_np), ("cut to random lengths", cut),
        ("seedseg < maxseg", low), ("maxrank 0", rank0),
        ("maxrank >= maxseg", past))]


def phase_k1_cases(K, cfg, rows, kmer_tab, errs: dict, tag: str) -> None:
    """K1 against its twin on ``k1_synthetic_cases``, with every group
    width the kernel takes (``k1_groups``)."""
    tab, cases = k1_synthetic_cases(K, cfg, rows, kmer_tab)
    n = 0
    for name, r in cases:
        fwd, rc = K.chain_inputs(cfg, r)
        want = K.fixed_schedule_plain(cfg, fwd, tab, rc)
        for group in K.k1_groups(cfg):
            got = K.fixed_schedule(cfg, fwd, tab, rc, group=group)
            check(errs, "fixed_schedule", f"synthetic table, {name}, group "
                  f"{group}", got, want)
        n += 1
    log(f"[{tag}] K1 '{cfg.chains_mode}' -s {cfg.S} -I {cfg.I} -v "
        f"{cfg.maxseg - 1}: {n} cases on a synthetic table (ties, counts "
        f"near 2^27, wrapping sums; cut reads, seedseg < maxseg, maxrank 0 "
        f"and >= maxseg) x groups of "
        f"{' and '.join(map(str, K.k1_groups(cfg)))} lanes — kernels == "
        "twins")


def k6_synthetic_rows(cfg, n: int, seed: int = 13, valid: int | None = None):
    """Both mates' full K4 rows and dispatch rows (numpy int32) for K6's
    cases beyond real windows, pair by pair in turn: all ``cfg.hits_k``
    hits valid on both mates with every combo eligible at one level (cnt =
    K*K: the key rank over all combos, the max_hits bit); no valid hit on
    mate 2; valid hits scattered, not a prefix; ssum past K (unpaired draws
    jj >= K); inserts at min_ins and max_ins and one past each; hits near
    the int32 limits (inserts that wrap); and random hits (levels 0-3,
    both chains, three chromosomes).  With ``valid`` every pair is the
    first case with only its first ``valid`` hits valid on each mate
    (valid**2 eligible combos), for timing K6 by live hits."""
    import numpy as np
    rng = np.random.default_rng(seed)
    MS, K, nw = cfg.maxseg, cfg.hits_k, cfg.nw
    base = 2 * MS + 17
    lo_i, hi_i = cfg.min_ins, cfg.max_ins
    ra = rng.integers(-2 ** 31, 2 ** 31, size=(n, base + 2 * K),
                      dtype=np.int64)
    rb = rng.integers(-2 ** 31, 2 ** 31, size=(n, base + 2 * K),
                      dtype=np.int64)
    ia = rng.integers(-2 ** 31, 2 ** 31, size=(n, 2 * nw + 4), dtype=np.int64)
    ib = rng.integers(-2 ** 31, 2 ** 31, size=(n, 2 * nw + 4), dtype=np.int64)
    for d in (ia, ib):
        d[:, 2 * nw] = rng.integers(30, 151, size=n)           # len
        d[:, 2 * nw + 1] = rng.integers(0, 6, size=n)          # budget
    for r in (ra, rb):
        ex = r[:, 2 * MS:]
        ex[:, 0] = rng.integers(0, 2, size=n)                  # X_FOUND
        ex[:, 1] = rng.integers(0, 4, size=n)                  # X_II
        ex[:, 2] = rng.integers(0, 12, size=n)                 # X_SSUM
        ex[:, 9] = rng.integers(0, 2, size=n)                  # X_REPLAY
        ex[:, 13] = rng.integers(0, 2, size=n)                 # X_OK
        ex[:, 16] = rng.integers(-5, 1 << 27, size=n)          # X_FTOT

    def w1(w, ch, rk, cp):
        return w | (ch << 4) | (rk << 5) | (cp << 9)

    locs = rng.integers(1000, 1_000_000, size=(n, 2, K))
    w = rng.integers(0, 4, size=(n, 2, K))
    hit_w1 = w1(w, rng.integers(0, 2, size=(n, 2, K)),
                rng.integers(0, 4, size=(n, 2, K)) % (w + 1),
                rng.integers(0, 3, size=(n, 2, K)))
    hit_w1[rng.random((n, 2, K)) < 0.3] = -1
    n_case = 7
    # every combo eligible at level 0: mate 2 (chain 1) lies mid-window
    # downstream of mate 1 (chain 0), hits in shuffled locus order
    c0 = (np.arange(n) % n_case == 0) if valid is None else np.ones(n, bool)
    n0 = int(c0.sum())
    ia[c0, 2 * nw + 1] = ib[c0, 2 * nw + 1] = 3
    a0 = rng.integers(1000, 10 ** 6, size=n0)
    mid = (lo_i + hi_i) // 2 - ib[c0, 2 * nw]
    locs[c0, 0] = a0[:, None] + np.argsort(rng.random((n0, K)), axis=1)
    locs[c0, 1] = (a0 + mid)[:, None] + np.argsort(rng.random((n0, K)),
                                                   axis=1)
    hit_w1[c0, 0] = w1(0, 0, 0, 2)
    hit_w1[c0, 1] = w1(0, 1, 0, 2)
    for p in np.nonzero(~c0)[0]:
        case = p % n_case
        if case == 1:               # no valid hit on mate 2
            hit_w1[p, 1] = -1
        elif case == 2:             # valid hits scattered
            hit_w1[p, :, ::2] = -1
            if K > 1:
                hit_w1[p, :, 1::2] = np.where(hit_w1[p, :, 1::2] < 0,
                                              w1(1, 0, 0, 1),
                                              hit_w1[p, :, 1::2])
        elif case == 3:             # unpaired draws past K
            ra[p, 2 * MS + 2] = rb[p, 2 * MS + 2] = K + 20 + p % 50
        elif case == 4:             # inserts at and beside the bounds
            la = int(ia[p, 2 * nw])
            a0 = int(rng.integers(10 ** 5, 10 ** 6))
            for k in range(K):
                ins = (lo_i, hi_i, lo_i - 1, hi_i + 1)[k % 4]
                # mate 1 on chain 1 of chromosome 2: an A-end insert
                locs[p, 0, k] = a0
                locs[p, 1, k] = a0 + la - ins
            hit_w1[p, 0] = w1(1, 1, 0, 2)
            hit_w1[p, 1] = w1(1, 0, 0, 2)
            ia[p, 2 * nw + 1] = ib[p, 2 * nw + 1] = 2
        elif case == 5:             # hits near the int32 limits
            locs[p, 0] = 2 ** 31 - 1 - rng.integers(0, 200, size=K)
            locs[p, 1] = -2 ** 31 + rng.integers(0, 200, size=K)
            hit_w1[p, 0] = w1(0, 0, 0, 0)
            hit_w1[p, 1] = w1(0, 1, 0, 0)
    if valid is not None:
        hit_w1[:, :, valid:] = -1
    ra[:, base: base + K] = locs[:, 0]
    rb[:, base: base + K] = locs[:, 1]
    ra[:, base + K:] = hit_w1[:, 0]
    rb[:, base + K:] = hit_w1[:, 1]
    return tuple(x.astype(np.int32) for x in (ra, rb, ia, ib))


K6_HITS = (16, 4, 1)          # the hits_k of K6's synthetic rows


def phase_k6_cases(K, cfg, n: int, dev, errs: dict, tag: str) -> None:
    """K6 against its twin on ``k6_synthetic_rows`` of ``n`` pairs, at
    each of ``K6_HITS``, with the cfg's -w and with -w K*K (the pairs whose
    every combo is eligible then set the max_hits bit)."""
    import torch
    for hk in K6_HITS:
        for w in (cfg.max_num_hits, hk * hk):
            c = cfg._replace(hits_k=hk, max_num_hits=w)
            ra, rb, ia, ib = (torch.from_numpy(x).to(dev)
                              for x in k6_synthetic_rows(c, n))
            check(errs, "pair_join", f"synthetic rows, K = {hk}, -w {w}",
                  [K.pair_join(c, ra, rb, ia, ib)],
                  [K.pair_join_plain(c, ra, rb, ia, ib)])
    log(f"[{tag}] K6 on {n} synthetic pairs (all combos eligible, no hit "
        f"on a mate, scattered hits, draws past K, inserts at the bounds "
        f"and across the int32 wrap) at K = "
        f"{'/'.join(map(str, K6_HITS))}, -w {cfg.max_num_hits} and K*K — "
        "kernels == twins")


def live_combos(cfg, rows_a, rows_b) -> int:
    """The sum over pairs of valid hits of mate 1 times valid hits of mate
    2 in both mates' full rows: the combos K6 walks."""
    base = 2 * cfg.maxseg + 17 + cfg.hits_k
    na = (rows_a[:, base: base + cfg.hits_k] >= 0).sum(dim=1)
    nb = (rows_b[:, base: base + cfg.hits_k] >= 0).sum(dim=1)
    return int((na * nb).sum())


_PHASE_S: dict = {}
_LAST_LOG = [time.time()]


def log(msg: str) -> None:
    """Print one progress line; the seconds since the previous line are
    booked to the line's leading [phase] tag, or that of a ``launches,
    [phase]`` line (``_PHASE_S``, printed in the summary)."""
    now = time.time()
    m = re.match(r"\s*(?:launches, )?\[(\w+)\]", msg)
    if m:
        _PHASE_S[m.group(1)] = _PHASE_S.get(m.group(1), 0.0) \
            + now - _LAST_LOG[0]
    _LAST_LOG[0] = now
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def run_cli(argv: list[str], mesh=None) -> dict:
    """``cli.run`` in this process with its progress lines kept quiet;
    returns the alignment stats.  ``mesh``: the device list of the mesh
    engines."""
    from bsmap_tpu_torch import cli
    stats: dict = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run(argv, stats=stats, mesh=mesh)
    if rc != 0:
        raise RuntimeError(f"cli.run returned {rc}:\n{buf.getvalue()}")
    stats["log"] = buf.getvalue()
    return stats


def check(errs: dict, name: str, case: str, got, want) -> None:
    """Kernel outputs against twin outputs: equal shapes, max |diff| 0;
    the largest difference seen is kept in ``errs[name]``."""
    import torch
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape:
            raise AssertionError(f"{name} [{case}] output {i}: shape "
                                 f"{tuple(a.shape)} != {tuple(b.shape)}")
        d = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0
        errs[name] = max(errs.get(name, 0), d)
        if d != 0:
            raise AssertionError(f"{name} [{case}] output {i} differs "
                                 f"from its twin (max |diff| {d})")


def timed_pair(name: str, kern, plain, what: str) -> dict:
    """Kernel and twin timed in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                      cuda_ms(plain))
    log(f"    {name}: kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} "
        f"ms ({what})")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2)}


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def device_ms(res: dict, timed: dict, what: str) -> None:
    """For every kernel of ``timed``, the card's own time for a call
    (``queued_ms``) beside the wrapper call's event time:
    res[name]["device_ms"]."""
    for name, (kern, _plain) in timed.items():
        res[name]["device_ms"] = queued_ms(kern)
        log(f"    {what} {name}: {_ms(res[name]['device_ms'])} a call on the "
            "card (calls queued behind a hold)")


def _least(*ts):
    """The least of the times that were measured (None: not measured)."""
    ts = [t for t in ts if t is not None]
    return min(ts) if ts else None


def timed_forms(name: str, key: str, forms: tuple, call, clock=None) -> dict:
    """Two forms of one kernel (``forms[0]`` the one in use) timed in turns
    (a, b, b, a) by ``clock`` (default ``cuda_ms``, the wrapper call's event
    time; ``queued_ms`` for the card's own time); returns {key: forms[0],
    "<key>_ms": its time, "other_<key>": forms[1], "other_<key>_ms": its
    time} and logs both."""
    a, b = forms
    t = [(clock or cuda_ms)(lambda f=f: call(f)) for f in (a, b, b, a)]
    ta, tb = _least(t[0], t[3]), _least(t[1], t[2])
    log(f"    {name}: {key} {a} {_ms(t[0])}/{_ms(t[3])}, {key} {b} "
        f"{_ms(t[1])}/{_ms(t[2])}")
    return {key: a, f"{key}_ms": ta, f"other_{key}": b,
            f"other_{key}_ms": tb}


def kernel_parts_ms(fn, reps: int = 5) -> dict:
    """Device time per CUDA kernel name, ms per launch (each of K3's kernels
    launches once a call), from a torch.profiler trace of ``reps`` calls of
    ``fn``: the kernel's time over the launches the trace recorded, since a
    later profiler session of one process sometimes records only some of
    them.  A trace that holds no device event is taken once more; {} when
    that one is empty too."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for _attempt in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if t and ev.count and ev.device_type.name == "CUDA":
                out[ev.key.split("(")[0]] = round(t / 1000.0 / ev.count, 5)
        if out:
            break
    return out


def ptxas_report(text: str) -> dict:
    """The build log's ptxas resources (-Xptxas -v) per source file and
    entry function: {source: [{"fn", "registers", "smem", "stack",
    "spill"}]}, the function name shortened from its mangled form (its
    integer template arguments in angle brackets)."""
    out: dict = {}
    src, cur = "", None
    for line in text.splitlines():
        if " -c " in line and line.rstrip().endswith(".cu"):  # an nvcc line
            src = os.path.basename(line.split()[-1])
            continue
        m = re.search(r"Compiling entry function '(_Z(\d+)(\w+))'", line)
        if m:
            n = int(m.group(2))
            args = re.findall(r"Li(\d+)E", m.group(3)[n:])
            fn = m.group(3)[:n] + (f"<{','.join(args)}>" if args else "")
            cur = {"fn": fn}
            out.setdefault(src, []).append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            cur["stack"], cur["spill"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def phase_build() -> dict:
    """Build the kernels; returns and logs the build's ``ptxas_report``."""
    from bsmap_tpu_torch.engine import _build
    t0 = time.time()
    so = _build.build()
    _build.lib()
    log(f"[1] kernels built in {time.time() - t0:.1f} s: {os.path.basename(so)}")
    report = {}
    if os.path.exists(so[:-3] + ".log"):        # written by the build
        with open(so[:-3] + ".log") as f:
            report = ptxas_report(f.read())
    for src, fns in sorted(report.items()):
        for r in fns:
            log(f"    ptxas {src} {r['fn']}: {r.get('registers')} registers, "
                f"{r.get('smem')} B shared, {r.get('stack')} B stack, "
                f"{r.get('spill')} B spill stores")
    return report


def check_index_cache(o, index, tag: str) -> None:
    """The index cache written by ``get_index`` memory-maps back equal."""
    import numpy as np
    from bsmap_tpu_torch.index import index_cache_key, load_index
    path = os.path.join(o.index_cache,
                        f"idx_{index_cache_key(o.ref_file, o.param)}.npz")
    mapped = load_index(path, mmap=True)
    if not (isinstance(mapped.locs, np.memmap)
            and np.array_equal(mapped.locs, index.locs)
            and np.array_equal(mapped.offsets, index.offsets)):
        raise AssertionError(f"{tag}: the memory-mapped index cache differs")


def phase_data(root: str, gen, tag: str, flags=ALIGN_FLAGS,
               phase: str = "2", **kw):
    """Generate one dataset, build its genome and index, and check that the
    index cache (``BSMAP_TPU_INDEX_CACHE``, which every CLI run below
    loads) memory-maps back equal."""
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.reference import load_genome
    d = os.path.join(root, tag)
    t0 = time.time()
    gpath, rpath = gen(d, **kw)
    t1 = time.time()
    o = parse_args(["-a", rpath, "-d", gpath, "-o", "x.sam"] + flags)
    genome = load_genome(gpath, o.param)
    index = get_index(o, genome)
    check_index_cache(o, index, tag)
    log(f"[{phase}] {tag}: data {t1 - t0:.1f} s, genome+index "
        f"{time.time() - t1:.1f} s ({genome.sum_length} bp, "
        f"{len(index.locs)} index entries; cache memory-maps)")
    return gpath, rpath, o, genome, index


def phase_kernels(o, genome, index, rpath: str, dev: str = "cuda",
                  mode: str = "f", phase: str = "3") -> dict:
    """Each kernel against its twin on the first window, on the forward
    chain or (``mode`` 'b', -n 1) on both chains with K5's rc rows; returns
    per-kernel {max_abs_err, ms, plain_ms, bound_ms, bound_by}.  (``dev`` =
    "cpu" rehearses the plumbing with the twins on both sides and no
    timing.)"""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine

    eng = DeviceEngine(genome, index, o.param, device=dev)
    stream = BlockReadStream(rpath, o.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    MS = eng._maxseg
    rows0 = torch.from_numpy(rows_np).to(dev)              # round 1: rank 0
    rows_np = rows_np.copy()
    rows_np[:, -1] = MS - 1
    rowsF = torch.from_numpy(rows_np).to(dev)              # round 2: full rank
    cfg_lean = eng._cfg(mode, lean=True, nw=nw)
    both = mode == "b"
    rc0 = K.rc_words(cfg_lean, rows0) if both else None
    rcF = K.rc_words(cfg_lean, rowsF) if both else None
    cases = [
        ("fixed lean, small tier", cfg_lean._replace(fixed=True), eng.CANDS,
         rows0, rc0),
        ("exact lean, small tier", cfg_lean, eng.CANDS, rows0, rc0),
        ("exact lean, big tier", cfg_lean, eng.CANDS_BIG, rowsF, rcF),
        ("exact full, big tier", cfg_lean._replace(lean=False),
         eng.CANDS_BIG, rowsF, rcF),
        ("probe", cfg_lean._replace(probe=True, lean=False), 1, rowsF, rcF),
    ]
    names = SE_PATH + (("rc_words",) if both else ())
    errs = {k: 0 for k in names}
    tabs = eng.tables
    if both:
        for rows, rc in ((rows0, rc0), (rowsF, rcF)):
            check(errs, "rc_words", "rc rows", [rc],
                  [K.rc_words_plain(cfg_lean, rows)])
    for case, cfg, cands, rows, rc in cases:
        if cfg.probe:
            got = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                   tabs["prof_a"], probe=True, rows_rc=rc)
            want = K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                          tabs["prof_a"], probe=True,
                                          rows_rc=rc)
            check(errs, "exact_schedule", case, [got.ftot_rank],
                  [want.ftot_rank])
            continue
        if cfg.fixed:
            slots = K.fixed_schedule(cfg, rows, tabs["kmer_tab"], rc)
            want = K.fixed_schedule_plain(cfg, rows, tabs["kmer_tab"], rc)
            check(errs, "fixed_schedule", case, slots, want)
        else:
            slots = K.exact_schedule(cfg, rows, tabs["kmer_tab"],
                                     tabs["prof_a"], rows_rc=rc)
            want = K.exact_schedule_plain(cfg, rows, tabs["kmer_tab"],
                                          tabs["prof_a"], rows_rc=rc)
            check(errs, "exact_schedule", case, slots, want)
        vc = K.verify_candidates(cfg, cands, rows, slots, tabs, rc)
        check(errs, "verify_candidates", case, vc,
              K.verify_candidates_plain(cfg, cands, rows, slots, tabs, rc))
        out = K.reduce_reads(cfg, cands, rows, vc, slots)
        check(errs, "reduce_reads", case, [out],
              [K.reduce_reads_plain(cfg, cands, rows, vc, slots)])
        n_total = int(vc.starts[-1])
        if cfg.lean:
            found = int((out[:, 1] & 1).sum())
            rc_picks = int(((out[:, 1] & 3) == 3).sum())
        else:
            found = int(out[:, 2 * MS].sum())
            rc_picks = int(((out[:, 2 * MS] != 0)
                            & (out[:, 2 * MS + K.X_CHAIN] == 1)).sum())
        log(f"[{phase}] '{mode}' {case}: {rows.shape[0]} reads, {n_total} "
            f"candidates, {found} found ({rc_picks} on the rc chain) — "
            "kernels == twins")

    # times at the main path's shapes: round 1 (fixed, small tier) for
    # K1/K3/K4 (and K5), the full-rank exact schedule for K2
    cfg_f = cfg_lean._replace(fixed=True)
    s_f = K.fixed_schedule(cfg_f, rows0, tabs["kmer_tab"], rc0)
    # what no real window reaches: K3 on synthetic slot counts (in place
    # of this window's), K2 on short and tying reads at larger budgets
    phase_k3_synthetic(K, cfg_f, eng.CANDS, rows0, s_f, tabs, rc0, errs,
                       phase)
    phase_k2_cases(K, cfg_lean, rows0.cpu().numpy(), tabs, dev, errs, phase)
    phase_k1_cases(K, cfg_f, rows0, tabs["kmer_tab"], errs, phase)
    cfg_x = cfg_lean._replace(lean=False)
    s_x = K.exact_schedule(cfg_x, rowsF, tabs["kmer_tab"], tabs["prof_a"],
                           rows_rc=rcF)
    tiers = (eng.CANDS, eng.CANDS_BIG)
    phase_k4_cases(K, [(f"'{mode}' lean fixed", cfg_f, rows0, rc0, s_f,
                        tiers),
                       (f"'{mode}' full", cfg_x, rowsF, rcF, s_x, tiers)],
                   tabs, errs, phase)
    del s_x
    vc_f = K.verify_candidates(cfg_f, eng.CANDS, rows0, s_f, tabs, rc0)
    ncand = min(int(vc_f.starts[-1]), eng.CANDS)
    timed = {
        "fixed_schedule": (
            lambda: K.fixed_schedule(cfg_f, rows0, tabs["kmer_tab"], rc0),
            lambda: K.fixed_schedule_plain(cfg_f, rows0, tabs["kmer_tab"],
                                           rc0)),
        "exact_schedule": (
            lambda: K.exact_schedule(cfg_lean, rowsF, tabs["kmer_tab"],
                                     tabs["prof_a"], rows_rc=rcF),
            lambda: K.exact_schedule_plain(cfg_lean, rowsF, tabs["kmer_tab"],
                                           tabs["prof_a"], rows_rc=rcF)),
        "verify_candidates": (
            lambda: K.verify_candidates(cfg_f, eng.CANDS, rows0, s_f, tabs,
                                        rc0),
            lambda: K.verify_candidates_plain(cfg_f, eng.CANDS, rows0, s_f,
                                              tabs, rc0)),
        "reduce_reads": (
            lambda: K.reduce_reads(cfg_f, eng.CANDS, rows0, vc_f, s_f),
            lambda: K.reduce_reads_plain(cfg_f, eng.CANDS, rows0, vc_f,
                                         s_f)),
    }
    if both:
        timed["rc_words"] = (lambda: K.rc_words(cfg_f, rows0),
                             lambda: K.rc_words_plain(cfg_f, rows0))
    res = {}
    m = rows0.shape[0]
    for name, (kern, plain) in timed.items():
        res[name] = {"max_abs_err": errs[name],
                     **bound(name, cfg_f, m, ncand, eng.CANDS)}
        if dev == "cuda":
            res[name].update(timed_pair(f"[{phase}] '{mode}' {name}", kern,
                                        plain, f"{m} reads; bound "
                                        f"{res[name]['bound_ms']:.4f} ms"))
    if dev == "cuda":
        # the other launch form of K3 and the other group width of K2, in
        # turns with the ones in use; K3's parts by kernel name; and, as a
        # yardstick for the scan part alone (the port never calls it), one
        # library scan of the same counts
        what = f"[{phase}] '{mode}'"
        v, (g, g_other) = K.K3_VARIANT, K.k2_groups(cfg_lean)
        res["verify_candidates"].update(timed_forms(
            f"{what} verify_candidates launch form", "variant", (v, 1 - v),
            lambda form: K.verify_candidates(cfg_f, eng.CANDS, rows0, s_f,
                                             tabs, rc0, variant=form)))
        res["exact_schedule"].update(timed_forms(
            f"{what} exact_schedule lanes per read", "group", (g, g_other),
            lambda form: K.exact_schedule(cfg_lean, rowsF, tabs["kmer_tab"],
                                          tabs["prof_a"], rows_rc=rcF,
                                          group=form)))
        res["fixed_schedule"].update(timed_forms(
            f"{what} fixed_schedule lanes per read, on the card",
            "card_group", K.k1_groups(cfg_f)[:2],
            lambda form: K.fixed_schedule(cfg_f, rows0, tabs["kmer_tab"],
                                          rc0, group=form), clock=queued_ms))
        # the same call on the window's first 32 reads (one warp): the
        # floor of launch and one read's chain of loads
        res["reduce_reads"]["card_floor_ms"] = queued_ms(
            lambda: K.reduce_reads(cfg_f, eng.CANDS, rows0[:32], vc_f, s_f))
        log(f"    {what} reduce_reads on 32 reads: "
            f"{_ms(res['reduce_reads']['card_floor_ms'])} a call on the card")
        device_ms(res, timed, what)
        for kname, form, fn in (
                ("verify_candidates", 1 - v, lambda: K.verify_candidates(
                    cfg_f, eng.CANDS, rows0, s_f, tabs, rc0, variant=1 - v)),
                ("exact_schedule", g_other, lambda: K.exact_schedule(
                    cfg_lean, rowsF, tabs["kmer_tab"], tabs["prof_a"],
                    rows_rc=rcF, group=g_other))):
            res[kname]["other_device_ms"] = queued_ms(fn)
            log(f"    {what} {kname}, the other form ({form}): "
                f"{_ms(res[kname]['other_device_ms'])} a call on the card")
        # K3's parts (scan, verify, dedup) by kernel name, both forms
        for form in (v, 1 - v):
            parts = kernel_parts_ms(lambda: K.verify_candidates(
                cfg_f, eng.CANDS, rows0, s_f, tabs, rc0, variant=form))
            log(f"    {what} verify_candidates variant {form}, ms per launch "
                f"by kernel (torch.profiler): {json.dumps(parts)}")
            if form == v and parts:
                res["verify_candidates"]["parts_ms"] = parts
        flat = s_f.cnt.reshape(-1)
        lib = cuda_ms(lambda: torch.cumsum(
            flat.clamp(max=2 ** 30).long(), 0))
        log(f"    {what} torch.cumsum of the {flat.numel()} clamped counts "
            f"(int64): {lib:.4f} ms (yardstick for K3's scan part only)")
        res["verify_candidates"]["scan_cumsum_ms"] = lib
    del eng, tabs, s_f, vc_f, rows0, rowsF, rc0, rcF
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_align(tag: str, gpath: str, rpath: str, out: str,
                n_reads: int, min_mapped: float, dev: str = "cuda",
                flags=ALIGN_FLAGS) -> dict:
    """One full CLI run on the card; checks the read count and the mapped
    share, prints reads/s and the engine counters."""
    st = run_cli(["-a", rpath, "-d", gpath, "-o", out, "--device", dev]
                 + flags)
    eng = st["engine"]
    if st["reads"] != n_reads:
        raise AssertionError(f"{tag}: aligned {st['reads']} of {n_reads}")
    with open(out, "rb") as f:
        lines = sum(1 for ln in f if not ln.startswith(b"@"))
    if not min_mapped * n_reads <= lines <= n_reads:
        raise AssertionError(f"{tag}: {lines} SAM records for {n_reads} "
                             f"fully converted reads (at least "
                             f"{min_mapped:.0%} expected)")
    rate = st["reads"] / st["align_s"]
    log(f"[{tag}] {st['reads']} reads in {st['align_s']:.3f} s = "
        f"{rate:.1f} reads/s; {lines} mapped; n_dispatched "
        f"{eng.n_dispatched}, n_probe {eng.n_probe}, n_replayed "
        f"{eng.n_replayed}, probe_mode {eng.probe_mode}; engine "
        f"{st['engine_name']}")
    return {"reads_per_s": rate, "align_s": st["align_s"],
            "n_dispatched": eng.n_dispatched, "n_probe": eng.n_probe,
            "n_replayed": eng.n_replayed}


def assert_same_file(tag: str, got: str, want: str) -> int:
    """The GPU run's file byte-identical to the host engine's; returns its
    size."""
    with open(got, "rb") as f:
        a = f.read()
    with open(want, "rb") as f:
        b = f.read()
    if a != b:
        la, lb = a.splitlines(), b.splitlines()
        bad = next(i for i in range(min(len(la), len(lb)) + 1)
                   if i >= min(len(la), len(lb)) or la[i] != lb[i])
        raise AssertionError(f"{tag}: GPU output {os.path.basename(got)} "
                             f"differs from the host engine at line {bad}")
    return len(a)


def phase_parity(tag: str, gpath: str, rpath: str, d: str,
                 dev: str = "cuda", flags=ALIGN_FLAGS,
                 phase: str = "6") -> None:
    outs = []
    for eng in (["--device", dev], ["--engine", "host"]):
        outs.append(os.path.join(d, f"parity_{eng[1]}.sam"))
        run_cli(["-a", rpath, "-d", gpath, "-o", outs[-1], "-E",
                 str(N_PARITY)] + flags + eng)
    size = assert_same_file(tag, *outs)
    log(f"[{phase}] {tag}: first {N_PARITY} reads byte-identical to the "
        f"host engine ({size} bytes)")


def phase_pe_data(root: str):
    """Generate the pair-end dataset and build its genome and index."""
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.reference import load_genome
    from tools.genreads import generate_pe
    t0 = time.time()
    gpath, r1, r2 = generate_pe(os.path.join(root, "pe"))
    t1 = time.time()
    o = parse_args(["-a", r1, "-b", r2, "-d", gpath, "-o", "x.sam"]
                   + PE_FLAGS)
    genome = load_genome(gpath, o.param)
    index = get_index(o, genome)
    check_index_cache(o, index, "pe")
    log(f"[7] pe: data {t1 - t0:.1f} s, genome+index {time.time() - t1:.1f} "
        f"s ({genome.sum_length} bp, {len(index.locs)} index entries; "
        "cache memory-maps)")
    return gpath, r1, r2, o, genome, index


def phase_pe_kernels(o, genome, index, r1: str, r2: str,
                     dev: str = "cuda", phase: str = "8") -> dict:
    """The pair-end kernels against their twins on the first window:
    rc_words, both mates' K2/K3/K4 (cfg.pe, 16 hits; mate 2 on the rc
    chain, or both mates on both chains under -n 1) at rank 0 on the small
    tier and at full rank on both tiers, and pair_join.  Returns per-kernel
    {max_abs_err, bound_ms, bound_by[, ms, plain_ms]} (times at the phase-1
    shapes: rank 0, small tier; K2-K5 on mate 2)."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.pair_device import PairDeviceEngine

    eng = PairDeviceEngine(genome, index, o.param, device=dev)
    se = eng.se
    blks = []
    for readset, path in ((1, r1), (2, r2)):
        stream = BlockReadStream(path, o.param, readset=readset,
                                 lib=native.get_lib())
        blks.append(stream.next_block(se.B))
        stream.close()
    nw, _live, _pos, ra_np, rb_np = eng.block_pair_rows(*blks)
    cfg_a, cfg_b = eng._cfg(1, nw), eng._cfg(2, nw)
    tabs = se.tables
    MS = se._maxseg
    errs = {k: 0 for k in PE_PATH}

    def to_dev(rows_np, rank):
        r = rows_np.copy()
        r[:, -1] = rank
        return torch.from_numpy(r).to(dev)

    window = {}
    for rank, cands, case in ((0, se.CANDS, "rank 0, small tier"),
                              (MS - 1, se.CANDS, "full rank, small tier"),
                              (MS - 1, se.CANDS_BIG, "full rank, big tier")):
        da, db = to_dev(ra_np, rank), to_dev(rb_np, rank)
        full, n_cand = [], []
        for cfg, rows in ((cfg_a, da), (cfg_b, db)):
            fwd, rc = K.chain_inputs(cfg, rows)
            if cfg.chains_mode != "f":
                check(errs, "rc_words", case, [rc if rc is not None else fwd],
                      [K.rc_words_plain(cfg, rows)])
            slots = K.exact_schedule(cfg, fwd, tabs["kmer_tab"],
                                     tabs["prof_a"], rows_rc=rc)
            check(errs, "exact_schedule", case, slots,
                  K.exact_schedule_plain(cfg, fwd, tabs["kmer_tab"],
                                         tabs["prof_a"], rows_rc=rc))
            vc = K.verify_candidates(cfg, cands, fwd, slots, tabs, rc)
            check(errs, "verify_candidates", case, vc,
                  K.verify_candidates_plain(cfg, cands, fwd, slots, tabs, rc))
            out = K.reduce_reads(cfg, cands, fwd, vc, slots)
            check(errs, "reduce_reads", case, [out],
                  [K.reduce_reads_plain(cfg, cands, fwd, vc, slots)])
            full.append(out)
            n_cand.append(int(vc.starts[-1]))
        j = K.pair_join(cfg_a, full[0], full[1], da, db)
        check(errs, "pair_join", case, [j],
              [K.pair_join_plain(cfg_a, full[0], full[1], da, db)])
        paired = int(((j[:, 6] & 31) > 0).sum())
        rc_pairs = int((((j[:, 6] & 31) > 0) & ((j[:, 6] >> 16) & 1 == 1))
                       .sum())
        log(f"[{phase}] '{cfg_a.chains_mode}'/'{cfg_b.chains_mode}' {case}: "
            f"{da.shape[0]} pairs, {n_cand[0]}/{n_cand[1]} candidates "
            f"(mate 1/2), {paired} paired ({rc_pairs} with mate 1 on the rc "
            "chain) — kernels == twins")
        window.setdefault("rows", (da, db, full, cands))
    phase_k6_cases(K, cfg_a, 14_000, dev, errs, phase)
    phase_k5_cases(K, cfg_b, dev, errs, phase)
    da, db, full, cands = window["rows"]
    fwd, rc = K.chain_inputs(cfg_b, db)
    s_b = K.exact_schedule(cfg_b, fwd, tabs["kmer_tab"], tabs["prof_a"],
                           rows_rc=rc)
    phase_k4_cases(K, [(f"mate 2 '{cfg_b.chains_mode}', {cfg_b.hits_k} hits",
                        cfg_b, fwd, rc, s_b, (se.CANDS, se.CANDS_BIG))],
                   tabs, errs, phase)
    vc_b = K.verify_candidates(cfg_b, cands, fwd, s_b, tabs, rc)
    m, ncand = da.shape[0], min(int(vc_b.starts[-1]), cands)
    res = {k: {"max_abs_err": v,
               **bound(k, cfg_b, m, ncand, cands)} for k, v in errs.items()}
    res["pair_join"].update(bound("pair_join", cfg_a, m,
                                  live=live_combos(cfg_a, *full)))
    if dev == "cuda":
        what = f"{m} pairs, mate 2, rank 0, small tier"
        timed = {
            "rc_words": (lambda: K.rc_words(cfg_b, db),
                         lambda: K.rc_words_plain(cfg_b, db)),
            "exact_schedule": (
                lambda: K.exact_schedule(cfg_b, fwd, tabs["kmer_tab"],
                                         tabs["prof_a"], rows_rc=rc),
                lambda: K.exact_schedule_plain(cfg_b, fwd, tabs["kmer_tab"],
                                               tabs["prof_a"], rows_rc=rc)),
            "verify_candidates": (
                lambda: K.verify_candidates(cfg_b, cands, fwd, s_b, tabs, rc),
                lambda: K.verify_candidates_plain(cfg_b, cands, fwd, s_b,
                                                  tabs, rc)),
            "reduce_reads": (
                lambda: K.reduce_reads(cfg_b, cands, fwd, vc_b, s_b),
                lambda: K.reduce_reads_plain(cfg_b, cands, fwd, vc_b, s_b)),
            "pair_join": (
                lambda: K.pair_join(cfg_a, full[0], full[1], da, db),
                lambda: K.pair_join_plain(cfg_a, full[0], full[1], da, db)),
        }
        for name, (kern, plain) in timed.items():
            res[name].update(timed_pair(
                f"[{phase}] {name}", kern, plain,
                f"{what}; bound {res[name]['bound_ms']:.4f} ms"))
        device_ms(res, timed, f"[{phase}]")
        res["rc_words"]["card_floor_ms"] = queued_ms(
            lambda: K.rc_words(cfg_b, db[:32]))
        log(f"    [{phase}] rc_words on 32 rows: "
            f"{_ms(res['rc_words']['card_floor_ms'])} a call on the card")
        # K6's card time on windows of synthetic pairs by valid hits a mate:
        # none (the per-pair floor), one (a clean pair), all K (K*K combos)
        by = {}
        for nv in (0, 1, cfg_a.hits_k):
            xs = [torch.from_numpy(x).to(dev)
                  for x in k6_synthetic_rows(cfg_a, m, valid=nv)]
            by[str(nv)] = queued_ms(lambda: K.pair_join(cfg_a, *xs))
        res["pair_join"]["card_by_valid_hits_ms"] = by
        log(f"    [{phase}] pair_join on {m} synthetic pairs, card ms by "
            f"valid hits a mate: {json.dumps(by)}")
    del eng, tabs, window, s_b, vc_b, fwd, rc
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_pe_align(gpath: str, r1: str, r2: str, out: str, n_pairs: int,
                   dev: str = "cuda", flags=PE_FLAGS,
                   phase: str = "9") -> dict:
    """The pair-end CLI run on the card; checks the pair count and the
    properly-paired share, prints pairs/s and the engine counters."""
    st = run_cli(["-a", r1, "-b", r2, "-d", gpath, "-o", out, "--device",
                  dev] + flags)
    eng = st["engine"]
    if st["pairs"] != n_pairs:
        raise AssertionError(f"pe: aligned {st['pairs']} of {n_pairs} pairs")
    proper = 0
    with open(out, "rb") as f:
        for ln in f:
            if not ln.startswith(b"@") and int(ln.split(b"\t", 2)[1]) & 2:
                proper += 1
    proper //= 2                                  # two records per pair
    if proper < 0.9 * n_pairs:
        raise AssertionError(f"pe: {proper} of {n_pairs} fully converted, "
                             "error-free pairs properly paired")
    rate = st["pairs"] / st["align_s"]
    log(f"[{phase}] {st['pairs']} pairs in {st['align_s']:.3f} s = {rate:.1f} "
        f"pairs/s; {proper} properly paired; n_dispatched "
        f"{eng.se.n_dispatched}, n_replayed {eng.n_replayed}")
    return {"pairs_per_s": rate, "align_s": st["align_s"],
            "n_dispatched": eng.se.n_dispatched,
            "n_replayed": eng.n_replayed}


def phase_pe_parity(gpath: str, r1: str, r2: str, d: str,
                    dev: str = "cuda") -> None:
    os.makedirs(d, exist_ok=True)
    outs = []
    for eng in (["--device", dev], ["--engine", "host"]):
        outs.append(os.path.join(d, f"pe_parity_{eng[1]}.sam"))
        run_cli(["-a", r1, "-b", r2, "-d", gpath, "-o", outs[-1], "-E",
                 str(N_PARITY)] + PE_FLAGS + eng)
    size = assert_same_file("pe", *outs)
    log(f"[10] pe: first {N_PARITY} pairs byte-identical to the host engine "
        f"({size} bytes)")


def make_pe_err_set(d: str, g: str, r1: str, r2: str) -> None:
    """Phase 11's data: 5,000 simulated pairs of 76 nt with 2% errors on a
    2 x 1 Mb genome, every 8th pair cut to 51 nt (stale-schedule reads: host
    replays)."""
    os.makedirs(d)
    t0 = time.time()
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "simulate.py"),
                    "--pe", "--n-reads", str(N_PARITY), "--read-len", "76",
                    "--n-chr", "2", "--chr-len", "1000000", "--error-rate",
                    "0.02", "--seed", "41", "--genome-out", g, "--reads-out",
                    r1, "--reads2-out", r2], check=True, timeout=600)
    for path in (r1, r2):                # every 8th pair to 51 nt
        with open(path) as f:
            lines = f.read().splitlines()
        for k in range(0, len(lines), 32):
            lines[k + 1], lines[k + 3] = lines[k + 1][:51], lines[k + 3][:51]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    log(f"[11] data: {N_PARITY} pairs of 76 nt (every 8th cut to 51 nt) "
        f"with 2% errors, 2 x 1 Mb genome, in {time.time() - t0:.1f} s")


def phase_pe_paths(root: str, dev: str = "cuda", extra=(),
                   phase: str = "11") -> dict:
    """Phase 11 (and with ``extra`` = -n 1, phase 18's part): simulated
    pairs with errors through the block path and the per-pair path on
    ``dev``, each against the host engine byte for byte; returns the
    kernels' launch counts summed over the two GPU runs, each of which must
    have launched every pair-end kernel.  The data is made once."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "pe_err")
    g, r1, r2 = (os.path.join(d, x) for x in ("ref.fa", "r1.fq", "r2.fq"))
    if not os.path.exists(r2):
        make_pe_err_set(d, g, r1, r2)
    total = {k: 0 for k in K.launch_counts()}
    for tag, flags, (suffix, *unpaired), min_disp, min_rep, engine in \
            PE_PATH_RUNS:
        flags = flags + list(extra)
        outs = {}
        for eng in (["--device", dev], ["--engine", "host"]):
            name = eng[1] + "".join(extra).replace("-", "_")
            files = [os.path.join(d, f"{name}.{suffix}")]
            argv = ["-o", files[0]]
            if unpaired:
                files.append(os.path.join(d, f"{name}_unpaired.{suffix}"))
                argv += ["-2", files[1]]
            outs[eng[0]] = files
            if eng[0] == "--engine":
                run_cli(["-a", r1, "-b", r2, "-d", g] + flags + argv + eng)
                continue
            K.reset_launch_counts()
            st = run_cli(["-a", r1, "-b", r2, "-d", g] + flags + argv + eng
                         + engine)
            counts = K.launch_counts()
            if st["pe_path"] != ("pairs" if engine else "blocks"):
                raise AssertionError(f"{tag}: ran the {st['pe_path']} "
                                     "path")
            missing = [k for k in PE_PATH if counts[k] == 0]
            if missing:
                raise AssertionError(f"{tag}: kernels never launched: "
                                     f"{missing}")
            for k, v in counts.items():
                total[k] += v
            engine = st["engine"]
            n_disp, n_rep = engine.se.n_dispatched, engine.n_replayed
            if n_disp < min_disp or n_rep < min_rep:
                raise AssertionError(f"{tag}: n_dispatched {n_disp}, "
                                     f"n_replayed {n_rep}: the path's "
                                     "corners did not run")
            t_gpu = st["align_s"]
        sizes = [assert_same_file(f"pe {tag}", a, b) for a, b in
                 zip(outs["--device"], outs["--engine"])]
        log(f"[{phase}] {tag} ({' '.join(flags)}, {suffix}): {N_PARITY} pairs "
            f"in {t_gpu:.3f} s on {dev}; n_dispatched {n_disp}, n_replayed "
            f"{n_rep}; launches {counts}; byte-identical to the host engine "
            f"({' + '.join(map(str, sizes))} bytes)")
    return total


def phase_rrbs_kernels(o, genome, index, rpath: str, dev: str = "cuda",
                       mode: str = "f", phase: str = "13") -> dict:
    """Phase 13 (and with ``mode`` 'b', phase 19's part): K2, K3 and K4
    with cfg.rrbs (on both chains under 'b', with K5's rc rows) against
    their twins on the first window of the RRBS reads (native trimming,
    full rank, the one big capacity tier), lean and full rows; returns
    per-kernel {max_abs_err, bound_ms, bound_by[, ms, plain_ms]} (times on
    the lean rows, the main path's SAM shapes)."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine

    eng = DeviceEngine(genome, index, o.param, device=dev)
    stream = BlockReadStream(rpath, o.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    MS = eng._maxseg
    rows_np = rows_np.copy()
    rows_np[:, -1] = MS - 1
    rows = torch.from_numpy(rows_np).to(dev)
    cfg_lean = eng._cfg(mode, lean=True, nw=nw)
    if not (cfg_lean.rrbs and eng.CANDS == eng.CANDS_BIG):
        raise AssertionError("RRBS engine without the rrbs cfg or the one "
                             "big capacity tier")
    tabs = eng.tables
    cands = eng.CANDS
    fwd, rc = K.chain_inputs(cfg_lean, rows)
    names = RRBS_PATH + (("rc_words",) if rc is not None else ())
    errs = {k: 0 for k in names}
    if rc is not None:
        check(errs, "rc_words", "rc rows", [rc],
              [K.rc_words_plain(cfg_lean, rows)])

    def schedule(cfg, plain=False):
        fn = K.exact_schedule_plain if plain else K.exact_schedule
        return fn(cfg, fwd, tabs["kmer_tab"], tabs["prof_a"],
                  tag_off=tabs["tag_off"], rows_rc=rc)

    for case, cfg in (("lean, big tier", cfg_lean),
                      ("full, big tier", cfg_lean._replace(lean=False))):
        slots = schedule(cfg)
        check(errs, "exact_schedule", case, slots, schedule(cfg, True))
        vc = K.verify_candidates(cfg, cands, fwd, slots, tabs, rc)
        check(errs, "verify_candidates", case, vc,
              K.verify_candidates_plain(cfg, cands, fwd, slots, tabs, rc))
        out = K.reduce_reads(cfg, cands, fwd, vc, slots)
        check(errs, "reduce_reads", case, [out],
              [K.reduce_reads_plain(cfg, cands, fwd, vc, slots)])
        info = vc.info
        n_first = int(((info & K.INFO_FIRST) != 0).sum())
        n_frag = int(((info & K.INFO_FRAG) != 0).sum())
        n_rc = int((((info >> K.INFO_CHAIN_SHIFT) & 1)
                    & ((info & K.INFO_FIRST) != 0)).sum())
        found = int((out[:, 1] & 1).sum()) if cfg.lean else \
            int(out[:, 2 * MS].sum())
        log(f"[{phase}] '{mode}' {case}: {rows.shape[0]} reads, "
            f"{int(vc.starts[-1])} candidates, {n_first} first of their key "
            f"({n_rc} on the rc chain), {n_frag} inside a valid fragment, "
            f"{found} found — kernels == twins")
    phase_k2_cases(K, cfg_lean, rows_np, tabs, dev, errs, phase,
                   budgets=(2, 4))
    s_l = schedule(cfg_lean)
    phase_k4_cases(K, [(f"RRBS '{mode}' lean", cfg_lean, fwd, rc, s_l,
                        (cands,)),
                       (f"RRBS '{mode}' full", cfg_lean._replace(lean=False),
                        fwd, rc, s_l, (cands,))], tabs, errs, phase)
    vc_l = K.verify_candidates(cfg_lean, cands, fwd, s_l, tabs, rc)
    m, ncand = rows.shape[0], min(int(vc_l.starts[-1]), cands)
    res = {k: {"max_abs_err": v, **bound(k, cfg_lean, m, ncand, cands)}
           for k, v in errs.items()}
    if dev == "cuda":
        timed = {
            "exact_schedule": (lambda: schedule(cfg_lean),
                               lambda: schedule(cfg_lean, True)),
            "verify_candidates": (
                lambda: K.verify_candidates(cfg_lean, cands, fwd, s_l, tabs,
                                            rc),
                lambda: K.verify_candidates_plain(cfg_lean, cands, fwd, s_l,
                                                  tabs, rc)),
            "reduce_reads": (
                lambda: K.reduce_reads(cfg_lean, cands, fwd, vc_l, s_l),
                lambda: K.reduce_reads_plain(cfg_lean, cands, fwd, vc_l,
                                             s_l)),
        }
        for name, (kern, plain) in timed.items():
            res[name].update(timed_pair(
                f"[{phase}] '{mode}' {name}", kern, plain,
                f"{m} RRBS reads, lean, big tier; bound "
                f"{res[name]['bound_ms']:.4f} ms"))
        device_ms(res, timed, f"[{phase}] '{mode}'")
        v, groups = K.K3_VARIANT, K.k2_groups(cfg_lean)
        res["verify_candidates"].update(timed_forms(
            f"[{phase}] '{mode}' verify_candidates launch form", "variant",
            (v, 1 - v), lambda form: K.verify_candidates(
                cfg_lean, cands, fwd, s_l, tabs, rc, variant=form)))
        res["exact_schedule"].update(timed_forms(
            f"[{phase}] '{mode}' exact_schedule lanes per read", "group",
            (groups[0], groups[-1]), lambda form: K.exact_schedule(
                cfg_lean, fwd, tabs["kmer_tab"], tabs["prof_a"],
                tag_off=tabs["tag_off"], rows_rc=rc, group=form)))
    del eng, tabs, rows, fwd, rc, s_l, vc_l
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_rrbs_set(root: str, dev: str = "cuda", extra=(),
                   phase: str = "15") -> dict:
    """Phase 15 (and with ``extra`` = -n 1, phase 19's part), second part:
    5,000 mixed-strand reads with mismatches on a two-chromosome digest
    (with -n 1 every second read reverse-complemented), SAM in a -m 100
    -x 150 window and BSP, each on ``dev`` against the host engine byte for
    byte; returns the launch counts summed over the GPU runs, each of which
    must launch K2-K4 (and K5 under -n 1) and never K1."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "rrbs_set")
    reads = os.path.join(d, "se.fq")
    if not os.path.exists(reads):
        os.makedirs(d)
        t0 = time.time()
        make_rrbs_set(d, n_reads=N_PARITY, chr_len=300_000)
        log(f"[15] data: {N_PARITY} mixed-strand RRBS reads, 2 x 0.3 Mb "
            f"digest, in {time.time() - t0:.1f} s")
    if extra:
        reads = nondirectional(reads, os.path.join(d, "nd.fq"))
    path = RRBS_PATH + (("rc_words",) if extra else ())
    total = {k: 0 for k in K.launch_counts()}
    for flags, suffix in RRBS_SET_RUNS:
        base = ["-a", reads, "-d", os.path.join(d, "rrbs.fa")] + flags \
            + list(extra)
        outs = [os.path.join(d, f"{e}.{suffix}") for e in ("gpu", "host")]
        K.reset_launch_counts()
        st = run_cli(base + ["-o", outs[0], "--device", dev])
        counts = K.launch_counts()
        if [k for k in path if counts[k] == 0] or counts["fixed_schedule"]:
            raise AssertionError(f"RRBS set {flags}: launches {counts}")
        for k, v in counts.items():
            total[k] += v
        run_cli(base + ["-o", outs[1], "--engine", "host"])
        size = assert_same_file(f"rrbs set {suffix}", *outs)
        log(f"[{phase}] {' '.join(base[4:])} ({suffix}): {N_PARITY} reads in "
            f"{st['align_s']:.3f} s on {dev}, n_replayed "
            f"{st['engine'].n_replayed}; launches {counts}; byte-identical "
            f"to the host engine ({size} bytes)")
    return total


def phase_small_seed(root: str, dev: str = "cuda", phase: str = "24") -> dict:
    """Phase 24: K2 at -s 12 -I 2 (a schedule of other proportions: 12-base
    seeds every second position) on phase 11's reads (76 nt, every 8th cut
    to 51 nt, 2% errors), first mates as single-end reads: the cases of
    ``phase_k2_cases`` on 'f' and 'b', then K3 and K4 on the -v 4
    full-rank slots; returns per-kernel {max_abs_err}."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine
    from bsmap_tpu_torch.reference import load_genome
    d = os.path.join(root, "pe_err")
    g, r1 = os.path.join(d, "ref.fa"), os.path.join(d, "r1.fq")
    o = parse_args(["-a", r1, "-d", g, "-o", "x.sam", "-s", "12", "-I", "2",
                    "-v", "4", "-S", "1"])
    genome = load_genome(g, o.param)
    eng = DeviceEngine(genome, get_index(o, genome), o.param, device=dev)
    stream = BlockReadStream(r1, o.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    rows_np = rows_np.copy()
    rows_np[:, -1] = eng._maxseg - 1
    errs = {k: 0 for k in RRBS_PATH + ("fixed_schedule",)}
    tabs = eng.tables
    for mode in ("f", "b"):
        cfg = eng._cfg(mode, nw=nw)
        phase_k2_cases(K, cfg, rows_np, tabs, dev, errs, phase)
        phase_k1_cases(K, cfg._replace(fixed=True),
                       torch.from_numpy(rows_np).to(dev), tabs["kmer_tab"],
                       errs, phase)
        rows, rc = K.chain_inputs(cfg, torch.from_numpy(rows_np).to(dev))
        slots = K.exact_schedule(cfg, rows, tabs["kmer_tab"], tabs["prof_a"],
                                 rows_rc=rc)
        vc = K.verify_candidates(cfg, eng.CANDS_BIG, rows, slots, tabs, rc)
        check(errs, "verify_candidates", f"-s 12 -I 2 '{mode}'", vc,
              K.verify_candidates_plain(cfg, eng.CANDS_BIG, rows, slots, tabs,
                                        rc))
        out = K.reduce_reads(cfg, eng.CANDS_BIG, rows, vc, slots)
        check(errs, "reduce_reads", f"-s 12 -I 2 '{mode}'", [out],
              [K.reduce_reads_plain(cfg, eng.CANDS_BIG, rows, vc, slots)])
        log(f"[{phase}] -s 12 -I 2 -v 4 '{mode}': {rows.shape[0]} reads, "
            f"{cfg.NB} slots a read, {int(vc.starts[-1])} candidates, "
            f"{int(out[:, 2 * cfg.maxseg].sum())} found — kernels == twins")
    del eng, tabs
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {k: {"max_abs_err": v} for k, v in errs.items()}


def k7_cands_per_read(c, cands: int, vcs, dev) -> list:
    """[mean, max] of a window's in-capacity candidates a read, summed over
    the shards."""
    import torch
    per = sum(torch.clamp(v.starts[c.NB::c.NB].to(dev, torch.int64),
                          max=cands)
              - torch.clamp(v.starts[:-1:c.NB].to(dev, torch.int64),
                            max=cands) for v in vcs)
    return [round(float(per.to(torch.float64).mean()), 2), int(per.max())]


def shard_mesh(n: int) -> list:
    """n shards round-robin over the visible cards."""
    import torch
    return [torch.device("cuda", k % torch.cuda.device_count())
            for k in range(n)]


def phase_shard_kernels(o, genome, index, rpath: str, dev: str = "cuda",
                        phase: str = "20") -> list[dict]:
    """Phase 20: the index-sharded kernels on the first window against
    their twins (per shard K1/K2/K3 and K5 under 'b', then K7), and the
    merged rows against the unsharded program, at -n 0 ('f') and -n 1
    ('b'); returns per mode per-kernel {max_abs_err, bound_ms, bound_by[,
    ms, plain_ms]} (times at round 1's shapes, fixed on the small tier, on
    shard 0; K2 at full rank)."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine
    from bsmap_tpu_torch.parallel import IndexShardedEngine

    mesh = shard_mesh(N_SHARDS) if dev == "cuda" else \
        [torch.device("cpu")] * N_SHARDS
    t0 = time.time()
    eng = IndexShardedEngine(genome, index, o.param, mesh=mesh)
    one = DeviceEngine(genome, index, o.param, device=mesh[0])
    sizes = [int(t["wlocs"].numel() + t["clocs"].numel())
             for t in eng.shard_tables]
    log(f"[{phase}] {N_SHARDS} region shards on "
        f"{sorted(set(map(str, mesh)))} in {time.time() - t0:.1f} s; "
        f"bounds {eng.bounds.tolist()}; entries per shard {sizes}")
    stream = BlockReadStream(rpath, o.param, readset=0, lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    MS = eng._maxseg
    ex = 2 * MS
    rows0 = torch.from_numpy(rows_np.copy())                # round 1: rank 0
    rows_np[:, -1] = MS - 1
    rowsF = torch.from_numpy(rows_np)                       # full rank

    def unsharded_diff(g, w):
        """{column: rows differing} over the reads both programs hold
        within capacity and without replay (pick columns: reads with a
        pick); raises on a column outside the capacity ones."""
        ok = ((g[:, ex + K.X_OK] != 0) & (w[:, ex + K.X_OK] != 0)
              & (g[:, ex + K.X_REPLAY] == 0) & (w[:, ex + K.X_REPLAY] == 0))
        bad = {}
        for col in range(g.shape[1]):
            sel = ok.copy()
            if col - ex in (K.X_CHRP, K.X_WLOC):
                sel &= g[:, ex + K.X_FOUND] != 0
            if col - ex in (K.X_H00C, K.X_H00W):
                sel &= g[:, ex + K.X_H00F] != 0
            n_bad = int((g[sel, col] != w[sel, col]).sum())
            if n_bad:
                bad[col - ex] = n_bad
        if set(bad) - {K.X_OK, K.X_BIG, K.X_FTOT}:
            raise AssertionError(f"[{phase}] merged rows differ from the "
                                 f"unsharded program in X_* columns {bad}")
        return int(ok.sum()), bad

    def one_mode(mode):
        cfg = eng._cfg(mode, nw=nw)                         # full rows
        names = INDEX_SHARDED_PATH + ("fixed_schedule",) + \
            (("rc_words",) if mode == "b" else ())
        errs = {k: 0 for k in names}
        keep = {}
        for case, c, cands, rows in (
                ("fixed, rank 0, small tier", cfg._replace(fixed=True),
                 eng.CANDS, rows0),
                ("exact, full rank, big tier", cfg, eng.CANDS_BIG, rowsF),
                ("probe", cfg._replace(probe=True), 1, rowsF)):
            placed, slots, vcs = {}, [], []
            for d, tabs in enumerate(eng.shard_tables):
                dv = tabs["kmer_tab"].device
                if dv not in placed:
                    r = rows.to(dv)
                    fwd, rc = K.chain_inputs(c, r)
                    if rc is not None:
                        check(errs, "rc_words", case, [rc],
                              [K.rc_words_plain(c, r)])
                    placed[dv] = (r, fwd, rc)
                r, fwd, rc = placed[dv]
                kt = tabs["kmer_tab"]
                if c.fixed:
                    sl = K.fixed_schedule(c, fwd, kt, rc)
                    check(errs, "fixed_schedule", case, sl,
                          K.fixed_schedule_plain(c, fwd, kt, rc))
                else:
                    kw = dict(probe=c.probe, rows_rc=rc, gcnt=tabs["gcnt"])
                    sl = K.exact_schedule(c, fwd, kt, tabs["prof_a"], **kw)
                    want = K.exact_schedule_plain(c, fwd, kt,
                                                  tabs["prof_a"], **kw)
                    check(errs, "exact_schedule", case,
                          [sl.ftot_rank] if c.probe else sl,
                          [want.ftot_rank] if c.probe else want)
                slots.append(sl)
                if not c.probe:
                    vc = K.verify_candidates(c, cands, fwd, sl, tabs, rc, d)
                    check(errs, "verify_candidates", case, vc,
                          K.verify_candidates_plain(c, cands, fwd, sl, tabs,
                                                    rc, d))
                    vcs.append(vc)
            if c.probe:
                continue
            r0 = placed[mesh[0]][0]
            out = K.merge_shards(c, cands, r0, vcs, slots)
            check(errs, "merge_shards", case, [out],
                  [K.merge_shards_plain(c, cands, r0, vcs, slots)])
            corner = torch.zeros(r0.shape[0], dtype=torch.int32,
                                 device=r0.device)
            for v in vcs:
                corner.scatter_reduce_(
                    0, v.rid.to(r0.device, torch.int64),
                    ((v.info & K.INFO_CORNER) != 0).to(r0.device,
                                                        torch.int32), "amax")
            g = out.cpu().numpy()
            msg = ""
            if not c.fixed:
                # the unsharded program on the same card, column by column
                w = K.align_program(c._replace(shards=0), cands, one.tables,
                                    r0).cpu().numpy()
                n_cmp, bad = unsharded_diff(g, w)
                msg = (f"; against the unsharded program on {n_cmp} reads "
                       f"(both within capacity, no replay) equal but for "
                       f"X_* columns {bad} (X_OK {K.X_OK}, X_BIG {K.X_BIG}, "
                       f"X_FTOT {K.X_FTOT}); replays "
                       f"{int((g[:, ex + K.X_REPLAY] != 0).sum())} sharded, "
                       f"{int((w[:, ex + K.X_REPLAY] != 0).sum())} unsharded")
            log(f"[{phase}] '{mode}' {case}: {r0.shape[0]} reads, "
                f"candidates per shard {[int(v.starts[-1]) for v in vcs]}, "
                f"{int((g[:, ex + K.X_FOUND] != 0).sum())} found, "
                f"{int(corner.sum())} with a corner candidate — kernels == "
                "twins" + msg)
            keep["fixed" if c.fixed else "exact"] = dict(
                c=c, cands=cands, vcs=vcs, slots=slots, rows=placed[mesh[0]])
        c, cands, vcs, slots = (keep["fixed"][k] for k in ("c", "cands",
                                                           "vcs", "slots"))
        r0, fwd, rc = keep["fixed"]["rows"]
        t0_ = eng.shard_tables[0]
        phase_k7_cases(K, cfg, mesh[0], errs, phase)
        phase_k2_cases(K, cfg, rows0.numpy(), t0_, mesh[0], errs, phase,
                       budgets=(2, 5), gcnt=t0_["gcnt"])
        phase_k1_cases(K, cfg._replace(fixed=True), rows0.to(mesh[0]),
                       t0_["kmer_tab"], errs, phase)
        fwdF, rcF = K.chain_inputs(cfg, rowsF.to(mesh[0]))
        kt, pa, gc = t0_["kmer_tab"], t0_["prof_a"], t0_["gcnt"]
        timed = {
            "fixed_schedule": (
                lambda: K.fixed_schedule(c, fwd, kt, rc),
                lambda: K.fixed_schedule_plain(c, fwd, kt, rc)),
            "exact_schedule": (
                lambda: K.exact_schedule(cfg, fwdF, kt, pa, rows_rc=rcF,
                                         gcnt=gc),
                lambda: K.exact_schedule_plain(cfg, fwdF, kt, pa,
                                               rows_rc=rcF, gcnt=gc)),
            "verify_candidates": (
                lambda: K.verify_candidates(c, cands, fwd, slots[0], t0_, rc,
                                            0),
                lambda: K.verify_candidates_plain(c, cands, fwd, slots[0],
                                                  t0_, rc, 0)),
            "merge_shards": (
                lambda: K.merge_shards(c, cands, r0, vcs, slots),
                lambda: K.merge_shards_plain(c, cands, r0, vcs, slots)),
        }
        if mode == "b":
            timed["rc_words"] = (lambda: K.rc_words(c, r0),
                                 lambda: K.rc_words_plain(c, r0))
        m = r0.shape[0]
        ncand = [min(int(v.starts[-1]), cands) for v in vcs]
        res = {}
        for name, (kern, plain) in timed.items():
            whole = name == "merge_shards"
            res[name] = {"max_abs_err": errs[name],
                         **bound(name, c, m, sum(ncand) if whole
                                 else ncand[0], cands)}
            if dev == "cuda":
                res[name].update(timed_pair(
                    f"[{phase}] '{mode}' {name}", kern, plain,
                    f"{m} reads, {'all shards' if whole else 'shard 0'}; "
                    f"bound {res[name]['bound_ms']:.4f} ms"))
        if dev == "cuda":
            device_ms(res, timed, f"[{phase}] '{mode}' shard 0")
        # K7 on both real cases: the fixed round's small tier (above) and
        # the full-rank big tier, with their candidates per read
        k7 = res["merge_shards"]
        for case, kp in keep.items():
            per = k7_cands_per_read(kp["c"], kp["cands"], kp["vcs"], mesh[0])
            k7[f"{case}_cands_per_read"] = per
            msg = f"[{phase}] '{mode}' K7 {case}: candidates a read {per}"
            if case == "exact":
                ce, cap, rr = kp["c"], kp["cands"], kp["rows"][0]
                v, s = kp["vcs"], kp["slots"]
                k7["exact_bound_ms"] = bound(
                    "merge_shards", ce, m,
                    sum(min(int(x.starts[-1]), cap) for x in v),
                    cap)["bound_ms"]
                if dev == "cuda":
                    t = timed_pair(
                        f"[{phase}] '{mode}' merge_shards {case}",
                        lambda: K.merge_shards(ce, cap, rr, v, s),
                        lambda: K.merge_shards_plain(ce, cap, rr, v, s),
                        f"{m} reads, all shards; bound "
                        f"{k7['exact_bound_ms']:.4f} ms")
                    k7["exact_ms"], k7["exact_plain_ms"] = (t["ms"],
                                                            t["plain_ms"])
                    k7["exact_device_ms"] = queued_ms(
                        lambda: K.merge_shards(ce, cap, rr, v, s))
                    msg += (f"; {_ms(k7['exact_device_ms'])} a call on the "
                            "card")
            log(msg)
        return res

    out = [one_mode(mode) for mode in ("f", "b")]
    del eng, one
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_index_sharded_se(root: str, gpath: str, rpath: str, rep: dict,
                           dev: str = "cuda") -> dict:
    """Phase 21: the repeat-heavy reads through ``--engine index-sharded``
    on the D = 4 mesh, against phase 5's SAM and phase 6's host-engine
    prefix; then -v 5 on both engines.  Returns the launch counts summed
    over its runs (each one zeroed right before it) and the rates."""
    import torch
    from bsmap_tpu_torch.engine import kernels as K
    mesh = shard_mesh(N_SHARDS) if dev == "cuda" else \
        [torch.device("cpu")] * N_SHARDS
    total = {k: 0 for k in K.launch_counts()}

    def run(out, flags, engine, mesh_=None):
        K.reset_launch_counts()
        st = run_cli(["-a", rpath, "-d", gpath, "-o", out, "--device", dev]
                     + flags + ["--engine", engine], mesh=mesh_)
        counts = K.launch_counts()
        if engine == "index-sharded":
            need_launches(f"[21] {' '.join(flags)} index-sharded run", counts,
                          INDEX_SHARDED_PATH, ("reduce_reads",))
            for k, v in counts.items():
                total[k] += v
        return st

    out = os.path.join(root, "rep_is.sam")
    st = run(out, ALIGN_FLAGS, "index-sharded", mesh)
    eng = st["engine"]
    size = assert_same_file("[21] index-sharded vs phase 5",
                            out, os.path.join(root, "rep.sam"))
    with open(out, "rb") as f:
        head = f.read()
    with open(os.path.join(root, "repeat", "parity_host.sam"), "rb") as f:
        host = f.read()
    if head[: len(host)] != host:
        raise AssertionError("[21] first reads differ from the host engine")
    rate = st["reads"] / st["align_s"]
    log(f"[21] {st['reads']} reads on {N_SHARDS} shards in "
        f"{st['align_s']:.3f} s = {rate:.1f} reads/s; n_dispatched "
        f"{eng.n_dispatched}, n_probe {eng.n_probe}, n_replayed "
        f"{eng.n_replayed} ({eng.n_replayed - rep['n_replayed']} past the "
        f"single-device run's {rep['n_replayed']}: corner reads and "
        f"per-shard dedup), probe_mode {eng.probe_mode}; byte-identical to "
        f"phase 5 ({size} bytes) and, first {N_PARITY} reads, to the host "
        "engine")
    v5 = ["-v", "5", "-S", "17"]
    res = {"reads_per_s": rate}
    outs = []
    for engine in ("index-sharded", "device"):
        outs.append(os.path.join(root, f"rep_v5_{engine}.sam"))
        st = run(outs[-1], v5, engine,
                 mesh if engine == "index-sharded" else None)
        res[engine + " -v 5"] = st["reads"] / st["align_s"]
        log(f"[21] -v 5 {engine}: {st['reads']} reads in {st['align_s']:.3f}"
            f" s = {res[engine + ' -v 5']:.1f} reads/s, n_replayed "
            f"{st['engine'].n_replayed}")
    size = assert_same_file("[21] -v 5 index-sharded vs device", *outs)
    log(f"[21] -v 5: index-sharded byte-identical to the single-device "
        f"engine ({size} bytes)")
    res["launches"] = total
    return res


def phase_stripes_se(root: str, gpath: str, rpath: str,
                     dev: str = "cuda") -> tuple[dict, dict]:
    """Phase 22: the headline reads through ``--engine sharded`` on D = 2
    read stripes, byte-identical to phase 4's SAM; returns (rate, launch
    counts)."""
    import torch
    from bsmap_tpu_torch.engine import kernels as K
    mesh = shard_mesh(2) if dev == "cuda" else [torch.device("cpu")] * 2
    out = os.path.join(root, "head_sd.sam")
    K.reset_launch_counts()
    st = run_cli(["-a", rpath, "-d", gpath, "-o", out, "--device", dev,
                  "--engine", "sharded"] + ALIGN_FLAGS, mesh=mesh)
    counts = K.launch_counts()
    need_launches("[22] sharded run", counts, SE_PATH, ("merge_shards",))
    eng = st["engine"]
    size = assert_same_file("[22] sharded vs phase 4", out,
                            os.path.join(root, "head.sam"))
    rate = st["reads"] / st["align_s"]
    log(f"[22] {st['reads']} reads on {len(mesh)} stripes of {eng.B_loc} in "
        f"{st['align_s']:.3f} s = {rate:.1f} reads/s; n_dispatched "
        f"{eng.n_dispatched}, last window's n_aligned "
        f"{int(eng.last_n_aligned)}; byte-identical to phase 4 ({size} "
        "bytes)")
    return rate, counts


def phase_mesh_pe(root: str, dev: str = "cuda") -> dict:
    """Phase 23: phase 11's error pairs through both mesh engines (the
    per-pair path), D = 2 with its SAM flags and D = 4 with its BSP -2
    flags, against its host-engine files; returns the launch counts summed
    over the runs."""
    import torch
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "pe_err")
    g, r1, r2 = (os.path.join(d, x) for x in ("ref.fa", "r1.fq", "r2.fq"))
    total = {k: 0 for k in K.launch_counts()}
    for engine in ("sharded", "index-sharded"):
        for D, (tag, flags, (suffix, *unpaired), _md, _mr, _e) in (
                (2, PE_PATH_RUNS[0]), (4, PE_PATH_RUNS[1])):
            mesh = shard_mesh(D) if dev == "cuda" else \
                [torch.device("cpu")] * D
            files = [os.path.join(d, f"mesh_{engine}_{D}.{suffix}")]
            argv = ["-o", files[0]]
            if unpaired:
                files.append(os.path.join(d, f"mesh_{engine}_{D}_u.{suffix}"))
                argv += ["-2", files[1]]
            K.reset_launch_counts()
            st = run_cli(["-a", r1, "-b", r2, "-d", g, "--device", dev,
                          "--engine", engine] + flags + argv, mesh=mesh)
            counts = K.launch_counts()
            need = ("exact_schedule", "verify_candidates", "rc_words",
                    "pair_join") + (("merge_shards",) if engine ==
                                    "index-sharded" else ("reduce_reads",))
            never = ("reduce_reads",) if engine == "index-sharded" else \
                ("merge_shards",)
            need_launches(f"[23] {engine} D={D}", counts, need, never)
            for k, v in counts.items():
                total[k] += v
            host = [os.path.join(d, f"host.{suffix}")] + (
                [os.path.join(d, f"host_unpaired.{suffix}")]
                if unpaired else [])
            sizes = [assert_same_file(f"[23] {engine} D={D}", a, b)
                     for a, b in zip(files, host)]
            log(f"[23] {engine}, D = {D}, per-pair path ({' '.join(flags)}, "
                f"{suffix}): {N_PARITY} pairs in {st['align_s']:.3f} s, "
                f"n_replayed {st['engine'].n_replayed}; byte-identical to "
                f"the host engine ({' + '.join(map(str, sizes))} bytes)")
    return total


def spawn(cmd: list, env: dict, log_path: str) -> subprocess.Popen:
    """``cmd`` in a session of its own (so a kill reaches the workers it
    starts), stdout and stderr to ``log_path``."""
    with open(log_path, "wb") as f:
        return subprocess.Popen(cmd, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True, cwd=REPO)


def finish(procs: list, timeout: float = PROC_TIMEOUT) -> list:
    """Wait for ``procs`` within ``timeout`` seconds in all; returns each
    one's seconds from now to its exit.  Kills the session of any left
    over and raises when one failed or ran over."""
    import signal
    t0 = time.time()
    took = [None] * len(procs)
    try:
        while any(t is None for t in took):
            for i, q in enumerate(procs):
                if took[i] is None and q.poll() is not None:
                    took[i] = time.time() - t0
                    if q.returncode != 0:
                        raise RuntimeError(f"{q.args[:4]}... exited "
                                           f"{q.returncode}")
            if time.time() - t0 > timeout:
                raise TimeoutError(f"processes ran over {timeout} s")
            time.sleep(0.1)
    finally:
        for q in procs:
            if q.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(q.pid, signal.SIGKILL)
                q.wait()
    return took


def sorted_digest(lines) -> tuple:
    """(count, sha256) of ``lines`` as a sorted multiset."""
    import hashlib
    h = hashlib.sha256()
    lines = sorted(lines)
    for ln in lines:
        h.update(ln.encode("latin1"))
    return len(lines), h.hexdigest()


def bam_digest(path: str) -> tuple:
    """``sorted_digest`` of a BAM's records as SAM lines."""
    from bsmap_tpu_torch.bamio import bam_sam_lines
    return sorted_digest(bam_sam_lines(path))


def sam_digest(path: str) -> tuple:
    """``sorted_digest`` of a SAM's body."""
    with open(path, encoding="latin1") as f:
        return sorted_digest(ln for ln in f if not ln.startswith("@"))


def phase_bam(root: str, g1: str, r1: str, gp: str, p1: str, p2: str,
              se_need: tuple, dev: str = "cuda", n_reads: int = N_HEADLINE,
              n_pairs: int = N_PAIRS) -> tuple[dict, list]:
    """Phase 25: BAM out and BAM in.  The headline reads and the pairs as
    ``.bam`` (no --engine), each run's launches counted (``se_need``: what
    phase 4's run of the same reads launched; ``PE_PATH``); each BAM's records
    (read back in a process of their own while the card goes on) equal to
    the body of phase 4's or 9's SAM as a sorted multiset, and its ``.bai``
    there; the first ``N_PARITY`` reads and pairs as ``.bam``
    byte-identical to the host engine's; a BAM made from a card SAM
    (the CLI's ``sam_to_bam`` of the card's SAM of the first ``N_PARITY``
reads, with -u) realigned with ``-a in.bam`` byte-identical to the host
engine.
    Returns (seconds and rates, the launch counts of each counted run)."""
    import concurrent.futures
    import multiprocessing
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "bam")
    os.makedirs(d, exist_ok=True)
    runs, res, pending = [], {}, {}
    se = ["-a", r1, "-d", g1] + ALIGN_FLAGS
    pe = ["-a", p1, "-b", p2, "-d", gp] + PE_FLAGS
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        for tag, base, sam, path, n in (
                ("se", se, "head.sam", se_need, n_reads),
                ("pe", pe, "pe.sam", PE_PATH, n_pairs)):
            out = os.path.join(d, f"{tag}.bam")
            K.reset_launch_counts()
            st = run_cli(base + ["-o", out, "--device", dev])
            runs.append(K.launch_counts())
            need_launches(f"[25] {tag} .bam run", runs[-1], path)
            if not os.path.exists(out + ".bai"):
                raise AssertionError(f"[25] {tag}: no .bai")
            got = st.get("reads", st.get("pairs"))
            if got != n:
                raise AssertionError(f"[25] {tag}: aligned {got} of {n}")
            pending[tag] = (pool.submit(bam_digest, out),
                            os.path.join(root, sam))
            res[tag] = {"align_s": st["align_s"], "bam_s": st["bam_s"],
                        "per_s": n / st["align_s"]}
            log(f"[25] {tag} -> .bam: {n} {'reads' if tag == 'se' else 'pairs'}"
                f" aligned in {st['align_s']:.3f} s ({res[tag]['per_s']:.1f}"
                f"/s), SAM -> sorted BAM + .bai in {st['bam_s']:.3f} s "
                f"({os.path.getsize(out)} bytes); engine {st['engine_name']}")
        for tag, base, unit in (("se", se, "reads"), ("pe", pe, "pairs")):
            outs = [os.path.join(d, f"parity_{tag}_{e}.bam")
                    for e in ("gpu", "host")]
            for out, eng in zip(outs, (["--device", dev],
                                       ["--engine", "host"])):
                run_cli(base + ["-E", str(N_PARITY), "-o", out] + eng)
            sizes = [assert_same_file(f"[25] {tag} parity{x}", outs[0] + x,
                                      outs[1] + x) for x in ("", ".bai")]
            log(f"[25] {tag}: first {N_PARITY} {unit} as .bam byte-identical "
                f"to the host engine's ({sizes[0]} + {sizes[1]} bytes .bai)")
        src = os.path.join(d, "in.bam")
        run_cli(se + ["-E", str(N_PARITY), "-u", "-o", src, "--device", dev])
        outs = [os.path.join(d, f"from_bam_{e}.sam") for e in ("gpu", "host")]
        K.reset_launch_counts()
        st = run_cli(["-a", src, "-d", g1, "-o", outs[0], "--device", dev]
                     + ALIGN_FLAGS)
        runs.append(K.launch_counts())
        need_launches("[25] -a in.bam run", runs[-1],
                      ("verify_candidates", "reduce_reads"))
        if st["reads"] != N_PARITY:
            raise AssertionError(f"[25] -a in.bam: {st['reads']} reads")
        run_cli(["-a", src, "-d", g1, "-o", outs[1], "--engine", "host"]
                + ALIGN_FLAGS)
        size = assert_same_file("[25] -a in.bam", *outs)
        log(f"[25] -a in.bam ({N_PARITY} reads, sam_to_bam of a card SAM "
            f"with -u): {st['align_s']:.3f} s on {dev}, engine "
            f"{st['engine_name']}; byte-identical to the host engine "
            f"({size} bytes)")
        for tag, (fut, sam) in pending.items():
            t0 = time.time()
            want = sam_digest(sam)
            got = fut.result(timeout=PROC_TIMEOUT)
            if got != want:
                raise AssertionError(f"[25] {tag}: the BAM's records "
                                     f"{got} differ from {sam}'s {want}")
            log(f"[25] {tag}: the BAM holds {got[0]} records, the body of "
                f"{os.path.basename(sam)} as a sorted multiset (checked in "
                f"{time.time() - t0:.1f} s after the reads above)")
    return res, runs


def phase_methratio(root: str, g1: str, r1: str, gp: str,
                    n_pairs: int = N_PAIRS, dev: str = "cuda") -> dict:
    """Phase 26: ``python -m bsmap_tpu_torch.methratio -z`` (fully
    converted reads: every ratio is 0) on phase 25's pair-end BAM and on
    phase 9's SAM of the same pairs, the two at once, outputs identical
    (per-chromosome sorted); ``bsp2sam`` on the card's
    BSP of the first ``N_PARITY`` headline reads equal to ``bsp2sam`` on
    the host engine's.  Returns methratio's seconds per input."""
    from bsmap_tpu_torch import bsp2sam
    d = os.path.join(root, "meth")
    os.makedirs(d, exist_ok=True)
    srcs = {"bam": os.path.join(root, "bam", "pe.bam"),
            "sam": os.path.join(root, "pe.sam")}
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [spawn([sys.executable, "-m", "bsmap_tpu_torch.methratio", "-d",
                    gp, "-o", os.path.join(d, f"{k}.txt"), "-z", "-q", v],
                   env, os.path.join(d, f"{k}.log"))
             for k, v in srcs.items()]
    took = dict(zip(srcs, finish(procs)))
    size = assert_same_file("[26] methratio, BAM vs SAM",
                            *(os.path.join(d, f"{k}.txt") for k in srcs))
    with open(os.path.join(d, "bam.log")) as f:
        summary = f.read().strip().splitlines()[-1]
    log(f"[26] methratio on {n_pairs} pairs, both at once: BAM "
        f"{took['bam']:.1f} s, SAM {took['sam']:.1f} s; outputs identical "
        f"({size} bytes; {summary})")
    outs = []
    for eng in (["--device", dev], ["--engine", "host"]):
        bsp = os.path.join(d, f"{eng[1]}.bsp")
        run_cli(["-a", r1, "-d", g1, "-E", str(N_PARITY), "-o", bsp]
                + ALIGN_FLAGS + eng)
        outs.append(bsp[:-4] + "_b2s.sam")
        with contextlib.redirect_stderr(io.StringIO()):
            bsp2sam.run(["-d", g1, "-o", outs[-1], "-q", bsp])
    size = assert_same_file("[26] bsp2sam", *outs)
    log(f"[26] bsp2sam on the first {N_PARITY} reads' BSP: card == host "
        f"engine ({size} bytes)")
    return {"methratio_bam_s": took["bam"], "methratio_sam_s": took["sam"]}


def _proc_id(rec: dict) -> str:
    return rec["argv"][rec["argv"].index("--proc-id") + 1]


# the CLI in a process of its own that writes its alignment phase's stats
# to the JSON file named by its first argument: phase 27's one-process run
CLI_STATS = """import json, sys
from bsmap_tpu_torch import cli
st = {}
rc = cli.run(sys.argv[2:], stats=st)
with open(sys.argv[1], "w") as f:
    json.dump({k: st[k] for k in ("reads", "pairs", "align_s") if k in st}, f)
sys.exit(rc)
"""


def phase_multiprocess(root: str, runs: dict, dev: str = "cuda",
                       phase: str = "27") -> tuple:
    """Phase 27 (and 29's -p 8 runs): multi-process runs on the one card.
    For each of
    ``runs`` (tag -> (how, argv without -o, the files of its one-process
    run, the kernels each process must launch, those the processes
    together must launch, those none may, its reads or pairs, the
    one-process run's rate)), by ``how``:
    ``nprocs``: ``--nprocs 2`` with process 0 in this process through
    ``cli.run`` (launches zeroed before it and read after) and process 1 a
    process of its own; ``workers``: -p 2 in argv, the CLI's own two
    worker processes; ``one``: -p in argv where the CLI keeps one process
    (single-end on the card): exactly one process reports, no worker, and
    its alignment phase's rate.  Each process's launches and card memory
    come from ``LAUNCH_DUMP``, the card's per-process memory from
    ``CardMemory``; the (merged) output, and a -2 file where the run
    writes one, byte-identical to the one-process run's.  Returns
    (per-run numbers, the launch counts of every process)."""
    import torch
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "mp")
    dump = os.path.join(d, "dump")
    env = launch_dump_env(dump)
    cli = [sys.executable, "-m", "bsmap_tpu_torch.cli"]
    res, counts = {}, []
    for tag, (how, argv, want, need, need_all, never, n, one_rate) in \
            runs.items():
        suffix = want[0].rsplit(".", 1)[1]
        outs = [os.path.join(d, f"{tag}{x}.{suffix}")
                for x in ("", "_u")[: len(want)]]
        oargv = ["-o", outs[0]] + (["-2", outs[1]] if len(outs) > 1 else [])
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        stats_path = os.path.join(d, f"{tag}.stats.json")
        t0 = time.time()
        with CardMemory(dev == "cuda") as mem:
            if how == "one":     # one CLI process, its stats to a file
                procs = [spawn([sys.executable, "-c", CLI_STATS, stats_path]
                               + argv + oargv + ["--device", dev], env,
                               outs[0] + ".log")]
            elif how == "workers":   # the CLI starts and merges them
                procs = [spawn(cli + argv + oargv + ["--device", dev], env,
                               outs[0] + ".log")]
            else:              # processes 1.. here, process 0 in-process
                procs = [spawn(cli + argv + oargv + [
                    "--device", dev, "--nprocs", str(N_NPROCS), "--proc-id",
                    str(k)], env, outs[0] + f".{k}.log")
                    for k in range(1, N_NPROCS)]
            try:
                if how == "nprocs":
                    K.reset_launch_counts()
                    st = run_cli(argv + oargv + ["--device", dev, "--nprocs",
                                                 str(N_NPROCS), "--proc-id",
                                                 "0"])
                    c0 = K.launch_counts()
            finally:
                finish(procs)
        wall = time.time() - t0
        recs = launch_dumps(dump, workers=False)
        workers = [r for r in recs if "--proc-id" in r["argv"]]
        want_n = {"one": 0, "workers": N_NPROCS,
                  "nprocs": N_NPROCS - 1}[how]
        if len(workers) != want_n or (how == "one" and len(recs) != 1):
            raise AssertionError(f"[{phase}] {tag}: {len(workers)} worker "
                                 f"records of {len(recs)}")
        if how == "one":
            per_proc = [("the one", recs[0]["launches"])]
        else:
            per_proc = ([("0", c0)] if how == "nprocs" else []) + [
                (_proc_id(r), r["launches"]) for r in workers]
        for k, c in per_proc:
            need_launches(f"[{phase}] {tag}, process {k}", c, need, never)
            counts.append(c)
        need_launches(f"[{phase}] {tag}, the processes together",
                      {k: sum(c[k] for _, c in per_proc) for k in need_all},
                      need_all)
        size = sum(assert_same_file(f"[{phase}] {tag} vs its one-process "
                                    "run", got, w)
                   for got, w in zip(outs, want))
        mib = {}
        if dev == "cuda":
            if how == "nprocs":
                mib["0"] = torch.cuda.max_memory_allocated() / 2**20
            mib.update(((_proc_id(r) if r in workers else "the one"),
                        r["max_allocated"] / 2**20) for r in recs
                       if "max_allocated" in r)
        res[tag] = {"how": how, "wall_s": wall, "per_s_wall": n / wall,
                    "one_process_per_s": one_rate, "alloc_mib": mib,
                    "smi_mib": dict(mem.peak)}
        if how == "nprocs":
            res[tag]["proc0_per_s"] = st.get("reads", st.get("pairs")) \
                / st["align_s"]
        if how == "one":
            with open(stats_path) as f:
                one = json.load(f)
            res[tag]["align_per_s"] = (one.get("reads") or one["pairs"]) \
                / one["align_s"]
        what = (f"-p {argv[argv.index('-p') + 1]}, one process"
                if how == "one" else f"-p {N_NPROCS}, the CLI's workers"
                if how == "workers" else f"--nprocs {N_NPROCS}")
        log(f"[{phase}] {tag}: {what} on {dev}, {n} in {wall:.1f} s from "
            "launch "
            f"to the {'file' if how == 'one' else 'merged file'} "
            f"({n / wall:.1f}/s; one process, alignment phase: "
            f"{one_rate:.1f}/s)"
            + ("" if how != "nprocs" else ", process 0's range aligned at "
               f"{res[tag]['proc0_per_s']:.1f}/s")
            + ("" if how != "one" else ", its own alignment phase at "
               f"{res[tag]['align_per_s']:.1f}/s")
            + f"; peak allocated MiB by process {mib or 'not on a card'} "
            "(process 0 here: with what this process still holds); "
            f"nvidia-smi, all processes on the card {mem.peak or 'not read'}; "
            f"byte-identical to the one-process run ({size} bytes)")
    return res, counts


def make_trim_pe_set(d: str, n_pairs: int, seed: int = 43,
                     filtered: float = 0.0025) -> tuple:
    """Phase 29's pairs on phase 7's genome (tools/genreads.generate_pe's
    4.6 Mb chromosome, seed 11): fully converted 76 nt mates as
    ``make_pe_reads`` draws them, over inserts uniform in 28-500; a mate
    of a shorter insert reads on into the TruSeq adapter.  Qualities 'I',
    but every 20th mate (at random) ends in '#' after base 40 (-q 2 trims
    it) and a ``filtered`` share of the mates after base 8 (-q 2 filters
    it; about 2 x ``filtered`` of the pairs).  The mix is synthetic:
    BASELINE config 2 gives only the insert range (its -m/-x), and no
    source here gives an insert distribution, tail rates or a filtered
    share, so a rate on this set is this set's and no library's.  Returns
    the two FASTQ paths; made once in ``d``."""
    import numpy as np
    from tools.genreads import COMP, make_genome
    os.makedirs(d, exist_ok=True)
    paths = (os.path.join(d, "t_1.fq"), os.path.join(d, "t_2.fq"))
    if os.path.exists(paths[1]):
        return paths
    t0 = time.time()
    rng = np.random.RandomState(seed)
    chrom = make_genome(11, 1, 4_600_000)[0]
    L = 76
    ins = rng.randint(28, 501, size=n_pairs)
    pos = rng.randint(0, len(chrom) - 501, size=n_pairs)
    offs = np.arange(L)
    w1 = chrom[pos[:, None] + np.minimum(offs, ins[:, None] - 1)]
    w2 = COMP[chrom[pos[:, None] + np.maximum(ins[:, None] - 1 - offs, 0)]]
    flip = rng.random_sample(n_pairs) < 0.5
    a = np.where(flip[:, None], w2, w1)
    b = np.where(flip[:, None], w1, w2)
    adapter = np.frombuffer((RRBS_ADAPTER + "CACACGTCTGAACTCCAGTCACATCTCGTA"
                             "TGCCGTCTTCTGCTTG").encode()[:L], np.uint8)
    tail = offs[None, :] >= ins[:, None]
    ad = adapter[np.maximum(offs[None, :] - ins[:, None], 0)]
    mates = (np.where(tail, ad, np.where(a == ord("C"), ord("T"), a)),
             np.where(tail, ad, np.where(b == ord("G"), ord("A"), b)))
    for path, seqs in zip(paths, mates):
        qual = np.full((n_pairs, L), ord("I"), np.uint8)
        qual[rng.random_sample(n_pairs) < 0.05, 40:] = ord("#")
        qual[rng.random_sample(n_pairs) < filtered, 8:] = ord("#")
        with open(path, "wb") as f:
            f.write(b"".join(b"@t%d\n%s\n+\n%s\n" % (i, s.tobytes(),
                                                    q.tobytes())
                             for i, (s, q) in enumerate(zip(seqs, qual))))
    log(f"[29] data (a synthetic mix): {n_pairs} pairs, inserts uniform "
        f"in 28-500 ({int((ins < L).sum())} under {L} nt), low-quality "
        f"tails on 5% of mates after base 40 and {100 * filtered:g}% after "
        f"base 8, in {time.time() - t0:.1f} s")
    return paths


def assert_prefix(tag: str, got: str, want: str) -> int:
    """The host engine's file on the first pairs is the start of the GPU
    run's on all of them; returns its size."""
    with open(want, "rb") as f:
        b = f.read()
    with open(got, "rb") as f:
        a = f.read(len(b))
    if a != b or not b.endswith(b"\n"):
        la, lb = a.splitlines(), b.splitlines()
        bad = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                   min(len(la), len(lb)))
        raise AssertionError(f"{tag}: GPU output {os.path.basename(got)} "
                             f"differs from the host engine at line {bad}")
    return len(b)


def phase_pe_trim(root: str, gp: str, sam_rate: float,
                  dev: str = "cuda") -> tuple:
    """Phase 29: pair-end trimming (``TRIM_PE_FLAGS``) on the block path,
    BSP with -2 and SAM with -R (module docstring).  Returns (per-run
    numbers, the launch counts of each main-path run)."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "pe_trim")
    t1, t2 = make_trim_pe_set(d, N_TRIM_PAIRS)
    res, counts, multi = {}, [], {}
    for tag, extra, (suffix, *unpaired) in TRIM_PE_RUNS:
        argv = ["-a", t1, "-b", t2, "-d", gp] + TRIM_PE_FLAGS + extra
        files, host = ([os.path.join(d, f"{who}{tag}{x}.{suffix}")
                        for x in ("", "_u")[: 1 + len(unpaired)]]
                       for who in ("", "host_"))

        def outs(fs):
            return ["-o", fs[0]] + (["-2", fs[1]] if len(fs) > 1 else [])

        K.reset_launch_counts()
        st = run_cli(argv + outs(files) + ["--device", dev, "-p", "1"])
        counts.append(K.launch_counts())
        need_launches(f"[29] {tag}, -p 1", counts[-1], PE_PATH)
        eng = st["engine"]
        if st["pe_path"] != "blocks" or st["pairs"] != N_TRIM_PAIRS:
            raise AssertionError(f"[29] {tag}: {st['pairs']} pairs on the "
                                 f"{st['pe_path']} path")
        run_cli(argv + outs(host) + ["-E", str(N_PARITY), "--engine",
                                     "host"])
        size = sum(assert_prefix(f"[29] {tag}", g, h)
                   for g, h in zip(files, host))
        rate = st["pairs"] / st["align_s"]
        res[tag] = {"pairs_per_s": rate, "align_s": st["align_s"],
                    "n_dispatched": eng.se.n_dispatched,
                    "n_replayed": eng.n_replayed,
                    "n_mate_filtered": eng.n_mate_filtered,
                    "host_s": eng.t_host}
        log(f"[29] {tag} ({' '.join(TRIM_PE_FLAGS + extra)}), -p 1: "
            f"{N_TRIM_PAIRS} pairs in {st['align_s']:.3f} s = {rate:.1f} "
            f"pairs/s (phase 9's SAM: {sam_rate:.1f}); n_dispatched "
            f"{eng.se.n_dispatched}, n_replayed {eng.n_replayed}, pairs "
            f"with a filtered mate {eng.n_mate_filtered}, "
            f"{eng.t_host:.3f} s on the host engine; the first "
            f"{N_PARITY} pairs byte-identical to the host engine ({size} "
            "bytes)")
        multi[f"trim_{tag}"] = ("one", argv + ["-p", "8"], files, PE_PATH,
                                PE_PATH, (), N_TRIM_PAIRS, rate)
    mp, c = phase_multiprocess(root, multi, dev, phase="29")
    counts.extend(c)
    for tag in res:
        res[tag]["p8_pairs_per_s"] = mp[f"trim_{tag}"]["align_per_s"]
        res[tag]["p8_wall_s"] = mp[f"trim_{tag}"]["wall_s"]
    return res, counts


def make_qc_set(src: str, dst: str, n: int) -> None:
    """Phase 30's reads: the first ``n`` FASTQ records of ``src`` with Ns
    put into each read k (1-based) with k % N_QC_EVERY == N_QC_AT, at
    random places (seed 30): 8 Ns (a QC read under the default -f 5) where
    k // N_QC_EVERY is even, else 3."""
    import itertools
    rng = random.Random(30)
    with open(src, "rb") as f:
        lines = list(itertools.islice(f, 4 * n))
    for k in range(N_QC_AT, n + 1, N_QC_EVERY):
        seq = bytearray(lines[4 * (k - 1) + 1].rstrip(b"\n"))
        for i in rng.sample(range(len(seq)), 8 if k // N_QC_EVERY % 2 == 0
                            else 3):
            seq[i] = ord("N")
        lines[4 * (k - 1) + 1] = bytes(seq) + b"\n"
    with open(dst, "wb") as f:
        f.writelines(lines)


def qc_line_counts(bsp: str, reads: str) -> tuple:
    """(QC lines, those reverse-complemented) of a BSP file: a QC line
    prints the read as trimmed, or reverse-complemented where the stale
    hits[0][0] slot lies on a Crick strand."""
    with open(reads, "rb") as f:
        lines = f.read().splitlines()
    seqs = {lines[k][1:]: lines[k + 1] for k in range(0, len(lines), 4)}
    n_qc = n_rc = 0
    with open(bsp, "rb") as f:
        for ln in f:
            name, seq, _qual, cls = ln.split(b"\t", 4)[:4]
            if cls.rstrip(b"\n") == b"QC":
                n_qc += 1
                n_rc += seq != seqs[name][: len(seq)]
    return n_qc, n_rc


def simulate_context_pairs(d: str) -> tuple[str, str, str]:
    """Phase 31's base set in ``d``: tools/simulate.py's 300 pairs of 76 nt
    on 2 x 20 kb with 1% errors (seed 5).  Returns (genome, mates 1,
    mates 2)."""
    g, r1, r2 = (os.path.join(d, x) for x in ("ctx.fa", "ctx_1.fq",
                                              "ctx_2.fq"))
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "simulate.py"),
                    "--pe", "--n-reads", str(N_CTX_PAIRS), "--read-len", "76",
                    "--chr-len", "20000", "--n-chr", "2", "--seed", "5",
                    "--error-rate", "0.01", "--genome-out", g, "--reads-out",
                    r1, "--reads2-out", r2], check=True, timeout=600)
    return g, r1, r2


def chr1_mates(genome: str, start: int, frag: int = 200,
               read_len: int = 76) -> tuple[str, str]:
    """The mates of the fully converted fragment ``frag`` nt long at 0-based
    ``start`` of the genome's first chromosome: mate 1 its first
    ``read_len`` bases with C read as T, mate 2 the first ``read_len`` of
    that fragment's reverse complement.  Mate 1 maps at ``start``, and with
    ``frag == read_len`` mate 2 too."""
    with open(genome) as f:
        chr1 = "".join(f.read().split(">")[1].splitlines()[1:])
    conv = chr1[start: start + frag].replace("C", "T")
    return conv[:read_len], conv.translate(str.maketrans(
        "ACGT", "TGCA"))[::-1][:read_len]


def plant_pairs(r1: str, r2: str, d1: str, d2: str, plant: dict) -> None:
    """``d1``/``d2``: copies of the FASTQ mates ``r1``/``r2`` with each pair
    k (1-based) of ``plant`` given its (mate 1, mate 2) sequences, None
    keeping a mate as it is, a planted mate's qualities all I."""
    for m, (src, dst) in enumerate(((r1, d1), (r2, d2))):
        with open(src) as f:
            lines = f.read().splitlines()
        for k, mates in plant.items():
            if mates[m] is not None:
                lines[4 * k - 3] = mates[m]
                lines[4 * k - 1] = "I" * len(mates[m])
        with open(dst, "w") as f:
            f.write("\n".join(lines) + "\n")


def context_plants(genome: str, mate1_at: int = 0, mate2_at: int = 0,
                   pos1_at: int = 0) -> dict:
    """Pairs to plant (``plant_pairs``) whose contexts at chromosome
    position 0 or 1 print the leading slots of a mate's context buffer
    (XR, BSP) as earlier contexts left them, each at the start of a pair
    range of a multi-process run: at pair ``mate1_at`` mate 1 maps at
    position 0 (F5's pair), at ``pos1_at`` mate 1 at position 1 (only slot
    0 leaks); at ``mate2_at`` mate 1 is all N (filtered) and mate 2 maps
    alone at position 0, an unpaired mate-2 line, the only kind that
    writes mate 2's buffer under SAM -R.  With ``mate2_at``, pair 10's mate
    1 is all N too (its mate 2 writes that buffer early), and pair 139's
    mate 2, whose mate 1 the base set leaves unpaired, as well.  A
    position left 0 plants nothing."""
    n = "N" * 76
    plant = {}
    if mate1_at:
        plant[mate1_at] = chr1_mates(genome, 0)
    if pos1_at:
        plant[pos1_at] = chr1_mates(genome, 1)
    if mate2_at:
        plant.update({10: (n, None), 139: (None, n),
                      mate2_at: (n, chr1_mates(genome, 0, frag=76)[1])})
    return plant


def phase_qc_lines(root: str, g1: str, r1: str, dev: str = "cuda") -> tuple:
    """Phase 30: QC lines of single-end BSP -u on the block path (module
    docstring).  Returns (numbers, the launch counts of each main-path
    run)."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "qc")
    os.makedirs(d, exist_ok=True)
    reads = os.path.join(d, "qc.fq")
    make_qc_set(r1, reads, N_PARITY)
    argv = ["-a", reads, "-d", g1] + QC_FLAGS
    one, host = (os.path.join(d, f"{w}.bsp") for w in ("one", "host"))
    # BSP rows are full rows: the exact schedule, never the fixed one
    need, never = ("exact_schedule", "verify_candidates",
                   "reduce_reads"), ("fixed_schedule",)
    K.reset_launch_counts()
    st = run_cli(argv + ["-o", one, "--device", dev, "-p", "1"])
    counts = [K.launch_counts()]
    need_launches("[30] QC lines, -p 1", counts[-1], need, never)
    t0 = time.perf_counter()
    run_cli(argv + ["-o", host, "--engine", "host", "-p", "1"])
    host_s = time.perf_counter() - t0
    size = assert_same_file("[30] -p 1", one, host)
    n_qc, n_rc = qc_line_counts(host, reads)
    if not 0 < n_rc < n_qc:
        raise AssertionError(f"[30] {n_rc} of {n_qc} QC lines turned: "
                             "expected both orientations")
    rate = st["reads"] / st["align_s"]
    log(f"[30] QC lines ({' '.join(QC_FLAGS)}; Ns in every "
        f"{N_QC_EVERY}th read): {N_PARITY} reads, -p 1 at {rate:.1f} "
        f"reads/s, byte-identical to the host engine ({size} bytes, host "
        f"{host_s:.1f} s); {n_qc} QC lines, {n_rc} reverse-complemented")
    mp, c = phase_multiprocess(root, {
        "qc_p8": ("one", argv + ["-p", "8"], [host], need, need, never,
                  N_PARITY, rate),
        "qc_nprocs": ("nprocs", argv, [host], need, need, never, N_PARITY,
                      rate)}, dev, phase="30")
    counts.extend(c)
    with open(os.path.join(root, "mp", "qc_nprocs.bsp.1.log")) as f:
        walk = re.findall(r"range start (\d+): hits\[0\]\[0\] slot "
                          r"\((\d+), (\d+)\), context .* from the reads "
                          r"before it in ([0-9.]+) s", f.read())
    with open(host, "rb") as f:
        first = f.read().splitlines()[N_PARITY // 2].split(b"\t")[3]
    if (len(walk) != 1 or int(walk[0][0]) != N_PARITY // 2 + 1
            or first != b"QC"):
        raise AssertionError(f"[30] --nprocs 2, process 1: walk back {walk}"
                             f", its first read's class {first}")
    walk_s = float(walk[0][3])
    log(f"[30] --nprocs 2: process 1's range starts at read {walk[0][0]} "
        f"(a QC read) with the slot ({walk[0][1]}, {walk[0][2]}) taken over "
        f"in {walk_s:.6f} s")
    return {"reads": N_PARITY, "qc_lines": n_qc, "qc_reverse": n_rc,
            "p1_reads_per_s": rate, "host_s": host_s, "walk_s": walk_s,
            "p8_align_per_s": mp["qc_p8"]["align_per_s"],
            "nprocs_wall_s": mp["qc_nprocs"]["wall_s"]}, counts


def phase_range_contexts(root: str, dev: str = "cuda") -> tuple:
    """Phase 31: pair-end context bytes at range starts (module
    docstring).  The processes of every multi-process run start at once;
    process 0 of each --nprocs 2 run then runs here, one after another.
    Returns (numbers, the launch counts of each main-path process)."""
    from bsmap_tpu_torch.engine import kernels as K
    d = os.path.join(root, "ctx")
    os.makedirs(d, exist_ok=True)
    g, r1, r2 = simulate_context_pairs(d)
    start = N_CTX_PAIRS // N_NPROCS + 1       # the second range's first pair
    mates = {}
    for name, plant in (("mate1", context_plants(g, mate1_at=start)),
                        ("mate2", context_plants(g, mate2_at=start))):
        a, b = (os.path.join(d, f"{name}_{m}.fq") for m in (1, 2))
        plant_pairs(r1, r2, a, b, plant)
        mates[name] = ["-a", a, "-b", b, "-d", g]
    outs, hosts = {}, {}
    t0 = time.perf_counter()
    for tag, (name, flags, n_out, _how) in CTX_RUNS.items():
        ext = "sam" if n_out == 1 else "bsp"
        outs[tag] = [os.path.join(d, f"{tag}{x}.{ext}")
                     for x in ("", "_u")[:n_out]]
        if (name, n_out) not in hosts:
            hosts[name, n_out] = [os.path.join(d, f"host_{name}{x}.{ext}")
                                  for x in ("", "_u")[:n_out]]
            run_cli(mates[name] + flags + _ctx_out(hosts[name, n_out])
                    + ["--engine", "host", "-p", "1"])
    host_s = time.perf_counter() - t0
    # the range start's context at chr1:1 takes its two leading bases from
    # the contexts before it
    for (name, n_out), files in hosts.items():
        with open(files[0], "rb") as f:
            rows = [x.split(b"\t") for x in f.read().splitlines()]
        ctx = ([r[-2][5:7] for r in rows if r[2:4] == [b"chr1", b"1"]]
               if n_out == 1 else
               [r[8][:2] for r in rows if r[4:6] == [b"chr1", b"1"]])
        if not ctx or not all(c.isalpha() and c.islower() for c in ctx):
            raise AssertionError(f"[31] {name}: contexts at chr1:1 {ctx}")
    dump = os.path.join(d, "dump")
    env = launch_dump_env(dump)
    cli = [sys.executable, "-m", "bsmap_tpu_torch.cli"]
    t0 = time.time()
    procs = []
    for tag, (name, flags, _n, how) in CTX_RUNS.items():
        argv = cli + mates[name] + flags + _ctx_out(outs[tag]) + [
            "--device", dev]
        argv += (["--nprocs", str(N_NPROCS), "--proc-id", "1"]
                 if how == "nprocs" else ["--engine", "sharded", "-p",
                                          str(N_NPROCS)])
        procs.append(spawn(argv, env, outs[tag][0] + ".log"))
    res, counts = {}, []
    try:
        for tag, (name, flags, _n, how) in CTX_RUNS.items():
            if how != "nprocs":
                continue
            K.reset_launch_counts()
            st = run_cli(mates[name] + flags + _ctx_out(outs[tag]) + [
                "--device", dev, "--nprocs", str(N_NPROCS), "--proc-id",
                "0"])
            counts.append(K.launch_counts())
            need_launches(f"[31] {tag}, process 0", counts[-1], PE_PATH)
            if st["pe_path"] != "blocks":
                raise AssertionError(f"[31] {tag} off the block path")
            res[tag] = {"patches": st["ctx_patches"],
                        "patch_s": st["patch_s"], "merge_s": st["merge_s"]}
    finally:
        finish(procs)
    wall = time.time() - t0
    for rec in launch_dumps(dump):
        need_launches(f"[31] {os.path.basename(rec['argv'][rec['argv'].index('-o') + 1])}"
                      f", process {_proc_id(rec)}", rec["launches"], PE_PATH)
        counts.append(rec["launches"])
    if len(counts) != len(CTX_RUNS) * N_NPROCS:
        raise AssertionError(f"[31] {len(counts)} processes' launches")
    for tag, (name, flags, n_out, how) in CTX_RUNS.items():
        with open(outs[tag][0] + ".log") as f:
            text = f.read()
        path = "block" if how == "nprocs" else "per-pair"
        if text.count(f"pairs on the {path} path") != (
                1 if how == "nprocs" else N_NPROCS):
            raise AssertionError(f"[31] {tag}: not every range on the "
                                 f"{path} path")
        if how != "nprocs":
            m = re.findall(r"merged \d+ shards -> .* in ([0-9.]+) s: "
                           r"(\d+) context patches in ([0-9.]+) s", text)
            if len(m) != 1:
                raise AssertionError(f"[31] {tag}: merge line {m}")
            res[tag] = {"merge_s": float(m[0][0]), "patches": int(m[0][1]),
                        "patch_s": float(m[0][2])}
        for got, want in zip(outs[tag], hosts[name, n_out]):
            assert_same_file(f"[31] {tag}", got, want)
        if res[tag]["patches"] != 2:
            raise AssertionError(f"[31] {tag}: {res[tag]['patches']} "
                                 "context patches, expected 2")
        log(f"[31] {tag} ({' '.join(flags)}; "
            f"{'--nprocs' if how == 'nprocs' else '--engine sharded -p'} "
            f"{N_NPROCS}, the {path} path): byte-identical to the host "
            f"engine at -p 1; {res[tag]['patches']} context patches in "
            f"{res[tag]['patch_s']:.6f} s of a {res[tag]['merge_s']:.6f} s "
            "merge")
    log(f"[31] {len(CTX_RUNS)} runs of {N_CTX_PAIRS} pairs, the range start "
        f"at pair {start}: {wall:.1f} s from launch, host engine "
        f"{host_s:.1f} s")
    return {"runs": res, "wall_s": wall, "host_s": host_s}, counts


def _ctx_out(files: list) -> list:
    return ["-o", files[0]] + (["-2", files[1]] if len(files) > 1 else [])


def scale_se_kernels(K, eng, rpath: str, errs: dict) -> dict:
    """Phase 28's single-end kernels against their twins on the first
    window of the hg38-class reads, on the tables step's engine: round 1
    (K1 fixed lean at the small tier, K3, K4: the main path's first
    dispatch), the probe pass (K2 at full rank, totals only) and the
    first exactly packed span at rank 0 (K2 exact lean, K3, K4 at the
    span's capacity: what probe mode dispatches after).  Returns per
    kernel its card time (``queued_ms``) and bound on the main path's
    shape (K1: round 1; K2: the packed span; K3, K4: round 1 and the
    span), with the window's candidates a read."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine.device_engine import pack_spans
    stream = BlockReadStream(rpath, eng.param, readset=0,
                             lib=native.get_lib())
    blk = stream.next_block(eng.B)
    stream.close()
    nw, _live, rows_np, _b = eng.block_rows(blk)
    MS = eng._maxseg
    rows0 = torch.from_numpy(rows_np).cuda()
    rows_np = rows_np.copy()
    rows_np[:, -1] = MS - 1
    rowsF = torch.from_numpy(rows_np).cuda()
    tabs, kt, pa = eng.tables, eng.tables["kmer_tab"], eng.tables["prof_a"]
    cfg = eng._cfg("f", lean=True, nw=nw)
    cfg_f, cfg_p = cfg._replace(fixed=True), cfg._replace(probe=True,
                                                          lean=False)
    s_f = K.fixed_schedule(cfg_f, rows0, kt)
    check(errs, "fixed_schedule", "hg38 round 1", s_f,
          K.fixed_schedule_plain(cfg_f, rows0, kt))
    vc_f = K.verify_candidates(cfg_f, eng.CANDS, rows0, s_f, tabs)
    check(errs, "verify_candidates", "hg38 round 1", vc_f,
          K.verify_candidates_plain(cfg_f, eng.CANDS, rows0, s_f, tabs))
    check(errs, "reduce_reads", "hg38 round 1",
          [K.reduce_reads(cfg_f, eng.CANDS, rows0, vc_f, s_f)],
          [K.reduce_reads_plain(cfg_f, eng.CANDS, rows0, vc_f, s_f)])
    pr = K.exact_schedule(cfg_p, rowsF, kt, pa, probe=True)
    check(errs, "exact_schedule", "hg38 probe", [pr.ftot_rank],
          [K.exact_schedule_plain(cfg_p, rowsF, kt, pa, probe=True)
           .ftot_rank])
    ftr = pr.ftot_rank.cpu().numpy().astype("int64")
    a0, b0, cap = pack_spans(ftr[:, 0], eng.B, eng.CANDS, eng.CANDS_BIG)[0]
    rowsP = rows0[a0: b0]
    s_p = K.exact_schedule(cfg, rowsP, kt, pa)
    check(errs, "exact_schedule", "hg38 packed span", s_p,
          K.exact_schedule_plain(cfg, rowsP, kt, pa))
    vc_p = K.verify_candidates(cfg, cap, rowsP, s_p, tabs)
    check(errs, "verify_candidates", "hg38 packed span", vc_p,
          K.verify_candidates_plain(cfg, cap, rowsP, s_p, tabs))
    check(errs, "reduce_reads", "hg38 packed span",
          [K.reduce_reads(cfg, cap, rowsP, vc_p, s_p)],
          [K.reduce_reads_plain(cfg, cap, rowsP, vc_p, s_p)])
    m, mp = rows0.shape[0], rowsP.shape[0]
    nc_f = min(int(vc_f.starts[-1]), eng.CANDS)
    nc_p = min(int(vc_p.starts[-1]), cap)
    log(f"[28] hg38 window: {m} reads, full-rank candidates a read "
        f"{ftr[:, -1].mean():.1f} mean, {int(ftr[:, -1].max())} most; rank 0 "
        f"{ftr[:, 0].mean():.1f}; round 1 {int(vc_f.starts[-1])} candidates "
        f"for a capacity of {eng.CANDS}; first packed span {mp} reads, "
        f"{nc_p} candidates, capacity {cap} — kernels == twins")
    timed = {
        "fixed_schedule": (lambda: K.fixed_schedule(cfg_f, rows0, kt),
                           bound("fixed_schedule", cfg_f, m)),
        "exact_schedule": (lambda: K.exact_schedule(cfg, rowsP, kt, pa),
                           bound("exact_schedule", cfg, mp)),
        "verify_candidates": (
            lambda: K.verify_candidates(cfg, cap, rowsP, s_p, tabs),
            bound("verify_candidates", cfg, mp, nc_p, cap)),
        "reduce_reads": (lambda: K.reduce_reads(cfg, cap, rowsP, vc_p, s_p),
                         bound("reduce_reads", cfg, mp, nc_p, cap)),
    }
    res = {name: {"device_ms": queued_ms(fn), **b}
           for name, (fn, b) in timed.items()}
    extra = {
        "exact_schedule": ("probe", lambda: K.exact_schedule(
            cfg_p, rowsF, kt, pa, probe=True), bound("exact_schedule",
                                                     cfg_p, m)),
        "verify_candidates": ("round1", lambda: K.verify_candidates(
            cfg_f, eng.CANDS, rows0, s_f, tabs), bound(
                "verify_candidates", cfg_f, m, nc_f, eng.CANDS)),
        "reduce_reads": ("round1", lambda: K.reduce_reads(
            cfg_f, eng.CANDS, rows0, vc_f, s_f), bound(
                "reduce_reads", cfg_f, m, nc_f, eng.CANDS)),
    }
    for name, (tag, fn, b) in extra.items():
        res[name][f"{tag}_device_ms"] = queued_ms(fn)
        res[name][f"{tag}_bound_ms"] = b["bound_ms"]
    for name, r in res.items():
        log(f"    [28] hg38 {name}: {_ms(r['device_ms'])} a call on the card, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + "".join(f"; {t} {_ms(r[t + '_device_ms'])}, bound "
                      f"{r[t + '_bound_ms']:.4f} ms" for t in
                      ("probe", "round1") if t + "_device_ms" in r))
    res["verify_candidates"].update(
        cands_per_read_mean=float(ftr[:, -1].mean()),
        cands_per_read_max=int(ftr[:, -1].max()), span_reads=mp,
        span_cands=nc_p, span_capacity=cap)
    return res


def scale_pe_kernels(K, genome, index, param, r1: str, r2: str,
                     errs: dict) -> dict:
    """Phase 28's pair-end kernels against their twins on the first window
    of the hg38-class pairs at rank 0 on the small tier (the main path's
    phase 1): K5 (mate 2's rc rows), each mate's K2, K3 and K4 with cfg.pe
    and 16 hits, then K6; card times on mate 2 and the join, with bounds."""
    import torch
    from bsmap_tpu_torch import native
    from bsmap_tpu_torch.blockio import BlockReadStream
    from bsmap_tpu_torch.engine.pair_device import PairDeviceEngine
    eng = PairDeviceEngine(genome, index, param, device="cuda")
    se = eng.se
    blks = []
    for readset, path in ((1, r1), (2, r2)):
        stream = BlockReadStream(path, param, readset=readset,
                                 lib=native.get_lib())
        blks.append(stream.next_block(se.B))
        stream.close()
    nw, _live, _pos, ra_np, rb_np = eng.block_pair_rows(*blks)
    cfg_a, cfg_b = eng._cfg(1, nw), eng._cfg(2, nw)
    tabs, cap = se.tables, se.CANDS
    kt, pa = tabs["kmer_tab"], tabs["prof_a"]
    da, db = (torch.from_numpy(x).cuda() for x in (ra_np, rb_np))
    full, ncand = [], 0
    for cfg, rows in ((cfg_a, da), (cfg_b, db)):
        fwd, rc = K.chain_inputs(cfg, rows)
        if cfg.chains_mode != "f":
            check(errs, "rc_words", "hg38 mate 2",
                  [rc if rc is not None else fwd],
                  [K.rc_words_plain(cfg, rows)])
        slots = K.exact_schedule(cfg, fwd, kt, pa, rows_rc=rc)
        check(errs, "exact_schedule", "hg38 pairs", slots,
              K.exact_schedule_plain(cfg, fwd, kt, pa, rows_rc=rc))
        vc = K.verify_candidates(cfg, cap, fwd, slots, tabs, rc)
        check(errs, "verify_candidates", "hg38 pairs", vc,
              K.verify_candidates_plain(cfg, cap, fwd, slots, tabs, rc))
        out = K.reduce_reads(cfg, cap, fwd, vc, slots)
        check(errs, "reduce_reads", "hg38 pairs", [out],
              [K.reduce_reads_plain(cfg, cap, fwd, vc, slots)])
        full.append(out)
        ncand = min(int(vc.starts[-1]), cap)
    j = K.pair_join(cfg_a, full[0], full[1], da, db)
    check(errs, "pair_join", "hg38 pairs", [j],
          [K.pair_join_plain(cfg_a, full[0], full[1], da, db)])
    m = da.shape[0]
    log(f"[28] hg38 pairs: {m} pairs at rank 0, mate 2 {ncand} candidates "
        f"for a capacity of {cap}, {int(((j[:, 6] & 31) > 0).sum())} paired "
        "in phase 1 — kernels == twins")
    timed = {
        "rc_words": (lambda: K.rc_words(cfg_b, db), bound("rc_words", cfg_b,
                                                          m)),
        "exact_schedule": (lambda: K.exact_schedule(cfg_b, fwd, kt, pa,
                                                    rows_rc=rc),
                           bound("exact_schedule", cfg_b, m)),
        "verify_candidates": (
            lambda: K.verify_candidates(cfg_b, cap, fwd, slots, tabs, rc),
            bound("verify_candidates", cfg_b, m, ncand, cap)),
        "reduce_reads": (lambda: K.reduce_reads(cfg_b, cap, fwd, vc, slots),
                         bound("reduce_reads", cfg_b, m, ncand, cap)),
        "pair_join": (lambda: K.pair_join(cfg_a, full[0], full[1], da, db),
                      bound("pair_join", cfg_a, m,
                            live=live_combos(cfg_a, *full))),
    }
    res = {}
    for name, (fn, b) in timed.items():
        res[name] = {"device_ms": queued_ms(fn), **b}
        log(f"    [28] hg38 pairs {name}: {_ms(res[name]['device_ms'])} a "
            f"call on the card, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    del eng, se, tabs, full, da, db
    torch.cuda.empty_cache()
    return res


def start_genome_scale_prep(root: str) -> subprocess.Popen:
    """Phase 28's genome and index (``genome_scale --steps genome,index``:
    the 3.12 Gb FASTA, its packed genome and the native index build, with
    their caches in ``root``/hg38), in a process of its own: some eight
    minutes of one host core, run while the earlier phases go on."""
    d = os.path.join(root, "hg38")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    return spawn([sys.executable, "-m", "bsmap_tpu_torch.genome_scale",
                  "--steps", "genome,index", "--dir", d], env,
                 os.path.join(root, "hg38_prep.log"))


def phase_genome_scale(root: str, main_runs: list, prep) -> dict:
    """Phase 28: ``bsmap_tpu_torch.genome_scale``'s steps 1-4, and step 5
    at ``N_SCALE_PAIRS`` pairs without methratio, on the full 3.12 Gb
    hg38-class genome built here from seed 38: the kernels against their
    twins on its first windows (``scale_se_kernels``,
    ``scale_pe_kernels``), the device's idle share, then both main paths
    with their launches counted; the steps themselves hold the reads past
    2^31 at their true places and the first reads and pairs byte-identical
    to the host engine.  ``prep`` (``start_genome_scale_prep``) writes the
    FASTA and builds the genome and index caches; the steps here wait for
    it and map them."""
    import torch
    from bsmap_tpu_torch import genome_scale as gs
    from bsmap_tpu_torch.engine import kernels as K
    t0 = time.time()
    waited = finish([prep], timeout=PREP_TIMEOUT)[0]
    with open(os.path.join(root, "hg38_prep.log")) as f:
        built = json.loads(f.read().strip().splitlines()[-1])
    log(f"[28] genome and index built in a process of their own while the "
        f"earlier phases ran (waited {waited:.1f} s for it): genome "
        f"{json.dumps(built['genome'])}; index {json.dumps(built['index'])}")
    a = gs.parse(["--dir", os.path.join(root, "hg38"), "--pe-pairs",
                  str(N_SCALE_PAIRS), "--no-methratio"])
    s = gs.Scale(a)
    genome, rec = gs.step_genome(s)
    log(f"[28] genome: {json.dumps(rec)}")
    index, rec = gs.step_index(s, genome)
    log(f"[28] index: {json.dumps(rec)}")
    eng, tables = gs.step_tables(s, genome, index)
    log(f"[28] tables: {json.dumps(tables)}")
    chrs = gs.chr_arrays(s.gpath, a.n_chr, a.chr_len)
    rpath = gs.se_reads(s, chrs)[0]
    r1, r2 = gs.pe_reads(s, chrs, a.pe_pairs)
    errs = {k: 0 for k in SE_PATH + PE_PATH}
    kres = scale_se_kernels(K, eng, rpath, errs)
    prof = gs.idle_share(s, eng, rpath, gs.PROFILE_READS)
    log(f"[28] idle share over an align pass of {gs.PROFILE_READS} "
        f"reads: {json.dumps(prof)}")
    del eng
    K.reset_launch_counts()
    se = gs.step_se(s, genome, chrs)
    main_runs.append(K.launch_counts())
    need_launches("[28] hg38-class SE run", main_runs[-1], SE_PATH)
    log(f"[28] se: {json.dumps(se)}")
    pres = scale_pe_kernels(K, genome, index, s.param(["-b", "x"]
                                                      + gs.PE_FLAGS),
                            r1, r2, errs)
    K.reset_launch_counts()
    pe = gs.step_pe(s, chrs, methratio=False)
    main_runs.append(K.launch_counts())
    need_launches("[28] hg38-class PE run", main_runs[-1], PE_PATH)
    log(f"[28] pe: {json.dumps(pe)}")
    for k, r in kres.items():
        r["launches"] = main_runs[-2][k]
    for k, r in pres.items():
        r["launches"] = main_runs[-1][k]
    card = max(se["card_max_allocated"], pe["card_max_allocated"],
               tables["card_max_allocated"])
    log(f"[28] summary: card memory {card / 2 ** 30:.2f} GiB (tables "
        f"{tables['tables_total_bytes'] / 2 ** 30:.2f} GiB), SE "
        f"{se['reads_per_s']:.1f} reads/s, idle share "
        f"{prof['idle_share']:.4f}, n_probe {se['n_probe']}, n_replayed "
        f"{se['n_replayed']}, n_dispatched {se['n_dispatched']}, candidates "
        f"a read {se['cands_mean']:.1f} mean {se['cands_max']} most; PE "
        f"{pe['pairs_per_s']:.1f} pairs/s, n_replayed {pe['n_replayed']}; "
        f"reads past 2^31 at their true places {json.dumps(se['high'])}; "
        f"{time.time() - t0:.1f} s")
    del genome, index, chrs
    torch.cuda.empty_cache()
    return {"se": kres, "pe": pres, "errs": errs, "card_bytes": card}


def need_launches(what: str, counts: dict, need, never=()) -> None:
    """A main path's launch counts: every kernel of ``need`` launched, none
    of ``never``."""
    missing = [k for k in need if counts[k] == 0]
    extra = [k for k in never if counts[k]]
    if missing or extra:
        raise AssertionError(f"{what}: kernels never launched {missing}, "
                             f"launched though off the path {extra}")
    log(f"    launches, {what}: {counts}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bsmap_tpu_torch.cli import get_index, parse_args
    from bsmap_tpu_torch.engine import kernels as K
    from bsmap_tpu_torch.reference import load_genome
    from tools.genreads import generate, generate_chr21, generate_rrbs

    card = card_line()
    import numpy
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, numpy {numpy.__version__}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    ptxas = phase_build()
    root = tempfile.mkdtemp(prefix="bsmap_smoke_")
    prep = start_genome_scale_prep(root)
    # every index below is built once and memory-mapped by each later run
    os.environ["BSMAP_TPU_INDEX_CACHE"] = os.path.join(root, "cache")
    # the CLI's default -p 8 starts worker processes on the pair-end
    # per-pair path (BSP, -R, trimming); single-end runs on the card stay
    # one process with -p encode threads.  The phases below run every path
    # in this process, where its launches are counted; phase 27 takes the
    # CLI's own rule: RRBS at -p 8 as one process, pair-end BSP at -p 2
    # with two workers
    os.environ["BSMAP_TPU_LOCAL_MP"] = "0"
    main_runs = []                  # launch counts of every main-path run

    def counted(fn, *args, **kw):
        """Run one main path with the counts zeroed just before it; keep
        and return its counts with its result."""
        K.reset_launch_counts()
        out = fn(*args, **kw)
        main_runs.append(K.launch_counts())
        return out, main_runs[-1]

    try:
        g1, r1, o1, genome, index = phase_data(
            root, generate, "headline", n_reads=N_HEADLINE)
        kres = phase_kernels(o1, genome, index, r1)
        del genome, index
        g2, r2, _o2, _g, _i = phase_data(
            root, generate_chr21, "repeat", n_reads=N_REPEAT)
        del _g, _i

        K.reset_launch_counts()
        head = phase_align("4", g1, r1, os.path.join(root, "head.sam"),
                           N_HEADLINE, 0.9)
        c4 = K.launch_counts()
        log(f"[4] launches, headline run: {c4}")
        rep = phase_align("5", g2, r2, os.path.join(root, "rep.sam"),
                          N_REPEAT, 0.5)
        main_runs.append(K.launch_counts())
        need_launches("[5] headline + repeat-heavy runs", main_runs[-1],
                      SE_PATH)
        from bsmap_tpu_torch import native
        if native.get_lib() is None:
            raise AssertionError("native block path not taken")

        phase_parity("headline", g1, r1, os.path.join(root, "headline"))
        phase_parity("repeat", g2, r2, os.path.join(root, "repeat"))

        gp, p1, p2, op, genome, index = phase_pe_data(root)
        pres = phase_pe_kernels(op, genome, index, p1, p2)
        del genome, index
        pe, c9 = counted(phase_pe_align, gp, p1, p2,
                         os.path.join(root, "pe.sam"), N_PAIRS)
        need_launches("[9] pair-end run", c9, PE_PATH)
        phase_pe_parity(gp, p1, p2, os.path.join(root, "pe_parity"))
        main_runs.append(phase_pe_paths(root))
        sres24 = phase_small_seed(root)

        gr, rr, orr, genome, index = phase_data(
            root, generate_rrbs, "rrbs", flags=RRBS_FLAGS, phase="12")
        rres = phase_rrbs_kernels(orr, genome, index, rr)
        del genome, index
        # -p 1: one encode thread, the rate phase 27's -p 8 is held beside
        rrbs, c14 = counted(phase_align, "14", gr, rr,
                            os.path.join(root, "rrbs.sam"), N_RRBS, 0.9,
                            flags=RRBS_FLAGS + ["-p", "1"])
        need_launches("[14] RRBS run", c14, RRBS_PATH, ("fixed_schedule",))
        phase_parity("rrbs", gr, rr, os.path.join(root, "rrbs"),
                     flags=RRBS_FLAGS, phase="15")
        main_runs.append(phase_rrbs_set(root))

        # -n 1: the four strands, on non-directional copies of the data
        def nd_copy(gpath, rpath):
            def gen(d):
                os.makedirs(d, exist_ok=True)
                return gpath, nondirectional(rpath,
                                             os.path.join(d, "reads_nd.fq"))
            return gen

        _, nd1, o16, genome, index = phase_data(
            root, nd_copy(g1, r1), "headline_n1", flags=ALIGN_FLAGS + N1,
            phase="16")
        kres16 = phase_kernels(o16, genome, index, nd1, mode="b",
                               phase="16")
        del genome, index
        head1, c17 = counted(phase_align, "17", g1, nd1,
                             os.path.join(root, "head_n1.sam"), N_HEADLINE,
                             0.9, flags=ALIGN_FLAGS + N1)
        need_launches("[17] -n 1 run", c17, SE_PATH + ("rc_words",))
        n_rec, n_rc = rc_chain_share(os.path.join(root, "head_n1.sam"))
        if not 0.3 * n_rec < n_rc < 0.7 * n_rec:
            raise AssertionError(f"[17] {n_rc} of {n_rec} picks on the rc "
                                 "chain: expected about half")
        log(f"[17] {n_rc} of {n_rec} picks on the rc chain (ZS:Z:?-)")
        phase_parity("headline -n 1", g1, nd1,
                     os.path.join(root, "headline_n1"),
                     flags=ALIGN_FLAGS + N1, phase="17")

        sp1, sp2 = swap_mates(p1, p2, os.path.join(root, "pe", "sw_1.fq"),
                              os.path.join(root, "pe", "sw_2.fq"))
        o18 = parse_args(["-a", sp1, "-b", sp2, "-d", gp, "-o", "x.sam"]
                         + PE_FLAGS + N1)
        genome = load_genome(gp, o18.param)
        pres18 = phase_pe_kernels(o18, genome, get_index(o18, genome), sp1,
                                  sp2, phase="18")
        del genome
        pe1, c18 = counted(phase_pe_align, gp, sp1, sp2,
                           os.path.join(root, "pe_n1.sam"), N_PAIRS,
                           flags=PE_FLAGS + N1, phase="18")
        need_launches("[18] pair-end -n 1 run", c18, PE_PATH)
        main_runs.append(phase_pe_paths(root, extra=N1, phase="18"))

        _, rr1, o19, genome, index = phase_data(
            root, nd_copy(gr, rr), "rrbs_n1", flags=RRBS_FLAGS + N1,
            phase="19")
        rres19 = phase_rrbs_kernels(o19, genome, index, rr1, mode="b",
                                    phase="19")
        del genome, index
        # a reverse-complemented fragment-start read begins at no site: the
        # rc chain seeds from the read's end (cseed_offset), so such a read
        # maps only where it spans its fragment; the forward half maps
        rrbs1, c19 = counted(phase_align, "19", gr, rr1,
                             os.path.join(root, "rrbs_n1.sam"), N_RRBS, 0.45,
                             flags=RRBS_FLAGS + N1)
        need_launches("[19] RRBS -n 1 run", c19, RRBS_PATH + ("rc_words",),
                      ("fixed_schedule",))
        main_runs.append(phase_rrbs_set(root, extra=N1, phase="19"))

        # the multi-device engines: D region shards / read stripes, round
        # robin over the visible cards
        o20 = parse_args(["-a", r2, "-d", g2, "-o", "x.sam"] + ALIGN_FLAGS)
        genome = load_genome(g2, o20.param)
        index = get_index(o20, genome)
        sres, sres1 = phase_shard_kernels(o20, genome, index, r2)
        del genome, index
        ise = phase_index_sharded_se(root, g2, r2, rep)
        main_runs.append(ise.pop("launches"))
        sd_rate, c22 = phase_stripes_se(root, g1, r1)
        main_runs.append(c22)
        main_runs.append(phase_mesh_pe(root))

        # BAM out and in, methratio and bsp2sam, multi-process runs
        # the headline's runs launch what phase 4's run launched; in
        # ranges of it, every range the round-1 kernels (K2 runs in one
        # window of phase 4)
        se_need = tuple(k for k in SE_PATH if c4[k])
        bam, c25 = phase_bam(root, g1, r1, gp, p1, p2, se_need)
        main_runs.extend(c25)
        meth = phase_methratio(root, g1, r1, gp)
        # pair-end BSP with -2 at -p 1: the bytes phase 27's -p 2 run
        # (one process on the block path) must write
        bsp = ["-a", p1, "-b", p2, "-d", gp] + PE_FLAGS + ["-E",
                                                           str(N_PE_BSP)]
        bsp_one = [os.path.join(root, f"pe_bsp{x}.bsp") for x in ("", "_u")]
        st_bsp, c_bsp = counted(run_cli, bsp + [
            "-o", bsp_one[0], "-2", bsp_one[1], "--device", "cuda", "-p",
            "1"])
        need_launches("[27] pair-end BSP, one process", c_bsp, PE_PATH)
        if st_bsp["pe_path"] != "blocks":
            raise AssertionError("[27] pair-end BSP off the block path")
        mp, c27 = phase_multiprocess(root, {
            "headline": ("nprocs", ["-a", r1, "-d", g1] + ALIGN_FLAGS,
                         [os.path.join(root, "head.sam")],
                         tuple(k for k in se_need if k != "exact_schedule"),
                         se_need, (), N_HEADLINE, head["reads_per_s"]),
            "rrbs_mspi_trim": ("one", ["-a", rr, "-d", gr, "-p", "8"]
                               + RRBS_FLAGS, [os.path.join(root, "rrbs.sam")],
                               RRBS_PATH, RRBS_PATH, ("fixed_schedule",),
                               N_RRBS, rrbs["reads_per_s"]),
            "pe_76nt": ("nprocs", ["-a", p1, "-b", p2, "-d", gp] + PE_FLAGS,
                        [os.path.join(root, "pe.sam")], PE_PATH, PE_PATH, (),
                        N_PAIRS, pe["pairs_per_s"]),
            "pe_76nt_bsp": ("one", bsp + ["-p", str(N_NPROCS)], bsp_one,
                            PE_PATH, PE_PATH, (), N_PE_BSP,
                            st_bsp["pairs"] / st_bsp["align_s"])})
        main_runs.extend(c27)
        trim, c29 = phase_pe_trim(root, gp, pe["pairs_per_s"])
        main_runs.extend(c29)
        qc, c30 = phase_qc_lines(root, g1, r1)
        main_runs.extend(c30)
        ctx, c31 = phase_range_contexts(root)
        main_runs.extend(c31)
        scale = phase_genome_scale(root, main_runs, prep)
    finally:
        if prep.poll() is None:          # a phase before 28 failed
            with contextlib.suppress(TimeoutError):
                finish([prep], timeout=0)
        shutil.rmtree(root, ignore_errors=True)

    log(f"[summary] headline {head['reads_per_s']:.1f} reads/s, "
        f"repeat-heavy {rep['reads_per_s']:.1f} reads/s, pair-end "
        f"{pe['pairs_per_s']:.1f} pairs/s, RRBS "
        f"{rrbs['reads_per_s']:.1f} reads/s; -n 1: headline "
        f"{head1['reads_per_s']:.1f} reads/s, pair-end "
        f"{pe1['pairs_per_s']:.1f} pairs/s, RRBS "
        f"{rrbs1['reads_per_s']:.1f} reads/s; index-sharded (D = "
        f"{N_SHARDS}) repeat-heavy {ise['reads_per_s']:.1f} reads/s, at -v 5 "
        f"{ise['index-sharded -v 5']:.1f} (single-device "
        f"{ise['device -v 5']:.1f}); read stripes (D = 2) headline "
        f"{sd_rate:.1f} reads/s")
    log("[summary] .bam runs: " + ", ".join(
        f"{k} aligned at {v['per_s']:.1f}/s, SAM -> BAM {v['bam_s']:.3f} s"
        for k, v in bam.items()) + f"; methratio on {N_PAIRS} pairs: BAM "
        f"{meth['methratio_bam_s']:.1f} s, SAM {meth['methratio_sam_s']:.1f} "
        "s; [27] launch to the (merged) file / one process's alignment "
        "phase: " + ", ".join(f"{k} ({v['how']}) {v['per_s_wall']:.1f} / "
                              f"{v['one_process_per_s']:.1f}"
                              for k, v in mp.items())
        + "; [29] pair-end trimming on the block path (the synthetic "
        "mix), pairs/s at -p 1 / "
        "-p 8: " + ", ".join(f"{k} {v['pairs_per_s']:.1f} / "
                              f"{v['p8_pairs_per_s']:.1f}"
                              for k, v in trim.items())
        + f" (phase 9's SAM {pe['pairs_per_s']:.1f}); [30] BSP -u QC "
        f"lines: {qc['qc_lines']} ({qc['qc_reverse']} reverse-complemented) "
        f"at -p 1, -p 8 and --nprocs 2, range start taken over in "
        f"{qc['walk_s']:.3f} s; [31] pair-end contexts at range starts: "
        + ", ".join(f"{k} {v['patches']} patches in {v['patch_s']:.6f} s"
                    for k, v in ctx["runs"].items())
        + f" ({ctx['wall_s']:.1f} s)")
    log("[summary] seconds by phase: " + json.dumps(
        {k: round(v, 1) for k, v in _PHASE_S.items()}))
    results = (kres, pres, rres, kres16, pres18, rres19, sres, sres1, sres24,
               {k: {"max_abs_err": v} for k, v in scale["errs"].items()})
    rows = []
    for k, (src, rep_) in KERNEL_SOURCES.items():
        # the main path's shapes: the SE headline window, else the PE one,
        # the index-sharded repeat-heavy window for K7
        t = next(r[k] for r in (kres, pres, sres) if "ms" in r.get(k, {}))
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep_,
                     "launches": sum(c[k] for c in main_runs),
                     "max_abs_err": max(r[k]["max_abs_err"]
                                        for r in results if k in r),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": None,
                     **{x: t[x] for x in FORM_KEYS if x in t},
                     "ptxas": ptxas.get(os.path.basename(src)),
                     # phase 28: the hg38-class genome's first windows
                     "hg38": {tag: scale[tag][k] for tag in ("se", "pe")
                              if k in scale[tag]} or None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
