"""bsmap_tpu_torch — the bisulfite aligner of ``bsmap_tpu`` on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper.

The single-end WGBS path runs end to end: native FASTQ/FASTA parsing and
encoding, the seed schedule, candidate verification and per-read reduction
as four CUDA kernels (``engine/kernels.py``, ``csrc/``), exact host replay
of the control-flow-sensitive reads, and native SAM/BSP formatting.  The
host layers are byte-identical copies of ``bsmap_tpu``'s; this package never
imports JAX.  See ROADMAP.md for what is not ported yet.
"""

__version__ = "0.1.0"
