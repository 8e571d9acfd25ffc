"""bsmap_tpu_torch — the bisulfite aligner of ``bsmap_tpu`` on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper.

Single-end, pair-end and RRBS alignment run end to end: native FASTQ/FASTA
parsing and encoding (SAM/BAM input too), the seed schedule, candidate
verification, per-read reduction and the pair join as CUDA kernels
(``engine/kernels.py``, ``csrc/``), exact host replay of the
control-flow-sensitive reads, native SAM/BSP formatting, BAM output,
``methratio``, ``bsp2sam`` and multi-process runs.  The host layers are
byte-identical copies of ``bsmap_tpu``'s; this package never imports JAX.
"""

__version__ = "0.1.0"
