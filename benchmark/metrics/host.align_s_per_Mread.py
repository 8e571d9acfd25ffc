"""Σ ``host.align`` on any thread (the host route's exact aligner),
seconds per million reads.
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["host.align_s_per_Mread"]
