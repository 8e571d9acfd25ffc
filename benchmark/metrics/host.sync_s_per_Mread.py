"""Σ ``host.sync`` on any thread (the host route's seed-buffer and
schedule sync before a host read or pair), seconds per million reads.
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["host.sync_s_per_Mread"]
