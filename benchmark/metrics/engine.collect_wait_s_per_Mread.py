"""Σ ``engine.collect`` on any thread (copies back and the waits for the
card), seconds per million reads.
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["engine.collect_wait_s_per_Mread"]
