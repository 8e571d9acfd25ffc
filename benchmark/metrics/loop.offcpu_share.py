"""Share of the align loop's own time in its spans (waits and
``engine.collect`` left out) in which its thread had no CPU (the GIL,
page faults), in percent.
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["loop.offcpu_share"]
