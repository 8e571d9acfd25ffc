"""The align loop's ``engine.align`` and ``engine.finish`` spans less the
``engine.collect`` spans inside them: the engine's host side in the
pipeline, seconds per million reads.
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["loop.engine_s_per_Mread"]
