"""Share of the traced pass the align loop spent waiting for its next
encoded block (``pipe.input_wait``), in percent.
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["loop.input_wait_share"]
