"""Units (reads; pairs pair-end) sent to the host route for a stale seed
schedule, first of their causes, over the traced pass's units, in
percent (the counter ``host_causes.stale``).
Read from the port's spans or counters by ``program_spans``."""

from program_spans import READERS

read = READERS["host.stale_share"]
