"""Output sink of a benchmark run: reads every pass the aligner writes into
a named pipe, so the output never reaches the disk.

    python benchmark/drain.py FIFO

Reads one JSON list of read names from stdin (the sample the correctness
check compares).  Then, for each pass: opens FIFO and streams it to its
end, keeping only the pass's byte count, its SAM header and the lines of
the sampled reads; prints ``eof <bytes>`` (the harness starts the next
pass on that line).  A pass of no bytes ends the loop: it prints the kept
passes as one JSON line and exits.  The aligner writes reads in input
order and read names are fixed-width (``r000000017``), so the sampled
names are looked for one after another, each in the stretch of complete
reads read so far.
"""

from __future__ import annotations

import json
import sys

CHUNK = 1 << 20


def _read_index(line_start: bytes) -> int:
    return int(line_start[1:line_start.index(b"\t")])


class PassScan:
    """The header and the sampled reads' lines of one pass, fed chunk by
    chunk; holds at most a chunk and the lines of one read."""

    def __init__(self, names: list[str]):
        self.names = sorted(names)
        self.keys = [b"\n" + n.encode() + b"\t" for n in self.names]
        self.index = [int(n[1:]) for n in self.names]
        self.next = 0
        self.lines: dict[str, list[str]] = {n: [] for n in self.names}
        self.header: bytes | None = None
        self.buf = b""
        self.nbytes = 0

    def feed(self, chunk: bytes) -> None:
        self.nbytes += len(chunk)
        self.buf += chunk
        if self.header is None and not self._take_header(False):
            return
        cut = self.buf.rfind(b"\n") + 1
        if cut == 0:
            return
        # the last complete line's read may go on in the next chunk: keep
        # its lines from their first one
        last = self.buf.rfind(b"\n", 0, cut - 1) + 1
        first = self._first_line_of(self.buf[last:cut], cut)
        self._scan(self.buf[:first], _read_index(self.buf[last:cut]))
        self.buf = self.buf[first:]

    def finish(self) -> dict:
        if self.header is None:
            self._take_header(True)
        self._scan(self.buf, None)
        self.buf = b""
        return {"bytes": self.nbytes,
                "header": (self.header or b"").decode("latin1"),
                "lines": self.lines}

    def _take_header(self, at_end: bool) -> bool:
        """Cut the leading ``@`` lines off ``buf`` once a line that is not
        one has begun (or the pass has ended)."""
        end = 0
        while end < len(self.buf) and self.buf[end:end + 1] == b"@":
            nl = self.buf.find(b"\n", end)
            if nl < 0:
                if not at_end:
                    return False
                end = len(self.buf)
                break
            end = nl + 1
        if end == len(self.buf) and not at_end:
            return False
        self.header, self.buf = self.buf[:end], self.buf[end:]
        return True

    def _first_line_of(self, line: bytes, cut: int) -> int:
        key = b"\n" + line[:line.index(b"\t") + 1]
        if self.buf.startswith(key[1:]):
            return 0
        return self.buf.find(key, 0, cut) + 1

    def _scan(self, done: bytes, before: int | None) -> None:
        """Collect the sampled reads whose lines are all in ``done``
        (every read below index ``before``; all, where None)."""
        text = b"\n" + done
        pos = 0
        while self.next < len(self.names):
            k = self.next
            if before is not None and self.index[k] >= before:
                return
            at = text.find(self.keys[k], pos)
            while at >= 0:
                end = text.find(b"\n", at + 1)
                end = len(text) if end < 0 else end
                self.lines[self.names[k]].append(
                    text[at + 1:end + 1].decode("latin1"))
                pos = end
                at = text.find(self.keys[k], pos, pos + len(self.keys[k]))
            self.next += 1


def main() -> int:
    fifo = sys.argv[1]
    names = json.loads(sys.stdin.readline())
    passes = []
    while True:
        scan = PassScan(names)
        with open(fifo, "rb") as f:
            while chunk := f.read(CHUNK):
                scan.feed(chunk)
        if not scan.nbytes:
            break
        sys.stdout.write(f"eof {scan.nbytes}\n")
        sys.stdout.flush()
        passes.append(scan.finish())
    sys.stdout.write(json.dumps(passes) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
