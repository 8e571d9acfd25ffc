"""Read ingestion: FASTA/FASTQ batch reader (reads.cpp).

Replicates the reference's stream parsing (reads.cpp:83-146) exactly:
``fin>>tok`` reads one whitespace-delimited token (possibly crossing line
boundaries) and ``getline`` discards the remainder of the current line.  So a
read record is: marker char, name token, rest-of-line discarded, sequence =
ONE token; FASTQ adds a '+' token + discard + quality token.  FASTA reads get
a synthetic quality of chr(zero_qual + default_qual) (reads.cpp:108); reads
longer than -L are truncated (reads.cpp:115-117); -B/-E select the read range
(reads.cpp:54-75,93-94).  Batches of 50,000 reads (reads.h:13).

SAM/BAM input (libbam in the reference) lives in bamio.py.
"""

from __future__ import annotations

import dataclasses

BATCH_NUM = 50000  # reads.h:13


@dataclasses.dataclass
class Read:
    index: int       # global read counter, starts at read_start-1
    readset: int     # 0 SE, 1 PE mate 1, 2 PE mate 2 (reads.h:18)
    name: str
    seq: str
    qual: str
    raw_len: int = 0  # pre-trim length, set by the trim pipeline


class _TokenStream:
    """istream-style tokenizer: next_token() == fin>>s, skip_line() == getline."""

    def __init__(self, fh):
        self._fh = fh
        self._line = ""
        self._pos = 0

    def _fill(self) -> bool:
        while self._pos >= len(self._line):
            line = self._fh.readline()
            if not line:
                return False
            self._line = line
            self._pos = 0
            # strip leading whitespace lazily in next_token
        return True

    def next_token(self) -> str | None:
        while True:
            if not self._fill():
                return None
            line, pos = self._line, self._pos
            n = len(line)
            while pos < n and line[pos] in " \t\r\n":
                pos += 1
            if pos >= n:
                self._pos = n
                continue
            start = pos
            while pos < n and line[pos] not in " \t\r\n":
                pos += 1
            self._pos = pos
            return line[start:pos]

    def peek_char(self) -> str | None:
        """First non-whitespace char without consuming it."""
        while True:
            if not self._fill():
                return None
            line, pos = self._line, self._pos
            n = len(line)
            while pos < n and line[pos] in " \t\r\n":
                pos += 1
            if pos >= n:
                self._pos = n
                continue
            self._pos = pos
            return line[pos]

    def get_char(self) -> str | None:
        c = self.peek_char()
        if c is not None:
            self._pos += 1
        return c

    def skip_line(self) -> None:
        self._pos = len(self._line)


def detect_format(path: str) -> int:
    """CheckFile probe (reads.cpp:13-51): 1 FASTA, 0 FASTQ, 3 BAM, 2 SAM."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head[:1] == b">":
        return 1
    if head[:1] == b"@":
        return 0
    if head[:2] == b"\x1f\x8b":
        return 3
    return 2


def open_read_stream(path: str, param, readset: int):
    """Dispatch on file format: FASTA/FASTQ here, SAM/BAM via bamio."""
    if detect_format(path) >= 2:
        from .bamio import BamReadStream
        return BamReadStream(path, param, readset)
    return ReadStream(path, param, readset)


class ReadStream:
    """Batch reader over one FASTA/FASTQ reads file (LoadBatchReads)."""

    def __init__(self, path: str, param, readset: int):
        self.param = param
        self.readset = readset
        self.fmt = detect_format(path)
        if self.fmt >= 2:
            raise NotImplementedError(
                "SAM/BAM read input: use bamio.BamReadStream")
        self._fh = open(path, "r")
        self._ts = _TokenStream(self._fh)
        self.index = param.read_start - 1  # reads.cpp:80
        # CheckFile line-skip to -B start (reads.cpp:54-66)
        per = 4 if self.fmt == 0 else 2
        for _ in range((param.read_start - 1) * per):
            self._fh.readline()

    def _next_record(self) -> Read | None:
        p, ts = self.param, self._ts
        if self.index >= p.read_end:
            return None
        c = ts.get_char()          # fin>>c: the '>' / '@' marker
        if c is None:
            return None
        name = ts.next_token()     # fin>>name (rest of marker token or next)
        if name is None:
            return None
        ts.skip_line()             # getline
        seq = ts.next_token()      # fin>>seq
        if seq is None:
            return None
        if self.fmt == 0:
            if ts.next_token() is None:   # '+' token
                return None
            ts.skip_line()
            qual = ts.next_token()
            if qual is None:
                return None
        else:
            qual = chr(p.zero_qual + p.default_qual) * len(seq)
        if len(seq) > p.max_readlen:
            seq = seq[: p.max_readlen]
            qual = qual[: p.max_readlen]
        r = Read(index=self.index, readset=self.readset, name=name,
                 seq=seq, qual=qual)
        self.index += 1
        return r

    def next_batch(self, n: int = BATCH_NUM) -> list[Read]:
        out = []
        for _ in range(n):
            r = self._next_record()
            if r is None:
                break
            out.append(r)
        return out

    def close(self) -> None:
        self._fh.close()
