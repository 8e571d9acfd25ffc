"""Block-based read ingestion: zero-copy batches for the device fast path.

The per-read Python object path (readio.ReadStream -> Read dataclasses)
costs ~15us/read in parse alone — two orders of magnitude over the TPU
kernel's per-read budget.  This module streams the file in large chunks and
tokenizes them natively (bsmap_native.cpp, exact reads.cpp:83-146 stream
semantics), yielding ``ReadBlock``s: one bytes buffer + (n, 6) offset
arrays.  Read objects are materialized lazily only for the rare exact-replay
reads.
"""

from __future__ import annotations

import numpy as np

from .readio import Read, detect_format

CHUNK = 8 << 20


class ReadBlock:
    """One parsed block: buffer + per-read (name/seq/qual) offset table."""

    __slots__ = ("buf", "rec", "start_index", "readset", "is_fasta",
                 "synth_qual", "enc")

    def __init__(self, buf: bytes, rec: np.ndarray, start_index: int,
                 readset: int, is_fasta: bool, synth_qual: int):
        self.buf = buf
        self.rec = rec
        self.start_index = start_index
        self.readset = readset
        self.is_fasta = is_fasta
        self.synth_qual = synth_qual
        self.enc = None      # (nw, rows, info) cache: DeviceEngine.encode_block

    def __len__(self) -> int:
        return len(self.rec)

    @property
    def indices(self) -> np.ndarray:
        return self.start_index + np.arange(len(self.rec), dtype=np.int64)

    def name(self, i: int) -> str:
        o, l = int(self.rec[i, 0]), int(self.rec[i, 1])
        return self.buf[o: o + l].decode("latin1")

    def read_obj(self, i: int) -> Read:
        """Materialize read i as a Read object (for exact host replays)."""
        r = self.rec[i]
        seq = self.buf[int(r[2]): int(r[2] + r[3])].decode("latin1")
        if r[4] < 0:
            qual = chr(self.synth_qual) * int(r[3])
        else:
            qual = self.buf[int(r[4]): int(r[4] + r[5])].decode("latin1")
        return Read(index=self.start_index + i, readset=self.readset,
                    name=self.name(i), seq=seq, qual=qual)


class BlockReadStream:
    """Chunked native FASTA/FASTQ reader producing ReadBlocks.

    Requires the native library; callers fall back to readio.ReadStream when
    ``native.get_lib()`` is None.  Honors -B/-E read ranges (reads.cpp:54-75)
    and -L truncation like the reference.
    """

    def __init__(self, path: str, param, readset: int, lib):
        self.param = param
        self.readset = readset
        self.lib = lib
        self.fmt = detect_format(path)
        if self.fmt >= 2:
            raise NotImplementedError("SAM/BAM input: use bamio")
        self._fh = open(path, "rb")
        self._tail = b""
        self._eof = False
        self.index = param.read_start - 1
        per = 4 if self.fmt == 0 else 2
        self._skip_lines((param.read_start - 1) * per)

    def _skip_lines(self, k: int) -> None:
        while k > 0:
            chunk = self._fh.read(CHUNK)
            if not chunk:
                self._eof = True
                return
            pos = -1
            while k > 0:
                nxt = chunk.find(b"\n", pos + 1)
                if nxt < 0:
                    break
                pos = nxt
                k -= 1
            if k == 0:
                self._tail = chunk[pos + 1:]

    def next_block(self, n: int) -> ReadBlock | None:
        """Incremental tokenization: each chunk is parsed once from the
        position after the last complete record (re-parsing only the
        incomplete tail), so block cost is linear in block size — the
        earlier parse-whole-buffer-per-chunk loop was quadratic and
        dominated the 1M-read block path."""
        from . import native
        p = self.param
        remaining = p.read_end - self.index
        if remaining <= 0:
            return None
        n = min(n, remaining)
        acc = bytearray(self._tail)
        base = 0                      # parse position (after last record)
        recs = []
        total = 0
        while True:
            tail = bytes(acc[base:]) if base else bytes(acc)
            rec, consumed = native.parse_reads(
                self.lib, tail, self._eof, self.fmt == 1, p.max_readlen,
                n - total)
            if len(rec):
                rec[:, 0] += base
                rec[:, 2] += base
                rec[:, 4][rec[:, 4] >= 0] += base
                recs.append(rec)
                total += len(rec)
                base += consumed
            if total == n or self._eof:
                break
            chunk = self._fh.read(CHUNK)
            if not chunk:
                self._eof = True      # reparse the tail with is_final=True
            else:
                acc += chunk
        if total == 0:
            self._tail = b""
            return None
        buf = bytes(acc)
        self._tail = buf[base:]
        rec = recs[0] if len(recs) == 1 else np.concatenate(recs)
        blk = ReadBlock(buf, rec, self.index, self.readset, self.fmt == 1,
                        p.zero_qual + p.default_qual)
        self.index += total
        return blk

    def close(self) -> None:
        self._fh.close()
