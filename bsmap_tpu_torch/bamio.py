"""Minimal BAM/BGZF I/O (replaces the vendored samtools 0.1.7, C21/C22).

The reference links libbam for SAM/BAM read *input* (reads.cpp:13-146) and
shells out to ``samtools view|sort|index`` for ``.bam`` output
(sam2bam.sh).  Here both directions are implemented natively:

  * BGZF block compression/decompression (gzip members with the BC extra
    subfield + the 28-byte EOF marker);
  * BAM record encode/decode (SAM spec section 4.2);
  * ``sam_to_bam``: coordinate-sort + write BAM + BAI index (the
    sam2bam.sh pipeline);
  * ``bam_sam_lines``: stream BAM records back as SAM text;
  * ``BamReadStream``: read FASTQ-equivalent reads out of SAM/BAM inputs
    with the reference's mate-interleaving rules (reads.cpp:119-143).
"""

from __future__ import annotations

import os
import struct
import zlib

BAM_MAGIC = b"BAM\x01"
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
SEQ_NT16 = "=ACMGRSVTWYHKDBN"
SEQ_NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
CIGAR_OPS = "MIDNSHP=X"


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

def bgzf_write_block(out, data: bytes) -> None:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(data) + comp.flush()
    crc = zlib.crc32(data) & 0xFFFFFFFF
    # BSIZE stores (total block size - 1); total = 18 header + cdata + 8
    bsize = len(cdata) + 25
    out.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff")
    out.write(struct.pack("<HBBHH", 6, 66, 67, 2, bsize))
    out.write(cdata)
    out.write(struct.pack("<II", crc, len(data) & 0xFFFFFFFF))


class BgzfWriter:
    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 60000:
            bgzf_write_block(self._fh, bytes(self._buf[:60000]))
            del self._buf[:60000]

    def close(self) -> None:
        if self._buf:
            bgzf_write_block(self._fh, bytes(self._buf))
        self._fh.write(BGZF_EOF)
        self._fh.close()


class BgzfReader:
    """Streaming BGZF (or plain-gzip) reader: one block in memory at a time
    (the reference's libbam streams the same way, samtools/bgzf.c).  Tracks
    BGZF virtual offsets (coffset << 16 | uoffset) for BAI building."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block = b""
        self._pos = 0               # position within the current block
        self._cstart = 0            # compressed offset of the current block
        self._plain = None          # decompressobj fallback for plain gzip

    def _next_block(self) -> bool:
        if self._plain is not None:
            return self._next_plain()
        self._cstart = self._fh.tell()
        head = self._fh.read(12)
        if len(head) < 12:
            return False
        if head[:2] != b"\x1f\x8b":
            raise ValueError("not a gzip stream")
        xlen = struct.unpack_from("<H", head, 10)[0] if head[3] & 4 else 0
        bsize = None
        if xlen:
            extra = self._fh.read(xlen)
            xoff = 0
            while xoff + 4 <= xlen:
                si1, si2 = extra[xoff], extra[xoff + 1]
                slen = struct.unpack_from("<H", extra, xoff + 2)[0]
                if si1 == 66 and si2 == 67:
                    bsize = struct.unpack_from("<H", extra, xoff + 4)[0] + 1
                xoff += 4 + slen
        if bsize is None:
            # plain gzip member: fall back to whole-stream decompression
            self._fh.seek(self._cstart)
            self._plain = zlib.decompressobj(31)
            return self._next_plain()
        cdata = self._fh.read(bsize - 12 - xlen)
        self._block = zlib.decompress(cdata[:-8], -15)
        self._pos = 0
        return len(self._block) > 0 or self._next_block()

    def _next_plain(self) -> bool:
        while True:
            raw = self._fh.read(1 << 20)
            if not raw:
                return False
            out = self._plain.decompress(raw)
            while self._plain.unused_data:
                tail = self._plain.unused_data
                self._plain = zlib.decompressobj(31)
                out += self._plain.decompress(tail)
            if out:
                self._block = out
                self._pos = 0
                return True

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._pos >= len(self._block):
                if not self._next_block():
                    break
            take = min(n, len(self._block) - self._pos)
            out += self._block[self._pos: self._pos + take]
            self._pos += take
            n -= take
        return bytes(out)

    def tell_virtual(self) -> int:
        if self._pos >= len(self._block):
            # between blocks: the next block's start
            return self._fh.tell() << 16
        return (self._cstart << 16) | self._pos

    def close(self) -> None:
        self._fh.close()


def bgzf_read_all(path: str) -> bytes:
    """Decompress a whole BGZF (or plain gzip) file (small files only; use
    BgzfReader for streaming)."""
    r = BgzfReader(path)
    out = []
    while True:
        chunk = r.read(1 << 22)
        if not chunk:
            break
        out.append(chunk)
    r.close()
    return b"".join(out)


# ---------------------------------------------------------------------------
# BAM record encoding
# ---------------------------------------------------------------------------

def reg2bin(beg: int, end: int) -> int:
    """SAM spec section 5.3 binning scheme."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_aux(tag: str, typ: str, val) -> bytes:
    out = tag.encode()
    if typ == "i":
        return out + b"i" + struct.pack("<i", int(val))
    if typ == "Z":
        return out + b"Z" + str(val).encode() + b"\x00"
    if typ == "A":
        return out + b"A" + str(val).encode()[:1]
    raise ValueError(typ)


def encode_record(refid: int, pos: int, name: str, flag: int, mapq: int,
                  cigar: list[tuple[int, int]], mrefid: int, mpos: int,
                  tlen: int, seq: str, qual: str, aux: bytes) -> bytes:
    l_seq = len(seq)
    if cigar:
        end = pos + sum(ln for ln, op in cigar
                        if CIGAR_OPS[op] in "MDN=X")
    else:
        end = pos + 1
    b = reg2bin(pos, max(end, pos + 1)) if pos >= 0 else 4680
    nameb = name.encode() + b"\x00"
    body = struct.pack("<iiBBHHHiiii", refid, pos, len(nameb), mapq, b,
                       len(cigar), flag, l_seq, mrefid, mpos, tlen)
    body += nameb
    for ln, op in cigar:
        body += struct.pack("<I", (ln << 4) | op)
    sb = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq):
        code = SEQ_NT16_CODE.get(ch.upper(), 15)
        if i % 2 == 0:
            sb[i // 2] = code << 4
        else:
            sb[i // 2] |= code
    body += bytes(sb)
    if qual == "*" or not qual:
        body += b"\xff" * l_seq
    else:
        body += bytes((ord(q) - 33) & 0xFF for q in qual)
    body += aux
    return struct.pack("<i", len(body)) + body


def _parse_cigar(cig: str) -> list[tuple[int, int]]:
    if cig == "*":
        return []
    out = []
    n = 0
    for ch in cig:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, CIGAR_OPS.index(ch)))
            n = 0
    return out


def _sam_line_to_record(cols: list[str], ref_ids: dict[str, int]) -> bytes:
    name, flag, rname, pos, mapq, cig, mrname, mpos, tlen = cols[:9]
    seq, qual = cols[9], cols[10]
    refid = ref_ids.get(rname, -1)
    if mrname == "=":
        mrefid = refid
    else:
        mrefid = ref_ids.get(mrname, -1)
    aux = b""
    for field in cols[11:]:
        tag, typ, val = field.split(":", 2)
        aux += encode_aux(tag, typ, val)
    return encode_record(refid, int(pos) - 1, name, int(flag), int(mapq),
                         _parse_cigar(cig), mrefid, int(mpos) - 1,
                         int(tlen), seq if seq != "*" else "",
                         qual if qual != "*" else "*", aux)


SORT_MEM_RECORDS = 400_000   # per in-memory run (~100-200 MB of records)


def sam_to_bam(sam_path: str, bam_path: str | None = None,
               make_index: bool = True,
               mem_records: int = SORT_MEM_RECORDS) -> str:
    """The sam2bam.sh pipeline: SAM text -> coordinate-sorted BAM (+ .bai),
    as a constant-memory EXTERNAL MERGE SORT (the reference's samtools
    bam_sort.c does the same: sorted runs spilled to temp files, k-way
    merge).  The input file keeps its name (the reference names the SAM
    output <stem>.bam already: main.cpp:466-473), so we convert in place."""
    import heapq
    import pickle

    if bam_path is None:
        bam_path = sam_path
    header_lines: list[str] = []
    ref_names: list[str] = []
    ref_lens: list[int] = []
    ref_ids: dict[str, int] = {}
    runs: list[str] = []
    buf: list[tuple[int, int, int, bytes]] = []
    serial = 0

    def spill() -> None:
        buf.sort()
        path = f"{bam_path}.sort{len(runs)}.tmp"
        with open(path, "wb") as f:
            pickle.dump(len(buf), f)
            for item in buf:
                pickle.dump(item, f)
        runs.append(path)
        buf.clear()

    with open(sam_path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header_lines.append(line)
                if line.startswith("@SQ"):
                    d = dict(f.split(":", 1) for f in line.split("\t")[1:])
                    ref_ids[d["SN"]] = len(ref_names)
                    ref_names.append(d["SN"])
                    ref_lens.append(int(d["LN"]))
                continue
            if not line:
                continue
            cols = line.split("\t")
            rid = ref_ids.get(cols[2], -1)
            # samtools sort order: (refid, pos), unmapped (refid -1) last,
            # input order preserved among equals (stable)
            key_rid = rid if rid >= 0 else 1 << 30
            buf.append((key_rid, int(cols[3]) - 1, serial,
                        _sam_line_to_record(cols, ref_ids)))
            serial += 1
            if len(buf) >= mem_records:
                spill()

    def run_iter(path):
        with open(path, "rb") as f:
            n = pickle.load(f)
            for _ in range(n):
                yield pickle.load(f)

    tmp = bam_path + ".tmp"
    w = BgzfWriter(tmp)
    text = ("\n".join(header_lines) + "\n").encode()
    head = BAM_MAGIC + struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(ref_names))
    for n, ln in zip(ref_names, ref_lens):
        nb = n.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    w.write(head)
    if runs:
        if buf:
            spill()
        for item in heapq.merge(*(run_iter(r) for r in runs)):
            w.write(item[3])
    else:
        buf.sort()
        for item in buf:
            w.write(item[3])
    w.close()
    for r in runs:
        os.remove(r)
    os.replace(tmp, bam_path)
    if make_index:
        try:
            build_bai(bam_path)
        except Exception:
            pass
    return bam_path


# ---------------------------------------------------------------------------
# BAM reading
# ---------------------------------------------------------------------------

class BamFile:
    """Streaming BAM reader: constant memory, one BGZF block at a time."""

    def __init__(self, path: str):
        self._r = BgzfReader(path)
        if self._r.read(4) != BAM_MAGIC:
            raise ValueError("not a BAM file")
        l_text = struct.unpack("<i", self._r.read(4))[0]
        self.header_text = self._r.read(l_text).decode("latin1")
        n_ref = struct.unpack("<i", self._r.read(4))[0]
        self.ref_names = []
        self.ref_lens = []
        for _ in range(n_ref):
            ln = struct.unpack("<i", self._r.read(4))[0]
            self.ref_names.append(self._r.read(ln)[:-1].decode())
            self.ref_lens.append(struct.unpack("<i", self._r.read(4))[0])

    def records(self):
        while True:
            raw = self._r.read(4)
            if len(raw) < 4:
                break
            bs = struct.unpack("<i", raw)[0]
            yield self._r.read(bs)

    def records_with_voffsets(self):
        """(start_virtual, end_virtual, record_body) triples for BAI."""
        while True:
            start = self._r.tell_virtual()
            raw = self._r.read(4)
            if len(raw) < 4:
                break
            bs = struct.unpack("<i", raw)[0]
            body = self._r.read(bs)
            yield start, self._r.tell_virtual(), body

    def close(self) -> None:
        self._r.close()


def decode_record(body: bytes):
    (refid, pos, l_name, mapq, _bin, n_cig, flag, l_seq, mrefid, mpos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    name = body[off: off + l_name - 1].decode()
    off += l_name
    cigar = []
    for _ in range(n_cig):
        v = struct.unpack_from("<I", body, off)[0]
        cigar.append((v >> 4, v & 0xF))
        off += 4
    seq = []
    for i in range(l_seq):
        byte = body[off + i // 2]
        code = (byte >> 4) if i % 2 == 0 else (byte & 0xF)
        seq.append(SEQ_NT16[code])
    off += (l_seq + 1) // 2
    qual = body[off: off + l_seq]
    off += l_seq
    aux = body[off:]
    return (refid, pos, name, flag, mapq, cigar, mrefid, mpos, tlen,
            "".join(seq), qual, aux)


def decode_aux(aux: bytes) -> list[str]:
    out = []
    off = 0
    while off + 3 <= len(aux):
        tag = aux[off: off + 2].decode()
        typ = chr(aux[off + 2])
        off += 3
        if typ in "cC":
            val = struct.unpack_from("<b" if typ == "c" else "<B",
                                     aux, off)[0]
            off += 1
            out.append(f"{tag}:i:{val}")
        elif typ in "sS":
            val = struct.unpack_from("<h" if typ == "s" else "<H",
                                     aux, off)[0]
            off += 2
            out.append(f"{tag}:i:{val}")
        elif typ in "iI":
            val = struct.unpack_from("<i" if typ == "i" else "<I",
                                     aux, off)[0]
            off += 4
            out.append(f"{tag}:i:{val}")
        elif typ == "f":
            val = struct.unpack_from("<f", aux, off)[0]
            off += 4
            out.append(f"{tag}:f:{val}")
        elif typ == "A":
            out.append(f"{tag}:A:{chr(aux[off])}")
            off += 1
        elif typ == "Z":
            end = aux.index(0, off)
            out.append(f"{tag}:Z:{aux[off:end].decode()}")
            off = end + 1
        else:
            break
    return out


def bam_sam_lines(path: str):
    """Yield SAM text lines (no header) from a BAM file."""
    bf = BamFile(path)
    for body in bf.records():
        (refid, pos, name, flag, mapq, cigar, mrefid, mpos, tlen, seq,
         qual, aux) = decode_record(body)
        rname = bf.ref_names[refid] if refid >= 0 else "*"
        if mrefid < 0:
            mrname = "*"
        else:
            mrname = "=" if mrefid == refid else bf.ref_names[mrefid]
        cig = ("".join(f"{ln}{CIGAR_OPS[op]}" for ln, op in cigar)
               if cigar else "*")
        q = ("*" if (not qual or qual[0] == 0xFF)
             else "".join(chr(c + 33) for c in qual))
        fields = [name, str(flag), rname, str(pos + 1), str(mapq), cig,
                  mrname, str(mpos + 1), str(tlen), seq if seq else "*", q]
        fields.extend(decode_aux(aux))
        yield "\t".join(fields) + "\n"


def build_bai(bam_path: str) -> str:
    """Write a BAI index (SAM spec section 5.2) for a coordinate-sorted BAM,
    streaming: one reference's bins/intervals in memory at a time (the input
    is coordinate-sorted, so refids arrive in order)."""
    bf = BamFile(bam_path)
    n_ref = len(bf.ref_names)
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    cur_ref = -1
    bins: dict = {}
    intervals: list = []

    def emit_ref() -> None:
        out.extend(struct.pack("<i", len(bins)))
        for b, chunks in sorted(bins.items()):
            merged: list = []
            for c in chunks:
                if merged and merged[-1][1] == c[0]:
                    merged[-1] = (merged[-1][0], c[1])
                else:
                    merged.append(c)
            out.extend(struct.pack("<Ii", b, len(merged)))
            for s, e in merged:
                out.extend(struct.pack("<QQ", s, e))
        for w in range(1, len(intervals)):
            if intervals[w] == 0:
                intervals[w] = intervals[w - 1]
        out.extend(struct.pack("<i", len(intervals)))
        for v in intervals:
            out.extend(struct.pack("<Q", v))

    for start_v, end_v, body in bf.records_with_voffsets():
        refid, pos2 = struct.unpack_from("<ii", body, 0)
        if refid < 0 or pos2 < 0:
            continue
        while cur_ref < refid:
            if cur_ref >= 0:
                emit_ref()
            cur_ref += 1
            bins, intervals = {}, []
        n_cig = struct.unpack_from("<H", body, 12)[0]
        l_name = body[8]
        cig_off = 32 + l_name
        span = 0
        for k in range(n_cig):
            v = struct.unpack_from("<I", body, cig_off + 4 * k)[0]
            if CIGAR_OPS[v & 0xF] in "MDN=X":
                span += v >> 4
        end = pos2 + max(span, 1)
        bins.setdefault(reg2bin(pos2, end), []).append((start_v, end_v))
        for w in range(pos2 >> 14, (end - 1 >> 14) + 1):
            while len(intervals) <= w:
                intervals.append(0)
            if intervals[w] == 0 or start_v < intervals[w]:
                intervals[w] = start_v
    while cur_ref < n_ref:
        if cur_ref >= 0:
            emit_ref()
        cur_ref += 1
        bins, intervals = {}, []
    bf.close()
    with open(bam_path + ".bai", "wb") as fh:
        fh.write(bytes(out))
    return bam_path + ".bai"


# ---------------------------------------------------------------------------
# SAM/BAM read input (reads.cpp:119-143)
# ---------------------------------------------------------------------------

class BamReadStream:
    """Reads aligner input from SAM/BAM files with the reference's mate
    interleaving: readset 1 takes records 0,2,4..., readset 2 takes
    1,3,5...; the 0x40/0x80 flags override the readset (reads.cpp:131-135).
    """

    def __init__(self, path: str, param, readset: int):
        self.param = param
        self.readset = readset
        self.index = param.read_start - 1
        if path.lower().endswith(".bam") or _is_bgzf(path):
            self._iter = self._bam_iter(path)
        else:
            self._iter = self._sam_iter(path)
        skip = param.read_start - 1
        if readset != 0:
            skip *= 2
        for _ in range(skip):
            if next(self._iter, None) is None:
                break

    def _bam_iter(self, path):
        bf = BamFile(path)
        for body in bf.records():
            (refid, pos, name, flag, mapq, cigar, mrefid, mpos, tlen, seq,
             qual, aux) = decode_record(body)
            q = "".join(chr(min(c, 93) + 33) for c in qual)
            yield name, flag, seq, q

    def _sam_iter(self, path):
        for line in open(path):
            if line.startswith("@"):
                continue
            col = line.rstrip("\n").split("\t")
            yield col[0], int(col[1]), col[9], col[10]

    def _next_record(self):
        from .readio import Read
        p = self.param
        if self.index >= p.read_end:
            return None
        if self.readset == 2:
            if next(self._iter, None) is None:
                return None
        rec = next(self._iter, None)
        if rec is None:
            return None
        name, flag, seq, qual = rec
        if self.readset == 1:
            next(self._iter, None)   # skip the mate record
        rs = self.readset
        if rs:
            if flag & 0x40:
                rs = 1
            elif flag & 0x80:
                rs = 2
        seq = seq[: p.max_readlen]
        qual = qual[: p.max_readlen]
        r = Read(index=self.index, readset=rs, name=name, seq=seq,
                 qual=qual)
        self.index += 1
        return r

    def next_batch(self, n: int):
        out = []
        for _ in range(n):
            r = self._next_record()
            if r is None:
                break
            out.append(r)
        return out

    def close(self) -> None:
        pass


def _is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"
