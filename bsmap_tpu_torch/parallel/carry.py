"""Exact pair-end context bytes at the range starts of a multi-process run.

The reference's context string (XR under SAM ``-R``, the BSP context
column) is built in a buffer that lives as long as its aligner, one per
mate (``_mapseq``, align.h:132; ``PairFormatter.fa``/``.fb`` and
``PairDeviceEngine._mapseq``).  Its two leading slots keep what the last
context wrote there when a hit lies at chromosome position 0 or 1: slot 1
is written by a context at position 1 or later, slot 0 by one at position
2 or later.  A range of a ``-p``/``--nprocs`` run starts with fresh
buffers, and the last write of a slot may lie any number of pairs before
it (under SAM ``-R`` mate 2's buffer is written only by an unpaired mate-2
line), so no walk back is bounded.  The four slots are carried at the
merge instead:

  * each shard records, for every byte it prints from a slot that it has
    not written yet, the byte's offset in its own output file (the main
    file or the unpaired ``-2`` file) and the slot, and at its end the
    slots' values, ``None`` for a slot it never wrote
    (``ContextCarry.save``, a sidecar beside the shard);
  * the merge walks the shards in order with the four carried values,
    NUL at first as in a fresh buffer, patches each recorded byte with its
    slot's carried value, then takes the shard's final values where it
    wrote them (``merge_patches``).  A recorded byte is NUL in the shard,
    and the files keep their lengths.

The cost is one sidecar and one byte written a recorded print, however
far back the last write lies.  On the native block path the pair
formatter (``native/pe_format.cpp``) records the prints; on the per-pair
path ``TrackedFormatter`` marks each such byte in its context string with
a placeholder character that no decoded input holds and
``ContextCarry.write`` turns it into NUL and its byte offset.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from ..output.sam import SamFormatter

MAIN, UNPAIRED = 0, 1
# the carried slots: mate 1's slots 0 and 1, then mate 2's
SLOTS = 4
# per-pair path: the character that stands for a byte of slot s until the
# writer records it.  Every string of the output comes from bytes decoded
# as latin-1 (blockio), as strict UTF-8 (text-mode reads, BAM names,
# chromosome names) or with surrogateescape (U+DC80-U+DCFF); none of them
# yields a lone surrogate of U+D800-U+D803, so no input can collide
MARK = tuple(chr(0xD800 + s) for s in range(SLOTS))
_MARKS = re.compile("[\ud800-\ud803]")


def sidecar_path(out_file: str, k: int) -> str:
    return f"{out_file}.shard{k}.ctx"


class ContextCarry:
    """One shard's record of the bytes it printed from context-buffer
    slots it had not written yet (``patches``: (file, slot, offset)
    rows), and which slots it has written (``written``, shared with the
    native formatter, which sets it)."""

    def __init__(self) -> None:
        self.written = np.zeros(SLOTS, np.int32)
        self.patches: list[tuple[int, int, int]] = []
        self.pos = [0, 0]          # bytes put out to the main and -2 files
        self.pending = False       # per-pair path: a mark awaits the writer

    def active(self) -> bool:
        return not self.written.all()

    def add_block(self, recs: np.ndarray, n_main: int, n_unpair: int) -> None:
        """Native path: one formatted block's records (file, slot, offset
        in the block's bytes of that file), then the block's lengths."""
        for f, s, off in recs.tolist():
            self.patches.append((f, s, self.pos[f] + off))
        self.pos[MAIN] += n_main
        self.pos[UNPAIRED] += n_unpair

    def write(self, fout, main: str, fout_unpair, unpair: str) -> None:
        """Per-pair path: write one batch's text, ``main`` to the text
        file ``fout`` and ``unpair`` to ``fout_unpair`` (the -2 file; the
        same file and empty under SAM), each mark as NUL with its byte
        offset recorded."""
        if not self.pending:
            fout.write(main)
            fout_unpair.write(unpair)
            return
        self.pending = False
        for f, text, file in ((fout, main, MAIN),
                              (fout_unpair, unpair, UNPAIRED)):
            if not text:
                continue
            f.flush()
            at = f.buffer.tell()
            last = 0
            for m in _MARKS.finditer(text):
                seg = text[last:m.start()]
                at += (len(seg) if seg.isascii()
                       else len(seg.encode(f.encoding, f.errors)))
                self.patches.append((file, ord(m.group()) - 0xD800, at))
                at += 1
                last = m.end()
            f.write(_MARKS.sub("\0", text))

    def save(self, path: str, mapseq_a, mapseq_b) -> None:
        """The sidecar: the records and the final slot values, from the
        shard's last buffers (``None`` where a slot was never written),
        written whole through a temporary file."""
        vals = [int(mapseq_a[0]), int(mapseq_a[1]),
                int(mapseq_b[0]), int(mapseq_b[1])]
        final = [v if w else None for v, w in zip(vals, self.written)]
        with open(path + ".tmp", "w") as f:
            json.dump({"final": final, "patches": self.patches}, f)
        os.replace(path + ".tmp", path)


class TrackedFormatter(SamFormatter):
    """Per-pair path: one mate's formatter (``PairFormatter.fa``/``.fb``)
    that marks a context byte printed from a slot the shard has not
    written yet (``MARK``) for ``ContextCarry.write``."""

    def __init__(self, genome, param, rand_r, carry: ContextCarry,
                 mate: int):
        super().__init__(genome, param, rand_r)
        self.carry = carry
        self.mate = mate

    def _context(self, chr_packed, loc, read_len):
        text = super()._context(chr_packed, loc, read_len)
        c = self.carry
        for s in (0, 1):
            sid = 2 * self.mate + s
            if loc >= 2 - s:
                c.written[sid] = 1
            elif not c.written[sid]:
                text = text[:s] + MARK[sid] + text[s + 1:]
                c.pending = True
        return text


def track_pair_formatter(fmt, carry: ContextCarry) -> None:
    """Give ``fmt`` (a fresh PairFormatter) mates' formatters that record
    into ``carry``."""
    fmt.fa = TrackedFormatter(fmt.genome, fmt.param, fmt.rand_r, carry, 0)
    fmt.fb = TrackedFormatter(fmt.genome, fmt.param, fmt.rand_r, carry, 1)


def merge_patches(out_file: str, num_processes: int):
    """The merge's plan, once every shard is in (a shard writes its
    sidecar before its .done sentinel; ``distributed.wait_shards``): each
    shard's sidecar read in order with the four carried slot values (NUL
    at first).  Returns ([each shard's (offset, byte) patches of the main
    file], [the same of the -2 file]) and removes the sidecars."""
    carried = [0] * SLOTS
    plan: tuple[list, list] = ([], [])
    for k in range(num_processes):
        with open(sidecar_path(out_file, k)) as f:
            side = json.load(f)
        per = ([], [])
        for file, slot, off in side["patches"]:
            per[file].append((off, carried[slot]))
        for s, v in enumerate(side["final"]):
            if v is not None:
                carried[s] = v
        plan[MAIN].append(per[MAIN])
        plan[UNPAIRED].append(per[UNPAIRED])
    for k in range(num_processes):
        os.remove(sidecar_path(out_file, k))
    return plan
