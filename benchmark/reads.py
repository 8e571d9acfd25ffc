"""The read set of one cell: a frozen, extended copy of the bench generator
(tools/genreads.py) and of the pair-end trimming mix
(chip_smoke.make_trim_pe_set), driven by a configuration and a traffic
mix.

The mix's ``library_seed`` draws the library: its ``pass_size``
fragments, uniform over the genome (chromosomes by length), their length
uniform in the mix's ``insert`` range, half from each strand.  The
fragment's own strand is bisulfite converted (``library`` in the
configuration: CpG C kept at ``cpg_methylated``, every other C converted
at ``conversion``); read 1 is the converted strand's first ``read_len``
bases, mate 2 (pair-end) the reverse complement's, running into the
mix's adapters (read 1's, read 2's) past the fragment's end; then
substitutions at a rate rising linearly along the read (``error_rate``)
and N at ``n_rate``; qualities the mix's ``qual``, each ``tails`` entry
ending that share of the reads in its ``qual`` after base ``after``.
Every draw after the library's is a hash of the fragment and the base, so
a fragment's reads are the same whatever their order, and overlapping
mates agree.

Record i of the file is fragment i, whatever the run's ``--seed``: the
order of the fragments changes the work of the host route (which pairs
meet in a block), so every run has the same file, and the seed draws only
the sample checked and ``-S``.  Records are ``@r%09d`` (single-end) or
``@p%09d`` (both mates), numbered by their place in the file; every
record of a file has one length, and record i starts at byte i * record
length.

    python benchmark/reads.py --config C --traffic T --cache DIR --out DIR

writes ``DIR/r1.fq`` (and ``DIR/r2.fq``); one configuration and mix give
the same bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from genome import ASCII, CODE

CHUNK = 100_000
NAME_DIGITS = 9


def record_len(read_len: int) -> int:
    return 1 + 1 + NAME_DIGITS + 1 + read_len + 3 + read_len + 1


def _hash_u01(key: np.ndarray) -> np.ndarray:
    """Uniform [0, 1) from uint32 keys (murmur3's 32-bit finaliser)."""
    z = key.astype(np.uint32)
    with np.errstate(over="ignore"):
        z ^= z >> np.uint32(16)
        z *= np.uint32(0x85EBCA6B)
        z ^= z >> np.uint32(13)
        z *= np.uint32(0xC2B2AE35)
        z ^= z >> np.uint32(16)
    return z.astype(np.float32) * np.float32(2.0 ** -32)


def _names(prefix: bytes, first: int, n: int) -> np.ndarray:
    """(n, 1 + NAME_DIGITS) uint8: prefix letter and zero-padded index."""
    idx = np.arange(first, first + n, dtype=np.int64)
    out = np.empty((n, 1 + NAME_DIGITS), dtype=np.uint8)
    out[:, 0] = prefix[0]
    for d in range(NAME_DIGITS):
        out[:, NAME_DIGITS - d] = ord("0") + (idx // 10 ** d) % 10
    return out


def fastq_block(prefix: bytes, first: int, seqs: np.ndarray,
                quals: np.ndarray) -> bytes:
    """FASTQ records of codes ``seqs`` (ASCII already) and ``quals``."""
    n, L = seqs.shape
    rec = np.empty((n, record_len(L)), dtype=np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1: 2 + NAME_DIGITS] = _names(prefix, first, n)
    c = 2 + NAME_DIGITS
    rec[:, c] = ord("\n")
    rec[:, c + 1: c + 1 + L] = seqs
    c += 1 + L
    rec[:, c: c + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, c + 3: c + 3 + L] = quals
    rec[:, -1] = ord("\n")
    return rec.tobytes()


class Fragments:
    """The library of a configuration and mix, and its reads."""

    def __init__(self, cfg: dict, traffic: dict, cat: np.ndarray):
        self.cfg, self.traffic = cfg, traffic
        self.L = int(cfg["read_len"])
        self.lens = np.array([n for _, n in cfg["genome"]["chromosomes"]],
                             dtype=np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lens)[:-1]])
        self.cat = cat
        self.lib = cfg["library"]
        self.adapters = [np.frombuffer(a.encode(), dtype=np.uint8)
                         for a in traffic["adapters"]]

    def library(self, n: int):
        """(global start, insert, Crick?) of the library's ``n``
        fragments."""
        rng = np.random.default_rng([int(self.traffic["library_seed"]),
                                     n])
        lo, hi = self.traffic["insert"]
        ins = rng.integers(int(lo), int(hi) + 1, size=n)
        c = rng.choice(len(self.lens), size=n, p=self.lens / self.lens.sum())
        pos = (rng.random(n) * (self.lens[c] - ins + 1)).astype(np.int64)
        crick = rng.random(n) < 0.5
        return self.starts[c] + pos, ins, crick

    def strand_bases(self, fid, g0, ins, crick, k: np.ndarray):
        """Converted bases at fragment offsets ``k`` (n, m) of each
        fragment's own strand (read 1 reads k = 0, 1, ...)."""
        gpos = np.where(crick[:, None], g0[:, None] + ins[:, None] - 1 - k,
                        g0[:, None] + k)
        base = self.cat[gpos]
        base[crick] = 3 - base[crick]
        r, c = np.nonzero(base == 1)
        u = _draw(fid[r], k[r, c], 0)
        # a CpG on the read's strand: Watson C before G, or (Crick) the
        # Watson G after C
        gp = gpos[r, c]
        nxt = np.where(crick[r], np.maximum(gp - 1, 0),
                       np.minimum(gp + 1, len(self.cat) - 1))
        cpg = self.cat[nxt] == np.where(crick[r], 1, 2)
        keep = np.where(cpg, u < float(self.lib["cpg_methylated"]),
                        u >= float(self.lib["conversion"]))
        base[r[~keep], c[~keep]] = 3
        return base

    def reads(self, fid: np.ndarray, g0, ins, crick):
        """(mate 1 ASCII, mate 2 ASCII or None, quals 1, quals 2 or None)
        of fragments ``fid`` (with their starts, inserts and strands)."""
        L, n = self.L, len(fid)
        k = np.broadcast_to(np.arange(L), (n, L))
        inside = k < ins[:, None]
        kk = np.minimum(k, ins[:, None] - 1)
        mates = [self.strand_bases(fid, g0, ins, crick, kk)]
        if self.cfg["layout"] == "pe":
            # mate 2: the reverse complement of the converted strand
            mates.append(3 - self.strand_bases(fid, g0, ins, crick,
                                               ins[:, None] - 1 - kk))
        out, quals = [None, None], [None, None]
        for m, (mate, ad) in enumerate(zip(mates, self.adapters)):
            seq = ASCII[mate]
            past = np.maximum(k - ins[:, None], 0)
            seq = np.where(inside, seq, ad[np.minimum(past, len(ad) - 1)])
            out[m] = self._errors(fid, seq, 1 + 8 * m)
            quals[m] = self._quals(fid, 4 + 8 * m)
        return out[0], out[1], quals[0], quals[1]

    def _errors(self, fid, seq: np.ndarray, salt: int) -> np.ndarray:
        n, L = seq.shape
        lo, hi = self.lib["error_rate"]
        rate = (lo + (hi - lo) * np.arange(L) / max(L - 1, 1)).astype(
            np.float32)
        k = np.broadcast_to(np.arange(L), (n, L))
        r, c = np.nonzero(_draw(fid[:, None], k, salt) < rate)
        codes = CODE[seq[r, c]] % 4
        step = 1 + (_draw(fid[r], c, salt + 1) * 3).astype(np.uint8)
        seq[r, c] = ASCII[(codes + step) % 4]
        r, c = np.nonzero(_draw(fid[:, None], k, salt + 2)
                          < float(self.lib["n_rate"]))
        seq[r, c] = ord("N")
        return seq

    def _quals(self, fid, salt: int) -> np.ndarray:
        L = self.L
        q = np.full((len(fid), L), ord(self.traffic["qual"]), dtype=np.uint8)
        for t, tail in enumerate(self.traffic["tails"]):
            rows = _draw(fid, np.zeros_like(fid), salt + t) < \
                float(tail["share"])
            q[np.ix_(rows, np.arange(int(tail["after"]), L))] = \
                ord(tail["qual"])
        return q


def _draw(fid, k, salt: int) -> np.ndarray:
    """Uniform [0, 1) of (fragment, base offset, salt), broadcast."""
    key = (np.asarray(fid, dtype=np.uint64) * np.uint64(1024)
           + np.asarray(k, dtype=np.uint64))
    return _hash_u01((key ^ np.uint64((salt * 0x9E3779B9) & 0xFFFFFFFF))
                     .astype(np.uint32) ^ np.uint32(salt * 0x85EBCA6B
                                                    & 0xFFFFFFFF))


_WORKER: dict = {}


def _chunk(args) -> int:
    """Pool worker: write records first .. first + m - 1 (fragments
    ``fid``) at their byte offset (records have one length)."""
    cfg, traffic, npy, paths, first, fid, g0, ins, crick = args
    key = (npy, json.dumps([cfg, traffic], sort_keys=True))
    if _WORKER.get("key") != key:
        _WORKER["key"] = key
        _WORKER["frag"] = Fragments(cfg, traffic,
                                    np.load(npy, mmap_mode="r"))
    frag = _WORKER["frag"]
    s1, s2, q1, q2 = frag.reads(fid, g0, ins, crick)
    prefix = b"r" if cfg["layout"] == "se" else b"p"
    off = first * record_len(frag.L)
    for path, s, q in zip(paths, (s1, s2), (q1, q2)):
        fd = os.open(path, os.O_WRONLY)
        try:
            os.pwrite(fd, fastq_block(prefix, first, s, q), off)
        finally:
            os.close(fd)
    return len(fid)


def write_reads(cfg: dict, traffic: dict, cache_dir: str, out_dir: str,
                n: int | None = None, procs: int | None = None) -> list[str]:
    """The pass file(s) of a cell: ``r1.fq`` (and ``r2.fq``) in
    ``out_dir``, the library of ``n`` reads or pairs (default: the mix's
    pass size), made in chunks by ``procs`` worker processes (default:
    one a core)."""
    import multiprocessing
    layout = cfg["layout"]
    n = int(traffic["pass_size"][layout]) if n is None else n
    paths = [os.path.join(out_dir, "r1.fq")]
    if layout == "pe":
        paths.append(os.path.join(out_dir, "r2.fq"))
    for p in paths:
        with open(p, "wb") as f:
            f.truncate(n * record_len(int(cfg["read_len"])))
    npy = os.path.join(cache_dir, "genome.npy")
    g0, ins, crick = Fragments(cfg, traffic, None).library(n)
    jobs = []
    for first in range(0, n, CHUNK):
        f = np.arange(first, min(n, first + CHUNK))
        jobs.append((cfg, traffic, npy, paths, first, f, g0[f], ins[f],
                     crick[f]))
    procs = procs or min(len(jobs), os.cpu_count() or 1)
    if procs <= 1:
        done = sum(map(_chunk, jobs))
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(procs) as pool:
            done = sum(pool.imap_unordered(_chunk, jobs))
    if done != n:
        raise RuntimeError(f"made {done} of {n} reads")
    return paths


def read_records(path: str, read_len: int, idx) -> list[tuple[str, str, str]]:
    """(name, seq, qual) of records ``idx`` of a file ``write_reads`` made."""
    size = record_len(read_len)
    out = []
    with open(path, "rb") as f:
        for i in idx:
            f.seek(int(i) * size)
            rec = f.read(size).decode("latin1").split("\n")
            out.append((rec[0][1:], rec[1], rec[3]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--cache", required=True,
                    help="the configuration's cache directory (genome.npy)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    with open(args.traffic) as f:
        traffic = json.load(f)
    for p in write_reads(cfg, traffic, args.cache, args.out, args.n):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
