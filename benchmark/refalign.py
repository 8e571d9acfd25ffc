"""Plain reference of BSMAP's single-end and pair-end semantics, in NumPy and
PyTorch, for the reads a run samples.  It imports nothing of the program
under test (nor JAX): it reads the genome's codes from the benchmark's own
``genome.npy`` and the reads from the generated FASTQ files.

What it computes for a read (``Query``): the read after BSMAP's
FilterReads (3' adapter, then quality trim, then the length and N
filters) and its mismatch budget ``(v + 1) * (len - 1) // raw_len``;
then *every* place where the read aligns within that budget, found
exhaustively: the read is cut into budget + 1 disjoint N-free windows,
every window is looked up in the three-letter (C = T) sequence of both
strands of the whole genome, and each candidate is verified base by base
under BSMAP's asymmetric count (a read T matches a reference C; a read N
matches anything).  By the pigeonhole rule no alignment within the budget
can escape.  For each hit it also counts the seed segments of BSMAP's
schedule that the hit breaks (``broken``): the segments whose seed windows,
over every start offset the schedule may take, hold a three-letter
mismatch or an N.  ``compare.py`` uses that to tell where BSMAP's seeding
must find the hit.

Codes are A=0, C=1, G=2, T=3, N=4 (and 5 pads a short read).
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_CODE, PAD = 4, 5
CODE = np.full(256, N_CODE, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
    CODE[_c + 32] = _i
# three-letter digit of a code: A 0, G 1, C and T 2; N and the pad 3
DIGIT = np.array([0, 2, 1, 2, 3, 3], dtype=np.uint8)
COMP_CHR = bytes(range(256)).translate(bytes.maketrans(b"ACGTacgt",
                                                      b"TGCAtgca"))
COMP_TABLE = str.maketrans({chr(i): ("N" if chr(i) not in "ACGTacgt"
                                     else chr(COMP_CHR[i]))
                            for i in range(256)})
SEG_CAP = 1000          # BSMAP's -w default (MAXHITS): equal hits a level
GAP = 256               # N codes between chromosomes in the targets
KS = (16, 14, 12, 10, 8)


def revcomp(seq: str) -> str:
    """Reverse complement; any letter but ACGT becomes N."""
    return seq.translate(COMP_TABLE)[::-1]


@dataclasses.dataclass
class Options:
    """BSMAP options the reference needs."""

    max_snp: int = 2          # -v
    seed_size: int = 16       # -s
    interval: int = 4         # -I
    min_insert: int = 28      # -m
    max_insert: int = 500     # -x
    adapters: tuple = ()      # -A
    qual_threshold: int = 0   # -q
    zero_qual: int = 33       # -z
    max_ns: int = 5           # -f
    repeat: int = 1           # -r

    @classmethod
    def from_argv(cls, argv: list[str]) -> "Options":
        o = cls()
        adapters = []
        it = iter(argv)
        for a in it:
            if a == "-v":
                o.max_snp = int(next(it))
            elif a == "-s":
                o.seed_size = int(next(it))
            elif a == "-I":
                o.interval = int(next(it))
            elif a == "-m":
                o.min_insert = int(next(it))
            elif a == "-x":
                o.max_insert = int(next(it))
            elif a == "-A":
                adapters.append(next(it))
            elif a == "-q":
                o.qual_threshold = int(next(it))
            elif a == "-z":
                o.zero_qual = int(next(it))
            elif a == "-f":
                o.max_ns = int(next(it))
            elif a == "-r":
                o.repeat = int(next(it))
            elif a in ("-p", "-S", "-n"):
                next(it)
        o.adapters = tuple(adapters)
        return o


# -- FilterReads --------------------------------------------------------------

def filter_read(seq: str, qual: str, o: Options):
    """(kept, seq, qual, budget, raw_len): BSMAP's FilterReads."""
    raw = len(seq)
    done = False
    for ad in o.adapters:
        if done:
            break
        for pos in range(o.seed_size, len(seq) - 4):
            mm, k = 0, 0
            limit = min(len(ad), 15, len(seq) - pos)
            while k < limit:
                if ad[k] != seq[pos + k]:
                    mm += 1
                    if mm > 4:
                        break
                k += 1
            if k >= mm * 5 and k > 3:
                seq, qual = seq[:pos], qual[:pos]
                done = True
                break
    if o.qual_threshold and len(qual) != 1:
        cut = o.zero_qual + o.qual_threshold
        keep = 0
        for i in range(len(qual), 0, -1):
            if ord(qual[i - 1]) > cut:
                keep = i
                break
        if keep < o.seed_size:
            return False, seq, qual, 0, raw
        seq, qual = seq[:keep], qual[:keep]
    if len(seq) < o.seed_size:
        return False, seq, qual, 0, raw
    if sum(c not in "ACGTacgt" for c in seq) > o.max_ns:
        return False, seq, qual, 0, raw
    return True, seq, qual, (o.max_snp + 1) * (len(seq) - 1) // raw, raw


# -- BSMAP's seed segments ----------------------------------------------------

def segments(L: int, budget: int, o: Options) -> list[tuple[int, int]]:
    """[lo, hi) read span of each seed segment BSMAP may probe for a read
    of length L: every seed offset over every interval phase and every
    start offset its schedule can choose (0 .. max_offset, or any stale
    0 .. S - 1 where max_offset is 0)."""
    S, I = o.seed_size, o.interval
    nseg = min((L - I + 1) // S, budget + 1)
    max_off = (L - I + 1) % S
    smax = max_off if max_off > 0 else S - 1
    out = []
    for j in range(nseg):
        offs = [((j * S + i + I - 1) // I) * I + st - i
                for i in range(I) for st in range(smax + 1)]
        out.append((min(offs), max(offs) + S))
    return out


def broken_segments(bad: np.ndarray, L: int, segs) -> int:
    """Segments holding a seed-breaking base (or reaching past the read)."""
    return sum(1 for lo, hi in segs if hi > L or bad[lo:hi].any())


# -- the genome ---------------------------------------------------------------

class Targets:
    """Both strands of the genome end to end on ``device``: ``w`` the
    Watson codes, ``c`` each chromosome's reverse complement in the same
    span, N gaps between chromosomes and after the last."""

    def __init__(self, chrs: list[tuple[str, np.ndarray]], device: str):
        import torch
        self.names = [n for n, _ in chrs]
        self.lens = np.array([len(s) for _, s in chrs], dtype=np.int64)
        self.starts = np.zeros(len(chrs), dtype=np.int64)
        at = 0
        for k, n in enumerate(self.lens):
            self.starts[k] = at
            at += int(n) + GAP
        self.size = at
        w = np.full(at, N_CODE, dtype=np.uint8)
        c = np.full(at, N_CODE, dtype=np.uint8)
        for k, (_, s) in enumerate(chrs):
            a = int(self.starts[k])
            w[a: a + len(s)] = s
            c[a: a + len(s)] = (3 - np.asarray(s))[::-1]
        self.device = device
        self.t = [torch.from_numpy(w).to(device),
                  torch.from_numpy(c).to(device)]
        self.digit = torch.from_numpy(DIGIT).to(device)


@dataclasses.dataclass
class Hit:
    chr: int
    parity: int      # 0 Watson reference, 1 Crick
    wloc: int        # 0-based Watson position of the leftmost base
    w: int           # mismatches
    broken: int      # BSMAP seed segments the hit breaks


@dataclasses.dataclass
class Query:
    """One read (or mate) as BSMAP aligns it."""

    name: str
    chain: int                   # 0 the read, 1 its reverse complement
    kept: bool = False
    seq: str = ""
    qual: str = ""
    budget: int = 0
    nseg: int = 0
    hits: list = dataclasses.field(default_factory=list)
    searched: bool = False       # False: too many Ns to cut windows

    @property
    def codes(self) -> np.ndarray:
        q = self.seq if self.chain == 0 else revcomp(self.seq)
        return CODE[np.frombuffer(q.encode("latin1"), dtype=np.uint8)]


def _windows(codes: np.ndarray, need: int):
    """(k, offsets) of ``need`` disjoint N-free windows, k as large as
    ``KS`` allows; None where no k gives that many."""
    for k in KS:
        offs, i = [], 0
        while i + k <= len(codes) and len(offs) < need:
            n_at = np.flatnonzero(codes[i: i + k] == N_CODE)
            if len(n_at):
                i += int(n_at[-1]) + 1
            else:
                offs.append(i)
                i += k
        if len(offs) >= need:
            return k, offs
    return None


def _keys(dig: np.ndarray) -> int:
    v = 0
    for d in dig:
        v = v * 3 + int(d)
    return v


def mismatches(q, t, rule: str = "bs"):
    """Per-base mismatch mask of query codes ``q`` against reference codes
    ``t`` (same shape, torch): BSMAP's count (``bs``: a read T matches a
    reference C, a read N or pad matches anything) or, for the control,
    the three-letter count (``3l``: C and T equal on both sides)."""
    real = q < N_CODE
    if rule == "bs":
        return real & (q != t) & ~((q == 3) & (t == 1))
    qq = q.clone()
    tt = t.clone()
    qq[qq == 1] = 3
    tt[tt == 1] = 3
    return real & (qq != tt)


def search(tg: Targets, queries: list[Query], o: Options,
           rule: str = "bs", chunk: int = 1 << 25) -> None:
    """Fill ``hits`` of every kept query: all places within its budget."""
    import torch
    dev = tg.device
    by_k: dict[int, list] = {}
    for qi, q in enumerate(queries):
        if not q.kept:
            continue
        codes = q.codes
        win = _windows(codes, q.budget + 1)
        if win is None:
            continue
        q.searched = True
        k, offs = win
        dig = DIGIT[codes]
        for off in offs:
            by_k.setdefault(k, []).append((_keys(dig[off: off + k]), qi,
                                           off))
    cands = []
    for k, seeds in by_k.items():
        seeds.sort()
        skeys = torch.tensor([s[0] for s in seeds], dtype=torch.int64,
                             device=dev)
        uniq, counts = torch.unique_consecutive(skeys, return_counts=True)
        first = torch.cumsum(counts, 0) - counts
        sq = torch.tensor([s[1] for s in seeds], dtype=torch.int64,
                          device=dev)
        so = torch.tensor([s[2] for s in seeds], dtype=torch.int64,
                          device=dev)
        for strand in (0, 1):
            t = tg.t[strand]
            d = tg.digit[t.long()]
            for s in range(0, tg.size - k + 1, chunk):
                e = min(s + chunk, tg.size - k + 1)
                key = torch.zeros(e - s, dtype=torch.int64, device=dev)
                bad = torch.zeros(e - s, dtype=torch.bool, device=dev)
                for j in range(k):
                    x = d[s + j: e + j]
                    key = key * 3 + x.clamp(max=2).long()
                    bad |= x == 3
                pos = torch.searchsorted(uniq, key)
                pos = pos.clamp(max=len(uniq) - 1)
                m = (uniq[pos] == key) & ~bad
                at = torch.nonzero(m).flatten()
                if len(at) == 0:
                    continue
                u = pos[at]
                cnt = counts[u]
                rep = torch.repeat_interleave(at, cnt)
                base = torch.repeat_interleave(first[u], cnt)
                step = torch.arange(len(rep), device=dev) - \
                    torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
                ent = base + step
                start = rep + s - so[ent]
                cands.append(torch.stack(
                    [sq[ent], torch.full_like(start, strand), start]))
    if not cands:
        return
    allc = torch.unique(torch.cat(cands, 1), dim=1)
    _verify(tg, queries, allc, o, rule)


def _verify(tg: Targets, queries, cands, o: Options, rule: str) -> None:
    import torch
    dev = tg.device
    Lmax = max(len(q.seq) for q in queries if q.kept)
    qmat = np.full((len(queries), Lmax), PAD, dtype=np.uint8)
    lens = np.zeros(len(queries), dtype=np.int64)
    budgets = np.zeros(len(queries), dtype=np.int64)
    for i, q in enumerate(queries):
        if q.kept:
            c = q.codes
            qmat[i, : len(c)] = c
            lens[i] = len(c)
            budgets[i] = q.budget
    qm = torch.from_numpy(qmat).to(dev)
    qlen = torch.from_numpy(lens).to(dev)
    qbud = torch.from_numpy(budgets).to(dev)
    starts = torch.from_numpy(tg.starts).to(dev)
    clens = torch.from_numpy(tg.lens).to(dev)
    ar = torch.arange(Lmax, device=dev)
    keep = []
    for s in range(0, cands.shape[1], 1 << 20):
        qi, strand, g = cands[:, s: s + (1 << 20)]
        ok = (g >= 0) & (g + qlen[qi] <= tg.size)
        qi, strand, g = qi[ok], strand[ok], g[ok]
        c = torch.searchsorted(starts, g, right=True) - 1
        ok = (c >= 0) & (g + qlen[qi] <= starts[c.clamp(min=0)]
                         + clens[c.clamp(min=0)])
        qi, strand, g, c = qi[ok], strand[ok], g[ok], c[ok]
        idx = (g[:, None] + ar[None, :]).clamp(max=tg.size - 1)
        t = torch.where(strand[:, None] == 0, tg.t[0][idx], tg.t[1][idx])
        q = qm[qi]
        w = mismatches(q, t, rule).sum(1)
        sel = w <= qbud[qi]
        if sel.any():
            qs, ts = q[sel], t[sel]
            brk = (q[sel] < N_CODE) & (tg.digit[qs.long()]
                                      != tg.digit[ts.long()])
            brk |= qs == N_CODE
            keep.append((qi[sel].cpu().numpy(), strand[sel].cpu().numpy(),
                         g[sel].cpu().numpy(), c[sel].cpu().numpy(),
                         w[sel].cpu().numpy(), brk.cpu().numpy()))
    segs_cache: dict = {}
    for qi, strand, g, c, w, brk in keep:
        for k in range(len(qi)):
            q = queries[int(qi[k])]
            L = len(q.seq)
            key = (L, q.budget)
            if key not in segs_cache:
                segs_cache[key] = segments(L, q.budget, o)
            local = int(g[k]) - int(tg.starts[c[k]])
            wloc = local if strand[k] == 0 else int(tg.lens[c[k]]) - L - local
            q.hits.append(Hit(int(c[k]), int(strand[k]), wloc, int(w[k]),
                              broken_segments(brk[k], L, segs_cache[key])))


def prepare(records, o: Options, chain: int) -> list[Query]:
    """Queries of (name, seq, qual) records, filtered."""
    out = []
    for name, seq, qual in records:
        q = Query(name, chain)
        q.kept, q.seq, q.qual, q.budget, _ = filter_read(seq, qual, o)
        if q.kept:
            q.nseg = len(segments(len(q.seq), q.budget, o))
        out.append(q)
    return out


def count_at(tg: Targets, q: Query, parity: int, wloc: int, chr_: int,
             rule: str = "bs") -> int | None:
    """Mismatches of ``q`` at one place (None when it lies off the
    chromosome)."""
    import torch
    L = len(q.seq)
    if wloc < 0 or wloc + L > int(tg.lens[chr_]):
        return None
    a = int(tg.starts[chr_])
    g = a + wloc if parity == 0 else a + int(tg.lens[chr_]) - L - wloc
    t = tg.t[parity][g: g + L]
    qc = torch.from_numpy(q.codes).to(tg.device)
    return int(mismatches(qc, t, rule).sum())
