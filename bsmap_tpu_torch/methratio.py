"""Per-cytosine methylation-ratio caller (methratio.py equivalent, C23).

Streams SAM/BSP alignments and counts, per reference position, sequencing
depth and unconverted cytosines: '+'-strand hits contribute at ref-C
positions (read C = methylated, read T = converted), '-'-strand at ref-G
with read G/A (methratio.py:87,106-113).  Supports unique/paired filters,
PCR-duplicate removal via per-position strand bitmaps (methratio.py:52-56),
end-repair fill-in trimming (methratio.py:57-63), PE-overlap single counting
(SAM only, methratio.py:64), CpG strand-combining (methratio.py:117-127) and
Wilson 95% confidence intervals (methratio.py:132-150).

Output is byte-identical to the reference script on the same input,
including its Python slicing quirk for the 5nt context at chromosome starts
(ref[i-2:i+3] with a negative start).  No samtools dependency: SAM text is
parsed directly (the reference shells out to ``samtools view -X`` and match
es on flag letters; the equivalent bits are tested here).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def disp(txt: str, quiet: bool, nt: int = 0) -> None:
    if not quiet:
        print("".join(["\t"] * nt + ["@ ", time.asctime(), ": ", txt]),
              file=sys.stderr)


BS_CONVERSION = {"+": ("C", "T"), "-": ("G", "A")}


def scan_fasta_chroms(path: str):
    """One cheap pass: [(name, length)] in file order (drives chromosome
    batching; the reference documents running per--c subsets to bound its
    ~26 GB whole-genome RSS, README.txt:217-232)."""
    out = []
    cr, n = "", 0
    for line in open(path):
        if line.startswith(">"):
            if cr:
                out.append((cr, n))
            cr = line[1:-1].split()[0]
            n = 0
        else:
            n += len(line.strip())
    if cr:
        out.append((cr, n))
    return out


def load_ref(path: str, chroms):
    """Reference as BYTES per chromosome (half the footprint of the
    str+bytes pair: context slices and CpG scans work on bytes directly)."""
    ref = {}
    cr, seq = "", []
    for line in open(path):
        if line.startswith(">"):
            if cr and (not chroms or cr in chroms):
                ref[cr] = "".join(seq).upper().encode("latin1")
            cr = line[1:-1].split()[0]
            seq = []
        else:
            seq.append(line.strip())
    if cr and (not chroms or cr in chroms):
        ref[cr] = "".join(seq).upper().encode("latin1")
    return ref


class MethCounter:
    def __init__(self, ref: dict, rm_dup: bool):
        self.ref = ref
        self.meth = {cr: np.zeros(len(s), dtype=np.uint32)
                     for cr, s in ref.items()}
        self.depth = {cr: np.zeros(len(s), dtype=np.uint32)
                      for cr, s in ref.items()}
        self.coverage = ({cr: np.zeros(len(s), dtype=np.uint8)
                          for cr, s in ref.items()} if rm_dup else None)
        self.nmap = 0
        # zero-copy byte views for vectorized counting
        self._refbytes = {cr: np.frombuffer(s, dtype=np.uint8)
                          for cr, s in ref.items()}

    def add(self, seq: str, strand0: str, cr: str, pos: int) -> None:
        depthcr = self.depth[cr]
        if pos + len(seq) > len(depthcr):
            return
        self.nmap += 1
        match, convert = BS_CONVERSION[strand0]
        rb = self._refbytes[cr][pos: pos + len(seq)]
        sb = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
        at = rb == ord(match)
        if not at.any():
            return
        idx = np.flatnonzero(at)
        svals = sb[idx]
        is_meth = svals == ord(match)
        is_conv = svals == ord(convert)
        tgt = pos + idx
        np.add.at(depthcr, tgt[is_meth | is_conv], 1)
        np.add.at(self.meth[cr], tgt[is_meth], 1)


def sam_flag_letters(flag: int) -> str:
    """samtools view -X letter translation of the FLAG bits used by the
    reference's filters ('u' unmapped, 's' secondary, 'P' proper pair)."""
    s = ""
    if flag & 0x1:
        s += "p"
    if flag & 0x2:
        s += "P"
    if flag & 0x4:
        s += "u"
    if flag & 0x8:
        s += "U"
    if flag & 0x10:
        s += "r"
    if flag & 0x20:
        s += "R"
    if flag & 0x40:
        s += "1"
    if flag & 0x80:
        s += "2"
    if flag & 0x100:
        s += "s"
    if flag & 0x200:
        s += "f"
    if flag & 0x400:
        s += "d"
    return s


def get_alignment(line: str, sam_format: bool, opts, counter: MethCounter,
                  chroms: set):
    """methratio.py:31-65, exactly."""
    col = line.split("\t")
    if sam_format:
        flag = sam_flag_letters(int(col[1]))
        if "u" in flag:
            return None
        if opts.unique and "s" in flag:
            return None
        if opts.pair and "P" not in flag:
            return None
        cr, pos, seq, strand, insert = (col[2], int(col[3]) - 1, col[9], "",
                                        int(col[8]))
        if cr not in chroms:
            return None
        for aux in col[11:]:
            if aux[:5] == "ZS:Z:":
                strand = aux[5:7]
                break
        if strand == "":
            raise ValueError("missing ZS strand tag")
    else:
        flag = col[3][:2]
        if flag == "NM" or flag == "QC":
            return None
        if opts.unique and flag != "UM":
            return None
        if opts.pair and col[7] == "0":
            return None
        seq, strand, cr, pos, insert = (col[1], col[6], col[4],
                                        int(col[5]) - 1, int(col[7]))
        if cr not in chroms:
            return None
    if opts.rm_dup:
        if strand == "+-" or strand == "-+":
            frag_end, direction = pos + len(seq), 2
        else:
            frag_end, direction = pos, 1
        cov = counter.coverage[cr]
        if frag_end < len(cov):
            if cov[frag_end] & direction:
                return None
            cov[frag_end] |= direction
    if opts.trim_fillin > 0:
        t = opts.trim_fillin
        if strand == "+-":
            seq = seq[:-t]
        elif strand == "--":
            seq, pos = seq[t:], pos + t
        elif insert != 0 and len(seq) > abs(insert) - t:
            trim_nt = len(seq) - (abs(insert) - t)
            if strand == "++":
                seq = seq[:-trim_nt]
            elif strand == "-+":
                seq, pos = seq[trim_nt:], pos + trim_nt
    if sam_format and insert > 0:
        seq = seq[: int(col[7]) - 1 - pos]   # PE overlap counted once
    return (seq, strand[0], cr, pos)


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        usage="%(prog)s [options] BSMAP_MAPPING_FILES")
    ap.add_argument("-o", "--out", dest="outfile", default="")
    ap.add_argument("-d", "--ref", dest="reffile", default="")
    ap.add_argument("-c", "--chr", dest="chroms", default="")
    ap.add_argument("-s", "--sam-path", dest="sam_path", default="")
    ap.add_argument("-u", "--unique", action="store_true")
    ap.add_argument("-p", "--pair", action="store_true")
    ap.add_argument("-z", "--zero-meth", action="store_true", dest="meth0")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-r", "--remove-duplicate", action="store_true",
                    dest="rm_dup")
    ap.add_argument("-t", "--trim-fillin", dest="trim_fillin", type=int,
                    default=2)
    ap.add_argument("-g", "--combine-CpG", action="store_true",
                    dest="combine_cpg")
    ap.add_argument("-m", "--min-depth", dest="min_depth", type=int,
                    default=1)
    ap.add_argument("-N", "--batch-bases", dest="batch_bases", type=int,
                    default=800_000_000,
                    help="process chromosomes in groups of at most this "
                         "many bases to bound RSS (~10 B/base); 0 = one "
                         "pass over everything (reference behavior, "
                         "~26 GB for human: README.txt:217)")
    ap.add_argument("infiles", nargs="+")
    opts = ap.parse_args(argv)
    if not opts.reffile:
        ap.error("Missing reference file, use -d or --ref option.")
    if not opts.outfile:
        ap.error("Missing output file name, use -o or --out option.")
    chroms_opt = opts.chroms.split(",") if opts.chroms else []

    # chromosome batching: the per-base counters dominate RSS, so large
    # genomes are processed in sorted-order chromosome groups — the output
    # is per-chromosome-sorted, so concatenated group output is
    # byte-identical to a single whole-genome pass
    info = scan_fasta_chroms(opts.reffile)
    sizes = dict(info)
    sel = sorted(c for c, _ in info if not chroms_opt or c in chroms_opt)
    groups: list[list[str]] = []
    if opts.batch_bases <= 0:
        groups = [sel]
    else:
        cur: list[str] = []
        acc = 0
        for c in sel:
            if cur and acc + sizes[c] > opts.batch_bases:
                groups.append(cur)
                cur, acc = [], 0
            cur.append(c)
            acc += sizes[c]
        if cur:
            groups.append(cur)

    nmap = nc = nd = 0
    with open(opts.outfile, "w") as fout:
        fout.write("chr\tpos\tstrand\tcontext\tratio\ttotal_C\tmethy_C\t"
                   "CI_lower\tCI_upper\n")
        for gi, group in enumerate(groups):
            tag = (f" (chromosome group {gi + 1}/{len(groups)})"
                   if len(groups) > 1 else "")
            disp(f"reading reference {opts.reffile} ...{tag}", opts.quiet)
            ref = load_ref(opts.reffile, set(group))
            counter = MethCounter(ref, opts.rm_dup)
            gnc, gnd = _process_group(ref, counter, opts, fout)
            nmap += counter.nmap
            nc += gnc
            nd += gnd
            del ref, counter
    disp("done.", opts.quiet)
    print(f"total {nmap} valid mappings, {nc} covered cytosines, "
          f"average coverage: {(float(nd) / nc if nc else 0):.2f} fold.")
    return 0


def _process_group(ref: dict, counter: MethCounter, opts, fout):
    """Count one chromosome group from every input file, CpG-combine, and
    append its (sorted) ratio lines.  Returns (covered, depth_sum)."""
    chroms = set(ref.keys())
    for infile in opts.infiles:
        nline = 0
        disp(f"reading {infile} ...", opts.quiet)
        up = infile[-4:].upper()
        if up == ".SAM":
            sam_format, fin = True, _sam_lines(open(infile))
        elif up == ".BAM":
            from .bamio import bam_sam_lines
            sam_format, fin = True, bam_sam_lines(infile)
        else:
            sam_format, fin = False, open(infile)
        for line in fin:
            nline += 1
            if nline % 10000000 == 0:
                disp(f"read {nline} lines", opts.quiet, nt=1)
            info = get_alignment(line, sam_format, opts, counter, chroms)
            if info is None:
                continue
            seq, strand0, cr, pos = info
            counter.add(seq, strand0, cr, pos)

    meth, depth = counter.meth, counter.depth
    if opts.combine_cpg:
        disp("combining CpG methylation from both strands ...", opts.quiet)
        for cr in depth:
            refcr = ref[cr]
            dc, mc = depth[cr], meth[cr]
            p = refcr.find(b"CG")
            while p >= 0:
                dc[p] += dc[p + 1]
                mc[p] += mc[p + 1]
                dc[p + 1] = 0
                mc[p + 1] = 0
                p = refcr.find(b"CG", p + 2)

    disp(f"writing {opts.outfile} ...", opts.quiet)
    ss = {ord("C"): "+", ord("G"): "-"}
    z95, z95sq = 1.96, 1.96 * 1.96
    nc, nd = 0, 0
    for cr in sorted(depth.keys()):
        depthcr, methcr, refcr = depth[cr], meth[cr], ref[cr]
        pos_idx = np.flatnonzero(depthcr >= opts.min_depth)
        for i in pos_idx:
            i = int(i)
            d = int(depthcr[i])
            nc += 1
            nd += d
            m = int(methcr[i])
            if m == 0 and not opts.meth0:
                continue
            ratio = float(m) / d
            seq = refcr[i - 2: i + 3].decode("latin1")
            strand = ss[refcr[i]]
            pmid = ratio + z95sq / (2 * d)
            sd = z95 * ((ratio * (1 - ratio) / d
                         + z95sq / (4 * d * d)) ** 0.5)
            denom = 1 + z95sq / d
            cil, ciu = (pmid - sd) / denom, (pmid + sd) / denom
            fout.write(f"{cr}\t{i + 1}\t{strand}\t{seq}\t{ratio:.3f}\t"
                       f"{d}\t{m}\t{cil:.3f}\t{ciu:.3f}\n")
    return nc, nd


def _sam_lines(fh):
    for line in fh:
        if not line.startswith("@"):
            yield line


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
