"""BSP -> single-end SAM converter (bsp2sam.py, C24).

Pairing information is lost; flags are emitted as samtools -X letter strings
exactly like the reference script (bsp2sam.py:37-43)."""

from __future__ import annotations

import argparse
import sys
import time


def disp(txt: str, quiet: bool, nt: int = 0) -> None:
    if not quiet:
        print("".join(["\t"] * nt + ["@ ", time.asctime(), ": ", txt]),
              file=sys.stderr)


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        usage="%(prog)s [options] BSMAP_MAPPING_FILE")
    ap.add_argument("-o", "--out", dest="outfile", default="")
    ap.add_argument("-d", "--ref", dest="reffile", default="")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("infile")
    opts = ap.parse_args(argv)
    assert opts.reffile, "Missing reference file, must set -d/--ref."
    assert opts.outfile, "Missing output file, must set -o/--out."

    fout = open(opts.outfile, "w")
    disp(f"reading reference {opts.reffile} ...", opts.quiet)
    fout.write("@HD\tVN:1.0\n")
    cr, crlen = "", 0
    for line in open(opts.reffile):
        if line[0] == ">":
            if cr:
                fout.write(f"@SQ\tSN:{cr}\tLN:{crlen}\n")
            cr, crlen = line[1:].split()[0], 0
        else:
            crlen += len(line) - 1
    fout.write(f"@SQ\tSN:{cr}\tLN:{crlen}\n@PG\tID:BSMAP_2.43\n")

    n = 0
    for line in open(opts.infile):
        col = line[:-1].split("\t")
        name, read, qual, flag = col[:4]
        n += 1
        if n % 10000000 == 0:
            disp(f"read {n} lines", opts.quiet, nt=1)
        if flag == "NM":
            fout.write(f"{name}\tu\t*\t0\t0\t*\t*\t0\t0\t{read}\t{qual}\n")
        elif flag == "QC":
            fout.write(f"{name}\tuf\t*\t0\t0\t*\t*\t0\t0\t{read}\t{qual}\n")
        else:
            cr, pos, strand, mm = col[4], col[5], col[6], col[9]
            samflag = ""
            if strand == "+-" or strand == "-+":
                samflag += "r"
            if flag == "MA" or flag == "OF":
                samflag += "s"
            fout.write(f"{name}\t{samflag}\t{cr}\t{pos}\t255\t"
                       f"{len(read)}M\t*\t0\t0\t{read}\t{qual}\t"
                       f"NM:i:{mm}\tZS:Z:{strand}\n")
    fout.close()
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
