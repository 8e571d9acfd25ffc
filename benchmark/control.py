"""The control of the check: the plain reference put in the program's place
with one of the configuration's guarantees broken, which ``compare.py``
has to judge not correct.

The guarantee broken is BSMAP's mismatch count: a read C over a reference
T is a mismatch.  The control counts mismatches in the three-letter
alphabet instead (C and T alike on both sides), the shortcut a faster
bisulfite aligner is tempted by, picks the best hit (pair-end: the best
pair, else each mate's best hit) under that count and prints the lines
BSMAP would print for it.

    python benchmark/control.py --workload wgbs_se100 --seeds 11,12,13

prints, for each seed, the control's ``bad_records`` over the sample a
run with that seed checks (the genome and reads as a run makes them;
nothing of the program runs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from compare import (best, expectations, judge_pass, pair_lines,  # noqa: E402
                     proper_pairs, sam_header, se_line, unpaired_line)


def control_lines(tg, o, qa, qb) -> dict[str, list[str]]:
    """The lines the control prints for each sampled read (its queries
    searched under the three-letter count)."""
    out = {}
    for k, q in enumerate(qa):
        if qb is None:
            lv, top = best(q)
            out[q.name] = ([se_line(q, top[0], len(top) > 1, tg.names)]
                           if q.kept and top else [])
            continue
        m = qb[k]
        if q.kept and m.kept:
            pairs = proper_pairs(q, m, o)
            if pairs:
                key = min((p[0], p[1]) for p in pairs)
                top = [p for p in pairs if (p[0], p[1]) == key]
                _, _, ha, hb, ins = top[0]
                out[q.name] = pair_lines(q, m, ha, hb, ins, len(top) > 1,
                                         tg.names).splitlines(True)
                continue
        lines = []
        tops = {}
        for mate, rs in ((q, 1), (m, 2)):
            if mate.kept:
                lv, top = best(mate)
                if top:
                    tops[rs] = (mate, top)
        for rs, (mate, top) in tops.items():
            other = tops.get(3 - rs)
            lines.append(unpaired_line(
                mate, rs, top[0], len(top) > 1,
                other[1][0] if other else None,
                other[0] if other else None, tg.names))
        out[q.name] = lines
    return out


def control_bad(cfg, traffic, cache_dir, reads, sample, device) -> int:
    """``bad_records`` of the control over one run's sample."""
    tg3, o, qa3, qb3 = expectations(cfg, traffic, cache_dir, reads, sample,
                                    device, rule="3l")
    lines = control_lines(tg3, o, qa3, qb3)
    del tg3
    tg, o, qa, qb = expectations(cfg, traffic, cache_dir, reads, sample,
                                 device)
    header = sam_header(tg.names, tg.lens)
    bad, _, why = judge_pass(tg, o, qa, qb, {"header": header,
                                             "lines": lines}, header)
    print(f"control: {bad} bad of {len(qa)}; reasons "
          f"{dict(list(why.items())[:6])}", file=sys.stderr)
    return bad


def main(argv=None) -> int:
    import subprocess
    import torch
    import harness
    from spec import load_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cfg, traffic = cell.config, cell.traffic
    layout = cfg["layout"]
    cache_dir = os.path.join(HERE, ".cache", harness.genome_key(cfg))
    subprocess.run([sys.executable, os.path.join(HERE, "genome.py"),
                    "--config", cell.config_file, "--out", cache_dir],
                   check=True, stdout=subprocess.DEVNULL)
    reads = harness.ensure_reads(cell, cache_dir)
    n = int(traffic["pass_size"][layout])
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        sample = harness.sample_indices(n, int(traffic["sample"][layout]),
                                        seed)
        bad = control_bad(cfg, traffic, cache_dir, reads, sample, device)
        rows.append({"workload": cell.name, "seed": seed,
                     "bad_records": bad})
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
