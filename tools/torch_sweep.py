#!/usr/bin/env python3
"""Differential sweep of the PyTorch port against ``bsmap_tpu --engine host
-p 1`` on the CPU, over random option sets drawn from a seed.

    python tools/torch_sweep.py --dir DIR [--first 0] [--last 400] [--procs 4]

Data (made once in DIR/data): the N-rich, trimmed, mixed-length single-end
and pair-end reads and the RRBS set of ``tests/test_torch_differential.py``
(``tests/test_torch_qc_lines.rough_reads``).  Case i draws its option set
from ``random.Random(1000 + i)``: -S, -v, -s, -A, -q, -z, -u, -n 1, -r 0,
-L, -f, -w, -M GA, -m/-x, -B/-E, -I, -R, SAM or BSP (with -2 for pair-end
BSP), and the port's engine (auto, sharded, index-sharded, host, or three
``-p`` workers; no -S 0 under workers, whose ranges draw from fresh
streams).  Each case runs both CLIs as processes in DIR/c<i> and compares
every output file byte for byte; a case that matches is removed, one that
does not is kept.  One JSON line a case goes to DIR/sweep_<first>_<last>.jsonl
and a summary line to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import shutil
import subprocess
import sys
from multiprocessing import get_context

REPO = pathlib.Path(__file__).resolve().parent.parent
ADAPTER = "AGATCGGAAGAGC"
ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu", "BSMAP_TPU_DEV_BATCH": "2048",
       "BSMAP_TPU_CANDS_PER_READ": "16", "BSMAP_TPU_RANDR_SEED": "99",
       "BSMAP_TPU_CPU_JIT_CACHE": "1", "HOME": os.environ.get("HOME", "")}


def make_data(d: pathlib.Path) -> None:
    """The differential test's three read sets, once."""
    if (d / "done").exists():
        return
    sys.path.insert(0, str(REPO))
    from chip_smoke import make_rrbs_set
    from tests.conftest import simulate
    from tests.test_torch_qc_lines import rough_reads
    d.mkdir(parents=True, exist_ok=True)
    simulate(d, genome_out="ref.fa", reads_out="raw.fq", n_reads=500,
             read_len=90, chr_len=20000, n_chr=3, seed=41, error_rate=0.01)
    simulate(d, genome_out="refpe.fa", reads_out="raw1.fq",
             reads2_out="raw2.fq", pe=True, n_reads=300, read_len=76,
             chr_len=20000, n_chr=2, seed=42, error_rate=0.01, insert_min=50,
             insert_max=300, adapter=ADAPTER)
    rough_reads(d / "raw1.fq", d / "pe1.fq", seed=42)
    rough_reads(d / "raw2.fq", d / "pe2.fq", seed=43)
    make_rrbs_set(str(d), n_reads=400)
    rough_reads(d / "se.fq", d / "rr.fq", seed=44)     # make_rrbs_set's
    rough_reads(d / "raw.fq", d / "se.fq", seed=41)    # written over
    (d / "done").write_text("")


def draw(i: int):
    """Case i: (kind, argv without outputs and engine, outputs, engine)."""
    rng = random.Random(1000 + i)
    kind = rng.choice(["se", "se", "se", "pe", "pe", "rrbs"])
    a = {"se": ["-a", "se.fq", "-d", "ref.fa"],
         "pe": ["-a", "pe1.fq", "-b", "pe2.fq", "-d", "refpe.fa"],
         "rrbs": ["-a", "rr.fq", "-d", "rrbs.fa", "-D", "C-CGG"]}[kind]
    a += ["-S", str(rng.choice([1, 2, 17, 0])), "-v", str(rng.randint(0, 8)),
          "-s", str(rng.choice([12, 12, 14, 16] if kind != "rrbs"
                               else [10, 12]))]
    for p, flags in ((0.5, ["-A", ADAPTER]),
                     (0.5, ["-q", str(rng.choice([2, 20]))]),
                     (0.2, ["-z", "40"]), (0.7, ["-u"]), (0.2, ["-n", "1"]),
                     (0.2, ["-r", "0"]),
                     (0.15, ["-L", str(rng.randint(40, 80))]),
                     (0.2, ["-f", str(rng.randint(0, 8))]),
                     (0.15, ["-w", str(rng.choice([1, 2, 5, 50]))]),
                     (0.1, ["-M", "GA"]),
                     (0.15, ["-m", str(rng.randint(20, 60)), "-x",
                             str(rng.randint(100, 400))])):
        if rng.random() < p:
            a += flags
    if rng.random() < 0.15:
        b = rng.randint(1, 100)
        a += ["-B", str(b)]
        if rng.random() < 0.5:
            a += ["-E", str(b + rng.randint(50, 250))]
    if rng.random() < 0.1 and kind != "rrbs":
        a += ["-I", str(rng.choice([2, 3]))]
    bsp = rng.random() < 0.5
    if not bsp and rng.random() < 0.3:
        a += ["-R"]
    outs = [("-o", "bsp" if bsp else "sam")]
    if bsp and kind == "pe":
        outs.append(("-2", "up.bsp"))
    eng = rng.choice(["auto", "auto", "sharded", "index-sharded", "p3",
                      "host"])
    if (kind == "rrbs" and eng == "index-sharded") or (
            kind == "pe" and "-D" in a):
        eng = "auto"
    if eng == "p3" and a[a.index("-S") + 1] == "0":
        a[a.index("-S") + 1] = "1"
    return kind, a, outs, eng


def run_case(job):
    """Both CLIs on case i in DIR/c<i>; returns the case's record."""
    root, i = job
    kind, a, outs, eng = draw(i)
    wd = root / f"c{i}"
    wd.mkdir(exist_ok=True)
    for f in (root / "data").iterdir():
        if f.is_file() and not (wd / f.name).exists():
            os.symlink(f, wd / f.name)
    res = {"i": i, "kind": kind, "args": a, "eng": eng}
    for tag in ("host", "port"):
        o = [x for flag, suf in outs for x in (flag, f"{tag}.{suf}")]
        if tag == "host":
            cmd = ["-m", "bsmap_tpu.cli", "--engine", "host", "-p", "1"]
            env = dict(ENV, BSMAP_TPU_LOCAL_MP="0")
        else:
            cmd = ["-m", "bsmap_tpu_torch.cli", "--device", "cpu"] + (
                ["-p", "3"] if eng == "p3" else ["-p", "1"] + (
                    ["--engine", eng] if eng != "auto" else []))
            env = dict(ENV)
        r = subprocess.run([sys.executable] + cmd[:2] + a + o + cmd[2:],
                           cwd=wd, capture_output=True, env=env,
                           timeout=600)
        res[f"{tag}_rc"] = r.returncode
        if r.returncode:
            res[f"{tag}_err"] = r.stderr.decode()[-600:]
    diffs = []
    for _flag, suf in outs:
        h, p = wd / f"host.{suf}", wd / f"port.{suf}"
        if not (h.exists() and p.exists()):
            diffs.append({"file": suf, "missing": True})
            continue
        hl, pl = h.read_bytes().split(b"\n"), p.read_bytes().split(b"\n")
        k = next((k for k, (x, y) in enumerate(zip(hl, pl)) if x != y),
                 None if len(hl) == len(pl) else min(len(hl), len(pl)))
        if k is not None:
            diffs.append({"file": suf, "line": k})
    res["ok"] = not diffs and res["host_rc"] == res["port_rc"] == 0
    res["diffs"] = diffs
    if res["ok"]:
        shutil.rmtree(wd)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--last", type=int, default=400)
    ap.add_argument("--procs", type=int, default=4)
    args = ap.parse_args()
    root = pathlib.Path(args.dir).resolve()
    make_data(root / "data")
    n_ok = n = 0
    out = root / f"sweep_{args.first}_{args.last}.jsonl"
    jobs = [(root, i) for i in range(args.first, args.last)]
    with get_context("spawn").Pool(args.procs) as pool, open(out, "w") as f:
        for r in pool.imap_unordered(run_case, jobs):
            f.write(json.dumps(r) + "\n")
            f.flush()
            n, n_ok = n + 1, n_ok + r["ok"]
            if not r["ok"]:
                print(json.dumps(r)[:400], flush=True)
    print(f"{n_ok} of {n} option sets byte-identical to the host engine")
    return 0 if n_ok == n else 1


if __name__ == "__main__":
    sys.exit(main())
