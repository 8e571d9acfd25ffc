#!/usr/bin/env python3
"""The benchmark of ``bsmap_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload wgbs_se100 --seed 7 --seconds 10 \\
        --trace 0

Runs one cell of ``BENCHMARK.json`` (``harness.run_cell``): makes the
genome of the cell's configuration and the cell's reads once into
``benchmark/.cache/genome_<hash>/`` (``--seed`` draws the sample checked
and ``-S``); sets the port up from the cache (set-up is ``setup_s``);
then, with ``--trace 0``, runs back-to-back passes of the CLI's block
pipeline over the reads until the first pass that ends after
``--seconds``, into a named pipe in ``TMPDIR`` that a child process
drains, and prints the cell's end-to-end metrics; with
``--trace 1`` one pass under ``torch.profiler`` with the port's own spans
on (``bsmap_tpu_torch.obs``) and each layer timed alone, and the
per-layer metrics.  A cell runs on the first ``chips`` cards of its
entry; a configuration may bring its own genome features, read library
and check as files (``spec.py``).  Either way the sampled output of the
timed passes is checked against the plain reference (``compare.py``, or
the configuration's own ``check``) once
the port is freed.  The last line of stdout is the result's JSON; the
numbers compared, each with its limit, are the last lines of stderr.
Exits non-zero with no result when no card (or fewer than the cell asks
for) is visible, or when JAX or ``bsmap_tpu`` was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (HERE, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# the kernels' build directory stays in the checkout (the port's own
# bsmap_tpu_torch/_build); Triton's cache, should anything use it, too
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(HERE, ".cache", "triton"))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="benchmark of bsmap_tpu_torch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import forbidden_modules, run_cell
    from spec import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: torch sees no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
