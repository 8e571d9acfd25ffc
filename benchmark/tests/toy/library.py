#!/usr/bin/env python3
"""A configuration's own read library, for the harness's tests: ``reads.py``
with its command line and record layout, that also leaves
``toy_library.json`` (its arguments) beside the reads it writes."""

import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, BENCH)

import reads  # noqa: E402

if __name__ == "__main__":
    argv = sys.argv[1:]
    rc = reads.main(argv)
    out = argv[argv.index("--out") + 1]
    with open(os.path.join(out, "toy_library.json"), "w") as f:
        json.dump(argv, f)
    sys.exit(rc)
