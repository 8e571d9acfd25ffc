"""Fixtures of the benchmark's CPU tests: a cell of ``BENCHMARK.json`` cut
to a tiny genome, few reads and seed size 12, so the port runs it with
its kernels' plain twins in seconds."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
for _p in (BENCH, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# the port's small windows for CPU runs (as its own tests set them)
os.environ.setdefault("BSMAP_TPU_DEV_BATCH", "2048")
os.environ.setdefault("BSMAP_TPU_CANDS_PER_READ", "16")


def tiny_cell(workload: str, d: str, n: int = 4000, sample: int = 300,
              chrs=(("chrA", 300_000), ("chrB", 200_000))):
    """``workload`` with its configuration and mix cut for a CPU run."""
    import spec
    cell = spec.load_cell(workload)
    cfg = json.loads(json.dumps(cell.config))
    cfg["genome"]["chromosomes"] = [list(c) for c in chrs]
    cfg["name"] += "_tiny"
    opts = cfg["options"]
    opts[opts.index("-s") + 1] = "12"
    tr = json.loads(json.dumps(cell.traffic))
    tr["pass_size"] = {"se": n, "pe": n}
    tr["warmup"] = {"se": 2048, "pe": 2048}
    tr["sample"] = {"se": sample, "pe": sample}
    os.makedirs(d, exist_ok=True)
    cell.config, cell.traffic = cfg, tr
    cell.config_file = os.path.join(d, f"{cfg['name']}.json")
    cell.traffic_file = os.path.join(d, f"{workload}_traffic.json")
    with open(cell.config_file, "w") as f:
        json.dump(cfg, f)
    with open(cell.traffic_file, "w") as f:
        json.dump(tr, f)
    return cell


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))
