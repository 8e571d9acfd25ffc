"""What ``BENCHMARK.json`` says about one cell, found by name: the
workload entry, its configuration (``configs/<config>.json``), its traffic
mix (``traffic/<traffic>.json``) and the metrics it reports, each metric
with its reader (``metrics/<name>.py``, a function ``read(ctx)`` that
returns a number, or None where the run has nothing to read)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object          # read(ctx) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_file: str
    traffic: dict
    traffic_file: str
    end_to_end: list[Metric]
    per_layer: list[Metric]

    @property
    def layout(self) -> str:
        return self.config["layout"]


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: list, workload: str) -> list[Metric]:
    return [Metric(m["name"], m["unit"], load_reader(m["name"]))
            for m in entries
            if workload in m.get("workloads", [workload])]


def load_cell(workload: str, bench_file: str | None = None) -> Cell:
    bench_file = bench_file or os.path.join(REPO, "BENCHMARK.json")
    with open(bench_file) as f:
        bench = json.load(f)
    root = os.path.dirname(os.path.abspath(bench_file))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_file}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = os.path.join(root, cfg_entry["file"])
    with open(cfg_file) as f:
        config = json.load(f)
    traffic_file = os.path.join(HERE, "traffic", f"{w['traffic']}.json")
    with open(traffic_file) as f:
        traffic = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                config_file=cfg_file, traffic=traffic,
                traffic_file=traffic_file,
                end_to_end=_metrics(bench["end_to_end"], workload),
                per_layer=_metrics(bench["per_layer"], workload))
