"""What ``BENCHMARK.json`` says about one cell, found by name: the
workload entry, its configuration (``configs/<config>.json``), its traffic
mix (``traffic/<traffic>.json``) and the metrics it reports, each metric
with its reader (``metrics/<name>.py``, a function ``read(ctx)`` that
returns a number, or None where the run has nothing to read).

A configuration may bring its own code as files under ``benchmark/``,
each named by a path relative to it and loaded by path
(``module_file``):

``genome_features``  a module whose ``apply(seq, rng, cfg, index)``
                     ``genome.py`` calls on each chromosome's codes after
                     its own steps, with a generator of the genome's seed;
``library_script``   a script with ``reads.py``'s command line and record
                     layout, run in its place;
``check``            a module whose ``check_run`` (``compare.check_run``'s
                     signature and verdict) judges the run in place of
                     ``compare.check_run``.

Where a configuration names none, nothing of it changes: not its code,
not its cache keys (``code_key``).
"""

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


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return _load(os.path.join(HERE, "metrics", f"{name}.py"),
                 "bench_metric_" + name.replace(".", "_")).read


def module_file(cfg: dict, key: str) -> str | None:
    """The file that configuration ``cfg`` names under ``key``
    (``genome_features``, ``library_script`` or ``check``), as an absolute
    path inside ``benchmark/``; None where it names none."""
    rel = cfg.get(key)
    if rel is None:
        return None
    path = os.path.normpath(os.path.join(HERE, rel))
    if os.path.isabs(rel) or not path.startswith(HERE + os.sep):
        raise ValueError(f"{key} {rel!r} is not a file under benchmark/")
    return path


def load_module(cfg: dict, key: str):
    """The module that ``cfg`` names under ``key``, or None."""
    path = module_file(cfg, key)
    if path is None:
        return None
    return _load(path, "bench_" + key + "_" + os.path.basename(path)
                 .removesuffix(".py").replace(".", "_"))


def code_key(cfg: dict, keys) -> list:
    """[key, file name, SHA-1 of its source] for each of ``keys`` that
    ``cfg`` names: what a cache key takes in, so that an edit to the file
    makes new inputs, and a configuration that names none keeps its
    key."""
    import hashlib
    out = []
    for key in keys:
        path = module_file(cfg, key)
        if path is not None:
            with open(path, "rb") as f:
                out.append([key, cfg[key],
                            hashlib.sha1(f.read()).hexdigest()])
    return out


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
