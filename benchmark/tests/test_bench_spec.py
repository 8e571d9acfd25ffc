"""Every cell of BENCHMARK.json finds its configuration, mix and metric
readers by name, and the file keeps to the contract's shapes."""

import json
import os
import re

import pytest

from conftest import REPO

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(w):
    import spec
    cell = spec.load_cell(w)
    assert cell.config["name"] == [x for x in BENCH["workloads"]
                                   if x["name"] == w][0]["config"]
    assert cell.traffic["name"] == [x for x in BENCH["workloads"]
                                    if x["name"] == w][0]["traffic"]
    names = {m.name for m in cell.end_to_end}
    assert {"setup_s", "reads_per_s"} <= names
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.read)


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert "assumed" in cfg and cfg["source"]
