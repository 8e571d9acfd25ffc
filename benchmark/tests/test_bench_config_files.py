"""A configuration brings its own genome features, read library and check
as files (``spec.module_file``) and runs through ``run_cell`` with them; the
configurations that name none keep their cache keys; a cell's mesh takes
its ``chips`` cards; the engine's counters and the port's spans reach the
metrics."""

import json
import os

import numpy as np
import pytest

from conftest import tiny_cell
from test_bench_spans import _ctx

SPAN_METRICS = ["loop.input_wait_share", "loop.engine_s_per_Mread",
                "loop.offcpu_share", "engine.collect_wait_s_per_Mread",
                "host.sync_s_per_Mread", "host.align_s_per_Mread",
                "host.stale_share"]


def _toy(tmp_path):
    cell = tiny_cell("wgbs_se100", str(tmp_path))
    cell.config.update(genome_features="tests/toy/features.py",
                       library_script="tests/toy/library.py",
                       check="tests/toy/check.py", toy_island=2000)
    with open(cell.config_file, "w") as f:
        json.dump(cell.config, f)
    return cell


def _has_island(codes: np.ndarray, n: int) -> bool:
    alt = (codes[:-1] == 1) & (codes[1:] == 2) | \
        (codes[:-1] == 2) & (codes[1:] == 1)
    run = np.convolve(alt.astype(np.int32), np.ones(n - 1, np.int32),
                      mode="valid")
    return bool((run == n - 1).any())


def test_toy_configuration_runs_its_own_files(tmp_path, cache_root):
    import genome
    import harness
    cell = _toy(tmp_path)
    plain = tiny_cell("wgbs_se100", str(tmp_path / "plain"))
    assert harness.genome_key(cell.config) != harness.genome_key(
        plain.config)
    assert harness.reads_key(cell) != harness.reads_key(plain)
    res = harness.run_cell(cell, 2**32 + 3, 0.5, False, device="cpu",
                           cache_root=cache_root)
    assert res["correct"], res["checks"]
    # the check: its own number, first
    assert list(res["checks"])[0] == "toy_reads_checked"
    assert res["checks"]["toy_reads_checked"]["value"] == 300
    assert res["device"]["count"] == cell.chips == 1
    cache = os.path.join(cache_root, harness.genome_key(cell.config))
    # the library: its stamp beside the reads the run read
    with open(os.path.join(cache, harness.reads_key(cell),
                           "toy_library.json")) as f:
        assert "--traffic" in json.load(f)
    # the features: an island in every chromosome, none without them
    for _, codes in genome.load_codes(cell.config, cache):
        assert _has_island(np.asarray(codes), 2000)
    assert not _has_island(genome.make_chromosome(
        plain.config["genome"], 0, 300_000), 2000)


def test_code_files_stay_under_the_benchmark():
    import spec
    with pytest.raises(ValueError):
        spec.module_file({"check": "../tools/genreads.py"}, "check")
    with pytest.raises(ValueError):
        spec.module_file({"check": "/etc/passwd"}, "check")
    assert spec.module_file({}, "check") is None
    assert spec.code_key({"genome": {}}, ["genome_features",
                                          "library_script", "check"]) == []


@pytest.mark.parametrize("workload,genome_key,reads_key", [
    ("wgbs_se100", "genome_c5b4cf72cc33", "reads_95d84d18d9bf"),
    ("wgbs_pe100_trim", "genome_c5b4cf72cc33", "reads_9af091ad6e6c"),
    ("wgbs_pe100", "genome_c5b4cf72cc33", "reads_5f074997bff9"),
])
def test_cache_keys_of_the_cells_are_kept(workload, genome_key, reads_key):
    """The keys as the harness had them before configurations could name
    files: the same genome, index and read files."""
    import harness
    import spec
    cell = spec.load_cell(workload)
    assert harness.genome_key(cell.config) == genome_key
    assert harness.reads_key(cell) == reads_key


def test_mesh_takes_the_cells_cards(monkeypatch):
    import torch
    import port
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert port.card_mesh("cuda", 1) == [torch.device("cuda", 0)]
    assert port.card_mesh("cuda", 4) == [torch.device("cuda", i)
                                         for i in range(4)]
    assert port.card_mesh("cpu", 4) is None
    peaks = [5, 9, 7, 3]
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i=0: peaks[i])
    assert port.card_peak_bytes("cuda", 1) == 5
    assert port.card_peak_bytes("cuda", 4) == 9
    assert port.card_peak_bytes("cpu", 4) == 0


def test_counters_carry_the_host_causes(tmp_path, cache_root):
    import genome
    import harness
    from port import Port
    cell = tiny_cell("wgbs_pe100_trim", str(tmp_path), n=2500, sample=200)
    cache = os.path.join(cache_root, harness.genome_key(cell.config))
    genome.ensure_genome(cell.config, cache)
    reads = harness.ensure_reads(cell, cache)
    p = Port(cell.config, cell.traffic, reads, genome.genome_path(cache),
             cache, os.devnull, 7, device="cpu")
    try:
        c0 = p.counters()
        assert p.run_pass() == 2500
        c1 = p.counters()
    finally:
        p.close()
    causes = {k: c1[k] - c0[k] for k in c1 if k.startswith("host_causes.")}
    assert {"host_causes." + k for k in ("filtered_mate", "device",
                                        "stale")} <= set(causes)
    host = (c1["n_replayed"] + c1["n_mate_filtered"]
            - c0["n_replayed"] - c0["n_mate_filtered"])
    assert 0 < host == sum(causes.values())
    assert c1["host_native"] - c0["host_native"] in (0, host)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_a_recorded_pass(name):
    import program_spans
    import spec
    read = spec.load_reader(name)
    ctx = _ctx()
    assert read(ctx) == pytest.approx(program_spans.READERS[name](ctx))
    assert read(ctx) is not None
    del ctx["spans"], ctx["counters"]
    assert read(ctx) is None


def test_span_metrics_in_the_benchmark():
    import spec
    from conftest import REPO
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert got[name]["moves"] == "reads_per_s"
        assert got[name]["source"] in ("program_span", "program_counter")
    # the host route's aligner runs in the pair-end cells, and stale
    # schedules send pairs to it in the trimmed one (none in the plain)
    lacks = {"wgbs_se100": {"host.align_s_per_Mread", "host.stale_share"},
             "wgbs_pe100": {"host.stale_share"}, "wgbs_pe100_trim": set()}
    for w, no in lacks.items():
        names = {m.name for m in spec.load_cell(w).per_layer}
        assert set(SPAN_METRICS) - no <= names, w
        assert not no & names, w


@pytest.mark.parametrize("workload", ["wgbs_se100", "wgbs_pe100_trim"])
def test_traced_run_hands_the_spans_to_metrics(tmp_path, cache_root,
                                               workload):
    """A traced run on the CPU: the span metrics its cell lists read a
    number, and the idle time is named by the align loop's spans."""
    import harness
    cell = tiny_cell(workload, str(tmp_path), n=2500, sample=200)
    res = harness.run_cell(cell, 2**32 + 9, 0.5, True, device="cpu",
                           cache_root=cache_root)
    assert res["correct"], res["checks"]
    listed = {m.name for m in cell.per_layer} & set(SPAN_METRICS)
    assert listed and listed <= set(res["metrics"]), res["metrics"]
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and all(k.startswith("loop:") for k, _ in gaps)
