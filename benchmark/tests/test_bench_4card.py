"""The four-card cell ``wgbs_se100_4card``: its configuration shares the
single-card cell's genome and reads; the ``mesh.*`` reader on hand-made
records, and None where a run has no mesh records; and the cell's run on
a 4-entry CPU mesh, which ``--engine auto`` turns into the sharded engine
as it does on four cards: the reference's verdict and the single-device
engine's bytes."""

import json
import os

import pytest

from conftest import REPO, tiny_cell
from test_bench_spans import _ctx

MESH_METRICS = ["mesh.dispatch_s_per_Mread"]
MS = 1_000_000          # ns


def _rec(name, tid, parent, a, b, kind="span", **attrs):
    return {"name": name, "kind": kind, "thread": f"t{tid}", "tid": tid,
            "seq": 0, "parent": parent, "start_ns": a * MS, "end_ns": b * MS,
            "cpu_ns": None, "attrs": attrs}


def _mesh_ctx():
    """A 500 ms traced pass of 2 Mreads: the align loop (tid 1) enqueues
    five stripes (cards 0-3, then card 0 again with card 1-3 padding
    alone), 10 ms each; a stripe span on another thread is not the
    loop's."""
    recs = [_rec("pipe.pass", 1, -1, 0, 500)]
    for k, card in enumerate([0, 1, 2, 3, 0]):
        recs.append(_rec("engine.stripe", 1, 0, 10 * k, 10 * k + 10,
                         rows=65536, card=card))
    recs += [_rec("mesh.skip", 1, 0, 50, 50, "instant", card=c)
             for c in (1, 2, 3)]
    recs += [_rec("engine.stripe", 2, -1, 100, 130, rows=5, card=1)]
    return {"layout": "se", "pass_reads": 2_000_000,
            "window_reads": 2_000_000, "window_s": 0.5,
            "spans": {"anchor": {"epoch_ns": 0, "perf_ns": 0,
                                 "width_ns": 1}, "records": recs}}


def _read(name, ctx):
    import spec
    return spec.load_reader(name)(ctx)


def test_mesh_metrics_on_hand_made_records():
    # the loop's five 10 ms stripe spans over 2 Mreads
    assert _read("mesh.dispatch_s_per_Mread", _mesh_ctx()) == \
        pytest.approx(0.050 / 2)


def test_mesh_metrics_read_nothing_without_mesh_records():
    """No spans, or a single-card engine's spans: no mesh.* number."""
    for name in MESH_METRICS:
        assert _read(name, {"layout": "se", "pass_reads": 2_000_000,
                            "window_s": 0.5}) is None
        assert _read(name, _ctx()) is None


def test_four_card_cell_keeps_the_single_card_inputs():
    """Four cards, the single-card cell's configuration but its name,
    source (at most 200 characters) and deployment, and so its genome and
    read files."""
    import harness
    import spec
    cell = spec.load_cell("wgbs_se100_4card")
    one = spec.load_cell("wgbs_se100")
    assert cell.chips == 4 and one.chips == 1
    assert cell.traffic == one.traffic
    assert len(cell.config["source"]) <= 200
    drop = ("name", "source", "deployment")
    assert {k: v for k, v in cell.config.items() if k not in drop} == \
        {k: v for k, v in one.config.items() if k not in drop}
    assert harness.genome_key(cell.config) == "genome_c5b4cf72cc33"
    assert harness.reads_key(cell) == "reads_95d84d18d9bf"
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in MESH_METRICS:
        assert got[name]["workloads"] == ["wgbs_se100_4card"]
        assert (got[name]["layer"], got[name]["moves"]) == (
            "mesh", "reads_per_s")
    assert [m.name for m in cell.per_layer] == MESH_METRICS


@pytest.fixture
def cpu_mesh(monkeypatch):
    """``Port``'s mesh on the CPU as on the cards: the cell's ``chips``
    entries (the CPU, repeated), stripes of 128 reads."""
    import torch
    import port
    from bsmap_tpu_torch.engine import device_engine
    monkeypatch.setattr(port, "card_mesh",
                        lambda device, chips: [torch.device(device)] * chips)
    monkeypatch.setattr(device_engine, "DEV_BATCH", 128)


def _cell(tmp_path):
    """The cell at 3,400 reads a pass: blocks of 512, 1,024 and 1,864
    reads, whose last window has at most 328 live reads, so its fourth
    stripe is padding alone."""
    return tiny_cell("wgbs_se100_4card", str(tmp_path), n=3400, sample=300)


@pytest.mark.parametrize("trace", [False, True])
def test_four_card_cell_on_a_cpu_mesh(tmp_path, cache_root, cpu_mesh,
                                      monkeypatch, trace):
    """``run_cell`` through ``Port``: the sharded engine at the cell's
    options (-p 8 encode threads), judged by the reference: no bad record
    or header; traced, the stripes' host cost reads a number, every card
    had a stripe and a padding stripe was skipped."""
    import harness
    from bsmap_tpu_torch import obs
    seen = []
    real = obs.stop
    monkeypatch.setattr(obs, "stop", lambda: seen.append(real()) or seen[-1])
    res = harness.run_cell(_cell(tmp_path), 2**33 + 21, 0.5, trace,
                           device="cpu", cache_root=cache_root)
    assert res["correct"], res["checks"]
    assert res["checks"]["bad_records"]["value"] == 0
    assert res["checks"]["bad_headers"]["value"] == 0
    assert res["device"]["count"] == 4
    assert bool(seen) is trace
    if trace:
        assert set(res["metrics"]) == {"mesh.dispatch_s_per_Mread"}
        assert res["metrics"]["mesh.dispatch_s_per_Mread"]["value"] > 0
        recs = seen[0]["records"]
        cards = {r["attrs"]["card"] for r in recs
                 if r["name"] == "engine.stripe"}
        assert cards == {0, 1, 2, 3}
        assert any(r["name"] == "mesh.skip" for r in recs)


def test_four_card_bytes_equal_the_single_device(tmp_path, cache_root,
                                                 monkeypatch):
    """The same pass through the sharded engine (4 CPU entries) and the
    single-device engine: the same output bytes."""
    import genome
    import harness
    import torch
    import port
    from bsmap_tpu_torch.engine import device_engine
    from bsmap_tpu_torch.parallel import ShardedDeviceEngine
    monkeypatch.setattr(device_engine, "DEV_BATCH", 128)
    cell = _cell(tmp_path)
    cache = os.path.join(cache_root, harness.genome_key(cell.config))
    genome.ensure_genome(cell.config, cache)
    reads = harness.ensure_reads(cell, cache)
    real = port.card_mesh
    out = {}
    for name, mesh in (("sharded", lambda d, c: [torch.device(d)] * c),
                       ("device", real)):
        monkeypatch.setattr(port, "card_mesh", mesh)
        p = port.Port(cell.config, cell.traffic, reads,
                      genome.genome_path(cache), cache, os.devnull, 11,
                      device="cpu", chips=cell.chips)
        try:
            assert p.engine.engine_name == name
            assert isinstance(p.engine, ShardedDeviceEngine) is (
                name == "sharded")
            path = str(tmp_path / f"{name}.sam")
            assert p.run_pass(out=path) == 3400
        finally:
            p.close()
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["sharded"].count(b"\n") > 3400
    assert out["sharded"] == out["device"]
