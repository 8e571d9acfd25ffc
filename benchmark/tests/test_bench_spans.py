"""The readers of the port's own spans (``program_spans``) on a hand-made
``ctx``, None where a run has no spans, and ``span_probe`` on a tiny cell
on the CPU."""

import pytest

import program_spans as ps
from conftest import tiny_cell

MS = 1_000_000          # ns


def _rec(name, tid, parent, a, b, cpu):
    return {"name": name, "kind": "span", "thread": f"t{tid}", "tid": tid,
            "seq": 0, "parent": parent, "start_ns": a * MS, "end_ns": b * MS,
            "cpu_ns": None if cpu is None else cpu * MS, "attrs": {}}


def _ctx():
    """An align loop (tid 1) over a 100 ms pass in a 110 ms window that
    starts 10 ms before it, a writer (tid 2) with the host route, a
    kernel's instant; the device busy 20-30 and 55-60 ms; spans on the
    profiler's clock as they are (anchor at 0)."""
    recs = [
        _rec("pipe.pass", 1, -1, 0, 100, 60),            # 0
        _rec("pipe.input_wait", 1, 0, 0, 10, 1),         # 1
        _rec("engine.align", 1, 0, 10, 40, 24),          # 2
        _rec("engine.rows", 1, 2, 10, 15, 5),            # 3
        _rec("engine.dispatch", 1, 2, 15, 20, 5),        # 4
        _rec("engine.collect", 1, 2, 20, 30, 1),         # 5
        _rec("engine.finish", 1, 0, 50, 70, 12),         # 6
        _rec("engine.collect", 1, 6, 52, 60, 1),         # 7
        _rec("pipe.output_wait", 1, 0, 80, 95, 1),       # 8
        _rec("host.route", 2, -1, 40, 90, 50),           # 9
        _rec("host.sync", 2, 9, 40, 50, 10),             # 10
        _rec("host.align", 2, 9, 50, 80, 30),            # 11
        _rec("engine.collect", 2, -1, 90, 95, 1),        # 12
        dict(_rec("kernel.reduce_reads", 1, 4, 16, 16, None),
             kind="instant", attrs={"m": 8}),            # 13
        _rec("gc.gen2", 1, 3, 11, 13, None),             # 14, no CPU read
    ]
    return {"layout": "se", "pass_reads": 2_000_000,
            "window_reads": 2_000_000, "window_s": 0.110,
            "spans": {"anchor": {"epoch_ns": 5 * 10**18, "perf_ns": 0,
                                 "width_ns": 100}, "records": recs},
            "trace": {"busy": [[0.020, 0.030], [0.055, 0.060]],
                      "trace_start_ns": 5 * 10**18},
            "counters": {"host_stale": 500}}


def test_readers_on_a_hand_made_pass():
    ctx = _ctx()
    got = {k: f(ctx) for k, f in ps.READERS.items()}
    assert got["loop.input_wait_share"] == pytest.approx(100 * 10 / 110)
    # align 30 + finish 20 less their collects 10 + 8, over 2 Mreads
    assert got["loop.engine_s_per_Mread"] == pytest.approx(0.032 / 2)
    # each kept span's own wall and CPU ms, its timed children's taken
    # out (the collection in rows read no CPU: it stays rows' own time):
    # pass, align, rows, dispatch, finish
    wall = 25 + 10 + 5 + 5 + 12
    cpu = 22 + 13 + 5 + 5 + 11
    assert got["loop.offcpu_share"] == pytest.approx(100 * (1 - cpu / wall))
    assert got["engine.collect_wait_s_per_Mread"] == pytest.approx(0.023 / 2)
    assert got["host.sync_s_per_Mread"] == pytest.approx(0.010 / 2)
    assert got["host.align_s_per_Mread"] == pytest.approx(0.030 / 2)
    assert got["host.stale_share"] == pytest.approx(100 * 500 / 2e6)


def test_idle_by_span_has_both_edges():
    """Idle from the window's start to the first busy interval, between,
    and from the last to the window's end: the loop's innermost span over
    each (a collection inside ``engine.rows`` its own), ``loop:none``
    before the pass's span."""
    got = dict(ps.idle_by_span(_ctx()))
    want = {"loop:pipe.input_wait": 0.010, "loop:engine.rows": 0.003,
            "loop:gc.gen2": 0.002,
            "loop:engine.dispatch": 0.005, "loop:engine.collect": 0.003,
            "loop:engine.align": 0.010, "loop:pipe.pass": 0.010 + 0.010
            + 0.005, "loop:engine.finish": 0.002 + 0.010,
            "loop:pipe.output_wait": 0.015, "loop:none": 0.010}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    assert sum(got.values()) == pytest.approx(0.110 - 0.015)
    assert ps.idle_intervals([[1, 2], [1.5, 3]], 0, 4) == [(0, 1), (3, 4)]


def test_readers_read_nothing_without_spans():
    ctx = _ctx()
    del ctx["spans"], ctx["counters"]
    assert all(f(ctx) is None for f in ps.READERS.values())
    assert ps.idle_by_span(ctx) is None
    ctx["spans"] = {"anchor": {}, "records": []}
    assert ps.idle_by_span(ctx) is None


@pytest.mark.parametrize("workload", ["wgbs_se100", "wgbs_pe100_trim"])
def test_probe_on_a_tiny_cell(tmp_path, cache_root, workload):
    """Two profiled passes on the CPU, spans in the first: every reader
    reads a number, the host causes add up to the host route's count, the
    pair-end host route's spans lie within its timer, and the loop is in a
    span over all but a sliver of the window."""
    import span_probe
    out = span_probe.probe(tiny_cell(workload, str(tmp_path), n=2500,
                                     sample=200), 2**33 + 5, 2,
                           device="cpu", cache_root=cache_root)
    on, off = out["passes"]
    assert on["spans"] and not off["spans"] and "metrics" not in off
    assert all(v is not None for v in on["metrics"].values()), on["metrics"]
    assert on["causes_add_up"]
    if workload == "wgbs_pe100_trim":       # t_host: pair-end only
        assert 0 < on["host_spans_s"] <= on["t_host_s"] + 1e-6
    idle = dict(on["idle_by_span"])
    assert idle.get("loop:none", 0.0) < 0.05 * on["window_s"]
