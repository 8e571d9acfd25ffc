"""The port's tracer (``bsmap_tpu_torch.obs``) on the CPU: nothing
recorded and nothing allocated while it is off; spans that nest with
their parents and carry their block's sequence number on every thread of
the block pipelines; output byte-identical with tracing on and off; the
host route's causes adding up to its counters; the clock anchor against
``torch.profiler``'s timeline; ``--trace``'s Chrome trace-event file; and
each kernel launch's work record."""

import json
import sys
import threading
import time

import pytest
import torch

from bsmap_tpu_torch import obs

from .test_pe_corners import repeat_pe_data  # noqa: F401 (fixture)
from .test_torch_pe_blocks import TRIM, pe_data  # noqa: F401 (fixture)

PIPE = {"pipe.pass", "pipe.parse", "pipe.encode", "pipe.input_wait",
        "pipe.writer_wait", "pipe.write"}
ENGINE = {"engine.align", "engine.rows", "engine.dispatch", "engine.h2d",
          "engine.launch", "engine.collect", "engine.commit",
          "engine.finish", "format"}
HOST = {"host.route", "host.sync", "host.align"}


@pytest.fixture
def traced():
    """Tracing left off, whatever a test does."""
    yield
    obs.stop()


@pytest.fixture
def small_windows(monkeypatch):
    """32-read windows (blocks of 32, 64, 128, ... reads: several blocks
    a pass), 16 candidates a read, one process with encode threads."""
    from bsmap_tpu_torch.engine import device_engine
    monkeypatch.setattr(device_engine, "DEV_BATCH", 32)
    monkeypatch.setattr(device_engine, "CANDS_PER_READ", 16)
    monkeypatch.setenv("BSMAP_TPU_LOCAL_MP", "0")
    monkeypatch.setenv("BSMAP_TPU_RANDR_SEED", "99")


def _by_name(trace) -> dict:
    out: dict = {}
    for r in trace["records"]:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_returns_the_shared_object_and_records_nothing(traced):
    obs.stop()
    assert obs.span("engine.align", rows=3) is obs.NOOP
    assert obs.block(7) is obs.NOOP
    with obs.block(1), obs.span("pipe.parse", rows=5, nbytes=9):
        pass
    obs.instant("kernel.fixed_schedule", m=1)
    assert not obs.enabled()
    assert obs.stop()["records"] == []


def test_off_allocates_nothing(traced):
    """10,000 spans and blocks while off leave the interpreter's count of
    allocated blocks where it was."""
    obs.stop()

    def loop():
        for i in range(10_000):
            with obs.block(i), obs.span("engine.h2d", nbytes=i):
                pass

    loop()
    before = sys.getallocatedblocks()
    loop()
    assert sys.getallocatedblocks() - before < 50


def test_spans_nest_per_thread_with_their_block(traced):
    """Spans on two threads: each parent is the enclosing span of its own
    thread, the block's number reaches every span opened under it, and
    the thread's name and CPU time are recorded."""
    obs.start()

    def worker(seq):
        with obs.block(seq), obs.span("pipe.encode", rows=4):
            with obs.span("engine.rows"):
                sum(range(20_000))
            obs.instant("kernel.rc_words", m=4)

    t = threading.Thread(target=worker, args=(3,), name="bsmap_encode_9")
    with obs.span("pipe.pass"):
        t.start()
        t.join(timeout=30)
        with obs.block(5), obs.span("engine.align", rows=2, nbytes=64):
            pass
    assert not t.is_alive()
    tr = obs.stop()
    recs = tr["records"]
    by = {r["name"]: (k, r) for k, r in enumerate(recs)}
    k_pass, r_pass = by["pipe.pass"]
    assert r_pass["parent"] == -1 and r_pass["seq"] == -1
    _, r_align = by["engine.align"]
    assert r_align["parent"] == k_pass and r_align["seq"] == 5
    assert r_align["attrs"] == {"rows": 2, "bytes": 64}
    k_enc, r_enc = by["pipe.encode"]
    assert r_enc["thread"] == "bsmap_encode_9" and r_enc["parent"] == -1
    assert r_enc["tid"] != r_pass["tid"] and r_enc["seq"] == 3
    _, r_rows = by["engine.rows"]
    assert r_rows["parent"] == k_enc and r_rows["seq"] == 3
    assert r_rows["cpu_ns"] > 0
    _, r_k = by["kernel.rc_words"]
    assert r_k["parent"] == k_enc and r_k["kind"] == "instant"
    assert r_k["cpu_ns"] is None and r_k["attrs"] == {"m": 4}
    assert r_k["start_ns"] == r_k["end_ns"]
    assert {r["kind"] for r in recs if r is not r_k} == {"span"}
    assert [r["start_ns"] for r in recs] == sorted(r["start_ns"]
                                                   for r in recs)


def test_cpu_time_left_out_and_collections_traced(traced):
    """A ``cpu=False`` span reads no CPU time; a garbage collection is a
    span of its own, on the thread that set it off, inside the span that
    was open; none once tracing is off."""
    import gc
    obs.start()
    with obs.span("host.route"):
        with obs.span("host.align", cpu=False):
            pass
        gc.collect()
    tr = obs.stop()
    by = {r["name"]: r for r in tr["records"]}
    assert by["host.align"]["cpu_ns"] is None
    assert by["host.route"]["cpu_ns"] >= 0
    col = by["gc.gen2"]
    assert col["kind"] == "span" and col["cpu_ns"] is None
    assert tr["records"][col["parent"]]["name"] == "host.route"
    gc.collect()
    assert obs.stop()["records"] == []


def test_start_drops_earlier_records(traced):
    obs.start()
    with obs.span("a"):
        pass
    obs.start()
    with obs.span("b"):
        pass
    assert [r["name"] for r in obs.stop()["records"]] == ["b"]


def test_totals_summary_and_chrome_trace():
    """Self time is a span's time less its children's; the summary has a
    line per name; the Chrome form has X, i, M and C events."""
    rec = {"thread": "MainThread", "tid": 1, "seq": 0, "attrs": {},
           "kind": "span"}
    tr = {"anchor": {"epoch_ns": 10**18, "perf_ns": 0, "width_ns": 100},
          "records": [
              dict(rec, name="engine.align", parent=-1, start_ns=0,
                   end_ns=10_000_000, cpu_ns=9_000_000),
              dict(rec, name="engine.collect", parent=0, start_ns=2_000_000,
                   end_ns=6_000_000, cpu_ns=1_000),
              dict(rec, name="kernel.reduce_reads", parent=0,
                   start_ns=1_000_000, end_ns=1_000_000, cpu_ns=None,
                   attrs={"m": 8, "cands": 16}, kind="instant")]}
    tot = obs.totals(tr)
    assert tot["engine.align"] == pytest.approx((1, 0.010, 0.006))
    assert tot["engine.collect"] == pytest.approx((1, 0.004, 0.004))
    assert "kernel.reduce_reads" not in tot
    lines = obs.summary(tr)
    assert len(lines) == 2 and "engine.align" in lines[0]
    ev = obs.chrome_trace(tr, {"host_causes": {"stale": 3}})["traceEvents"]
    kinds = {e["ph"]: e for e in ev}
    assert set(kinds) == {"M", "X", "i", "C"}
    x = [e for e in ev if e["name"] == "engine.collect"][0]
    assert x["ts"] == pytest.approx(1e15 + 2_000) and x["dur"] == 4_000
    assert kinds["C"]["args"] == {"stale": 3}
    assert kinds["i"]["args"]["cands"] == 16


def test_anchor_places_spans_on_the_profiler_timeline(traced):
    """An ``obs.span`` and a ``record_function`` around the same sleep
    line up within 1 ms on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    obs.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.005)
        with obs.span("probe"), record_function("probe_rf"):
            time.sleep(0.05)
    tr = obs.stop()
    start = prof.profiler.kineto_results.trace_start_ns()
    ev = [e for e in prof.events() if e.name == "probe_rf"][0]
    sp = [r for r in tr["records"] if r["name"] == "probe"][0]
    a = obs.to_epoch_ns(tr, sp["start_ns"]) - start
    b = obs.to_epoch_ns(tr, sp["end_ns"]) - start
    assert abs(a - ev.time_range.start * 1000) < 1e6
    assert abs(b - ev.time_range.end * 1000) < 1e6


def _cli(d, argv, monkeypatch):
    from bsmap_tpu_torch import cli
    monkeypatch.chdir(d)
    st = {}
    assert cli.run(argv + ["--device", "cpu"], stats=st) == 0
    return st


def _check_blocks(trace, loop_tid) -> None:
    """Every pipeline and engine span sits on its thread with its parent
    there, and each block's spans carry its number on every thread."""
    recs = trace["records"]
    for r in recs:
        if r["parent"] >= 0:
            assert recs[r["parent"]]["tid"] == r["tid"]
    names = {r["tid"]: r["thread"] for r in recs}
    threads = {r["name"]: {names[x["tid"]] for x in recs
                           if x["name"] == r["name"]} for r in recs}
    assert threads["pipe.parse"] == {"bsmap_reader"}
    assert all(t.startswith(("bsmap_encode", "bsmap_pe_encode"))
               for t in threads["pipe.encode"])
    assert threads["pipe.writer_wait"] == {"bsmap_writer"}
    assert {r["tid"] for r in recs if r["name"] == "engine.align"} == \
        {loop_tid}
    seqs = {r["seq"] for r in recs if r["name"] == "pipe.encode"}
    assert len(seqs) >= 3 and seqs == set(range(len(seqs)))
    for name in ("pipe.parse", "engine.align", "engine.finish", "format",
                 "pipe.write"):
        assert {r["seq"] for r in recs if r["name"] == name} >= seqs, name
    for r in recs:
        if r["name"] in ("engine.h2d", "engine.launch"):
            up = recs[r["parent"]]
            assert up["name"] == "engine.dispatch"
            assert up["seq"] == r["seq"]


def test_se_pass_spans_and_same_output(pe_data, small_windows,  # noqa: F811
                                       monkeypatch, traced):
    """A trimmed single-end pass at -p 2 (reader, two encode threads, the
    align loop, writer): with ``--trace`` it writes the same bytes as
    without, every span name of the pipeline, the engine and the SE host
    route, nested and numbered by block; the Chrome file parses, and its
    names are those spans, the kernels' and the host causes'."""
    base = ["-a", "a1.fq", "-d", "ref.fa", "-s", "12", "-S", "2", "-v",
            "2", "-u", "-p", "2"] + TRIM
    st0 = _cli(pe_data, base + ["-o", "plain.sam"], monkeypatch)
    st1 = _cli(pe_data, base + ["-o", "traced.sam", "--trace", "se.json"],
               monkeypatch)
    assert (pe_data / "plain.sam").read_bytes() == \
        (pe_data / "traced.sam").read_bytes()
    assert st0["engine"].n_replayed == st1["engine"].n_replayed > 0
    ev = json.loads((pe_data / "se.json").read_text())["traceEvents"]
    names = {e["name"] for e in ev if e["ph"] == "X"
             and not e["name"].startswith("gc.gen")}
    assert names >= PIPE | ENGINE | HOST
    assert {e["name"] for e in ev if e["ph"] == "C"} == {"host_causes"}
    assert {e["name"] for e in ev if e["ph"] == "M"} == {"thread_name"}
    assert names <= PIPE | ENGINE | HOST | {"pipe.read_wait",
                                            "pipe.output_wait"}


def test_pipeline_threads_and_blocks(pe_data, small_windows,  # noqa: F811
                                     monkeypatch, traced):
    """The same pass through ``obs.start``/``obs.stop`` in process: the
    parents and block numbers across the reader, encode, align-loop and
    writer threads."""
    base = ["-a", "a1.fq", "-d", "ref.fa", "-s", "12", "-S", "2", "-v",
            "2", "-p", "2", "-o", "inproc.sam"] + TRIM
    obs.start()
    _cli(pe_data, base, monkeypatch)
    tr = obs.stop()
    loop = [r for r in tr["records"] if r["name"] == "pipe.pass"]
    assert len(loop) == 1
    assert loop[0]["thread"] == threading.current_thread().name
    _check_blocks(tr, loop[0]["tid"])


@pytest.mark.parametrize("case", ["bsp", "s0", "r0"])
def test_pe_pass_spans_causes_and_same_output(pe_data,  # noqa: F811
                                              small_windows, monkeypatch,
                                              traced, case):
    """A trimmed pair-end pass with filtered mates and replays: the same
    bytes with tracing on and off; every span of the pipeline, the engine
    and the host route (syncs, host alignments, selections); each host
    pair counted once, under the first cause that holds."""
    flags = {"bsp": ["-S", "2"], "s0": ["-S", "0"],
             "r0": ["-S", "3", "-r", "0"]}[case]
    base = ["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12", "-v",
            "2", "-u", "-p", "2"] + flags + TRIM
    outs = []
    for tag in ("off", "on"):
        files = ["-o", f"{case}_{tag}.bsp", "-2", f"{case}_{tag}_u.bsp"]
        if tag == "on":
            obs.start()
        st = _cli(pe_data, base + files, monkeypatch)
        tr = obs.stop()
        outs.append([(pe_data / f).read_bytes() for f in files[1::2]])
    assert outs[0] == outs[1]
    names = set(_by_name(tr))
    assert names >= PIPE | ENGINE | HOST | {"host.select"}
    eng = st["engine"]
    causes = eng.host_causes
    assert sum(causes.values()) == eng.n_replayed + eng.n_mate_filtered
    assert causes["filtered_mate"] == eng.n_mate_filtered > 0
    assert causes["stale"] > 0
    if case != "r0":
        assert causes["multi"] == 0
    loop = _by_name(tr)["pipe.pass"][0]["tid"]
    _check_blocks(tr, loop)
    n_host = sum(r["attrs"]["rows"] for r in _by_name(tr)["host.route"])
    assert n_host == eng.n_replayed + eng.n_mate_filtered
    assert len(_by_name(tr)["host.align"]) == n_host


@pytest.mark.parametrize("data,flags,cause", [
    ("pe_data", ["-S", "2"] + TRIM, "stale"),
    ("repeat_pe_data", ["-S", "0"], "draw")])
def test_se_host_causes_add_up(request, small_windows, monkeypatch, data,
                               flags, cause):
    """Single-end: every replayed read counted once among the causes;
    trimmed lengths give stale schedules, multi-hit reads under -S 0
    sequential draws."""
    d = request.getfixturevalue(data)
    reads, ref = (("a1.fq", "ref.fa") if data == "pe_data"
                  else ("p1.fq", "g.fa"))
    st = _cli(d, ["-a", reads, "-d", ref, "-s", "12", "-v", "2", "-p", "1",
                  "-o", "se_c.sam"] + flags, monkeypatch)
    eng = st["engine"]
    assert sum(eng.host_causes.values()) == eng.n_replayed > 0
    assert eng.host_causes[cause] > 0
    assert eng.host_causes["filtered_mate"] == eng.host_causes["multi"] == 0


def test_pe_repeat_host_causes_add_up(repeat_pe_data, small_windows,  # noqa
                                      monkeypatch):
    """Pair-end multi-hit pairs under -S 0: each host pair counted once,
    as a sequential draw."""
    st = _cli(repeat_pe_data, ["-a", "p1.fq", "-b", "p2.fq", "-d", "g.fa",
                               "-s", "12", "-v", "2", "-p", "1", "-S", "0",
                               "-o", "rep_c.sam"], monkeypatch)
    eng = st["engine"]
    assert sum(eng.host_causes.values()) == \
        eng.n_replayed + eng.n_mate_filtered
    assert eng.host_causes["draw"] > 0


def test_pe_replay_cause_takes_the_first_that_holds():
    """``_replay_cause`` on hand-made J rows: the device's flags before a
    stale schedule, before a -r 0 multi-pair, before a -S 0 draw."""
    from types import SimpleNamespace

    import numpy as np

    from bsmap_tpu_torch.engine import pair_device as pd
    eng = pd.PairDeviceEngine.__new__(pd.PairDeviceEngine)
    eng.param = SimpleNamespace(randseed=0, report_repeat_hits=0)
    j = np.zeros((7, pd.JN_COLS), dtype=np.int32)
    multi = 2 | (3 << 5)                 # paired at step 1, three pairs
    j[0, pd.J_FLAGS] = 1                 # mate 1's replay bit
    j[1, pd.J_FLAGS] = 1 << 3            # a pairhits bucket at the limit
    j[2, pd.J_PAIR] = multi              # stale below, multi, draw
    j[3, pd.J_PAIR] = multi              # multi (and draw)
    j[4, pd.J_PAIR] = 1 | (2 << 5)       # step 0, two pairs: a draw
    j[5, pd.J_MATE_B] = 1 | (2 << 6)     # unpaired mate with two hits
    risk = np.array([1, 0, 1, 0, 0, 0, 0], dtype=bool)
    got = [pd.HOST_CAUSES[c] if c else None
           for c in eng._replay_cause(j, risk)]
    assert got == ["device", "device", "stale", "multi", "draw", "draw",
                   None]
    eng.param = SimpleNamespace(randseed=5, report_repeat_hits=1)
    assert list(eng._replay_cause(j, risk)) == [1, 1, 2, 0, 0, 0, 0]


@pytest.mark.parametrize("extra", [["--nprocs", "2", "--proc-id", "0"],
                                   ["-p", "2"]])
def test_trace_refuses_worker_processes(pe_data, monkeypatch,  # noqa: F811
                                        extra):
    """--trace records one process: --nprocs and -p workers (trimming
    under --device cpu) refuse it with a message that says so."""
    from bsmap_tpu_torch import cli
    monkeypatch.chdir(pe_data)
    monkeypatch.delenv("BSMAP_TPU_LOCAL_MP", raising=False)
    monkeypatch.setattr(cli, "_worker_cap", lambda *a: 2)
    with pytest.raises(SystemExit) as e:
        cli.run(["-a", "a1.fq", "-d", "ref.fa", "-s", "12", "-o", "w.sam",
                 "--device", "cpu", "--trace", "w.json"] + TRIM + extra)
    assert "--trace records the spans of one process" in str(e.value)
    assert not (pe_data / "w.json").exists()


def test_kernel_launch_record(traced):
    """A launch's work record: the host-known arguments of
    ``measure.bound``, only while tracing is on."""
    from bsmap_tpu_torch.engine import device_engine as de
    from bsmap_tpu_torch.engine import kernels as K
    cfg = de.Cfg(S=12, I=4, maxseg=3, chains_mode="b", P=40,
                 max_num_hits=1000, report_repeat_hits=1, W=100, n_chr=1,
                 lean=True, nw=7)
    K._note("verify_candidates", cfg, 100, 4096)
    obs.start()
    K._note("verify_candidates", cfg, 100, 4096)
    (r,) = obs.stop()["records"]
    assert r["name"] == "kernel.verify_candidates"
    assert r["attrs"] == {"m": 100, "cands": 4096, "nw": 7, "NB": 24,
                          "maxseg": 3, "nch": 2, "lean": 1, "rrbs": 0}


@pytest.mark.gpu
def test_cuda_kernel_records_match_launches(pe_data, small_windows,  # noqa
                                            monkeypatch, traced):
    """On a CUDA device: one ``kernel.<name>`` record a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run pytest -m gpu on the GPU "
                    "machine)")
    from bsmap_tpu_torch import cli
    from bsmap_tpu_torch.engine import kernels as K
    monkeypatch.chdir(pe_data)
    K.reset_launch_counts()
    obs.start()
    assert cli.run(["-a", "a1.fq", "-b", "a2.fq", "-d", "ref.fa", "-s", "12",
                    "-S", "2", "-o", "gpu.bsp", "-2", "gpu_u.bsp", "-p", "2",
                    "--device", "cuda"] + TRIM) == 0
    tr = obs.stop()
    got = {}
    for r in tr["records"]:
        if r["name"].startswith("kernel."):
            got[r["name"][7:]] = got.get(r["name"][7:], 0) + 1
    want = {k: v for k, v in K.launch_counts().items() if v}
    assert got == want and want
