#!/usr/bin/env python3
"""Traced passes of one cell with the port's own spans, on one NVIDIA card.

    python3 benchmark/span_probe.py --workload wgbs_se100 --seed 7 \\
        --passes 6 --out spans_se.json.gz

Sets the cell up as ``harness.run_cell`` does (inputs made once into
``benchmark/.cache``, the port from the cache, one warm-up pass), then
runs ``--passes`` pipeline passes under ``torch.profiler``, the port's
tracer (``bsmap_tpu_torch.obs``) on in passes 1, 4, 5, 8, 9, ... (on,
off, off, on: a drift of the host's speed over the run weighs on both
alike).  For each pass it prints the wall time and the host route's
seconds (``t_host``, pair-end); for a pass with spans also the
readings of ``program_spans.READERS``, ``idle_by_span``, the largest
offset of a device-to-host copy from the ``engine.collect`` span that
holds it, the same for each ``cudaMemcpyAsync`` call on the host
against the ``engine.h2d`` or ``engine.collect`` span that made it, the
engine's ``host_causes`` against its counters, and the host route's
spans against ``t_host``.  The output goes to
``/dev/null``; the check against the reference is ``run.py``'s.  The last
line of stdout is the JSON of every pass; ``--out`` writes it too, with
each traced pass's spans, busy intervals and copies under ``raw`` (gzip
where the name ends in ``.gz``).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (HERE, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import program_spans  # noqa: E402
from bench_trace import _union  # noqa: E402


def profiled_pass(port, device: str, spans: bool) -> dict:
    """One pass under ``torch.profiler`` (and ``obs`` with ``spans``):
    its reads, wall time, the device's busy intervals and device-to-host
    copies (seconds from the profiler's start), the profiler's start in
    epoch ns, and the spans."""
    import torch
    from bsmap_tpu_torch import obs
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if spans:
        obs.start()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            n = port.run_pass()
            if device == "cuda":
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    finally:
        trace = obs.stop() if spans else None
    dev, d2h, calls = [], [], []
    for ev in prof.events():
        a, b = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type.name != "CUDA":
            if ev.name == "cudaMemcpyAsync":
                calls.append((a, b))
            continue
        dev.append((a, b))
        if "DtoH" in ev.name:
            d2h.append((a, b))
    return {"n": n, "window_s": window,
            "busy": [list(iv) for iv in _union(dev)],
            "d2h": d2h, "memcpy_calls": calls,
            "trace_start_ns": prof.profiler.kineto_results.trace_start_ns(),
            "spans": trace}


def offsets(ctx, intervals, names) -> list[float]:
    """For each interval (seconds on the profiler's timeline), in ms, how
    far it reaches outside the nearest span named in ``names`` (0 where
    one holds it)."""
    spans = [(program_spans.on_device_clock(ctx, r["start_ns"]),
              program_spans.on_device_clock(ctx, r["end_ns"]))
             for r in ctx["spans"]["records"] if r["name"] in names]
    return [1e3 * min((max(s - a, b - e, 0.0) for s, e in spans),
                      default=float("inf")) for a, b in intervals]


def probe(cell, seed: int, passes: int, device: str = "cuda",
          cache_root: str | None = None) -> dict:
    """Set ``cell`` up and run its profiled passes (see the module's
    docstring); returns the JSON object."""
    import harness
    from bsmap_tpu_torch import obs
    from port import Port
    cfg, traffic = cell.config, cell.traffic
    layout = cfg["layout"]
    per = 2 if layout == "pe" else 1
    cache_dir = os.path.join(cache_root or os.path.join(HERE, ".cache"),
                             harness.genome_key(cfg))
    harness._child([os.path.join(HERE, "genome.py"), "--config",
                    cell.config_file, "--out", cache_dir])
    reads = harness.ensure_reads(cell, cache_dir)
    t0 = time.perf_counter()
    port = Port(cfg, traffic, reads, os.path.join(cache_dir, "genome.fa"),
                cache_dir, os.devnull, seed, device=device)
    port.run_pass(read_end=int(traffic["warmup"][layout]))
    setup_s = time.perf_counter() - t0
    eng = port.engine
    card = ""
    if device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    out = {"workload": cell.name, "seed": seed, "card": card,
           "setup_s": setup_s, "passes": []}
    print(f"{cell.name}: set-up {setup_s:.3f} s on {card or device}",
          file=sys.stderr)
    for i in range(passes):
        on = i % 4 in (0, 3)
        c0 = dict(eng.host_causes)
        r0 = eng.n_replayed + getattr(eng, "n_mate_filtered", 0)
        h0 = float(getattr(eng, "t_host", 0.0))
        tr = profiled_pass(port, device, on)
        row = {"spans": on, "window_s": tr["window_s"],
               "busy_s": sum(b - a for a, b in tr["busy"]),
               "t_host_s": float(getattr(eng, "t_host", 0.0)) - h0}
        if on:
            causes = {k: v - c0[k] for k, v in eng.host_causes.items()}
            n_host = eng.n_replayed + getattr(eng, "n_mate_filtered", 0) - r0
            ctx = {"layout": layout, "pass_reads": tr["n"] * per,
                   "window_reads": tr["n"] * per,
                   "window_s": tr["window_s"], "spans": tr["spans"],
                   "trace": {"busy": tr["busy"],
                             "trace_start_ns": tr["trace_start_ns"]},
                   "counters": {"host_stale": causes["stale"]}}
            tot = {k: v[1] for k, v in obs.totals(tr["spans"]).items()}
            off = offsets(ctx, tr["d2h"], ("engine.collect",))
            calls = offsets(ctx, tr["memcpy_calls"],
                            ("engine.h2d", "engine.collect"))
            row.update(
                memcpy_calls=len(calls),
                memcpy_call_max_offset_ms=max(calls, default=0),
                metrics={k: f(ctx) for k, f in
                         program_spans.READERS.items()},
                idle_by_span=program_spans.idle_by_span(ctx),
                d2h_copies=len(off), d2h_max_offset_ms=max(off, default=0),
                host_causes=causes, host_units=n_host,
                causes_add_up=sum(causes.values()) == n_host,
                host_spans_s=sum(tot.get(k, 0.0) for k in
                                 ("host.sync", "host.align", "host.select")),
                span_totals_s=tot, records=len(tr["spans"]["records"]))
        print(json.dumps(row), file=sys.stderr, flush=True)
        if on:
            row["raw"] = {k: tr[k] for k in ("busy", "d2h", "memcpy_calls",
                                             "trace_start_ns", "spans")}
        out["passes"].append(row)
    port.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=6)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from spec import load_cell
    out = probe(load_cell(args.workload), args.seed, args.passes)
    if args.out:
        with (gzip.open if args.out.endswith(".gz") else open)(
                args.out, "wt") as f:
            json.dump(out, f)
    for row in out["passes"]:
        row.pop("raw", None)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
