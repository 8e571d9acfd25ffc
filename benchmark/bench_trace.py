"""A traced pass: one whole pipeline pass under ``torch.profiler``, reduced
to the device's busy intervals and busy time and the time of its
operations by name; with the profiler's start on the epoch clock, so that
the port's own spans (``program_spans``) can name the idle time between
the busy intervals."""

from __future__ import annotations

import time


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def traced_pass(run, device: str = "cuda") -> dict:
    """Profile ``run()`` (one pipeline pass, which returns its reads or
    pairs) and reduce the trace.  Times are seconds, intervals from the
    profiler's start (``trace_start_ns``, epoch ns); on a CPU run the
    device readings are empty or zero."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = run()
        if device == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, by_name = [], {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            a, b = ev.time_range.start / 1e6, ev.time_range.end / 1e6
            dev.append((a, b))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
    busy = _union(dev)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"n": n, "window_s": window,
            "busy": [list(iv) for iv in busy],
            "busy_s": sum(b - a for a, b in busy),
            "trace_start_ns": prof.profiler.kineto_results.trace_start_ns(),
            "device_op_s": sum(by_name.values()),
            "device_ops": [[k, v] for k, v in ops[:10]]}
