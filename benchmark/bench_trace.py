"""A traced pass: one whole pipeline pass under ``torch.profiler``, with a
span around each layer's entry point (``Port.spans``), reduced to the
device's busy time, the time of its operations by name, and its longest
idle gaps labelled by the span the host was in."""

from __future__ import annotations

import contextlib
import functools
import time


def _wrap(fn, label: str):
    import torch

    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function("bench:" + label):
            return fn(*a, **k)
    return inner


@contextlib.contextmanager
def layer_spans(spans):
    """Wrap each (object, attribute, name) in a profiler span for the
    duration of the block."""
    saved = []
    try:
        for obj, attr, label in spans:
            saved.append((obj, attr, obj.__dict__.get(attr)))
            setattr(obj, attr, _wrap(getattr(obj, attr), label))
        yield
    finally:
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def traced_pass(run, spans, device: str = "cuda") -> dict:
    """Profile ``run()`` (one pipeline pass, which returns its reads or
    pairs) and reduce the trace (times in seconds; on a CPU run the device
    readings are zero)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with layer_spans(spans), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = run()
        if device == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, by_name, host = [], {}, []
    for ev in prof.events():
        a, b = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.name.startswith("bench:"):
            if ev.device_type.name != "CUDA":   # not its device-side copy
                host.append((a, b, ev.name[len("bench:"):]))
        elif ev.device_type.name == "CUDA":
            dev.append((a, b))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
    busy = _union(dev)
    gaps = []
    for (a0, b0), (a1, b1) in zip(busy, busy[1:]):
        gaps.append((a1 - b0, b0, a1))
    gaps.sort(reverse=True)
    labelled = []
    for g, a, b in gaps[:10]:
        best, label = 0.0, "none"
        for ha, hb, name in host:
            ov = min(hb, b) - max(ha, a)
            if ov > best:
                best, label = ov, name
        labelled.append([label, g])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"n": n, "window_s": window,
            "busy_s": sum(b - a for a, b in busy),
            "device_op_s": sum(by_name.values()),
            "device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": labelled}
