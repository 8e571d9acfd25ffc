"""The port's own spans (``bsmap_tpu_torch.obs``) of one traced pass, placed
on the device's timeline, and the per-layer numbers read from them.

A run's ``ctx`` carries, beside the keys the harness fills:

  ``spans``   ``obs.stop()``'s result for the traced pass: ``anchor``
              (an epoch time and a ``perf_counter`` time read together)
              and ``records`` (name, kind, thread id, parent, start and
              end in ``perf_counter`` ns, the thread's CPU ns where the
              span read it, ...);
  ``trace``   ``busy``, the device's busy intervals in seconds from the
              profiler's start, and ``trace_start_ns``, that start in
              epoch ns (``kineto_results.trace_start_ns()``).

The align loop is the thread of the pass's root span, ``pipe.pass``.
Every reader returns None where ``ctx`` has no spans (a program without
``obs``), and never raises for it.
"""

from __future__ import annotations

def records(ctx) -> list | None:
    sp = ctx.get("spans")
    return sp["records"] if sp and sp.get("records") else None


def loop_tid(recs) -> int | None:
    """The align loop's thread: the one that ran ``pipe.pass``."""
    for r in recs:
        if r["name"] == "pipe.pass":
            return r["tid"]
    return None


def _dur(r) -> float:
    return (r["end_ns"] - r["start_ns"]) / 1e9


def _sum(recs, name: str, tid: int | None = None) -> float:
    return sum(_dur(r) for r in recs if r["name"] == name
               and (tid is None or r["tid"] == tid))


def _per_mread(ctx, seconds: float) -> float:
    return seconds / (ctx["pass_reads"] / 1e6)


def input_wait_share(ctx):
    """Share of the traced window the align loop spent waiting for its
    next encoded block (``pipe.input_wait``), in percent."""
    recs = records(ctx)
    tid = recs and loop_tid(recs)
    if tid is None:
        return None
    return 100.0 * _sum(recs, "pipe.input_wait", tid) / ctx["window_s"]


def _ancestor_ids(recs, k: int):
    while (k := recs[k]["parent"]) >= 0:
        yield k


def _ancestors(recs, k: int):
    return (recs[j] for j in _ancestor_ids(recs, k))


def engine_s_per_Mread(ctx):
    """The align loop's ``engine.align`` and ``engine.finish`` trees less
    the ``engine.collect`` spans in them (the copies back and the waits
    for the card): the engine's host side in the pipeline, s/Mreads."""
    recs = records(ctx)
    tid = recs and loop_tid(recs)
    if tid is None:
        return None
    roots = ("engine.align", "engine.finish")
    total = 0.0
    for k, r in enumerate(recs):
        if r["tid"] != tid:
            continue
        up = [a["name"] for a in _ancestors(recs, k)]
        inside = any(n in roots for n in up)
        if r["name"] in roots and not inside:
            total += _dur(r)
        elif r["name"] == "engine.collect" and inside:
            total -= _dur(r)
    return _per_mread(ctx, total)


def offcpu_share(ctx):
    """1 - thread CPU / wall over the align loop's own time in its spans
    but its waits (``pipe.*_wait``) and ``engine.collect``: time with work
    in hand and no CPU (the GIL, page faults), in percent.  A span that
    read no CPU time (a per-pair span, a collection) counts as its
    nearest ancestor's own time."""
    recs = records(ctx)
    tid = recs and loop_tid(recs)
    if tid is None:
        return None
    timed = [r["tid"] == tid and r["cpu_ns"] is not None for r in recs]
    wall = [0.0] * len(recs)
    cpu = [0.0] * len(recs)
    for k, r in enumerate(recs):
        if not timed[k]:
            continue
        wall[k] += _dur(r)
        cpu[k] += r["cpu_ns"] / 1e9
        up = next((j for j in _ancestor_ids(recs, k) if timed[j]), -1)
        if up >= 0:
            wall[up] -= _dur(r)
            cpu[up] -= r["cpu_ns"] / 1e9
    keep = [k for k, r in enumerate(recs)
            if timed[k] and not (r["name"].startswith("pipe.")
                                 and r["name"].endswith("_wait"))
            and r["name"] != "engine.collect"]
    w = sum(wall[k] for k in keep)
    if w <= 0:
        return None
    return 100.0 * (1.0 - sum(cpu[k] for k in keep) / w)


def _any_thread(name: str):
    def read(ctx):
        recs = records(ctx)
        if recs is None:
            return None
        return _per_mread(ctx, _sum(recs, name))
    read.__doc__ = f"Σ ``{name}`` on any thread, s/Mreads."
    return read


def stale_share(ctx):
    """Units (reads; pairs pair-end) sent to the host route for a stale
    seed schedule, first of their causes, over the pass's units, in
    percent (``host_causes["stale"]``, counted as ``host_stale``)."""
    c = ctx.get("counters") or {}
    if "host_stale" not in c:
        return None
    units = ctx["window_reads"] // (2 if ctx["layout"] == "pe" else 1)
    return 100.0 * c["host_stale"] / units


READERS = {
    "loop.input_wait_share": input_wait_share,
    "loop.engine_s_per_Mread": engine_s_per_Mread,
    "loop.offcpu_share": offcpu_share,
    "engine.collect_wait_s_per_Mread": _any_thread("engine.collect"),
    "host.sync_s_per_Mread": _any_thread("host.sync"),
    "host.align_s_per_Mread": _any_thread("host.align"),
    "host.stale_share": stale_share,
}


def on_device_clock(ctx, perf_ns: int) -> float:
    """A ``perf_counter`` ns time of the spans in seconds on the
    profiler's timeline."""
    a = ctx["spans"]["anchor"]
    lead = a["epoch_ns"] - ctx["trace"]["trace_start_ns"]
    return (lead + perf_ns - a["perf_ns"]) / 1e9


def _innermost(recs, tid: int, ctx):
    """The align loop's time cut into (start, end, innermost open span)
    pieces, in seconds on the device timeline, in order."""
    kids: dict = {}
    roots = []
    for k, r in enumerate(recs):
        if r["tid"] == tid and r["kind"] == "span":
            p = r["parent"]
            (kids.setdefault(p, []) if p >= 0 else roots).append(k)
    out = []

    def walk(k):
        r = recs[k]
        t = r["start_ns"]
        for c in sorted(kids.get(k, []), key=lambda c: recs[c]["start_ns"]):
            out.append((t, recs[c]["start_ns"], r["name"]))
            walk(c)
            t = recs[c]["end_ns"]
        out.append((t, r["end_ns"], r["name"]))

    for k in sorted(roots, key=lambda k: recs[k]["start_ns"]):
        walk(k)
    return [(on_device_clock(ctx, a), on_device_clock(ctx, b), n)
            for a, b, n in out if b > a]


def idle_intervals(busy, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for a, b in sorted(busy):
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def idle_by_span(ctx, top: int = 10):
    """The device's idle time over the traced window, divided by the span
    the align loop was innermost in (``loop:<span>``; ``loop:none`` where
    it was in none): the ``top`` largest as [label, seconds].  The window
    ends with the pass's span or the device's last busy interval,
    whichever is later, and is ``window_s`` long (it starts before the
    pass's span where the pass's set-up came first), edges included."""
    recs = records(ctx)
    tid = recs and loop_tid(recs)
    busy = (ctx.get("trace") or {}).get("busy")
    if tid is None or busy is None:
        return None
    root = next(r for r in recs if r["name"] == "pipe.pass")
    hi = max([on_device_clock(ctx, root["end_ns"])]
             + [b for _, b in busy])
    lo = min(on_device_clock(ctx, root["start_ns"]), hi - ctx["window_s"])
    idle = idle_intervals(busy, lo, hi)
    pieces = _innermost(recs, tid, ctx)
    acc: dict = {}
    j = 0
    for a, b in idle:
        t = a
        while t < b:
            while j < len(pieces) and pieces[j][1] <= t:
                j += 1
            if j == len(pieces) or pieces[j][0] >= b:
                acc["loop:none"] = acc.get("loop:none", 0.0) + b - t
                break
            pa, pb, name = pieces[j]
            if pa > t:                    # a stretch in no span
                acc["loop:none"] = acc.get("loop:none", 0.0) + pa - t
                t = pa
            end = min(pb, b)
            acc["loop:" + name] = acc.get("loop:" + name, 0.0) + end - t
            t = end
    ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]
