"""Spans and instants of the port's own work, kept in memory while a run
asks for them (``cli --trace PATH``, a profiled pass of the benchmark).

    obs.start()
    with obs.block(seq), obs.span("engine.align", rows=len(block)):
        ...
    trace = obs.stop()      # {"anchor": {...}, "records": [...]}

While tracing is off ``span``, ``block`` and ``instant`` return at once:
``span`` and ``block`` hand back one shared object whose ``with`` does
nothing, so the call sites cost a function call and allocate nothing.

While it is on, a span records its name, its thread's name and id, its
start and end (``time.perf_counter_ns``), the thread's CPU time over it
(``time.thread_time_ns``; left out with ``cpu=False``, for the spans
opened once per read, pair or dispatch window, where the clock's system
call would cost a share of the item), its parent span on the same
thread, the sequence number of the block it works on (set by ``block``;
every span of one block shares it, -1 outside any block) and its int
attributes (``rows``, ``bytes``, and ``card``: the mesh entry a mesh
engine's span serves).  Each garbage collection is a span too
(``gc.gen<n>``, on the thread that set it off).  Records live in one list per thread,
registered on the thread's first span.  ``start`` also reads a clock
anchor, an epoch time (``time.time_ns``) and a ``perf_counter_ns`` read
back to back, so that the records can be placed on another epoch
timeline, such as a ``torch.profiler`` trace's
(``kineto_results.trace_start_ns()``).
"""

from __future__ import annotations

import gc
import json
import threading
import time

_on = False
_gen = 0                 # bumped by start(): older thread buffers retire
_lock = threading.Lock()
_bufs: list = []         # this generation's thread buffers, in order
_tls = threading.local()
_anchor = {"epoch_ns": 0, "perf_ns": 0, "width_ns": 0}


class _Noop:
    """The object ``span`` and ``block`` return while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


class _Buf:
    """One thread's records, its open spans and its current block."""

    __slots__ = ("gen", "name", "tid", "records", "stack", "seq")

    def __init__(self, gen: int):
        t = threading.current_thread()
        self.gen, self.name, self.tid = gen, t.name, t.ident
        self.records: list = []
        self.stack: list = []
        self.seq = -1


def _buf() -> _Buf:
    b = getattr(_tls, "buf", None)
    if b is None or b.gen != _gen:
        b = _tls.buf = _Buf(_gen)
        with _lock:
            if b.gen == _gen:
                _bufs.append(b)
    return b


class _Span:
    __slots__ = ("name", "buf", "seq", "parent", "rows", "nbytes", "card",
                 "attrs", "cpu", "t0", "t1", "c0", "c1")

    def __init__(self, name: str, rows: int, nbytes: int, cpu: bool,
                 card: int = -1):
        self.name, self.rows, self.nbytes = name, rows, nbytes
        self.card = card
        self.attrs = None
        self.cpu = cpu

    def __enter__(self):
        b = self.buf = _buf()
        self.seq = b.seq
        self.parent = b.stack[-1] if b.stack else None
        b.stack.append(self)
        if self.cpu:
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.cpu:
            self.c1 = time.thread_time_ns()
        b = self.buf
        b.stack.pop()
        b.records.append(self)
        return False


class _Block:
    __slots__ = ("seq", "buf", "prev")

    def __init__(self, seq: int):
        self.seq = seq

    def __enter__(self):
        b = self.buf = _buf()
        self.prev, b.seq = b.seq, self.seq
        return self

    def __exit__(self, *exc) -> bool:
        self.buf.seq = self.prev
        return False


def enabled() -> bool:
    return _on


def span(name: str, rows: int = -1, nbytes: int = -1, cpu: bool = True,
         card: int = -1):
    """A context manager that records ``name`` on this thread while
    tracing is on; ``rows``, ``nbytes`` and ``card`` are its attributes
    (-1: none); ``cpu=False`` leaves the thread's CPU time out (a span
    opened once per read, pair or dispatch window)."""
    if not _on:
        return NOOP
    return _Span(name, rows, nbytes, cpu, card)


def block(seq: int):
    """A context manager under which this thread's spans and instants
    carry block sequence number ``seq``."""
    if not _on:
        return NOOP
    return _Block(seq)


def instant(name: str, **attrs) -> None:
    """Record a point event with int attributes (a kernel launch's work,
    say).  Its keyword arguments allocate a dict: guard the call with
    ``enabled()`` where it sits on a hot path."""
    if not _on:
        return
    sp = _Span(name, -1, -1, False)
    b = sp.buf = _buf()
    sp.seq = b.seq
    sp.parent = b.stack[-1] if b.stack else None
    sp.t0 = sp.t1 = time.perf_counter_ns()
    sp.attrs = attrs
    b.records.append(sp)


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry while tracing is on: each collection a span
    on the thread that set it off."""
    if phase == "start" and _on:
        sp = _gc_open.sp = _Span(f"gc.gen{info['generation']}", -1, -1,
                                  False)
        sp.__enter__()
    elif getattr(_gc_open, "sp", None) is not None:
        _gc_open.sp.__exit__()
        _gc_open.sp = None


_gc_open = threading.local()


def _read_anchor() -> dict:
    """An epoch time and a perf_counter time read back to back: the
    tightest pair of five tries, the perf time at the middle of it."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        e = time.time_ns()
        z = time.perf_counter_ns()
        if best is None or z - a < best["width_ns"]:
            best = {"epoch_ns": e, "perf_ns": (a + z) // 2,
                    "width_ns": z - a}
    return best


def start() -> None:
    """Drop every record and turn tracing on; reads the clock anchor."""
    global _on, _gen, _bufs, _anchor
    with _lock:
        _gen += 1
        _bufs = []
    _anchor = _read_anchor()
    if _gc_span not in gc.callbacks:
        gc.callbacks.append(_gc_span)
    _on = True


def stop() -> dict:
    """Turn tracing off; returns ``{"anchor": {epoch_ns, perf_ns,
    width_ns}, "records": [...]}``, the records in order of start, each a
    dict: name, kind ("span" or "instant"), thread, tid, seq, parent
    (index of the parent record, -1 for none), start_ns, end_ns
    (perf_counter; equal for an instant), cpu_ns (thread CPU time; None
    for an instant and a ``cpu=False`` span), attrs (rows, bytes, card, or
    an instant's attributes).  Spans still open are left out.  The records
    are handed over once: a second ``stop`` returns none."""
    global _on, _gen, _bufs
    _on = False
    if _gc_span in gc.callbacks:
        gc.callbacks.remove(_gc_span)
    with _lock:
        bufs, _bufs = _bufs, []
        _gen += 1
    spans = [(sp, b) for b in bufs for sp in list(b.records)]
    spans.sort(key=lambda x: (x[0].t0, x[0].t1 == x[0].t0))
    index = {id(sp): k for k, (sp, _) in enumerate(spans)}
    records = []
    for sp, b in spans:
        if sp.attrs is not None:
            attrs = dict(sp.attrs)
        else:
            attrs = {}
            if sp.rows >= 0:
                attrs["rows"] = sp.rows
            if sp.nbytes >= 0:
                attrs["bytes"] = sp.nbytes
            if sp.card >= 0:
                attrs["card"] = sp.card
        records.append({
            "name": sp.name,
            "kind": "span" if sp.attrs is None else "instant",
            "thread": b.name, "tid": b.tid, "seq": sp.seq,
            "parent": (-1 if sp.parent is None
                       else index.get(id(sp.parent), -1)),
            "start_ns": sp.t0, "end_ns": sp.t1,
            "cpu_ns": sp.c1 - sp.c0 if sp.cpu else None, "attrs": attrs})
    return {"anchor": dict(_anchor), "records": records}


def to_epoch_ns(trace: dict, perf_ns: int) -> int:
    """A perf_counter time of ``trace`` on the epoch clock."""
    a = trace["anchor"]
    return a["epoch_ns"] + (perf_ns - a["perf_ns"])


def totals(trace: dict) -> dict:
    """Per span name: (count, total seconds, self seconds), self being the
    span's time less its child spans'; instants are left out."""
    recs = trace["records"]
    child = [0] * len(recs)
    for r in recs:
        if r["kind"] == "span" and r["parent"] >= 0:
            child[r["parent"]] += r["end_ns"] - r["start_ns"]
    out: dict = {}
    for k, r in enumerate(recs):
        if r["kind"] != "span":
            continue
        d = r["end_ns"] - r["start_ns"]
        n, tot, own = out.get(r["name"], (0, 0.0, 0.0))
        out[r["name"]] = (n + 1, tot + d / 1e9, own + (d - child[k]) / 1e9)
    return out


def summary(trace: dict) -> list[str]:
    """One line per span name, by total time: count, total and self
    seconds."""
    rows = sorted(totals(trace).items(), key=lambda kv: -kv[1][1])
    return [f"trace: {name:<20} {n:>8} spans {tot:10.3f} s total "
            f"{own:10.3f} s self" for name, (n, tot, own) in rows]


def chrome_trace(trace: dict, counters: dict | None = None) -> dict:
    """The records as Chrome trace-event JSON (chrome://tracing,
    Perfetto): spans as ``X`` events and instants as ``i`` events, on the
    epoch clock in microseconds, each thread named by an ``M`` event; the
    ``counters`` (name -> {series: value}) as ``C`` events at the end."""
    pid = 1
    events = []
    seen = {}
    for r in trace["records"]:
        if r["tid"] not in seen:
            seen[r["tid"]] = r["thread"]
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": r["tid"], "args": {"name": r["thread"]}})
        ts = to_epoch_ns(trace, r["start_ns"]) / 1e3
        args = dict(r["attrs"], seq=r["seq"])
        ev = {"name": r["name"], "pid": pid, "tid": r["tid"], "ts": ts,
              "args": args}
        if r["kind"] == "instant":
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=(r["end_ns"] - r["start_ns"]) / 1e3)
            if r["cpu_ns"] is not None:
                args["cpu_us"] = r["cpu_ns"] / 1e3
        events.append(ev)
    end = max((to_epoch_ns(trace, r["end_ns"]) / 1e3
               for r in trace["records"]), default=0.0)
    for name, series in (counters or {}).items():
        events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                       "ts": end, "args": dict(series)})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, trace: dict,
                       counters: dict | None = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(trace, counters), f)
