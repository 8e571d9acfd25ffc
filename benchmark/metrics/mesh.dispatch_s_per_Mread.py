"""Σ of the align loop's ``engine.stripe`` spans (``bsmap_tpu_torch``'s
``parallel/sharded.py`` under ``obs``: each stripe's H2D, program enqueue
and gather enqueue) per million reads of the traced pass: the serial host
cost of feeding the cards.  None without the mesh engine's spans (a
single-device engine, or a program without these spans)."""

from program_spans import loop_tid, records


def read(ctx):
    recs = records(ctx)
    tid = recs and loop_tid(recs)
    if tid is None:
        return None
    spans = [r for r in recs
             if r["name"] == "engine.stripe" and r["tid"] == tid]
    if not spans:
        return None
    s = sum(r["end_ns"] - r["start_ns"] for r in spans) / 1e9
    return s / (ctx["pass_reads"] / 1e6)
