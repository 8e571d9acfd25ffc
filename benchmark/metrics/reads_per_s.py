"""Reads aligned and written over the window (a pair-end mate counts as
one read): all reads of all passes over the wall time from the window's
start to the end of its last pass."""


def read(ctx):
    if "trace" in ctx:
        return None
    return ctx["window_reads"] / ctx["window_s"]
