"""Share of the traced pass that the engine sent to the host route:
(``n_replayed`` + ``n_mate_filtered``) over the pass's reads, or, pair-end,
over its pairs (the engine counts pairs, and both mates of such a pair go
to the host), in percent."""


def read(ctx):
    c = ctx.get("counters")
    if c is None:
        return None
    units = ctx["window_reads"] // (2 if ctx["layout"] == "pe" else 1)
    return 100.0 * (c["n_replayed"] + c["n_mate_filtered"]) / units
