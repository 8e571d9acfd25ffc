"""Device time of every kernel, copy and fill over one traced pipeline
pass (torch.profiler), in milliseconds per million reads; the breakdown
lists them by name."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["device_op_s"] <= 0:
        return None
    return 1e3 * tr["device_op_s"] / (ctx["window_reads"] / 1e6)
