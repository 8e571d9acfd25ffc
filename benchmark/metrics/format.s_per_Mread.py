"""Native SAM formatting and the write of one pass's aligned blocks
(``format_aligned_block``, or ``emit_block`` less the host engine's
seconds in it), timed alone: seconds per million reads."""


def read(ctx):
    st = ctx.get("stages")
    if not st:
        return None
    return (st["format_s"] - st["host_s"]) / (ctx["pass_reads"] / 1e6)
