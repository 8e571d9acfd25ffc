"""Native parse of one pass's blocks (``BlockReadStream.next_block``, one
thread), timed alone: seconds per million reads."""


def read(ctx):
    st = ctx.get("stages")
    return st["parse_s"] / (ctx["pass_reads"] / 1e6) if st else None
