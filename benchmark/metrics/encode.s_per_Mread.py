"""Native FilterReads and encode of one pass's blocks (``encode_block``,
``encode_block_pair``, one thread), timed alone: seconds per million
reads."""


def read(ctx):
    st = ctx.get("stages")
    return st["encode_s"] / (ctx["pass_reads"] / 1e6) if st else None
