"""The engine over one pass's encoded blocks (``DeviceEngine.align_block``
and its finish, or ``PairDeviceEngine.align_block_pair`` and its collect),
ending in a device synchronise, timed alone: seconds per million reads."""


def read(ctx):
    st = ctx.get("stages")
    return st["align_s"] / (ctx["pass_reads"] / 1e6) if st else None
