"""Pair-end only: the host engine's seconds (``PairDeviceEngine.t_host``:
replayed pairs and pairs with a filtered mate) in one pass's
``emit_block`` calls, per million reads."""


def read(ctx):
    st = ctx.get("stages")
    if not st or ctx["layout"] != "pe":
        return None
    return st["host_s"] / (ctx["pass_reads"] / 1e6)
