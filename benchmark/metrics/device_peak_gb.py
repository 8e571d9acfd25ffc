"""torch.cuda.max_memory_allocated() over set-up and window, in GB (10^9
bytes)."""


def read(ctx):
    b = ctx["device_peak_bytes"]
    return b / 1e9 if b else None
