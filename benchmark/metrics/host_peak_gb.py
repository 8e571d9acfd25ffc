"""The process's peak resident memory (ru_maxrss, the kernel's VmHWM) when the window ends, in GB
(10^9 bytes); inputs are made in child processes and not counted."""


def read(ctx):
    return ctx["host_peak_bytes"] / 1e9
