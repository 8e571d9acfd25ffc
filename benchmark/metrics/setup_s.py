"""The port's set-up: genome and index from the cache, the engine with its
tables on the card and its kernel libraries, and one warm-up pass."""


def read(ctx):
    return ctx["setup_s"]
