"""Engine construction in set-up: the tables put on the card
(``tables_from_numpy``) and the kernel libraries loaded, in seconds."""


def read(ctx):
    return ctx["engine_s"]
