"""round_s: the window's wall time over the whole rounds completed in it
(host clock; each round ends when its statistics reach the host)."""


def read(ctx):
    return ctx.round_s
