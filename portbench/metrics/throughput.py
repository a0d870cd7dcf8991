"""Input samples of every call completed in the window over the window's
seconds, from the first call's start to the last call's synchronise."""


def read(ctx):
    t0, t1 = ctx.spans[0][0], ctx.spans[-1][2]
    return ctx.samples_per_call * len(ctx.spans) / (t1 - t0) / 1e6
