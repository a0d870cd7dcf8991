"""Mean host time of the window's calls from a call's start until the
entry point returns, before the synchronise: the benchmark's span around
the call into the entry-point layer."""


def read(ctx):
    return sum(t1 - t0 for t0, t1, _ in ctx.spans) / len(ctx.spans) * 1e3
