"""Device operations (kernels, copies, fills) per call in the traced
window."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches / ctx.trace.calls
