"""A call's least time on the card (its work from shapes, ``peaks.least``)
over its summed device time in the traced window, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.device_s <= 0:
        return None
    return 100.0 * ctx.work["least_s"] / (ctx.trace.device_s / ctx.trace.calls)
