"""The 95th percentile (nearest rank) over all calls of the window, each
timed on the host clock from its start to the synchronise after it."""

import math


def read(ctx):
    durations = sorted(t2 - t0 for t0, _, t2 in ctx.spans)
    return durations[math.ceil(0.95 * len(durations)) - 1] * 1e3
