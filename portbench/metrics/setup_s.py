"""From the process's start to the window's: imports, the kernel library's
load (its build on a checkout's first run), the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
