"""Share of the traced window in which no operation ran on the device: one
minus the union of the device's kernel, copy and set intervals inside the
window (the trace's margins excluded), in %."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
