"""Model operations of every optimizer step in the window (forward and
backward over each batch's live rows, `work/alignn.py`) over the window's
wall time × the device's peak, in %."""


def read(ctx):
    if not ctx.model_flops:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * ctx.peak_flops)
