"""The attention backward's share of its roofline: the least seconds of
every launch in the window (`work/alignn.py`, at the device's peaks) over
the device seconds of the op's kernels (`work/patterns/`), in %. Nothing
when no kernel of the op ran."""


def read(ctx):
    busy = ctx.by_op.get("attn_bwd", 0.0)
    if busy <= 0 or not ctx.work.get("attn_bwd"):
        return None
    return 100.0 * ctx.work["attn_bwd"] / busy
