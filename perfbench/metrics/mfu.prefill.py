"""mfu.prefill: model FLOPs of the real prompt tokens of every group that
finished in the traced window (``work.prefill_flops``: each prompt at its own
length, the head at its last position), over the traced window times the
bf16 dense peak, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.record["all_done"]:
        return None
    flops = sum(ctx.work.prefill_flops(ctx.prog, n) for n in ctx.record["all_done"])
    return 100.0 * flops / (ctx.trace["window_s"] * ctx.work.PEAK_BF16_FLOPS)
