"""mfu.train: model FLOPs of every train step that finished in the traced
window (``work.train_flops``: forward and backward, the head and loss at
every position, no recompute), over the traced window times the bf16 dense
peak, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.record["all_steps"]:
        return None
    mix = ctx.cell.mix
    flops = ctx.record["all_steps"] * ctx.work.train_flops(ctx.prog, mix["batch"], mix["seq_len"])
    return 100.0 * flops / (ctx.trace["window_s"] * ctx.work.PEAK_BF16_FLOPS)
