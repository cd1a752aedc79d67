"""device_idle.prefill: the share of the traced window in which no operation
runs on the device (one less the union of the operations' times over the
window), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
