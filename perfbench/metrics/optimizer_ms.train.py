"""optimizer_ms.train: the host's wall time of the optimizer's update per
step in the traced window, each call opened and closed by
``torch.cuda.synchronize()``, in ms."""

RANGES = {"train.optimizer": {"target": "entry:optimizer_update", "sync": True}}


def read(ctx):
    if ctx.ranges is None or not ctx.ranges.host_s["train.optimizer"]:
        return None
    s = ctx.ranges.host_s["train.optimizer"]
    return 1e3 * sum(s) / len(s)
