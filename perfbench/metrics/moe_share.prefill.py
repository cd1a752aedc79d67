"""moe_share.prefill: the share of the device's busy time spent in operations
launched inside the MoE block (``repro_torch.models.moe.apply_moe``: router,
top-k, dispatch positions, scatter, expert products, combine), in %."""

RANGES = {"models.moe": {"target": "repro_torch.models.moe:apply_moe"}}


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_s"].get("models.moe") or t["busy_s"] <= 0:
        return None
    return 100.0 * t["device_s"]["models.moe"] / t["busy_s"]
