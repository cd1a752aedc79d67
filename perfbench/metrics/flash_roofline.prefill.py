"""flash_roofline.prefill: the least time of every attention call in the
traced window (``work.flash_call`` from the shapes passed to
``repro_torch.kernels.ops.flash_attention``: the causal pairs' products at
the bf16 dense peak, or q, k, v read and out written once at HBM bandwidth,
whichever is larger) over the device time of the operations launched inside
those calls, in %."""

BYTES = {"torch.bfloat16": 2, "torch.float32": 4}


def _work(q, k, v, causal=True, backend="auto", offset=0):
    import work

    if offset:
        raise ValueError("flash_roofline: an offset causal mask is not counted")
    flops, nbytes = work.flash_call(tuple(q.shape), tuple(k.shape), causal, BYTES[str(q.dtype)])
    return work.least_time(flops, nbytes, work.PEAK_BF16_FLOPS if q.dtype.itemsize == 2
                           else work.PEAK_F32_PRODUCT_FLOPS)


RANGES = {"kernels.flash": {"target": "repro_torch.kernels.ops:flash_attention", "work": _work}}


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_s"].get("kernels.flash"):
        return None
    return 100.0 * sum(ctx.ranges.work["kernels.flash"]) / t["device_s"]["kernels.flash"]
