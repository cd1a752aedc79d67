"""ssd_roofline.prefill: the least time of every chunked SSD scan in the
traced window (``work.ssd_chunks_call`` from the shapes passed to
``repro_torch.kernels.ops.ssd_chunks``: its float32 products at
``work.PEAK_F32_PRODUCT_FLOPS``, 495/3 TFLOP/s, or its inputs read and
outputs written once at HBM bandwidth, whichever is larger) over the device
time of the operations launched inside those calls, in %."""


def _work(xh, bmat, cmat, da, chunk=128, backend="auto"):
    import work

    flops, nbytes = work.ssd_chunks_call(tuple(xh.shape), bmat.shape[-1], chunk)
    return work.least_time(flops, nbytes, work.PEAK_F32_PRODUCT_FLOPS)


RANGES = {"kernels.ssd": {"target": "repro_torch.kernels.ops:ssd_chunks", "work": _work}}


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_s"].get("kernels.ssd"):
        return None
    return 100.0 * sum(ctx.ranges.work["kernels.ssd"]) / t["device_s"]["kernels.ssd"]
