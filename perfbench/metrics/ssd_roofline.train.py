"""ssd_roofline.train: the least time of the SSD chunk step's forward calls
and of their gradients in the traced window (``work.ssd_step_call`` from the
shapes passed to ``repro_torch.kernels.ops.SSDChunk``'s forward and
backward: the products at ``work.PEAK_F32_PRODUCT_FLOPS``, 495/3 TFLOP/s,
two for each of the forward's in the gradient, or the bytes in and out once
at HBM bandwidth, whichever is larger) over the device time of the
operations launched inside them, in %. A forward recomputed in the backward
is a call, and counts."""


def _fwd(ctx, x, bmat, cmat, da, chunk, backend):
    import work

    flops, nbytes = work.ssd_step_call(tuple(x.shape), bmat.shape[-1], chunk, backward=False)
    return work.least_time(flops, nbytes, work.PEAK_F32_PRODUCT_FLOPS)


def _bwd(ctx, d_y, d_states, d_cum):
    import work

    chunk = d_y.shape[1] // d_states.shape[1]
    flops, nbytes = work.ssd_step_call(tuple(d_y.shape), d_states.shape[-1], chunk,
                                       backward=True)
    return work.least_time(flops, nbytes, work.PEAK_F32_PRODUCT_FLOPS)


RANGES = {"kernels.ssd_fwd": {"target": "repro_torch.kernels.ops:SSDChunk.forward", "work": _fwd},
          "kernels.ssd_bwd": {"target": "repro_torch.kernels.ops:SSDChunk.backward",
                              "work": _bwd}}


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dev = sum(t["device_s"].get(k, 0.0) for k in RANGES)
    if dev <= 0:
        return None
    return 100.0 * sum(sum(ctx.ranges.work[k]) for k in RANGES) / dev
