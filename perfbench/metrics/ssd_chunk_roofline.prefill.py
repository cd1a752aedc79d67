"""ssd_chunk_roofline.prefill: the least time of every SSD chunk step
forward in the traced window (``work.ssd_step_call`` from the shapes the
program's ``kernels/ssd.chunk_fwd`` spans record: x's shape, the state size
and the chunk; its float32 products at ``work.PEAK_F32_PRODUCT_FLOPS``,
495/3 TFLOP/s, or its inputs read and outputs written once at HBM
bandwidth, whichever is larger) over the device time of the operations
launched inside those spans, in %. The chunk kernel alone: the inter-chunk
part of the op (``kernels/ssd.scan``) is outside the span."""
import program_spans

SPAN = "kernels/ssd.chunk_fwd"
RANGES = program_spans.own(SPAN, "serve/prefill")


def read(ctx):
    import work

    device_s = ctx.trace["device_s"].get(SPAN) if ctx.trace is not None else None
    calls = [s for s in program_spans.stored(ctx) or () if s.name == SPAN]
    if not device_s or not calls:
        return None
    least = sum(work.least_time(*work.ssd_step_call(s.attrs["x"], s.attrs["n"], s.attrs["chunk"],
                                                    backward=False),
                                work.PEAK_F32_PRODUCT_FLOPS) for s in calls)
    return 100.0 * least / device_s
