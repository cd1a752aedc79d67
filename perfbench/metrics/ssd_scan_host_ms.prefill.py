"""ssd_scan_host_ms.prefill: the host's ms a prefill call spends in the
program's span ``kernels/ssd.scan`` (``ops.ssd_chunks``' inter-chunk loop
and off-diagonal term in plain torch), summed over the call's layers, per
``serve/prefill`` span of the traced window, from the program's span
store. Read on a CUDA device only."""
import program_spans

RANGES = program_spans.own("kernels/ssd.scan", "serve/prefill")


def read(ctx):
    return program_spans.host_ms_on_card(ctx, "kernels/ssd.scan", "serve/prefill")
