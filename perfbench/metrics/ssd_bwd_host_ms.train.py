"""ssd_bwd_host_ms.train: the host's ms a train step spends in the program's
span ``kernels/ssd.chunk_bwd`` (``ops.SSDChunk.backward``, the plain
recompute and its gradient, launched from the autograd engine's thread),
summed over the step's layers, per ``train/step`` span of the traced
window, from the program's span store. Read on a CUDA device only."""
import program_spans

RANGES = program_spans.own("kernels/ssd.chunk_bwd", "train/step")


def read(ctx):
    return program_spans.host_ms_on_card(ctx, "kernels/ssd.chunk_bwd", "train/step")
