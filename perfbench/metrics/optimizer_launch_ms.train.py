"""optimizer_launch_ms.train: the host's ms a train step spends in the
program's span ``train/optimizer`` (opened inside the optimizer's own
``update``, so no wait a caller puts around it counts: the launches of
AdamW's loop), per ``train/step`` span of the traced window, from the
program's span store. Read on a CUDA device only."""
import program_spans

RANGES = program_spans.own("train/optimizer", "train/step")


def read(ctx):
    return program_spans.host_ms_on_card(ctx, "train/optimizer", "train/step")
