"""norm_wait_ms.train: the host's ms a train step spends in the program's
span ``train/global_norm`` (``repro_torch.train.step.global_norm``, where
the step copies a host zero to the card and so waits for the work queued
before it), per ``train/step`` span of the traced window, from the
program's span store. Read on a CUDA device only."""
import program_spans

RANGES = program_spans.own("train/global_norm", "train/step")


def read(ctx):
    return program_spans.host_ms_on_card(ctx, "train/global_norm", "train/step")
