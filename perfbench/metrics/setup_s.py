"""setup_s: process start to the window's start (import, the kernels'
build or load, weights from the seed, warm-up), on the host's clock."""


def read(ctx):
    return ctx.setup_s
