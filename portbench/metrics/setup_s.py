"""setup_s: from the command's start to the window's: the kernels'
build or load, the frames made on the card and copied to the host, the
source's set-up (a store's ingest) and the warm-up analysis."""


def read(ctx):
    return ctx.setup_s
