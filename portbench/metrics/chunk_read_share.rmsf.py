"""chunk_read_share.rmsf: the program's `chunk_read` timer (the block
store's chunk fetch and decode, once a chunk read), summed over the
window's AlignedRMSF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "chunk_read", "aligned_rmsf")
