"""repack_share.rmsf: the program's `repack` timer (each staged
block's interleaved-to-planar repack on the host), summed over the
window's AlignedRMSF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "repack", "aligned_rmsf")
