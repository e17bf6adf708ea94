"""wire_share.rmsf: the program's `wire` timer (each staged block's
copy to the card, queued on the staging thread), summed over the
window's AlignedRMSF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "wire", "aligned_rmsf")
