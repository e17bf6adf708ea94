"""pass1_share.rmsf: the program's `pass1` timer (AlignedRMSF's
first pass, the average structure: the only pass that stages, as the
second reads the blocks the first left on the card), summed over the
window's AlignedRMSF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "pass1", "aligned_rmsf")
