"""stage_wait_share.rmsf: the program's `stage_wait` timer (the
dispatching thread blocked on the next staged block: staging on the
critical path), summed over the window's AlignedRMSF analyses, as a
share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "stage_wait", "aligned_rmsf")
