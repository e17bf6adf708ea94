"""gather_share.rmsf: the program's `gather` timer (the selection
gather and int16 quantize of each staged block: the native kernel
from memory, the raw chunk slices from a store), summed over the
window's AlignedRMSF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "gather", "aligned_rmsf")
