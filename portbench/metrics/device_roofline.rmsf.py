"""device_roofline.rmsf: the least time of the traced window's
AlignedRMSF work (:mod:`portbench.roofline`) over the device time of every
kernel in the window, in %."""

from portbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "aligned_rmsf")
