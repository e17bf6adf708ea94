"""device_roofline.rdf: the least time of the traced window's
InterRDF work (:mod:`portbench.roofline`) over the device time of every
kernel in the window, in %."""

from portbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "inter_rdf")
