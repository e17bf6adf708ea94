"""device_idle.rdf: the share of the traced window in which no
kernel, copy or memset ran on the card, in %."""

from portbench.metrics import idle_share


def read(ctx):
    return idle_share(ctx, "inter_rdf")
