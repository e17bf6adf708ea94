"""dispatch_share.rdf: the program's ``dispatch`` timer (the
executor handing each block or captured group to the card), summed
over the window's InterRDF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "dispatch", "inter_rdf")
