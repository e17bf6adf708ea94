"""stage_wait_share.rdf: the program's `stage_wait` timer (the
dispatching thread blocked on the next staged block), summed over the
window's InterRDF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "stage_wait", "inter_rdf")
