"""stage_share.rdf: the program's ``stage`` timer (host staging:
the readers, the store, quantization and the copy to the card), summed
over the window's InterRDF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "stage", "inter_rdf")
