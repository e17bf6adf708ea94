"""rdf_frames_per_s: every frame of the window's InterRDF analyses over
the time from the window's start to the end of its last analysis."""

from portbench.metrics import rate


def read(ctx):
    return rate(ctx, "inter_rdf")
