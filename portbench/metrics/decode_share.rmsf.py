"""decode_share.rmsf: the program's `decode` timer (every native XTC
decode made while staging a block, inside `gather`: the fused decode
and int16 quantize, its re-run when the adaptive scale overflows, and
the float32 read that seeds a fresh reader's scale), summed over the
window's AlignedRMSF analyses, as a share of the window."""

from portbench.metrics import phase_share


def read(ctx):
    return phase_share(ctx, "decode", "aligned_rmsf")
