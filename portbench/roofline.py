"""The yardstick of the kernel layer: the card's published rates and
the least time of each analysis's device work, whatever implements it.

Frozen copies of ``chip_smoke.py``'s ``CARD_RATES``,
``FLOPS_PER_ATOM_FRAME``, ``FLOPS_PER_FRAME``, ``FLOPS_PER_PAIR``,
``FLOPS_PER_BINNED_PAIR``, ``bound_ms`` and ``ph_bound_ms``, rewritten to
take shapes and counts instead of the program's tensors.  Each input
byte is read once and each output byte written once; the least time is
the larger of bytes over the memory rate and operations over the
float32 rate (NVIDIA's data sheets, dense, without the tensor cores).
"""

from __future__ import annotations

# (name substring, memory bytes/s, float32 flop/s), first match wins
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),          # H100 SXM5 (80GB HBM3)
    ("H200", 4.8e12, 67e12),
)

# Aligned moments per atom-frame: dequant 3, COM 6, correlation 18,
# centre 3, rotate 15, deviation + masks 9, sums 9; per frame the QCP
# solve (~40 Newton steps + adjugate).
FLOPS_PER_ATOM_FRAME = 63
FLOPS_PER_FRAME = 1000

# Pair histogram per pair: per axis sub, div, rint, mul, sub, square
# (18), two adds, sqrt, the two range compares; per pair inside the
# range: sub, mul, floor, two clamps and two edge compares.
FLOPS_PER_PAIR = 23
FLOPS_PER_BINNED_PAIR = 7

WIRE_BYTES = {"int8": 1, "int16": 2, "float32": 4}


def card_rates(name: str) -> tuple[float, float]:
    """(bytes/s, flop/s) of the card named ``name``; the H100 SXM's
    when no entry matches."""
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    return CARD_RATES[2][1], CARD_RATES[2][2]


def aligned_moments_s(frames: int, atoms: int, wire: str, bw: float,
                      flops: float) -> float:
    """Least time of one aligned-moments pass over a block of
    ``frames`` frames of ``atoms`` selected atoms on the ``wire``: the
    three coordinate planes, the per-block scale, the weights, the
    reference (3 a atom), the atom mask, Σref, the frame mask read once
    and six sums an atom written once."""
    nbytes = (3 * frames * atoms * WIRE_BYTES[wire] + 4
              + 4 * (atoms + 3 * atoms + atoms + 3 + frames)
              + 6 * atoms * 4)
    ops = FLOPS_PER_ATOM_FRAME * frames * atoms + FLOPS_PER_FRAME * frames
    return max(nbytes / bw, ops / flops)


def pair_histogram_s(frames: int, n_a: int, n_b: int, nbins: int,
                     binned: float, bw: float, flops: float) -> float:
    """Least time of one pair histogram over a block of ``frames``
    frames: both coordinate sets, the box lengths and the edges read
    once, the uint64 counts written once, against the operations of
    every pair plus those of the ``binned`` pairs inside the range."""
    nbytes = ((frames * n_a + frames * n_b) * 3 * 4 + frames * 3 * 4
              + (nbins + 1) * 4 + frames * nbins * 8)
    ops = FLOPS_PER_PAIR * frames * n_a * n_b + FLOPS_PER_BINNED_PAIR * binned
    return max(nbytes / bw, ops / flops)


def blocks(n_frames: int, batch: int):
    """The frame counts of the blocks ``n_frames`` frames are staged in."""
    full, rest = divmod(n_frames, batch)
    return [batch] * full + ([rest] if rest else [])
