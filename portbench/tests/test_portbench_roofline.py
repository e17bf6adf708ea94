"""The frozen roofline functions against counts made by hand."""

import pytest

from portbench import roofline


def test_aligned_moments_at_the_main_shape():
    bw, flops = roofline.card_rates("NVIDIA H100 80GB HBM3")
    assert (bw, flops) == (3.35e12, 67e12)
    b, s = 512, 50_000
    # int16 planes 3*512*50000*2 = 153,600,000; scale 4; w, ref (3),
    # mask 4*(50000 + 150000 + 50000) = 1,000,000; Σref 12; frame mask
    # 2,048; six sums 1,200,000
    nbytes = 153_600_000 + 4 + 1_000_000 + 12 + 2_048 + 1_200_000
    ops = 63 * b * s + 1000 * b            # 1,613,312,000
    got = roofline.aligned_moments_s(b, s, "int16", bw, flops)
    assert got == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))
    assert got == pytest.approx(155_802_064 / 3.35e12)     # bytes-bound


def test_pair_histogram_at_the_main_shape():
    bw, flops = roofline.card_rates("NVIDIA H100 80GB HBM3")
    b, n, nbins, binned = 16, 32_768, 75, 2.5e8
    ops = 23 * b * n * n + 7 * binned
    got = roofline.pair_histogram_s(b, n, n, nbins, binned, bw, flops)
    assert got == pytest.approx(ops / 67e12)                # operations
    assert got * 1e3 == pytest.approx(5.923, abs=2e-3)      # chip_smoke's


def test_blocks_and_unknown_card():
    assert roofline.blocks(10_000, 512) == [512] * 19 + [272]
    assert roofline.blocks(1_000, 16) == [16] * 62 + [8]
    assert roofline.card_rates("Some Card") == (3.35e12, 67e12)
