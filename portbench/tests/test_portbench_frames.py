"""The chunk-addressable generator."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.frames import CHUNK, Frames, stream_seed
from portbench.tests._tiny import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name)) as f:
        return json.load(f)


PROTEIN = dict(_cfg("protein100k_heavy_rmsf.json"), n_atoms=64)
WATER = dict(_cfg("tip3p32k_oo_rdf.json"), n_waters=27, n_atoms=81,
             box_A=9.3)


@pytest.mark.parametrize("cfg", [PROTEIN, WATER], ids=["protein", "water"])
def test_same_seed_same_frames_in_one_process_and_split_over_ranks(cfg):
    n = 2 * CHUNK + 100
    whole = Frames(cfg, 2**31 + 17, n, "cpu").to_host()
    assert whole.shape == (n, cfg["n_atoms"], 3)
    # four ranks, each making only the chunks it owns, in another order
    for rank in range(4):
        mine = Frames(cfg, 2**31 + 17, n, "cpu")
        for k in reversed(range(rank % mine.n_chunks, mine.n_chunks, 4)):
            lo = k * CHUNK
            got = mine.chunk(k).numpy()
            assert np.array_equal(got, whole[lo:lo + len(got)])
    # a shorter trajectory is the prefix
    short = Frames(cfg, 2**31 + 17, CHUNK + 3, "cpu").to_host()
    assert np.array_equal(short, whole[:CHUNK + 3])


def test_seeds_differ_and_take_any_whole_number():
    a = Frames(PROTEIN, -3, 8, "cpu").to_host()
    b = Frames(PROTEIN, 2**64 + 5, 8, "cpu").to_host()
    assert not np.array_equal(a, b)
    assert 0 <= stream_seed(2**70, "x", 1) < 2**63
    assert stream_seed(5, "chunk", 1) != stream_seed(5, "chunk", 2)


def test_protein_model_is_a_rotation_of_the_base_plus_noise():
    cfg = dict(PROTEIN, noise_A=0.0)
    f = Frames(cfg, 9, 4, "cpu")
    x = f.chunk(0).to(torch.float64)
    base = f.shared.to(torch.float64)
    assert abs(float(base.mean(0).abs().max())) < 1e-5
    # a rotation about z keeps z and each atom's distance from the axis
    assert torch.allclose(x[..., 2], base[:, 2].expand(4, -1))
    r_xy = (x[..., :2] ** 2).sum(-1)
    assert torch.allclose(r_xy, (base[:, :2] ** 2).sum(-1).expand(4, -1),
                          rtol=1e-5)


def test_water_oxygens_lie_in_the_box():
    f = Frames(WATER, 4, 16, "cpu").to_host()
    o = f[:, 0::3]
    assert (o >= 0).all() and (o <= WATER["box_A"]).all()
