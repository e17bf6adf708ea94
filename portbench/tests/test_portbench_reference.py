"""The references against the plainest forms of their definitions."""

import numpy as np
import pytest
import torch

from portbench.reference import inter_rdf


def _brute(a, b, lengths, edges, identical):
    d = b[None, :, :] - a[:, None, :]
    d -= lengths * np.round(d / lengths)
    r = np.sqrt((d * d).sum(-1))
    if identical:
        np.fill_diagonal(r, np.inf)
    return np.histogram(r[(r >= edges[0]) & (r < edges[-1])], bins=edges)[0]


@pytest.mark.parametrize("identical", [True, False])
@pytest.mark.parametrize("lengths", [(24.8, 24.8, 24.8), (27.0, 31.5, 40.0)])
def test_cell_list_counts_equal_all_pairs(identical, lengths):
    rng = np.random.default_rng(3)
    lengths = np.array(lengths)
    a = rng.uniform(-5, 1.2, size=(400, 3)) * lengths / 2
    b = a if identical else rng.uniform(0, 1, size=(300, 3)) * lengths
    edges = np.linspace(0.0, 8.0, 41)
    want = _brute(a, b, lengths, edges, identical)
    got = inter_rdf.frame_counts(torch.as_tensor(a), torch.as_tensor(b),
                                 torch.as_tensor(lengths), edges, identical)
    assert np.array_equal(got.numpy(), want)


def test_cell_list_refuses_a_box_under_three_cells():
    with pytest.raises(ValueError):
        inter_rdf.frame_counts(torch.zeros(4, 3, dtype=torch.float64),
                               torch.zeros(4, 3, dtype=torch.float64),
                               torch.full((3,), 20.0, dtype=torch.float64),
                               np.linspace(0, 8, 9), True)
