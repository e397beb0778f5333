"""The pair counts of the roofline against brute force."""

import numpy as np
import pytest
import torch

from portbench.roofline import pairs, peaks


def _brute(x: np.ndarray, depth: int) -> int:
    n = 1 << depth
    lo = x.min(0)
    side = (x.max(0) - lo).max() * (1 + 1e-12)
    ijk = np.minimum(((x - lo) / side * n).astype(int), n - 1)
    cnt = 0
    for i in range(len(x)):
        for j in range(i + 1, len(x)):
            if np.abs(ijk[i] - ijk[j]).max() <= 1:
                cnt += 1
    return cnt


@pytest.mark.parametrize("seed, n, depth", [(0, 300, 2), (1, 400, 3),
                                            (2, 250, 1), (3, 350, 4)])
def test_near_pairs_match_brute_force(seed, n, depth):
    x = np.random.default_rng(seed).random((n, 3))
    c = pairs.box_counts(torch.as_tensor(x), depth)
    assert int(c.sum()) == n
    assert pairs.near_pairs(c) == _brute(x, depth)


def test_surface_points_and_bound():
    assert pairs.surface_points(6) == 152
    x = torch.as_tensor(np.random.default_rng(5).random((2000, 3)))
    w = pairs.uniform_fmm_work(x, 2, 6, "Laplace3D-FxU", 1, 1)
    assert w["pairs"]["s2m"] == w["pairs"]["l2t"] == 2000 * 152
    assert w["total_pairs"] == sum(w["pairs"].values())
    # one rsqrt a pair binds a Laplace pair on this card
    assert w["bound_by"] == "rsqrt"
    assert w["bound_s"] == pytest.approx(w["total_pairs"]
                                         / peaks.RSQRT_PER_S)
