"""The port's uniform Morton tree against the JAX package's: the same
points give the same permutation, box offsets, counts and neighbours
(exact equality)."""

import jax  # noqa: F401  (the JAX package's tree imports jax.numpy)
import numpy as np
import pytest
import torch  # noqa: F401

from sctl_tpu.fmm.kifmm import KIFMM as J_KIFMM
from sctl_tpu.tree import morton as jmt
from sctl_tpu.tree.tree import UniformTree as J_Tree
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.tree import UniformTree
from sctl_tpu_torch.tree import morton as mt

limit_cpu_threads()


@pytest.mark.parametrize("depth,shift", [(2, 0.0), (3, 0.0), (3, -4.5)])
def test_uniform_tree_matches_jax(depth, shift):
    rng = np.random.default_rng(depth)
    x = rng.random((3000, 3)) * np.array([1.0, 2.0, 0.5]) + shift
    x[:50] = x[50:100]                   # coincident points
    bbox = (x.min(0) - 0.1, x.max(0))
    t, tj = UniformTree(x, depth, bbox=bbox), J_Tree(x, depth, bbox=bbox)
    np.testing.assert_array_equal(t.perm, tj.perm)
    np.testing.assert_array_equal(t.box_dsp, tj.box_dsp)
    np.testing.assert_array_equal(t.box_cnt, tj.box_cnt)
    np.testing.assert_array_equal(t.X_sorted, tj.X_sorted)
    np.testing.assert_array_equal(t.neighbor_boxes(), tj.neighbor_boxes())
    np.testing.assert_array_equal(t.box_centers(), tj.box_centers())
    assert t.scale == tj.scale


def test_morton_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.random((1000, 3))
    k = mt.morton_encode(x)
    np.testing.assert_array_equal(k, jmt.morton_encode(x))
    np.testing.assert_array_equal(mt.morton_decode(k),
                                  jmt.morton_decode(k))
    for lvl in (1, 3, 6):
        np.testing.assert_array_equal(mt.box_coords(k, lvl),
                                      jmt.box_coords(k, lvl))


@pytest.mark.parametrize("lvl", [2, 3, 4])
def test_raster_index_matches_jax(lvl):
    np.testing.assert_array_equal(mt.raster_index(lvl),
                                  J_KIFMM._grid_index_np(lvl))
