"""The port's full tree API against the JAX package's: Morton keys,
ancestors, children and neighbours in 2-D and 3-D, periodic and not;
UniformTree (the native sort) and PtTree's leaves, levels, permutation,
point ranges and particle data identical, with and without the 2:1
balance; the adaptive FMM's tree through `PtTree.refined` as the JAX
adaptive FMM builds it."""

import numpy as np
import pytest

from sctl_tpu.fmm.adaptive import AdaptiveFMM as J_Adaptive
from sctl_tpu.tree import morton as jmt
from sctl_tpu.tree.tree import PtTree as J_PtTree
from sctl_tpu.tree.tree import UniformTree as J_Tree
from sctl_tpu.tree.tree import _normalize as j_normalize
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.tree import PtTree, UniformTree
from sctl_tpu_torch.tree import morton as mt

limit_cpu_threads()

eq = np.testing.assert_array_equal


def _points(dim, n, seed):
    """Clustered points: a uniform cloud and a tight blob, so the tree
    refines unevenly."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, dim))
    x[: n // 3] = 0.3 + 0.02 * rng.random((n // 3, dim))
    return x


@pytest.mark.parametrize("dim", [2, 3])
def test_morton_api_matches_jax(dim):
    x = _points(dim, 3000, dim)
    k = mt.morton_encode(x, dim=dim)
    eq(k, jmt.morton_encode(x, dim=dim))
    eq(mt.morton_decode(k, dim), jmt.morton_decode(k, dim))
    assert mt.max_depth(dim) == jmt.max_depth(dim)
    for lvl in (1, 4, 7):
        eq(mt.morton_ancestor(k, lvl, dim), jmt.morton_ancestor(k, lvl, dim))
        a = mt.morton_ancestor(k[:200], lvl, dim)
        eq(mt.morton_children(a, lvl, dim), jmt.morton_children(a, lvl, dim))
        b = mt.box_coords(k, lvl, dim)
        eq(b, jmt.box_coords(k, lvl, dim))
        eq(mt.coords_to_key(b, lvl, dim), jmt.coords_to_key(b, lvl, dim))
        for periodic in (False, True):
            for p, j in zip(mt.morton_neighbors(a, lvl, dim, periodic),
                            jmt.morton_neighbors(a, lvl, dim, periodic)):
                eq(p, j)


@pytest.mark.parametrize("dim,depth,periodic", [
    (3, 3, False), (3, 3, True), (3, 4, True), (2, 5, False),
    (2, 5, True)])
def test_uniform_tree_matches_jax(dim, depth, periodic):
    """The native radix sort of the box ids (dim * depth <= 24 key
    bits) gives the JAX package's permutation and boxes."""
    x = _points(dim, 4000, depth) * 3.0 - 1.0
    t, tj = UniformTree(x, depth, dim=dim), J_Tree(x, depth, dim=dim)
    for name in ("perm", "box_sorted", "box_dsp", "box_cnt", "X_sorted"):
        eq(getattr(t, name), getattr(tj, name))
    eq(t.neighbor_boxes(periodic), tj.neighbor_boxes(periodic))
    eq(t.box_centers(), tj.box_centers())
    assert (t.box_size(), t.n_boxes) == (tj.box_size(), tj.n_boxes)


@pytest.mark.parametrize("dim,balance21,periodic", [
    (3, False, False), (3, True, False), (3, True, True),
    (2, False, False), (2, True, False), (2, True, True)])
def test_pttree_matches_jax(dim, balance21, periodic):
    x = _points(dim, 6000, 10 + dim)
    t = PtTree(dim).update_refinement(x, 40, balance21, periodic)
    tj = J_PtTree(dim).update_refinement(x, 40, balance21, periodic)
    for name in ("perm", "X_sorted", "leaf_keys", "leaf_levels",
                 "leaf_dsp", "leaf_cnt", "offset"):
        eq(getattr(t, name), getattr(tj, name))
    assert t.scale == tj.scale and t.n_leaves() == tj.n_leaves()
    eq(t.leaf_of_points(), tj.leaf_of_points())
    for per in (False, True):
        assert t.check_2to1(per) == tj.check_2to1(per)
    if balance21:
        assert t.check_2to1(periodic)
    assert t.leaf_levels.max() > t.leaf_levels.min() + 1
    # particle data: tree order and input order
    v = np.random.default_rng(1).normal(size=(len(x), 3))
    t.add_particle_data("v", v)
    tj.add_particle_data("v", v)
    eq(t.get_tree_order_data("v"), tj.get_tree_order_data("v"))
    eq(t.get_particle_data("v"), v)
    t.delete_particle_data("v")
    with pytest.raises(KeyError):
        t.get_particle_data("v")


def test_pttree_depth_cap_and_comm():
    """max_level caps the refinement as in the JAX package; a comm is
    kept, as the JAX package's PtTree keeps it, and the tree it builds
    is the one without."""
    x = _points(3, 3000, 4)
    t = PtTree().update_refinement(x, 4, max_level=3)
    tj = J_PtTree().update_refinement(x, 4, max_level=3)
    eq(t.leaf_keys, tj.leaf_keys)
    eq(t.leaf_levels, tj.leaf_levels)
    from sctl_tpu.comm import Comm as J_Comm
    from sctl_tpu_torch.comm import Comm
    comm = Comm.self_()
    tc = PtTree(3, comm=comm).update_refinement(x, 4, max_level=3)
    assert tc.comm is comm and J_PtTree(3, comm=J_Comm()).comm is not None
    eq(tc.leaf_keys, tj.leaf_keys)
    eq(tc.leaf_levels, tj.leaf_levels)


def test_adaptive_tree_through_refined_matches_jax():
    """`PtTree.refined` over the adaptive FMM's shared normalization is
    the JAX adaptive FMM's tree (its own refinement loop and 2:1 balance,
    sctl_tpu/fmm/adaptive.py:323-341)."""
    xs, xt = _points(3, 5000, 21), _points(3, 2000, 22)
    _, off, sc = j_normalize(np.concatenate([xs, xt]))
    t = PtTree.refined(xs, off, sc, 32)
    tj = J_PtTree(dim=3)
    keys = jmt.morton_encode((xs - off) / sc, dim=3)
    tj.perm = np.argsort(keys, kind="stable")
    J_Adaptive._refine(tj, keys[tj.perm], 3, 32)
    eq(t.perm, tj.perm)
    eq(t.leaf_keys, tj.leaf_keys)
    eq(t.leaf_levels, tj.leaf_levels)
