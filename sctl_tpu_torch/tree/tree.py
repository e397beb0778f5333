"""Morton-ordered point trees (counterpart of sctl_tpu/tree/tree.py:39-278;
reference: include/sctl/tree.hpp:27-292, tree.txx:134-333).

  UniformTree  dense fixed-depth tree: every box exists, box ids are
               dense Morton indices, neighbours are integer arithmetic.
               The uniform KIFMM's tree.
  PtTree       adaptive linear tree (split while a box holds more than
               max_pts points, optional 2:1 balance, periodic or not)
               with named particle data moved between input and tree
               order.  The adaptive FMM's tree.

Host numpy in 2-D and 3-D: a tree is built once at setup and its flat
arrays go to the device.  The pointer-free construction is the
reference algorithm as sort / searchsorted steps: one Morton sort, box
counts by searchsorted on the sorted keys, leaves the children of split
boxes with at most max_pts points (tree.txx:211-228).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import morton as mt


def _normalize(X: np.ndarray, bbox=None):
    """Scale points into [0,1)^dim: (X01, offset, scale) with x01 =
    (x - offset) / scale (the reference FMM's bbox_scale / offset,
    fmm-wrapper.txx:845)."""
    X = np.asarray(X, dtype=np.float64)
    if bbox is None:
        lo, hi = X.min(axis=0), X.max(axis=0)
    else:
        lo, hi = map(np.asarray, bbox)
    scale = float((hi - lo).max()) * (1 + 1e-10) or 1.0
    return (X - lo) / scale, lo, scale


class UniformTree:
    """Dense fixed-depth Morton tree over points in any box.

    perm      : sorted position -> input index (stable Morton sort; the
                native radix sort at dim * depth <= 24 key bits)
    box_dsp   : (n_boxes + 1,) offsets; box b holds sorted points
                box_dsp[b] : box_dsp[b + 1]
    box_cnt   : (n_boxes,) points per box
    X_sorted  : points in Morton order
    """

    def __init__(self, X, depth: int, dim: int = 3, bbox=None):
        self.dim = dim
        self.depth = depth
        self.n_boxes = 1 << (dim * depth)
        X01, self.offset, self.scale = _normalize(X, bbox)
        D = mt.max_depth(dim)
        keys = mt.morton_encode(X01, dim=dim)
        self.box_of_point = (keys >> np.uint64(dim * (D - depth))).astype(
            np.int64)
        key_bits = dim * depth
        if key_bits <= 24:
            from .. import native
            self.box_sorted, self.perm = native.argsort_small(
                self.box_of_point, key_bits)
        else:
            self.perm = np.argsort(self.box_of_point, kind="stable")
            self.box_sorted = self.box_of_point[self.perm]
        self.box_dsp = np.searchsorted(self.box_sorted,
                                       np.arange(self.n_boxes + 1))
        self.box_cnt = np.diff(self.box_dsp)
        self.X_sorted = np.asarray(X, dtype=np.float64)[self.perm]

    def box_centers(self) -> np.ndarray:
        """(n_boxes, dim) box centres in input coordinates."""
        b = mt.morton_decode(mt.level_keys(self.depth, self.dim), self.dim)
        side = 1.0 / (1 << self.depth)
        ctr01 = (b.astype(np.float64) / (1 << mt.max_depth(self.dim))
                 + side / 2)
        return ctr01 * self.scale + self.offset

    def box_size(self) -> float:
        return self.scale / (1 << self.depth)

    def neighbor_boxes(self, periodic: bool = False) -> np.ndarray:
        """(n_boxes, 3^dim) neighbour box indices including self; -1
        outside the domain unless periodic, where they wrap."""
        lvl, dim = self.depth, self.dim
        n_side = 1 << lvl
        b = mt.box_coords(mt.level_keys(lvl, dim), lvl, dim)
        offsets = np.stack(np.meshgrid(*([[-1, 0, 1]] * dim),
                                       indexing="ij"), -1).reshape(-1, dim)
        nb = b[:, None, :] + offsets
        if periodic:
            nb = nb % n_side
            valid = np.ones(nb.shape[:-1], dtype=bool)
        else:
            valid = np.all((nb >= 0) & (nb < n_side), axis=-1)
            nb = np.clip(nb, 0, n_side - 1)
        nidx = (mt.coords_to_key(nb, lvl, dim) >> np.uint64(
            dim * (mt.max_depth(dim) - lvl))).astype(np.int64)
        return np.where(valid, nidx, -1)


class PtTree:
    """Adaptive linear Morton tree (reference: PtTree<Real,DIM>,
    tree.hpp:198-292), the JAX package's API:

    update_refinement(X, max_pts, balance21, periodic, max_level)
        builds the leaves (<= max_pts points each, optionally 2:1
        balanced, periodic or not) over X normalized to its bounding box;
    PtTree.refined(X, offset, scale, max_pts, ...)
        the same over a given normalization (the adaptive FMM's, shared
        by sources and targets);
    add_particle_data / get_particle_data / get_tree_order_data /
    delete_particle_data
        named per-point arrays, kept in tree order, returned in input
        order (tree.hpp:288-291);
    n_leaves(), leaf_of_points(), check_2to1(periodic).

    Arrays: offset, scale (x01 = (x - offset) / scale), perm and
    X_sorted (the Morton sort), leaf_keys and leaf_levels (sorted
    leaves, first-descendant keys), leaf_dsp and leaf_cnt (each leaf's
    range of sorted points).  `comm` is kept for the caller, as the JAX
    package keeps it (sctl_tpu/tree/tree.py:128-130): the distribution
    itself is `tree.dist_tree.DistPtTree`'s, through the comm's verbs.
    """

    def __init__(self, dim: int = 3, comm=None):
        self.dim = dim
        self.comm = comm       # distribution handled by the caller's verbs
        self.leaf_keys: Optional[np.ndarray] = None
        self.leaf_levels: Optional[np.ndarray] = None
        self._data: Dict[str, np.ndarray] = {}
        self._data_dof: Dict[str, int] = {}
        self.perm: Optional[np.ndarray] = None

    # -- construction ---------------------------------------------------
    def update_refinement(self, X, max_pts: int = 100,
                          balance21: bool = False, periodic: bool = False,
                          max_level: Optional[int] = None):
        """Build the adaptive tree over X normalized to its bounding box
        (reference: UpdateRefinement, tree.txx:134: Morton sort, split
        while > max_pts, optional 2:1 balance); max_level defaults to
        min(max_depth, 15)."""
        _, offset, scale = _normalize(X)
        if max_level is None:
            max_level = min(mt.max_depth(self.dim), 15)
        return self._build(X, offset, scale, max_pts, balance21, periodic,
                           max_level)

    @classmethod
    def refined(cls, X, offset, scale, max_pts: int,
                balance21: bool = True, periodic: bool = False,
                max_level: int = 12, dim: int = 3) -> "PtTree":
        """A tree built as `update_refinement` builds it, over the
        normalization x01 = (x - offset) / scale (the adaptive FMM's
        tree: sources and targets share one bounding box; max_level 12
        and the 2:1 balance of sctl_tpu/fmm/adaptive.py:927-959)."""
        return cls(dim)._build(X, offset, scale, max_pts, balance21,
                               periodic, max_level)

    @classmethod
    def with_leaves(cls, X, offset, scale, leaf_keys, leaf_levels,
                    dim: int = 3) -> "PtTree":
        """A tree over X normalized by (offset, scale) whose leaves are
        given, e.g. a `DistPtTree` skeleton built over the same
        normalization: the leaves are adopted as they are (sorted by
        key), with no refinement (sctl_tpu/fmm/adaptive.py:332-336)."""
        t = cls(dim)
        skeys = t._sort(X, offset, scale)
        lk = np.asarray(leaf_keys, np.uint64)
        order = np.argsort(lk, kind="stable")
        t.leaf_keys = lk[order]
        t.leaf_levels = np.asarray(leaf_levels, np.int32)[order]
        t._finish(skeys)
        return t

    def _sort(self, X, offset, scale) -> np.ndarray:
        """Morton-sort X: perm, X_sorted; returns the sorted keys."""
        X = np.asarray(X, np.float64)
        self.offset, self.scale = offset, scale
        keys = mt.morton_encode((X - offset) / scale, dim=self.dim)
        self.perm = np.argsort(keys, kind="stable")
        self.X_sorted = X[self.perm]
        return keys[self.perm]

    def _finish(self, skeys: np.ndarray) -> None:
        """Each leaf's range of sorted points."""
        self.leaf_dsp = np.searchsorted(skeys, self.leaf_keys)
        self.leaf_cnt = np.diff(np.append(self.leaf_dsp, len(skeys)))
        self._skeys = skeys

    def _build(self, X, offset, scale, max_pts, balance21, periodic,
               max_level):
        dim = self.dim
        D = mt.max_depth(dim)
        skeys = self._sort(X, offset, scale)

        def count(box_keys, level):
            """points inside each box (given by its first-descendant key)"""
            shift = np.uint64(dim * (D - level))
            lo = np.searchsorted(skeys, box_keys)
            hi = np.searchsorted(skeys, box_keys + (np.uint64(1) << shift))
            return hi - lo

        leaf_keys, leaf_levels = [], []
        active = np.zeros(1, dtype=np.uint64)           # the root
        level = 0
        while len(active) and level < max_level:
            child = mt.morton_children(active, level, dim).reshape(-1)
            split = count(child, level + 1) > max_pts
            leaf_keys.append(child[~split])
            leaf_levels.append(np.full((~split).sum(), level + 1,
                                       dtype=np.int32))
            active = child[split]
            level += 1
        if len(active):                                 # depth-capped boxes
            leaf_keys.append(active)
            leaf_levels.append(np.full(len(active), level, np.int32))
        lk = np.concatenate(leaf_keys) if leaf_keys else active
        ll = (np.concatenate(leaf_levels) if leaf_levels
              else np.zeros(0, np.int32))
        order = np.argsort(lk, kind="stable")
        self.leaf_keys, self.leaf_levels = lk[order], ll[order]
        if balance21:
            self._balance21(periodic)
        self._finish(skeys)
        return self

    def _leaf_ends(self):
        dim, D = self.dim, mt.max_depth(self.dim)
        return self.leaf_keys + (np.uint64(1) << (
            np.uint64(dim) * np.uint64(D)
            - np.uint64(dim) * self.leaf_levels.astype(np.uint64)))

    def _too_coarse(self, lvl: int, periodic: bool):
        """Indices j of leaves adjacent to a level-lvl leaf and coarser
        than lvl - 1 (one entry per adjacency)."""
        lk, ll = self.leaf_keys, self.leaf_levels
        nbk, valid = mt.morton_neighbors(lk[ll == lvl], int(lvl), self.dim,
                                         periodic)
        # a neighbour key lies in leaf j if lk[j] <= key < ends[j]
        j = np.clip(np.searchsorted(lk, nbk.reshape(-1), side="right") - 1,
                    0, len(lk) - 1)
        inside = (nbk.reshape(-1) < self._leaf_ends()[j]) & valid.reshape(-1)
        return j[inside & (ll[j] < lvl - 1)]

    def _balance21(self, periodic: bool):
        """Iterative 2:1 balance (reference: tree.txx:236-294): split any
        leaf more than one level coarser than an adjacent leaf until
        none is."""
        dim = self.dim
        while len(self.leaf_keys) > 1:
            lk, ll = self.leaf_keys, self.leaf_levels
            must_split = np.zeros(len(lk), dtype=bool)
            for lvl in np.unique(ll):
                must_split[np.unique(self._too_coarse(lvl, periodic))] = True
            if not must_split.any():
                return
            new_k, new_l = [lk[~must_split]], [ll[~must_split]]
            for key, lvl in zip(lk[must_split], ll[must_split]):
                ck = mt.morton_children(np.asarray([key], np.uint64),
                                        int(lvl), dim).reshape(-1)
                new_k.append(ck)
                new_l.append(np.full(len(ck), lvl + 1, dtype=np.int32))
            allk, alll = np.concatenate(new_k), np.concatenate(new_l)
            order = np.argsort(allk, kind="stable")
            self.leaf_keys, self.leaf_levels = allk[order], alll[order]

    # -- particle data (reference: tree.hpp:198-292) ----------------------
    def add_particle_data(self, name: str, data):
        """Store per-point data given in input order; kept in tree
        order."""
        data = np.asarray(data)
        dof = data.size // len(self.perm)
        self._data[name] = data.reshape(len(self.perm), dof)[self.perm]
        self._data_dof[name] = dof

    def get_particle_data(self, name: str) -> np.ndarray:
        """The data in input order (reference: GetParticleData scatters
        back through scatter_idx)."""
        out = np.empty_like(self._data[name])
        out[self.perm] = self._data[name]
        return out.reshape(len(self.perm), -1)

    def get_tree_order_data(self, name: str) -> np.ndarray:
        return self._data[name]

    def delete_particle_data(self, name: str):
        del self._data[name]
        del self._data_dof[name]

    # -- queries ----------------------------------------------------------
    def n_leaves(self) -> int:
        return len(self.leaf_keys)

    def leaf_of_points(self) -> np.ndarray:
        """Leaf index of each point in sorted order."""
        return np.searchsorted(self.leaf_keys, self._skeys,
                               side="right") - 1

    def check_2to1(self, periodic: bool = False) -> bool:
        """True when no leaf is adjacent to a leaf more than one level
        coarser."""
        return not any(len(self._too_coarse(lvl, periodic))
                       for lvl in np.unique(self.leaf_levels))
