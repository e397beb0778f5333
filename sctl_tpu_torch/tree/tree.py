"""Uniform Morton tree (counterpart of sctl_tpu/tree/tree.py:54).

Every box of a fixed depth exists; box ids are dense Morton indices, so
neighbours are integer arithmetic.  Host numpy: the tree is built once
at setup and its flat arrays go to the device.
"""

from __future__ import annotations

import numpy as np

from . import morton as mt


def _normalize(X: np.ndarray, bbox=None):
    """Scale points into [0,1)^3: x01 = (x - offset) / scale."""
    X = np.asarray(X, dtype=np.float64)
    if bbox is None:
        lo, hi = X.min(axis=0), X.max(axis=0)
    else:
        lo, hi = map(np.asarray, bbox)
    scale = float((hi - lo).max()) * (1 + 1e-10) or 1.0
    return (X - lo) / scale, lo, scale


class UniformTree:
    """Dense fixed-depth octree over 3-D points.

    perm      : sorted position -> input index (stable Morton sort)
    box_dsp   : (n_boxes + 1,) offsets; box b holds sorted points
                box_dsp[b] : box_dsp[b + 1]
    box_cnt   : (n_boxes,) points per box
    X_sorted  : points in Morton order
    """

    def __init__(self, X, depth: int, bbox=None):
        self.depth = depth
        self.n_boxes = 1 << (3 * depth)
        X01, self.offset, self.scale = _normalize(X, bbox)
        keys = mt.morton_encode(X01)
        self.box_of_point = (keys >> np.uint64(
            3 * (mt.MAX_DEPTH_3D - depth))).astype(np.int64)
        self.perm = np.argsort(self.box_of_point, kind="stable")
        box_sorted = self.box_of_point[self.perm]
        self.box_dsp = np.searchsorted(box_sorted,
                                       np.arange(self.n_boxes + 1))
        self.box_cnt = np.diff(self.box_dsp)
        self.X_sorted = np.asarray(X, dtype=np.float64)[self.perm]

    def box_centers(self) -> np.ndarray:
        """(n_boxes, 3) box centres in input coordinates."""
        b = mt.morton_decode(mt.level_keys(self.depth))
        side = 1.0 / (1 << self.depth)
        ctr01 = (b.astype(np.float64) / (1 << mt.MAX_DEPTH_3D)
                 + side / 2)
        return ctr01 * self.scale + self.offset

    def box_size(self) -> float:
        return self.scale / (1 << self.depth)

    def neighbor_boxes(self) -> np.ndarray:
        """(n_boxes, 27) neighbour box indices including self, -1 where
        the neighbour lies outside the domain."""
        lvl = self.depth
        n_side = 1 << lvl
        b = mt.box_coords(mt.level_keys(lvl), lvl)
        offsets = np.stack(np.meshgrid(*([[-1, 0, 1]] * 3),
                                       indexing="ij"), -1).reshape(-1, 3)
        nb = b[:, None, :] + offsets
        valid = np.all((nb >= 0) & (nb < n_side), axis=-1)
        nb = np.clip(nb, 0, n_side - 1)
        nidx = (mt.coords_to_key(nb, lvl) >> np.uint64(
            3 * (mt.MAX_DEPTH_3D - lvl))).astype(np.int64)
        return np.where(valid, nidx, -1)


class PtTree:
    """Adaptive linear Morton octree, 2:1 balanced (counterpart of
    sctl_tpu/tree/tree.py:118, the parts `AdaptiveFMM` reads).

    offset, scale : the normalization x01 = (x - offset) / scale
    perm, X_sorted: Morton sort of the points
    leaf_keys, leaf_levels : sorted leaves (first-descendant keys)
    leaf_dsp, leaf_cnt     : each leaf's range of sorted points
    """

    def __init__(self, X, offset, scale, max_pts: int,
                 max_level: int = 12):
        X = np.asarray(X, np.float64)
        self.offset, self.scale = offset, scale
        keys = mt.morton_encode((X - offset) / scale)
        self.perm = np.argsort(keys, kind="stable")
        self.X_sorted = X[self.perm]
        skeys = keys[self.perm]
        self._refine(skeys, max_pts, max_level)
        self._balance21()
        self.leaf_dsp = np.searchsorted(skeys, self.leaf_keys)
        self.leaf_cnt = np.diff(np.append(self.leaf_dsp, len(skeys)))

    def _refine(self, skeys, max_pts: int, max_level: int):
        """Split every box holding more than max_pts points, level by
        level (the loop of sctl_tpu AdaptiveFMM._refine)."""
        D = mt.MAX_DEPTH_3D

        def count(box_keys, level):
            shift = np.uint64(3 * (D - level))
            lo = np.searchsorted(skeys, box_keys)
            hi = np.searchsorted(skeys, box_keys + (np.uint64(1) << shift))
            return hi - lo

        leaf_keys, leaf_levels = [], []
        active = np.zeros(1, dtype=np.uint64)
        level = 0
        while len(active) and level < max_level:
            child = mt.morton_children(active, level).reshape(-1)
            split = count(child, level + 1) > max_pts
            leaf_keys.append(child[~split])
            leaf_levels.append(np.full((~split).sum(), level + 1,
                                       dtype=np.int32))
            active = child[split]
            level += 1
        if len(active):
            leaf_keys.append(active)
            leaf_levels.append(np.full(len(active), level, np.int32))
        lk = np.concatenate(leaf_keys)
        ll = np.concatenate(leaf_levels)
        order = np.argsort(lk, kind="stable")
        self.leaf_keys, self.leaf_levels = lk[order], ll[order]

    def _balance21(self):
        """Split any leaf more than one level coarser than an adjacent
        leaf until none is (sctl_tpu PtTree._balance21, not periodic)."""
        D = mt.MAX_DEPTH_3D
        while True:
            lk, ll = self.leaf_keys, self.leaf_levels
            if len(lk) <= 1:
                return
            ends = lk + (np.uint64(1) << (np.uint64(3 * D)
                                          - np.uint64(3)
                                          * ll.astype(np.uint64)))
            must_split = np.zeros(len(lk), dtype=bool)
            for lvl in np.unique(ll):
                nbk, valid = mt.morton_neighbors(lk[ll == lvl], int(lvl))
                j = np.clip(np.searchsorted(lk, nbk.reshape(-1),
                                            side="right") - 1,
                            0, len(lk) - 1)
                inside = (nbk.reshape(-1) < ends[j]) & valid.reshape(-1)
                must_split[np.unique(j[inside & (ll[j] < lvl - 1)])] = True
            if not must_split.any():
                return
            new_k = [lk[~must_split]]
            new_l = [ll[~must_split]]
            for key, lvl in zip(lk[must_split], ll[must_split]):
                new_k.append(mt.morton_children(
                    np.asarray([key], np.uint64), int(lvl)).reshape(-1))
                new_l.append(np.full(8, lvl + 1, dtype=np.int32))
            allk, alll = np.concatenate(new_k), np.concatenate(new_l)
            order = np.argsort(allk, kind="stable")
            self.leaf_keys, self.leaf_levels = allk[order], alll[order]
