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
