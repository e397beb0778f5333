"""Morton (Z-order) keys as vectorized numpy bit operations
(counterpart of sctl_tpu/tree/morton.py, numpy path only).

Keys are uint64 with 3 interleaved coordinate fields of MAX_DEPTH_3D
bits, x in the lowest bit of each triple: child index c = x + 2y + 4z.
"""

from __future__ import annotations

import numpy as np

MAX_DEPTH_3D = 20

_U = np.uint64


def _spread3(x):
    x = x.astype(np.uint64)
    x = (x | (x << _U(32))) & _U(0x1F00000000FFFF)
    x = (x | (x << _U(16))) & _U(0x1F0000FF0000FF)
    x = (x | (x << _U(8))) & _U(0x100F00F00F00F00F)
    x = (x | (x << _U(4))) & _U(0x10C30C30C30C30C3)
    x = (x | (x << _U(2))) & _U(0x1249249249249249)
    return x


def _compact3(x):
    x = x & _U(0x1249249249249249)
    x = (x | (x >> _U(2))) & _U(0x10C30C30C30C30C3)
    x = (x | (x >> _U(4))) & _U(0x100F00F00F00F00F)
    x = (x | (x >> _U(8))) & _U(0x1F0000FF0000FF)
    x = (x | (x >> _U(16))) & _U(0x1F00000000FFFF)
    x = (x | (x >> _U(32))) & _U(0x1FFFFF)
    return x


def morton_encode(coords: np.ndarray) -> np.ndarray:
    """Coordinates in [0,1)^3, (N, 3) -> keys at MAX_DEPTH_3D."""
    scale = float(1 << MAX_DEPTH_3D)
    q = np.clip(coords * scale, 0, scale - 1).astype(np.uint64)
    return (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << _U(1))
            | (_spread3(q[..., 2]) << _U(2)))


def morton_decode(keys: np.ndarray) -> np.ndarray:
    """Keys -> integer lattice coordinates at MAX_DEPTH_3D, (N, 3)."""
    return np.stack([_compact3(keys), _compact3(keys >> _U(1)),
                     _compact3(keys >> _U(2))], axis=-1)


def box_coords(keys: np.ndarray, level: int) -> np.ndarray:
    """Integer box coordinates at `level` for keys at any depth."""
    return (morton_decode(keys) >> _U(MAX_DEPTH_3D - level)).astype(
        np.int64)


def coords_to_key(box: np.ndarray, level: int) -> np.ndarray:
    """Integer box coordinates at `level` -> key (first descendant)."""
    b = box.astype(np.uint64) << _U(MAX_DEPTH_3D - level)
    return (_spread3(b[..., 0]) | (_spread3(b[..., 1]) << _U(1))
            | (_spread3(b[..., 2]) << _U(2)))


def level_keys(level: int) -> np.ndarray:
    """Keys of all boxes at `level`, in Morton order."""
    return (np.arange(1 << (3 * level), dtype=np.uint64)
            << _U(3 * (MAX_DEPTH_3D - level)))


def raster_index(level: int) -> np.ndarray:
    """Morton box index -> raster index (x * n + y) * n + z at
    `level` (the grid helpers' `_grid_index_np`, kifmm.py:1569)."""
    n = 1 << level
    b = box_coords(level_keys(level), level)
    return (b[:, 0] * n + b[:, 1]) * n + b[:, 2]


def morton_children(keys: np.ndarray, level: int) -> np.ndarray:
    """Keys of the 8 children of level-`level` boxes, (N,) -> (N, 8),
    child c = x + 2y + 4z."""
    shift = _U(3 * (MAX_DEPTH_3D - level - 1))
    return keys[..., None] | (np.arange(8, dtype=np.uint64) << shift)


def morton_neighbors(keys: np.ndarray, level: int):
    """Keys of the 26 same-level neighbour boxes, (N, 26), and their
    validity (False outside the unit cube)."""
    b = box_coords(keys, level)
    offsets = np.stack(np.meshgrid(*([[-1, 0, 1]] * 3), indexing="ij"),
                       -1).reshape(-1, 3)
    offsets = offsets[~np.all(offsets == 0, axis=1)]
    nb = b[..., None, :] + offsets
    side = 1 << level
    valid = np.all((nb >= 0) & (nb < side), axis=-1)
    return coords_to_key(np.clip(nb, 0, side - 1), level), valid
