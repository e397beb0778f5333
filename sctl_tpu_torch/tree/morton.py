"""Morton (Z-order) keys as vectorized numpy bit operations (counterpart
of sctl_tpu/tree/morton.py:53-177; reference: include/sctl/morton.hpp,
morton.txx: coords <-> key, Ancestor, Children, NbrList).

Keys are uint64 with `dim` interleaved coordinate fields of
`max_depth(dim)` bits (20 in 3-D, 31 in 2-D), x in the lowest bit of
each group: child index c = x + 2y (+ 4z).  Every key sits at the
maximum depth, so keys of any level share one order (a box's key is its
first descendant's, the reference's DFD order).  Host numpy: trees are
built once at setup and their flat arrays go to the device.
"""

from __future__ import annotations

import numpy as np

MAX_DEPTH_3D = 20
MAX_DEPTH_2D = 31

_U = np.uint64


def _spread3(x):
    """Spread the low 21 bits of x two zero bits apart (3-D interleave)."""
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


def _spread2(x):
    x = x.astype(np.uint64)
    x = (x | (x << _U(16))) & _U(0x0000FFFF0000FFFF)
    x = (x | (x << _U(8))) & _U(0x00FF00FF00FF00FF)
    x = (x | (x << _U(4))) & _U(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << _U(2))) & _U(0x3333333333333333)
    x = (x | (x << _U(1))) & _U(0x5555555555555555)
    return x


def _compact2(x):
    x = x & _U(0x5555555555555555)
    x = (x | (x >> _U(1))) & _U(0x3333333333333333)
    x = (x | (x >> _U(2))) & _U(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> _U(4))) & _U(0x00FF00FF00FF00FF)
    x = (x | (x >> _U(8))) & _U(0x0000FFFF0000FFFF)
    x = (x | (x >> _U(16))) & _U(0x00000000FFFFFFFF)
    return x


def _interleave(q, dim: int):
    if dim == 3:
        return (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << _U(1))
                | (_spread3(q[..., 2]) << _U(2)))
    if dim == 2:
        return _spread2(q[..., 0]) | (_spread2(q[..., 1]) << _U(1))
    raise ValueError(f"dim {dim} not supported")


def max_depth(dim: int) -> int:
    return MAX_DEPTH_3D if dim == 3 else MAX_DEPTH_2D


def morton_encode(coords: np.ndarray, depth: int = None,
                  dim: int = None) -> np.ndarray:
    """Coordinates in [0, 1)^dim, (N, dim) -> keys (reference:
    Morton(coord)).  With `depth`, the bits below that level are cleared
    (the box keys of level `depth`; `native.morton_encode`'s keys)."""
    dim = dim or coords.shape[-1]
    D = max_depth(dim)
    scale = float(1 << D)
    q = np.clip(coords * scale, 0, scale - 1).astype(np.uint64)
    keys = _interleave(q, dim)
    if depth is None:
        return keys
    shift = _U(dim * (D - depth))
    return (keys >> shift) << shift


def morton_decode(keys: np.ndarray, dim: int = 3) -> np.ndarray:
    """Keys -> integer lattice coordinates at the maximum depth."""
    if dim == 3:
        return np.stack([_compact3(keys), _compact3(keys >> _U(1)),
                         _compact3(keys >> _U(2))], axis=-1)
    if dim == 2:
        return np.stack([_compact2(keys), _compact2(keys >> _U(1))],
                        axis=-1)
    raise ValueError(f"dim {dim} not supported")


def morton_ancestor(keys: np.ndarray, level: int, dim: int = 3):
    """Key of the level-`level` ancestor box, its first descendant's
    key (reference: Morton::Ancestor)."""
    shift = _U(dim * (max_depth(dim) - level))
    return (keys >> shift) << shift


def morton_children(keys: np.ndarray, level: int, dim: int = 3):
    """Keys of the 2^dim children of level-`level` boxes (reference:
    Morton::Children, morton.txx:138), (N,) -> (N, 2^dim)."""
    shift = _U(dim * (max_depth(dim) - level - 1))
    return keys[..., None] | (np.arange(1 << dim, dtype=np.uint64) << shift)


def box_coords(keys: np.ndarray, level: int, dim: int = 3) -> np.ndarray:
    """Integer box coordinates at `level` for keys at any depth."""
    return (morton_decode(keys, dim) >> _U(max_depth(dim) - level)).astype(
        np.int64)


def coords_to_key(box: np.ndarray, level: int, dim: int = 3) -> np.ndarray:
    """Integer box coordinates at `level` -> key (first descendant)."""
    return _interleave(box.astype(np.uint64) << _U(max_depth(dim) - level),
                       dim)


def level_keys(level: int, dim: int = 3) -> np.ndarray:
    """Keys of all boxes at `level`, in Morton order."""
    return (np.arange(1 << (dim * level), dtype=np.uint64)
            << _U(dim * (max_depth(dim) - level)))


def raster_index(level: int) -> np.ndarray:
    """Morton box index -> raster index (x * n + y) * n + z at
    `level` in 3-D (the grid helpers' `_grid_index_np`, kifmm.py:1569)."""
    n = 1 << level
    b = box_coords(level_keys(level), level)
    return (b[:, 0] * n + b[:, 1]) * n + b[:, 2]


def morton_neighbors(keys: np.ndarray, level: int, dim: int = 3,
                     periodic: bool = False):
    """Keys of the 3^dim - 1 same-level neighbour boxes (reference:
    Morton::NbrList, morton.txx:88), (N, 3^dim - 1), and their validity:
    False outside the unit box unless periodic, where they wrap."""
    b = box_coords(keys, level, dim)
    side = 1 << level
    offsets = np.stack(np.meshgrid(*([[-1, 0, 1]] * dim), indexing="ij"),
                       -1).reshape(-1, dim)
    offsets = offsets[~np.all(offsets == 0, axis=1)]
    nb = b[..., None, :] + offsets
    if periodic:
        nb = nb % side
        valid = np.ones(nb.shape[:-1], dtype=bool)
    else:
        valid = np.all((nb >= 0) & (nb < side), axis=-1)
        nb = np.clip(nb, 0, side - 1)
    return coords_to_key(nb, level, dim), valid
