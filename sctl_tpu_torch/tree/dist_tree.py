"""Distributed adaptive Morton tree (counterpart of
sctl_tpu/tree/dist_tree.py; reference: include/sctl/tree.txx:134-333:
Morton sort, boundary exchange and splitter partition, the 2:1 balance
across ranks (236-294), the ghost exchanges ReduceBroadcast and
Broadcast (547, 668)).

The JAX package's design is kept: the points (O(N)) are sharded over the
ranks, the skeleton (the leaf keys and levels, O(N / max_pts)) is
replicated.  Construction takes one all-reduce a level (the global box
counts), the 2:1 balance is the same local computation on every rank
with no communication, and a ghost exchange of named node data is one
all-reduce.

Each rank runs on its own tensors on its device.  Keys are int64 (a 3-D
key has 60 bits, a 2-D one 62); the padding key NOKEY is the int64
maximum, which sorts last (the JAX package's uint64 all-ones).  Unlike
the JAX package's static-capacity program, the active box lists have the
length they need (the same on every rank, since they follow from
all-reduced counts); the outputs are padded to leaf_cap and pt_cap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm.comm import Comm
from ..comm.verbs import global_sort
from . import morton as mt

NOKEY = torch.iinfo(torch.int64).max     # padding key (sorts last)

_SPREAD = {3: ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
               (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
               (2, 0x1249249249249249)),
           2: ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
               (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
               (1, 0x5555555555555555))}
_COMPACT = {3: ((2, 0x10C30C30C30C30C3), (4, 0x100F00F00F00F00F),
                (8, 0x1F0000FF0000FF), (16, 0x1F00000000FFFF),
                (32, 0x1FFFFF)),
            2: ((1, 0x3333333333333333), (2, 0x0F0F0F0F0F0F0F0F),
                (4, 0x00FF00FF00FF00FF), (8, 0x0000FFFF0000FFFF),
                (16, 0x00000000FFFFFFFF))}
_LOW = {3: 0x1249249249249249, 2: 0x5555555555555555}


def _spread(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`morton._spread3` / `_spread2` on int64 lattice coordinates."""
    for s, m in _SPREAD[dim]:
        x = (x | (x << s)) & m
    return x


def _compact(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x & _LOW[dim]
    for s, m in _COMPACT[dim]:
        x = (x | (x >> s)) & m
    return x


def lattice_to_key(lat: torch.Tensor, dim: int = 3) -> torch.Tensor:
    """Maximum-depth lattice coordinates (..., dim) -> Morton keys."""
    key = _spread(lat[..., 0], dim)
    for a in range(1, dim):
        key = key | (_spread(lat[..., a], dim) << a)
    return key


def morton_encode(X01: torch.Tensor, dim: int = 3) -> torch.Tensor:
    """Coordinates in [0, 1)^dim -> int64 keys, the keys of
    `morton.morton_encode` bit for bit (the same float64 scaling)."""
    scale = float(1 << mt.max_depth(dim))
    q = torch.clamp(X01.to(torch.float64) * scale, 0, scale - 1)
    return lattice_to_key(q.to(torch.int64), dim)


def morton_decode(keys: torch.Tensor, dim: int = 3) -> torch.Tensor:
    """Keys -> maximum-depth lattice coordinates (..., dim)."""
    return torch.stack([_compact(keys >> a, dim) for a in range(dim)], -1)


def _box_size(levels: torch.Tensor, dim: int) -> torch.Tensor:
    """Key span 2^(dim (D - level)) of a box at each level."""
    D = mt.max_depth(dim)
    return torch.ones_like(levels, dtype=torch.int64) << (
        dim * (D - levels.to(torch.int64)))


def _children(keys: torch.Tensor, levels: torch.Tensor, dim: int):
    """(K,) boxes at per-box levels -> (K, 2^dim) child keys."""
    D = mt.max_depth(dim)
    shift = dim * (D - 1 - levels.to(torch.int64))
    c = torch.arange(1 << dim, device=keys.device)
    return keys[:, None] | (c[None, :] << shift[:, None])


def build_skeleton(skeys, n_local, comm: Comm, max_pts: int,
                   max_level: int, leaf_cap: int, dim: int = 3):
    """Adaptive refinement with global counts, one all-reduce a level.

    skeys: (C,) locally sorted keys, NOKEY past n_local.  The active box
    list is the same on every rank, so every split decision is global.
    Returns (leaf_keys (leaf_cap,), leaf_levels (leaf_cap,), n_leaves),
    sorted by key, NOKEY past n_leaves."""
    dev = skeys.device
    D = mt.max_depth(dim)
    n_local = int(n_local)
    active = torch.zeros(1, dtype=torch.int64, device=dev)      # the root
    keys, lvls = [], []
    for level in range(max_level):
        child = _children(active, torch.full_like(active, level), dim) \
            .reshape(-1)
        span = 1 << (dim * (D - level - 1))
        lo = torch.clamp(torch.searchsorted(skeys, child), max=n_local)
        hi = torch.clamp(torch.searchsorted(skeys, child + (span - 1),
                                            right=True), max=n_local)
        c = comm.allreduce(hi - lo)
        split = (c > max_pts) & (level + 1 < max_level)
        keys.append(child[~split])
        lvls.append(torch.full((int((~split).sum()),), level + 1,
                               dtype=torch.int32, device=dev))
        active = child[split]
        if not len(active):
            break
    return _pad_leaves(torch.cat(keys), torch.cat(lvls), leaf_cap)


class LeafCapacityError(ValueError):
    """More leaves than a DistPtTree's leaf_cap: `n_leaf` is the count
    (the same on every rank), so that a caller can grow the capacity."""

    def __init__(self, n_leaf: int, leaf_cap: int):
        super().__init__(f"DistPtTree: {n_leaf} leaves exceed leaf_cap "
                         f"{leaf_cap}")
        self.n_leaf = n_leaf


def _pad_leaves(lk, ll, leaf_cap: int):
    n = lk.shape[0]
    if n > leaf_cap:
        raise LeafCapacityError(n, leaf_cap)
    order = torch.argsort(lk)
    out_k = torch.full((leaf_cap,), NOKEY, dtype=torch.int64,
                       device=lk.device)
    out_l = torch.zeros(leaf_cap, dtype=torch.int32, device=lk.device)
    out_k[:n], out_l[:n] = lk[order], ll[order]
    return out_k, out_l, n


def balance21_skeleton(leaf_keys, leaf_lvl, n_leaf, max_level: int,
                       leaf_cap: int, dim: int = 3, periodic: bool = False):
    """2:1 balance of the replicated skeleton (reference:
    tree.txx:236-294; the same local computation on every rank, no
    communication): each round splits every leaf more than one level
    coarser than an adjacent leaf, until a round splits none (at most
    max_level rounds)."""
    D = mt.max_depth(dim)
    dev = leaf_keys.device
    off = np.stack(np.meshgrid(*([[-1, 0, 1]] * dim), indexing="ij"),
                   -1).reshape(-1, dim)
    off = torch.as_tensor(off[~np.all(off == 0, axis=1)], device=dev)
    n_off = off.shape[0]
    side = 1 << D
    keys, lvl = leaf_keys[:n_leaf], leaf_lvl[:n_leaf].to(torch.int64)
    for _ in range(max_level):
        step = torch.ones_like(lvl) << (D - lvl)
        nb = (morton_decode(keys, dim)[:, None, :]
              + off[None] * step[:, None, None])
        if periodic:
            nb = nb % side
            ok = torch.ones(nb.shape[:-1], dtype=torch.bool, device=dev)
        else:
            ok = ((nb >= 0) & (nb < side)).all(-1)
            nb = torch.clamp(nb, 0, side - 1)
        nb_key = lattice_to_key(nb, dim).reshape(-1)
        j = torch.clamp(torch.searchsorted(keys, nb_key, right=True) - 1, 0,
                        keys.shape[0] - 1)
        last = keys + (_box_size(lvl, dim) - 1)
        inside = (nb_key <= last[j]) & ok.reshape(-1)
        too_coarse = inside & (lvl[j] < lvl.repeat_interleave(n_off) - 1)
        must = torch.zeros(keys.shape[0], dtype=torch.bool, device=dev)
        must[j[too_coarse]] = True
        if not bool(must.any()):
            break
        child = _children(keys[must], lvl[must], dim).reshape(-1)
        keys = torch.cat([keys[~must], child])
        lvl = torch.cat([lvl[~must],
                         (lvl[must] + 1).repeat_interleave(1 << dim)])
        order = torch.argsort(keys)
        keys, lvl = keys[order], lvl[order]
    return _pad_leaves(keys, lvl.to(torch.int32), leaf_cap)


class DistPtTree:
    """Distributed particle tree: sharded points, replicated skeleton
    (reference PtTree, tree.hpp:198-292, in the sharded setting).

        tree = DistPtTree(comm, leaf_cap=..., pt_cap=...)
        fn = tree.build_fn(max_pts, balance21=True)
        leaf_keys, leaf_lvl, n_leaf, X_sorted, cnt = fn(X_local, n_local)

    with the named node-data exchanges `reduce_broadcast` and
    `broadcast` (tree.txx:547, 668)."""

    def __init__(self, comm: Comm, leaf_cap: int, pt_cap: int,
                 dim: int = 3, max_level: int = 10):
        self.comm = comm
        self.dim = dim
        self.leaf_cap = leaf_cap
        self.pt_cap = pt_cap
        self.max_level = max_level

    def build_fn(self, max_pts: int, balance21: bool = False,
                 periodic: bool = False, bbox=None):
        """fn(X (C, dim) tensor, cnt) -> (leaf_keys (leaf_cap,), leaf_lvl
        (leaf_cap,), n_leaf, X_sorted (pt_cap, dim), out_cnt), the same
        skeleton on every rank: the global bounding box (all-reduced
        min and max), Morton keys, the distributed sample sort
        (`global_sort`), the skeleton with global counts, and optionally
        the 2:1 balance.  bbox=(offset (dim,), scale) fixes the key
        normalization instead (for a consumer that maps other points,
        FMM targets, into the same keys)."""
        comm, dim = self.comm, self.dim

        def fn(X, cnt):
            cnt = int(cnt)
            valid = (torch.arange(X.shape[0], device=X.device) < cnt)[:, None]
            if bbox is not None:
                lo = torch.as_tensor(bbox[0], dtype=X.dtype, device=X.device)
                scale = torch.as_tensor(bbox[1], dtype=X.dtype,
                                        device=X.device)
            else:
                big = torch.tensor(1e300, dtype=X.dtype, device=X.device)
                lo = comm.allreduce(torch.where(valid, X, big).amin(0),
                                    "min")
                hi = comm.allreduce(torch.where(valid, X, -big).amax(0),
                                    "max")
                scale = (hi - lo).max() * (1 + 1e-10)
            keys = morton_encode(torch.where(valid, (X - lo) / scale,
                                             torch.full_like(X, 0.5)), dim)
            keys = torch.where(valid[:, 0], keys, torch.full_like(keys, NOKEY))
            skeys, Xs, out_cnt = global_sort(comm, keys, cnt, payload=X,
                                             capacity=self.pt_cap)
            n_out = int(out_cnt)
            skeys = torch.where(torch.arange(self.pt_cap,
                                             device=X.device) < n_out,
                                skeys, torch.full_like(skeys, NOKEY))
            lk, ll, nl = build_skeleton(skeys, n_out, comm, max_pts,
                                        self.max_level, self.leaf_cap, dim)
            if balance21:
                lk, ll, nl = balance21_skeleton(lk, ll, nl, self.max_level,
                                                self.leaf_cap, dim, periodic)
            return lk, ll, nl, Xs, n_out

        return fn

    # -- named node-data exchange (tree.txx:547, 668) ----------------------
    def reduce_broadcast(self, partial_leaf_vals):
        """Per-leaf contributions summed over the ranks, the totals on
        every rank (on the replicated skeleton, one all-reduce)."""
        return self.comm.allreduce(partial_leaf_vals)

    def broadcast(self, leaf_vals, owner_mask):
        """Each leaf's owner's values on every rank: the all-reduce of
        the owner-masked values (owner_mask (L,) True on one rank a
        leaf)."""
        m = owner_mask.reshape((-1,) + (1,) * (leaf_vals.dim() - 1))
        return self.comm.allreduce(torch.where(m, leaf_vals,
                                               torch.zeros_like(leaf_vals)))

    @staticmethod
    def leaf_of_points(leaf_keys, pt_keys):
        """Leaf index of each point key (a replicated-skeleton lookup)."""
        return torch.clamp(torch.searchsorted(leaf_keys, pt_keys,
                                              right=True) - 1, 0,
                           leaf_keys.shape[0] - 1)
