"""Sibling-blocked M2L (counterpart of sctl_tpu/ops/pallas_m2l.py:
`m2l_grid_blocked` :227-303 and its host helpers :306-356).

The child grid (n, n, n, r2) is reshaped to the parent grid
(h, h, h, 8*r2), h = n/2, child channel blocks c = 4cx + 2cy + cz, and
swept with the 26 parent-neighbour directions; direction k applies one
(8*r2, 8*r) block operator assembled from the child-pair V-list tables,
near child pairs zero.  On a CUDA tensor `m2l_grid_blocked` launches
csrc/m2l_blocked.cu; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import launch
from ._launch_checks import check_kernel_args, on_cuda


@functools.lru_cache(maxsize=None)
def _blk_dirs() -> np.ndarray:
    """(26, 3) parent-neighbour directions in the JAX package's order
    (dz-major stable sort); `blocked_m2l_mats` follows it."""
    dirs = np.array([(dx, dy, dz) for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                     if (dx, dy, dz) != (0, 0, 0)])
    return dirs[np.argsort(dirs[:, 2], kind="stable")]


@functools.lru_cache(maxsize=None)
def _blk_dirs_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_blk_dirs().astype(np.int32), device=device)


def blocked_m2l_mats(ca: np.ndarray, offsets: np.ndarray,
                     valid: np.ndarray, r_cap: int,
                     r2_cap: int) -> np.ndarray:
    """(26, 8*r2_cap, 8*r_cap) sibling-blocked operator stack from the
    compressed per-offset tables ca (316, r, r2), in `_blk_dirs()`
    order.  Block (cs, ct) of direction D is A_o^T for the child offset
    d = 2D + cs - ct when (o, parity ct) is in the V list, else zero."""
    omap = {tuple(d): i for i, d in enumerate(offsets)}
    r2c, rc = r2_cap, r_cap
    W = np.zeros((26, 8 * r2c, 8 * rc), ca.dtype)
    for k, D in enumerate(_blk_dirs()):
        for ct in range(8):
            tx, ty, tz = (ct >> 2) & 1, (ct >> 1) & 1, ct & 1
            for cs in range(8):
                sx, sy, sz = (cs >> 2) & 1, (cs >> 1) & 1, cs & 1
                d = (2 * D[0] + sx - tx, 2 * D[1] + sy - ty,
                     2 * D[2] + sz - tz)
                o = omap.get(d)
                if o is None or not valid[ct, o]:
                    continue
                W[k, cs * r2c:(cs + 1) * r2c, ct * rc:(ct + 1) * rc] \
                    = ca[o, :rc, :r2c].T
    return W


def m2l_windows(qp: torch.Tensor) -> list:
    """The 26 shifted (h^3, K) windows of the padded parent grid
    qp (h+2, h+2, h+2, K), in `_blk_dirs()` order."""
    h, K = qp.shape[0] - 2, qp.shape[-1]
    return [qp[1 + dx:1 + dx + h, 1 + dy:1 + dy + h,
               1 + dz:1 + dz + h].reshape(h ** 3, K)
            for dx, dy, dz in _blk_dirs()]


def m2l_grid_blocked_plain(qp, mats_blk):
    """Plain version of `m2l_grid_blocked`: 26 window products."""
    h = qp.shape[0] - 2
    out = None
    for k, win in enumerate(m2l_windows(qp)):
        y = win @ mats_blk[k]
        out = y if out is None else out + y
    return out.reshape(h, h, h, -1)


def m2l_grid_blocked(qp, mats_blk):
    """qp (h+2, h+2, h+2, 8*r2) zero-margin parent grid; mats_blk
    (26, 8*r2, 8*r) in `_blk_dirs()` order -> (h, h, h, 8*r)
    parent-blocked down-check contributions."""
    h, K = qp.shape[0] - 2, qp.shape[-1]
    N = mats_blk.shape[-1]
    if (h < 1 or qp.shape != (h + 2,) * 3 + (K,)
            or mats_blk.shape != (26, K, N) or K % 8 or N % 8):
        raise ValueError(f"m2l_grid_blocked: qp {tuple(qp.shape)}, "
                         f"mats_blk {tuple(mats_blk.shape)}")
    if not on_cuda(qp, mats_blk):
        return m2l_grid_blocked_plain(qp, mats_blk)
    check_kernel_args("m2l_grid_blocked", qp=qp, mats_blk=mats_blk)
    out = torch.empty((h, h, h, N), dtype=torch.float32,
                      device=qp.device)
    dirs = _blk_dirs_on(qp.device)
    launch("sctl_m2l_grid_blocked", qp.data_ptr(), mats_blk.data_ptr(),
           dirs.data_ptr(), out.data_ptr(), h, K, N)
    m2l_grid_blocked.launches += 1
    return out


m2l_grid_blocked.launches = 0
