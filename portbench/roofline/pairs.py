"""The pair work an evaluation of the uniform-tree FMM needs, counted
from its inputs and the configuration's depth, and the least time the
card needs for it.

The points are binned at the configuration's depth into the cube that
bounds them (the benchmark's own binning, not the program's tree).

- Near field: every unordered pair of distinct points in the same leaf
  box or in two adjacent ones (the 27-box neighbourhood).  Sources are
  the targets and the kernel is symmetric, so each pair counts once:
  the least these inputs need.
- S2M: every point against the check surface of its leaf, and L2T:
  every point against the equivalent surface of its leaf; a surface of
  order p has 6 (p - 1)^2 + 2 points.

M2L is left out: the work it needs depends on the compression an
implementation picks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import peaks


def surface_points(p: int) -> int:
    return 6 * (p - 1) ** 2 + 2


def box_counts(x: torch.Tensor, depth: int) -> torch.Tensor:
    """(n, n, n) int64 point counts of the 2^depth grid over the cube
    that bounds x (N, 3)."""
    n = 1 << depth
    x = x.double()
    lo = x.min(0).values
    side = float((x.max(0).values - lo).max()) * (1 + 1e-12)
    ijk = ((x - lo) / side * n).long().clamp_(0, n - 1)
    flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
    return torch.bincount(flat, minlength=n ** 3).reshape(n, n, n)


def near_pairs(counts: torch.Tensor) -> int:
    """Unordered pairs of distinct points in the same or adjacent
    boxes of the grid `counts`."""
    c = counts.double()
    nb = F.conv3d(c[None, None], torch.ones((1, 1, 3, 3, 3),
                                            dtype=c.dtype,
                                            device=c.device),
                  padding=1)[0, 0]
    ordered = float((c * nb).sum()) - float(c.sum())
    return int(round(ordered / 2))


def uniform_fmm_work(x: torch.Tensor, depth: int, p: int, kernel: str,
                     k0: int, k1: int) -> dict:
    """Pairs, float32 operations and bytes of one evaluation with the
    points x as sources and targets, and the least time each bound
    gives (seconds)."""
    N = x.shape[0]
    counts = box_counts(x, depth)
    ns = surface_points(p)
    pairs = {"near": near_pairs(counts), "s2m": N * ns, "l2t": N * ns}
    total = sum(pairs.values())
    boxes = int((counts > 0).sum())
    # each value read once and written once, float32: the points and
    # densities in, the potentials out; the surfaces' values per box
    nbytes = 4 * (N * (3 + k0) + N * k1 + 2 * boxes * ns * max(k0, k1))
    t_flops = total * peaks.PAIR_FLOPS[kernel] / peaks.F32_FLOPS
    t_rsqrt = total / peaks.RSQRT_PER_S
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    bound = max(t_flops, t_rsqrt, t_bytes)
    by = ("rsqrt" if bound == t_rsqrt else
          "flops" if bound == t_flops else "bytes")
    return dict(pairs=pairs, total_pairs=total, bytes=nbytes,
                t_flops_s=t_flops, t_rsqrt_s=t_rsqrt, t_bytes_s=t_bytes,
                bound_s=bound, bound_by=by)
