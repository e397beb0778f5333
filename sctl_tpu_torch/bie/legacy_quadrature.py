"""Geometric-shell Duffy rule descriptors (numpy copy of
sctl_tpu/bie/legacy_quadrature.py `duffy_radii_batch`, the part the
device near engine calls)."""

from __future__ import annotations

import numpy as np

_DUFFY_KMAX = 28      # padded shell cap of the batched rule


def duffy_radii_batch(coords: np.ndarray, order: int,
                      adapts: np.ndarray) -> np.ndarray:
    """Shell-radii ladders (P, K+1) for P (parameter point, adapt)
    pairs: breakpoints at the adapt distance and the distances to the
    square's edges, interleaved with a geometric fill of ratio
    order / 2.  Adapt values below 1e-7 count as 0."""
    coords = np.atleast_2d(np.asarray(coords, np.float64))
    P = len(coords)
    adapts = np.broadcast_to(np.asarray(adapts, np.float64), (P,))
    adapts = np.where(adapts < 1e-7, 0.0, adapts)
    ratio = 0.5 * order
    c0, c1 = coords[:, 0], coords[:, 1]
    vals = np.sort(np.stack(
        [np.zeros(P), adapts, np.abs(c0), np.abs(c0 - 1.0),
         np.abs(c1), np.abs(c1 - 1.0)], 1), axis=1)        # (P, 6)
    start = np.maximum(0.0, vals[:, -2] - 1.0)

    def _bp(idx):
        return np.take_along_axis(vals, np.minimum(idx, 5)[:, None],
                                  1)[:, 0]

    r = start.copy()
    bp_idx = np.zeros(P, np.int64)
    for _ in range(6):
        bp_idx += (bp_idx < 6) & (_bp(bp_idx) <= r)
    cols = [r.copy()]
    active = bp_idx < 6
    while active.any():
        if len(cols) > _DUFFY_KMAX:
            raise RuntimeError("duffy_radii_batch: shell cap exceeded")
        nb = _bp(bp_idx)
        geo = np.where(r > 0, ratio * r, np.inf)
        r_next = np.where(active, np.minimum(geo, nb), r)
        bp_idx += active & (geo >= nb)
        for _ in range(6):
            bp_idx += active & (bp_idx < 6) & (_bp(bp_idx) <= r_next)
        cols.append(r_next)
        r = r_next
        active = bp_idx < 6
    return np.stack(cols, 1)


def duffy_quad(coord, order: int, adapt: float = -1.0):
    """Quadrature on [0, 1]^2 concentrating geometrically at `coord`
    (which may lie outside the square): concentric rectangular shells
    around coord with growth ratio order / 2, each shell's four
    trapezoidal side panels carrying a mapped tensor Gauss rule;
    adapt >= 0 inserts a breakpoint at that radius (numpy copy of
    sctl_tpu/bie/legacy_quadrature.py `duffy_quad` at its defaults).

    Returns (nodes (N, 2), weights (N,))."""
    from ..linalg.quadrule import leg_quad_rule
    coord = np.asarray(coord, np.float64)
    q1, w1 = leg_quad_rule(order)
    eps = 16 * np.finfo(np.float64).eps
    ratio = 0.5 * order
    vals = sorted([0.0, adapt, abs(coord[0]), abs(coord[0] - 1.0),
                   abs(coord[1]), abs(coord[1] - 1.0)])
    X = [max(0.0, vals[-2] - 1.0)]
    for v in vals:
        if v > X[-1]:
            X.append(v)
    radii = [X[0]]
    for v in X[1:]:
        while radii[-1] > 0.0 and ratio * radii[-1] < v:
            radii.append(ratio * radii[-1])
        radii.append(v)
    yy, zz = np.meshgrid(q1, q1, indexing="ij")
    ww = np.outer(w1, w1).ravel()
    yy, zz = yy.ravel(), zz.ravel()
    nds, wts = [], []
    clip = lambda v: min(1.0, max(0.0, v))
    for k in range(len(radii) - 1):
        r0, r1 = radii[k], radii[k + 1]
        for d0 in range(2):
            d1 = 1 - d0
            for sgn in (-1.0, 1.0):
                lo0 = [clip(coord[d] - r0) for d in range(2)]
                hi0 = [clip(coord[d] + r0) for d in range(2)]
                lo1 = [clip(coord[d] - r1) for d in range(2)]
                hi1 = [clip(coord[d] + r1) for d in range(2)]
                f0 = clip(coord[d0] + sgn * r0)
                f1 = clip(coord[d0] + sgn * r1)
                th = abs(f1 - f0)
                w0, w1_ = hi0[d1] - lo0[d1], hi1[d1] - lo1[d1]
                if th * max(w0, w1_) < eps:
                    continue
                nd = np.empty((len(yy), 2))
                nd[:, d0] = f0 * (1 - zz) + f1 * zz
                nd[:, d1] = ((lo0[d1] * (1 - yy) + hi0[d1] * yy) * (1 - zz)
                             + (lo1[d1] * (1 - yy) + hi1[d1] * yy) * zz)
                nds.append(nd)
                wts.append(ww * th * (w0 * (1 - zz) + w1_ * zz))
    if not nds:
        return np.zeros((0, 2)), np.zeros((0,))
    return np.concatenate(nds), np.concatenate(wts)
