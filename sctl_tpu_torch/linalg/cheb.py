"""Tensor-product Chebyshev basis on boxes, on the host (counterpart of
sctl_tpu/linalg/cheb.py; reference: include/sctl/cheb_utils.hpp:20-1377
— `ChebBasis`: approx/eval/grad/integ of tensor-Chebyshev interpolants
on boxes; legacy in the reference, doc/tutorial/index.rst:70-86).
Float64 numpy, the JAX package's arithmetic; `integ_kernel_face` reads
the port's `bie.legacy_quadrature.duffy_quad` and
`ops.kernels_np.full_matrix_np`.

Conventions: order-q basis uses Chebyshev nodes of the first kind,
x_i = cos((2i+1)pi/(2q)) mapped to the box; coefficients in the T_k
product basis.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def cheb_nodes(q: int, box: Tuple = ((0.0, 1.0),)) -> np.ndarray:
    """Tensor grid of first-kind Chebyshev nodes on a box.

    box: sequence of (lo, hi) per dimension.  Returns (q^d, d) points
    in C order (first dimension slowest)."""
    box = np.asarray(box, np.float64)
    d = len(box)
    x1 = np.cos((2 * np.arange(q) + 1) * np.pi / (2 * q))[::-1]
    grids = [(box[i, 0] + (x1 + 1) / 2 * (box[i, 1] - box[i, 0]))
             for i in range(d)]
    mesh = np.meshgrid(*grids, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1)


def _vander(q: int) -> np.ndarray:
    """(q, q) matrix V[i, k] = T_k(x_i) at first-kind nodes."""
    x1 = np.cos((2 * np.arange(q) + 1) * np.pi / (2 * q))[::-1]
    V = np.zeros((q, q))
    V[:, 0] = 1.0
    if q > 1:
        V[:, 1] = x1
    for k in range(1, q - 1):
        V[:, k + 1] = 2 * x1 * V[:, k] - V[:, k - 1]
    return V


def _analysis(q: int) -> np.ndarray:
    """(q, q) matrix A with coeffs = A @ values (exact inverse of the
    Chebyshev Vandermonde at first-kind nodes, via discrete
    orthogonality)."""
    i = np.arange(q)
    th = (2 * i + 1) * np.pi / (2 * q)
    A = np.cos(np.outer(np.arange(q), th[::-1])) * (2.0 / q)
    A[0] *= 0.5
    return A


def approx(vals: np.ndarray, q: int, dim: int) -> np.ndarray:
    """Values on the cheb_nodes tensor grid -> T-product coefficients.

    vals: (q^dim,) or (q^dim, k).  Returns same shape of coeffs
    (reference: ChebBasis::Approx)."""
    vals = np.asarray(vals, np.float64)
    k = 1 if vals.ndim == 1 else vals.shape[1]
    c = vals.reshape((q,) * dim + (k,))
    A = _analysis(q)
    for ax in range(dim):
        c = np.tensordot(A, np.moveaxis(c, ax, 0), axes=(1, 0))
        c = np.moveaxis(c, 0, ax)
    return c.reshape(q ** dim, k) if vals.ndim > 1 else \
        c.reshape(q ** dim)


def _cheb_t(x: np.ndarray, q: int) -> np.ndarray:
    """(len(x), q) values T_k(x) on [-1,1]."""
    T = np.zeros((len(x), q))
    T[:, 0] = 1.0
    if q > 1:
        T[:, 1] = x
    for k in range(1, q - 1):
        T[:, k + 1] = 2 * x * T[:, k] - T[:, k - 1]
    return T


def evaluate(coeffs: np.ndarray, q: int, pts: np.ndarray,
             box) -> np.ndarray:
    """Evaluate the interpolant at points (M, d) inside the box
    (reference: ChebBasis::Eval)."""
    box = np.asarray(box, np.float64)
    d = len(box)
    pts = np.asarray(pts, np.float64).reshape(-1, d)
    k = 1 if coeffs.ndim == 1 else coeffs.shape[1]
    c = np.asarray(coeffs, np.float64).reshape((q,) * d + (k,))
    xs = [2 * (pts[:, i] - box[i, 0]) / (box[i, 1] - box[i, 0]) - 1
          for i in range(d)]
    Ts = [_cheb_t(x, q) for x in xs]                # (M, q) each
    out = c
    for ax in range(d):
        out = np.einsum("mq,q...->m..." if ax == 0 else "mq,mq...->m...",
                        Ts[ax], out)
    return out.reshape(len(pts), k) if coeffs.ndim > 1 else \
        out.reshape(len(pts))


def grad_coeffs(coeffs: np.ndarray, q: int, box) -> np.ndarray:
    """Coefficients of the gradient (d sets) of a tensor-Chebyshev
    interpolant (reference: ChebBasis::Grad)."""
    box = np.asarray(box, np.float64)
    d = len(box)
    k = 1 if coeffs.ndim == 1 else coeffs.shape[1]
    c = np.asarray(coeffs, np.float64).reshape((q,) * d + (k,))
    D = _deriv_matrix(q)
    out = []
    for ax in range(d):
        scale = 2.0 / (box[ax, 1] - box[ax, 0])
        g = np.tensordot(D, np.moveaxis(c, ax, 0), axes=(1, 0)) * scale
        g = np.moveaxis(g, 0, ax)
        out.append(g.reshape(q ** d, k) if coeffs.ndim > 1 else
                   g.reshape(q ** d))
    return np.stack(out)


def _deriv_matrix(q: int) -> np.ndarray:
    """(q, q) map of T-coefficients -> T-coefficients of d/dx."""
    D = np.zeros((q, q))
    for k in range(q):          # derivative of T_k
        for j in range(k - 1, -1, -2):
            D[j, k] = 2 * k
        if k % 2 == 1:
            D[0, k] = k
    return D


def integrate(coeffs: np.ndarray, q: int, box) -> np.ndarray:
    """Integral of the interpolant over the box
    (reference: ChebBasis::Integ).  int T_k over [-1,1] =
    2/(1-k^2) for even k, 0 for odd."""
    box = np.asarray(box, np.float64)
    d = len(box)
    k = 1 if coeffs.ndim == 1 else coeffs.shape[1]
    c = np.asarray(coeffs, np.float64).reshape((q,) * d + (k,))
    w = np.zeros(q)
    for kk in range(0, q, 2):
        w[kk] = 2.0 / (1 - kk * kk)
    for ax in range(d):
        # each contraction removes the current leading axis
        scale = (box[ax, 1] - box[ax, 0]) / 2
        c = np.tensordot(w, c, axes=(0, 0)) * scale
    return c.reshape(k) if coeffs.ndim > 1 else float(c)


def integ_kernel_face(ker, q: int, trg, side: float, face: int,
                      order_q: int = 16) -> np.ndarray:
    """Kernel integration over a box face: the matrix mapping tensor
    Chebyshev coefficients of a density on `face` of the box
    [0,side]^3 to the potential at target `trg` (reference:
    BasisInterface::Integ<DIM=3,SUBDIM=2>, cheb_utils.hpp:338 +
    Integ_ :1075 — there a bespoke shell/panel sweep; here the same
    geometric-shell rule via bie.legacy_quadrature.duffy_quad with the
    adapt floor set to the target's normal distance).

    Faces are indexed like the reference: face = 2*axis + s where the
    face plane is x[axis] = s*side; the face normal used for
    double-layer kernels is +x[axis] for s=0 and -x[axis] for s=1
    (cheb_utils.hpp:1147-1152).

    Returns (q, q, k0, k1): coefficient (i0, i1) indexes T_{i0} along
    the first in-face axis and T_{i1} along the second, where the
    in-face axes are (axis+1)%3 and (axis+2)%3.
    """
    from ..bie.legacy_quadrature import duffy_quad
    from ..ops.kernels_np import full_matrix_np

    trg = np.asarray(trg, np.float64)
    axis, s = face >> 1, face & 1
    # rotated frame: in-face axes first, face axis last
    perm = [(i + axis + 1) % 3 for i in range(3)]
    t = np.array([trg[p] for p in perm])
    t[2] -= side * s
    r0 = abs(t[2]) / side
    nds, wts = duffy_quad((t[0] / side, t[1] / side), order_q,
                          adapt=(r0 if r0 > 0 else -1.0))
    if len(nds) == 0:
        return np.zeros((q, q, ker.kdim0, ker.kdim1))
    # face points in the original frame
    pts = np.empty((len(nds), 3))
    pts[:, perm[0]] = nds[:, 0] * side
    pts[:, perm[1]] = nds[:, 1] * side
    pts[:, perm[2]] = side * s
    nrm = np.zeros((len(nds), 3))
    nrm[:, axis] = -1.0 if s else 1.0
    M = full_matrix_np(ker, trg[None, :], pts,
                       nrm if ker.needs_normal else None)
    k0, k1 = ker.kdim0, ker.kdim1
    Mq = M.reshape(len(nds), k0, k1)
    # Chebyshev basis on the face (T_k on [-1,1] of the scaled coords)
    B0 = _cheb_t(2 * nds[:, 0] - 1, q)              # (N, q)
    B1 = _cheb_t(2 * nds[:, 1] - 1, q)
    w = wts * side * side                           # area Jacobian
    return np.einsum("ni,nj,n,nab->ijab", B0, B1, w, Mq)
