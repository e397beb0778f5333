"""Quadrature rules on the host (counterpart of sctl_tpu/linalg/
quadrule.py; reference: include/sctl/quadrule.hpp/.txx).

  cheb_quad_rule  — Clenshaw-Curtis on [0,1]        (ChebQuadRule)
  leg_quad_rule   — Gauss-Legendre on [0,1]         (LegQuadRule)
  leg_poly        — Legendre polynomials and their derivatives
  InterpQuadRule  — generalized Chebyshev quadrature for arbitrary
                    integrand families (quadrule.txx:223-…; algorithm
                    DOI:10.1137/080737046 — adaptive panel GL
                    discretization -> orthonormalize (SVD/pivoted QR)
                    -> stable node selection (column-pivoted QR) ->
                    least-squares weights)

Offline precompute in float64 numpy and scipy, the JAX package's
arithmetic; rules cached in the process like the reference's static
caches of nodes and weights.  Nothing here runs on the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def cheb_quad_rule(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Clenshaw-Curtis nodes/weights of order n on [0,1]
    (reference: ChebQuadRule::ComputeNdsWts, quadrule.txx:69)."""
    if n == 1:
        return np.array([0.5]), np.array([1.0])
    # CC points: x_k = cos(k pi/(n-1)), k=0..n-1 on [-1,1]
    k = np.arange(n)
    x = -np.cos(k * np.pi / (n - 1))
    # weights via exact cosine-moment formula
    w = np.zeros(n)
    jj = np.arange(1, (n - 1) // 2 + 1)
    for i in range(n):
        th = i * np.pi / (n - 1)
        s = 1.0 - 2.0 * np.sum(np.cos(2 * jj * th) / (4 * jj * jj - 1))
        if (n - 1) % 2 == 0 and n > 2:
            # the j=(n-1)/2 term enters with coefficient 1, not 2
            s += np.cos((n - 1) * th) / ((n - 1) ** 2 - 1)
        w[i] = 2.0 / (n - 1) * s
    w[0] *= 0.5
    w[-1] *= 0.5
    return (x + 1) / 2, w / 2                       # map to [0,1]


@functools.lru_cache(maxsize=None)
def leg_quad_rule(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights of order n on [0,1]
    (reference: LegQuadRule::ComputeNdsWts via Newton on LegPoly,
    quadrule.txx:150)."""
    x, w = np.polynomial.legendre.leggauss(n)
    # refine by Newton in f64 for full precision (numpy is already good)
    return (x + 1) / 2, w / 2


def leg_poly(x, degree: int):
    """Legendre polynomials P_0..P_degree and derivatives at x in [-1,1]
    (reference: LegQuadRule::LegPoly, quadrule.hpp:102).
    Returns (P (degree+1, len(x)), dP (degree+1, len(x)))."""
    x = np.asarray(x, dtype=np.float64)
    P = np.zeros((degree + 1, len(x)))
    dP = np.zeros((degree + 1, len(x)))
    P[0] = 1.0
    if degree >= 1:
        P[1] = x
        dP[1] = 1.0
    for k in range(1, degree):
        P[k + 1] = ((2 * k + 1) * x * P[k] - k * P[k - 1]) / (k + 1)
        dP[k + 1] = dP[k - 1] + (2 * k + 1) * P[k]
    return P, dP


class InterpQuadRule:
    """Generalized Chebyshev quadrature rules
    (reference: InterpQuadRule, quadrule.hpp:111-195)."""

    @staticmethod
    def adap_quad_rule(fn: Callable, a: float, b: float, tol: float,
                       order: int = 16, max_panels: int = 4096):
        """Adaptive composite panel Gauss-Legendre discretization nodes
        (reference: adap_quad_rule, quadrule.hpp:194): bisect panels
        until per-panel interpolation of every integrand converges."""
        nds0, wts0 = leg_quad_rule(order)
        nds1, wts1 = leg_quad_rule(2 * order)

        def panel_err(lo, hi):
            h = hi - lo
            x0 = lo + nds0 * h
            x1 = lo + nds1 * h
            f0 = np.asarray(fn(x0))                  # (order, nfn)
            f1 = np.asarray(fn(x1))
            i0 = (wts0 * h) @ f0
            i1 = (wts1 * h) @ f1
            return np.max(np.abs(i0 - i1)), np.max(np.abs(i1))

        panels = [(a, b)]
        done = []
        fmax = 0.0
        while panels and len(done) + len(panels) < max_panels:
            lo, hi = panels.pop()
            err, fm = panel_err(lo, hi)
            fmax = max(fmax, fm)
            if err < tol * max(fmax, 1e-300):
                done.append((lo, hi))
            else:
                mid = 0.5 * (lo + hi)
                panels.extend([(lo, mid), (mid, hi)])
        done.extend(panels)
        done.sort()
        nds = np.concatenate([lo + nds0 * (hi - lo) for lo, hi in done])
        wts = np.concatenate([wts0 * (hi - lo) for lo, hi in done])
        return nds, wts

    @staticmethod
    def build_from_matrix(M: np.ndarray, nds: np.ndarray,
                          wts: np.ndarray, eps: float = 1e-16,
                          order: int = 0,
                          nds_interval: Optional[Tuple[float, float]] = None,
                          use_svd: bool = True):
        """Build a quadrature from integrand samples M[i][j] = f_j(x_i)
        (reference: InterpQuadRule::Build, quadrule.txx:230).

        Returns (quad_nds, quad_wts, cond).
        """
        import scipy.linalg as sla
        M = np.asarray(M, dtype=np.float64)
        nds = np.asarray(nds, dtype=np.float64)
        wts = np.asarray(wts, dtype=np.float64)
        sqw = np.sqrt(np.abs(wts))
        Ms = M * sqw[:, None]                        # row-scaled

        # orthonormal basis of the integrand span (columns)
        if use_svd:
            U, S, _ = np.linalg.svd(Ms, full_matrices=False)
            if order and order > 0:
                k = min(order, len(S))
            else:
                k = int(np.sum(S > eps * S[0]))
            k = max(k, 1)
            B = U[:, :k]                             # (n_disc, k)
        else:
            Q, R, _ = sla.qr(Ms, mode="economic", pivoting=True)
            d = np.abs(np.diag(R))
            if order and order > 0:
                k = min(order, len(d))
            else:
                k = int(np.sum(d > eps * d[0]))
            k = max(k, 1)
            B = Q[:, :k]

        # node selection: column-pivoted QR on B^T picks k stable rows
        mask = np.ones(len(nds), dtype=bool)
        if nds_interval is not None:
            lo, hi = nds_interval
            if hi > lo:
                mask = (nds >= lo) & (nds <= hi)
        cand = np.where(mask)[0]
        _, _, piv = sla.qr(B[cand].T, pivoting=True)
        sel = np.sort(cand[piv[:k]])
        quad_nds = nds[sel]

        # least-squares weights: sum_q w_q B[q,l]/sqw[q] = integral of
        # basis l = sum_i wts_i * (B[i,l]/sqw[i])
        A = (B[sel] / sqw[sel, None]).T              # (k, k)
        rhs = (B / sqw[:, None]).T @ wts             # (k,)
        quad_wts, *_ = np.linalg.lstsq(A, rhs, rcond=None)
        cond = float(np.linalg.cond(A))
        return quad_nds, quad_wts, cond

    @staticmethod
    def build(integrands: Callable, a: float, b: float,
              eps: float = 1e-16, order: int = 0,
              nds_interval: Optional[Tuple[float, float]] = None,
              use_svd: bool = True, disc_order: int = 16):
        """Build from an integrand-family callable (reference:
        InterpQuadRule::Build w/ BasisObj, quadrule.hpp:138).

        `integrands(x) -> (len(x), n_fns)` samples every integrand.
        Returns (quad_nds, quad_wts, cond).
        """
        disc_tol = max(eps * 1e-2, 1e-16)
        nds, wts = InterpQuadRule.adap_quad_rule(
            integrands, a, b, disc_tol, order=disc_order)
        M = np.asarray(integrands(nds))
        return InterpQuadRule.build_from_matrix(
            M, nds, wts, eps=eps, order=order,
            nds_interval=nds_interval, use_svd=use_svd)
