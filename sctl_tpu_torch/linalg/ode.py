"""Spectral Deferred Correction (SDC) ODE integrator (counterpart of
sctl_tpu/linalg/ode.py; reference: include/sctl/ode-solver.hpp,
ode-solver.txx:74-306).

  - collocation on 2nd-kind Chebyshev nodes of [0,1]
    (ode-solver.txx:83-89)
  - integration matrix M_time_step (row i integrates the Lagrange
    interpolant from 0 to nds[i]) and interpolation-defect error matrix
    M_error, both built in double-double on the host (QuadReal in the
    reference, ode-solver.txx:77-131) and then moved to the device
  - one step = Picard iterations, each a product Mv = M_time_step @ Mf
    followed by an explicit-Euler "residual time-stepping" sweep
    re-evaluating F at each substep (ode-solver.txx:200-238), with
    convergence/divergence detection on max|dMv|*dt, one scalar read
    back an iteration
  - AdaptiveSolve: accept if max(err_interp, err_picard) < tol_*dt;
    dt <- min(T-t, max(0.5 dt, 0.9 dt ((tol_ dt)/err)^(1/order)))
    (Quaife-Biros step control, ode-solver.txx:264-299)

The state u is a tensor on the solver's device.  With a comm (a
`comm.Comm` over ranks that each hold a part of the state), the
max-norms of the step control are all-reduced with MAX (the reference's
comm.Allreduce(MAX), ode-solver.txx:144-153), so every rank takes the
same steps; None or the self-communicator: one process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import quadmath as qm
from ..config import resolve_device
from .lagrange import interpolation_matrix
from .quadrule import cheb_quad_rule


class StepInfo(NamedTuple):
    error_interp: float
    error_picard: float
    norm_dudt: float
    picard_iter: int


def _second_kind_cheb_nds_dd(order: int) -> qm.DD:
    i = np.arange(order, dtype=np.float64)
    ang = qm.dd_mul(qm.dd_div(qm.dd_pi(), qm.DD(float(order - 1))),
                    qm.DD(i))
    c = qm.dd_cos(ang)
    return qm.dd_add(qm.DD(0.5), qm.dd_mul(qm.DD(-0.5), c))


def _cc_quad_dd(order: int):
    """Clenshaw-Curtis nodes and weights on [0,1] (nodes in DD, weights
    at float64 accuracy)."""
    nds_dd = _second_kind_cheb_nds_dd(order)
    _, wts = cheb_quad_rule(order)
    return nds_dd, qm.DD(wts)


def _max_abs(x, comm=None) -> float:
    m = x.abs().max()
    if comm is not None and not comm.is_self:
        m = comm.allreduce(m, "max")
    return float(m)


class SDC:
    """SDC(order, comm=, device=, dtype=): one-step integrator and
    adaptive time stepping (reference API: SDC<Real>(Order, comm))."""

    def __init__(self, order: int, comm=None, dtype=torch.float64,
                 device=None):
        if order < 2:
            raise ValueError(f"SDC: order {order} < 2")
        self.comm = comm
        self.order = o = order
        self.device = resolve_device(device)
        self.dtype = dtype
        nds0 = _second_kind_cheb_nds_dd(o)

        # M_error = (interp down to order-1 nodes and back)^T - I
        nds1 = _second_kind_cheb_nds_dd(o - 1)
        i0 = interpolation_matrix(nds0, nds1, dd=True)     # (o, o-1)
        i1 = interpolation_matrix(nds1, nds0, dd=True)     # (o-1, o)
        m_err = (i0 @ i1).T - np.eye(o)
        self.M_error = torch.as_tensor(m_err, dtype=dtype,
                                       device=self.device)

        # M_time_step: row i maps f(nds) -> integral_0^{nds[i]} interp(f)
        qx_dd, qw_dd = _cc_quad_dd(o)
        qw64 = qw_dd.to_float64()
        nds64 = nds0.to_float64()
        m_ts = np.zeros((o, o))
        for i in range(o):
            scaled = qm.dd_mul(qx_dd, qm.DD(nds64[i]))
            minterp = interpolation_matrix(nds0, scaled, dd=True)  # (o,o)
            m_ts[i, :] = (minterp @ qw64) * nds64[i]
        self.M_time_step = torch.as_tensor(m_ts, dtype=dtype,
                                           device=self.device)
        self.nds = torch.as_tensor(nds64, dtype=dtype, device=self.device)
        self._nds64 = nds64

    def __call__(self, dt: float, u0, F: Callable,
                 n_picard: Optional[int] = None,
                 tol_picard: float = 0.0):
        """One step: solve u = u0 + int_0^dt F(u).  Returns (u, info)
        (reference: SDC::operator(), ode-solver.txx:143-255)."""
        o = self.order
        if n_picard is None:
            n_picard = o
        u0 = torch.as_tensor(u0, device=self.device)

        f00 = F(u0)
        Mu = [u0 for _ in range(o)]
        Mf0 = [f00 for _ in range(o)]
        Mf1 = [f00 for _ in range(o)]
        Mv = torch.zeros((o,) + tuple(u0.shape), dtype=u0.dtype,
                         device=u0.device)

        nds = self._nds64
        picard_err = []
        it = 0
        while it < n_picard:
            Mv_new = torch.tensordot(self.M_time_step, torch.stack(Mf0),
                                     dims=([1], [0]))
            change = _max_abs(Mv - Mv_new, self.comm) * dt
            Mv = Mv_new
            picard_err.append(change)
            if change < tol_picard or (
                    it > 1 and picard_err[it] > picard_err[it - 2]):
                for i in range(1, o):
                    Mu[i] = u0 + Mv[i] * dt
                break

            # residual time-stepping sweep (ode-solver.txx:216-236)
            v_corr = torch.zeros_like(u0)
            for i in range(1, o):
                v_corr = v_corr + (Mf1[i - 1] - Mf0[i - 1]) * (
                    nds[i] - nds[i - 1])
                Mv[i] += v_corr
                Mu[i] = u0 + Mv[i] * dt
                Mf1[i] = F(Mu[i])
            Mf0 = list(Mf1)
            it += 1

        u = Mu[o - 1]
        err_picard = picard_err[min(it, n_picard - 1)] \
            if picard_err else 0.0
        err_mat = torch.tensordot(self.M_error, Mv, dims=([1], [0]))
        err_interp = _max_abs(err_mat, self.comm) * dt
        norm_dudt = _max_abs(Mv, self.comm) * dt
        return u, StepInfo(err_interp, err_picard, norm_dudt, it)

    def adaptive_solve(self, dt: float, T: float, u0, F: Callable,
                       tol: float, monitor: Optional[Callable] = None,
                       continue_with_errors: bool = False):
        """Adaptive time stepping to time T (reference:
        SDC::AdaptiveSolve, ode-solver.txx:264-299).  `monitor(t, dt, u)`
        is called after each accepted step.
        Returns (u, t_reached, accumulated_error)."""
        o = self.order
        u0_ = torch.as_tensor(u0, device=self.device)
        eps = float(torch.finfo(u0_.dtype).eps)
        t, err_total = 0.0, 0.0
        while t < T and dt > eps * T:
            tol_ = max(tol / T, (tol - err_total) / (T - t))
            u_, info = self(dt, u0_, F, n_picard=2 * o,
                            tol_picard=tol_ * dt * 0.8 ** o)
            max_err = max(info.error_interp, info.error_picard)
            tiny = (continue_with_errors and info.norm_dudt > 0
                    and max_err / info.norm_dudt < 2 * eps)
            if max_err < tol_ * dt or tiny:
                u0_ = u_
                t += dt
                err_total += max_err
                if monitor is not None:
                    monitor(t, dt, u0_)
            if tiny:
                dt = min(T - t, 1.1 * dt)
            else:
                dt = min(T - t, max(
                    0.5 * dt,
                    0.9 * dt * ((tol_ * dt) / max_err) ** (1.0 / o)))
            if T - t <= 0:
                break
        return u0_, t, err_total
