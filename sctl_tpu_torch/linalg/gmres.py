"""Restarted GMRES on device tensors (counterpart of
sctl_tpu/linalg/gmres.py:279-466, `gmres_device` and
`_make_gmres_cycle`).

Each cycle runs CGS2 Arnoldi with Givens rotations on the operand's
device, in its dtype, as the JAX package's traced loop does, and stops
at the same iteration.  The loop is a Python loop: one scalar, the
residual estimate, is read back to the host after each Arnoldi step
for the convergence test (the JAX package keeps even that on the
device inside a while loop; a CUDA graph of the step is later work).
"""

from __future__ import annotations

from typing import Callable

import torch


def gmres_device(A: Callable, b: torch.Tensor, tol: float = 1e-10,
                 max_iter: int = 100, x0=None, use_abs_tol: bool = False,
                 restarts: int = 1, precond=None, recycle: bool = False):
    """Solve A x = b.  `max_iter` is the cycle length m; up to
    `restarts` cycles run, each restarting from the current iterate,
    until the residual estimate passes tol (relative to |b| unless
    use_abs_tol).  Returns (x, iters, residual_norm): iters counts the
    inner iterations of all cycles, residual_norm is the last cycle's
    Givens estimate, a 0-d tensor.

    `precond` and `recycle` (the Krylov-recycling right preconditioner)
    are not ported and raise NotImplementedError."""
    if precond is not None or recycle:
        raise NotImplementedError(
            "gmres_device: precond= and recycle=True are not ported")
    N = b.shape[0]
    m = int(min(max_iter, N))
    b_norm = float(torch.linalg.vector_norm(b))
    abs_tol = tol * (1.0 if use_abs_tol else b_norm)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    total = 0
    err = torch.tensor(float("inf"), dtype=b.dtype, device=b.device)
    for _ in range(max(1, restarts)):
        x, k, err = _cycle(A, b, x, abs_tol, m)
        total += k
        if not float(err) > abs_tol:
            break
    return x, total, err


def _cycle(A, b, x, abs_tol: float, m: int):
    """One GMRES(m) cycle from x -> (x', k, err)."""
    N, dt, dev = b.shape[0], b.dtype, b.device
    r = b - A(x)
    r_norm = torch.linalg.vector_norm(r)
    Q = torch.zeros((m + 1, N), dtype=dt, device=dev)
    if float(r_norm) > 0:
        Q[0] = r / r_norm
    H = torch.zeros((m + 1, m), dtype=dt, device=dev)
    cs = torch.zeros(m, dtype=dt, device=dev)
    sn = torch.zeros(m, dtype=dt, device=dev)
    beta = torch.zeros(m + 1, dtype=dt, device=dev)
    beta[0] = r_norm
    err, k = r_norm, 0
    while k < m and float(err) > abs_tol:        # the one readback
        w = A(Q[k])
        h1 = Q @ w                               # CGS2; rows > k are 0
        w = w - h1 @ Q
        h2 = Q @ w
        w = w - h2 @ Q
        h_norm = torch.linalg.vector_norm(w)
        Q[k + 1] = w / torch.where(h_norm > 0, h_norm, 1.0)
        hk = (h1 + h2).clone()
        hk[k + 1:] = 0
        hk[k + 1] = h_norm
        for j in range(k):                       # earlier rotations
            a, bj = hk[j].clone(), hk[j + 1].clone()
            hk[j] = cs[j] * a + sn[j] * bj
            hk[j + 1] = -sn[j] * a + cs[j] * bj
        hkk, hk1 = hk[k].clone(), hk[k + 1].clone()
        t = torch.sqrt(hkk * hkk + hk1 * hk1)
        pos = t > 0
        tsafe = torch.where(pos, t, 1.0)
        ck = torch.where(pos, hkk / tsafe, 1.0)
        sk = torch.where(pos, hk1 / tsafe, 0.0)
        hk[k] = ck * hkk + sk * hk1
        hk[k + 1] = 0
        cs[k], sn[k] = ck, sk
        H[:, k] = hk
        bk = beta[k].clone()
        beta[k + 1] = -sk * bk
        beta[k] = ck * bk
        err = beta[k + 1].abs()
        k += 1
    if k:
        y = torch.linalg.solve_triangular(H[:k, :k], beta[:k, None],
                                          upper=True)[:, 0]
        x = x + y @ Q[:k]
    return x, k, err
