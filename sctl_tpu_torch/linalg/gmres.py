"""GMRES and its Krylov-recycling preconditioner on device tensors
(counterpart of sctl_tpu/linalg/gmres.py).

  KrylovPrecond  P <- P (I + U Qt): the Krylov subspace of each solve
                 preconditions later solves (:43-70).
  gmres          the host loop (:87-181): the basis Q lies on the
                 operand's device in its dtype and CGS2 runs there as
                 two pairs of GEMVs; the Hessenberg matrix, the Givens
                 rotations and the right-hand side are numpy float64 on
                 the host, one projection vector read back per step.
  gmres_device   restarted GMRES(m) whose Arnoldi step, rotations and
                 least squares stay on the device (:279-463), with the
                 (U, Qt) right preconditioner (a 2-D pair or the 3-D
                 stack) and per-cycle recycling (`recycle=True`).
  fgmres, fgmres_device
                 flexible GMRES: a right preconditioner M(v, k) that may
                 change at every iteration, its outputs kept as Z beside
                 Q (:466-626).
  gmres_ld       numpy longdouble throughout (:629-691).
  GMRES          the class facade (:694-709).

Distributed (`comm=`, a `comm.Comm` over the ranks): the vectors are
row-sharded, each rank holding its rows of b, x and the basis, and the
operator maps a rank's rows to its rows.  Every inner product and norm
is all-reduced over the comm (the reference's comm.Allreduce in
inner_prod, lin-solve.txx:68-78; what GSPMD inserts for the JAX package,
tests/test_gmres.py:78-95); the Hessenberg matrix and the rotations are
then the same on every rank.  Without a comm, or with the
self-communicator, nothing changes: the same operations in the same
order.

`gmres_device` and `fgmres_device` are Python loops: the residual
estimate, one scalar, is read back after each Arnoldi step for the
convergence test (the JAX package keeps even that on the device inside
a while loop; a CUDA graph of the step is later work).  Each stops at
the JAX function's iteration, and its state (Q, H, cs, sn) is the JAX
function's, in the operand's dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import profile


class KrylovPrecond:
    """P <- P (I + U Qt) Krylov-subspace preconditioner
    (sctl_tpu/linalg/gmres.py:43-70)."""

    def __init__(self):
        self._pairs = []          # list of (Qt (N,k), U (k,N)), newest first
        self._n = 0

    def size(self) -> int:
        return self._n

    def rank(self) -> int:
        return sum(int(qt.shape[1]) for qt, _ in self._pairs)

    def append(self, Qt, U) -> None:
        n = Qt.shape[0]
        if n != self._n:          # dimension changed: reset
            self._pairs = []
            self._n = n
        self._pairs.insert(0, (Qt, U))

    def apply(self, y, comm=None):
        """y <- y (I + U Qt) for each stored pair, newest first; with a
        comm the rows are sharded and y @ Qt is all-reduced."""
        for Qt, U in self._pairs:
            y = y + _reduced(comm, y @ Qt) @ U
        return y


def _distributed(comm) -> bool:
    return comm is not None and not comm.is_self


def _reduced(comm, t):
    """t summed over the ranks of a distributed comm."""
    return comm.allreduce(t) if _distributed(comm) else t


def _global_len(b, comm=None) -> int:
    """The length of a vector whose rows the ranks of comm share."""
    if not _distributed(comm):
        return int(b.shape[0])
    return int(comm.allreduce(torch.tensor(b.shape[0], device=b.device)))


def _norm(v, comm=None):
    """The 2-norm of a vector whose rows the ranks of comm share."""
    if not _distributed(comm):
        return torch.linalg.vector_norm(v)
    return torch.sqrt(comm.allreduce(torch.linalg.vector_norm(v) ** 2))


def _arnoldi_cgs2(Q, w, comm=None):
    """Orthogonalize w against the rows of Q (zero rows are inert) ->
    (h, q_new, h_norm): the projections, the normalized remainder and
    its norm."""
    h1 = _reduced(comm, Q @ w)
    w = w - h1 @ Q
    h2 = _reduced(comm, Q @ w)     # re-orthogonalization pass
    w = w - h2 @ Q
    nrm = _norm(w, comm)
    return h1 + h2, w / torch.where(nrm > 0, nrm, 1.0), nrm


def _host_start(A, b, x0, tol, use_abs_tol, max_iter, comm=None):
    """The host loops' start: (max_iter, x, r, r_norm, abs_tol); N is
    the global length."""
    N = _global_len(b, comm)
    max_iter = min(N, 500 if max_iter is None else int(max_iter))
    if x0 is not None:
        r, x = b - A(x0), x0
    else:
        r, x = b, torch.zeros_like(b)
    b_norm = float(_norm(b, comm))
    abs_tol = tol * (1.0 if use_abs_tol else b_norm)
    return max_iter, x, r, float(_norm(r, comm)), abs_tol


def _host_step(hk_dev, k, H, cs, sn, beta) -> float:
    """Rotate the new Hessenberg column [h_0..h_k, h_norm] (a device
    tensor, read back once) by the earlier Givens rotations and a new
    one; update H, cs, sn and beta in place; return |beta[k+1]|."""
    hk = hk_dev.cpu().numpy().astype(np.float64)
    for i in range(k):
        t = cs[i] * hk[i] + sn[i] * hk[i + 1]
        hk[i + 1] = -sn[i] * hk[i] + cs[i] * hk[i + 1]
        hk[i] = t
    t = np.hypot(hk[k], hk[k + 1])
    cs[k], sn[k] = hk[k] / t, hk[k + 1] / t
    hk[k] = cs[k] * hk[k] + sn[k] * hk[k + 1]
    hk[k + 1] = 0.0
    H[:k + 2, k] = hk
    beta[k + 1] = -sn[k] * beta[k]
    beta[k] = cs[k] * beta[k]
    return abs(beta[k + 1])


def _host_arnoldi(A_of, Q, max_iter, abs_tol, r_norm, verbose,
                  comm=None):
    """The host loops' Arnoldi iteration over the preallocated basis Q:
    w = A_of(q_k, k) -> (k, H, cs, sn, beta), numpy float64."""
    H = np.zeros((max_iter + 1, max_iter))
    cs = np.zeros(max_iter)
    sn = np.zeros(max_iter)
    beta = np.zeros(max_iter + 1)
    beta[0] = r_norm
    k, error = 0, r_norm
    while k < max_iter and error > abs_tol:
        if verbose:
            print(f"{k:3d} KSP Residual norm {error:.12e}")
        h, q_new, h_norm = _arnoldi_cgs2(Q, A_of(Q[k], k), comm)
        Q[k + 1] = q_new
        error = _host_step(torch.cat([h[:k + 1], h_norm[None]]), k, H, cs,
                           sn, beta)
        k += 1
    if verbose:
        print(f"{k:3d} KSP Residual norm {error:.12e}")
    return k, H, cs, sn, beta


def _back_substitute(H, beta, k) -> np.ndarray:
    """y = H[:k, :k]^-1 beta[:k], upper triangular, on the host."""
    y = np.zeros(k)
    for i in range(k - 1, -1, -1):
        y[i] = (beta[i] - H[i, i + 1:k] @ y[i + 1:k]) / H[i, i]
    return y


def gmres(A: Callable, b: torch.Tensor, tol: float = 1e-10,
          max_iter: Optional[int] = None, use_abs_tol: bool = False,
          x0=None, krylov_precond: Optional[KrylovPrecond] = None,
          verbose: bool = False, comm=None) -> Tuple[torch.Tensor, int]:
    """Solve A x = b by full GMRES (no restart), stopping on |residual|
    <= tol |b| (or tol with use_abs_tol).  Returns (x, iterations).

    The basis is preallocated at (max_iter + 1, N) on b's device, so
    max_iter defaults to min(N, 500), not N.  With `krylov_precond` of
    b's size the solve is right-preconditioned by it, and this solve's
    subspace is appended to it.  comm: the ranks that share the rows
    (see the module docstring); N is then the global length."""
    N, dtype = b.shape[0], b.dtype
    precond = krylov_precond
    apply_P = ((lambda v: precond.apply(v, comm))
               if precond is not None and precond.size() == N
               else (lambda v: v))
    max_iter, x, r, r_norm, abs_tol = _host_start(A, b, x0, tol,
                                                  use_abs_tol, max_iter,
                                                  comm)
    if r_norm <= abs_tol or r_norm == 0.0:
        return x, 0
    Q = b.new_zeros((max_iter + 1, N))
    Q[0] = r / r_norm
    k, H, cs, sn, beta = _host_arnoldi(lambda q, _: A(apply_P(q)), Q,
                                       max_iter, abs_tol, r_norm, verbose,
                                       comm)
    y = _back_substitute(H, beta, k)
    x = x + apply_P(torch.as_tensor(y, dtype=dtype, device=b.device)
                    @ Q[:k])
    if precond is not None and k > 0:
        _append_krylov(precond, Q, H, cs, sn, k)
    return x, k


def _rotation_map(cs, sn, k: int, m: int, like: torch.Tensor):
    """M (m, m+1) in like's dtype and device: rows < k compose this
    solve's Givens rotations on the basis (t_j = q_j for j < k,
    rotations mix rows j and j+1, the last row adds sn[k-1] q_k); rows
    >= k are zero."""
    M = like.new_zeros((m, m + 1))
    M[:k, :k] = torch.eye(k, dtype=like.dtype, device=like.device)
    for j in range(k - 1):
        a, b_row = M[j].clone(), M[j + 1].clone()
        M[j] = cs[j] * a + sn[j] * b_row
        M[j + 1] = -sn[j] * a + cs[j] * b_row
    ek = like.new_zeros(m + 1)
    ek[k] = 1.0
    M[k - 1] = cs[k - 1] * M[k - 1] + sn[k - 1] * ek
    return M


def _append_krylov(precond: KrylovPrecond, Q, H, cs, sn, k: int):
    """Build (Qt, U) from this solve's basis and append
    (sctl_tpu/linalg/gmres.py:184-211): Qt = (M Q[:k+1])^T with M the
    composed rotations, U = H[:k, :k]^-T Q[:k] - Qt^T (the reference's
    back substitution of the rotated triangle).  M and H^-T are formed
    on the host in float64, as the host rotations are."""
    M = _rotation_map(torch.as_tensor(cs), torch.as_tensor(sn), k, k,
                      torch.zeros(0, dtype=torch.float64))
    Hinv = np.linalg.solve(H[:k, :k].T, np.eye(k))
    Qt = (M.to(Q) @ Q[:k + 1]).T                            # (N, k)
    U = torch.as_tensor(Hinv).to(Q) @ Q[:k] - Qt.T
    precond.append(Qt, U)


def _pair_device(Q, H, cs, sn, k: int, m: int):
    """The recycling pair (Qt (N, m), U (m, N)) of one GMRES(m) cycle's
    basis, on the device in its dtype: the fixed-size form of
    `_append_krylov` (sctl_tpu/linalg/gmres.py:214-251).  Columns of Qt
    and rows of U >= k are zero (inert under y + (y @ Qt) @ U); a cycle
    that ran no step (k = 0) gives an all-zero pair."""
    N = Q.shape[1]
    if k == 0:
        return Q.new_zeros((N, m)), Q.new_zeros((m, N))
    Qt = (_rotation_map(cs, sn, k, m, Q) @ Q).T            # (N, m)
    HinvT = torch.linalg.solve_triangular(
        H[:k, :k].T, torch.eye(k, dtype=Q.dtype, device=Q.device),
        upper=False)                                      # Hk^-T
    U = Q.new_zeros((m, N))
    U[:k] = HinvT @ Q[:k] - Qt.T[:k]
    return Qt, U


def _apply_pair_precond(y, precond, comm=None):
    """Right-preconditioner application for a (U, Qt) pair or a stack of
    pairs (sctl_tpu/linalg/gmres.py:254-276).

    2-D (U (k, N), Qt (N, k)): y -> y + (y @ Qt) @ U.
    3-D (U (R, m, N), Qt (R, N, m)): the stack of `gmres_device
    (recycle=True)`, newest (highest) slot first; zero slots are inert.
    """
    if precond is None:
        return y
    U_p, Qt_p = precond
    if U_p.dim() == 2:
        return y + _reduced(comm, y @ Qt_p) @ U_p
    for s in range(U_p.shape[0] - 1, -1, -1):
        y = y + _reduced(comm, y @ Qt_p[s]) @ U_p[s]
    return y


def gmres_device(A: Callable, b: torch.Tensor, tol: float = 1e-10,
                 max_iter: int = 100, x0=None, use_abs_tol: bool = False,
                 restarts: int = 1, precond=None, recycle: bool = False,
                 comm=None):
    """Solve A x = b.  `max_iter` is the cycle length m; up to
    `restarts` cycles run, each restarting from the current iterate,
    until the residual estimate passes tol (relative to |b| unless
    use_abs_tol).  Returns (x, iters, residual_norm): iters counts the
    inner iterations of all cycles, residual_norm is the last cycle's
    Givens estimate, a 0-d tensor.

    `precond` is the right preconditioner y -> y + (y @ Qt) @ U, the
    device form of KrylovPrecond.apply: a 2-D (U, Qt) pair (for example
    `(kp._pairs[0][1], kp._pairs[0][0])` of a host `gmres` with
    `krylov_precond=kp`) or the 3-D stack a `recycle=True` call returns.

    With `recycle=True` each cycle appends its (U, Qt) pair to fixed
    (restarts, m, N) and (restarts, N, m) buffers, and cycle c runs
    right-preconditioned by cycles 0..c-1 (newest first) on top of
    `precond`; returns (x, iters, residual_norm, (U_stack, Qt_stack)),
    whose stack a later solve takes as `precond`.

    comm: the ranks that share the rows (see the module docstring)."""
    m = int(min(max_iter, _global_len(b, comm)))
    b_norm = float(_norm(b, comm))
    abs_tol = tol * (1.0 if use_abs_tol else b_norm)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    if recycle:
        return _gmres_device_recycle(A, b, x, abs_tol, m, restarts,
                                     precond, comm)
    apply_P = lambda y: _apply_pair_precond(y, precond, comm)
    total = 0
    err = torch.tensor(float("inf"), dtype=b.dtype, device=b.device)
    for _ in range(max(1, restarts)):
        x, k, err, _ = _cycle(A, b, x, abs_tol, m, apply_P, comm)
        total += k
        if not float(err) > abs_tol:
            break
    return x, total, err


def _gmres_device_recycle(A, b, x, abs_tol: float, m: int, restarts: int,
                          precond, comm=None):
    """Restarted GMRES with per-cycle Krylov recycling
    (sctl_tpu/linalg/gmres.py:348-385): cycle c runs right-preconditioned
    by the pairs of cycles 0..c-1, newest first, then by `precond`."""
    R, N = int(restarts), b.shape[0]
    Qt_buf = b.new_zeros((R, N, m))
    U_buf = b.new_zeros((R, m, N))

    def apply_P(y):
        return _apply_pair_precond(
            _apply_pair_precond(y, (U_buf, Qt_buf), comm), precond, comm)

    total = 0
    err = torch.tensor(float("inf"), dtype=b.dtype, device=b.device)
    for c in range(R):
        x, k, err, (Q, H, cs, sn) = _cycle(A, b, x, abs_tol, m, apply_P,
                                           comm)
        Qt_buf[c], U_buf[c] = _pair_device(Q, H, cs, sn, k, m)
        total += k
        if not float(err) > abs_tol:
            break
    return x, total, err, (U_buf, Qt_buf)


def _givens_column(hk, k: int, cs, sn):
    """Apply the rotations 0..k-1 to the column hk (m+1,) and form the
    k-th; returns (hk rotated, c_k, s_k), all on the device."""
    for j in range(k):
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
    return hk, ck, sk


def _device_arnoldi(step, Q, r_norm, abs_tol: float, m: int, comm=None):
    """The device loops' Arnoldi iteration: w = step(k) for k = 0, 1, ...
    until m steps or the residual estimate passes abs_tol (one scalar
    read back a step) -> (k, err, H, cs, sn, beta), device tensors in
    Q's dtype."""
    dt, dev = Q.dtype, Q.device
    H = torch.zeros((m + 1, m), dtype=dt, device=dev)
    cs = torch.zeros(m, dtype=dt, device=dev)
    sn = torch.zeros(m, dtype=dt, device=dev)
    beta = torch.zeros(m + 1, dtype=dt, device=dev)
    beta[0] = r_norm
    err, k = r_norm, 0
    while k < m and float(err) > abs_tol:        # the one readback
        h, q_new, h_norm = _arnoldi_cgs2(Q, step(k), comm)
        Q[k + 1] = q_new
        hk = h.clone()                           # rows > k of Q are 0
        hk[k + 1:] = 0
        hk[k + 1] = h_norm
        hk, ck, sk = _givens_column(hk, k, cs, sn)
        cs[k], sn[k] = ck, sk
        H[:, k] = hk
        bk = beta[k].clone()
        beta[k + 1] = -sk * bk
        beta[k] = ck * bk
        err = beta[k + 1].abs()
        k += 1
    return k, err, H, cs, sn, beta


def _first_basis(r, m: int, comm=None):
    """(Q (m+1, N) with q_0 = r / |r| (zero if r is), |r|)."""
    r_norm = _norm(r, comm)
    Q = r.new_zeros((m + 1, r.shape[0]))
    if float(r_norm) > 0:
        Q[0] = r / r_norm
    return Q, r_norm


def _cycle(A, b, x, abs_tol: float, m: int, apply_P, comm=None):
    """One right-preconditioned GMRES(m) cycle from x
    (sctl_tpu/linalg/gmres.py:388-463): the basis of A(P(q_k)), then
    x + P(y @ Q) -> (x', k, err, (Q, H, cs, sn))."""
    Q, r_norm = _first_basis(b - A(x), m, comm)
    k, err, H, cs, sn, beta = _device_arnoldi(
        lambda k: A(apply_P(Q[k])), Q, r_norm, abs_tol, m, comm)
    if k:
        y = torch.linalg.solve_triangular(H[:k, :k], beta[:k, None],
                                          upper=True)[:, 0]
        x = x + apply_P(y @ Q[:k])
    return x, k, err, (Q, H, cs, sn)


def fgmres(A: Callable, b: torch.Tensor, M: Callable, tol: float = 1e-10,
           max_iter: Optional[int] = None, use_abs_tol: bool = False,
           x0=None, verbose: bool = False) -> Tuple[torch.Tensor, int]:
    """Flexible GMRES (Saad 1993) on the host loop of `gmres`: right
    preconditioning by ``M(v, k) -> z``, which may change at every
    iteration k (an inner solve to a loose tolerance, a cycling
    multilevel sweep).  The preconditioned vectors z_k = M(q_k, k) are
    kept as Z, one more (max_iter, N) buffer, and x += y @ Z.

    Returns (x, iterations)."""
    N = b.shape[0]
    max_iter, x, r, r_norm, abs_tol = _host_start(A, b, x0, tol,
                                                  use_abs_tol, max_iter)
    if r_norm <= abs_tol or r_norm == 0.0:
        return x, 0
    Q = b.new_zeros((max_iter + 1, N))
    Q[0] = r / r_norm
    Z = b.new_zeros((max_iter, N))

    def A_of(q, k):
        Z[k] = M(q, k)
        return A(Z[k])

    k, H, cs, sn, beta = _host_arnoldi(A_of, Q, max_iter, abs_tol, r_norm,
                                       verbose)
    y = _back_substitute(H, beta, k)
    return x + torch.as_tensor(y, dtype=b.dtype, device=b.device) @ Z[:k], k


def fgmres_device(A: Callable, b: torch.Tensor, M: Callable,
                  tol: float = 1e-10, max_iter: int = 100, x0=None,
                  use_abs_tol: bool = False):
    """FGMRES(m), one cycle, in the form of `gmres_device`: the right
    preconditioner ``M(v, k)`` may depend on the iteration index k (a
    Python int); the preconditioned basis Z (one more (m, N) buffer)
    forms x = x0 + y @ Z.  Returns (x, iters, residual_norm)."""
    N = b.shape[0]
    m = int(min(max_iter, N))
    b_norm = float(torch.linalg.vector_norm(b))
    abs_tol = tol * (1.0 if use_abs_tol else b_norm)
    x0v = torch.zeros_like(b) if x0 is None else x0
    Q, r_norm = _first_basis(b - A(x0v), m)
    Z = b.new_zeros((m, N))

    def step(k):
        Z[k] = M(Q[k], k)
        return A(Z[k])

    k, err, H, _, _, beta = _device_arnoldi(step, Q, r_norm, abs_tol, m)
    if not k:
        return x0v, 0, err
    y = torch.linalg.solve_triangular(H[:k, :k], beta[:k, None],
                                      upper=True)[:, 0]
    return x0v + y @ Z[:k], k, err


def gmres_ld(A: Callable, b, tol: float = 1e-16,
             max_iter: Optional[int] = None, use_abs_tol: bool = False,
             verbose: bool = False):
    """Host longdouble GMRES (sctl_tpu/linalg/gmres.py:629-691): the
    reference's GMRES<long double> configuration, converging below the
    float64 residual floor (about 1e-15).

    A maps longdouble (N,) -> (N,) (numpy).  Pure numpy MGS Arnoldi and
    Givens least squares, all in np.longdouble.  Returns (x, iters)."""
    b = np.asarray(b, np.longdouble)
    N = b.shape[0]
    if max_iter is None:
        max_iter = min(int(N), 500)
    max_iter = min(max_iter, int(N))

    b_norm = float(np.sqrt(b @ b))
    abs_tol = tol * (1.0 if use_abs_tol else b_norm)
    r = b
    x = np.zeros(N, np.longdouble)
    r_norm = float(np.sqrt(r @ r))
    if r_norm <= abs_tol or r_norm == 0.0:
        return x, 0

    Q = np.zeros((max_iter + 1, N), np.longdouble)
    Q[0] = r / r_norm
    H = np.zeros((max_iter + 1, max_iter), np.longdouble)
    cs = np.zeros(max_iter, np.longdouble)
    sn = np.zeros(max_iter, np.longdouble)
    beta = np.zeros(max_iter + 1, np.longdouble)
    beta[0] = r_norm

    k = 0
    error = r_norm
    while k < max_iter and error > abs_tol:
        if verbose:
            print(f"{k:3d} KSP Residual norm {float(error):.12e}")
        w = np.asarray(A(Q[k]), np.longdouble)
        for i in range(k + 1):          # modified Gram-Schmidt
            H[i, k] = Q[i] @ w
            w = w - H[i, k] * Q[i]
        H[k + 1, k] = np.sqrt(w @ w)
        Q[k + 1] = w / (H[k + 1, k] if H[k + 1, k] > 0 else 1.0)
        for i in range(k):
            t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
            H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
            H[i, k] = t
        t = np.sqrt(H[k, k] ** 2 + H[k + 1, k] ** 2)
        cs[k], sn[k] = H[k, k] / t, H[k + 1, k] / t
        H[k, k] = cs[k] * H[k, k] + sn[k] * H[k + 1, k]
        H[k + 1, k] = 0.0
        beta[k + 1] = -sn[k] * beta[k]
        beta[k] = cs[k] * beta[k]
        error = abs(float(beta[k + 1]))
        k += 1
    if verbose:
        print(f"{k:3d} KSP Residual norm {float(error):.12e}")

    y = np.zeros(k, np.longdouble)
    for i in range(k - 1, -1, -1):
        y[i] = (beta[i] - H[i, i + 1:k] @ y[i + 1:k]) / H[i, i]
    return x + y @ Q[:k], k


class GMRES:
    """Class facade of the reference API (GMRES<Real>(comm, verbose);
    operator()), forwarding to `gmres` with its comm (the ranks that
    share the rows; None or the self-communicator: one process); each
    call is timed in the profile block "GMRES" (with sync), as at
    sctl_tpu/linalg/gmres.py:705."""

    def __init__(self, comm=None, verbose: bool = False):
        self.comm = comm
        self.verbose = verbose

    def __call__(self, A, b, tol: float = 1e-10,
                 max_iter: Optional[int] = None,
                 use_abs_tol: bool = False, x0=None,
                 krylov_precond: Optional[KrylovPrecond] = None):
        with profile.Profile.scoped("GMRES", sync=True):
            return gmres(A, b, tol=tol, max_iter=max_iter,
                         use_abs_tol=use_abs_tol, x0=x0,
                         krylov_precond=krylov_precond,
                         verbose=self.verbose, comm=self.comm)
