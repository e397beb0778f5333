"""The port's Krylov recycling against the JAX package's on the same
dense systems (the cases of tests/test_gmres.py), in float64:
`KrylovPrecond` through the host `gmres` (:44), `gmres_device` with a
2-D (U, Qt) pair (:146) and with the 3-D stack of a `recycle=True`
solve (:169), the recycling solve itself (:169), and the inert pairs
of cycles after the one that met tol (:283).  Each case runs both
packages on the same inputs and holds the port to the JAX package's
iteration counts; the (U, Qt) stacks to 1e-10 of their largest
entry."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sctl_tpu.linalg import KrylovPrecond as J_KP
from sctl_tpu.linalg import gmres as j_host
from sctl_tpu.linalg.gmres import gmres_device as j_gmres
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import KrylovPrecond, gmres, gmres_device

limit_cpu_threads()


def _rel(x, x_j):
    x, x_j = np.asarray(x), np.asarray(x_j)
    return float(np.abs(x - x_j).max() / np.abs(x_j).max())


def _ops(A):
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    return (lambda v: At @ v), (lambda v: Aj @ v)


def _device_both(A, b, precond=None, precond_j=None, **kw):
    """gmres_device of both packages on A x = b."""
    op, op_j = _ops(A)
    out = gmres_device(op, torch.as_tensor(b), precond=precond, **kw)
    out_j = jax.jit(lambda v, p: j_gmres(op_j, v, precond=p, **kw))(
        jnp.asarray(b), precond_j)
    return out, out_j


def test_krylov_precond_reuse_matches_jax():
    """tests/test_gmres.py:44 (src/test-linear-solver.cpp): I plus a
    low-rank part of exponentially decaying spectrum; the second solve,
    preconditioned by the first one's subspace, takes the JAX package's
    iterations, under half the first's."""
    rng = np.random.default_rng(2)
    N = 200
    A = np.zeros((N, N))
    for r in range(N):
        u = rng.random((N, 1))
        vt = rng.random((1, N))
        A += u @ vt * np.exp(np.log(np.finfo(np.float64).eps) * r / N)
    A += np.eye(N)
    op, op_j = _ops(A)
    x0a, x0b = rng.random(N), rng.random(N)
    kp, kp_j = KrylovPrecond(), J_KP()
    its = []
    for xs in (x0a, x0b):
        b = A @ xs
        x, it = gmres(op, torch.as_tensor(b), tol=1e-10, krylov_precond=kp)
        x_j, it_j = j_host(op_j, jnp.asarray(b), tol=1e-10,
                           krylov_precond=kp_j)
        assert it == it_j
        assert np.linalg.norm(A @ x.numpy() - b) < 1e-9 * np.linalg.norm(b)
        assert np.abs(x.numpy() - xs).max() < 1e-5
        its.append(it)
    assert kp.size() == N and kp.rank() == kp_j.rank() == sum(its)
    assert its[1] < its[0] / 2, its


def test_gmres_device_pair_precond_matches_jax():
    """tests/test_gmres.py:146: the (U, Qt) pair of a host solve as the
    right preconditioner of a device solve of another right-hand side;
    the same iterations as the JAX package, fewer than without."""
    rng = np.random.default_rng(5)
    n = 60
    A = np.eye(n) + 0.3 * rng.normal(size=(n, n)) / np.sqrt(n)
    op, op_j = _ops(A)
    b1 = rng.normal(size=n)
    kp, kp_j = KrylovPrecond(), J_KP()
    gmres(op, torch.as_tensor(b1), tol=1e-10, krylov_precond=kp)
    j_host(op_j, jnp.asarray(b1), tol=1e-10, krylov_precond=kp_j)
    (Qt, U), (Qt_j, U_j) = kp._pairs[0], kp_j._pairs[0]
    b2 = rng.normal(size=n)
    (x_n, it_n, _), (_, it_n_j, _) = _device_both(A, b2, tol=1e-10,
                                                  max_iter=n)
    (x, it, _), (x_j, it_j, _) = _device_both(A, b2, (U, Qt), (U_j, Qt_j),
                                              tol=1e-10, max_iter=n)
    assert (it_n, it) == (int(it_n_j), int(it_j)) and it < it_n
    assert _rel(x, x_j) < 1e-10
    assert np.linalg.norm(A @ x.numpy() - b2) < 1e-8 * np.linalg.norm(b2)


def test_gmres_device_recycle_matches_jax():
    """tests/test_gmres.py:169: GMRES(12) with 6 restarts collecting one
    (U, Qt) pair a cycle, each cycle preconditioned by the earlier ones;
    then a second right-hand side plain and with the stack as
    `precond`.  Iterations equal the JAX package's.  The first cycle's
    pair agrees to 1e-10 of its largest entry (measured 2.4e-15).  The
    second cycle (6 steps to tol) is ill-conditioned in the JAX package
    itself: b moved by one ulp moves its stack by 4.3e-10 to 1.3e-9 of
    the largest entry, so the whole stack is held to twice the JAX
    package's own one-ulp spread (the port reads 5.0e-10)."""
    rng = np.random.default_rng(7)
    n = 60
    A = np.eye(n) + 0.3 * rng.normal(size=(n, n)) / np.sqrt(n)
    b1 = rng.normal(size=n)
    kw = dict(tol=1e-10, max_iter=12, restarts=6, recycle=True)
    (x, it, err, (U_s, Qt_s)), (x_j, it_j, _, (U_j, Qt_j)) = _device_both(
        A, b1, **kw)
    assert it == int(it_j)
    assert U_s.shape == (6, 12, n) and Qt_s.shape == (6, n, 12)
    assert float(U_s.abs().max()) > 0
    assert _rel(U_s[0], U_j[0]) < 1e-10 and _rel(Qt_s[0], Qt_j[0]) < 1e-10
    spread = {"U": 0.0, "Qt": 0.0}
    for to in (np.inf, -np.inf):
        _, (_, _, _, (U_u, Qt_u)) = _device_both(A, np.nextafter(b1, to),
                                                 **kw)
        spread["U"] = max(spread["U"], _rel(U_u, U_j))
        spread["Qt"] = max(spread["Qt"], _rel(Qt_u, Qt_j))
    assert _rel(U_s, U_j) <= 2 * spread["U"]
    assert _rel(Qt_s, Qt_j) <= 2 * spread["Qt"]
    assert _rel(x, x_j) < 1e-10
    assert np.linalg.norm(A @ x.numpy() - b1) < 1e-8 * np.linalg.norm(b1)

    b2 = rng.normal(size=n)
    (_, it0, _), (_, it0_j, _) = _device_both(A, b2, tol=1e-10,
                                              max_iter=12, restarts=8)
    (xp, itp, _), (xp_j, itp_j, _) = _device_both(
        A, b2, (U_s, Qt_s), (U_j, Qt_j), tol=1e-10, max_iter=12,
        restarts=8)
    assert (it0, itp) == (int(it0_j), int(itp_j)) and itp < it0
    assert _rel(xp, xp_j) < 1e-10
    assert np.linalg.norm(A @ xp.numpy() - b2) < 1e-8 * np.linalg.norm(b2)


def test_recycle_converged_cycles_inert_matches_jax():
    """tests/test_gmres.py:283: the first cycle meets tol, so the other
    slots of the stack stay exactly zero; the stack as `precond` never
    slows a second solve, and the counts are the JAX package's."""
    rng = np.random.default_rng(9)
    n = 40
    A = np.eye(n) + 0.05 * rng.normal(size=(n, n)) / np.sqrt(n)
    b1 = rng.normal(size=n)
    (x, it, _, (U_s, Qt_s)), (_, it_j, _, (U_j, Qt_j)) = _device_both(
        A, b1, tol=1e-10, max_iter=n, restarts=4, recycle=True)
    assert it == int(it_j)
    assert float(U_s[1:].abs().max()) == 0.0
    assert float(Qt_s[1:].abs().max()) == 0.0
    assert _rel(U_s, U_j) < 1e-10 and _rel(Qt_s, Qt_j) < 1e-10
    b2 = rng.normal(size=n)
    (_, it0, _), (_, it0_j, _) = _device_both(A, b2, tol=1e-10, max_iter=n)
    (xp, itp, _), (_, itp_j, _) = _device_both(
        A, b2, (U_s, Qt_s), (U_j, Qt_j), tol=1e-10, max_iter=n)
    assert (it0, itp) == (int(it0_j), int(itp_j)) and itp <= it0
    assert np.linalg.norm(A @ xp.numpy() - b2) < 1e-8 * np.linalg.norm(b2)


def test_pair_of_a_cycle_with_no_step_is_zero():
    """A cycle that starts at the solution runs no step (k = 0) and
    gives an all-zero pair, the JAX package's inert pair."""
    A = np.eye(8) * 2.0
    b = np.ones(8)
    x0 = torch.full((8,), 0.5, dtype=torch.float64)
    op, _ = _ops(A)
    x, it, err, (U_s, Qt_s) = gmres_device(
        op, torch.as_tensor(b), tol=1e-10, max_iter=4, restarts=2,
        x0=x0, recycle=True)
    assert it == 0 and float(err) == 0.0
    assert float(U_s.abs().max()) == 0.0 and float(Qt_s.abs().max()) == 0.0
    np.testing.assert_array_equal(x.numpy(), 0.5)
