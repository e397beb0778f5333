"""The port's GMRES solvers against the JAX package's on the same dense
systems (the cases of tests/test_gmres.py), in float64: the same
iteration count and the same solution.  The restarted device solver
(:109-128, :146), the host loop `gmres` (:13, :25, :32), the `GMRES`
facade (:98), flexible GMRES on the host and on the device (:233,
:264) and the longdouble solver (:292).  The recycling options are in
test_torch_gmres_recycle.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sctl_tpu.linalg import GMRES as J_GMRES
from sctl_tpu.linalg import gmres as j_host
from sctl_tpu.linalg.gmres import fgmres as j_fgmres
from sctl_tpu.linalg.gmres import fgmres_device as j_fgmres_device
from sctl_tpu.linalg.gmres import gmres_device as j_gmres
from sctl_tpu.linalg.gmres import gmres_ld as j_gmres_ld
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import (GMRES, fgmres, fgmres_device, gmres,
                                   gmres_device, gmres_ld)

limit_cpu_threads()


def _rel(x, x_j):
    x, x_j = np.asarray(x), np.asarray(x_j)
    return float(np.abs(x - x_j).max() / np.abs(x_j).max())


def _solve_both(A, b, **kw):
    x_j, it_j, err_j = jax.jit(lambda v: j_gmres(
        lambda u: jnp.asarray(A) @ u, v, **kw))(jnp.asarray(b))
    At = torch.as_tensor(A)
    x, it, err = gmres_device(lambda u: At @ u, torch.as_tensor(b), **kw)
    return (x.numpy(), it, float(err)), (np.asarray(x_j), int(it_j),
                                         float(err_j))


def test_gmres_matches_jax_dense():
    """The case of tests/test_gmres.py:109-128: same iterations, the
    solutions to 1e-10 (the same arithmetic in another order)."""
    rng = np.random.default_rng(3)
    n = 80
    A = np.eye(n) * 4 + rng.normal(size=(n, n)) * 0.3
    b = rng.normal(size=n)
    (x, it, err), (x_j, it_j, err_j) = _solve_both(A, b, tol=1e-10,
                                                   max_iter=n)
    assert it == it_j
    assert np.abs(x - x_j).max() < 1e-10 * np.abs(x_j).max()
    assert np.linalg.norm(A @ x - b) < 1e-9 * np.linalg.norm(b)


def test_gmres_restarted_matches_jax():
    """GMRES(10) with 8 restarts (tests/test_gmres.py:146): one short
    cycle does not converge, the restarts do, in the same total
    iterations as the JAX package."""
    rng = np.random.default_rng(3)
    n = 40
    A = np.eye(n) + 0.25 * rng.normal(size=(n, n)) / np.sqrt(n)
    b = rng.normal(size=n)
    (x1, it1, err1), _ = _solve_both(A, b, tol=1e-10, max_iter=10,
                                     restarts=1)
    (x, it, err), (x_j, it_j, _) = _solve_both(A, b, tol=1e-10,
                                               max_iter=10, restarts=8)
    assert err1 > 1e-10 and it > it1 and it == it_j
    assert err <= 1e-10 * np.linalg.norm(b) * 1.01
    assert np.abs(x - x_j).max() < 1e-10 * np.abs(x_j).max()


def test_host_gmres_random_matrix_matches_jax():
    """tests/test_gmres.py:13 (GMRES<Real>::test): a random 15 x 15
    system to 1e-10; the same iterations, the solutions to 1e-10."""
    rng = np.random.default_rng(0)
    N = 15
    A = rng.random((N, N))
    b = rng.random(N)
    x_j, it_j = j_host(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                       tol=1e-10)
    At = torch.as_tensor(A)
    x, it = gmres(lambda v: At @ v, torch.as_tensor(b), tol=1e-10)
    assert it == it_j <= N
    assert _rel(x, x_j) < 1e-10
    assert np.abs(A @ x.numpy() - b).max() < 1e-9


def test_host_gmres_identity_shortcut():
    """tests/test_gmres.py:25: the identity converges in one step."""
    x, it = gmres(lambda v: v, torch.ones(10, dtype=torch.float64),
                  tol=1e-12)
    x_j, it_j = j_host(lambda v: v, jnp.ones(10), tol=1e-12)
    assert it == it_j == 1
    np.testing.assert_allclose(x.numpy(), 1.0, atol=1e-12)
    assert _rel(x, x_j) < 1e-10


def test_host_gmres_x0_matches_jax():
    """tests/test_gmres.py:32: a solve, then one from its solution,
    which takes no step."""
    rng = np.random.default_rng(1)
    N = 20
    A = rng.random((N, N)) + np.eye(N) * 5
    xs = rng.random(N)
    b = A @ xs
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    x, it1 = gmres(lambda v: At @ v, bt, tol=1e-12)
    x_j, it1_j = j_host(lambda v: Aj @ v, bj, tol=1e-12)
    x2, it2 = gmres(lambda v: At @ v, bt, tol=1e-12, x0=x)
    x2_j, it2_j = j_host(lambda v: Aj @ v, bj, tol=1e-12, x0=x_j)
    assert (it1, it2) == (it1_j, it2_j) and it2 == 0
    assert _rel(x2, x2_j) < 1e-10
    np.testing.assert_allclose(x2.numpy(), xs, atol=1e-9)


def test_gmres_class_facade_matches_jax():
    """tests/test_gmres.py:98: the facade forwards to the host gmres."""
    rng = np.random.default_rng(4)
    N = 30
    A = rng.random((N, N)) + np.eye(N) * 3
    b = rng.random(N)
    At = torch.as_tensor(A)
    x, it = GMRES(verbose=False)(lambda v: At @ v, torch.as_tensor(b),
                                 tol=1e-11)
    x_j, it_j = J_GMRES(verbose=False)(lambda v: jnp.asarray(A) @ v,
                                       jnp.asarray(b), tol=1e-11)
    assert it == it_j
    assert _rel(x, x_j) < 1e-10
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-9 * np.linalg.norm(b)


def test_fgmres_variable_preconditioner_matches_jax():
    """tests/test_gmres.py:233: a Jacobi sweep whose depth changes with
    k; the same iterations and solution, at most the plain solve's
    iterations."""
    rng = np.random.default_rng(3)
    n = 80
    A = np.diag(np.linspace(1.0, 20.0, n)) + 0.1 * rng.normal(size=(n, n))
    b = rng.normal(size=n)
    d = np.diag(A).copy()

    def make_M(op, d):
        def M(v, k):
            z = v / d
            for _ in range((k % 3) + 1):
                z = z + (v - op(z)) / d
            return z
        return M

    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    op = lambda v: At @ v
    x, it = fgmres(op, torch.as_tensor(b), make_M(op, dt), tol=1e-10,
                   max_iter=80)
    op_j = lambda v: jnp.asarray(A) @ v
    x_j, it_j = j_fgmres(op_j, jnp.asarray(b), make_M(op_j, jnp.asarray(d)),
                         tol=1e-10, max_iter=80)
    x0, it0 = gmres(op, torch.as_tensor(b), tol=1e-10, max_iter=80)
    assert it == it_j <= it0
    assert _rel(x, x_j) < 1e-10
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-8 * np.linalg.norm(b)


def test_fgmres_device_matches_jax():
    """tests/test_gmres.py:264: a preconditioner blending Jacobi and
    the identity by the iteration index."""
    rng = np.random.default_rng(4)
    n = 60
    A = np.diag(np.linspace(1.0, 10.0, n)) + 0.05 * rng.normal(size=(n, n))
    b = rng.normal(size=n)
    d = np.diag(A).copy()
    At, dt = torch.as_tensor(A), torch.as_tensor(d)

    def M(v, k):
        w = 1.0 / (1.0 + 0.1 * k)
        return w * (v / dt) + (1.0 - w) * v

    x, it, err = fgmres_device(lambda v: At @ v, torch.as_tensor(b), M,
                               tol=1e-10, max_iter=60)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)

    def M_j(v, k):
        w = 1.0 / (1.0 + 0.1 * k.astype(v.dtype))
        return w * (v / dj) + (1.0 - w) * v

    x_j, it_j, err_j = jax.jit(lambda bb: j_fgmres_device(
        lambda v: Aj @ v, bb, M_j, tol=1e-10, max_iter=60))(jnp.asarray(b))
    assert it == int(it_j)
    assert _rel(x, x_j) < 1e-10
    assert float(err) < 1e-10 * np.linalg.norm(b) * 1.01
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-8 * np.linalg.norm(b)


def test_gmres_ld_matches_jax():
    """tests/test_gmres.py:292: longdouble below the float64 floor; the
    same longdouble arithmetic as the JAX package's, so the solutions
    agree to 1e-18."""
    rng = np.random.default_rng(9)
    n = 60
    A = (np.eye(n) + 0.2 * rng.normal(size=(n, n)) / np.sqrt(n)
         ).astype(np.longdouble)
    b = rng.normal(size=n).astype(np.longdouble)
    x, it = gmres_ld(lambda v: A @ v, b, tol=1e-17, max_iter=n)
    x_j, it_j = j_gmres_ld(lambda v: A @ v, b, tol=1e-17, max_iter=n)
    assert it == it_j <= n
    assert np.abs(x - x_j).max() <= 1e-18 * np.abs(x_j).max()
    r = A @ x - b
    assert float(np.sqrt(r @ r) / np.sqrt(b @ b)) < 1e-16
