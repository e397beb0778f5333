"""The port's restarted GMRES against the JAX package's gmres_device on
the same dense systems (tests/test_gmres.py:109-128 and :146), in
float64: the same iteration count and the same solution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.linalg.gmres import gmres_device as j_gmres
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import gmres_device

limit_cpu_threads()


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


def test_gmres_unported_options_raise():
    A = lambda u: u
    b = torch.ones(4, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        gmres_device(A, b, recycle=True)
    with pytest.raises(NotImplementedError):
        gmres_device(A, b, precond=(b[None], b[None]))
