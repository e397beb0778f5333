"""The port's SDC integrator against the JAX package's (the harmonic
oscillator of tests/test_ode.py) on the same inputs, in float64 on the
CPU.  The tables are built by the same double-double numpy code, so
they agree bit for bit; a step's products run in torch and XLA in their
own summation orders, so fixed steps agree to 1e-13.  The adaptive
solve reads the same scalars and takes the same decisions: the same
number of accepted steps, the same t, and the JAX test's 10 x tol bar.
The step sizes themselves drift apart in the last digits: the
interpolation-error estimate M_error @ Mv cancels down to tol dt (at
order 12 and tol 1e-12 about 1e-13 of Mv), so its rounding moves each
dt by up to about 1e-5 relative in either package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.linalg import SDC as J_SDC
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import SDC, StepInfo

limit_cpu_threads()


def harmonic(u):
    """du/dt = (-u1, u0): u0(t) = cos(t) from (1, 0)."""
    return torch.stack([-u[1], u[0]])


def j_harmonic(u):
    return jnp.stack([-u[1], u[0]])


@pytest.mark.parametrize("order", [5, 12])
def test_tables_bit_for_bit(order):
    s, j = SDC(order, device="cpu"), J_SDC(order)
    for name in ("M_error", "M_time_step", "nds"):
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(j, name)))


@pytest.mark.parametrize("order", [5, 12])
def test_fixed_steps(order):
    """dt = 0.1 to T = 0.6, each step's u and StepInfo against JAX's."""
    s, j = SDC(order, device="cpu"), J_SDC(order)
    u = torch.tensor([1.0, 0.0], dtype=torch.float64)
    ju = jnp.asarray([1.0, 0.0])
    for _ in range(6):
        u, info = s(0.1, u, harmonic)
        ju, jinfo = j(0.1, ju, j_harmonic)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                                   atol=1e-13)
        assert isinstance(info, StepInfo)
        assert info.picard_iter == jinfo.picard_iter
        for a, b in zip(info[:3], jinfo[:3]):
            assert abs(a - b) <= 1e-13 + 1e-9 * abs(b)
    assert abs(float(u[0]) - np.cos(0.6)) < 1e-9


@pytest.mark.parametrize("order,tol", [(5, 1e-5), (12, 1e-12)])
def test_adaptive_solve(order, tol):
    """tests/test_ode.py:39-48 through both packages: the same accepted
    steps and t, and the error within 10 tol."""
    steps, j_steps = [], []
    u, t, err = SDC(order, device="cpu").adaptive_solve(
        0.1, 10.0, torch.tensor([1.0, 0.0], dtype=torch.float64), harmonic,
        tol, monitor=lambda t, dt, u: steps.append(t))
    ju, jt, jerr = J_SDC(order).adaptive_solve(
        0.1, 10.0, jnp.asarray([1.0, 0.0]), j_harmonic, tol,
        monitor=lambda t, dt, u: j_steps.append(t))
    assert len(steps) == len(j_steps)
    assert t == jt and abs(t - 10.0) < 1e-12
    assert abs(float(u[0]) - np.cos(10.0)) < 10 * tol
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                               atol=10 * tol)


def test_step_info():
    """tests/test_ode.py:51-56."""
    u, info = SDC(4, device="cpu")(0.05, torch.tensor([1.0, 0.0],
                                                      dtype=torch.float64),
                                   harmonic)
    assert info.picard_iter <= 4 and info.error_interp < 1e-6
    assert 0.04 < info.norm_dudt < 0.06
    assert StepInfo._fields == ("error_interp", "error_picard",
                                "norm_dudt", "picard_iter")


def test_state_on_the_solver_device():
    s = SDC(3, device="cpu")
    u, info = s(0.1, np.array([1.0, 0.0]), harmonic)
    assert u.device.type == "cpu" and s.M_time_step.device.type == "cpu"
    # a comm is taken, as the JAX package's SDC takes one; the
    # self-communicator leaves the step as it was, bit for bit
    from sctl_tpu.comm import Comm as J_Comm
    from sctl_tpu_torch.comm import Comm
    J_SDC(3, comm=J_Comm())
    s1 = SDC(3, comm=Comm.self_(), device="cpu")
    u1, info1 = s1(0.1, np.array([1.0, 0.0]), harmonic)
    assert s1.comm.is_self and info1 == info
    assert torch.equal(u1, u)
