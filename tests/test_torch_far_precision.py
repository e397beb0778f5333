"""Why the port's adaptive FMM runs every far stage but the U list in
float64: the bench_bie system (Stokes double layer, quadrature tolerance
1e-6, the Stokeslet's boundary data) on a small torus, solved by
gmres_device to 1e-6, once in the JAX package's float32 design (float32
tables at pinv cutoff 3e-5, float32 stages: what it runs on the TPU) and
once in the port's (float32 densities, near corrections and U list,
float64 far stages at cutoff 1e-9).  Both share the near matrices and
the far FMM's order, so they differ only in the far field's precision.

The CPU's scatter is deterministic: two JAX applies of one density are
bit-identical, so a residual that recomputes far above the one GMRES
returns is float32 rounding through the pinv operators (the apply is
not linear to within 1e-6), not the order of a scatter.  The bar is
chip_smoke.py's 1.5e-6 for the recomputed residual."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctl_tpu.fmm as j_fmm
from sctl_tpu.linalg import gmres_device as j_gmres
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
from sctl_tpu_torch.linalg import gmres_device
from sctl_tpu_torch.ops import Stokes3D_DxU, Stokes3D_FxU, direct_eval_blocked

from test_torch_bie import _jax_op_on_near

limit_cpu_threads()

TOL, RESID_BAR, P = 1e-6, 1.5e-6, 4


@pytest.fixture(scope="module")
def port_op():
    """The port's operator at its card design on the CPU."""
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=torch.float32)
    op.set_accuracy(TOL)
    op.add_elem_list(torus_patches(nu=6, nv=3, q=6, R=2.0, r=0.5))
    op.far_fmm_cutoff = 1000
    op.far_fmm_p = P
    op.setup()
    assert op._far_fmm is not None
    return op


def _rhs(X):
    return direct_eval_blocked(
        Stokes3D_FxU, torch.as_tensor(X),
        torch.as_tensor(np.array([[6.0, 0.0, 0.0]])),
        torch.as_tensor(np.array([[1.0, -0.5, 0.8]]))).reshape(-1).numpy()


def test_port_far_f64_residual_recomputes_within_bar(port_op):
    op = port_op
    b = torch.as_tensor(_rhs(op.X), dtype=torch.float32)
    A = lambda s: op.compute_potential_tensor(s).reshape(-1) - 0.5 * s
    x, iters, err = gmres_device(A, b, tol=TOL, max_iter=120)
    nb = float(torch.linalg.vector_norm(b))
    returned = float(err) / nb
    recomputed = float(torch.linalg.vector_norm(A(x) - b)) / nb
    print(f"port, float64 far stages: {iters} iterations, residual "
          f"{returned:.3e} returned, {recomputed:.3e} recomputed")
    assert iters < 120 and returned <= TOL
    assert recomputed <= RESID_BAR


def test_jax_far_f32_residual_recomputes_above_bar(port_op, tmp_path):
    op = port_op
    adaptive = j_fmm.AdaptiveFMM
    j_fmm.AdaptiveFMM = functools.partial(adaptive, p=P)
    try:
        with jax.enable_x64(False):
            jop = _jax_op_on_near(op, TOL, tmp_path / "near.npz",
                                  cutoff=1000)
            assert jop._far_fmm is not None
            assert jop._far_fmm.dtype == jnp.float32
            params = jop.apply_params()
            Af = jax.jit(lambda s, p: jop.compute_potential_jnp(s, p)
                         .reshape(-1) - 0.5 * s)
            A = lambda s: Af(s, params)
            b = jnp.asarray(_rhs(op.X), jnp.float32)
            s0 = jnp.asarray(np.random.default_rng(0).normal(size=b.shape),
                             jnp.float32)
            assert np.array_equal(np.asarray(A(s0)), np.asarray(A(s0)))
            x, iters, err = jax.jit(lambda v: j_gmres(
                A, v, tol=TOL, max_iter=120))(b)
            nb = float(jnp.linalg.norm(b))
            returned = float(err) / nb
            recomputed = float(jnp.linalg.norm(A(x) - b)) / nb
    finally:
        j_fmm.AdaptiveFMM = adaptive
    print(f"JAX package, float32 far stages: {int(iters)} iterations, "
          f"residual {returned:.3e} returned, {recomputed:.3e} recomputed")
    assert int(iters) < 120 and returned <= TOL
    assert recomputed > RESID_BAR and recomputed > 5 * returned
