"""bench.py's bench_bie_f64 (:105-186) on the CPU at a small size: the
Stokes double-layer Dirichlet problem on the 6 x 3 torus, q = 6, at
quadrature tolerance 1e-6, with the far field through the adaptive FMM
(p = 6, the cutoff lowered to 1,000 far nodes as
test_torch_bie.py::test_apply_matches_jax_adaptive_far_field does),
float64, solved by the host gmres to a 1e-10 relative residual, in the
port and in the JAX package on the same operator: the JAX package's
tables (its disk cache) in both, the port's near matrices in both
(test_torch_bie.py::_jax_op_on_near).

About 200 s on two threads: the near assembly at q = 6 (about 57 s),
and about 55 iterations of each package's apply, whose far stages run
over every padded leaf slot (the X list alone about 1.1 s a port
apply)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.linalg import gmres as j_gmres
from sctl_tpu.ops import Stokes3D_DxU as J_DXU
from sctl_tpu.ops import Stokes3D_FSxU as J_FS
from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.linalg import gmres
from sctl_tpu_torch.ops import (Stokes3D_DxU, Stokes3D_FSxU, Stokes3D_FxU,
                                direct_eval_blocked)

from test_torch_bie import _jax_op_on_near

limit_cpu_threads()

F64 = torch.float64
TOL, CUTOFF, P = 1e-6, 1000, 6
SOLVE_TOL, MAX_ITER, RESID_BAR = 1e-10, 200, 2e-10


def test_bie_f64_solve_matches_jax(tmp_path):
    """The port's host gmres to 1e-10 takes the JAX host gmres's
    iterations within 1; both residuals recompute to at most 2e-10;
    the solution's potential at tests/test_torch_bie.py's two interior
    points (near corrections included) is within 1e-4 of the exact
    Stokeslet (tests/test_bie.py:244)."""
    jops = J_Ops(J_DXU, J_FS, J_FS, P, 3, 1.0, jnp.float64, rcond=1e-9)
    tables = {k: np.asarray(getattr(jops, k))
              for k in KIFMMOperators.TABLES}
    tables.update(p=P, rcond=1e-9)
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op.set_accuracy(TOL)
    op.add_elem_list(torus_patches(nu=6, nv=3, q=6, R=2.0, r=0.5))
    op.far_fmm_cutoff = CUTOFF
    op.far_fmm_p = P
    op.far_fmm_operators = operators_from_numpy(tables, "cpu", F64,
                                                Stokes3D_FSxU)
    op.setup()
    assert op._far_fmm is not None and op._far_fmm.dtype == F64
    src = np.array([[6.0, 0.0, 0.0]])
    q = np.array([[1.0, -0.5, 0.8]])
    t = lambda a: torch.as_tensor(np.asarray(a))
    b = direct_eval_blocked(Stokes3D_FxU, t(op.X), t(src), t(q)).reshape(-1)
    A = lambda s: op.compute_potential_tensor(s).reshape(-1) - 0.5 * s
    x, iters = gmres(A, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    nb = float(torch.linalg.vector_norm(b))
    resid = float(torch.linalg.vector_norm(A(x) - b)) / nb

    jop = _jax_op_on_near(op, TOL, tmp_path / "near.npz", cutoff=CUTOFF)
    assert jop._far_fmm is not None and jop._far_fmm.p == P
    params = jop.apply_params()
    Aj = jax.jit(lambda s, p: jop.compute_potential_jnp(s, p).reshape(-1)
                 - 0.5 * s)
    bj = jnp.asarray(b.numpy())
    x_j, it_j = j_gmres(lambda s: Aj(s, params), bj, tol=SOLVE_TOL,
                        max_iter=MAX_ITER)
    resid_j = float(jnp.linalg.norm(Aj(x_j, params) - bj)) / nb
    print(f"port: {iters} iterations, residual {resid:.3e}; JAX package: "
          f"{it_j} iterations, residual {resid_j:.3e}")
    assert iters < MAX_ITER and abs(iters - it_j) <= 1
    assert resid <= RESID_BAR and resid_j <= RESID_BAR

    xt_in = np.array([[2.0, 0.0, 0.0], [0.0, -2.1, 0.15]])
    op2 = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op2.set_accuracy(TOL)
    op2.add_elem_list(torus_patches(nu=6, nv=3, q=6, R=2.0, r=0.5))
    op2.set_target_coord(xt_in)
    u_in = op2.compute_potential(x.numpy())
    u_ex = direct_eval_blocked(Stokes3D_FxU, t(xt_in), t(src),
                               t(q)).numpy()
    assert np.abs(u_in - u_ex).max() / np.abs(u_ex).max() < 1e-4
