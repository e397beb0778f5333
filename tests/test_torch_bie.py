"""The port's boundary-integral path against the JAX package's: the
device near engine (on CPU float64 tensors) against the JAX device
engine forced on, a bare element list through the host near path, the Gauss identity, the operator apply with the far
field through the adaptive FMM, and the Stokes torus Dirichlet solve
of tests/test_bie.py:196-245.  Small geometry: the torus at nu = 6,
nv = 3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctl_tpu.fmm as j_fmm
from sctl_tpu.bie import BoundaryIntegralOp as J_Op
from sctl_tpu.bie import torus_patches as j_torus
from sctl_tpu.linalg import gmres_device as j_gmres
from sctl_tpu.ops import Stokes3D_DxU as J_DXU
from sctl_tpu.ops import Stokes3D_FxU as J_FXU
from sctl_tpu.ops import direct_eval_blocked as j_direct
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.bie import (BoundaryIntegralOp, ParametricPatchList,
                                sphere_patches, torus_patches)
from sctl_tpu_torch.fmm import KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.linalg import gmres_device
from sctl_tpu_torch.ops import (Stokes3D_DxU, Stokes3D_FSxU, Stokes3D_FxU,
                                direct_eval_blocked)

limit_cpu_threads()

F64 = torch.float64


def _ops(q, tol, cutoff=10 ** 12, p=4):
    """The same operator in both packages, both with the device near
    engine, float64; far field through the adaptive FMM at order p
    above `cutoff` far nodes (the port on the JAX package's tables)."""
    jop = J_Op(J_DXU)
    jop.set_accuracy(tol)
    jop.add_elem_list(j_torus(nu=6, nv=3, q=q, R=2.0, r=0.5))
    jop.use_device_near = True
    jop.far_fmm_cutoff = cutoff
    adaptive = j_fmm.AdaptiveFMM
    j_fmm.AdaptiveFMM = functools.partial(adaptive, p=p)
    try:
        jop.setup()
    finally:
        j_fmm.AdaptiveFMM = adaptive
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op.set_accuracy(tol)
    op.add_elem_list(torus_patches(nu=6, nv=3, q=q, R=2.0, r=0.5))
    op.far_fmm_cutoff = cutoff
    op.far_fmm_p = p
    if jop._far_fmm is not None:
        jo = jop._far_fmm._ops
        t = {k: getattr(jo, k) for k in KIFMMOperators.TABLES}
        t.update(p=p, rcond=jo._rcond)
        op.far_fmm_operators = operators_from_numpy(t, "cpu", F64,
                                                    Stokes3D_FSxU)
    return jop, op.setup()


def test_near_engine_matches_jax_torus():
    """Ladder bands, Duffy shells, escalation and the far subtraction
    at tol 1e-4, q = 4 (the test_near_device.py:111-126 structure):
    equal pairs, median row error below 1e-9 of the scale, max below
    30 tol."""
    jop, op = _ops(4, 1e-4)
    assert op.near_pairs == jop.near_pairs and jop._near_fallback_count == 0
    dev = op._near_mats_dev.numpy()
    ref = np.asarray(jop._dev["near_mats"], np.float64)
    assert dev.shape == ref.shape
    d = np.abs(dev - ref).reshape(len(dev), -1).max(1) / np.abs(ref).max()
    assert np.median(d) < 1e-9 and d.max() < 30 * 1e-4


def test_near_engine_gauss_identity_sphere():
    """The double layer of the constant density is -1/2 on the surface
    (test_near_device.py:129, here the Stokes form: the Stokes double
    layer of a rigid translation e is -e/2)."""
    tol = 1e-4
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op.set_accuracy(tol)
    op.add_elem_list(sphere_patches(n_per_face=2, q=4))
    op.far_fmm_cutoff = 10 ** 12
    sigma = np.tile([1.0, 0.0, 0.0], op.dim(0) // 3)
    u = op.compute_potential(sigma)
    assert np.abs(u - [-0.5, 0.0, 0.0]).max() < 20 * tol


def test_apply_matches_jax_adaptive_far_field():
    """compute_potential on the same sigma, float64, far field through
    the adaptive FMM (cutoff lowered to 1,000 far nodes): 1e-9 of the
    max, the adaptive FMM's bar (tests/test_torch_adaptive.py)."""
    jop, op = _ops(4, 1e-4, cutoff=1000)
    assert op._far_fmm is not None and jop._far_fmm is not None
    sigma = np.random.default_rng(0).normal(size=op.dim(0))
    u, u_j = op.compute_potential(sigma), jop.compute_potential(sigma)
    assert np.abs(u - u_j).max() < 1e-9 * np.abs(u_j).max()


def _jax_op_on_near(op, tol, path, cutoff=None):
    """The JAX operator of `op`'s geometry at `tol` whose near matrices
    are `op`'s own, handed over through the JAX package's near-cache
    file (so the JAX side skips its own near assembly); its far field
    through the adaptive FMM above `cutoff` far nodes if given."""
    from types import SimpleNamespace
    jop = J_Op(J_DXU)
    jop.set_accuracy(tol)
    jop.add_elem_list(j_torus(nu=6, nv=3, q=6, R=2.0, r=0.5))
    if cutoff is not None:
        jop.far_fmm_cutoff = cutoff
    key = J_Op._near_key(SimpleNamespace(
        X=op.X, Xt_eff=op.Xt_eff, Xf=op.Xf, wf=op.wf, df=op.df,
        kernel=J_DXU, tol=tol))
    mats = op._near_mats_dev.numpy()
    np.savez(path, key=np.asarray(key), rows=np.full(len(mats),
                                                     mats.shape[1]),
             pairs=np.asarray(op.near_pairs, np.int64).reshape(-1, 2),
             blob=mats.reshape(-1, mats.shape[2]))
    jop.near_cache = str(path)
    jop.setup()
    assert jop._near_key() == key and jop.near_pairs == op.near_pairs
    return jop


def test_stokes_torus_dirichlet_solve(tmp_path):
    """The slice on the CPU: interior Stokes Dirichlet on the torus by
    the double-layer ansatz (the scenario of tests/test_bie.py:196-245
    at q = 6, with bench_bie's quadrature tolerance 1e-6: at test_bie's
    1e-7 the per-pair host rule runs for several hundred more near
    pairs, beyond the tests' time budget), solved by the port's
    gmres_device to 1e-7.
    Iterations within 1 of the JAX gmres_device's on the same operator
    (the JAX package's far field and apply on the port's near
    matrices), residual below 1e-6, interior error against the exact
    Stokeslet below 1e-4."""
    tol = 1e-6
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op.set_accuracy(tol)
    op.add_elem_list(torus_patches(nu=6, nv=3, q=6, R=2.0, r=0.5))
    op.setup()
    src = np.array([[6.0, 0.0, 0.0]])
    q = np.array([[1.0, -0.5, 0.8]])
    b = direct_eval_blocked(Stokes3D_FxU, torch.as_tensor(op.X),
                            torch.as_tensor(src),
                            torch.as_tensor(q)).reshape(-1)
    A = lambda s: op.compute_potential_tensor(s).reshape(-1) - 0.5 * s
    x, iters, err = gmres_device(A, b, tol=1e-7, max_iter=80)

    jop = _jax_op_on_near(op, tol, tmp_path / "near.npz")
    bj = np.asarray(j_direct(J_FXU, jnp.asarray(op.X), jnp.asarray(src),
                             jnp.asarray(q))).reshape(-1)
    np.testing.assert_allclose(b.numpy(), bj, rtol=1e-12)
    Aj = lambda s: jop.compute_potential_jnp(s).reshape(-1) - 0.5 * s
    _, it_j, _ = jax.jit(lambda v: j_gmres(Aj, v, tol=1e-7,
                                           max_iter=80))(jnp.asarray(bj))
    assert abs(iters - int(it_j)) <= 1
    assert float(torch.linalg.vector_norm(A(x) - b)
                 / torch.linalg.vector_norm(b)) < 1e-6

    xt_in = np.array([[2.0, 0.0, 0.0], [0.0, -2.1, 0.15]])
    op2 = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op2.set_accuracy(tol)
    op2.add_elem_list(torus_patches(nu=6, nv=3, q=6, R=2.0, r=0.5))
    op2.set_target_coord(xt_in)
    u_in = op2.compute_potential(x.numpy())
    u_ex = direct_eval_blocked(Stokes3D_FxU, torch.as_tensor(xt_in),
                               torch.as_tensor(src),
                               torch.as_tensor(q)).numpy()
    assert np.abs(u_in - u_ex).max() / np.abs(u_ex).max() < 1e-4


def test_near_interac_matches_jax():
    """The per-pair host rule, with the JAX signature near_interac(kernel,
    xt, elem, tol), that the device engine hands its unresolved pairs:
    nodes of the neighbouring element, at tol 1e-7, through the Duffy
    rule or (where its two orders disagree) adaptive subdivision,
    against the JAX package's near_interac pair by pair: the same
    charts and arithmetic, 1e-12 relative."""
    lst = torus_patches(nu=6, nv=3, q=6, R=2.0, r=0.5)
    jl = j_torus(nu=6, nv=3, q=6, R=2.0, r=0.5)
    X, _, _ = lst.get_node_coord()
    Xt = X[36:36 + 36:5]                    # nodes of element 1
    adaptive = [lst._near_interac_duffy(Stokes3D_DxU, x, 0, 1e-7) is None
                for x in Xt]
    assert any(adaptive) and not all(adaptive)
    for x in Xt:
        m = lst.near_interac(Stokes3D_DxU, x, 0, 1e-7)
        ref = jl.near_interac(J_DXU, x, 0, 1e-7)
        assert m.shape == ref.shape == (36 * 3, 3)
        assert np.abs(m - ref).max() < 1e-12 * np.abs(ref).max()


def test_sqrt_scaling_matches_jax():
    """The node quadrature weights' square-root scaling, the same numpy
    on both sides."""
    v = np.random.default_rng(1).normal(size=(6 * 3 * 16, 3))
    ops = []
    for Op, tp, kw in ((J_Op, j_torus, {}),
                       (BoundaryIntegralOp, torus_patches,
                        {"device": "cpu", "dtype": F64})):
        o = Op(Stokes3D_DxU if kw else J_DXU, **kw)
        o.add_elem_list(tp(nu=6, nv=3, q=4))
        ops.append(o.sqrt_scaling(v))
    np.testing.assert_allclose(ops[1], ops[0], rtol=1e-14)


def test_inv_sqrt_scaling_matches_jax():
    """The inverse square-root scaling, the same numpy on both sides, and
    the inverse of sqrt_scaling."""
    v = np.random.default_rng(2).normal(size=(6 * 3 * 16, 3))
    out = []
    for Op, tp, kw in ((J_Op, j_torus, {}),
                       (BoundaryIntegralOp, torus_patches,
                        {"trg_normal_dot_prod": False, "device": "cpu",
                         "dtype": F64})):
        o = Op(Stokes3D_DxU if "device" in kw else J_DXU, **kw)
        o.add_elem_list(tp(nu=6, nv=3, q=4))
        out.append((o.inv_sqrt_scaling(v), o))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-14)
    np.testing.assert_allclose(out[1][1].sqrt_scaling(out[1][0]), v,
                               rtol=1e-14)


def test_unported_near_paths_raise():
    """An element list without a DeviceGeom takes the host near path by
    default, and its operators match the JAX package's host path (its
    default on the CPU) pair by pair; forcing the device engine on it
    raises, as do the translation kernels' operator tables."""
    lst = torus_patches(nu=6, nv=3, q=4)
    bare = ParametricPatchList(lst.charts, q=4,
                               surface_batch=lst._surface_batch)
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    op.set_accuracy(1e-4)
    op.add_elem_list(bare)
    op.far_fmm_cutoff = 10 ** 12
    op.setup()
    assert op._near_mats_dev is None and len(op._near_mats) == len(
        op.near_pairs) > 0
    jop = J_Op(J_DXU)
    jop.set_accuracy(1e-4)
    jop.add_elem_list(j_torus(nu=6, nv=3, q=4, R=2.0, r=0.5))
    jop.setup()
    assert op.near_pairs == jop.near_pairs
    for m, ref in zip(op._near_mats, jop._near_mats):
        assert np.abs(m - ref).max() <= 1e-12 * np.abs(ref).max()
    forced = BoundaryIntegralOp(Stokes3D_DxU, device="cpu", dtype=F64)
    forced.add_elem_list(bare)
    forced.use_device_near = True
    with pytest.raises(NotImplementedError):
        forced.setup()
    with pytest.raises(NotImplementedError):      # translation kernels
        KIFMMOperators(Stokes3D_DxU, 4, 1e-9, "cpu", F64)
