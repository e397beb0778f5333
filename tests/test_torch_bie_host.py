"""The port's host near path, near cache and Laplace double-layer BIE
against the JAX package's host path (its default on the CPU), float64
on both sides: `near_interac_batch` pair by pair in each of its classes,
the operator with one and with two element lists (node counts 16 and
25: ragged near matrices), the near cache's round trip and a cache the
JAX package wrote, the interior Dirichlet solve on the sphere of
tests/test_bie.py:89-124, and the Laplace far field through the
adaptive FMM at cutoff 100 (tests/test_bie.py:150-191) on the JAX
package's tables.

Targets are cut where the JAX side would take minutes: the 8 x 4
torus's operator at every sixth node, and near_interac_batch on every
seventh pair of the 6 x 3 torus (Laplace) and on one element's pairs of
the 16 x 8 torus (Stokes: its self pairs at some nodes are the ones the
batched Duffy rule hands to the per-pair rule; the 6 x 3 torus at tol
1e-6 has none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.bie import BoundaryIntegralOp as J_Op
from sctl_tpu.bie.boundary_integral import \
    host_kernel_matrix as j_host_kernel_matrix
from sctl_tpu.bie import sphere_patches as j_sphere
from sctl_tpu.bie import torus_patches as j_torus
from sctl_tpu.fmm.adaptive import AdaptiveFMM as J_Adaptive
from sctl_tpu.linalg import gmres as j_gmres
from sctl_tpu.ops import Laplace3D_DxU as J_LDXU
from sctl_tpu.ops import Laplace3D_FxU as J_LFXU
from sctl_tpu.ops import Stokes3D_DxU as J_SDXU
from sctl_tpu_torch.bie import (BoundaryIntegralOp, sphere_patches,
                                torus_patches)
from sctl_tpu_torch.bie.boundary_integral import host_kernel_matrix
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.linalg import gmres
from sctl_tpu_torch.ops import (Laplace3D_DxU, Laplace3D_FxU, Stokes3D_DxU,
                                direct_eval_blocked)

limit_cpu_threads()

F64 = torch.float64
KERNELS = {"Laplace3D-DxU": (Laplace3D_DxU, J_LDXU),
           "Stokes3D-DxU": (Stokes3D_DxU, J_SDXU)}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _port_op(kernel, lists, tol, Xt=None, **attrs):
    op = BoundaryIntegralOp(kernel, device="cpu", dtype=F64)
    op.set_accuracy(tol)
    for lst in lists:
        op.add_elem_list(lst)
    op.set_target_coord(Xt)
    op.far_fmm_cutoff = 10 ** 12
    for k, v in attrs.items():
        setattr(op, k, v)
    return op


def _jax_op(kernel, lists, tol, Xt=None, cutoff=10 ** 12):
    op = J_Op(kernel)
    op.set_accuracy(tol)
    for lst in lists:
        op.add_elem_list(lst)
    op.set_target_coord(Xt)
    op.far_fmm_cutoff = cutoff
    return op


def _near_pairs(lst, tol):
    """The op's near pairs (target, element) of `lst`'s own nodes,
    without its near operators."""
    op = _port_op(Laplace3D_DxU, [lst], tol)
    op._build_near_matrices = op._setup_device_apply = lambda: None
    op.setup()
    pairs = np.asarray(op.near_pairs)
    return op.X[pairs[:, 0]], pairs[:, 1]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_near_interac_batch_matches_jax(name):
    """near_interac_batch at tol 1e-6, pair by pair within 1e-12 of the
    JAX package's: the ladder bands and the batched Duffy class, and for
    Stokes the per-pair rule too (each class asserted present)."""
    ker, jker = KERNELS[name]
    if name.startswith("Laplace"):
        lst, jl = torus_patches(nu=6, nv=3, q=6), j_torus(nu=6, nv=3, q=6)
        Xt, el = _near_pairs(lst, 1e-6)
        Xt, el = Xt[::7], el[::7]
    else:
        lst, jl = (torus_patches(nu=16, nv=8, q=6),
                   j_torus(nu=16, nv=8, q=6))
        Xt, el = _near_pairs(lst, 1e-6)
        Xt, el = Xt[el == 0], el[el == 0]
    m = lst.near_interac_batch(ker, Xt, el, 1e-6)
    ref = jl.near_interac_batch(jker, Xt, el, 1e-6)
    cls = lst.last_classes
    assert (cls >= 0).any() and (cls == -1).any()
    assert (cls == -2).any() == name.startswith("Stokes")
    assert lst.last_fallback_count == int((cls == -2).sum())
    d = (np.abs(m - ref).reshape(len(m), -1).max(1)
         / np.abs(ref).reshape(len(m), -1).max(1))
    assert d.max() < 1e-12


def test_op_host_path_matches_jax():
    """BoundaryIntegralOp(use_device_near=False) on the 8 x 4 torus at
    tol 1e-6 (tests/test_bie.py:74-86's geometry; targets at every
    sixth node): the same near pairs, the apply within 1e-10 of the JAX
    package's default CPU operator, and the Gauss identity (the double
    layer of 1 is -1/2 on the surface) within 3e-6."""
    lst = torus_patches(nu=8, nv=4, q=6)
    Xt = lst.get_node_coord()[0][::6]
    op = _port_op(Laplace3D_DxU, [lst], 1e-6, Xt, use_device_near=False)
    op.setup()
    assert op._near_mats_dev is None and op._near_fallback_count == 0
    jop = _jax_op(J_LDXU, [j_torus(nu=8, nv=4, q=6)], 1e-6, Xt)
    jop.setup()
    assert op.near_pairs == jop.near_pairs
    sigma = np.random.default_rng(0).normal(size=op.dim(0))
    assert rel(op.compute_potential(sigma),
               jop.compute_potential(sigma)) < 1e-10
    u = op.compute_potential(np.ones(op.dim(0)))
    assert np.abs(u[:, 0] + 0.5).max() < 3e-6


def test_two_lists_ragged_matches_jax():
    """Two element lists, the torus at q = 4 and the sphere inside its
    hole at q = 5, take the host path by default; the near operators
    (16 and 25 rows, pairs across the lists) pad to one (P, 25, 1)
    tensor with zero rows; the apply is within 1e-10 of the JAX
    package's."""
    tol = 1e-4
    lists = [torus_patches(nu=4, nv=2, q=4), sphere_patches(q=5)]
    op = _port_op(Laplace3D_DxU, lists, tol)
    op.setup()
    rows = np.array([m.shape[0] for m in op._near_mats])
    assert op._near_mats_dev is None and set(rows) == {16, 25}
    te = np.array(op.near_pairs)
    n_torus = 4 * 2 * 16
    assert ((te[:, 0] < n_torus) & (te[:, 1] >= 8)).any()
    mats = op._dev["near_mats"].numpy()
    assert mats.shape == (len(rows), 25, 1)
    assert not mats[rows == 16, 16:].any()
    jop = _jax_op(J_LDXU, [j_torus(nu=4, nv=2, q=4), j_sphere(q=5)], tol)
    jop.setup()
    assert op.near_pairs == jop.near_pairs
    sigma = np.random.default_rng(1).normal(size=op.dim(0))
    assert rel(op.compute_potential(sigma),
               jop.compute_potential(sigma)) < 1e-10


def test_near_cache_round_trip(tmp_path):
    """With near_cache set, the first op writes the JAX package's npz
    layout, a second op of the same geometry loads it (no near stages)
    with bit-equal operators and apply, and a changed tol rebuilds."""
    path = str(tmp_path / "near.npz")
    lst = torus_patches(nu=4, nv=2, q=4)
    op1 = _port_op(Laplace3D_DxU, [lst], 1e-4, near_cache=path,
                   use_device_near=False)
    op1.setup()
    z = np.load(path)
    assert sorted(z.files) == ["blob", "key", "pairs", "rows"]
    assert str(z["key"]) == op1._near_key()
    op2 = _port_op(Laplace3D_DxU, [lst], 1e-4, near_cache=path)
    op2.setup()
    assert "near_cache" in op2.setup_times
    assert "near_assembly" not in op2.setup_times
    assert op2.near_pairs == op1.near_pairs
    for a, b in zip(op2._near_mats, op1._near_mats):
        assert np.array_equal(a, b)
    sigma = np.random.default_rng(2).normal(size=op1.dim(0))
    assert np.array_equal(op2.compute_potential(sigma),
                          op1.compute_potential(sigma))
    op3 = _port_op(Laplace3D_DxU, [lst], 1e-5, near_cache=path,
                   use_device_near=False)
    op3.setup()
    assert "near_assembly" in op3.setup_times
    assert str(np.load(path)["key"]) == op3._near_key() != op1._near_key()


def test_near_mats_list_is_the_device_tensor():
    """_near_mats_list() of a device-engine op: one host array a pair,
    the rows of its (P, R, k1) tensor."""
    op = _port_op(Laplace3D_DxU, [torus_patches(nu=4, nv=2, q=4)], 1e-4)
    op.setup()
    mats = op._near_mats_list()
    blob = op._near_mats_dev.numpy()
    assert len(mats) == len(op.near_pairs) == len(blob)
    assert all(np.array_equal(m, b) for m, b in zip(mats, blob))


def test_self_interac_matches_jax():
    """The protocol's default self_interac (near_interac at each of an
    element's own nodes) and host_kernel_matrix against the JAX
    package's: 1e-12."""
    lst, jl = torus_patches(nu=4, nv=2, q=4), j_torus(nu=4, nv=2, q=4)
    for m, ref in zip(lst.self_interac(Laplace3D_DxU, 1e-4),
                      jl.self_interac(J_LDXU, 1e-4)):
        assert m.shape == ref.shape == (16, 16) and rel(m, ref) < 1e-12
    rng = np.random.default_rng(5)
    xt, xs, ns = rng.normal(size=(3, 3)), rng.normal(size=(4, 3)), \
        rng.normal(size=(4, 3))
    assert np.array_equal(host_kernel_matrix(Stokes3D_DxU, xt, xs, ns),
                          j_host_kernel_matrix(J_SDXU, xt, xs, ns))


def test_near_cache_written_by_jax(tmp_path):
    """A cache the JAX package wrote: its key equals the port's for the
    same geometry, and the port reads its pairs and operators bit for
    bit and applies within 1e-12 of the JAX operator."""
    path = str(tmp_path / "near_jax.npz")
    jop = _jax_op(J_LDXU, [j_torus(nu=4, nv=2, q=4)], 1e-4)
    jop.near_cache = path
    jop.setup()
    op = _port_op(Laplace3D_DxU, [torus_patches(nu=4, nv=2, q=4)], 1e-4,
                  near_cache=path)
    op.setup()
    assert op._near_key() == jop._near_key()
    assert "near_cache" in op.setup_times
    assert op.near_pairs == jop.near_pairs
    for a, b in zip(op._near_mats, jop._near_mats):
        assert np.array_equal(a, b)
    sigma = np.random.default_rng(3).normal(size=op.dim(0))
    assert rel(op.compute_potential(sigma),
               jop.compute_potential(sigma)) < 1e-12


def test_interior_dirichlet_solve_matches_jax(tmp_path):
    """tests/test_bie.py:89-124: the interior Laplace Dirichlet problem on
    the sphere (q = 8, tol 1e-8) by the double layer, A(s) = D s - s/2,
    boundary data of a point charge outside; the port's host gmres takes
    the JAX host gmres's iterations on the JAX operator built on the
    port's near operators (handed over through the near cache), under
    30, and the interior potential is within 1e-5 of the exact one."""
    tol = 1e-8
    path = str(tmp_path / "near.npz")
    lst = sphere_patches(n_per_face=1, q=8)
    op = _port_op(Laplace3D_DxU, [lst], tol, use_device_near=False,
                  near_cache=path)
    op.setup()
    X = op.X
    src, q = np.array([[1.7, 0.8, 1.2]]), np.ones((1, 1))
    c = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    bc = direct_eval_blocked(Laplace3D_FxU, c(X), c(src), c(q))[:, 0]
    A = lambda s: op.compute_potential_tensor(s)[:, 0] - 0.5 * s
    x, iters = gmres(A, bc, tol=tol)
    assert iters < 30

    jop = _jax_op(J_LDXU, [j_sphere(n_per_face=1, q=8)], tol)
    jop.near_cache = path
    jop.setup()
    Aj = lambda s: jnp.asarray(jop.compute_potential(np.asarray(s))[:, 0]
                               - 0.5 * np.asarray(s))
    _, it_j = j_gmres(Aj, jnp.asarray(bc.numpy()), tol=tol)
    assert iters == int(it_j)

    xt_in = np.array([[0.3, 0.1, -0.2], [0.0, 0.5, 0.0]])
    op2 = _port_op(Laplace3D_DxU, [lst], tol, xt_in, use_device_near=False)
    u_in = op2.compute_potential(x.numpy())[:, 0]
    u_ex = direct_eval_blocked(Laplace3D_FxU, c(xt_in), c(src),
                               c(q))[:, 0].numpy()
    assert rel(u_in, u_ex) < 1e-5


def test_laplace_far_field_fmm_matches_jax():
    """The Laplace double layer's far field through the adaptive FMM at
    cutoff 100 far nodes (tests/test_bie.py:150-191's sphere, q = 6, tol
    1e-7): AdaptiveFMM(Laplace3D_DxU, ker_l2t=Laplace3D_FxU), p = 6, on
    the JAX package's tables, within 1e-9 of the JAX package's on the
    same weighted far density."""
    lst = sphere_patches(n_per_face=1, q=6)
    Xf, Xnf, wf, _, _ = lst.get_far_field_nodes(1e-7)
    X = lst.get_node_coord()[0]
    jf = J_Adaptive(J_LDXU, ker_l2t=J_LFXU).setup(Xf, X, n_src=Xnf)
    t = {k: getattr(jf._ops, k) for k in KIFMMOperators.TABLES}
    t.update(p=6, rcond=jf._ops._rcond)
    op = _port_op(Laplace3D_DxU, [lst], 1e-7, far_fmm_cutoff=100,
                  far_fmm_operators=operators_from_numpy(
                      t, "cpu", F64, Laplace3D_FxU))
    op.setup()
    fmm = op._far_fmm
    assert fmm is not None and fmm.ker_l2t.name == "Laplace3D-FxU"
    sigma = np.random.default_rng(4).normal(size=(op.dim(0), 1))
    Ff = lst.get_far_field_density(sigma) * wf[:, None]
    u = fmm.unsort(fmm._eval_impl(fmm.pad_density(torch.as_tensor(Ff))))
    u_j = np.asarray(jf.eval_jnp(jnp.asarray(Ff)))
    assert rel(u.numpy(), u_j) < 1e-9
    u_d = direct_eval_blocked(Laplace3D_DxU, torch.as_tensor(X),
                              torch.as_tensor(Xf), torch.as_tensor(Ff),
                              ns=torch.as_tensor(Xnf)).numpy()
    assert rel(u.numpy(), u_d) < 1e-4
