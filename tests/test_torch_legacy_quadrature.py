"""The port's legacy quadrature layer (sctl_tpu_torch/bie/
legacy_quadrature.py) against the JAX package's, function by function,
in float64 on the same numpy inputs, and the reference's Gauss-identity
bars (tests/test_legacy_quadrature.py).

The correction blocks of setup_singular and setup_near_singular subtract
two rules of large, nearly cancelling terms, and the geometry near a
singular point is sensitive to the last bit of the basis sums: the JAX
package's own blocks move by 1.4e-12 (singular) and 3.9e-12 to 7.5e-12
(near) of their maximum when the element nodes move by one ulp.  The
port forms the same sums in torch on a device, in another order (its
blocks read 6.5e-13 to 1.2e-12 and 1.1e-11 to 1.4e-11 against the JAX
package's), so those two are held to four times the JAX package's
one-ulp spread on the same inputs (the larger of +1 and -1 ulp);
everything else to 1e-12 or exactly, the operator's output
(LegacyQuadrature.eval) included."""

import numpy as np
import pytest
import torch

import sctl_tpu.bie.legacy_quadrature as J
import sctl_tpu_torch.bie.legacy_quadrature as T
from sctl_tpu.bie.patches import sphere_patches as j_sphere
from sctl_tpu.ops import Laplace3D_DxU as J_LDXU
from sctl_tpu.ops import Stokes3D_DxU as J_SDXU
from sctl_tpu_torch.bie import (BasisElemList, LegacyQuadrature,
                                TensorBasis, duffy_quad, tensor_gauss_quad)
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.ops import Laplace3D_DxU, Stokes3D_DxU

limit_cpu_threads()

KERNELS = {"Laplace3D-DxU": (Laplace3D_DxU, J_LDXU),
           "Stokes3D-DxU": (Stokes3D_DxU, J_SDXU)}
ULP = 2.0 ** -52


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_pairs(a, b):
    """Largest of the blocks' errors, each relative to its block."""
    n = len(b)
    return float((np.abs(a - b).reshape(n, -1).max(1)
                  / np.abs(b).reshape(n, -1).max(1)).max())


def _elems(order, n_per_face=1):
    charts = j_sphere(n_per_face=n_per_face, q=6).charts
    return (BasisElemList.discretize(order, charts),
            J.BasisElemList.discretize(order, charts))


@pytest.mark.parametrize("order", [6, 8])
def test_tensor_basis_matches_jax(order):
    b, bj = TensorBasis(order, 2), J.TensorBasis(order, 2)
    nds = b.nodes()
    assert np.array_equal(nds, bj.nodes())
    assert np.array_equal(b.eval_matrix(nds), bj.eval_matrix(nds))
    pts = np.concatenate([np.random.default_rng(order).random((2, 40)),
                          nds[:, :3], nds[:, :3] + 1e-9], axis=1)
    assert rel(b.eval_matrix(pts), bj.eval_matrix(pts)) < 1e-12
    for g, gj in zip(b.grad_matrices(pts), bj.grad_matrices(pts)):
        assert rel(g, gj) < 1e-12


def test_duffy_rules_match_jax():
    """duffy_quad (adapt, ratio, max_panel, a point off the square),
    duffy_quad_batch and tensor_gauss_quad: the same nodes and weights."""
    for args in (([0.3, 0.4], 12), ([0.5, 1.08], 16, 0.08),
                 ([0.2, 0.7], 12, -1.0, 3.0, 0.4), ([-0.1, 0.5], 8, 0.05)):
        for a, b in zip(duffy_quad(*args), J.duffy_quad(*args)):
            assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    c = rng.random((24, 2)) * 1.4 - 0.2
    ad = np.concatenate([rng.random(20) * 0.1, [0.0, 5e-8, 1e-3, -1.0]])
    for a, b in zip(T.duffy_quad_batch(c, 12, ad),
                    J.duffy_quad_batch(c, 12, ad)):
        assert np.array_equal(a, b)
    for a, b in zip(tensor_gauss_quad(7), J.tensor_gauss_quad(7)):
        assert np.array_equal(a, b)


def test_basis_elem_list_matches_jax():
    e, ej = _elems(8)
    assert np.array_equal(e.X, ej.X) and e.n_elem == ej.n_elem == 6
    pts = np.random.default_rng(1).random((2, 30))
    for a, b in zip(e.geometry(pts), ej.geometry(pts)):
        assert rel(a, b) < 1e-12
    for a, b in zip(e.geometry(pts, elem=4), ej.geometry(pts, elem=4)):
        assert rel(a, b) < 1e-12


def test_build_nbr_list_matches_jax():
    e, ej = _elems(8, n_per_face=2)
    xt = e.geometry(e.basis.nodes())[0].reshape(-1, 3)
    own = np.repeat(np.arange(e.n_elem), e.basis.size)
    assert np.array_equal(T.build_nbr_list(xt, own, e, 2.5),
                          J.build_nbr_list(xt, own, ej, 2.5))
    off = np.random.default_rng(2).normal(size=(50, 3))
    none = np.full(50, -1)
    assert np.array_equal(T.build_nbr_list(off, none, e, 1.5),
                          J.build_nbr_list(off, none, ej, 1.5))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_setup_singular_matches_jax(name):
    ker, jker = KERNELS[name]
    e, ej = _elems(8)
    nds = e.basis.nodes()[:, ::13]
    m = T.setup_singular(nds, e, ker, 12, 8, device="cpu")
    ref = J.setup_singular(nds, ej, jker, 12, 8)
    spread = max(rel(J.setup_singular(
        nds, J.BasisElemList(8, ej.X * (1 + s * ULP)), jker, 12, 8), ref)
        for s in (1, -1))
    assert m.shape == ref.shape and rel(m, ref) <= 4 * spread


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_setup_near_singular_matches_jax(name):
    ker, jker = KERNELS[name]
    e, ej = _elems(8)
    xt = e.geometry(e.basis.nodes())[0].reshape(-1, 3)
    pairs = T.build_nbr_list(xt, np.repeat(np.arange(6), 64), e, 2.5)[::40]
    m = T.setup_near_singular(xt, pairs, e, ker, 12, 8, device="cpu")
    ref = J.setup_near_singular(xt, pairs, ej, jker, 12, 8)
    spread = max(rel_pairs(J.setup_near_singular(
        xt * (1 + s * ULP), pairs, J.BasisElemList(8, ej.X * (1 + s * ULP)),
        jker, 12, 8), ref) for s in (1, -1))
    assert m.shape == ref.shape and rel_pairs(m, ref) <= 4 * spread


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_legacy_eval_matches_jax(name):
    """LegacyQuadrature.eval against the JAX package's on the same
    density: on the surface at order 4, and at off-surface targets near
    and far at order 8: 1e-12 of the maximum."""
    ker, jker = KERNELS[name]
    k0 = ker.kdim0
    rng = np.random.default_rng(3)
    xt = np.array([[0.0, 0.0, 0.9], [0.55, 0.55, 0.55], [0.0, 0.0, 0.2],
                   [0.0, 1.4, 0.0]])
    for order, Xt in ((4, None), (8, xt)):
        e, ej = _elems(order)
        q = LegacyQuadrature(ker, e, 12, 8, device="cpu",
                             dtype=torch.float64).setup(Xt)
        qj = J.LegacyQuadrature(jker, ej, 12, 8)
        qj.setup(Xt)
        sigma = rng.normal(size=(e.n_elem, e.basis.size, k0))
        assert np.array_equal(q._pairs, qj._pairs)
        assert rel(q.eval(sigma), qj.eval(sigma)) < 1e-12


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_duffy_pairs_match_per_pair_rule(name):
    """The batched Duffy blocks (each panel of the rule a tensor
    product, pairs of one shell count together) against the per-pair
    arithmetic of the reference: duffy_quad at the preimage, the
    element's geometry and _corr_block, on the on-surface near pairs and
    on points 1e-2 off the surface over the elements' edges and corners:
    1e-11 of each block.  (A target within about 1e-6 of an element's
    edge makes its block move by 1e-6 under a one-ulp change of the
    rule's nodes: no two sums of it agree further.)"""
    ker = KERNELS[name][0]
    e, _ = _elems(8)
    nds = np.array([[0.0, 0.3, 1.0, 0.5, 1.0], [0.2, 0.0, 0.7, 1.0, 1.0]])
    x_e, n_e, _ = e.geometry(nds)
    xt = np.concatenate([e.geometry(e.basis.nodes())[0].reshape(-1, 3),
                         (x_e + 1e-2 * n_e).reshape(-1, 3)])
    own = np.concatenate([np.repeat(np.arange(6), 64), np.full(30, -1)])
    pairs = T.build_nbr_list(xt, own, e, 2.5)
    pairs = np.concatenate([pairs[:384][::7], pairs[384:][::5]])
    u0, adapt = T._preimages(xt, pairs, e)
    m = T._duffy_pairs(e.X, pairs[:, 1], xt[pairs[:, 0]], u0, adapt, 12, 8,
                       ker, "cpu")
    assert len(np.unique((np.diff(T.duffy_radii_batch(
        u0, 12, adapt, floor=0.0), axis=1) > 0).sum(1))) >= 3
    ref = np.stack([
        T._corr_block(ker, xt[t], *(lambda g: (g[0], g[1], w * g[2]))(
            e.geometry(nds_.T, elem=int(el))), e.basis.eval_matrix(nds_.T))
        for (t, el), u, a in zip(pairs, u0, adapt)
        for nds_, w in [T.duffy_quad(u, 12, a)]])
    assert rel_pairs(m, ref) < 1e-11


def test_legacy_gauss_identity_laplace():
    """The double layer of 1 is -1/2 on the surface, -1 at interior
    targets near and deep, 0 outside (tests/test_legacy_quadrature.py:
    84-112, the bars 2e-4); eval_tensor gives the same on tensors."""
    e, _ = _elems(8)
    q = LegacyQuadrature(Laplace3D_DxU, e, 12, 8, device="cpu",
                         dtype=torch.float64).setup(None)
    sigma = np.ones((e.n_elem, e.basis.size, 1))
    u = q.eval(sigma)
    assert np.abs(u[:, 0] + 0.5).max() < 2e-4
    ut = q.eval_tensor(torch.ones(e.n_elem, e.basis.size, 1,
                                  dtype=torch.float64))
    assert isinstance(ut, torch.Tensor) and np.array_equal(ut.numpy(), u)
    q.setup(np.array([[0.0, 0.0, 0.9], [0.55, 0.55, 0.55],
                      [0.0, 0.0, 0.2], [0.0, 1.4, 0.0]]))
    u = q.eval(sigma)[:, 0]
    assert np.abs(u[:3] + 1.0).max() < 2e-4 and abs(u[3]) < 2e-4


def test_legacy_gauss_identity_stokes():
    """The Stokes double layer of a rigid translation u0 is -u0/2 on the
    surface (tests/test_legacy_quadrature.py:115-129, bar 5e-3)."""
    e, _ = _elems(6)
    u0 = np.array([0.3, -1.1, 0.7])
    sigma = np.broadcast_to(u0, (e.n_elem, e.basis.size, 3)).copy()
    u = LegacyQuadrature(Stokes3D_DxU, e, 12, 8, device="cpu",
                         dtype=torch.float64).setup(None).eval(sigma)
    assert np.abs(u + 0.5 * u0).max() / np.abs(u0).max() < 5e-3


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_legacy_float32_off_surface(name):
    """float32 (setup in float64, eval in float32) within 1e-5 of float64
    at the off-surface targets near and deep.  On the surface float32
    reads 4e-5 to 4e-4: the far sum's sources lie a node spacing from its
    targets there, and r . n of such pairs cancels."""
    ker = KERNELS[name][0]
    e, _ = _elems(8)
    xt = np.array([[0.0, 0.0, 0.9], [0.55, 0.55, 0.55], [0.0, 0.0, 0.2],
                   [0.0, 1.4, 0.0]])
    sigma = np.random.default_rng(5).normal(
        size=(e.n_elem, e.basis.size, ker.kdim0))
    u = [LegacyQuadrature(ker, e, 12, 8, device="cpu", dtype=dt)
         .setup(xt).eval(sigma) for dt in (torch.float64, torch.float32)]
    assert rel(u[1], u[0]) < 1e-5
