"""The port's tensor-Chebyshev basis (`linalg.cheb`) and the direct sums
`direct_eval` and `kernel_matrix` (`ops.direct`) against the JAX
package's on the same inputs, at 1e-12 of the maximum: the Chebyshev
functions are the same numpy code (their kernel-face integrals read
each package's own kernel formulas and Duffy rule); the direct sums are
torch's plain pairwise form against XLA's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu import ops as jops
from sctl_tpu.linalg import cheb as jcheb
from sctl_tpu.ops.direct import direct_eval as j_direct_eval
from sctl_tpu.ops.direct import kernel_matrix as j_kernel_matrix
from sctl_tpu_torch import ops
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import cheb
from sctl_tpu_torch.ops import direct_eval, kernel_matrix

limit_cpu_threads()

BAR = 1e-12
KERNELS = ["Laplace3D_FxU", "Laplace3D_DxU", "Laplace3D_FxdU",
           "Stokes3D_FxU", "Stokes3D_DxU", "Stokes3D_FxT",
           "Stokes3D_FSxU", "Stokes3D_FxUP"]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


BOX3 = [(0, 1), (-1, 1), (0.5, 2)]


def f3(x):
    return np.sin(2 * x[:, 0]) * np.exp(x[:, 1]) + x[:, 2] ** 3


@pytest.mark.parametrize("q,box", [(12, BOX3), (8, [(0, 1)]),
                                   (9, [(0, 2), (0, 1)])])
def test_basis_matches_jax(q, box):
    d = len(box)
    pts = cheb.cheb_nodes(q, box)
    np.testing.assert_array_equal(pts, jcheb.cheb_nodes(q, box))
    vals = np.stack([np.cos(pts.sum(1)), np.exp(pts[:, 0])], axis=1)
    c = cheb.approx(vals, q, d)
    assert rel(c, jcheb.approx(vals, q, d)) < BAR
    assert rel(cheb.approx(vals[:, 0], q, d),
               jcheb.approx(vals[:, 0], q, d)) < BAR
    rng = np.random.default_rng(q)
    tp = np.stack([rng.uniform(lo, hi, 30) for lo, hi in box], axis=-1)
    assert rel(cheb.evaluate(c, q, tp, box),
               jcheb.evaluate(c, q, tp, box)) < BAR
    assert rel(cheb.grad_coeffs(c, q, box),
               jcheb.grad_coeffs(c, q, box)) < BAR
    assert rel(cheb.integrate(c, q, box), jcheb.integrate(c, q, box)) < BAR


def test_approx_eval_3d_accuracy():
    """tests/test_cheb.py:14-24 on the port."""
    q = 12
    pts = cheb.cheb_nodes(q, BOX3)
    coeffs = cheb.approx(f3(pts), q, 3)
    rng = np.random.default_rng(0)
    tp = np.stack([rng.uniform(lo, hi, 50) for lo, hi in BOX3], axis=-1)
    np.testing.assert_allclose(cheb.evaluate(coeffs, q, tp, BOX3),
                               f3(tp), atol=1e-9)


@pytest.mark.parametrize("ker", ["Laplace3D_FxU", "Laplace3D_DxU",
                                 "Stokes3D_FxU"])
@pytest.mark.parametrize("face", [0, 3, 4])
def test_integ_kernel_face_matches_jax(ker, face):
    trg = np.array([0.3, -0.4, 0.7])
    M = cheb.integ_kernel_face(getattr(ops, ker), 3, trg, 0.8, face,
                               order_q=10)
    jM = jcheb.integ_kernel_face(getattr(jops, ker), 3, trg, 0.8, face,
                                 order_q=10)
    assert M.shape == jM.shape
    assert rel(M, jM) < BAR


def test_integ_kernel_face_on_face_singular():
    """tests/test_cheb.py:72-85: a constant density over the z=0 face,
    target at its center: ln(1 + sqrt 2) / pi."""
    M = cheb.integ_kernel_face(ops.Laplace3D_FxU, 4, [0.5, 0.5, 0.0],
                               1.0, 4, order_q=16)
    np.testing.assert_allclose(M[0, 0, 0, 0],
                               np.log(1 + np.sqrt(2)) / np.pi, rtol=1e-10)


def _points(seed, ker, nt=40, ns=70):
    rng = np.random.default_rng(seed)
    xt, xs = rng.random((nt, 3)), rng.random((ns, 3))
    xs[:3] = xt[:3]                     # coincident pairs: masked to 0
    f = rng.normal(size=(ns * ker.kdim0,))
    n = rng.normal(size=(ns, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return xt, xs, f, (n if ker.needs_normal else None)


@pytest.mark.parametrize("name", KERNELS)
def test_direct_eval_matches_jax(name):
    ker, jker = getattr(ops, name), getattr(jops, name)
    xt, xs, f, n = _points(1, ker)
    u = direct_eval(ker, torch.as_tensor(xt), xs, f, ns=n, device="cpu")
    ju = j_direct_eval(jker, jnp.asarray(xt), jnp.asarray(xs),
                       jnp.asarray(f), None if n is None
                       else jnp.asarray(n))
    assert u.shape == (len(xt), ker.kdim1) and u.dtype == torch.float64
    # the JAX applied form of Stokes3D-FxT expands r_j r_k in source
    # moments (sctl_tpu/ops/uker.py `_uk_stk_fxt`), which cancels to
    # about 5e-12 (tests/test_torch_formulas.py:66-72): there the port
    # is held to the JAX per-pair matrix applied at 1e-12 and to the
    # JAX sum at 1e-10
    if name == "Stokes3D_FxT":
        jK = np.asarray(j_kernel_matrix(jker, jnp.asarray(xt),
                                        jnp.asarray(xs)))
        assert rel(u, (f @ jK).reshape(u.shape)) < BAR
        assert rel(u, ju) < 1e-10
    else:
        assert rel(u, ju) < BAR


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matrix_matches_jax(name):
    ker, jker = getattr(ops, name), getattr(jops, name)
    xt, xs, f, n = _points(2, ker, 9, 11)
    K = kernel_matrix(ker, xt, xs, n, device="cpu")
    jK = j_kernel_matrix(jker, jnp.asarray(xt), jnp.asarray(xs),
                         None if n is None else jnp.asarray(n))
    assert K.shape == jK.shape
    assert rel(K, jK) < BAR
    # the matrix applied is the direct sum
    u = direct_eval(ker, xt, xs, f, ns=n, device="cpu")
    assert rel((torch.as_tensor(f) @ K).reshape(u.shape), u) < BAR


def test_direct_eval_needs_normals_and_defaults_to_the_card():
    xt, xs, f, _ = _points(3, ops.Laplace3D_DxU)
    with pytest.raises(ValueError):
        direct_eval(ops.Laplace3D_DxU, xt, xs, f, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            direct_eval(ops.Laplace3D_FxU, xt, xs, f)
