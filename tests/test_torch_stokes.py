"""The port's Stokes kernel layer against the JAX package: the three
kernels of the BIE path (Stokes3D-FxU, -DxU, -FSxU) in their matrix,
applied and host forms, the direct sum with source normals, the
quadrature helpers, and the plain version of the U-list kernel against
the Pallas kernel in interpret mode.  Inputs are made with numpy from
fixed seeds and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.linalg.lagrange import interpolation_matrix as j_interp
from sctl_tpu.linalg.quadrule import leg_quad_rule as j_leg
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import direct_eval_blocked as j_direct
from sctl_tpu.ops.kernels_np import block_matrix_np as j_block_np
from sctl_tpu.ops.kernels_np import offset_blocks_np as j_offset_np
from sctl_tpu.ops.pallas_p2p import p2p_ulist as j_ulist
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import interpolation_matrix, leg_quad_rule
from sctl_tpu_torch.ops import KERNELS, direct_eval_blocked
from sctl_tpu_torch.ops.kernels_np import (block_matrix_np, full_matrix_np,
                                           offset_blocks_np)
from sctl_tpu_torch.ops.p2p import p2p_ulist

limit_cpu_threads()

T = torch.as_tensor
STOKES = ["Stokes3D-FxU", "Stokes3D-DxU", "Stokes3D-FSxU"]
ULIST = ["Laplace3D-FxU", "Laplace3D-DxU", "Laplace3D-FxdU", "Stokes3D-FxU",
         "Stokes3D-DxU", "Stokes3D-FSxU"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _data(seed, k0, n_t=60, n_s=80):
    rng = np.random.default_rng(seed)
    xt = rng.random((n_t, 3))
    xs = rng.random((n_s, 3))
    xs[:4] = xt[:4]                  # coincident pairs: masked to 0
    ns = rng.normal(size=(n_s, 3))
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    return xt, xs, ns, rng.normal(size=(n_s, k0))


@pytest.mark.parametrize("name", STOKES)
def test_stokes_apply_and_matrix_match_jax(name):
    """Identical formulas in float64: 1e-12 relative."""
    ker, jk = KERNELS[name], J_KERNELS[name]
    xt, xs, ns, f = _data(1, ker.kdim0)
    nrm = ns if ker.needs_normal else None
    jn = None if nrm is None else jnp.asarray(nrm)
    u = ker.apply_pairwise(T(xt), T(xs), None if nrm is None else T(nrm),
                           T(f)).numpy()
    u_j = jk.apply_pairwise(jnp.asarray(xt), jnp.asarray(xs), jn,
                            jnp.asarray(f))
    assert rel(u, u_j) < 1e-12
    m = ker.full_matrix(T(xt), T(xs), None if nrm is None else T(nrm))
    m_j = jk.full_matrix(jnp.asarray(xt), jnp.asarray(xs), jn)
    assert m.shape == m_j.shape
    assert rel(m.numpy(), m_j) < 1e-12
    assert rel(full_matrix_np(ker, xt, xs, nrm), m_j) < 1e-12


@pytest.mark.parametrize("name", STOKES + ["Laplace3D-FxU"])
def test_host_forms_match_jax(name):
    """The same numpy on both sides: 1e-14 relative."""
    ker, jk = KERNELS[name], J_KERNELS[name]
    xt, xs, ns, _ = _data(2, ker.kdim0)
    nrm = ns if ker.needs_normal else None
    assert rel(block_matrix_np(ker, xt, xs, nrm),
               j_block_np(jk, xt, xs, nrm)) < 1e-14
    d = xt[:, None, :] - xs[None, :, :]
    nb = None if nrm is None else np.broadcast_to(nrm, d.shape)
    assert rel(offset_blocks_np(ker, d, ns=nb),
               j_offset_np(jk, d, ns=nb)) < 1e-14


def test_direct_eval_blocked_with_normals_matches_jax():
    ker = KERNELS["Stokes3D-DxU"]
    xt, xs, ns, f = _data(3, 3, 300, 500)
    u = direct_eval_blocked(ker, T(xt), T(xs), T(f), ns=T(ns), block_t=128,
                            block_s=96).numpy()
    u_j = j_direct(J_KERNELS["Stokes3D-DxU"], jnp.asarray(xt),
                   jnp.asarray(xs), jnp.asarray(f), ns=jnp.asarray(ns),
                   block_t=128, block_s=128)
    assert rel(u, u_j) < 1e-12
    with pytest.raises(ValueError):
        direct_eval_blocked(ker, T(xt), T(xs), T(f))


def test_quadrature_helpers_match_jax():
    for n in (4, 6, 12, 24):
        x, w = leg_quad_rule(n)
        xj, wj = j_leg(n)
        assert rel(x, xj) < 1e-14 and rel(w, wj) < 1e-14
    x1, _ = leg_quad_rule(6)
    t = np.concatenate([np.linspace(-0.2, 1.2, 41), x1[:2]])
    assert rel(interpolation_matrix(x1, t), j_interp(x1, t)) < 1e-14


@pytest.mark.parametrize("name", ULIST)
def test_p2p_ulist_plain_matches_pallas(name):
    """G = 9 boxes (not a multiple of the Pallas kernel's 8), T = 16,
    S = 256 with padded slots; float32.  Bar 2e-4 of the maximum
    (tests/test_pallas_p2p.py:61)."""
    ker, jk = KERNELS[name], J_KERNELS[name]
    rng = np.random.default_rng(7)
    G, Tn, S = 9, 16, 256
    xt = rng.random((G, 3, Tn)).astype(np.float32)
    xs = (rng.random((G, 3, S)) * 2 - 0.5).astype(np.float32)
    ns = rng.normal(size=(G, 3, S)).astype(np.float32)
    f = (rng.normal(size=(G, ker.kdim0, S))
         * (rng.random((G, 1, S)) < 0.8)).astype(np.float32)
    u = p2p_ulist(ker, T(xt), T(xs), T(ns) if ker.needs_normal else None,
                  T(f)).numpy()
    u_j = np.asarray(j_ulist(jk, jnp.asarray(xt), jnp.asarray(xs),
                             jnp.asarray(ns), jnp.asarray(f),
                             interpret=True))
    assert u.shape == u_j.shape == (G, Tn, ker.kdim1)
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()


def test_p2p_ulist_rejects_bad_shapes():
    ker = KERNELS["Stokes3D-DxU"]
    z = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError):            # S not a multiple of 128
        p2p_ulist(ker, z(2, 3, 8), z(2, 3, 100), z(2, 3, 100), z(2, 3, 100))
    with pytest.raises(ValueError):            # the double layer's normals
        p2p_ulist(ker, z(2, 3, 8), z(2, 3, 128), None, z(2, 3, 128))
    with pytest.raises(NotImplementedError):   # no tree path
        p2p_ulist(KERNELS["Stokes3D-FxT"], z(2, 3, 8), z(2, 3, 128), None,
                  z(2, 3, 128))
