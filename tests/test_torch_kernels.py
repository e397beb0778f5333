"""The port's kernel layer against the JAX package: Laplace3D-FxU
forms, the direct sum, and the plain versions of the four CUDA kernels
against the Pallas kernels run in interpret mode.  Inputs are made with
numpy from fixed seeds and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops import direct_eval_blocked as j_direct
from sctl_tpu.ops.kernels_np import full_matrix_np as j_full_np
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops import direct_eval_blocked
from sctl_tpu_torch.ops.kernels_np import full_matrix_np
from sctl_tpu_torch.ops.uker import check_supported

limit_cpu_threads()

T = torch.as_tensor


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _points(seed, n_t=70, n_s=90):
    rng = np.random.default_rng(seed)
    xt = rng.random((n_t, 3))
    xs = rng.random((n_s, 3))
    xs[:5] = xt[:5]                  # coincident pairs: masked to 0
    return xt, xs, rng.normal(size=(n_s, 1))


def test_apply_pairwise_matches_jax():
    xt, xs, f = _points(0)
    u = LAP.apply_pairwise(T(xt), T(xs), None, T(f)).numpy()
    u_j = np.asarray(J_LAP.apply_pairwise(jnp.asarray(xt),
                                          jnp.asarray(xs), None,
                                          jnp.asarray(f)))
    assert rel(u, u_j) < 1e-12


def test_full_matrix_matches_jax():
    xt, xs, _ = _points(1)
    m = LAP.full_matrix(T(xt), T(xs)).numpy()
    m_j = np.asarray(J_LAP.full_matrix(jnp.asarray(xt), jnp.asarray(xs)))
    assert m.shape == m_j.shape
    assert rel(m, m_j) < 1e-12
    assert rel(full_matrix_np(LAP, xt, xs), j_full_np(J_LAP, xt, xs)) \
        < 1e-12


def test_direct_eval_blocked_matches_jax():
    xt, xs, f = _points(2, 300, 500)
    u = direct_eval_blocked(LAP, T(xt), T(xs), T(f), block_t=128,
                            block_s=96).numpy()
    u_j = np.asarray(j_direct(J_LAP, jnp.asarray(xt), jnp.asarray(xs),
                              jnp.asarray(f), block_t=128, block_s=128))
    assert rel(u, u_j) < 1e-12


@pytest.mark.parametrize("name", ["Laplace3D-DxU", "Stokes3D-FxT"])
def test_other_kernels_not_ported(name):
    """All eight kernels of the JAX package are ported: these two pass
    the port's check; an unknown name, or a kernel outside a stage's own
    list, raises."""
    check_supported(name)
    with pytest.raises(NotImplementedError):
        check_supported(name + "-unknown")
    with pytest.raises(NotImplementedError):
        check_supported(name, ("Laplace3D-FxU",))


def _surface(p=6, rad=2.95):
    from sctl_tpu_torch.fmm.kifmm import cube_surface
    return cube_surface(p) * (rad / 2)


def test_surface_pair_plain_matches_pallas():
    """B = 512 boxes (depth 3); bar 2e-4 of the maximum, the JAX tests'
    bar for the sibling tile kernel (tests/test_pallas_p2p.py:61)."""
    from sctl_tpu.ops.pallas_sl import surface_pair as j_sp
    from sctl_tpu_torch.ops.sl import surface_pair
    rng = np.random.default_rng(3)
    B, cap = 512, 16
    surf = _surface().astype(np.float32)
    pts = (rng.random((3, B * cap)) - 0.5).astype(np.float32)
    f = (rng.normal(size=(1, B * cap))
         * (rng.random((1, B * cap)) < 0.7)).astype(np.float32)
    u = surface_pair(LAP, T(surf), T(pts), T(f), cap).numpy()
    u_j = np.asarray(j_sp(J_LAP, jnp.asarray(surf), jnp.asarray(pts),
                          None, jnp.asarray(f), cap, interpret=True))
    assert u.shape == u_j.shape
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()


def test_l2t_surface_plain_matches_pallas():
    from sctl_tpu.ops.pallas_sl import l2t_surface as j_l2t
    from sctl_tpu_torch.ops.sl import l2t_surface
    rng = np.random.default_rng(4)
    B, cap_t = 512, 8
    surf = _surface().astype(np.float32)
    xt = (rng.random((3, B * cap_t)) - 0.5).astype(np.float32)
    q = rng.normal(size=(1, len(surf), B)).astype(np.float32)
    u = l2t_surface(LAP, T(surf), T(xt), T(q), cap_t).numpy()
    u_j = np.asarray(j_l2t(J_LAP, jnp.asarray(surf), jnp.asarray(xt),
                           jnp.asarray(q), cap_t, interpret=True))
    assert u.shape == u_j.shape
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()


@pytest.mark.parametrize("h", [2, 4])
def test_m2l_grid_blocked_plain_matches_pallas(h):
    """Real widths (r = 72, r2 = 128); bar 1e-4 relative max, the floor
    of the Pallas kernel's three-pass bf16 split (tests/test_fmm.py:394).
    """
    from sctl_tpu.ops.pallas_m2l import m2l_grid_blocked as j_m2l
    from sctl_tpu_torch.ops.m2l import m2l_grid_blocked
    rng = np.random.default_rng(5)
    r, r2 = 72, 128
    qp = np.zeros((h + 2,) * 3 + (8 * r2,), np.float32)
    qp[1:-1, 1:-1, 1:-1] = rng.normal(size=(h, h, h, 8 * r2))
    mats = (rng.normal(size=(26, 8 * r2, 8 * r))
            / np.sqrt(8 * r2)).astype(np.float32)
    u = m2l_grid_blocked(T(qp), T(mats)).numpy()
    u_j = np.asarray(j_m2l(jnp.asarray(qp), jnp.asarray(mats), h, r, r2,
                           interpret=True))
    assert u.shape == u_j.shape
    assert rel(u, u_j) < 1e-4


def test_blocked_m2l_mats_match_jax():
    from sctl_tpu.ops.pallas_m2l import blocked_m2l_mats as j_blk
    from sctl_tpu_torch.fmm.kifmm import _vlist_offsets
    from sctl_tpu_torch.ops.m2l import blocked_m2l_mats
    rng = np.random.default_rng(6)
    ca = rng.normal(size=(316, 16, 24))
    d, valid = _vlist_offsets()
    np.testing.assert_array_equal(blocked_m2l_mats(ca, d, valid, 8, 16),
                                  j_blk(ca, d, valid, 8, 16))


def test_p2p_stencil9_plain_matches_pallas():
    """n = 4 with boundary boxes; bar 2e-4 of the scale
    (tests/test_pallas_p2p.py:112)."""
    from sctl_tpu.fmm.kifmm import KIFMM as J_KIFMM
    from sctl_tpu.ops.pallas_p2p import p2p_stencil9 as j_p2p
    from sctl_tpu_torch.ops.p2p import p2p_stencil9, to_slab
    rng = np.random.default_rng(13)
    n, cap_t, cap, npb = 4, 8, 16, 5
    SL = -(-9 * cap // 128) * 128
    lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                  -1).reshape(-1, 1, 3)
    xs = np.zeros((n ** 3, cap, 3), np.float32)
    f = np.zeros((n ** 3, cap, 1), np.float32)
    xs[:, :npb] = (lo + rng.random((n ** 3, npb, 3))) / n
    f[:, :npb] = rng.normal(size=(n ** 3, npb, 1))
    xt = ((lo + rng.random((n ** 3, cap_t, 3))) / n).astype(np.float32)
    xt_g = xt.reshape(n, n, n, cap_t, 3).transpose(0, 1, 2, 4, 3)
    inv = np.arange(n ** 3)
    xs_s = J_KIFMM._to_slab(xs, inv, n)
    f_s = J_KIFMM._to_slab(f, inv, n)
    np.testing.assert_array_equal(
        to_slab(T(xs), T(inv), n, SL).numpy(), xs_s)
    u = p2p_stencil9(LAP, n, SL, cap_t, T(np.ascontiguousarray(xt_g)),
                     T(xs_s), T(f_s)).numpy()
    u_j = np.asarray(j_p2p(J_LAP, n, SL, cap_t, jnp.asarray(xt_g),
                           jnp.asarray(xs_s),
                           jnp.asarray(np.zeros((n, n, 3, 128),
                                                np.float32)),
                           jnp.asarray(f_s), interpret=True))
    assert u.shape == u_j.shape
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()
