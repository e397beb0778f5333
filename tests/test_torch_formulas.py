"""The port's eight kernel formulas against the JAX package: the specs
(applied form, dense matrix, matrix blocks, host float64 forms), the
direct sum against `direct_eval` and against the Pallas `p2p` in
interpret mode, and the plain versions of the four pair kernels for
every formula they take against their Pallas kernels in interpret mode.
Inputs are made with numpy from fixed seeds and handed to both
packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import direct_eval as j_direct
from sctl_tpu.ops.kernels_np import block_matrix_np as j_block_np
from sctl_tpu.ops.kernels_np import full_matrix_np as j_full_np
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.ops import KERNELS, direct_eval_blocked
from sctl_tpu_torch.ops.kernels_np import block_matrix_np, full_matrix_np
from sctl_tpu_torch.ops.uker import (L2T_KERNELS, S2M_KERNELS, SUPPORTED,
                                     TREE_KERNELS, rinv_masked,
                                     uker_matrix)

limit_cpu_threads()

T = torch.as_tensor
NEW = ["Laplace3D-DxU", "Laplace3D-FxdU", "Stokes3D-FxT", "Stokes3D-FxUP"]


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


@pytest.mark.parametrize("name", NEW)
def test_new_specs_match_jax(name):
    """Dimensions, scale, exponents and per-pair flops, the applied form,
    the dense matrix and the matrix blocks; 1e-12 relative, float64."""
    ker, jk = KERNELS[name], J_KERNELS[name]
    assert (ker.kdim0, ker.kdim1, ker.needs_normal, ker.flops) == \
        (jk.kdim0, jk.kdim1, jk.needs_normal, jk.flops)
    assert ker.scale_factor == jk.scale_factor
    assert ker.src_scal == tuple(jk.src_scal)
    assert ker.trg_scal == tuple(jk.trg_scal)
    xt, xs, ns, f = _data(1, ker.kdim0)
    n = ns if ker.needs_normal else None
    jn = None if n is None else jnp.asarray(n)
    u = ker.apply_pairwise(T(xt), T(xs), None if n is None else T(n),
                           T(f)).numpy()
    u_j = jk.apply_pairwise(jnp.asarray(xt), jnp.asarray(xs), jn,
                            jnp.asarray(f))
    m = ker.full_matrix(T(xt), T(xs), None if n is None else T(n))
    m_j = np.asarray(jk.full_matrix(jnp.asarray(xt), jnp.asarray(xs), jn))
    assert m.shape == m_j.shape and rel(m, m_j) < 1e-12
    # the port's applied form against the JAX per-pair matrix at 1e-12;
    # against the JAX applied form at 1e-10, since that one expands
    # FxT's r_j r_k in source moments (sctl_tpu/ops/uker.py
    # `_uk_stk_fxt`), which cancels to about 5e-12 on these points
    u_m = (f.reshape(1, -1) @ m_j).reshape(-1, ker.kdim1) / ker.scale_factor
    assert rel(u, u_m) < 1e-12
    assert rel(u, u_j) < 1e-10
    d = xt[:, None, :] - xs[None, :, :]
    nb = None if n is None else np.broadcast_to(n, d.shape)
    blk = uker_matrix(name, T(d), rinv_masked(T((d * d).sum(-1))),
                      None if nb is None else T(nb.copy()))
    blk_j = jk.matrix(jnp.asarray(d), None if nb is None
                      else jnp.asarray(nb))          # both unscaled
    assert rel(blk, blk_j) < 1e-12


@pytest.mark.parametrize("name", NEW)
def test_new_host_forms_match_jax(name):
    ker, jk = KERNELS[name], J_KERNELS[name]
    xt, xs, ns, _ = _data(2, ker.kdim0)
    n = ns if ker.needs_normal else None
    assert rel(full_matrix_np(ker, xt, xs, n),
               j_full_np(jk, xt, xs, n)) < 1e-12
    assert rel(block_matrix_np(ker, xt, xs, n),
               j_block_np(jk, xt, xs, n)) < 1e-12


@pytest.mark.parametrize("name", SUPPORTED)
def test_direct_sum_matches_jax(name):
    """200 x 300 points, not tile-aligned (tests/test_pallas_p2p.py:
    15-28): float64 against `direct_eval` at 1e-12, and float32 against
    the Pallas `p2p` in interpret mode at 2e-5 of the maximum."""
    from sctl_tpu.ops.pallas_p2p import p2p as j_p2p
    ker, jk = KERNELS[name], J_KERNELS[name]
    rng = np.random.default_rng(7)
    xt = rng.normal(size=(200, 3))
    xs = rng.normal(size=(300, 3)) + 4.0
    nrm = rng.normal(size=(300, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    f = rng.normal(size=(300, ker.kdim0))
    n = nrm if ker.needs_normal else None
    u = direct_eval_blocked(ker, T(xt), T(xs), T(f),
                            ns=None if n is None else T(n),
                            block_t=128, block_s=96).numpy()
    u_j = np.asarray(j_direct(jk, jnp.asarray(xt), jnp.asarray(xs),
                              jnp.asarray(f), ns=jnp.asarray(nrm)))
    assert rel(u, u_j) < 1e-12
    f32 = lambda a: T(np.float32(a))
    u32 = direct_eval_blocked(ker, f32(xt), f32(xs), f32(f),
                              ns=None if n is None else f32(n)).numpy()
    u_pl = np.asarray(j_p2p(jk, jnp.asarray(np.float32(xt)),
                            jnp.asarray(np.float32(xs)),
                            jnp.asarray(np.float32(f)),
                            ns=jnp.asarray(np.float32(nrm)), block_t=128,
                            block_s=128, interpret=True))
    assert np.abs(u32 - u_pl).max() < 2e-5 * np.abs(u_pl).max()


def _surface(p=4, rad=2.95):
    from sctl_tpu_torch.fmm.kifmm import cube_surface
    return (cube_surface(p) * (rad / 2)).astype(np.float32)


@pytest.mark.parametrize("name", S2M_KERNELS[1:])
def test_surface_pair_formulas_match_pallas(name):
    """B = 128 boxes; bar 2e-4 of the maximum, as the Laplace case
    (tests/test_torch_kernels.py)."""
    from sctl_tpu.ops.pallas_sl import surface_pair as j_sp
    from sctl_tpu_torch.ops.sl import surface_pair
    ker, jk = KERNELS[name], J_KERNELS[name]
    rng = np.random.default_rng(3)
    B, cap = 128, 16
    surf = _surface()
    pts = (rng.random((3, B * cap)) - 0.5).astype(np.float32)
    nrm = rng.normal(size=(3, B * cap))
    nrm = (nrm / np.linalg.norm(nrm, axis=0)).astype(np.float32)
    f = (rng.normal(size=(ker.kdim0, B * cap))
         * (rng.random((1, B * cap)) < 0.7)).astype(np.float32)
    n = nrm if ker.needs_normal else None
    u = surface_pair(ker, T(surf), T(pts), T(f), cap,
                     None if n is None else T(n)).numpy()
    u_j = np.asarray(j_sp(jk, jnp.asarray(surf), jnp.asarray(pts),
                          None if n is None else jnp.asarray(n),
                          jnp.asarray(f), cap, interpret=True))
    assert u.shape == u_j.shape == (ker.kdim1, len(surf), B)
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()


@pytest.mark.parametrize("name", L2T_KERNELS[1:])
def test_l2t_surface_formulas_match_pallas(name):
    from sctl_tpu.ops.pallas_sl import l2t_surface as j_l2t
    from sctl_tpu_torch.ops.sl import l2t_surface
    ker, jk = KERNELS[name], J_KERNELS[name]
    rng = np.random.default_rng(4)
    B, cap_t = 128, 8
    surf = _surface()
    xt = (rng.random((3, B * cap_t)) - 0.5).astype(np.float32)
    q = rng.normal(size=(ker.kdim0, len(surf), B)).astype(np.float32)
    u = l2t_surface(ker, T(surf), T(xt), T(q), cap_t).numpy()
    u_j = np.asarray(j_l2t(jk, jnp.asarray(surf), jnp.asarray(xt),
                           jnp.asarray(q), cap_t, interpret=True))
    assert u.shape == u_j.shape == (ker.kdim1, B * cap_t)
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()


@pytest.mark.parametrize("name", TREE_KERNELS[1:])
def test_p2p_stencil9_formulas_match_pallas(name):
    """n = 4 with boundary boxes; bar 2e-4 of the scale, as the Laplace
    case (tests/test_pallas_p2p.py:112)."""
    from sctl_tpu.fmm.kifmm import KIFMM as J_KIFMM
    from sctl_tpu.ops.pallas_p2p import p2p_stencil9 as j_p2p
    from sctl_tpu_torch.ops.p2p import p2p_stencil9
    ker, jk = KERNELS[name], J_KERNELS[name]
    rng = np.random.default_rng(13)
    n, cap_t, cap, npb = 4, 8, 16, 5
    SL = -(-9 * cap // 128) * 128
    lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                  -1).reshape(-1, 1, 3)
    xs = np.zeros((n ** 3, cap, 3), np.float32)
    nrm = np.zeros((n ** 3, cap, 3), np.float32)
    f = np.zeros((n ** 3, cap, ker.kdim0), np.float32)
    xs[:, :npb] = (lo + rng.random((n ** 3, npb, 3))) / n
    nv = rng.normal(size=(n ** 3, npb, 3))
    nrm[:, :npb] = nv / np.linalg.norm(nv, axis=2, keepdims=True)
    f[:, :npb] = rng.normal(size=(n ** 3, npb, ker.kdim0))
    xt = ((lo + rng.random((n ** 3, cap_t, 3))) / n).astype(np.float32)
    xt_g = np.ascontiguousarray(
        xt.reshape(n, n, n, cap_t, 3).transpose(0, 1, 2, 4, 3))
    inv = np.arange(n ** 3)
    xs_s, ns_s, f_s = (J_KIFMM._to_slab(a, inv, n) for a in (xs, nrm, f))
    u = p2p_stencil9(ker, n, SL, cap_t, T(xt_g), T(xs_s), T(f_s),
                     T(ns_s) if ker.needs_normal else None).numpy()
    u_j = np.asarray(j_p2p(jk, n, SL, cap_t, jnp.asarray(xt_g),
                           jnp.asarray(xs_s), jnp.asarray(ns_s),
                           jnp.asarray(f_s), interpret=True))
    assert u.shape == u_j.shape == (n, n, n, cap_t, ker.kdim1)
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()
