"""The two shared-surface kernels over real slots only, against the JAX
package: S2M `surface_pair` with per-box source counts and L2T
`l2t_surface` with per-box target counts, then a depth-3 KIFMM whose
S2M and L2T take them with the counts wired in, and the route rules
that pick the shared-surface kernels.

The JAX functions are defined on padded slots whose padding carries
zero density; the port's functions skip the slots past each box's
count, so they must agree wherever the JAX function's padding is zero
(the port is handed nonzero densities there, which it must not read),
and `l2t_surface` must give exactly zero at the target slots past the
counts.  Both packages get the same inputs, made with numpy from fixed
seeds.  The Pallas kernels (sctl_tpu/ops/pallas_sl.py) take float32
only (their error-free bf16 split bitcasts float32 words), so they run
in interpret mode in float32 at their own bar, 2e-4 of the maximum
(tests/test_torch_kernels.py); in float64 the port is held to 1e-12 of
the maximum against the JAX package's pair formula
(`KernelSpec.apply_pairwise`) over every padded slot of each box, which
is the function the Pallas kernels compute."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops.pallas_sl import l2t_surface as j_l2t
from sctl_tpu.ops.pallas_sl import surface_pair as j_sp
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.fmm.kifmm import cube_surface
from sctl_tpu_torch.ops import KERNELS
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops.sl import (l2t_surface, l2t_surface_fits,
                                   surface_pair, surface_pair_fits)
from sctl_tpu_torch.ops.uker import L2T_KERNELS, S2M_KERNELS

limit_cpu_threads()

T = torch.as_tensor
B = 128                 # the Pallas kernels' boxes a program
PALLAS_BAR = 2e-4


def _counts(rng, cap):
    """B box counts in [0, cap], with 0, 1 and cap among them."""
    cnt = rng.integers(0, cap + 1, B)
    cnt[:4] = (0, 1, cap, cap)
    return cnt


def _slots(a):
    """(B, cap, k) -> (k, B*cap), the kernels' slot layout."""
    return np.ascontiguousarray(a.transpose(2, 0, 1).reshape(a.shape[2], -1))


def _rel_live(u, u_j, live):
    return float(np.abs((u - u_j) * live).max() / np.abs(u_j * live).max())


@functools.lru_cache(maxsize=None)
def _s2m_case(name, seed=40, cap=16, p=4):
    """A check surface, each box's cap slots with its first cnt real
    (the slots past them hold nonzero densities), unit normals."""
    ker = KERNELS[name]
    rng = np.random.default_rng(seed)
    cnt = _counts(rng, cap)
    surf = cube_surface(p) * (2.95 / 2)
    pts = rng.random((B, cap, 3)) - 0.5
    nrm = rng.normal(size=(B, cap, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    f = rng.normal(size=(B, cap, ker.kdim0))
    real = (np.arange(cap) < cnt[:, None])[..., None]
    return surf, pts, nrm, f, f * real, cnt, cap


def _port_s2m(name, dtype, case):
    surf, pts, nrm, f, _, cnt, cap = case
    ker = KERNELS[name]
    c = lambda a: T(a, dtype=dtype)
    return surface_pair(ker, c(surf), c(_slots(pts)), c(_slots(f)), cap,
                        c(_slots(nrm)) if ker.needs_normal else None,
                        T(cnt.astype(np.int32))).numpy()


@pytest.mark.parametrize("name", S2M_KERNELS)
def test_counted_surface_pair_f64_matches_jax(name):
    """float64: the counted port against the JAX pair formula over every
    slot of each box, zero density past the counts; 1e-12, as
    tests/test_torch_p2p_counts.py."""
    case = _s2m_case(name)
    surf, pts, nrm, _, f_real, _, _ = case
    jk = J_KERNELS[name]
    u_j = jax.vmap(lambda x, n, f: jk.apply_pairwise(
        jnp.asarray(surf), x, n, f))(jnp.asarray(pts), jnp.asarray(nrm),
                                     jnp.asarray(f_real))
    u_j = np.asarray(u_j).transpose(2, 1, 0)                # (k1, ns, B)
    u = _port_s2m(name, torch.float64, case)
    assert u.shape == u_j.shape == (KERNELS[name].kdim1, len(surf), B)
    assert np.abs(u - u_j).max() < 1e-12 * np.abs(u_j).max()


@pytest.mark.parametrize("name", S2M_KERNELS)
def test_counted_surface_pair_f32_matches_pallas(name):
    """float32: the counted port against the Pallas kernel in interpret
    mode on the same slots, zero density past the counts."""
    case = _s2m_case(name)
    surf, pts, nrm, _, f_real, _, cap = case
    f32 = lambda a: jnp.asarray(np.float32(a))
    n = f32(_slots(nrm)) if KERNELS[name].needs_normal else None
    u_j = np.asarray(j_sp(J_KERNELS[name], f32(surf), f32(_slots(pts)), n,
                          f32(_slots(f_real)), cap, interpret=True))
    u = _port_s2m(name, torch.float32, case)
    assert u.shape == u_j.shape
    assert np.abs(u - u_j).max() < PALLAS_BAR * np.abs(u_j).max()


@functools.lru_cache(maxsize=None)
def _l2t_case(name, seed=41, cap_t=12, p=4):
    """An equivalent surface, each box's densities on it, cap_t target
    slots with their first cnt real."""
    ker = KERNELS[name]
    rng = np.random.default_rng(seed)
    cnt = _counts(rng, cap_t)
    surf = cube_surface(p) * (2.95 / 2)
    xt = rng.random((B, cap_t, 3)) - 0.5
    q = rng.normal(size=(ker.kdim0, len(surf), B))
    live = (np.arange(cap_t) < cnt[:, None]).reshape(1, -1)
    return surf, xt, q, cnt, cap_t, live


def _port_l2t(name, dtype, case):
    surf, xt, q, cnt, cap_t, _ = case
    c = lambda a: T(a, dtype=dtype)
    return l2t_surface(KERNELS[name], c(surf), c(_slots(xt)), c(q), cap_t,
                       T(cnt.astype(np.int32))).numpy()


@pytest.mark.parametrize("name", L2T_KERNELS)
def test_counted_l2t_surface_f64_matches_jax(name):
    """float64: the counted port against the JAX pair formula at every
    target slot, 1e-12 at the real slots, exactly zero past them."""
    case = _l2t_case(name)
    surf, xt, q, _, cap_t, live = case
    u_j = jax.vmap(lambda x, f: J_KERNELS[name].apply_pairwise(
        x, jnp.asarray(surf), None, f))(jnp.asarray(xt),
                                        jnp.asarray(q.transpose(2, 1, 0)))
    u_j = np.asarray(u_j).reshape(B * cap_t, -1).T          # (k1, B cap_t)
    u = _port_l2t(name, torch.float64, case)
    assert u.shape == u_j.shape == (KERNELS[name].kdim1, B * cap_t)
    assert _rel_live(u, u_j, live) < 1e-12
    assert (u[:, ~live[0]] == 0).all()


@pytest.mark.parametrize("name", L2T_KERNELS)
def test_counted_l2t_surface_f32_matches_pallas(name):
    """float32: the counted port against the Pallas kernel in interpret
    mode on the same densities."""
    case = _l2t_case(name)
    surf, xt, q, _, cap_t, live = case
    f32 = lambda a: jnp.asarray(np.float32(a))
    u_j = np.asarray(j_l2t(J_KERNELS[name], f32(surf), f32(_slots(xt)),
                           f32(q), cap_t, interpret=True))
    u = _port_l2t(name, torch.float32, case)
    assert u.shape == u_j.shape
    assert _rel_live(u, u_j, live) < PALLAS_BAR
    assert (u[:, ~live[0]] == 0).all()


def test_counts_none_is_every_slot():
    """Without counts every slot counts, the JAX functions' definition:
    the same values as counts of cap (float64, the plain versions)."""
    surf, pts, nrm, f, _, cnt, cap = _s2m_case("Laplace3D-DxU")
    c = lambda a: T(a, dtype=torch.float64)
    args = (KERNELS["Laplace3D-DxU"], c(surf), c(_slots(pts)), c(_slots(f)),
            cap, c(_slots(nrm)))
    full = T(np.full(B, cap, np.int32))
    assert torch.equal(surface_pair(*args), surface_pair(*args, full))
    surf, xt, q, cnt, cap_t, _ = _l2t_case("Stokes3D-FSxU")
    args = (KERNELS["Stokes3D-FSxU"], c(surf), c(_slots(xt)), c(q), cap_t)
    full = T(np.full(B, cap_t, np.int32))
    assert torch.equal(l2t_surface(*args), l2t_surface(*args, full))


# The route rules (ops/sl.py) decide which shapes take the shared-surface
# kernels and which the U-list kernel; the kernels over real slots take
# any capacity, but the rules keep their formulas, so that no route
# moves: on some shapes the rules leave out (depth-3 Stokes trees) the
# surface kernels were measured slower than the U list, so widening
# the rules waits for a measurement of its own.  (kernel, capacity or
# surface points, answer) at the phases' shapes: phase 4 (cap_s 56,
# ns 152) and phase 7 (cap_s 344, ns 296) take the surface route; the
# Stokeslet facade (cap_s 344) and the depth-3 double layers (cap 432)
# the U list.
S2M_ROUTE = [("Laplace3D-FxU", 56, True), ("Laplace3D-FxU", 344, True),
             ("Laplace3D-FxU", 432, True), ("Stokes3D-FxU", 56, True),
             ("Stokes3D-FxU", 344, False), ("Laplace3D-DxU", 432, False),
             ("Stokes3D-DxU", 432, False), ("Stokes3D-FSxU", 432, False)]
L2T_ROUTE = [("Laplace3D-FxU", 152, True), ("Laplace3D-FxU", 296, True),
             ("Stokes3D-FSxU", 152, True), ("Stokes3D-FSxU", 296, True),
             ("Stokes3D-FSxU", 488, False)]


@pytest.mark.parametrize("name,cap,fits", S2M_ROUTE)
def test_surface_pair_route_rule_unchanged(name, cap, fits):
    assert surface_pair_fits(KERNELS[name], cap) is fits


@pytest.mark.parametrize("name,ns,fits", L2T_ROUTE)
def test_l2t_surface_route_rule_unchanged(name, ns, fits):
    assert l2t_surface_fits(KERNELS[name], ns) is fits


def _tables(jops, p):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jops._rcond)
    return t


def test_kifmm_surface_route_counts_match_jax():
    """A depth-3 KIFMM (512 boxes), float64, p = 4, on the JAX package's
    tables, on points with empty boxes (none with x and y below 0.3) and
    a dense cluster whose boxes reach the caps: S2M and L2T through the
    counted shared-surface functions, against the JAX KIFMM (its S2M
    and L2T in plain float64: the Pallas surface kernels take float32
    only); 1e-9, the float64 bar of tests/test_torch_kifmm.py."""
    rng = np.random.default_rng(42)
    x = rng.random((6000, 3))
    x = x[(x[:, 0] > 0.3) | (x[:, 1] > 0.3)]
    x = np.concatenate([x, 0.6 + 0.06 * rng.random((600, 3))])
    f = rng.normal(size=(len(x), 1))
    jk = J_KIFMM(J_LAP, p=4, depth=3, use_pallas_p2p=False,
                 use_pallas_m2l=False, use_pallas_sl=True).setup(x, x)
    ops = operators_from_numpy(_tables(jk._ops, 4), "cpu", torch.float64)
    kf = KIFMM(LAP, p=4, depth=3, device="cpu", dtype=torch.float64,
               operators=ops).setup(x, x)
    assert kf.surface_route
    cs, ct = kf.cnt_s_box.numpy(), kf.cnt_t_box.numpy()
    assert (cs == 0).any() and (cs == kf.cap_s).any()
    assert (ct == 0).any() and (ct == kf.cap_t).any()
    u_j = np.asarray(jk.eval(f))
    u = kf.eval(f)
    assert np.abs(u - u_j).max() < 1e-9 * np.abs(u_j).max()
