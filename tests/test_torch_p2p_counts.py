"""The two pair kernels over real points only, against the JAX package:
the halo stencil `p2p_stencil` with per-box source and target counts,
and the U list `p2p_ulist` compacted to each leaf's real sources.

The JAX functions are defined on padded slots whose padding carries
zero density; the port's functions skip the slots past each box's
count, so they must agree wherever the JAX function's padding is zero
(the port is handed nonzero densities there, which it must not read)
and give exactly zero at the target slots past the counts.  Both
packages get the same inputs, made with numpy from fixed seeds; the
Pallas kernels run in interpret mode, in float64.  Then the two slices
that run the new inputs end to end: the adaptive FMM's apply and a
depth-2 KIFMM whose near field takes the halo stencil."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.bie import torus_patches as j_torus
from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.fmm.adaptive import AdaptiveFMM as J_Adaptive
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops.pallas_p2p import p2p_stencil as j_p2p_stencil
from sctl_tpu.ops.pallas_p2p import p2p_ulist as j_p2p_ulist
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import (AdaptiveFMM, KIFMM, KIFMMOperators,
                                operators_from_numpy)
from sctl_tpu_torch.ops import KERNELS
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_ulist, to_halo

limit_cpu_threads()

T = torch.as_tensor
STENCIL = ["Laplace3D-FxU", "Laplace3D-DxU", "Stokes3D-FxU"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tables(jops, p):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jops._rcond)
    return t


@functools.lru_cache(maxsize=None)
def _near_field(depth):
    """A float64 KIFMM on points with empty boxes (none with x and y
    below 0.3) and a dense cluster, whose boxes overflow the source and
    target capacities (their counts clip at the caps)."""
    rng = np.random.default_rng(30 + depth)
    x = rng.random((3000, 3))
    x = x[(x[:, 0] > 0.3) | (x[:, 1] > 0.3)]
    x = np.concatenate([x, 0.6 + 0.06 * rng.random((400, 3))])
    kf = KIFMM(LAP, p=4, depth=depth, device="cpu",
               dtype=torch.float64).setup(x, x)
    cnt_s = kf.cnt_s_rast.numpy()
    assert (cnt_s == 0).any() and (cnt_s == kf.cap_s).any()
    assert (kf.cnt_t_rast.numpy() == kf.cap_t).any()
    return kf


@pytest.mark.parametrize("name", STENCIL)
@pytest.mark.parametrize("depth", [2, 3])
def test_counted_stencil_matches_pallas(depth, name):
    """The counted plain version on the KIFMM's own halo columns and
    counts against the Pallas kernel on the same slots re-padded to its
    64-slot multiple, zero density past each box's count: 1e-12 of the
    maximum at the real target slots, zero past them."""
    kf = _near_field(depth)
    ker = KERNELS[name]
    rng = np.random.default_rng(31)
    n, cs, ct = 1 << depth, kf.cap_s, kf.cap_t
    B = n ** 3
    real = kf.pad_valid.numpy()[..., None]
    f = rng.normal(size=(B, cs, ker.kdim0))
    nrm = rng.normal(size=(B, cs, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    xs = kf.xs_pad.numpy()
    halo = lambda a: to_halo(T(a), kf.rast_to_mort, n)
    u = p2p_stencil(ker, n, cs, ct, kf.xt_rast, halo(xs), halo(f),
                    halo(nrm) if ker.needs_normal else None,
                    kf.cnt_s_rast, kf.cnt_t_rast).numpy()
    c64 = -(-cs // 64) * 64
    pad = lambda a: np.pad(a, ((0, 0), (0, c64 - cs), (0, 0)))
    jh = lambda a: jnp.asarray(halo(pad(a)).numpy())
    u_j = np.asarray(j_p2p_stencil(
        J_KERNELS[name], n, c64, ct, jnp.asarray(kf.xt_rast.numpy()),
        jh(xs), jh(nrm * real), jh(f * real), interpret=True))
    live = (np.arange(ct) < kf.cnt_t_rast.numpy()[..., None])[..., None]
    assert u.shape == u_j.shape == (n, n, n, ct, ker.kdim1)
    assert np.abs((u - u_j) * live).max() < 1e-12 * np.abs(u_j * live).max()
    assert (u[~np.broadcast_to(live, u.shape)] == 0).all()


@functools.lru_cache(maxsize=None)
def _torus():
    lst = j_torus(nu=6, nv=3, q=6, R=2.0, r=0.5)
    X, _, _ = lst.get_node_coord()
    Xf, Xnf, _, _, _ = lst.get_far_field_nodes(1e-6)
    return X, Xf, Xnf


@functools.lru_cache(maxsize=None)
def _adaptive_pair():
    """The JAX AdaptiveFMM (its U list through the Pallas p2p_ulist in
    interpret mode) and the port's, Laplace FxU, p = 4, float64, the
    port on the JAX package's tables."""
    X, Xf, _ = _torus()
    jk = J_Adaptive(J_LAP, p=4, max_pts=32,
                    use_pallas_ulist=True).setup(Xf, X)
    ops = operators_from_numpy(_tables(jk._ops, 4), "cpu", torch.float64)
    af = AdaptiveFMM(LAP, p=4, max_pts=32, device="cpu",
                     dtype=torch.float64, operators=ops).setup(Xf, X)
    return jk, af


@pytest.mark.parametrize("name", ["Laplace3D-FxU", "Stokes3D-DxU"])
def test_compacted_ulist_matches_padded_pallas(name):
    """The port's compacted U list (each leaf's source leaves' real
    points, one flat list) through the plain version against the Pallas
    p2p_ulist on the JAX package's padded slabs of the same list (its
    gather, sctl_tpu/fmm/adaptive.py:836-866), both in the target
    leaf's frame: 1e-12 of the maximum at the real targets, zero past
    them.  The port's densities past each leaf's count are nonzero and
    must go unread."""
    _, af = _adaptive_pair()
    ker = KERNELS[name]
    rng = np.random.default_rng(32)
    nl, cs, ct = af.n_leaf, af.cap_s, af.cap_t
    fp = rng.normal(size=(nl, cs, ker.kdim0))
    nrm = rng.normal(size=(nl, cs, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    # the port: the AdaptiveFMM's list, with this formula's normals
    xt, xs, _, _, srng, tcnt, fidx = af.ulist_args(T(fp))
    ns = T(np.ascontiguousarray(nrm.reshape(-1, 3)[fidx.numpy()].T))
    u = p2p_ulist(ker, xt, xs, ns if ker.needs_normal else None,
                  T(fp.reshape(-1, ker.kdim0)), srng, tcnt, fidx).numpy()
    # the JAX package's padded slabs of the same U list, zero density
    # in padded slots and for absent source leaves
    rows, ok = af.ul_rows.numpy(), af.ul_ok.numpy() > 0
    G, Ku = rows.shape
    S0 = Ku * cs
    S, Tp = -(-S0 // 128) * 128, -(-ct // 8) * 8
    slab = lambda a: np.pad(a[rows].reshape(G, S0, -1),
                            ((0, 0), (0, S - S0), (0, 0))).transpose(0, 2, 1)
    glob = af.tree.X_sorted[af.sidx.numpy()]            # (n_leaf, cs, 3)
    xs_b = slab(glob) - af.leaf_ctr[:, :, None]
    live_src = np.pad(np.repeat(ok, cs, axis=1), ((0, 0), (0, S - S0)))
    f_b = slab(fp * af.svalid.numpy()[..., None]) * live_src[:, None, :]
    xt_b = np.pad(af.xt_loc.numpy(), ((0, 0), (0, Tp - ct), (0, 0))) \
        .transpose(0, 2, 1)
    u_j = np.asarray(j_p2p_ulist(
        J_KERNELS[name], jnp.asarray(xt_b), jnp.asarray(xs_b),
        jnp.asarray(slab(nrm)), jnp.asarray(f_b), interpret=True))[:, :ct]
    live = (np.arange(ct) < tcnt.numpy()[:, None])[..., None]
    assert u.shape == u_j.shape == (G, ct, ker.kdim1)
    assert np.abs((u - u_j) * live).max() < 1e-12 * np.abs(u_j * live).max()
    assert (u[~np.broadcast_to(live, u.shape)] == 0).all()


def test_adaptive_apply_matches_jax_pallas_ulist():
    """The whole apply, float64, same tables: the port (the compacted U
    list, one plain call) against the JAX AdaptiveFMM whose U list runs
    the Pallas p2p_ulist over padded slabs in interpret mode; 1e-9, the
    bar of tests/test_torch_adaptive.py (the pinv operators amplify
    1-ulp differences about a million-fold)."""
    jk, af = _adaptive_pair()
    _, Xf, _ = _torus()
    f = np.random.default_rng(33).normal(size=(len(Xf), 1))
    assert rel(af.eval(f), np.asarray(jk.eval(f))) < 1e-9


def test_kifmm_stencil_route_matches_jax():
    """A depth-2 KIFMM, float64, p = 4, on the JAX package's tables, at
    about 300 points a box: the near field through the counted halo
    stencil, S2M and L2T through the U list over each box's real slots
    (64 boxes), against the JAX KIFMM with its Pallas S2M/L2T route
    (p2p_ulist over padded slots, interpret mode); 1e-9, the f64 bar of
    tests/test_torch_kifmm.py."""
    rng = np.random.default_rng(34)
    xs, xt = rng.random((20000, 3)), rng.random((10000, 3))
    f = rng.normal(size=(20000, 1))
    jk = J_KIFMM(J_LAP, p=4, depth=2, use_pallas_p2p=False,
                 use_pallas_m2l=False, use_pallas_sl=True).setup(xs, xt)
    ops = operators_from_numpy(_tables(jk._ops, 4), "cpu", torch.float64)
    kf = KIFMM(LAP, p=4, depth=2, device="cpu", dtype=torch.float64,
               operators=ops).setup(xs, xt)
    assert not kf.surface_route and kf.near_route == "stencil"
    assert rel(kf.eval(f), np.asarray(jk.eval(f))) < 1e-9
