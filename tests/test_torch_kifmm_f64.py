"""The port's uniform KIFMM in float64 against the JAX package's float64
KIFMM, and the float64 route rules.

float64 takes the JAX package's float64 M2L route, the per-parity sweep
at the exact ranks, on every device, so these CPU tests cover the
route the card runs; the pair kernels' route rules read the element
size.  Both packages get the same inputs, made with numpy from fixed
seeds, and the same cold tables (the JAX package's, carried by
`operators_from_numpy`).  The JAX package writes no table cache here:
its `_save_cache` is replaced by a no-op for these tests (it reads a
cache that is already there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.fmm import ParticleFMM
from sctl_tpu_torch.ops import KERNELS, Laplace3D_FxU, Stokes3D_FSxU
from sctl_tpu_torch.ops.p2p import stencil9_fits
from sctl_tpu_torch.ops.sl import l2t_surface_fits, surface_pair_fits

limit_cpu_threads()

F64 = torch.float64


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(autouse=True)
def no_jax_cache_writes(monkeypatch):
    monkeypatch.setattr(J_Ops, "_save_cache", lambda self, path: None)


def _cloud(seed, k0, n_s=3000, n_t=2500):
    """Uniform sources; targets concentrated in one corner, so both the
    source and the target overflow sidebands are used."""
    rng = np.random.default_rng(seed)
    xs = rng.random((n_s, 3))
    xt = np.concatenate([rng.random((n_t // 2, 3)),
                         rng.random((n_t - n_t // 2, 3)) ** 2])
    return xs, xt, rng.normal(size=(n_s, k0))


@pytest.mark.parametrize("name,p", [("Laplace3D-FxU", 6),
                                    ("Stokes3D-FxU", 4)])
def test_slice_f64_matches_jax(name, p):
    """Depth 3, float64, the JAX package's cold tables (rcond 1e-9): the
    port (the per-parity M2L sweep at the exact ranks, the plain
    versions of S2M, L2T and the slab stencil) against the JAX KIFMM
    with every Pallas route off, at every target, the overflow
    sidebands included.  The bar is twice the JAX package's own spread
    under a 1-ulp change of the densities: the pinv operators amplify
    float64 rounding about a million-fold, so two correct evaluations
    differ by that spread (1.9e-10 for Laplace at p = 6).  Stokes at
    p = 4: the JAX package's Stokes KIFMM at p = 6 holds 16 GB in
    float64 (its per-level copies of the 700 MB compressed M2L family),
    more than a worker of the test run can take; p = 4 runs the same
    route (Stokes3D-FSxU translations, the per-level M2L scaling) in
    2.6 GB."""
    ker = KERNELS[name]
    xs, xt, f = _cloud(0, ker.kdim0)
    jk = J_KIFMM(J_KERNELS[name], p=p, depth=3, dtype=jnp.float64,
                 use_pallas_p2p=False, use_pallas_m2l=False,
                 use_pallas_sl=False).setup(xs, xt)
    u_j = np.asarray(jk.eval(f))
    spread = rel(np.asarray(jk.eval(f + np.spacing(f))), u_j)
    tables = {k: getattr(jk._ops, k) for k in KIFMMOperators.TABLES}
    tables.update(p=p, rcond=jk._ops._rcond)
    ops = operators_from_numpy(tables, "cpu", F64,
                               KERNELS[jk.ker_trans.name])
    kf = KIFMM(ker, p=p, depth=3, device="cpu", dtype=F64,
               operators=ops).setup(xs, xt)
    assert kf._ops.m2l_route == "parity"
    assert (kf._ops.blk_r, kf._ops.blk_r2) == kf._ops.ca_unit.shape[1:]
    assert kf.n_ovf_s > 0 and kf.n_ovf_t > 0
    assert kf.surface_route and kf.near_route == "stencil9"
    assert 0 < spread < 1e-8
    assert rel(kf.eval(f), u_j) < 2 * spread


def test_f64_route_is_parity_on_every_device():
    """float64 takes the per-parity sweep at the exact ranks and builds
    no blocked or grid stack; float32 keeps its route by the stacks'
    sizes (Laplace p = 6: blocked).  The JAX package gates its Pallas
    M2L kernels on float32 (sctl_tpu/fmm/kifmm.py:1186-1188,
    :1216-1217), so its float64 takes the same sweep."""
    ops = KIFMMOperators(Laplace3D_FxU, 6, 1e-9, "cpu", F64).device_tables()
    assert ops.m2l_route == "parity"
    assert ops.m2l_blk is None and ops.m2l_at is None
    assert (ops.blk_r, ops.blk_r2) == ops.ca_unit.shape[1:]
    ops32 = KIFMMOperators(Laplace3D_FxU, 6, 3e-5, "cpu", torch.float32)
    assert ops32.m2l_route == "blocked"


def test_fit_rules_read_element_size():
    """The three route rules at 4 and 8 bytes a value, on shapes where
    float32 and float64 differ, against the 227 KB of shared memory: the
    slab stencil's window at SL 1,280 (120 KB of float, 240 KB of
    double), the S2M tiles at cap 344 (phase 7's: 172 KB, 345 KB) and
    the Stokes L2T records at ns 296 (p = 8: 152 KB, 303 KB)."""
    lap, stk = Laplace3D_FxU, Stokes3D_FSxU
    assert stencil9_fits(lap, 48, 1280) and not stencil9_fits(
        lap, 48, 1280, F64)
    assert stencil9_fits(lap, 48, 1152, F64)
    assert surface_pair_fits(lap, 344) and not surface_pair_fits(
        lap, 344, F64)
    assert surface_pair_fits(lap, 227, F64) and not surface_pair_fits(
        lap, 228, F64)
    assert l2t_surface_fits(stk, 152, F64) and l2t_surface_fits(stk, 296)
    assert not l2t_surface_fits(stk, 296, F64)


def test_kifmm_routes_follow_dtype():
    """A depth-3 field at about 330 points a box (cap_s past 227): in
    float32 S2M and L2T take the shared-surface kernels, in float64 the
    U-list kernel (the surface rule at 8 bytes), and the result is the
    same function; the near field takes the halo stencil in both."""
    rng = np.random.default_rng(21)
    x = rng.random((512 * 330, 3))
    routes = {}
    for dt in (torch.float32, F64):
        kf = KIFMM(Laplace3D_FxU, p=4, depth=3, device="cpu",
                   dtype=dt).setup(x, x)
        routes[dt] = (kf.cap_s > 227, kf.surface_route, kf.near_route)
    assert routes == {torch.float32: (True, True, "stencil"),
                      F64: (True, False, "stencil")}


def test_f64_gate_removed(monkeypatch):
    """KIFMM and ParticleFMM take float64 on the card: with a card
    present (stubbed here) neither refuses the dtype any more."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    kf = KIFMM(Laplace3D_FxU, p=6, device="cuda", dtype=F64)
    assert kf.device.type == "cuda" and kf.rcond == 1e-9
    fmm = ParticleFMM(accuracy=8, device="cuda", dtype=F64)
    assert fmm.device.type == "cuda" and fmm.dtype == F64
    with pytest.raises(NotImplementedError):
        KIFMM(Laplace3D_FxU, device="cuda", dtype=torch.float16)
