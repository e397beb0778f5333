"""The port's uniform Laplace KIFMM against the JAX package's: operator
tables, the whole slice in float64 and in float32, against a direct
sum, and the ParticleFMM facade.  Both packages get the same inputs,
made with numpy from fixed seeds, and (where stated) the same tables
through `operators_from_numpy`."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import (DIRECT_CUTOFF, KIFMM, KIFMMOperators,
                                ParticleFMM, operators_from_numpy)
from sctl_tpu_torch.ops import KERNELS
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops import direct_eval_blocked
from sctl_tpu_torch.ops.kernels import KernelSpec

limit_cpu_threads()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tables(jops):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=jops.p, rcond=jops._rcond)
    return t


def _cloud(seed, n_s=3000, n_t=2500):
    """Uniform sources; targets concentrated in one corner, so both the
    source and the target overflow sidebands are used."""
    rng = np.random.default_rng(seed)
    xs = rng.random((n_s, 3))
    xt = np.concatenate([rng.random((n_t // 2, 3)),
                         rng.random((n_t - n_t // 2, 3)) ** 2])
    return xs, xt, rng.normal(size=(n_s, 1))


@pytest.mark.parametrize("rcond", [1e-9, 3e-5])
def test_operator_tables_match_jax(rcond):
    """Cold-built tables at p = 6 against the JAX package's.  The host
    code is the same numpy; the only differences come from BLAS and
    LAPACK threading, hence 1e-12 relative."""
    ops = KIFMMOperators(LAP, 6, rcond, "cpu", torch.float64)
    jops = J_Ops(J_LAP, J_LAP, J_LAP, 6, 3, 1.0, jnp.float64, rcond=rcond)
    for name in KIFMMOperators.TABLES:
        a, b = getattr(ops, name), np.asarray(getattr(jops, name))
        assert a.shape == b.shape, name
        assert rel(a, b) < 1e-12, name
    if rcond == 3e-5:
        jops32 = J_Ops(J_LAP, J_LAP, J_LAP, 6, 3, 1.0, jnp.float32,
                       rcond=rcond)
        assert (ops.m2l_cap_r, ops.m2l_cap_r2) == (jops32.m2l_cap_r,
                                                   jops32.m2l_cap_r2)


def test_slice_f64_matches_jax():
    """Depth 3, p = 6, same tables: the port (plain versions, f64)
    against the JAX KIFMM with every Pallas route off, at every target
    including the overflow sidebands.

    The bar is 1e-9, not 1e-12: the pinv operators (rcond 1e-9) amplify
    rounding about a million-fold.  Measured on this input: 1-ulp random
    noise put into the port's own S2M check potentials moves its result
    by 1.9e-10 of the maximum, and the two packages differ by 1.8e-10
    (3.0e-10 since the port's float64 M2L is the per-parity sweep, the
    JAX package's float64 route; tests/test_torch_kifmm_f64.py); the
    M2L and L2T orders of summation and coordinate forms were each
    ruled out as the cause (each changes the result by < 1e-15)."""
    xs, xt, f = _cloud(0)
    jk = J_KIFMM(J_LAP, p=6, depth=3, use_pallas_p2p=False,
                 use_pallas_m2l=False, use_pallas_sl=False).setup(xs, xt)
    u_j = np.asarray(jk.eval(f))
    ops = operators_from_numpy(_tables(jk._ops), "cpu", torch.float64)
    kf = KIFMM(LAP, p=6, depth=3, device="cpu", dtype=torch.float64,
               operators=ops).setup(xs, xt)
    assert kf.n_ovf_s > 0 and kf.n_ovf_t > 0
    assert rel(kf.eval(f), u_j) < 1e-9


def test_slice_f32_matches_jax_pallas_route():
    """Depth 3, f32: the port's plain kernel versions against the JAX
    KIFMM with its Pallas P2P, M2L and S2M/L2T kernels in interpret
    mode; bar 6e-4 of the maximum (tests/test_fmm.py:443)."""
    xs, xt, f = _cloud(1, 1500, 1500)
    jk = J_KIFMM(J_LAP, p=6, depth=3, dtype=jnp.float32,
                 use_pallas_p2p=True, use_pallas_m2l=True,
                 use_pallas_sl=True).setup(xs, xt)
    assert jk._sl_on and jk._data["m2l_blk"] is not None
    u_j = np.asarray(jk.eval(f))
    ops = operators_from_numpy(_tables(jk._ops), "cpu", torch.float32)
    kf = KIFMM(LAP, p=6, depth=3, device="cpu", dtype=torch.float32,
               operators=ops).setup(xs, xt)
    assert (kf.cap_s, kf.cap_t, kf.SL) == (jk.cap_s, jk.cap_t, jk.SL)
    assert rel(kf.eval(f), u_j) < 6e-4


@functools.lru_cache(maxsize=None)
def _cold_ops(p, dtype):
    """The port's own cold-built tables (rcond 1e-9 in float64, 3e-5 in
    float32), shared by the tests below."""
    return KIFMMOperators(LAP, p, 1e-9 if dtype == torch.float64 else 3e-5,
                          "cpu", dtype)


def test_slice_f64_vs_direct():
    """The port's f64 KIFMM (cold tables, rcond 1e-9) against its direct
    sum; bar twice BASELINE.md rung 3 (3.6e-6)."""
    rng = np.random.default_rng(12)
    x = rng.random((2000, 3))
    f = rng.normal(size=(2000, 1))
    kf = KIFMM(LAP, p=6, depth=3, device="cpu", dtype=torch.float64,
               operators=_cold_ops(6, torch.float64)).setup(x, x)
    X = torch.as_tensor(x)
    u_d = direct_eval_blocked(LAP, X, X, torch.as_tensor(f)).numpy()
    assert rel(kf.eval(f), u_d) < 2 * 3.6e-6


def test_eval_tensor_matches_eval():
    xs, xt, f = _cloud(2, 1200, 900)
    kf = KIFMM(LAP, p=4, depth=3, device="cpu",
               dtype=torch.float64).setup(xs, xt)
    u = kf.eval_tensor(torch.as_tensor(f)).numpy()
    np.testing.assert_array_equal(u, kf.eval(f))


def test_particle_fmm_tree_and_direct():
    """eval against eval_direct in the port: the tree path above the
    cutoff (bar 2e-4, tests/test_fmm.py:113) and the direct path below
    it (identical)."""
    rng = np.random.default_rng(3)
    for n, bar in ((DIRECT_CUTOFF + 2000, 2e-4), (500, 1e-12)):
        fmm = ParticleFMM(accuracy=6, device="cpu", dtype=torch.float64)
        fmm.set_kernel_s2t("s", "t", LAP)
        fmm.set_src_coord("s", rng.random((n, 3)))
        fmm.set_src_density("s", rng.normal(size=(n, 1)))
        fmm.set_trg_coord("t", rng.random((700, 3)))
        assert rel(fmm.eval("t"), fmm.eval_direct("t")) < bar


def test_particle_fmm_stokes_direct_matches_jax():
    """ParticleFMM takes the Stokeslet: with 1,000 points the JAX
    package returns the direct sum, and so does the port, to 1e-12 in
    float64 (the port raised NotImplementedError for every kernel but
    Laplace3D-FxU)."""
    from sctl_tpu.fmm import ParticleFMM as J_PFMM
    rng = np.random.default_rng(14)
    x = rng.random((1000, 3))
    f = rng.normal(size=(1000, 3))
    us = []
    for fmm in (J_PFMM(accuracy=6),
                ParticleFMM(accuracy=6, device="cpu", dtype=torch.float64)):
        fmm.set_kernel_s2t("s", "t", KERNELS["Stokes3D-FxU"]
                           if isinstance(fmm, ParticleFMM)
                           else J_KERNELS["Stokes3D-FxU"])
        fmm.set_src_coord("s", x)
        fmm.set_src_density("s", f)
        fmm.set_trg_coord("t", x)
        us.append(fmm.eval("t"))
    assert us[1].shape == (1000, 3)
    assert rel(us[1], us[0]) < 1e-12


@pytest.mark.parametrize("name", ["Laplace3D-DxU", "Stokes3D-DxU"])
def test_particle_fmm_passes_normals(name):
    """The double layers read the source normals given to set_src_coord
    (the direct path passed none, and set_src_coord took none): eval and
    eval_direct against the direct sum with the normals, 1e-12."""
    ker = KERNELS[name]
    rng = np.random.default_rng(15)
    x = rng.random((800, 3))
    n = rng.normal(size=(800, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    f = rng.normal(size=(800, ker.kdim0))
    fmm = ParticleFMM(device="cpu", dtype=torch.float64)
    fmm.set_kernel_s2t("s", "t", ker)
    fmm.set_src_coord("s", x, normal=n)
    fmm.set_src_density("s", f)
    fmm.set_trg_coord("t", x[:300])
    X = torch.as_tensor(x)
    u_d = direct_eval_blocked(ker, X[:300], X, torch.as_tensor(f),
                              ns=torch.as_tensor(n)).numpy()
    assert rel(fmm.eval("t"), u_d) < 1e-12
    assert rel(fmm.eval_direct("t"), u_d) < 1e-12


def test_unported_requests_raise():
    """The uniform KIFMM takes the six kernels with a tree path and
    ParticleFMM all eight; Stokes3D-FxT has no tree path, an unknown
    kernel is refused, and float16 is no type of the port."""
    with pytest.raises(NotImplementedError):
        KIFMM(KERNELS["Stokes3D-FxT"], device="cpu")
    unknown = KernelSpec("Stokes3D-FxQ", 3, 3, False, 1.0, (1.0,) * 3,
                         (0.0,) * 3)
    with pytest.raises(NotImplementedError):
        ParticleFMM(device="cpu").set_kernel_s2t("s", "t", unknown)
    with pytest.raises(NotImplementedError):
        KIFMM(LAP, device="cpu", dtype=torch.float16)


def _depth2_case(seed, n):
    rng = np.random.default_rng(seed)
    return rng.random((n, 3)), rng.random((n // 2, 3)), \
        rng.normal(size=(n, 1))


@pytest.mark.parametrize("n", [3000, 20000])
def test_depth2_ulist_route_matches_jax(n):
    """Depth 2 (64 boxes, not a multiple of 128), float32: S2M and L2T
    through the U-list kernel's plain version, and at 20,000 points
    (about 300 a box, beyond the slab stencil's block) the near field
    through the halo stencil's, against the JAX KIFMM at depth 2 with
    use_pallas_sl=True, whose S2M and L2T take pallas_p2p.p2p_ulist in
    interpret mode.  Bar 6e-4 of the maximum (tests/test_fmm.py:443)."""
    xs, xt, f = _depth2_case(4, n)
    jk = J_KIFMM(J_LAP, p=6, depth=2, dtype=jnp.float32,
                 use_pallas_p2p=False, use_pallas_m2l=False,
                 use_pallas_sl=True).setup(xs, xt)
    assert not jk._sl_on
    u_j = np.asarray(jk.eval(f))
    ops = operators_from_numpy(_tables(jk._ops), "cpu", torch.float32)
    kf = KIFMM(LAP, p=6, depth=2, device="cpu", dtype=torch.float32,
               operators=ops).setup(xs, xt)
    assert not kf.surface_route
    assert kf.near_route == ("stencil9" if n == 3000 else "stencil")
    assert rel(kf.eval(f), u_j) < 6e-4


def test_depth2_f64_vs_direct():
    """The depth-2 U-list route in float64 (cold tables, rcond 1e-9)
    against the direct sum; bar twice BASELINE.md rung 3 (3.6e-6)."""
    xs, xt, f = _depth2_case(5, 3000)
    kf = KIFMM(LAP, p=6, depth=2, device="cpu", dtype=torch.float64,
               operators=_cold_ops(6, torch.float64)).setup(xs, xt)
    assert not kf.surface_route
    u_d = direct_eval_blocked(LAP, torch.as_tensor(xt), torch.as_tensor(xs),
                              torch.as_tensor(f)).numpy()
    assert rel(kf.eval(f), u_d) < 2 * 3.6e-6


def test_depth_gate_removed():
    """The card no longer refuses depth 2: no depth gate is left in
    KIFMM, and the routes follow the shapes alone (the shared-surface
    kernels at a box count that is a multiple of 128, the U-list
    kernel below it), the same on the card as on the CPU."""
    import sctl_tpu_torch.fmm.kifmm as kifmm_mod
    assert not hasattr(kifmm_mod, "MIN_CUDA_DEPTH")
    x = np.random.default_rng(6).random((2000, 3))
    routes = {d: KIFMM(LAP, p=4, depth=d, device="cpu",
                       operators=_cold_ops(4, torch.float32))
              .setup(x, x).surface_route for d in (2, 3)}
    assert routes == {2: False, 3: True}
