"""The slice as a whole against the JAX package: the uniform KIFMM for
the five tree kernels beside Laplace3D-FxU, and the ParticleFMM facade
on its direct path (all eight kernels, normals, several source groups)
and its tree path (the Stokeslet above the cutoff).  Both packages get
the same inputs, made with numpy from fixed seeds; float64, depth <= 3.
The port builds its tables cold, once per (kernel, p, rcond) in the
process (`sctl_tpu_torch.fmm.kifmm.unit_tables`), so the cases that
share a translation kernel share them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.fmm import ParticleFMM as J_PFMM
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import DIRECT_CUTOFF, KIFMM, ParticleFMM
from sctl_tpu_torch.fmm.kifmm import KIFMMOperators
from sctl_tpu_torch.ops import KERNELS, direct_eval_blocked

limit_cpu_threads()

F64 = torch.float64
# kernel -> (p, bar against the direct sum): tests/test_fmm.py:156-196
# (Stokes at p=4: FxU 1e-2, DxU 5e-3; FxdU at p=6: 5e-3), and 5e-3 for
# the two kernels that test has no case for
TREE = {"Laplace3D-DxU": (6, 5e-3), "Laplace3D-FxdU": (6, 5e-3),
        "Stokes3D-FxU": (4, 1e-2), "Stokes3D-DxU": (4, 5e-3),
        "Stokes3D-FSxU": (4, 5e-3)}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cloud(seed, n, k0):
    rng = np.random.default_rng(seed)
    n_src = rng.normal(size=(n, 3))
    n_src /= np.linalg.norm(n_src, axis=1, keepdims=True)
    return (rng.random((n, 3)), rng.random((n, 3)), n_src,
            rng.normal(size=(n, k0)))


@pytest.mark.parametrize("name", list(TREE))
def test_kifmm_tree_kernel_matches_jax(name):
    """Depth 3, 3,000 points: the port's KIFMM (cold tables, rcond 1e-9)
    against the JAX KIFMM at 1e-8 of the maximum (measured 2.3e-14 to
    3.5e-12), and against the direct sum at the JAX test's bar."""
    p, bar = TREE[name]
    ker, jk = KERNELS[name], J_KERNELS[name]
    xs, xt, nrm, f = _cloud(16, 3000, ker.kdim0)
    n = nrm if ker.needs_normal else None
    u_j = np.asarray(J_KIFMM(jk, p=p, depth=3).setup(xs, xt, n_src=n)
                     .eval(f))
    kf = KIFMM(ker, p=p, depth=3, device="cpu", dtype=F64).setup(
        xs, xt, n_src=n)
    u = kf.eval(f)
    u_d = direct_eval_blocked(ker, torch.as_tensor(xt), torch.as_tensor(xs),
                              torch.as_tensor(f),
                              ns=torch.as_tensor(nrm)).numpy()
    assert u.shape == (3000, ker.kdim1)
    assert rel(u, u_j) < 1e-8
    assert rel(u, u_d) < bar


def test_stokes_level_tables_match_jax_to_depth_6():
    """Stokes3D-FSxU's per-level operators, which its source exponents
    (1, 1, 1, 2) make level-dependent, from the same unit tables (p = 4,
    rcond 1e-9) through bench_fmm's depth 6: the port's M2M and L2L per
    child level, uc2e and dc2e, and the M2L bases scaled by the row
    scaling m2l_s, against the JAX package's `_derive_levels`, 1e-12."""
    jk = J_KERNELS["Stokes3D-FSxU"]
    jops = J_Ops(J_KERNELS["Stokes3D-DxU"], jk, jk, 4, 6, 2.5, jnp.float64,
                 rcond=1e-9)
    tables = {k: np.asarray(getattr(jops, k))
              for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(KERNELS["Stokes3D-FSxU"], 4, 1e-9, "cpu", F64,
                         tables=tables)
    lt = ops.level_tables(6, 2.5)
    for name in ("m2m", "l2l", "uc2e", "dc2e"):
        assert len(lt[name]) == len(getattr(jops, name)), name
        for a, b in zip(lt[name], getattr(jops, name)):
            assert rel(a, b) < 1e-12, name
    for lvl, s in enumerate(lt["m2l_s"]):
        assert rel(ops.cb_unit * s[:, None], jops.m2l_u[lvl]) < 1e-12
        assert rel(ops.vb_unit / s[:, None], jops.m2l_v[lvl]) < 1e-12
    # the scaling is not the identity below the root
    assert rel(lt["m2l_s"][6], np.ones_like(lt["m2l_s"][6])) > 0.5


def test_stokes_kifmm_depth4_matches_jax():
    """The Stokeslet at depth 4 (levels 2-4 of M2L, M2M and L2L, each
    with its own scaling), p = 4, float64, 3,000 points: the port
    against the JAX KIFMM at 1e-8 of the maximum (measured 2.3e-13), and
    against the direct sum at the JAX test's bar (1e-2; measured 1.4e-3,
    as the JAX KIFMM's)."""
    ker = KERNELS["Stokes3D-FxU"]
    xs, xt, _, f = _cloud(23, 3000, 3)
    u_j = np.asarray(J_KIFMM(J_KERNELS["Stokes3D-FxU"], p=4, depth=4)
                     .setup(xs, xt).eval(f))
    u = KIFMM(ker, p=4, depth=4, device="cpu", dtype=F64).setup(
        xs, xt).eval(f)
    u_d = direct_eval_blocked(ker, torch.as_tensor(xt), torch.as_tensor(xs),
                              torch.as_tensor(f)).numpy()
    assert rel(u, u_j) < 1e-8
    assert rel(u, u_d) < 1e-2


def test_kifmm_double_layer_needs_normals():
    """setup refuses a double layer without normals, as the JAX
    package's does (tests/test_fmm.py:198)."""
    x = np.random.default_rng(17).random((500, 3))
    for name in ("Laplace3D-DxU", "Stokes3D-DxU"):
        with pytest.raises(ValueError):
            KIFMM(KERNELS[name], p=4, depth=2, device="cpu",
                  dtype=F64).setup(x, x)


def _facade(pkg, kernels, groups, xt, accuracy=6):
    """One ParticleFMM of `pkg` (the port's or the JAX package's) with
    source groups {name: (x, normals, f)} into target group "t"."""
    fmm = (ParticleFMM(accuracy=accuracy, device="cpu", dtype=F64)
           if pkg == "port" else J_PFMM(accuracy=accuracy))
    for s, (x, nrm, f) in groups.items():
        fmm.set_kernel_s2t(s, "t", kernels[s])
        fmm.set_src_coord(s, x, normal=nrm)
        fmm.set_src_density(s, f)
    fmm.set_trg_coord("t", xt)
    return fmm


@pytest.mark.parametrize("name", list(KERNELS))
def test_particle_fmm_direct_path_matches_jax(name):
    """1,000 points, below the cutoff: the port's ParticleFMM against the
    JAX package's, eval and eval_direct, 1e-12 (normals for all; only the
    double layers read them), and against the JAX package's per-pair
    host matrix, 1e-12.  Stokes3D-FxT meets the JAX facade at 1e-10:
    the JAX direct sum expands its r_j r_k in source moments
    (sctl_tpu/ops/uker.py `_uk_stk_fxt`), which cancels to 4e-11 here,
    while the port sums per pair."""
    from sctl_tpu.ops.kernels_np import full_matrix_np as j_full_np
    ker = KERNELS[name]
    xs, xt, nrm, f = _cloud(18, 1000, ker.kdim0)
    out = {}
    for pkg, kers in (("port", KERNELS), ("jax", J_KERNELS)):
        fmm = _facade(pkg, {"s": kers[name]}, {"s": (xs, nrm, f)}, xt)
        out[pkg] = (fmm.eval("t"), fmm.eval_direct("t"))
    bar = 1e-10 if name == "Stokes3D-FxT" else 1e-12
    assert out["port"][0].shape == (1000, ker.kdim1)
    assert rel(out["port"][0], out["jax"][0]) < bar
    assert rel(out["port"][1], out["jax"][1]) < bar
    m = j_full_np(J_KERNELS[name], xt, xs,
                  nrm if ker.needs_normal else None)
    u_m = (f.reshape(1, -1) @ m).reshape(-1, ker.kdim1)
    assert rel(out["port"][0], u_m) < 1e-12


def test_particle_fmm_source_groups_sum():
    """Two source groups into one target group (a Stokeslet and a Stokes
    double layer with its normals): eval sums them, as the JAX package's
    does, 1e-12."""
    a = _cloud(19, 700, 3)
    b = _cloud(20, 500, 3)
    names = {"a": "Stokes3D-FxU", "b": "Stokes3D-DxU"}
    groups = {"a": (a[0], None, a[3]), "b": (b[0], b[2], b[3])}
    u = {pkg: _facade(pkg, {s: kers[k] for s, k in names.items()}, groups,
                      a[1]).eval("t")
         for pkg, kers in (("port", KERNELS), ("jax", J_KERNELS))}
    assert rel(u["port"], u["jax"]) < 1e-12


def test_particle_fmm_tree_path_matches_jax():
    """The Stokeslet with 42,000 sources (above the cutoff, automatic
    depth 2) and 700 targets, accuracy 4 (p = 4): the port's tree path
    against the JAX package's at 1e-8 of the maximum, and against the
    port's direct sum at the JAX test's bar (1e-2)."""
    n = DIRECT_CUTOFF + 2000
    xs, _, _, f = _cloud(21, n, 3)
    xt = np.random.default_rng(22).random((700, 3))
    u = {}
    for pkg, kers in (("port", KERNELS), ("jax", J_KERNELS)):
        fmm = _facade(pkg, {"s": kers["Stokes3D-FxU"]}, {"s": (xs, None, f)},
                      xt, accuracy=4)
        u[pkg] = fmm.eval("t")
        if pkg == "port":
            kf = next(iter(fmm._kifmm_cache.values()))
            assert (kf.depth, kf.p) == (2, 4)
            u_d = fmm.eval_direct("t")
    assert rel(u["port"], u["jax"]) < 1e-8
    assert rel(u["port"], u_d) < 1e-2


@pytest.mark.parametrize("route", ["direct", "tree"])
def test_particle_fmm_eval_tensor_matches_eval_and_jax(route):
    """eval_tensor, densities as tensors in and a tensor out, against
    the port's eval (1e-12) and the JAX package's eval_jnp (as
    tests/test_fmm.py:116 holds it against eval) on both routes: the
    direct route with two source groups (a Stokeslet and a Stokes
    double layer with normals, 1,200 points), 1e-12; the tree route
    with the Laplace single layer at 42,000 sources (above the cutoff,
    depth 2, accuracy 4), 1e-9, the tree path's bar against the JAX
    KIFMM (the pinv operators amplify rounding)."""
    if route == "direct":
        a, b = _cloud(23, 700, 3), _cloud(24, 500, 3)
        names = {"a": "Stokes3D-FxU", "b": "Stokes3D-DxU"}
        groups = {"a": (a[0], None, a[3]), "b": (b[0], b[2], b[3])}
        xt, acc, bar = a[1], 6, 1e-12
    else:
        a = _cloud(25, DIRECT_CUTOFF + 2000, 1)
        names = {"a": "Laplace3D-FxU"}
        groups = {"a": (a[0], None, a[3])}
        xt = np.random.default_rng(26).random((700, 3))
        acc, bar = 4, 1e-9
    dens = {s: g[2] for s, g in groups.items()}
    fmm = _facade("port", {s: KERNELS[k] for s, k in names.items()}, groups,
                  xt, accuracy=acc)
    u = fmm.eval_tensor("t", {s: torch.as_tensor(f)
                              for s, f in dens.items()})
    assert isinstance(u, torch.Tensor) and u.dtype == F64
    assert rel(u.numpy(), fmm.eval("t")) < 1e-12
    if route == "tree":
        kf = next(iter(fmm._kifmm_cache.values()))
        assert (kf.depth, kf.p) == (2, 4)
    jf = _facade("jax", {s: J_KERNELS[k] for s, k in names.items()},
                 groups, xt, accuracy=acc)
    u_j = jf.eval_jnp("t", {s: jnp.asarray(f) for s, f in dens.items()})
    assert rel(u.numpy(), u_j) < bar
