"""The port's adaptive-tree FMM against the JAX package's: the tree and
interaction lists (exact), the cold-built Stokes translation tables,
and the evaluation in float64 on the same tables.  The points are the
far-field quadrature nodes of a small torus, the surface distribution
the adaptive tree serves in the BIE."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.bie import torus_patches as j_torus
from sctl_tpu.fmm.adaptive import AdaptiveFMM as J_Adaptive
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops import Stokes3D_DxU as J_DXU
from sctl_tpu.ops import Stokes3D_FSxU as J_FS
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import (AdaptiveFMM, KIFMMOperators,
                                operators_from_numpy)
from sctl_tpu_torch.ops import Laplace3D_FxU, Stokes3D_DxU, Stokes3D_FSxU

limit_cpu_threads()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _torus_points():
    lst = j_torus(nu=6, nv=3, q=4, R=2.0, r=0.5)
    X, _, _ = lst.get_node_coord()
    Xf, Xnf, _, _, _ = lst.get_far_field_nodes(1e-6)
    return X, Xf, Xnf


def _tables(jops, p):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jops._rcond)
    return t


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """The JAX and the port AdaptiveFMM set up on the same points, p = 4,
    float64, the port on the JAX package's tables."""
    X, Xf, Xnf = _torus_points()
    rng = np.random.default_rng(11)
    if kind == "stokes":
        jk = J_Adaptive(J_DXU, p=4, max_pts=32, ker_l2t=J_FS,
                        use_pallas_ulist=False).setup(Xf, X, n_src=Xnf)
        f = rng.normal(size=(len(Xf), 3))
        ker, kt, nrm = Stokes3D_DxU, Stokes3D_FSxU, Xnf
    else:
        jk = J_Adaptive(J_LAP, p=4, max_pts=32,
                        use_pallas_ulist=False).setup(Xf, X)
        f = rng.normal(size=(len(Xf), 1))
        ker, kt, nrm = Laplace3D_FxU, Laplace3D_FxU, None
    ops = operators_from_numpy(_tables(jk._ops, 4), "cpu", torch.float64,
                               ker_trans=kt)
    af = AdaptiveFMM(ker, p=4, max_pts=32, device="cpu",
                     dtype=torch.float64, operators=ops).setup(Xf, X, nrm)
    return jk, af, f


def test_tree_and_lists_match_jax():
    jk, af, _ = _pair("stokes")
    t, tj = af.tree, jk.tree
    for name in ("perm", "leaf_keys", "leaf_levels", "leaf_dsp", "leaf_cnt"):
        np.testing.assert_array_equal(getattr(t, name), getattr(tj, name))
    assert af.L == jk.L and (af.cap_s, af.cap_t) == (jk.cap_s, jk.cap_t)
    np.testing.assert_array_equal(af.svalid.numpy() > 0, jk._svalid_np)
    np.testing.assert_array_equal(
        af.t_take.numpy(), np.nonzero(jk._tvalid_np.reshape(-1))[0])
    ok = af.ul_ok.numpy() > 0
    np.testing.assert_array_equal(np.where(ok, af.ul_rows.numpy(), -1),
                                  np.asarray(jk._data["ulist"]))
    d = jk._data
    for li, lv in enumerate(range(2, jk.L + 1)):
        jt, js = (np.asarray(a) for a in d["vtab"][li])
        if lv not in af.vtab:
            assert (jt < 0).all()
            continue
        np.testing.assert_array_equal(af.vtab[lv][0].numpy(), jt)
        np.testing.assert_array_equal(af.vtab[lv][1].numpy(), js)
    n_w = 0
    for lv in range(1, jk.L + 1):
        jt, jn = (np.asarray(a) for a in d["wpairs"][lv - 1])
        n_w += len(jt)
        pt, pn = (af.wpairs[lv][:2] if lv in af.wpairs
                  else (torch.zeros(0), torch.zeros(0)))
        np.testing.assert_array_equal(pt.numpy(), jt)
        np.testing.assert_array_equal(pn.numpy(), jn)
        xl = d["xlist_t"][lv - 1]
        jx = set() if xl is None else {
            (int(n), int(s)) for n, row in enumerate(np.asarray(xl))
            for s in row if s >= 0}
        px = (set() if lv not in af.xpairs else
              set(zip(*(a.numpy().tolist() for a in af.xpairs[lv][:2]))))
        assert px == jx
    assert n_w > 0 and len(af.vtab) > 0


@pytest.mark.parametrize("kind", ["stokes", "laplace"])
def test_adaptive_f64_matches_jax(kind):
    """Same tables, float64, the JAX U list in XLA: 1e-9 relative.  Not
    1e-12: the pinv operators amplify 1-ulp differences about a
    million-fold (the bar of tests/test_torch_kifmm.py's f64 slice)."""
    jk, af, f = _pair(kind)
    u_j = jk.eval(f)
    u = af.eval(f)
    assert rel(u, u_j) < 1e-9
    np.testing.assert_array_equal(af.eval_tensor(torch.as_tensor(f))
                                  .numpy(), u)


def test_stokes_tables_cold_match_jax():
    """The port's cold build of the Stokes3D-FSxU tables at p = 4 (rcond
    1e-9) against the JAX package's: the same numpy, so 1e-12."""
    ops = KIFMMOperators(Stokes3D_FSxU, 4, 1e-9, "cpu", torch.float64)
    jops = J_Ops(J_DXU, J_FS, J_FS, 4, 3, 1.0, jnp.float64, rcond=1e-9)
    for name in KIFMMOperators.TABLES:
        a, b = getattr(ops, name), np.asarray(getattr(jops, name))
        assert a.shape == b.shape, name
        assert rel(a, b) < 1e-12, name
    lt = ops.level_tables(3, 2.5)
    for name in ("uc2e", "dc2e", "surf_in", "surf_out"):
        j = getattr(J_Ops(J_DXU, J_FS, J_FS, 4, 3, 2.5, jnp.float64,
                          rcond=1e-9), name)
        for a, b in zip(lt[name], j):
            assert rel(a, b) < 1e-12, name
