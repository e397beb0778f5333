"""The port's last two kernels against the JAX package: the 316-offset
grid M2L (`m2l_grid`) and the near field over 9 shifted halo columns
(`p2p_stencil`), their host layouts, the data-selected M2L route, and
the slice that runs both, `KIFMM(p=8)` in float32.  The Pallas kernels
run in interpret mode; both packages get the same inputs, made with
numpy from fixed seeds, and (where stated) the same tables through
`operators_from_numpy`."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.config import config as j_config
from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.fmm.kifmm import _vlist_offsets as j_vlist_offsets
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops.pallas_m2l import _sorted_tables
from sctl_tpu.ops.pallas_m2l import m2l_grid as j_m2l_grid
from sctl_tpu.ops.pallas_p2p import p2p_stencil as j_p2p_stencil
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.fmm.kifmm import m2l_route
from sctl_tpu_torch.ops import KERNELS
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops import direct_eval_blocked
from sctl_tpu_torch.ops.m2l import m2l_grid, parity_offsets
from sctl_tpu_torch.ops.p2p import p2p_stencil, to_halo

limit_cpu_threads()

T = torch.as_tensor


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tables(jops):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=jops.p, rcond=jops._rcond)
    return t


@functools.lru_cache(maxsize=None)
def _jax_tables(p):
    """The JAX package's float32 tables at order p (rcond 3e-5)."""
    return _tables(J_Ops(J_LAP, J_LAP, J_LAP, p, 3, 1.0, jnp.float32,
                         rcond=3e-5))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("threepass,bar", [(True, 1e-4), (False, 1e-5)])
def test_m2l_grid_plain_matches_pallas(n, threepass, bar):
    """`m2l_grid`'s plain version against the Pallas kernel at the p=8
    caps (r = 80, r2 = 256).  The margins are random too, so that every
    offset's index is checked.  The bars: the Pallas kernel's bf16
    three-pass split keeps about 1e-5 of each product (1e-4 over the
    sums); in full f32 (HIGHEST) only the order of summation differs."""
    rng = np.random.default_rng(40 + n)
    r, r2 = 80, 256
    qp = rng.normal(size=(n + 6,) * 3 + (r2,)).astype(np.float32)
    mats = (rng.normal(size=(316, r2, r)) / np.sqrt(r2)).astype(np.float32)
    u_j = np.asarray(j_m2l_grid(jnp.asarray(qp), jnp.asarray(mats), n, r,
                                r2, interpret=True, threepass=threepass))
    u = m2l_grid(T(qp), T(mats)).numpy()
    assert u.shape == (n, n, n, r)
    assert rel(u, u_j) < bar


def test_parity_offsets_match_pallas_masks():
    """The port's per-parity offset lists carry exactly the validity of
    the Pallas kernel's (316, t, t, n) masks, box by box, and the same
    offsets in the same canonical order."""
    n, t = 8, 4
    _, order, _, masks = _sorted_tables(n, t)
    d, _ = j_vlist_offsets()
    tab = parity_offsets()
    assert tab.shape == (8, 189, 4)
    for x in range(t):
        for y in range(t):
            for z in range(n):
                c = 4 * (x % 2) + 2 * (y % 2) + z % 2
                valid = np.sort(order[masks[:, x, y, z] > 0])
                np.testing.assert_array_equal(tab[c, :, 3], valid)
                np.testing.assert_array_equal(tab[c, :, :3], d[valid])


def test_to_halo_matches_reference(monkeypatch):
    """`to_halo` on the JAX package's own box slots (its shifted-window
    route, p2p_packed9 off) reproduces its halo columns exactly."""
    monkeypatch.setattr(j_config, "p2p_packed9", False)
    rng = np.random.default_rng(41)
    x = rng.random((6000, 3))
    jk = J_KIFMM(J_LAP, p=4, depth=2, dtype=jnp.float32,
                 use_pallas_p2p=True).setup(x, x)
    xs_p2 = jk.src_tree.X_sorted[jk._sidx2_np]
    inv = torch.tensor(np.asarray(jk._data["rast_to_mort"]),
                       dtype=torch.long)
    halo = to_halo(T(xs_p2), inv, 4).float().numpy()
    np.testing.assert_array_equal(halo, np.asarray(jk._data["xs_halo"]))


@pytest.mark.parametrize("name", ["Laplace3D-FxU", "Stokes3D-DxU"])
def test_p2p_stencil_plain_matches_pallas(name):
    """`p2p_stencil`'s plain version against the Pallas kernel in
    interpret mode on a 4^3 grid (every column but four touches the
    boundary), 5 sources in each box's 64 slots, unit normals; bar 2e-4
    of the maximum (tests/test_pallas_p2p.py:138-187)."""
    ker, jker = KERNELS[name], J_KERNELS[name]
    rng = np.random.default_rng(42)
    n, cap, cap_t, npb = 4, 64, 8, 5
    k0 = ker.kdim0
    w = 1.0 / n
    xs_b = np.zeros((n, n, n, cap, 3), np.float32)
    ns_b = np.zeros((n, n, n, cap, 3), np.float32)
    f_b = np.zeros((n, n, n, cap, k0), np.float32)
    lo = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    xs_b[..., :npb, :] = (lo[..., None, :]
                          + rng.random((n, n, n, npb, 3))) * w
    nrm = rng.normal(size=(n, n, n, npb, 3))
    ns_b[..., :npb, :] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    f_b[..., :npb, :] = rng.normal(size=(n, n, n, npb, k0))
    xt_g = ((lo[..., None, :] + rng.random((n, n, n, cap_t, 3))) * w) \
        .transpose(0, 1, 2, 4, 3).astype(np.float32)
    ident = torch.arange(n ** 3)
    halo = lambda a: to_halo(T(a.reshape(n ** 3, cap, -1)), ident, n)
    xs_h, ns_h, f_h = halo(xs_b), halo(ns_b), halo(f_b)
    u_j = np.asarray(j_p2p_stencil(
        jker, n, cap, cap_t, jnp.asarray(xt_g), jnp.asarray(xs_h.numpy()),
        jnp.asarray(ns_h.numpy()), jnp.asarray(f_h.numpy()),
        interpret=True))
    u = p2p_stencil(ker, n, cap, cap_t, T(xt_g), xs_h, f_h, ns_h).numpy()
    assert u.shape == (n, n, n, cap_t, ker.kdim1)
    assert np.abs(u - u_j).max() < 2e-4 * np.abs(u_j).max()


def test_m2l_route_by_stack_size():
    """The float32 M2L route follows the stacks' sizes with the JAX
    package's gates: Laplace p=6 (caps 72/128) -> blocked, Laplace p=8
    (80/256) -> grid, Stokes p=6 (248/512; PERF.md) -> the per-parity
    sweep; only the route's stack is built."""
    assert (m2l_route(72, 128), m2l_route(80, 256),
            m2l_route(248, 512)) == ("blocked", "grid", "parity")
    routes = {}
    for p in (6, 8):
        ops = operators_from_numpy(_jax_tables(p), "cpu", torch.float32)
        ops.device_tables()
        routes[p] = (ops.m2l_route, ops.blk_r, ops.blk_r2,
                     ops.m2l_blk is None, ops.m2l_at is None)
    assert routes == {6: ("blocked", 72, 128, False, True),
                      8: ("grid", 80, 256, True, False)}


def test_slice_p8_f32_matches_jax_grid_route():
    """Depth 3, p = 8, float32, same tables: the port on the CPU (its
    level 3 through `m2l_grid`'s plain version) against the JAX KIFMM
    with its Pallas kernels in interpret mode, whose level 3 runs
    `m2l_grid` (p=8's blocked stack exceeds its gate).  Bar 6e-4 of the
    maximum (tests/test_fmm.py:443)."""
    rng = np.random.default_rng(43)
    xs = rng.random((1500, 3))
    f = rng.normal(size=(1500, 1))
    jk = J_KIFMM(J_LAP, p=8, depth=3, dtype=jnp.float32,
                 use_pallas_p2p=True, use_pallas_m2l=True,
                 use_pallas_sl=True).setup(xs, xs)
    assert jk._data["m2l_blk"] is None
    u_j = np.asarray(jk.eval(f))
    ops = operators_from_numpy(_tables(jk._ops), "cpu", torch.float32)
    kf = KIFMM(LAP, p=8, depth=3, device="cpu", dtype=torch.float32,
               operators=ops).setup(xs, xs)
    assert kf._ops.m2l_route == "grid"
    assert rel(kf.eval(f), u_j) < 6e-4


def test_near_field_beyond_stencil9_matches_jax(monkeypatch):
    """Depth 2, 20,000 points (about 300 a box, beyond the slab
    stencil's block), float32: the port's near field through
    `p2p_stencil`'s plain version against the JAX KIFMM with its
    shifted-window `p2p_stencil` in interpret mode (p2p_packed9 off for
    this test), S2M and L2T through `p2p_ulist`.  The JAX package
    rounds its capacity up to 128 slots on this route (384 against the
    port's 344), so the two split the points between box slots and
    sidebands differently; both sums are exact.  Bar 6e-4 of the
    maximum (tests/test_fmm.py:443)."""
    monkeypatch.setattr(j_config, "p2p_packed9", False)
    rng = np.random.default_rng(4)
    xs, xt = rng.random((20000, 3)), rng.random((10000, 3))
    f = rng.normal(size=(20000, 1))
    jk = J_KIFMM(J_LAP, p=6, depth=2, dtype=jnp.float32,
                 use_pallas_p2p=True, use_pallas_m2l=False,
                 use_pallas_sl=True).setup(xs, xt)
    assert not jk._p2p_packed9 and "xs_halo" in jk._data
    u_j = np.asarray(jk.eval(f))
    ops = operators_from_numpy(_tables(jk._ops), "cpu", torch.float32)
    kf = KIFMM(LAP, p=6, depth=2, device="cpu", dtype=torch.float32,
               operators=ops).setup(xs, xt)
    assert kf.near_route == "stencil"
    assert rel(kf.eval(f), u_j) < 6e-4


def test_rung2_p8_f32_vs_direct():
    """BASELINE.md rung 2, the float32 accuracy floor, on the port: its
    own cold p=8 tables, depth 3, 4,000 points, against the float64
    direct sum; bar 1e-4 (tests/test_accuracy_ladder.py:32-33)."""
    rng = np.random.default_rng(44)
    x = rng.random((4000, 3))
    f = rng.normal(size=(4000, 1))
    kf = KIFMM(LAP, p=8, depth=3, device="cpu",
               dtype=torch.float32).setup(x, x)
    assert kf._ops.m2l_route == "grid"
    X = torch.as_tensor(x)
    u_d = direct_eval_blocked(LAP, X, X, torch.as_tensor(f)).numpy()
    assert rel(kf.eval(f), u_d) < 1e-4
