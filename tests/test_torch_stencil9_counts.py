"""The slab stencil `p2p_stencil9` over real points only, against the
JAX package, and the direct sum's grid.

The port compacts each slab entry at setup (`slab_index` with the
boxes' counts): the 9 boxes' real points first, a count an entry, zeros
past it.  The JAX function reads every slot of its own layout (a block
of cap slots a box), whose padding carries zero density.  So the two
must agree wherever the JAX function's padding is zero (the port is
handed nonzero densities past the entries' counts, which it must not
read), and the port gives exactly zero at the target slots past the
counts.  Both packages get the same inputs, made with numpy from fixed
seeds; the Pallas kernel runs in interpret mode, in float64.  Then the
slice that runs the new inputs end to end: a depth-3 KIFMM whose near
field takes the slab stencil.  Last, `p2p_grid`, which sizes the direct
sum's grid to the card's resident blocks (pure arithmetic)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.ops import KERNELS as J_KERNELS
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops.pallas_p2p import p2p_stencil9 as j_p2p_stencil9
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.ops import KERNELS
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops.p2p import (p2p_grid, p2p_stencil9, slab_gather,
                                    slab_index, to_slab)

limit_cpu_threads()

T = torch.as_tensor
STENCIL = ["Laplace3D-FxU", "Laplace3D-DxU", "Stokes3D-FxU"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _near_field(depth):
    """A float64 KIFMM whose near field is the slab stencil, on points
    with empty boxes (none with x and y below 0.3) and a dense cluster,
    whose boxes overflow the source and target capacities (their
    counts clip at the caps)."""
    rng = np.random.default_rng(40 + depth)
    x = rng.random((300 * 8 ** (depth - 1), 3))
    x = x[(x[:, 0] > 0.3) | (x[:, 1] > 0.3)]
    x = np.concatenate([x, 0.6 + 0.04 * rng.random((300, 3))])
    kf = KIFMM(LAP, p=4, depth=depth, device="cpu",
               dtype=torch.float64).setup(x, x)
    assert kf.near_route == "stencil9"
    cnt_s = kf.cnt_s_rast.numpy()
    assert (cnt_s == 0).any() and (cnt_s == kf.cap_s).any()
    assert (kf.cnt_t_rast.numpy() == kf.cap_t).any()
    return kf


def _entry_live(cnt9, SL):
    """(n, n, n+2) entry counts -> (n, n, 1, (n+2) SL) bool."""
    n = cnt9.shape[0]
    return (np.arange(SL) < cnt9[..., None]).reshape(n, n, 1, -1)


@pytest.mark.parametrize("name", STENCIL)
@pytest.mark.parametrize("depth", [2, 3])
def test_compacted_stencil9_matches_pallas(depth, name):
    """The counted plain version on the KIFMM's compacted slab against
    the Pallas kernel on the JAX package's slab of the same slots, zero
    density past each box's count: 1e-12 of the maximum at the real
    target slots, zero past them.  The compacted slab carries nonzero
    densities and normals past each entry's count."""
    kf = _near_field(depth)
    ker = KERNELS[name]
    rng = np.random.default_rng(41)
    n, cs, ct, SL = 1 << depth, kf.cap_s, kf.cap_t, kf.SL
    B = n ** 3
    real = kf.pad_valid.numpy()[..., None]
    f = rng.normal(size=(B, cs, ker.kdim0))
    nrm = rng.normal(size=(B, cs, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    xs = kf.xs_pad.numpy()
    idx, cnt9 = slab_index(kf.rast_to_mort, n, cs, SL, kf.cnt_s_rast)
    dead = ~_entry_live(cnt9.numpy(), SL)

    def plant(a):                     # the compacted slab, nonzero past
        s = slab_gather(T(a), idx).numpy()          # each entry's count
        return T(np.where(dead, rng.normal(size=s.shape), s))

    u = p2p_stencil9(ker, n, SL, ct, kf.xt_rast, slab_gather(T(xs), idx),
                     plant(f), plant(nrm) if ker.needs_normal else None,
                     cnt9, kf.cnt_t_rast).numpy()
    inv = kf.rast_to_mort.numpy()
    jslab = lambda a: jnp.asarray(J_KIFMM._to_slab(a, inv, n))
    u_j = np.asarray(j_p2p_stencil9(
        J_KERNELS[name], n, SL, ct, jnp.asarray(kf.xt_rast.numpy()),
        jslab(xs), jslab(nrm * real), jslab(f * real), interpret=True))
    live = (np.arange(ct) < kf.cnt_t_rast.numpy()[..., None])[..., None]
    assert u.shape == u_j.shape == (n, n, n, ct, ker.kdim1)
    assert np.abs((u - u_j) * live).max() < 1e-12 * np.abs(u_j * live).max()
    assert (u[~np.broadcast_to(live, u.shape)] == 0).all()


@pytest.mark.parametrize("depth", [2, 3])
def test_compacted_slab_holds_each_entry_real_points_first(depth):
    """Each entry of the compacted slab holds the real slots of the JAX
    package's entry, in its order (box c = 3(dx+1) + dy+1, then slot),
    in its first cnt9 slots, and zeros past them; the JAX layout itself
    is `to_slab` without counts."""
    kf = _near_field(depth)
    n, cs, SL = 1 << depth, kf.cap_s, kf.SL
    B = n ** 3
    rng = np.random.default_rng(42)
    a = T(rng.normal(size=(B, cs, 2)))
    live_box = kf.pad_valid.reshape(B, cs, 1)
    idx, cnt9 = slab_index(kf.rast_to_mort, n, cs, SL, kf.cnt_s_rast)
    comp = slab_gather(a, idx).reshape(n, n, 2, n + 2, SL)
    full = to_slab(a, kf.rast_to_mort, n, SL).reshape(n, n, 2, n + 2, SL)
    mask = to_slab(live_box, kf.rast_to_mort, n, SL).reshape(
        n, n, 1, n + 2, SL) > 0
    assert (cnt9 == mask.sum(-1)[:, :, 0]).all()
    order = torch.sort((~mask).to(torch.int8), dim=-1, stable=True)[1]
    first = torch.gather(full, -1, order.expand_as(full))
    keep = torch.arange(SL) < cnt9[:, :, None, :, None]
    assert torch.equal(comp, torch.where(keep, first, 0.0))


def _tables(jops, p):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jops._rcond)
    return t


def test_kifmm_stencil9_route_matches_jax():
    """A depth-3 KIFMM, float64, p = 4, on the JAX package's tables, at
    about 40 points a box: the near field through the compacted slab
    stencil, against the JAX KIFMM; 1e-9, the f64 bar of
    tests/test_torch_kifmm.py (the pinv operators amplify 1-ulp
    differences about a million-fold)."""
    rng = np.random.default_rng(43)
    xs, xt = rng.random((20000, 3)), rng.random((12000, 3))
    f = rng.normal(size=(20000, 1))
    jk = J_KIFMM(J_LAP, p=4, depth=3, use_pallas_p2p=False,
                 use_pallas_m2l=False, use_pallas_sl=False).setup(xs, xt)
    ops = operators_from_numpy(_tables(jk._ops, 4), "cpu", torch.float64)
    kf = KIFMM(LAP, p=4, depth=3, device="cpu", dtype=torch.float64,
               operators=ops).setup(xs, xt)
    assert kf.near_route == "stencil9"
    assert int(kf.cnt9.sum()) < kf.cnt9.numel() * kf.SL
    assert rel(kf.eval(f), np.asarray(jk.eval(f))) < 1e-9


@pytest.mark.parametrize("T_,S,resident", [
    (1000, 10_000_000, 660), (1000, 10_000_000, 1056),
    (4096, 39_000, 1056), (39_000, 39_000, 792), (300, 300, 1056),
    (5, 0, 1056)])
def test_p2p_grid_covers_sources_near_one_full_wave(T_, S, resident):
    """The direct sum's splits cover the sources in whole tiles, and the
    grid's waves times a block's tiles lie within 10% of the ideal (every
    resident block busy to the end), or are one wave of one tile."""
    per_block, tile = 256, 128
    nsplit, chunk = p2p_grid(T_, S, per_block, tile, resident)
    assert chunk % tile == 0 and nsplit * chunk >= S
    assert nsplit == 1 or (nsplit - 1) * chunk < S
    t_blocks, tiles = -(-T_ // per_block), max(1, -(-S // tile))
    waves = -(-t_blocks * nsplit // resident)
    assert waves * (chunk // tile) <= max(1.0, 1.1 * t_blocks * tiles
                                          / resident)
