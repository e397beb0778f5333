"""The arithmetic of the two M2L kernels on the tensor cores (3xTF32),
checked on the CPU: `tf32_split` on the JAX package's real p=6 and p=8
float32 operator stacks and on random data of wide range, and the
plain PyTorch emulation of the kernels (`m2l_grid_blocked_tf32x3`,
`m2l_grid_tf32x3`: TF32 hi and lo parts by integer rounding of the f32
bits, the three products lo hi + hi lo + hi hi summed in f32) against
the Pallas kernels in interpret mode in full f32 (threepass=False; bar
1e-5, the order of summation) and against a float64 evaluation, where
its error may be at most twice the float32 plain version's.  The
stacks are those of the float32 routes at their caps: the blocked
stack of p=6 (K = 1024, N = 576) and the 316-offset stack of p=8
(r = 80, r2 = 256), from the JAX package's tables through
`operators_from_numpy`."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops.pallas_m2l import m2l_grid as j_m2l_grid
from sctl_tpu.ops.pallas_m2l import m2l_grid_blocked as j_m2l_blocked
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMMOperators, operators_from_numpy
from sctl_tpu_torch.ops.m2l import (m2l_grid_blocked_plain,
                                    m2l_grid_blocked_tf32x3, m2l_grid_plain,
                                    m2l_grid_tf32x3, tf32_split)

limit_cpu_threads()

T = torch.as_tensor


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _stack(p):
    """The float32 route's operator stack at order p from the JAX
    package's tables (rcond 3e-5): p=6 the blocked stack (26, 1024,
    576), p=8 the 316-offset stack (316, 256, 80)."""
    jops = J_Ops(J_LAP, J_LAP, J_LAP, p, 3, 1.0, jnp.float32, rcond=3e-5)
    tables = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    tables.update(p=p, rcond=jops._rcond)
    ops = operators_from_numpy(tables, "cpu", torch.float32)
    ops.device_tables()
    return ops.m2l_blk if p == 6 else ops.m2l_at


def _grid(side, margin, width, seed):
    rng = np.random.default_rng(seed)
    q = np.zeros((side + 2 * margin,) * 3 + (width,), np.float32)
    q[margin:-margin, margin:-margin, margin:-margin] = rng.normal(
        size=(side,) * 3 + (width,))
    return q


def _wide(seed):
    """float32 values over 60 binades, both signs, and exact TF32
    values, ties and near-ties of the rounding among them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=20000) * np.exp2(rng.integers(-30, 30, 20000))
    u = x.astype(np.float32).view(np.uint32)
    u[:1000] &= np.uint32(0xFFFFE000)                        # TF32 exact
    u[1000:2000] = (u[1000:2000] & np.uint32(0xFFFFE000)) | 0x1000  # ties
    u[2000:3000] = (u[2000:3000] & np.uint32(0xFFFFE000)) | 0x0FFF
    return u.view(np.float32)


@pytest.mark.parametrize("src", ["p6 blocked stack", "p8 grid stack",
                                 "wide random"])
def test_tf32_split(src):
    """hi and lo are TF32 (low 13 mantissa bits zero), hi is x rounded
    to nearest (|x - hi| <= 2^-11 |x|, ties away from zero), and
    hi + lo holds x to 2^-22 relative."""
    x = {"p6 blocked stack": lambda: _stack(6).numpy(),
         "p8 grid stack": lambda: _stack(8).numpy(),
         "wide random": lambda: _wide(0)}[src]().ravel()
    hi, lo = (t.numpy() for t in tf32_split(T(x)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    x64, hi64 = x.astype(np.float64), hi.astype(np.float64)
    assert (np.abs(x64 - hi64) <= 2.0 ** -11 * np.abs(x64)).all()
    assert (np.abs(x64 - hi64 - lo) <= 2.0 ** -22 * np.abs(x64)).all()
    if src == "wide random":
        ties = x[1000:2000]
        assert (np.abs(hi[1000:2000]) > np.abs(ties)).all()
        np.testing.assert_array_equal(hi[:1000], x[:1000])
        np.testing.assert_array_equal(lo[:1000], 0)


def test_blocked_emulation_matches_pallas():
    """The blocked kernel's arithmetic against the Pallas kernel in
    full f32, h = 4, on the real p=6 stack (r = 72, r2 = 128)."""
    mats = _stack(6)
    qp = _grid(4, 1, 1024, 1)
    u = m2l_grid_blocked_tf32x3(T(qp), mats).numpy()
    u_j = np.asarray(j_m2l_blocked(jnp.asarray(qp), jnp.asarray(mats.numpy()),
                                   4, 72, 128, interpret=True,
                                   threepass=False))
    assert u.shape == u_j.shape == (4, 4, 4, 576)
    assert rel(u, u_j) < 1e-5


def test_grid_emulation_matches_pallas():
    """`m2l_grid`'s arithmetic against the Pallas kernel in full f32,
    n = 4, on the real p=8 stack (r = 80, r2 = 256)."""
    mats = _stack(8)
    qp = _grid(4, 3, 256, 2)
    u = m2l_grid_tf32x3(T(qp), mats).numpy()
    u_j = np.asarray(j_m2l_grid(jnp.asarray(qp), jnp.asarray(mats.numpy()),
                                4, 80, 256, interpret=True,
                                threepass=False))
    assert u.shape == u_j.shape == (4, 4, 4, 80)
    assert rel(u, u_j) < 1e-5


@pytest.mark.parametrize("kernel", ["blocked", "grid"])
def test_emulation_float64_error(kernel):
    """Against a float64 evaluation of the same inputs the emulation's
    error is at most twice the float32 plain version's: the blocked
    kernel's at h = 4 on the p=6 stack, `m2l_grid`'s at n = 8 on the
    p=8 stack."""
    if kernel == "blocked":
        mats, qp = _stack(6), T(_grid(4, 1, 1024, 3))
        plain, emu = m2l_grid_blocked_plain, m2l_grid_blocked_tf32x3
    else:
        mats, qp = _stack(8), T(_grid(8, 3, 256, 4))
        plain, emu = m2l_grid_plain, m2l_grid_tf32x3
    r64 = plain(qp.double(), mats.double())
    assert rel(emu(qp, mats), r64) <= 2 * rel(plain(qp, mats), r64)
