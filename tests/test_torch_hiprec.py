"""The port's hiprec operator tables against the JAX package's: the
extended-precision product `ld_gemm`, the cold longdouble build at
p = 4, the committed p = 10 lite tables read by both packages, and
BASELINE.md's rung 7 at p = 10 through the port on the CPU.

The JAX package writes its cold table cache under a temporary
directory here, never under data/; the port writes none.  The p = 10
tables are read once (a module fixture, about 13 s a package)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.config import config as j_config
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.fmm.kifmm import _op_cache_path, _vlist_offsets
from sctl_tpu.fmm.kifmm import cube_surface as j_cube_surface
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.quadmath import ld_gemm as j_ld_gemm
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators
from sctl_tpu_torch.fmm.kifmm import table_path, unit_tables
from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
from sctl_tpu_torch.quadmath import ld_gemm

limit_cpu_threads()

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def test_ld_gemm_matches_longdouble_matmul():
    """ld_gemm of longdouble factors, and of a float64 one with a
    longdouble one, against numpy's longdouble product: normwise within
    1e-17, below float64's rounding (1.1e-16) and at numpy's own
    longdouble rounding; and the same bits as the JAX package's."""
    rng = np.random.default_rng(30)
    ld = lambda a: a.astype(np.longdouble) * (1 + np.longdouble(2) ** -60)
    A = ld(rng.normal(size=(40, 96)))
    B = ld(rng.normal(size=(96, 24)) * np.exp(rng.normal(size=(96, 1))))
    for a, b in ((A, B), (np.float64(A), B), (A, np.float64(B))):
        ref = np.matmul(a.astype(np.longdouble), b.astype(np.longdouble))
        out = ld_gemm(a, b)
        assert out.dtype == np.longdouble
        err = np.linalg.norm(np.float64(out - ref)) / np.linalg.norm(
            np.float64(ref))
        assert err < 1e-17, err
        np.testing.assert_array_equal(out, j_ld_gemm(a, b))


def test_cold_hiprec_tables_match_jax(tmp_path, monkeypatch):
    """The cold hiprec build (longdouble pinv refinement, longdouble M2M
    and L2L products, the rcond-linked compression cutoff, ca_unit
    through ld_gemm) at p = 4, rcond 1e-10: the port's tables against
    the JAX package's, built by the same numpy on one host, bit for
    bit."""
    monkeypatch.setattr(j_config, "data_path", str(tmp_path))
    monkeypatch.setenv("SCTL_DATA_PATH", str(tmp_path))
    jops = J_Ops(J_LAP, J_LAP, J_LAP, 4, 3, 1.0, jnp.float64, rcond=1e-10,
                 hiprec=True)
    t = unit_tables(Laplace3D_FxU.name, 4, 1e-10, True)
    for name in KIFMMOperators.TABLES:
        np.testing.assert_array_equal(t[name], getattr(jops, name),
                                      err_msg=name)
    # hiprec changes the tables: the longdouble ca_unit is not float64's
    plain = unit_tables(Laplace3D_FxU.name, 4, 1e-10)
    assert not np.array_equal(plain["ca_unit"], t["ca_unit"])


@pytest.fixture(scope="module")
def p10_tables():
    """The committed p = 10 lite tables (rcond 1e-10) read by the port
    from the repository's data directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCTL_DATA_PATH", DATA)
        lite = table_path(Laplace3D_FxU.name, 10, 1e-10, True)[:-4] \
            + "_lite.npz"
        assert os.path.exists(lite), lite
        yield unit_tables(Laplace3D_FxU.name, 10, 1e-10, True)


def test_lite_tables_match_jax_bit_for_bit(p10_tables, monkeypatch):
    """The p = 10 lite file read by the port and by the JAX package's
    `_load_cache_lite`: every table, cc_unit and ca_unit rebuilt in
    float64 with the stored longdouble delta, equal bit for bit."""
    monkeypatch.setattr(j_config, "data_path", DATA)
    jops = J_Ops.__new__(J_Ops)
    jops.offsets, jops.parity_valid = _vlist_offsets()
    assert jops._load_cache_lite(_op_cache_path(J_LAP, 10, 1e-10, True),
                                 J_LAP, j_cube_surface(10))
    for name in KIFMMOperators.TABLES:
        np.testing.assert_array_equal(p10_tables[name], getattr(jops, name),
                                      err_msg=name)


def test_rung7_p10_cpu(p10_tables):
    """BASELINE.md rung 7 through the port on the CPU: KIFMM(p=10,
    depth 3, float64, rcond 1e-10, hiprec) on the ladder's 2,000 points
    (default_rng(12)) against the float64 direct sum; bar 3e-8
    (tests/test_accuracy_ladder.py:127-146; measured 8.6e-9 by the JAX
    package)."""
    rng = np.random.default_rng(12)
    x = rng.random((2000, 3))
    f = rng.normal(size=(2000, 1))
    ops = KIFMMOperators(Laplace3D_FxU, 10, 1e-10, "cpu", torch.float64,
                         tables=p10_tables)
    kf = KIFMM(Laplace3D_FxU, p=10, depth=3, device="cpu",
               dtype=torch.float64, rcond=1e-10, hiprec=True,
               operators=ops).setup(x, x)
    assert kf._ops.m2l_route == "parity" and kf._ops.blk_r == 488
    X = torch.as_tensor(x)
    u_d = direct_eval_blocked(Laplace3D_FxU, X, X,
                              torch.as_tensor(f)).numpy()
    err = np.abs(kf.eval(f) - u_d).max() / np.abs(u_d).max()
    assert err < 3e-8, err
