"""The port's longdouble host KIFMM against the JAX package's: KIFMMLd at
p = 8, depth 2, on the points of tests/test_accuracy_ladder.py:76-96
(seed 7, 900 points), for the single and the double layer: within 1e-13
of the JAX evaluator's maximum on the same pseudo-inverse tables, and
under the JAX bar of 1e-6 against a longdouble dense sum.  The tables
are read from the data directory where the JAX package has written them
(the lam0.249693542 file of this tree); the port writes nothing there."""

import os

import numpy as np
import pytest

from sctl_tpu.config import config as j_config
from sctl_tpu.fmm.kifmm_ld import KIFMMLd as J_KIFMMLd
from sctl_tpu.ops import Laplace3D_DxU as J_DXU
from sctl_tpu.ops import Laplace3D_FxU as J_FXU
from sctl_tpu_torch.config import data_path, limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMMLd
from sctl_tpu_torch.fmm import kifmm_ld
from sctl_tpu_torch.ops import Laplace3D_DxU, Laplace3D_FxU

limit_cpu_threads()

P, DEPTH, RCOND = 8, 2, 1e-11


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.random((900, 3))
    f = rng.normal(size=(900, 1))
    ns = rng.normal(size=(900, 3))
    return x, f, ns / np.linalg.norm(ns, axis=1, keepdims=True)


@pytest.fixture
def jax_tables(tmp_path, monkeypatch):
    """The JAX evaluator reads the data directory's table where it
    exists; where it does not, it builds and writes the table under a
    temporary directory, not under data/."""
    name = kifmm_ld.table_name("Laplace3D-FxU", P, RCOND, 0.249693542)
    monkeypatch.setattr(j_config, "data_path", data_path() if os.path.exists(
        os.path.join(data_path(), name)) else str(tmp_path))
    return name


@pytest.mark.parametrize("kind", ["FxU", "DxU"])
def test_kifmm_ld_matches_jax(kind, jax_tables):
    x, f, ns = _inputs()
    ker, jker = ((Laplace3D_FxU, J_FXU) if kind == "FxU"
                 else (Laplace3D_DxU, J_DXU))
    n_src = ns if kind == "DxU" else None
    before = set(os.listdir(data_path())) if os.path.isdir(
        data_path()) else set()
    kp = KIFMMLd(ker, p=P, depth=DEPTH, rcond=RCOND).setup(x, x, n_src=n_src)
    kj = J_KIFMMLd(jker, p=P, depth=DEPTH, rcond=RCOND).setup(x, x,
                                                             n_src=n_src)
    assert kifmm_ld.table_name(ker.name if kind == "FxU" else "Laplace3D-FxU",
                               P, RCOND, kp.scale / 4) == jax_tables
    if os.path.exists(os.path.join(data_path(), jax_tables)):
        assert kp.table_source == {2: "data"}
    for t in ("uc2e", "dc2e"):
        np.testing.assert_array_equal(getattr(kp, t)[2], getattr(kj, t)[2])
    u, uj = kp.eval(f), kj.eval(f)
    assert np.abs(u - uj).max() <= 1e-13 * np.abs(uj).max()
    K = kifmm_ld._kmat_ld(ker, x, x, n_src)
    ud = np.float64((K @ f.astype(np.longdouble).ravel()).reshape(-1, 1))
    assert np.abs(u - ud).max() / np.abs(ud).max() < 1e-6
    after = set(os.listdir(data_path())) if os.path.isdir(
        data_path()) else set()
    assert after == before


def test_kifmm_ld_cold_tables_cached_outside_data(tmp_path, monkeypatch):
    """Without a data-directory table the pseudo-inverses are built in
    longdouble and cached under the build directory, and a second setup
    reads the cache: p = 4 on the seed-7 points, against the JAX
    package's cold build (written under a temporary directory)."""
    monkeypatch.setenv("SCTL_DATA_PATH", str(tmp_path / "none"))
    monkeypatch.setattr(kifmm_ld, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(j_config, "data_path", str(tmp_path / "jax"))
    x, f, _ = _inputs()
    kp = KIFMMLd(Laplace3D_FxU, p=4, depth=2).setup(x, x)
    assert kp.table_source == {2: "built"}
    assert os.listdir(tmp_path / "cache") == [
        kifmm_ld.table_name("Laplace3D-FxU", 4, RCOND, kp.scale / 4)]
    k2 = KIFMMLd(Laplace3D_FxU, p=4, depth=2).setup(x, x)
    assert k2.table_source == {2: "cache"}
    kj = J_KIFMMLd(J_FXU, p=4, depth=2).setup(x, x)
    u, uj = k2.eval(f), kj.eval(f)
    assert np.abs(u - uj).max() <= 1e-13 * np.abs(uj).max()
    assert not os.path.exists(tmp_path / "none")
