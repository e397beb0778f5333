"""The port's spherical harmonics (scalar and vector transforms, the
Stokes potentials on the sphere, the coefficient layouts, the VTK
writer) against the JAX package's on the same inputs (numpy
default_rng), at p <= 16 and one scalar round trip at p = 64, in
float64 on the CPU.  Bars: 1e-12 of the maximum (the two packages sum
in their own orders; the port also weights the Fourier data rather
than the Legendre table), `stokes_eval_kl` 1e-11 (it differentiates
through the per-target synthesis); the Legendre tables bit for bit (the
same numpy recurrence).  The JAX package is called at p < 128 only: at
p >= 128 it caches its tables under data/."""

import os
import base64
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.linalg import sph_harm as J
from sctl_tpu.tree import vtu as j_vtu
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import sph_harm as T
from sctl_tpu_torch.linalg import (SHCArrange, SphericalHarmonics, sh_dim,
                                   shc_arrange, shc_rearrange,
                                   stokes_eval_dl, stokes_eval_kl,
                                   stokes_eval_kself, stokes_eval_sl)
from sctl_tpu_torch.tree import vtu

limit_cpu_threads()

BAR, KL_BAR = 1e-12, 1e-11
STOKES = ["stokes_eval_sl", "stokes_eval_dl", "stokes_eval_kself",
          "stokes_pressure_sl"]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(p, nt=None, np_=None):
    return (SphericalHarmonics(p, nt, np_, device="cpu"),
            J.SphericalHarmonics(p, nt, np_))


def _vec_shc(rng, p, batch=()):
    S = rng.normal(size=batch + (3, sh_dim(p)))
    S[..., 1, 0] = S[..., 2, 0] = 0.0          # W_00 = X_00 = 0
    return S


@pytest.mark.parametrize("p,nt", [(4, 6), (16, 18), (40, 45), (100, 102)])
def test_legendre_tables_bit_for_bit(p, nt):
    for a, b in zip(T._legendre_tables(p, nt), J._legendre_tables(p, nt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p,ct", [(8, 25), (16, 7)])
def test_legendre_trio_bit_for_bit(p, ct):
    th = np.linspace(0.0, np.pi, ct)
    P, dP, Q = T._legendre_trio(p, torch.as_tensor(np.cos(th)),
                                torch.as_tensor(np.sin(th)))
    jP, jdP, jQ = J._legendre_trio(p, np.cos(th), np.sin(th), np)
    for m in range(p + 2):
        for l in range(p + 2):
            if l < m:
                assert not (P[:, m, l].any() or dP[:, m, l].any()
                            or Q[:, m, l].any())
                continue
            np.testing.assert_array_equal(P[:, m, l].numpy(), jP[m][l])
            np.testing.assert_array_equal(dP[:, m, l].numpy(), jdP[m][l])
            if m >= 1:
                np.testing.assert_array_equal(Q[:, m, l].numpy(), jQ[m][l])


# one grid per degree for the scalar and vector tests, so that the JAX
# side compiles each of its operations once for both
GRIDS = [(5, None), (16, (19, 34))]


@pytest.mark.parametrize("p,grid", GRIDS)
def test_scalar_transforms(p, grid):
    sh, jsh = _pair(p, *(grid or (None, None)))
    rng = np.random.default_rng(p)
    shc = rng.normal(size=(2, sh_dim(p)))
    f = rng.normal(size=(2, sh.nt, sh.np_))
    assert rel(sh.shc2grid(shc), jsh.shc2grid(shc)) < BAR
    assert rel(sh.grid2shc(f), jsh.grid2shc(f)) < BAR
    assert rel(sh.shc2grid(shc[0]), jsh.shc2grid(shc[0])) < BAR
    for a, b in zip(sh.shc2grid_grad(shc), jsh.shc2grid_grad(shc)):
        assert rel(a, b) < BAR
    if p < 16:      # the JAX transpose compiles anew for every shape
        assert rel(sh.shc2grid_transpose(f), jsh.shc2grid_transpose(f)) \
            < BAR
    assert rel(sh.shc2pole(shc), jsh.shc2pole(shc)) < BAR
    th, ph = rng.random(9) * np.pi, rng.random(9) * 2 * np.pi
    assert rel(sh.eval(shc[1], th, ph), jsh.eval(shc[1], th, ph)) < BAR


def test_scalar_roundtrip_p64():
    sh, jsh = _pair(64)
    shc = np.random.default_rng(64).normal(size=(3, sh_dim(64)))
    g = sh.shc2grid(shc)
    assert rel(g, jsh.shc2grid(shc)) < BAR
    back = sh.grid2shc(g)
    assert rel(back, jsh.grid2shc(np.asarray(g))) < BAR
    assert float((back - torch.as_tensor(shc)).abs().max()) < 1e-11


@pytest.mark.parametrize("p,grid", [(6, None), (16, (19, 34)),
                                    (7, (9, 15))])
def test_shc2grid_transpose_is_the_adjoint(p, grid):
    """<shc2grid(s), X> = <s, shc2grid_transpose(X)>, also on odd grids
    (np_ odd: no Nyquist order)."""
    sh = SphericalHarmonics(p, *(grid or (None, None)), device="cpu")
    rng = np.random.default_rng(5)
    s = torch.as_tensor(rng.normal(size=(2, sh_dim(p))))
    X = torch.as_tensor(rng.normal(size=(2, sh.nt, sh.np_)))
    lhs = float((sh.shc2grid(s) * X).sum())
    rhs = float((s * sh.shc2grid_transpose(X)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("p,grid", GRIDS)
def test_vector_transforms(p, grid):
    sh, jsh = _pair(p, *(grid or (None, None)))
    rng = np.random.default_rng(100 + p)
    S = _vec_shc(rng, p, (2,))
    F = rng.normal(size=(2, 3, sh.nt, sh.np_))
    assert rel(sh.vecshc2grid(S), jsh.vecshc2grid(jnp.asarray(S))) < BAR
    assert rel(sh.grid2vecshc(F), jsh.grid2vecshc(jnp.asarray(F))) < BAR
    back = sh.grid2vecshc(sh.vecshc2grid(S[0]))
    assert float((back - torch.as_tensor(S[0])).abs().max()) < 1e-11
    th, ph = rng.random(11) * np.pi, rng.random(11) * 2 * np.pi
    assert rel(sh.vecshc_eval(S, th, ph),
               jsh.vecshc_eval(jnp.asarray(S), th, ph)) < BAR


def _targets(rng, n, R):
    d = rng.normal(size=(n, 3))
    return R * d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("name", STOKES)
@pytest.mark.parametrize("p", [4, 16])
@pytest.mark.parametrize("R", [0.55, 1.7])
def test_stokes_potentials(name, p, R):
    rng = np.random.default_rng(p)
    S = _vec_shc(rng, p, (2,))
    trg = _targets(rng, 7, R)
    got = getattr(T, name)(S, p, trg, R < 1, device="cpu")
    want = getattr(J, name)(jnp.asarray(S), p, jnp.asarray(trg), R < 1)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert rel(got, want) < BAR


@pytest.mark.parametrize("p,R", [(4, 0.55), (4, 1.7)])
def test_stokes_eval_kl(p, R):
    rng = np.random.default_rng(200 + p)
    S = _vec_shc(rng, p)
    trg, nor = _targets(rng, 6, R), _targets(rng, 6, 1.0)
    got = stokes_eval_kl(S, p, trg, nor, R < 1, device="cpu")
    want = J.stokes_eval_kl(jnp.asarray(S), p, jnp.asarray(trg),
                            jnp.asarray(nor), R < 1)
    assert rel(got, want) < KL_BAR
    # KSelf is KL with the radial normal
    ks = stokes_eval_kself(S, p, trg, R < 1, device="cpu")
    kr = stokes_eval_kl(S, p, trg, trg / R, R < 1, device="cpu")
    assert rel(kr, ks) < KL_BAR


def test_stokes_quadrature_oracle_matches_jax_oracle():
    """chip_smoke.py's Stokes oracle (direct sums through
    direct_eval_blocked) against the formulas of the JAX test's
    _StokesOracle (tests/test_sph_harm.py:168-228) on the same grid at
    p = 5: the same conventions and scale (1e-12)."""
    import chip_smoke
    from test_sph_harm import _StokesOracle
    p = 5
    rng = np.random.default_rng(5)
    S = _vec_shc(rng, p)
    oracle = _StokesOracle(p, S, 2 * p + 2, 4 * p + 4)
    for R in (0.55, 1.7):
        trg = _targets(rng, 4, R)
        sl, dl = chip_smoke.stokes_quadrature(torch, S, p, trg, "cpu")
        assert rel(sl, np.stack([oracle.sl(t) for t in trg])) < BAR
        assert rel(dl, np.stack([oracle.dl(t) for t in trg])) < BAR


def test_stokes_against_the_oracle_p16():
    """At p = 16 the (2p+2) x (4p+4) grid resolves the kernels on both
    spheres: SL and DL within the JAX test's bars (2e-5 and 50 x that,
    :253-258) of the direct sums."""
    import chip_smoke
    p = 16
    rng = np.random.default_rng(16)
    S = _vec_shc(rng, p)
    for R in (0.55, 1.7):
        trg = _targets(rng, 20, R)
        sl, dl = chip_smoke.stokes_quadrature(torch, S, p, trg, "cpu")
        assert rel(stokes_eval_sl(S, p, trg, R < 1, device="cpu"), sl) \
            < 2e-5
        assert rel(stokes_eval_dl(S, p, trg, R < 1, device="cpu"), dl) \
            < 1e-3


def test_rotated_shc_is_the_rotation():
    """chip_smoke.py's exact answer of 9c: the coefficients of
    u(theta, phi - a) against a synthesis on a shifted grid."""
    import chip_smoke
    p, a = 6, 0.37
    sh = SphericalHarmonics(p, device="cpu")
    shc = np.random.default_rng(1).normal(size=(2, sh_dim(p)))
    th = np.repeat(sh.theta, 4)
    ph = np.tile(np.array([0.1, 1.0, 2.5, 4.0]), sh.nt)
    got = np.stack([sh.eval(c, th, ph).numpy()
                    for c in chip_smoke.rotated_shc(shc, p, a)])
    want = np.stack([sh.eval(c, th, ph - a).numpy() for c in shc])
    assert rel(got, want) < BAR


@pytest.mark.parametrize("arrange", [SHCArrange.ALL, SHCArrange.ROW_MAJOR,
                                     SHCArrange.COL_MAJOR_NONZERO])
def test_shc_arrange_layouts(arrange):
    p = 7
    shc = np.random.default_rng(0).normal(size=(2, sh_dim(p)))
    lay = shc_arrange(torch.as_tensor(shc), p, arrange)
    want = np.asarray(J.shc_arrange(jnp.asarray(shc), p, arrange))
    np.testing.assert_array_equal(lay.numpy(), want)
    np.testing.assert_array_equal(shc_arrange(shc, p, arrange), want)
    np.testing.assert_array_equal(shc_rearrange(lay, p, arrange).numpy(),
                                  shc)
    np.testing.assert_array_equal(shc_rearrange(want, p, arrange), shc)
    with pytest.raises(ValueError):
        shc_rearrange(want[..., 1:], p, arrange)


def _vtu_parts(path):
    """(the XML lines with the data lines blanked, the decoded arrays)
    of a .vtu file."""
    lines = open(path).read().split("\n")
    xml, arrays = [], []
    for ln in lines:
        if ln.startswith("<") or not ln:
            xml.append(ln)
            continue
        raw = base64.b64decode(ln)
        n = struct.unpack("<I", raw[:4])[0]
        arrays.append(raw[4:4 + n])
        xml.append("DATA")
    return xml, arrays


def _same_vtu(path, jpath, dtypes):
    xml, arrs = _vtu_parts(path)
    jxml, jarrs = _vtu_parts(jpath)
    assert xml == jxml
    assert len(arrs) == len(jarrs) == len(dtypes)
    for a, b, dt in zip(arrs, jarrs, dtypes):
        a, b = np.frombuffer(a, dt), np.frombuffer(b, dt)
        assert a.shape == b.shape
        if dt == np.float32:
            assert np.abs(a.astype(np.float64) - b).max() \
                <= 1e-12 * max(np.abs(b).max(), 1e-300)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("warped", [False, True])
def test_write_vtk(tmp_path, warped):
    p = 4
    sh, jsh = _pair(p)
    kw = {}
    if warped:
        th = sh.theta
        ph = 2 * np.pi * np.arange(sh.np_) / sh.np_
        X = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                      np.sin(th)[:, None] * np.sin(ph)[None],
                      np.cos(th)[:, None] * np.ones((1, sh.np_))])
        kw = dict(coord_shc=np.asarray(jsh.grid2shc(X)) * 1.5,
                  value_shc=np.random.default_rng(4).normal(
                      size=(2, sh_dim(p))))
    data = sh.write_vtk(str(tmp_path / "port"), **kw)
    jsh.write_vtk(str(tmp_path / "jax"), **kw)
    assert isinstance(data, vtu.VTUData)
    dts = [np.float32] + [np.float32] * warped + [np.int32, np.int32,
                                                  np.uint8]
    _same_vtu(tmp_path / "port.vtu", tmp_path / "jax.vtu", dts)


def test_write_vtk_p_out(tmp_path):
    """p_out != p: the coefficients truncated or zero-padded to degree
    p_out, which the JAX package's resampling cannot do (it fails on a
    grid mismatch): a sphere of radius 1.5 written at p = 6 from p = 4
    and at p = 2 from p = 4 lies on that sphere; the value field at
    p_out = 6 is the same function as at p = 4."""
    sh = SphericalHarmonics(4, device="cpu")
    th = sh.theta
    ph = 2 * np.pi * np.arange(sh.np_) / sh.np_
    X = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                  np.sin(th)[:, None] * np.sin(ph)[None],
                  np.cos(th)[:, None] * np.ones((1, sh.np_))])
    cs = 1.5 * sh.grid2shc(X)
    val = torch.as_tensor(np.random.default_rng(4).normal(
        size=(1, sh_dim(4))))
    for po in (6, 2):
        d = sh.write_vtk(str(tmp_path / f"p{po}"), coord_shc=cs,
                         value_shc=val if po > 4 else None, p_out=po)
        np.testing.assert_allclose(np.linalg.norm(d.coord, axis=1), 1.5,
                                   rtol=1e-6)
    sh6 = SphericalHarmonics(6, device="cpu")
    th6 = np.repeat(sh6.theta, sh6.np_)
    ph6 = np.tile(2 * np.pi * np.arange(sh6.np_) / sh6.np_, sh6.nt)
    want = sh.eval(val[0], th6, ph6).numpy()
    np.testing.assert_allclose(d_val(tmp_path / "p6.vtu"), want,
                               rtol=0, atol=1e-6 * np.abs(want).max())


def d_val(path):
    """The float32 "value" array of a .vtu file written by write_vtk."""
    _, arrs = _vtu_parts(path)
    return np.frombuffer(arrs[1], np.float32)


def test_vtu_particles_boxes_and_pvtu(tmp_path):
    rng = np.random.default_rng(3)
    X, val = rng.random((20, 3)), rng.normal(size=20)
    vtu.write_particle_vtk(str(tmp_path / "pp"), X, val)
    j_vtu.write_particle_vtk(str(tmp_path / "jp"), X, val)
    _same_vtu(tmp_path / "pp.vtu", tmp_path / "jp.vtu",
              [np.float32, np.float32, np.int32, np.int32, np.uint8])
    for mod, tag in ((vtu, "p"), (j_vtu, "j")):
        d = mod.VTUData()
        d.add_points(X[:5], value=val[:5])
        d.add_boxes(X[5:8], X[5:8] + 0.1, level=np.arange(3.0))
        d.write_vtu(str(tmp_path / f"{tag}b"))
        mod.VTUData.write_pvtu(str(tmp_path / f"{tag}m"), 3,
                               point_fields=[("value", 1)],
                               cell_fields=[("level", 1)])
    _same_vtu(tmp_path / "pb.vtu", tmp_path / "jb.vtu",
              [np.float32, np.float32, np.float32, np.int32, np.int32,
               np.uint8])
    assert (open(tmp_path / "pm.pvtu").read().replace("pm_", "jm_")
            == open(tmp_path / "jm.pvtu").read())


def test_write_tree_vtk(tmp_path):
    """The port's PtTree's leaves as hexahedra; the JAX writer reads the
    same leaf arrays."""
    from types import SimpleNamespace
    from sctl_tpu_torch.tree import PtTree
    X = np.random.default_rng(2).random((3000, 3))
    tree = PtTree.refined(X, np.zeros(3), 1.0, max_pts=60)
    vtu.write_tree_vtk(str(tmp_path / "pt"), tree)
    j_vtu.write_tree_vtk(str(tmp_path / "jt"), SimpleNamespace(
        dim=3, leaf_keys=tree.leaf_keys, leaf_levels=tree.leaf_levels,
        scale=tree.scale, offset=tree.offset))
    _same_vtu(tmp_path / "pt.vtu", tmp_path / "jt.vtu",
              [np.float32, np.float32, np.int32, np.int32, np.uint8])


def test_p128_writes_nothing_under_the_data_path(tmp_path, monkeypatch):
    """At p >= 128 the JAX package caches its Legendre tables under
    SCTL_DATA_PATH; the port builds them in the process and writes
    nothing there."""
    monkeypatch.setenv("SCTL_DATA_PATH", str(tmp_path))
    T._legendre_tables.cache_clear()
    sh = SphericalHarmonics(128, device="cpu")
    shc = torch.as_tensor(np.random.default_rng(7).normal(
        size=sh_dim(128)))
    assert float((sh.grid2shc(sh.shc2grid(shc)) - shc).abs().max()) \
        < 1e-10
    sh._build_dpq()
    T._legendre_tables.cache_clear()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("entry", ["SphericalHarmonics", "stokes"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "SphericalHarmonics":
            SphericalHarmonics(4)
        else:
            stokes_eval_sl(np.zeros((3, 4)), 1, np.ones((2, 3)), False)
