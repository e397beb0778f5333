"""The port's containers against the JAX package's: the array files of
both layouts byte-identical across the packages and each read by the
other, Matrix's SVD and pseudo-inverse (1e-12), Vector, Permutation and
Tensor on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctl_tpu
from sctl_tpu import containers as jc
from sctl_tpu_torch import (Matrix, Permutation, Tensor, Vector, read_array,
                            write_array)
from sctl_tpu_torch import containers as pc
from sctl_tpu_torch.config import limit_cpu_threads

limit_cpu_threads()


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) * 100
    if dtype == "bool":
        return a > 0
    if dtype.startswith("complex"):
        return (a + 1j * rng.normal(size=shape)).astype(dtype)
    if dtype.startswith("uint"):
        return np.abs(a).astype(dtype)
    return a.astype(dtype)


DTYPES = ["float32", "float64", "int32", "int64", "uint32", "uint64",
          "complex64", "complex128", "int8", "uint8", "bool", "float16"]


@pytest.mark.parametrize("dtype,shape", [(d, (3, 5)) for d in DTYPES]
                         + [("float64", (2, 3, 4)), ("float32", (0, 4)),
                            ("int64", ())])
def test_write_array_bytes_match_jax(tmp_path, dtype, shape):
    """Files of either package are byte-identical and read back by the
    other."""
    a = _array(dtype, shape, 4)
    pj, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jc.write_array(pj, a)
    write_array(pp, torch.as_tensor(a))
    assert open(pj, "rb").read() == open(pp, "rb").read()
    np.testing.assert_array_equal(read_array(pj, device="cpu").numpy(), a)
    np.testing.assert_array_equal(jc.read_array(pp), a)


def test_write_array_bfloat16_and_conversion(tmp_path):
    """bfloat16 (code 8) both ways; a cross-dtype write and read as the
    JAX package converts."""
    a = _array("float32", (4, 6), 5)
    pj, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jc.write_array(pj, jnp.asarray(a, jnp.bfloat16))
    write_array(pp, torch.as_tensor(a).to(torch.bfloat16))
    assert open(pj, "rb").read() == open(pp, "rb").read()
    np.testing.assert_array_equal(
        read_array(pj, dtype=np.float32, device="cpu").numpy(),
        jc.read_array(pp, dtype=np.float32))
    jc.write_array(pj, a, dtype=np.float16)
    write_array(pp, a, dtype=np.float16)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    np.testing.assert_array_equal(
        read_array(pp, dtype=torch.float64, device="cpu").numpy(),
        jc.read_array(pj, dtype=np.float64))


@pytest.mark.parametrize("shape", [(7,), (5, 3)])
def test_write_array_sctl_bytes_match_jax(tmp_path, shape):
    """The reference's (dim0, dim1) layout, Vector and Matrix forms."""
    a = _array("float64", shape, 6)
    pj, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jc.write_array_sctl(pj, a, dtype=np.float32)
    pc.write_array_sctl(pp, torch.as_tensor(a), dtype=torch.float32)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    np.testing.assert_array_equal(
        pc.read_array_sctl(pj, np.float32, device="cpu").numpy(),
        jc.read_array_sctl(pp, np.float32))
    with pytest.raises(ValueError):
        pc.write_array_sctl(pp, np.zeros((2, 2, 2)))


def test_matrix_svd_pinv_match_jax():
    """SVD reconstructs, and pinv of a rank-deficient matrix (the eps
    cut) equals the JAX package's to 1e-12 of its maximum."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(12, 8))
    a[:, 7] = a[:, 0] + a[:, 1]                 # rank 7
    m = Matrix(torch.as_tensor(a))
    u, s, vt = m.svd()
    np.testing.assert_allclose(((u.data * s.data) @ vt.data).numpy(), a,
                               atol=1e-12)
    pj = np.asarray(sctl_tpu.Matrix(jnp.asarray(a)).pinv().data)
    pp = m.pinv().data.numpy()
    assert np.abs(pp - pj).max() <= 1e-12 * np.abs(pj).max()
    b = rng.normal(size=(12, 8))
    pj = np.asarray(sctl_tpu.Matrix(jnp.asarray(b)).pinv().data)
    pp = Matrix(b, device="cpu").pinv().data.numpy()
    assert np.abs(pp - pj).max() <= 1e-12 * np.abs(pj).max()
    c = Matrix(torch.as_tensor(a)) @ Matrix(torch.as_tensor(b.T))
    np.testing.assert_allclose(c.data.numpy(), a @ b.T, atol=1e-12)
    np.testing.assert_array_equal((-m.transpose()).data.numpy(), -a.T)


def test_vector_and_tensor_match_jax(tmp_path):
    x = np.random.default_rng(7).normal(size=9)
    vj, vp = sctl_tpu.Vector(jnp.asarray(x)), Vector(torch.as_tensor(x))
    for f in (lambda v: v * 2.0 + 1.0, lambda v: 3.0 - v / 2.0,
              lambda v: v.push_back(9.0), lambda v: v.set(2, -1.0),
              lambda v: -(v + v)):
        np.testing.assert_array_equal(f(vp).data.numpy(),
                                      np.asarray(f(vj).data))
    assert float(vp.norm2()) == float(vj.norm2())
    vp.write(str(tmp_path / "v.bin"), dtype=np.float32)
    vj.write(str(tmp_path / "w.bin"), dtype=np.float32)
    assert (open(tmp_path / "v.bin", "rb").read()
            == open(tmp_path / "w.bin", "rb").read())
    np.testing.assert_array_equal(
        Vector.read(str(tmp_path / "w.bin"), device="cpu").data.numpy(),
        np.asarray(sctl_tpu.Vector.read(str(tmp_path / "v.bin")).data))
    a = np.arange(24.0)
    tj, tp = sctl_tpu.Tensor(a, shape=(2, 3, 4)), Tensor(a, (2, 3, 4),
                                                          device="cpu")
    assert (tp.order, tp.size, tp.dim(1)) == (tj.order, tj.size, tj.dim(1))
    for f in (lambda t: t.rotate_left(), lambda t: t.rotate_right(),
              lambda t: t @ Tensor(np.ones((4, 2)), device="cpu")
              if isinstance(t, Tensor) else t @ sctl_tpu.Tensor(
                  np.ones((4, 2)))):
        np.testing.assert_array_equal(f(tp).data.numpy(),
                                      np.asarray(f(tj).data))


def test_permutation_matches_jax():
    """Permutation algebra on the same indices and scaling: get_matrix,
    transpose, composition, row and column application; rand_perm draws
    from a torch.Generator."""
    rng = np.random.default_rng(3)
    perm, scal = rng.permutation(6), rng.random(6)
    a = rng.normal(size=(6, 6))
    pj = sctl_tpu.Permutation(jnp.asarray(perm), jnp.asarray(scal))
    pp = Permutation(torch.as_tensor(perm), torch.as_tensor(scal))
    mj, mp = sctl_tpu.Matrix(jnp.asarray(a)), Matrix(torch.as_tensor(a))
    np.testing.assert_array_equal(pp.get_matrix().data.numpy(),
                                  np.asarray(pj.get_matrix().data))
    np.testing.assert_array_equal(pp.transpose().get_matrix().data.numpy(),
                                  np.asarray(pj.transpose().get_matrix().data))
    np.testing.assert_array_equal((pp @ pp.transpose()).scal.numpy(),
                                  np.asarray((pj @ pj.transpose()).scal))
    np.testing.assert_array_equal(mp.row_perm(pp).data.numpy(),
                                  np.asarray(mj.row_perm(pj).data))
    np.testing.assert_array_equal(mp.col_perm(pp).data.numpy(),
                                  np.asarray(mj.col_perm(pj).data))
    np.testing.assert_array_equal((pp @ mp).data.numpy(),
                                  np.asarray((pj @ mj).data))
    g = torch.Generator().manual_seed(0)
    r1 = Permutation.rand_perm(6, g, device="cpu")
    r2 = Permutation.rand_perm(6, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(r1.perm, r2.perm) and torch.equal(r1.scal, r2.scal)
    assert sorted(r1.perm.tolist()) == list(range(6))


def test_device_rule():
    """A wrapper of a tensor keeps its device; other data goes to the
    card unless device= says otherwise."""
    assert Vector(torch.ones(3)).data.device.type == "cpu"
    assert Matrix.zeros(2, 2, device="cpu").data.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Vector([1.0, 2.0])
