"""The port's double-double arithmetic (`sctl_tpu_torch.quadmath`) and
`mathutils` against the JAX package's on the same inputs, bit for bit:
both are the same numpy operations in the same order, so `hi` and `lo`
must be equal (assert_array_equal), not close."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sctl_tpu import mathutils as j_mu
from sctl_tpu import quadmath as jq
from sctl_tpu_torch import mathutils as mu
from sctl_tpu_torch import quadmath as qm
from sctl_tpu_torch.config import limit_cpu_threads

limit_cpu_threads()


def _same(a, b):
    np.testing.assert_array_equal(a.hi, b.hi)
    np.testing.assert_array_equal(a.lo, b.lo)


def _pair(seed, shape=(7,)):
    """The same DD operands for both packages: random hi, lo a fraction
    of an ulp of hi."""
    rng = np.random.default_rng(seed)
    hi = rng.normal(size=shape) * np.exp(rng.normal(size=shape))
    lo = hi * 1e-17 * rng.normal(size=shape)
    return (qm.DD(hi, lo), jq.DD(hi, lo))


BINARY = ["dd_add", "dd_mul", "dd_div"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_ops_bit_for_bit(name):
    (a, ja), (b, jb) = _pair(1), _pair(2)
    _same(getattr(qm, name)(a, b), getattr(jq, name)(ja, jb))


@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_operators_bit_for_bit(op):
    (a, ja), (b, jb) = _pair(3), _pair(4)
    f = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
         "*": lambda x, y: x * y, "/": lambda x, y: x / y}[op]
    _same(f(a, b), f(ja, jb))
    _same(f(a, 0.3), f(ja, 0.3))
    _same(f(1.7, a), f(1.7, ja))


@pytest.mark.parametrize("name", ["dd_neg", "dd_abs", "dd_sqrt", "dd_cos",
                                  "dd_sin"])
def test_unary_ops_bit_for_bit(name):
    a, ja = _pair(5)
    if name == "dd_sqrt":
        a, ja = qm.dd_abs(a), jq.dd_abs(ja)
    _same(getattr(qm, name)(a), getattr(jq, name)(ja))


@pytest.mark.parametrize("n", [-3, 0, 1, 10])
def test_powi_bit_for_bit(n):
    a, ja = _pair(6)
    _same(qm.dd_powi(a, n), jq.dd_powi(ja, n))
    _same(a ** n, ja ** n)


def test_error_free_transforms_bit_for_bit():
    rng = np.random.default_rng(7)
    x, y = rng.normal(size=(2, 50)) * 1e3
    for name in ("_two_sum", "_quick_two_sum", "_two_prod"):
        for u, v in zip(getattr(qm, name)(x, y), getattr(jq, name)(x, y)):
            np.testing.assert_array_equal(u, v)
    for u, v in zip(qm._split(x), jq._split(x)):
        np.testing.assert_array_equal(u, v)


def test_constants_and_parse():
    for name in ("dd_pi", "dd_2pi", "dd_e"):
        _same(getattr(qm, name)(), getattr(jq, name)())
    _same(qm.dd_from_string("0.1"), jq.dd_from_string("0.1"))
    _same(qm.to_dd(2.5), jq.to_dd(2.5))


def test_comparisons_and_indexing():
    (a, ja), (b, jb) = _pair(8), _pair(9)
    for f in (lambda x, y: x < y, lambda x, y: x <= y,
              lambda x, y: x > y, lambda x, y: x >= y,
              lambda x, y: x == y, lambda x, y: x != y):
        np.testing.assert_array_equal(f(a, b), f(ja, jb))
    _same(a[2:5], ja[2:5])
    a[1], ja[1] = b[3], jb[3]
    _same(a, ja)
    assert len(a) == len(ja) and a.shape == ja.shape
    np.testing.assert_array_equal(a.to_float64(), ja.to_float64())
    _same(qm.DD.zeros((2, 3)), jq.DD.zeros((2, 3)))


def test_sincos_reduction_bit_for_bit():
    k = np.arange(-9, 40, dtype=np.float64) * 0.37
    s, c = qm._dd_sincos(qm.DD(k))
    js, jc = jq._dd_sincos(jq.DD(k))
    _same(s, js)
    _same(c, jc)


def test_matmul_and_solve_bit_for_bit():
    rng = np.random.default_rng(10)
    A, x = rng.normal(size=(6, 6)), rng.normal(size=(6, 2))
    b = qm.dd_matmul(qm.DD(A), qm.DD(x))
    _same(b, jq.dd_matmul(jq.DD(A), jq.DD(x)))
    sol = qm.dd_solve(qm.DD(A), b)
    _same(sol, jq.dd_solve(jq.DD(A), jq.DD(b.hi, b.lo)))
    assert np.abs((sol - qm.DD(x)).to_float64()).max() < 1e-25


def test_ld_gemm_bit_for_bit():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(9, 12)).astype(np.longdouble) / 3
    B = rng.normal(size=(12, 5))
    np.testing.assert_array_equal(qm.ld_gemm(A, B), jq.ld_gemm(A, B))


@pytest.mark.parametrize("dt", ["float64", "float32", "DD"])
def test_mathutils(dt):
    t, j = ((qm.DD, jq.DD) if dt == "DD" else
            (getattr(torch, dt), getattr(jnp, dt)))
    assert mu.significant_bits(t) == j_mu.significant_bits(j)
    assert mu.machine_eps(t) == j_mu.machine_eps(j)
    assert mu.digits(t) == j_mu.digits(j)
    for name in ("const_pi", "const_e"):
        got, want = getattr(mu, name)(t), getattr(j_mu, name)(j)
        if dt == "DD":
            _same(got, want)
        else:
            assert got.dtype == t and float(got) == float(want)
    got, want = mu.atoreal("0.1", t), j_mu.atoreal("0.1", j)
    if dt == "DD":
        _same(got, want)
        _same(mu.pow_int(got, 5), j_mu.pow_int(want, 5))
    else:
        assert got.dtype == t and float(got) == float(want)
        assert float(mu.pow_int(got, 3)) == float(j_mu.pow_int(want, 3))
