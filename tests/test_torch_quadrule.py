"""The port's quadrature rules and Lagrange matrices against the JAX
package's (the cases of tests/test_quadrule.py) on the same inputs.
Both run the same numpy (and scipy) operations in the same order on the
host, so every result must be equal bit for bit."""

import numpy as np
import pytest

from sctl_tpu.linalg import InterpQuadRule as J_IQR
from sctl_tpu.linalg import cheb_quad_rule as j_cheb_quad_rule
from sctl_tpu.linalg import derivative_matrix as j_derivative_matrix
from sctl_tpu.linalg import interpolation_matrix as j_interpolation_matrix
from sctl_tpu.linalg.quadrule import leg_poly as j_leg_poly
from sctl_tpu import quadmath as jq
from sctl_tpu_torch import quadmath as qm
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import (InterpQuadRule, cheb_quad_rule,
                                   derivative_matrix, interpolation_matrix,
                                   leg_poly, leg_quad_rule)

limit_cpu_threads()

eq = np.testing.assert_array_equal


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_cheb_quad_rule_bit_for_bit(n):
    for a, b in zip(cheb_quad_rule(n), j_cheb_quad_rule(n)):
        eq(a, b)


@pytest.mark.parametrize("n", [2, 5, 16, 33])
def test_cheb_quad_rule_exactness(n):
    """Clenshaw-Curtis of n points integrates degree n-1 exactly."""
    x, w = cheb_quad_rule(n)
    for d in range(n):
        assert abs(np.sum(w * x ** d) - 1.0 / (d + 1)) < 1e-13


@pytest.mark.parametrize("degree", [0, 1, 4, 12])
def test_leg_poly_bit_for_bit(degree):
    x = np.linspace(-1, 1, 11)
    for a, b in zip(leg_poly(x, degree), j_leg_poly(x, degree)):
        eq(a, b)
    P, dP = leg_poly(x, max(degree, 3))
    np.testing.assert_allclose(P[3], 0.5 * (5 * x ** 3 - 3 * x),
                               atol=1e-14)


def _log_family(K=8):
    def integrands(x):
        x = np.asarray(x)
        cols = [x ** k for k in range(K)]
        cols += [x ** k * np.log(x) for k in range(K)]
        return np.stack(cols, axis=1)
    return integrands


@pytest.mark.parametrize("use_svd", [True, False])
def test_interp_quad_rule_log_singularity(use_svd):
    """The log-singular family of tests/test_quadrule.py:71-99: the
    same nodes, weights and condition number as the JAX package, and
    the family integrated to 1e-10."""
    K = 8
    nds, wts, cond = InterpQuadRule.build(_log_family(K), 0.0, 1.0,
                                          eps=1e-12, use_svd=use_svd)
    j = J_IQR.build(_log_family(K), 0.0, 1.0, eps=1e-12, use_svd=use_svd)
    eq(nds, j[0])
    eq(wts, j[1])
    assert cond == j[2]
    assert len(nds) <= 2 * K and cond < 1e4
    for k in range(K):
        assert abs(np.sum(wts * nds ** k) - 1 / (k + 1)) < 1e-10
        assert abs(np.sum(wts * nds ** k * np.log(nds))
                   + 1 / (k + 1) ** 2) < 1e-10


def test_interp_quad_rule_order_cap_and_interval():
    """The order cap of tests/test_quadrule.py:102-110, and nodes
    restricted to a sub-interval."""
    def integrands(x):
        return np.stack([np.asarray(x) ** k for k in range(12)], axis=1)

    for kw in (dict(eps=1e-14, order=6),
               dict(eps=1e-12, nds_interval=(0.25, 0.75))):
        got = InterpQuadRule.build(integrands, 0.0, 1.0, **kw)
        want = J_IQR.build(integrands, 0.0, 1.0, **kw)
        for a, b in zip(got, want):
            eq(a, b)
    assert len(InterpQuadRule.build(integrands, 0.0, 1.0, eps=1e-14,
                                    order=6)[0]) == 6


def test_adap_quad_rule_bit_for_bit():
    fn = _log_family(4)
    for a, b in zip(InterpQuadRule.adap_quad_rule(fn, 0.0, 1.0, 1e-13),
                    J_IQR.adap_quad_rule(fn, 0.0, 1.0, 1e-13)):
        eq(a, b)


@pytest.mark.parametrize("ns,nt", [(8, 25), (12, 7)])
def test_interpolation_matrix_bit_for_bit(ns, nt):
    src = np.cos(np.pi * np.arange(ns) / (ns - 1))
    trg = np.linspace(-1, 1, nt)
    for dd in (False, True):
        eq(interpolation_matrix(src, trg, dd=dd),
           j_interpolation_matrix(src, trg, dd=dd))
    Mdd = interpolation_matrix(src, trg, dd=True)
    np.testing.assert_allclose(src ** (ns - 3) @ Mdd, trg ** (ns - 3),
                               atol=1e-12)


def test_interpolation_matrix_dd_nodes_bit_for_bit():
    """DD nodes in, as the SDC tables give them."""
    rng = np.random.default_rng(0)
    s = np.sort(rng.random(9))
    t = rng.random(5)
    ds, dt = qm.DD(s, s * 1e-17), qm.DD(t, t * 3e-17)
    js, jt = jq.DD(s, s * 1e-17), jq.DD(t, t * 3e-17)
    eq(interpolation_matrix(ds, dt, dd=True),
       j_interpolation_matrix(js, jt, dd=True))


@pytest.mark.parametrize("n", [5, 12])
def test_derivative_matrix_bit_for_bit(n):
    src = np.cos(np.pi * np.arange(n) / (n - 1))
    D = derivative_matrix(src)
    eq(D, j_derivative_matrix(src))
    np.testing.assert_allclose(src ** 4 @ D, 4 * src ** 3, atol=1e-10)


def test_leg_quad_rule_unchanged():
    x, w = leg_quad_rule(16)
    assert abs(np.sum(w) - 1.0) < 1e-14
