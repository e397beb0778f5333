"""The port's native host runtime: each entry point's native and numpy
paths bit for bit, and both against the JAX package's native module on
the same inputs from a seed."""

import numpy as np
import pytest

from sctl_tpu import native as j_native
from sctl_tpu_torch import native
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.tree import morton as mt

limit_cpu_threads()


def test_library_builds():
    """g++ is on this host, so the library builds and the entry points
    take it."""
    assert native.available() and native.build().exists()


@pytest.mark.parametrize("dim,depth", [(3, 20), (3, 6), (2, 31), (2, 9)])
def test_morton_encode(dim, depth):
    rng = np.random.default_rng(dim * 100 + depth)
    x = rng.random((5000, dim))
    x[:10] = [[0.0] * dim, [1.0] * dim, [1 - 1e-17] * dim,
              [-0.2] * dim, [1.3] * dim] * 2
    k = native.morton_encode(x, depth)
    np.testing.assert_array_equal(k, native.morton_encode_plain(x, depth))
    np.testing.assert_array_equal(k, j_native.morton_encode(x, depth))
    np.testing.assert_array_equal(k, mt.morton_encode(x, depth=depth))


def test_argsort_u64():
    rng = np.random.default_rng(2)
    k = rng.integers(0, 2 ** 63, size=30000, dtype=np.uint64)
    k[::7] = k[3]                                # ties: stability
    s, p = native.argsort_u64(k)
    sp, pp = native.argsort_u64_plain(k)
    np.testing.assert_array_equal(s, sp)
    np.testing.assert_array_equal(p, pp)
    sj, pj = j_native.argsort_u64(k)
    np.testing.assert_array_equal(p, pj)


@pytest.mark.parametrize("bits", [3, 12, 18, 24])
def test_argsort_small(bits):
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 1 << bits, size=40000).astype(np.int64)
    s, p = native.argsort_small(ids, bits)
    sp, pp = native.argsort_small_plain(ids, bits)
    np.testing.assert_array_equal(s, sp)
    np.testing.assert_array_equal(p, pp)
    np.testing.assert_array_equal(p, j_native.argsort_small(ids, bits)[1])


def test_box_counts():
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(-3, 600, size=20000)).astype(np.int64)
    c = native.box_counts(ids, 512)
    np.testing.assert_array_equal(c, native.box_counts_plain(ids, 512))
    ok = ids[(ids >= 0) & (ids < 512)]
    np.testing.assert_array_equal(c, j_native.box_counts(ok, 512))
