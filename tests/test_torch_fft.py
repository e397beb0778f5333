"""The port's FFT facade against the JAX package's on the same inputs
(the dims and batch counts of tests/test_fft.py): each of the four
transform types in the interleaved (re, im) flat layout, at 1e-12 of the
maximum (torch.fft and XLA's FFT sum in their own orders); the
double-double DFT `fft_dd` bit for bit (the same numpy operations), and
the dense DFT matrix at 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctl_tpu.linalg import FFT as J_FFT
from sctl_tpu.linalg.fft import FFTType as J_FFTType
from sctl_tpu.linalg.fft import dft_matrix as j_dft_matrix
from sctl_tpu.linalg.fft import fft_dd as j_fft_dd
from sctl_tpu import quadmath as jq
from sctl_tpu_torch import quadmath as qm
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.linalg import FFT, FFTType, dft_matrix, fft_dd

limit_cpu_threads()

BAR = 1e-12


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# tests/test_fft.py's cases: the real transforms at three dims and
# howmany 1 and 3, the complex ones at two dims and howmany 2
CASES = ([(k, d, h) for k in ("R2C", "C2R")
          for d in ((16,), (8, 12), (4, 6, 8)) for h in (1, 3)]
         + [(k, d, 2) for k in ("C2C", "C2C_INV") for d in ((16,), (8, 12))])


@pytest.mark.parametrize("kind,dims,howmany", CASES)
def test_fft_matches_jax(kind, dims, howmany):
    plan = FFT(device="cpu").setup(getattr(FFTType, kind), howmany, dims)
    jplan = J_FFT().setup(getattr(J_FFTType, kind), howmany, dims)
    assert (plan.in_size(), plan.out_size()) == (jplan.in_size(),
                                                 jplan.out_size())
    rng = np.random.default_rng(hash((kind, dims, howmany)) % 2 ** 32)
    x = rng.normal(size=plan.in_size())
    y = plan.execute(torch.as_tensor(x))
    assert y.shape == (plan.out_size(),) and y.dtype == torch.float64
    assert rel(y, jplan.execute(jnp.asarray(x))) < BAR


@pytest.mark.parametrize("dims", [(16,), (8, 12), (4, 6, 8)])
def test_roundtrips(dims):
    rng = np.random.default_rng(1)
    for fwd, bwd in ((FFTType.R2C, FFTType.C2R),
                     (FFTType.C2C, FFTType.C2C_INV)):
        pf = FFT(device="cpu").setup(fwd, 2, dims)
        pb = FFT(device="cpu").setup(bwd, 2, dims)
        x = torch.as_tensor(rng.normal(size=pf.in_size()))
        assert rel(pb.execute(pf.execute(x)), x) < BAR


def test_float32_plan():
    plan = FFT(dtype=torch.float32, device="cpu").setup(FFTType.C2C, 1,
                                                        (32,))
    x = np.random.default_rng(2).normal(size=64)
    y = plan.execute(x)
    assert y.dtype == torch.float32
    ref = np.fft.fft(x[0::2] + 1j * x[1::2])
    assert rel(y.numpy()[0::2] + 1j * y.numpy()[1::2], ref) < 1e-6


def test_execute_needs_setup():
    with pytest.raises(RuntimeError):
        FFT(device="cpu").execute(torch.zeros(4))


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_dd_bit_for_bit(inverse):
    rng = np.random.default_rng(3)
    re, im = rng.normal(size=(2, 12))
    got = fft_dd(re, im, inverse=inverse)
    want = j_fft_dd(re, im, inverse=inverse)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.hi, b.hi)
        np.testing.assert_array_equal(a.lo, b.lo)
    back = fft_dd(*got, inverse=not inverse)
    assert np.abs((back[0] - qm.DD(re)).to_float64()).max() < 1e-28
    assert isinstance(got[0], qm.DD) and not isinstance(got[0], jq.DD)


@pytest.mark.parametrize("n", [7, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matrix(n, inverse):
    F = dft_matrix(n, inverse=inverse, device="cpu")
    assert F.dtype == torch.complex128
    assert rel(F.numpy(), np.asarray(j_dft_matrix(n, inverse=inverse))) \
        < BAR
