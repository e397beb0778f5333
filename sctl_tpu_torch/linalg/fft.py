"""FFT facade (counterpart of sctl_tpu/linalg/fft.py; reference:
include/sctl/fft_wrapper.hpp/.txx — FFT<T> R2C/C2C/C2C_INV/C2R batched
multi-dimensional transforms with Setup(type, howmany, dims)/Execute).

`torch.fft` on the plan's device (cuFFT on the card) plays FFTW's role.
The facade keeps the reference's Setup/Execute API and its data layout:
the input is a flat vector of `howmany` contiguous transforms, complex
data interleaved (re, im).  Normalization as FFTW's: forward unscaled,
inverse scaled by 1/N; R2C keeps N//2+1 complex outputs.

`fft_dd` is the reference's QuadReal DFT in double-double on the host;
`dft_matrix` the dense DFT matrix.
"""

from __future__ import annotations

import enum
import math
from typing import Sequence

import numpy as np
import torch

from .. import quadmath as qm
from ..config import resolve_device


class FFTType(enum.Enum):
    R2C = "r2c"
    C2C = "c2c"
    C2C_INV = "c2c_inv"
    C2R = "c2r"


class FFT:
    """Plan-style facade: FFT(device=, dtype=).setup(type, howmany,
    dims); execute(x).  dtype is the real type (float64 or float32)."""

    def __init__(self, dtype=torch.float64, device=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.fft_type = None
        self.howmany = 0
        self.dims: Sequence[int] = ()

    def setup(self, fft_type: FFTType, howmany: int,
              dims: Sequence[int]) -> "FFT":
        self.fft_type = FFTType(fft_type)
        self.howmany = int(howmany)
        self.dims = tuple(int(d) for d in dims)
        return self

    # -- size bookkeeping (reference: FFT::Dim0/Dim1) --------------------
    def _n_real(self) -> int:
        return int(np.prod(self.dims))

    def _n_cplx(self) -> int:
        d = list(self.dims)
        d[-1] = d[-1] // 2 + 1
        return int(np.prod(d))

    def in_size(self) -> int:
        t = self.fft_type
        if t == FFTType.R2C:
            return self.howmany * self._n_real()
        if t == FFTType.C2R:
            return self.howmany * self._n_cplx() * 2
        return self.howmany * self._n_real() * 2

    def out_size(self) -> int:
        t = self.fft_type
        if t == FFTType.R2C:
            return self.howmany * self._n_cplx() * 2
        if t == FFTType.C2R:
            return self.howmany * self._n_real()
        return self.howmany * self._n_real() * 2

    # -- execution -------------------------------------------------------
    def execute(self, x) -> torch.Tensor:
        """Transform a flat array of `howmany` contiguous signals on the
        plan's device.  Real transforms take and return real flat
        arrays; complex data is interleaved (re, im) pairs, the layout
        of the reference's Complex<Real> vectors."""
        t = self.fft_type
        if t is None:
            raise RuntimeError("FFT.execute: call setup() first")
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        axes = tuple(range(1, 1 + len(self.dims)))
        if t == FFTType.R2C:
            y = torch.fft.rfftn(x.reshape((self.howmany,) + self.dims),
                                dim=axes)
            return _c2flat(y)
        if t == FFTType.C2C:
            y = torch.fft.fftn(_flat2c(x, (self.howmany,) + self.dims),
                               dim=axes)
            return _c2flat(y)
        if t == FFTType.C2C_INV:
            y = torch.fft.ifftn(_flat2c(x, (self.howmany,) + self.dims),
                                dim=axes)
            return _c2flat(y)
        d = list(self.dims)
        d[-1] = d[-1] // 2 + 1
        y = torch.fft.irfftn(_flat2c(x, (self.howmany,) + tuple(d)),
                             s=self.dims, dim=axes)
        return y.reshape(-1)


def _flat2c(x, shape):
    return torch.view_as_complex(x.reshape(-1, 2).contiguous()
                                 ).reshape(shape)


def _c2flat(y):
    return torch.view_as_real(y.contiguous()).reshape(-1)


def fft_dd(re, im, inverse: bool = False):
    """1-D DFT in double-double on the host (the reference's QuadReal
    FFT path, src/test-fft.cpp with SCTL_QUAD_T: no FFTW for f128, so a
    dense DFT-matrix transform, fft_wrapper.txx:70-110).

    re/im: DD or float arrays of length n.  Returns (re_out, im_out) as
    DD.  O(n^2), precompute-grade."""
    re = re if isinstance(re, qm.DD) else qm.DD(np.asarray(re, float))
    im = im if isinstance(im, qm.DD) else qm.DD(np.asarray(im, float))
    n = len(re.hi)
    k = np.arange(n, dtype=np.float64)
    sign = 1.0 if inverse else -1.0
    # angles k j 2 pi / n in DD, row by row (the products k j are exact
    # in float64 up to n^2 < 2^53)
    out_re = qm.DD.zeros(n)
    out_im = qm.DD.zeros(n)
    two_pi = qm.dd_2pi()
    inv_n = qm.dd_div(qm.DD(1.0), qm.DD(float(n)))
    for j in range(n):
        ang = qm.dd_mul(qm.dd_mul(two_pi, inv_n), qm.DD(sign * k * j))
        s, c = qm._dd_sincos(ang)
        # out[j] = sum_k (re + i im)(c + i s)
        rr = qm.dd_add(qm.dd_mul(re, c), qm.dd_neg(qm.dd_mul(im, s)))
        ii = qm.dd_add(qm.dd_mul(re, s), qm.dd_mul(im, c))
        out_re[j] = _dd_sum(rr)
        out_im[j] = _dd_sum(ii)
    if inverse:
        out_re = qm.dd_mul(out_re, inv_n)
        out_im = qm.dd_mul(out_im, inv_n)
    return out_re, out_im


def _dd_sum(a):
    """Sum of a DD vector (sequential compensated)."""
    acc = qm.DD(0.0)
    for i in range(len(a.hi)):
        acc = qm.dd_add(acc, qm.DD(a.hi[i], a.lo[i]))
    return acc


def dft_matrix(n: int, inverse: bool = False, dtype=torch.complex128,
               device=None) -> torch.Tensor:
    """Dense DFT matrix (the reference fallback's building block,
    fft_wrapper.txx:70-110), formed in numpy and moved to `device`."""
    k = np.arange(n)
    sign = 2j if inverse else -2j
    m = np.exp(sign * math.pi * np.outer(k, k) / n)
    if inverse:
        m = m / n
    return torch.as_tensor(m, dtype=dtype, device=resolve_device(device))
