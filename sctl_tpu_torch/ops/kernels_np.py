"""Numpy host forms of the kernels (counterpart of
sctl_tpu/ops/kernels_np.py:26-70), used by the operator precompute, the
BIE near assembly and the longdouble KIFMM (`fmm.KIFMMLd`): they make
hundreds of small matrix builds, which stay on the host.  Longdouble
inputs stay longdouble (the QuadReal precompute path,
math_utils.hpp:236-300); everything else computes in float64."""

from __future__ import annotations

import numpy as np

from .kernels import KernelSpec
from .uker import uker_matrix


def _real(*arrays):
    """np.longdouble if any of the arrays is longdouble, else float64."""
    return (np.longdouble if any(np.asarray(a).dtype == np.longdouble
                                 for a in arrays if a is not None)
            else np.float64)


def full_matrix_np(ker: KernelSpec, xt, xs, ns=None) -> np.ndarray:
    """(Ns*k0, Nt*k1) matrix, scale factor included."""
    m = block_matrix_np(ker, xt, xs, ns)
    T, S = m.shape[:2]
    return m.transpose(1, 2, 0, 3).reshape(S * ker.kdim0, T * ker.kdim1)


def block_matrix_np(ker: KernelSpec, xt, xs, ns=None) -> np.ndarray:
    """(T, S, k0, k1) kernel blocks, scale factor included; ns (S, 3)
    source normals."""
    dt = _real(xt, xs)
    xt = np.atleast_2d(np.asarray(xt, dt))
    xs = np.atleast_2d(np.asarray(xs, dt))
    d = xt[:, None, :] - xs[None, :, :]
    if ns is not None:
        ns = np.broadcast_to(np.asarray(ns), d.shape)
    return offset_blocks_np(ker, d, ns=ns)


def offset_blocks_np(ker: KernelSpec, d, rinv=None, ns=None) -> np.ndarray:
    """(..., k0, k1) kernel blocks from displacements d = xt - xs
    (..., 3) and optional per-pair source normals of the same shape,
    scale factor included."""
    d = np.asarray(d, _real(d))
    if rinv is None:
        r2 = (d * d).sum(-1)
        rinv = np.where(r2 > 0, 1.0 / np.sqrt(np.where(r2 > 0, r2, 1.0)),
                        0.0)
    return uker_matrix(ker.name, d, rinv, ns) * ker.scale_factor
