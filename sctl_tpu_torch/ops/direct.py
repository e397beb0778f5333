"""Direct kernel sums (counterpart of sctl_tpu/ops/direct.py:42-113).

The accuracy oracle of the port, ParticleFMM's direct path, the BIE
boundary data and its far field below the FMM cutoff.

Dispatch rule (the JAX package's docstring promises a Pallas dispatch
that its code does not make, sctl_tpu/ops/direct.py:13-14): tensors on
a card go through the hand-written kernel `p2p` (csrc/p2p_direct.cu,
float32 or float64), and a failed build or launch raises; tensors on
the CPU go through the kernel's plain version, the pairwise form in
(block_t x block_s) tiles.  Each sum credits T S kernel.flops to the
profiler's FLOP counter (sctl_tpu/ops/direct.py:63, :111) once, in
`p2p`, which both functions call.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import resolve_device
from .kernels import KernelSpec
from .p2p import p2p


def kernel_matrix(kernel: KernelSpec, xt, xs, ns=None,
                  device=None) -> torch.Tensor:
    """Dense (Ns*kdim0, Nt*kdim1) matrix on `device`, scale factor
    included (reference: GenericKernel::KernelMatrix)."""
    dev = resolve_device(device)
    xt, xs = torch.as_tensor(xt, device=dev), torch.as_tensor(xs, device=dev)
    return kernel.full_matrix(
        xt, xs, None if ns is None else torch.as_tensor(ns, device=dev))


def direct_eval(kernel: KernelSpec, xt, xs, f, ns=None,
                digits: Optional[int] = None, device=None) -> torch.Tensor:
    """Direct sum u[t, k1] = scale sum_s K[t, s, k0, k1] f[s, k0] on
    `device` (reference: GenericKernel::Eval): xt (T, 3), xs (S, 3), f
    (S*k0,) or (S, k0), ns (S, 3) source normals for the kernels that
    read them -> (T, k1).  On the CPU the plain version in one tile
    (`direct_eval_blocked` bounds its memory); on a card `p2p`.
    `digits` is accepted for the reference's API and not read: the sum
    runs at the tensors' precision."""
    dev = resolve_device(device)
    xt, xs, f = (torch.as_tensor(a, device=dev) for a in (xt, xs, f))
    if ns is not None:
        ns = torch.as_tensor(ns, device=dev)
    if kernel.needs_normal and ns is None:
        raise ValueError(f"{kernel.name} needs source normals")
    T, S = xt.shape[0], xs.shape[0]
    return p2p(kernel, xt, xs, ns, f.reshape(S, kernel.kdim0),
               max(T, 1), max(S, 1)) * kernel.scale_factor


def direct_eval_blocked(kernel: KernelSpec, xt, xs, f, ns=None,
                        block_t: int = 1024, block_s: int = 1024):
    """Direct sum xt (T, 3), xs (S, 3), f (S, k0), ns (S, 3) source
    normals (for kernels that read them) -> (T, k1), scale included,
    through `p2p`: on the CPU its plain version in (block_t x block_s)
    tiles, so memory stays bounded at any problem size; on a card its
    kernel (the tile sizes do not apply)."""
    if kernel.needs_normal and ns is None:
        raise ValueError(f"{kernel.name} needs source normals")
    return p2p(kernel, xt, xs, ns, f.reshape(xs.shape[0], kernel.kdim0),
               block_t, block_s) * kernel.scale_factor
