"""Direct kernel sums (counterpart of sctl_tpu/ops/direct.py:42-113).

The accuracy oracle of the port, the BIE boundary data and its far
field below the FMM cutoff.  It runs the plain pairwise form in
(block_t x block_s) tiles, so memory stays bounded at any problem size,
on whatever device the inputs lie.
"""

from __future__ import annotations

import torch

from .kernels import KernelSpec


def direct_eval_blocked(kernel: KernelSpec, xt, xs, f, ns=None,
                        block_t: int = 1024, block_s: int = 1024):
    """Memory-bounded direct sum over (block_t x block_s) tiles:
    xt (T, 3), xs (S, 3), f (S, k0), ns (S, 3) source normals (for
    kernels that read them) -> (T, k1), scale included."""
    if kernel.needs_normal and ns is None:
        raise ValueError(f"{kernel.name} needs source normals")
    f = f.reshape(xs.shape[0], kernel.kdim0)
    out = torch.zeros((xt.shape[0], kernel.kdim1), dtype=f.dtype,
                      device=f.device)
    for t0 in range(0, xt.shape[0], block_t):
        acc = out[t0:t0 + block_t]
        for s0 in range(0, xs.shape[0], block_s):
            s = slice(s0, s0 + block_s)
            acc += kernel.apply_pairwise(
                xt[t0:t0 + block_t], xs[s],
                None if ns is None else ns[s], f[s])
    return out * kernel.scale_factor
