"""Direct kernel sums (counterpart of sctl_tpu/ops/direct.py:42-113).

The accuracy oracle of the port, ParticleFMM's direct path, the BIE
boundary data and its far field below the FMM cutoff.

Dispatch rule (the JAX package's docstring promises a Pallas dispatch
that its code does not make, sctl_tpu/ops/direct.py:13-14): tensors on
a card go through the hand-written kernel `p2p` (csrc/p2p_direct.cu,
float32 or float64), and a failed build or launch raises; tensors on
the CPU go through the kernel's plain version, the pairwise form in
(block_t x block_s) tiles.
"""

from __future__ import annotations

from .kernels import KernelSpec
from .p2p import p2p


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
