"""Near-field P2P over the packed 9-column slab (counterpart of
sctl_tpu/ops/pallas_p2p.py `p2p_stencil9` :362-446).

Boxes are in raster order.  Slab entry z' of column (x, y) holds the 9
(dx, dy) neighbour columns' box (x+dx, y+dy, z'-1) points side by side
(SL slots, zeros in margins and padding), so the 27-box neighbourhood
of target box z is the one window [z*SL, (z+3)*SL).  On a CUDA tensor
`p2p_stencil9` launches csrc/p2p_stencil9.cu; on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import torch

from ._build import launch
from ._launch_checks import CHUNK_PAIRS, check_kernel_args, on_cuda
from .kernels import KernelSpec
from .uker import check_supported


def to_slab(a, rast_to_mort, n: int, SL: int):
    """(B, cap, k) box-slot array in Morton order -> packed slab columns
    (n, n, k, (n+2)*SL): entry z' of column (x, y) holds the 9 (dx, dy)
    neighbour columns' box (x+dx, y+dy, z'-1) slots in blocks of cap,
    c = 3(dx+1) + dy+1; zeros in margins and padding
    (sctl_tpu/fmm/kifmm.py:1468)."""
    B, cap, k = a.shape
    g = a[rast_to_mort].reshape(n, n, n, cap, k).permute(0, 1, 4, 2, 3)
    buf = a.new_zeros((n, n, k, n + 2, SL))
    c = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x0, x1 = max(0, -dx), min(n, n - dx)
            y0, y1 = max(0, -dy), min(n, n - dy)
            buf[x0:x1, y0:y1, :, 1:n + 1, c * cap:(c + 1) * cap] = \
                g[x0 + dx:x1 + dx, y0 + dy:y1 + dy]
            c += 1
    return buf.reshape(n, n, k, (n + 2) * SL)


def p2p_stencil9_plain(kernel: KernelSpec, nside: int, SL: int,
                       cap_t: int, xt_g, xs_s, f_s):
    """Plain version of `p2p_stencil9`, in column chunks per z."""
    n, k0 = nside, kernel.kdim0
    xt = xt_g.reshape(n * n, n, 3, cap_t)
    xs = xs_s.reshape(n * n, 3, (n + 2) * SL)
    f = f_s.reshape(n * n, k0, (n + 2) * SL)
    out = torch.empty((n * n, n, cap_t, kernel.kdim1), dtype=xt_g.dtype,
                      device=xt_g.device)
    step = max(1, CHUNK_PAIRS // (cap_t * 3 * SL))
    for c0 in range(0, n * n, step):
        c = slice(c0, c0 + step)
        for z in range(n):
            w = slice(z * SL, (z + 3) * SL)
            out[c, z] = kernel.apply_pairwise(
                xt[c, z].transpose(1, 2), xs[c, :, w].transpose(1, 2),
                f[c, :, w].transpose(1, 2))
    return out.reshape(n, n, n, cap_t, kernel.kdim1)


def p2p_stencil9(kernel: KernelSpec, nside: int, SL: int, cap_t: int,
                 xt_g, xs_s, f_s):
    """Uniform-grid near-field P2P.

    xt_g (n, n, n, 3, cap_t): target coordinates per box, raster order.
    xs_s (n, n, 3, (n+2)*SL): packed slab columns (z margin included).
    f_s  (n, n, k0, (n+2)*SL): densities, zero in padding.
    -> (n, n, n, cap_t, k1) unscaled potentials, raster order.
    """
    check_supported(kernel.name)
    n = nside
    if (xt_g.shape != (n, n, n, 3, cap_t)
            or xs_s.shape != (n, n, 3, (n + 2) * SL)
            or f_s.shape != (n, n, kernel.kdim0, (n + 2) * SL)):
        raise ValueError(f"p2p_stencil9: xt_g {tuple(xt_g.shape)}, xs_s "
                         f"{tuple(xs_s.shape)}, f_s {tuple(f_s.shape)}, "
                         f"n {n}, SL {SL}, cap_t {cap_t}")
    if not on_cuda(xt_g, xs_s, f_s):
        return p2p_stencil9_plain(kernel, n, SL, cap_t, xt_g, xs_s, f_s)
    check_kernel_args("p2p_stencil9", xt_g=xt_g, xs_s=xs_s, f_s=f_s)
    if 4 * cap_t > 1024 or 16 * 6 * SL > 227 * 1024:
        raise NotImplementedError(f"p2p_stencil9: cap_t {cap_t} or SL "
                                  f"{SL} exceeds the kernel's block")
    out = torch.empty((n, n, n, cap_t, 1), dtype=torch.float32,
                      device=xt_g.device)
    launch("sctl_p2p_stencil9", xt_g.data_ptr(), xs_s.data_ptr(),
           f_s.data_ptr(), out.data_ptr(), n, SL, cap_t)
    p2p_stencil9.launches += 1
    return out


p2p_stencil9.launches = 0
