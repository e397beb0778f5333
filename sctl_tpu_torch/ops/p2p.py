"""Pair kernels: the near-field P2P over the packed 9-column slab
(counterpart of sctl_tpu/ops/pallas_p2p.py `p2p_stencil9` :362-446)
and the per-box U-list P2P (`p2p_ulist` :449-518).

Boxes are in raster order.  Slab entry z' of column (x, y) holds the 9
(dx, dy) neighbour columns' box (x+dx, y+dy, z'-1) points side by side
(SL slots, zeros in margins and padding), so the 27-box neighbourhood
of target box z is the one window [z*SL, (z+3)*SL).

On a CUDA tensor `p2p_stencil9` launches csrc/p2p_stencil9.cu and
`p2p_ulist` csrc/p2p_ulist.cu; on a CPU tensor each runs its plain
version.
"""

from __future__ import annotations

import torch

from ._build import launch
from ._launch_checks import CHUNK_PAIRS, check_kernel_args, on_cuda
from .kernels import KernelSpec
from .uker import LAPLACE_ONLY, check_supported


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


def stencil9_fits(cap_t: int, SL: int) -> bool:
    """Whether csrc/p2p_stencil9.cu's block takes these widths: one
    thread per target slot of 4 z boxes, and the (4 + 2) SL float4
    window in the 227 KB of shared memory."""
    return 4 * cap_t <= 1024 and 16 * 6 * SL <= 227 * 1024


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
                None, f[c, :, w].transpose(1, 2))
    return out.reshape(n, n, n, cap_t, kernel.kdim1)


def p2p_stencil9(kernel: KernelSpec, nside: int, SL: int, cap_t: int,
                 xt_g, xs_s, f_s):
    """Uniform-grid near-field P2P.

    xt_g (n, n, n, 3, cap_t): target coordinates per box, raster order.
    xs_s (n, n, 3, (n+2)*SL): packed slab columns (z margin included).
    f_s  (n, n, k0, (n+2)*SL): densities, zero in padding.
    -> (n, n, n, cap_t, k1) unscaled potentials, raster order.
    """
    check_supported(kernel.name, LAPLACE_ONLY)
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
    if not stencil9_fits(cap_t, SL):
        raise NotImplementedError(f"p2p_stencil9: cap_t {cap_t} or SL "
                                  f"{SL} exceeds the kernel's block")
    out = torch.empty((n, n, n, cap_t, 1), dtype=torch.float32,
                      device=xt_g.device)
    launch("sctl_p2p_stencil9", xt_g.data_ptr(), xs_s.data_ptr(),
           f_s.data_ptr(), out.data_ptr(), n, SL, cap_t)
    p2p_stencil9.launches += 1
    return out


p2p_stencil9.launches = 0


# kernel name -> formula index of csrc/p2p_ulist.cu
ULIST_KERNELS = {"Laplace3D-FxU": 0, "Stokes3D-DxU": 1, "Stokes3D-FSxU": 2}


def p2p_ulist_plain(kernel: KernelSpec, xt_b, xs_b, ns_b, f_b):
    """Plain version of `p2p_ulist`, in box chunks."""
    G, _, T = xt_b.shape
    S = xs_b.shape[2]
    out = xt_b.new_empty((G, T, kernel.kdim1))
    step = max(1, CHUNK_PAIRS // max(1, T * S))
    for g0 in range(0, G, step):
        g = slice(g0, g0 + step)
        out[g] = kernel.apply_pairwise(
            xt_b[g].transpose(1, 2), xs_b[g].transpose(1, 2),
            None if ns_b is None else ns_b[g].transpose(1, 2),
            f_b[g].transpose(1, 2))
    return out


def p2p_ulist(kernel: KernelSpec, xt_b, xs_b, ns_b, f_b):
    """Per-box U-list P2P: box g's T targets against its S gathered
    source slots.

    xt_b (G, 3, T): target coordinates per box, T % 8 == 0.
    xs_b (G, 3, S): gathered source coordinates, S % 128 == 0.
    ns_b (G, 3, S): source normals (None unless kernel.needs_normal).
    f_b  (G, k0, S): densities, zero in padded slots.
    -> (G, T, k1) unscaled potentials.
    """
    check_supported(kernel.name, tuple(ULIST_KERNELS))
    G, _, T = xt_b.shape
    S = xs_b.shape[2]
    k0 = kernel.kdim0
    if (xt_b.shape != (G, 3, T) or xs_b.shape != (G, 3, S)
            or f_b.shape != (G, k0, S) or T % 8 or S % 128
            or (kernel.needs_normal
                and (ns_b is None or ns_b.shape != (G, 3, S)))):
        raise ValueError(f"p2p_ulist: xt_b {tuple(xt_b.shape)}, xs_b "
                         f"{tuple(xs_b.shape)}, f_b {tuple(f_b.shape)}, "
                         f"ns_b {None if ns_b is None else tuple(ns_b.shape)}"
                         f", kernel {kernel.name}")
    ns_b = ns_b if kernel.needs_normal else None
    tensors = [t for t in (xt_b, xs_b, ns_b, f_b) if t is not None]
    if not on_cuda(*tensors):
        return p2p_ulist_plain(kernel, xt_b, xs_b, ns_b, f_b)
    check_kernel_args("p2p_ulist", xt_b=xt_b, xs_b=xs_b, f_b=f_b,
                      **({} if ns_b is None else {"ns_b": ns_b}))
    out = torch.empty((G, T, kernel.kdim1), dtype=torch.float32,
                      device=xt_b.device)
    launch("sctl_p2p_ulist", xt_b.data_ptr(), xs_b.data_ptr(),
           None if ns_b is None else ns_b.data_ptr(), f_b.data_ptr(),
           out.data_ptr(), ULIST_KERNELS[kernel.name], G, T, S)
    p2p_ulist.launches += 1
    return out


p2p_ulist.launches = 0
