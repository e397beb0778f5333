"""Shared-surface S2M and L2T (counterpart of sctl_tpu/ops/pallas_sl.py:
`surface_pair` :195-272 and `l2t_surface` :300-370).

Both stages pair every leaf box's points, in box-local coordinates,
with the same check or equivalent surface.  On a CUDA tensor each
wrapper launches its kernel (csrc/surface_pair.cu, csrc/l2t_surface.cu);
on a CPU tensor it runs the plain version beside it, which computes the
same function in the same layout.
"""

from __future__ import annotations

import torch

from ._build import launch
from ._launch_checks import CHUNK_PAIRS, check_kernel_args, on_cuda
from .kernels import KernelSpec
from .uker import FORMULA, L2T_KERNELS, S2M_KERNELS, check_supported


def surface_pair_fits(kernel: KernelSpec, cap: int) -> bool:
    """Whether csrc/surface_pair.cu's shared tile takes `cap` slots of 32
    boxes: 4 bytes a slot for each coordinate, density component and
    (for the double layers) normal component, in 227 KB."""
    return 4 * kernel.src_floats * 32 * (cap | 1) <= 227 * 1024


def l2t_surface_fits(kernel: KernelSpec, ns: int) -> bool:
    """Whether csrc/l2t_surface.cu's shared memory takes ns surface
    points: 32 boxes' k0 densities and the coordinates, in 227 KB."""
    return 4 * ns * (32 * kernel.kdim0 + 3) <= 227 * 1024


def surface_pair_plain(kernel: KernelSpec, surf, pts_l, f_l, cap: int,
                       nrm_l=None):
    """Plain version of `surface_pair`, in box chunks."""
    ns, k0 = surf.shape[0], kernel.kdim0
    B = pts_l.shape[1] // cap
    out = torch.empty((kernel.kdim1, ns, B), dtype=pts_l.dtype,
                      device=pts_l.device)
    step = max(1, CHUNK_PAIRS // (ns * cap * k0))
    box = lambda a, b0, b1: a[:, b0 * cap:b1 * cap].reshape(
        a.shape[0], b1 - b0, cap).permute(1, 2, 0)
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        u = kernel.apply_pairwise(
            surf[None], box(pts_l, b0, b1),
            None if nrm_l is None else box(nrm_l, b0, b1),
            box(f_l, b0, b1))                               # (b, ns, k1)
        out[:, :, b0:b1] = u.permute(2, 1, 0)
    return out


def surface_pair(kernel: KernelSpec, surf, pts_l, f_l, cap: int,
                 nrm_l=None):
    """Per-box surface pairing -> per-box, per-surface-point sums (the
    S2M check potentials).

    surf  (ns, 3): box-local check surface, shared by every box.
    pts_l (3, B*cap): box-local source coordinates, box-major slots.
    f_l   (k0, B*cap): densities, zero in padded slots.
    nrm_l (3, B*cap): source normals (None unless kernel.needs_normal).
    -> (k1, ns, B) unscaled sums u[:, m, b] = sum_s K(surf_m - x_bs) f_bs.
    """
    check_supported(kernel.name, S2M_KERNELS)
    ns, N = surf.shape[0], pts_l.shape[1]
    if (surf.shape != (ns, 3) or pts_l.shape[0] != 3
            or f_l.shape != (kernel.kdim0, N) or N % cap
            or (kernel.needs_normal
                and (nrm_l is None or nrm_l.shape != (3, N)))):
        raise ValueError(f"surface_pair: shapes surf {tuple(surf.shape)}"
                         f", pts_l {tuple(pts_l.shape)}, f_l "
                         f"{tuple(f_l.shape)}, nrm_l "
                         f"{None if nrm_l is None else tuple(nrm_l.shape)}"
                         f", cap {cap}, kernel {kernel.name}")
    nrm_l = nrm_l if kernel.needs_normal else None
    tensors = [t for t in (surf, pts_l, f_l, nrm_l) if t is not None]
    if not on_cuda(*tensors):
        return surface_pair_plain(kernel, surf, pts_l, f_l, cap, nrm_l)
    check_kernel_args("surface_pair", surf=surf, pts_l=pts_l, f_l=f_l,
                      **({} if nrm_l is None else {"nrm_l": nrm_l}))
    B = N // cap
    if not surface_pair_fits(kernel, cap):
        raise NotImplementedError(f"surface_pair: cap {cap} exceeds the "
                                  "kernel's shared-memory tile")
    out = torch.empty((kernel.kdim1, ns, B), dtype=torch.float32,
                      device=surf.device)
    launch("sctl_surface_pair", surf.data_ptr(), pts_l.data_ptr(),
           None if nrm_l is None else nrm_l.data_ptr(), f_l.data_ptr(),
           out.data_ptr(), FORMULA[kernel.name], ns, B, cap)
    surface_pair.launches += 1
    return out


surface_pair.launches = 0


def l2t_surface_plain(kernel: KernelSpec, surf, xt_l, q_cm, cap_t: int):
    """Plain version of `l2t_surface`, in box chunks."""
    k0, ns, B = q_cm.shape
    out = torch.empty((kernel.kdim1, B * cap_t), dtype=xt_l.dtype,
                      device=xt_l.device)
    step = max(1, CHUNK_PAIRS // (ns * cap_t * k0))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        sl = slice(b0 * cap_t, b1 * cap_t)
        xt = xt_l[:, sl].reshape(3, b1 - b0, cap_t).permute(1, 2, 0)
        q = q_cm[:, :, b0:b1].permute(2, 1, 0)              # (b, ns, k0)
        u = kernel.apply_pairwise(xt, surf[None], None, q)  # (b,ct,k1)
        out[:, sl] = u.permute(2, 0, 1).reshape(kernel.kdim1, -1)
    return out


def l2t_surface(kernel: KernelSpec, surf, xt_l, q_cm, cap_t: int):
    """Downward-equivalent surface -> leaf targets (L2T).

    surf (ns, 3): box-local equivalent surface (source positions).
    xt_l (3, B*cap_t): box-local target coordinates, box-major slots.
    q_cm (k0, ns, B): per-box equivalent densities, component-major.
    -> (k1, B*cap_t) unscaled potentials at the padded target slots.
    """
    check_supported(kernel.name, L2T_KERNELS)
    if not on_cuda(surf, xt_l, q_cm):
        return l2t_surface_plain(kernel, surf, xt_l, q_cm, cap_t)
    check_kernel_args("l2t_surface", surf=surf, xt_l=xt_l, q_cm=q_cm)
    ns = surf.shape[0]
    B = q_cm.shape[2]
    if (surf.shape != (ns, 3) or q_cm.shape != (kernel.kdim0, ns, B)
            or xt_l.shape != (3, B * cap_t)):
        raise ValueError(f"l2t_surface: shapes surf {tuple(surf.shape)}, "
                         f"xt_l {tuple(xt_l.shape)}, q_cm "
                         f"{tuple(q_cm.shape)}, cap_t {cap_t}")
    if not l2t_surface_fits(kernel, ns):
        raise NotImplementedError(f"l2t_surface: {ns} surface points "
                                  "exceed the kernel's shared memory")
    out = torch.empty((kernel.kdim1, B * cap_t), dtype=torch.float32,
                      device=surf.device)
    launch("sctl_l2t_surface", surf.data_ptr(), xt_l.data_ptr(),
           q_cm.data_ptr(), out.data_ptr(), FORMULA[kernel.name], ns, B,
           cap_t)
    l2t_surface.launches += 1
    return out


l2t_surface.launches = 0
