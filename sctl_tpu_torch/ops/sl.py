"""Shared-surface S2M and L2T (counterpart of sctl_tpu/ops/pallas_sl.py:
`surface_pair` :195-272 and `l2t_surface` :300-370).

Both stages pair every leaf box's points, in box-local coordinates,
with the same check or equivalent surface.  A box's real points are
its first slots; an optional per-box int32 count (Morton order) says
how many, and both functions then leave the slots past it out:
`surface_pair` reads no source past it, `l2t_surface` gives exactly 0
at the target slots past it.  Without counts every slot counts, the
JAX functions' definition.  On a CUDA tensor each wrapper launches its
kernel (csrc/surface_pair.cu, csrc/l2t_surface.cu), the float32 or the
float64 build by the tensors' type; on a CPU tensor it runs the plain
version beside it, which computes the same function in the same layout.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import launch, library
from ._launch_checks import (CHUNK_PAIRS, check_index_args,
                             check_kernel_args, on_cuda)
from .kernels import KernelSpec
from .p2p import _slot_mask
from .uker import FORMULA, L2T_KERNELS, S2M_KERNELS, check_supported


def surface_pair_fits(kernel: KernelSpec, cap: int,
                      dtype: torch.dtype = torch.float32) -> bool:
    """Route rule of the KIFMM's S2M (`KIFMM.surface_route`): `cap`
    source slots of 32 boxes at the element size of `dtype` (4 or 8
    bytes) a coordinate, density and (for the double layers) normal
    component within 227 KB.  The kernel stages fixed tiles of real
    sources and takes any capacity; the rule stays so that the shapes it
    leaves out keep the U-list route, until a measurement shows where
    the surface kernels are the faster way."""
    return (dtype.itemsize * kernel.src_floats * 32 * (cap | 1)
            <= 227 * 1024)


def l2t_surface_fits(kernel: KernelSpec, ns: int,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Route rule of the KIFMM's L2T (`KIFMM.surface_route`): ns surface
    points with 32 boxes' k0 densities and the coordinates, at the
    element size of `dtype`, within 227 KB.  Within it
    csrc/l2t_surface.cu's records of at least one box fit."""
    return dtype.itemsize * ns * (32 * kernel.kdim0 + 3) <= 227 * 1024


def surface_pair_layout(kernel: KernelSpec, ns: int,
                        dtype: torch.dtype = torch.float32) -> dict:
    """csrc/surface_pair.cu's layout at ns surface points in the build of
    `dtype`: surface points a lane, passes over the surface, threads a
    block (8 warps), boxes a warp (one at a time), and the resident
    blocks an SM (the occupancy API)."""
    lay, blocks = (ctypes.c_int * 4)(), ctypes.c_int(0)
    err = library().sctl_surface_pair_occupancy(
        FORMULA[kernel.name], int(dtype == torch.float64), ns, lay,
        ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"sctl_surface_pair_occupancy: CUDA error {err}")
    return dict(points_per_lane=lay[0], passes=lay[1], threads=lay[2],
                boxes_per_warp=lay[3], blocks_per_sm=blocks.value)


def l2t_surface_layout(kernel: KernelSpec, ns: int, cap_t: int,
                       dtype: torch.dtype = torch.float32) -> dict:
    """csrc/l2t_surface.cu's block at (ns, cap_t) in the build of
    `dtype`: targets a thread, boxes a block, threads a block, and the
    resident blocks an SM."""
    lay, blocks = (ctypes.c_int * 3)(), ctypes.c_int(0)
    err = library().sctl_l2t_surface_occupancy(
        FORMULA[kernel.name], int(dtype == torch.float64), ns, cap_t, lay,
        ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"sctl_l2t_surface_occupancy: CUDA error {err}")
    return dict(targets_per_thread=lay[0], boxes=lay[1], threads=lay[2],
                blocks_per_sm=blocks.value)


def surface_pair_plain(kernel: KernelSpec, surf, pts_l, f_l, cap: int,
                       nrm_l=None, cnt=None):
    """Plain version of `surface_pair`, in box chunks: the densities of
    the slots past cnt are masked to zero."""
    ns, k0 = surf.shape[0], kernel.kdim0
    B = pts_l.shape[1] // cap
    if cnt is not None:
        f_l = f_l * _slot_mask(cnt, cap).reshape(1, -1).to(f_l.dtype)
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
                 nrm_l=None, cnt=None):
    """Per-box surface pairing -> per-box, per-surface-point sums (the
    S2M check potentials).

    surf  (ns, 3): box-local check surface, shared by every box.
    pts_l (3, B*cap): box-local source coordinates, box-major slots.
    f_l   (k0, B*cap): densities (zero in padded slots, or past cnt).
    nrm_l (3, B*cap): source normals (None unless kernel.needs_normal).
    cnt   (B,) int32: each box's real sources, its first slots (None:
          every slot); the slots past it are not read.
    -> (k1, ns, B) unscaled sums u[:, m, b] = sum_s K(surf_m - x_bs) f_bs,
    in the inputs' type: on the card float32 or float64, one type for
    every float tensor.
    """
    check_supported(kernel.name, S2M_KERNELS)
    ns, N = surf.shape[0], pts_l.shape[1]
    if (surf.shape != (ns, 3) or pts_l.shape[0] != 3
            or f_l.shape != (kernel.kdim0, N) or N % cap
            or (kernel.needs_normal
                and (nrm_l is None or nrm_l.shape != (3, N)))
            or (cnt is not None and cnt.shape != (N // cap,))):
        raise ValueError(f"surface_pair: shapes surf {tuple(surf.shape)}"
                         f", pts_l {tuple(pts_l.shape)}, f_l "
                         f"{tuple(f_l.shape)}, nrm_l "
                         f"{None if nrm_l is None else tuple(nrm_l.shape)}"
                         f", cnt "
                         f"{None if cnt is None else tuple(cnt.shape)}, "
                         f"cap {cap}, kernel {kernel.name}")
    nrm_l = nrm_l if kernel.needs_normal else None
    tensors = [t for t in (surf, pts_l, f_l, nrm_l, cnt) if t is not None]
    if not on_cuda(*tensors):
        return surface_pair_plain(kernel, surf, pts_l, f_l, cap, nrm_l,
                                  cnt)
    dt = check_kernel_args("surface_pair", (torch.float32, torch.float64),
                           surf=surf, pts_l=pts_l, f_l=f_l,
                           **({} if nrm_l is None else {"nrm_l": nrm_l}))
    check_index_args("surface_pair", cnt=cnt)
    B = N // cap
    out = torch.empty((kernel.kdim1, ns, B), dtype=dt, device=surf.device)
    f64 = dt == torch.float64
    launch("sctl_surface_pair_f64" if f64 else "sctl_surface_pair",
           surf.data_ptr(), pts_l.data_ptr(),
           None if nrm_l is None else nrm_l.data_ptr(), f_l.data_ptr(),
           None if cnt is None else cnt.data_ptr(), out.data_ptr(),
           FORMULA[kernel.name], ns, B, cap)
    surface_pair.launches += 1
    surface_pair.launches_f64 += f64
    return out


surface_pair.launches = 0
# the launches of the float64 build among them
surface_pair.launches_f64 = 0


def l2t_surface_plain(kernel: KernelSpec, surf, xt_l, q_cm, cap_t: int,
                      cnt=None):
    """Plain version of `l2t_surface`, in box chunks: the target slots
    past cnt come out zero."""
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
    if cnt is not None:
        out.masked_fill_(~_slot_mask(cnt, cap_t).reshape(1, -1), 0)
    return out


def l2t_surface(kernel: KernelSpec, surf, xt_l, q_cm, cap_t: int,
                cnt=None):
    """Downward-equivalent surface -> leaf targets (L2T).

    surf (ns, 3): box-local equivalent surface (source positions).
    xt_l (3, B*cap_t): box-local target coordinates, box-major slots.
    q_cm (k0, ns, B): per-box equivalent densities, component-major.
    cnt  (B,) int32: each box's real targets, its first slots (None:
         every slot); the slots past it come out exactly 0.
    -> (k1, B*cap_t) unscaled potentials at the padded target slots, in
    the inputs' type: on the card float32 or float64, one type for every
    float tensor.
    """
    check_supported(kernel.name, L2T_KERNELS)
    ns = surf.shape[0]
    B = q_cm.shape[2]
    if (surf.shape != (ns, 3) or q_cm.shape != (kernel.kdim0, ns, B)
            or xt_l.shape != (3, B * cap_t)
            or (cnt is not None and cnt.shape != (B,))):
        raise ValueError(f"l2t_surface: shapes surf {tuple(surf.shape)}, "
                         f"xt_l {tuple(xt_l.shape)}, q_cm "
                         f"{tuple(q_cm.shape)}, cnt "
                         f"{None if cnt is None else tuple(cnt.shape)}, "
                         f"cap_t {cap_t}")
    tensors = [t for t in (surf, xt_l, q_cm, cnt) if t is not None]
    if not on_cuda(*tensors):
        return l2t_surface_plain(kernel, surf, xt_l, q_cm, cap_t, cnt)
    dt = check_kernel_args("l2t_surface", (torch.float32, torch.float64),
                           surf=surf, xt_l=xt_l, q_cm=q_cm)
    check_index_args("l2t_surface", cnt=cnt)
    # one box's 16-byte records: (3 + k0) values of dt a surface point
    per_rec = 16 // dt.itemsize
    if 16 * -(-(3 + kernel.kdim0) // per_rec) * ns + 256 > 227 * 1024:
        raise NotImplementedError(f"l2t_surface: one box's records of "
                                  f"{ns} surface points exceed the "
                                  "kernel's shared memory")
    out = torch.empty((kernel.kdim1, B * cap_t), dtype=dt,
                      device=surf.device)
    f64 = dt == torch.float64
    launch("sctl_l2t_surface_f64" if f64 else "sctl_l2t_surface",
           surf.data_ptr(), xt_l.data_ptr(), q_cm.data_ptr(),
           None if cnt is None else cnt.data_ptr(), out.data_ptr(),
           FORMULA[kernel.name], ns, B, cap_t)
    l2t_surface.launches += 1
    l2t_surface.launches_f64 += f64
    return out


l2t_surface.launches = 0
# the launches of the float64 build among them
l2t_surface.launches_f64 = 0
