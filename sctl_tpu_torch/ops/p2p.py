"""Pair kernels: the dense direct sum (counterpart of
sctl_tpu/ops/pallas_p2p.py `p2p` :521-606), the near-field P2P over the
packed 9-column slab (`p2p_stencil9` :362-446), the near-field P2P over
9 shifted halo columns (`p2p_stencil` :286-359) and the per-box U-list
P2P (`p2p_ulist` :449-518).  Each takes its kernel formula as a
template parameter of its CUDA source (csrc/ukernels.cuh).

Boxes are in raster order.  Slab entry z' of column (x, y) holds the 9
(dx, dy) neighbour columns' box (x+dx, y+dy, z'-1) points side by side
(SL slots, zeros in margins and padding), so the 27-box neighbourhood
of target box z is the one window [z*SL, (z+3)*SL).  The JAX package
gives each box a block of cap slots in its entry; the port compacts
each entry to its boxes' real points, first, with a count an entry
(`slab_index`), and the kernel reads only those.  The halo layout
keeps each column's own boxes only, cap slots a box between cap-wide
zero margins (`to_halo`); the kernel reads the real slots of boxes
z-1..z+1 of each of the 9 neighbour columns where they lie, by the
boxes' counts.  The U-list kernel reads each box's run of one flat
source list (`box_ranges` for box-major slots).

On a CUDA tensor `p2p` launches csrc/p2p_direct.cu, `p2p_ulist`
csrc/p2p_ulist.cu, `p2p_stencil9` csrc/p2p_stencil9.cu and
`p2p_stencil` csrc/p2p_stencil.cu, each in its float32 or float64 build
by the tensors' type; on a CPU tensor each runs its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import profile
from ._build import launch, library
from ._launch_checks import (CHUNK_PAIRS, check_index_args,
                             check_kernel_args, n_sms, on_cuda)
from .kernels import KernelSpec
from .uker import FORMULA, TREE_KERNELS, check_supported


def p2p_layout(kernel: KernelSpec, dtype, device) -> dict:
    """csrc/p2p_direct.cu's block for `kernel` in `dtype` on the card:
    threads, targets a thread, sources a shared tile, and the resident
    blocks an SM (the occupancy API)."""
    return _p2p_layout(FORMULA[kernel.name], dtype == torch.float64,
                       torch.device(device).index)


@functools.lru_cache(maxsize=None)
def _p2p_layout(formula: int, f64: bool, device_index) -> dict:
    lay, blocks = (ctypes.c_int * 3)(), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = library().sctl_p2p_direct_occupancy(
            formula, int(f64), lay, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"sctl_p2p_direct_occupancy: CUDA error {err}")
    return dict(threads=lay[0], targets_per_thread=lay[1], tile=lay[2],
                blocks_per_sm=blocks.value)


@functools.lru_cache(maxsize=256)
def p2p_grid(T: int, S: int, per_block: int, tile: int,
             resident: int) -> tuple:
    """(source splits, sources a split) of the direct sum's grid: among
    split counts up to 8 waves of target blocks, the one whose blocks,
    `resident` at a time, finish soonest (the waves times the tiles of a
    block; the fewest splits among equals)."""
    t_blocks, tiles = -(-T // per_block), max(1, -(-S // tile))
    best = None
    for ns in range(1, min(tiles, 8 * -(-resident // t_blocks)) + 1):
        cost = -(-t_blocks * ns // resident) * -(-tiles // ns)
        if best is None or cost < best[0]:
            best = (cost, ns)
    chunk = -(-tiles // best[1]) * tile
    return -(-S // chunk) if S else 1, chunk


def p2p_plain(kernel: KernelSpec, xt, xs, ns, f, block_t: int = 1024,
              block_s: int = 1024):
    """Plain version of `p2p`: the pairwise form in (block_t x block_s)
    tiles, so memory stays bounded at any size."""
    out = torch.zeros((xt.shape[0], kernel.kdim1), dtype=f.dtype,
                      device=f.device)
    for t0 in range(0, xt.shape[0], block_t):
        acc = out[t0:t0 + block_t]
        for s0 in range(0, xs.shape[0], block_s):
            s = slice(s0, s0 + block_s)
            acc += kernel.apply_pairwise(
                xt[t0:t0 + block_t], xs[s],
                None if ns is None else ns[s], f[s])
    return out


def p2p(kernel: KernelSpec, xt, xs, ns, f, block_t: int = 1024,
        block_s: int = 1024):
    """Dense direct sum, unscaled: xt (T, 3), xs (S, 3), ns (S, 3) source
    normals (None unless kernel.needs_normal), f (S, k0) -> (T, k1),
    u[t] = sum_s K(xt_t - xs_s) f_s with r2 = 0 masked; float32 or
    float64.  The card's grid splits the sources when the target blocks
    alone would leave resident blocks idle (`p2p_grid`), and the
    splits' partial sums are added here.  On the CPU the plain version
    runs in (block_t x block_s) tiles; the card's kernel has its own
    tiles.  T S kernel.flops go to the profiler's FLOP counter
    (sctl_tpu/ops/pallas_p2p.py:598)."""
    T, S, k0 = xt.shape[0], xs.shape[0], kernel.kdim0
    if (xt.shape != (T, 3) or xs.shape != (S, 3) or f.shape != (S, k0)
            or (kernel.needs_normal
                and (ns is None or ns.shape != (S, 3)))):
        raise ValueError(f"p2p: xt {tuple(xt.shape)}, xs {tuple(xs.shape)}"
                         f", f {tuple(f.shape)}, ns "
                         f"{None if ns is None else tuple(ns.shape)}, "
                         f"kernel {kernel.name}")
    ns = ns if kernel.needs_normal else None
    profile.add_flops(float(T) * S * kernel.flops)
    tensors = [t for t in (xt, xs, ns, f) if t is not None]
    if not on_cuda(*tensors):
        return p2p_plain(kernel, xt, xs, ns, f, block_t, block_s)
    dt = xt.dtype
    if dt not in (torch.float32, torch.float64) or any(
            t.dtype != dt for t in tensors):
        raise NotImplementedError(f"p2p: dtypes {[t.dtype for t in tensors]}"
                                  "; the CUDA kernel takes float32 or "
                                  "float64, one type for all")
    xt, xs, f = xt.contiguous(), xs.contiguous(), f.contiguous()
    ns = None if ns is None else ns.contiguous()
    lay = p2p_layout(kernel, dt, xt.device)
    nsplit, chunk = p2p_grid(
        max(T, 1), S, lay["threads"] * lay["targets_per_thread"],
        lay["tile"], lay["blocks_per_sm"] * n_sms(xt.device))
    part = torch.empty((nsplit, T, kernel.kdim1), dtype=dt,
                       device=xt.device)
    launch("sctl_p2p_direct_" + ("f32" if dt == torch.float32 else "f64"),
           xt.data_ptr(), xs.data_ptr(),
           None if ns is None else ns.data_ptr(), f.data_ptr(),
           part.data_ptr(), FORMULA[kernel.name], T, S, nsplit, chunk)
    p2p.launches += 1
    p2p.launches_f64 += dt == torch.float64
    return part[0] if nsplit == 1 else part.sum(0)


p2p.launches = 0
# the launches of the float64 build among them
p2p.launches_f64 = 0


def slab_index(rast_to_mort, n: int, cap: int, SL: int, cnt=None):
    """The gather index of the packed slab columns -> (idx, cnt9).

    Entry z' of column (x, y) holds the 9 (dx, dy) neighbour columns'
    box (x+dx, y+dy, z'-1), c = 3(dx+1) + dy+1 in turn; idx (n, n,
    (n+2)*SL) int32 gives each slot's row among the B*cap slots of a
    (B, cap, k) box-slot array in Morton order (`rast_to_mort`), B*cap
    for an empty slot.  cnt None: box c fills its block [c cap,
    (c+1) cap) of the entry, the JAX package's layout
    (sctl_tpu/fmm/kifmm.py:1468), and cnt9 is None.  cnt (n, n, n),
    raster order, each box's real points (its first slots): the boxes'
    real points one after another, so each entry's real points are its
    first cnt9 (n, n, n+2) int32 slots."""
    dev = rast_to_mort.device
    B = n ** 3
    if B * cap >= 2 ** 31 or 9 * cap > SL:
        raise ValueError(f"slab_index: n {n}, cap {cap}, SL {SL}")
    box_cnt = (torch.full((n, n, n), cap, device=dev) if cnt is None
               else cnt.to(dev).long().clamp(0, cap))
    # pad index i along each axis is raster i-1; zero outside the domain
    pc = F.pad(box_cnt, (1, 1, 1, 1, 1, 1))
    pm = F.pad(rast_to_mort.reshape(n, n, n).long(), (1, 1, 1, 1, 1, 1))
    idx = torch.full((n * n * (n + 2) * SL,), B * cap, dtype=torch.int32,
                     device=dev)
    entry = torch.arange(n * n * (n + 2), device=dev).reshape(
        n, n, n + 2, 1) * SL
    k = torch.arange(cap, device=dev)
    start = torch.zeros((n, n, n + 2, 1), dtype=torch.long, device=dev)
    c = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cc = pc[1 + dx:1 + dx + n, 1 + dy:1 + dy + n, :, None]
            mm = pm[1 + dx:1 + dx + n, 1 + dy:1 + dy + n, :, None]
            real = k < cc
            pos = entry + (c * cap if cnt is None else start) + k
            idx[pos[real]] = (mm * cap + k)[real].to(torch.int32)
            start = start + cc
            c += 1
    idx = idx.reshape(n, n, (n + 2) * SL)
    if cnt is None:
        return idx, None
    return idx, start.reshape(n, n, n + 2).to(torch.int32)


def slab_gather(a, idx):
    """(B, cap, k) box-slot array in Morton order -> the packed slab
    columns (n, n, k, (n+2)*SL) of `slab_index`'s idx: one gather."""
    B, cap, k = a.shape
    n, _, L = idx.shape
    rows = torch.cat([a.reshape(B * cap, k), a.new_zeros((1, k))]).T
    out = rows.contiguous().index_select(1, idx.reshape(-1))
    return out.reshape(k, n, n, L).permute(1, 2, 0, 3).contiguous()


def to_slab(a, rast_to_mort, n: int, SL: int):
    """(B, cap, k) box-slot array in Morton order -> packed slab columns
    (n, n, k, (n+2)*SL) in the JAX package's layout, a block of cap
    slots a box, zeros in margins and padding
    (sctl_tpu/fmm/kifmm.py:1468)."""
    return slab_gather(a, slab_index(rast_to_mort, n, a.shape[1], SL)[0])


def stencil9_fits(kernel: KernelSpec, cap_t: int, SL: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """Whether csrc/p2p_stencil9.cu's block takes these widths: the
    target slots of 4 z boxes, at most 1,024, and the (4 + 2) SL window
    in the 227 KB of shared memory, at the element size of `dtype` (4
    or 8 bytes) a slot for each coordinate, density component and (for
    the double layers) normal component."""
    return (4 * cap_t <= 1024
            and dtype.itemsize * kernel.src_floats * 6 * SL <= 227 * 1024)


def stencil9_layout(kernel: KernelSpec, SL: int, cap_t: int,
                    dtype: torch.dtype = torch.float32) -> dict:
    """csrc/p2p_stencil9.cu's block at these widths in the build of
    `dtype`: lanes a target, threads, and the resident blocks an SM (the
    occupancy API)."""
    lay, blocks = (ctypes.c_int * 2)(), ctypes.c_int(0)
    err = library().sctl_p2p_stencil9_occupancy(
        FORMULA[kernel.name], int(dtype == torch.float64), SL, cap_t, lay,
        ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"sctl_p2p_stencil9_occupancy: CUDA error {err}")
    return dict(lanes_per_target=lay[0], threads=lay[1],
                blocks_per_sm=blocks.value)


def p2p_stencil9_plain(kernel: KernelSpec, nside: int, SL: int,
                       cap_t: int, xt_g, xs_s, f_s, ns_s=None, cnt9=None,
                       cnt_t=None):
    """Plain version of `p2p_stencil9`, in column chunks per z: the
    densities of entry slots past cnt9 are masked to zero and the
    target slots past cnt_t come out zero."""
    n, k0 = nside, kernel.kdim0
    if cnt9 is not None:
        f_s = f_s * _slot_mask(cnt9, SL).reshape(n, n, 1, -1).to(f_s.dtype)
    xt = xt_g.reshape(n * n, n, 3, cap_t)
    xs = xs_s.reshape(n * n, 3, (n + 2) * SL)
    f = f_s.reshape(n * n, k0, (n + 2) * SL)
    nrm = None if ns_s is None else ns_s.reshape(n * n, 3, (n + 2) * SL)
    out = torch.empty((n * n, n, cap_t, kernel.kdim1), dtype=xt_g.dtype,
                      device=xt_g.device)
    step = max(1, CHUNK_PAIRS // (cap_t * 3 * SL))
    for c0 in range(0, n * n, step):
        c = slice(c0, c0 + step)
        for z in range(n):
            w = slice(z * SL, (z + 3) * SL)
            out[c, z] = kernel.apply_pairwise(
                xt[c, z].transpose(1, 2), xs[c, :, w].transpose(1, 2),
                None if nrm is None else nrm[c, :, w].transpose(1, 2),
                f[c, :, w].transpose(1, 2))
    out = out.reshape(n, n, n, cap_t, kernel.kdim1)
    if cnt_t is not None:
        out = out * _slot_mask(cnt_t, cap_t)[..., None].to(out.dtype)
    return out


def p2p_stencil9(kernel: KernelSpec, nside: int, SL: int, cap_t: int,
                 xt_g, xs_s, f_s, ns_s=None, cnt9=None, cnt_t=None):
    """Uniform-grid near-field P2P over the packed 9-column slab.

    xt_g (n, n, n, 3, cap_t): target coordinates per box, raster order.
    xs_s (n, n, 3, (n+2)*SL): packed slab columns (z margin included).
    f_s  (n, n, k0, (n+2)*SL): densities, zero in padding.
    ns_s (n, n, 3, (n+2)*SL): source normals in the same slab (None
         unless kernel.needs_normal).
    cnt9 (n, n, n+2) int32: each entry's real points, its first slots
         (`slab_index` with counts; None: every slot).  Slots past it
         are left out.
    cnt_t (n, n, n) int32, raster order: each box's real targets, its
         first slots (None: all cap_t); the slots past it come out zero.
    -> (n, n, n, cap_t, k1) unscaled potentials, raster order, in the
    inputs' type: on the card float32 or float64, one type for every
    float tensor.
    """
    check_supported(kernel.name, TREE_KERNELS)
    n = nside
    slab = (n, n, 3, (n + 2) * SL)
    if (xt_g.shape != (n, n, n, 3, cap_t) or xs_s.shape != slab
            or f_s.shape != (n, n, kernel.kdim0, (n + 2) * SL)
            or (kernel.needs_normal
                and (ns_s is None or ns_s.shape != slab))
            or (cnt9 is not None and cnt9.shape != (n, n, n + 2))
            or (cnt_t is not None and cnt_t.shape != (n, n, n))):
        raise ValueError(f"p2p_stencil9: xt_g {tuple(xt_g.shape)}, xs_s "
                         f"{tuple(xs_s.shape)}, f_s {tuple(f_s.shape)}, "
                         f"ns_s {None if ns_s is None else tuple(ns_s.shape)}"
                         f", counts {[None if c is None else tuple(c.shape)
                                      for c in (cnt9, cnt_t)]}, n {n}, SL "
                         f"{SL}, cap_t {cap_t}, kernel {kernel.name}")
    ns_s = ns_s if kernel.needs_normal else None
    tensors = [t for t in (xt_g, xs_s, f_s, ns_s, cnt9, cnt_t)
               if t is not None]
    if not on_cuda(*tensors):
        return p2p_stencil9_plain(kernel, n, SL, cap_t, xt_g, xs_s, f_s,
                                  ns_s, cnt9, cnt_t)
    dt = check_kernel_args("p2p_stencil9", (torch.float32, torch.float64),
                           xt_g=xt_g, xs_s=xs_s, f_s=f_s,
                           **({} if ns_s is None else {"ns_s": ns_s}))
    check_index_args("p2p_stencil9", cnt9=cnt9, cnt_t=cnt_t)
    if not stencil9_fits(kernel, cap_t, SL, dt):
        raise NotImplementedError(f"p2p_stencil9: cap_t {cap_t} or SL "
                                  f"{SL} exceeds the kernel's block for "
                                  f"{kernel.name} in {dt}")
    out = torch.empty((n, n, n, cap_t, kernel.kdim1), dtype=dt,
                      device=xt_g.device)
    f64 = dt == torch.float64
    launch("sctl_p2p_stencil9_f64" if f64 else "sctl_p2p_stencil9",
           xt_g.data_ptr(), xs_s.data_ptr(), _ptr(ns_s), f_s.data_ptr(),
           _ptr(cnt9), _ptr(cnt_t), out.data_ptr(), FORMULA[kernel.name],
           n, SL, cap_t)
    p2p_stencil9.launches += 1
    p2p_stencil9.launches_f64 += f64
    return out


p2p_stencil9.launches = 0
# the launches of the float64 build among them
p2p_stencil9.launches_f64 = 0


def to_halo(a, rast_to_mort, n: int):
    """(B, cap, k) box-slot array in Morton order -> halo columns
    (n, n, k, (n+2)*cap): column (x, y) holds boxes (x, y, 0..n-1) in
    blocks of cap slots, z-major, between cap-wide zero margins (the
    layout of the `to_halo` closure, sctl_tpu/fmm/kifmm.py:861-867).
    Any cap: the JAX package rounds it up to a 64 or 128 multiple for
    the TPU's lane tiles, which the CUDA kernel does not need (its loads
    take any slot and skip the slots past each box's count)."""
    B, cap, k = a.shape
    g = a[rast_to_mort].reshape(n, n, n, cap, k).permute(0, 1, 4, 2, 3)
    return F.pad(g.reshape(n, n, k, n * cap), (cap, cap))


def _nine_columns(a, n: int):
    """(n, n, k, L) halo columns -> (n*n, 9, k, L): each column's 9
    (dx, dy) neighbour columns, zeros outside the domain."""
    pa = F.pad(a, (0, 0, 0, 0, 1, 1, 1, 1))
    return torch.stack([pa[1 + dx:1 + dx + n, 1 + dy:1 + dy + n]
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                       2).reshape(n * n, 9, a.shape[2], -1)


def _slot_mask(cnt, cap: int):
    """(..., ) per-box counts -> (..., cap) bool, slot < count."""
    return torch.arange(cap, device=cnt.device) < cnt[..., None]


def p2p_stencil_plain(kernel: KernelSpec, nside: int, cap: int,
                      cap_t: int, xt_g, xs_h, f_h, ns_h=None, cnt_s=None,
                      cnt_t=None):
    """Plain version of `p2p_stencil`, in column chunks per z: the
    densities of source slots past cnt_s are masked to zero and the
    target slots past cnt_t come out zero."""
    n = nside
    if cnt_s is not None:
        m = _slot_mask(cnt_s, cap).reshape(n, n, 1, n * cap)
        f_h = f_h * F.pad(m, (cap, cap)).to(f_h.dtype)
    xs9, f9 = _nine_columns(xs_h, n), _nine_columns(f_h, n)
    ns9 = None if ns_h is None else _nine_columns(ns_h, n)
    xt = xt_g.reshape(n * n, n, 3, cap_t)
    out = xt_g.new_empty((n * n, n, cap_t, kernel.kdim1))
    step = max(1, CHUNK_PAIRS // (cap_t * 27 * cap))

    def win(a, c, z):                      # (C, 27 cap, k)
        w = a[c, :, :, z * cap:(z + 3) * cap].transpose(2, 3)
        return w.reshape(w.shape[0], 27 * cap, -1)

    for c0 in range(0, n * n, step):
        c = slice(c0, c0 + step)
        for z in range(n):
            out[c, z] = kernel.apply_pairwise(
                xt[c, z].transpose(1, 2), win(xs9, c, z),
                None if ns9 is None else win(ns9, c, z), win(f9, c, z))
    out = out.reshape(n, n, n, cap_t, kernel.kdim1)
    if cnt_t is not None:
        out = out * _slot_mask(cnt_t, cap_t)[..., None].to(out.dtype)
    return out


def p2p_stencil(kernel: KernelSpec, nside: int, cap: int, cap_t: int,
                xt_g, xs_h, f_h, ns_h=None, cnt_s=None, cnt_t=None):
    """Uniform-grid near-field P2P over 9 shifted halo columns.

    xt_g (n, n, n, 3, cap_t): target coordinates per box, raster order.
    xs_h (n, n, 3, (n+2)*cap): halo columns (`to_halo`).
    f_h  (n, n, k0, (n+2)*cap): densities, zero in margins.
    ns_h (n, n, 3, (n+2)*cap): source normals in the same columns (None
         unless kernel.needs_normal).
    cnt_s, cnt_t (n, n, n) int32, raster order: each box's real source
         and target points, its first slots (None: every slot).  Source
         slots past cnt_s are left out, target slots past cnt_t come
         out zero.
    -> (n, n, n, cap_t, k1) unscaled potentials, raster order, in the
    inputs' type: on the card float32 or float64, one type for every
    float tensor.  Any (cap, cap_t): the card's block streams the
    sources in tiles.
    """
    check_supported(kernel.name, TREE_KERNELS)
    n = nside
    col = (n, n, 3, (n + 2) * cap)
    if (xt_g.shape != (n, n, n, 3, cap_t) or xs_h.shape != col
            or f_h.shape != (n, n, kernel.kdim0, (n + 2) * cap)
            or (kernel.needs_normal
                and (ns_h is None or ns_h.shape != col))
            or any(c is not None and c.shape != (n, n, n)
                   for c in (cnt_s, cnt_t))):
        raise ValueError(f"p2p_stencil: xt_g {tuple(xt_g.shape)}, xs_h "
                         f"{tuple(xs_h.shape)}, f_h {tuple(f_h.shape)}, "
                         f"ns_h {None if ns_h is None else tuple(ns_h.shape)}"
                         f", counts {[None if c is None else tuple(c.shape)
                                      for c in (cnt_s, cnt_t)]}, n {n}, cap "
                         f"{cap}, cap_t {cap_t}, kernel "
                         f"{kernel.name}")
    ns_h = ns_h if kernel.needs_normal else None
    tensors = [t for t in (xt_g, xs_h, f_h, ns_h, cnt_s, cnt_t)
               if t is not None]
    if not on_cuda(*tensors):
        return p2p_stencil_plain(kernel, n, cap, cap_t, xt_g, xs_h, f_h,
                                 ns_h, cnt_s, cnt_t)
    dt = check_kernel_args("p2p_stencil", (torch.float32, torch.float64),
                           xt_g=xt_g, xs_h=xs_h, f_h=f_h,
                           **({} if ns_h is None else {"ns_h": ns_h}))
    check_index_args("p2p_stencil", cnt_s=cnt_s, cnt_t=cnt_t)
    out = torch.empty((n, n, n, cap_t, kernel.kdim1), dtype=dt,
                      device=xt_g.device)
    f64 = dt == torch.float64
    launch("sctl_p2p_stencil_f64" if f64 else "sctl_p2p_stencil",
           xt_g.data_ptr(), xs_h.data_ptr(), _ptr(ns_h), f_h.data_ptr(),
           _ptr(cnt_s), _ptr(cnt_t), out.data_ptr(), FORMULA[kernel.name],
           n, cap, cap_t)
    p2p_stencil.launches += 1
    p2p_stencil.launches_f64 += f64
    return out


p2p_stencil.launches = 0
# the launches of the float64 build among them
p2p_stencil.launches_f64 = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def p2p_ulist_plain(kernel: KernelSpec, xt_b, xs, ns, f, srng, tcnt=None,
                    fidx=None):
    """Plain version of `p2p_ulist`: each box's sources gathered into a
    slab as wide as the longest list (zero density past its own), in
    box chunks; target slots past tcnt come out zero."""
    G, _, T = xt_b.shape
    beg = srng[:, 0].long()
    cnt = (srng[:, 1].long() - beg).clamp(min=0)
    S = int(cnt.max()) if G else 0
    k = torch.arange(S, device=xt_b.device)
    real = k < cnt[:, None]                                 # (G, S)
    j = torch.where(real, beg[:, None] + k, 0)
    rows = j if fidx is None else fidx.long()[j]
    out = xt_b.new_zeros((G, T, kernel.kdim1))
    step = max(1, CHUNK_PAIRS // max(1, T * S))
    for g0 in range(0, G, step):
        g = slice(g0, g0 + step)
        out[g] = kernel.apply_pairwise(
            xt_b[g].transpose(1, 2), xs.T[j[g]],
            None if ns is None else ns.T[j[g]],
            f[rows[g]] * real[g, :, None].to(f.dtype))
    if tcnt is not None:
        out = out * _slot_mask(tcnt, T)[..., None].to(out.dtype)
    return out


def _ulist_from_padded(kernel: KernelSpec, xt_b, xs_b, ns_b, f_b):
    """The JAX function's padded slabs -> the flat form: (xs, ns, f,
    srng), every slot of each box's slab a source."""
    G, _, T = xt_b.shape
    S = xs_b.shape[2]
    if (xt_b.shape != (G, 3, T) or xs_b.shape != (G, 3, S)
            or f_b.shape != (G, kernel.kdim0, S) or T % 8 or S % 128
            or (kernel.needs_normal
                and (ns_b is None or ns_b.shape != (G, 3, S)))):
        raise ValueError(f"p2p_ulist: xt_b {tuple(xt_b.shape)}, xs_b "
                         f"{tuple(xs_b.shape)}, f_b {tuple(f_b.shape)}, "
                         f"ns_b {None if ns_b is None else tuple(ns_b.shape)}"
                         f", kernel {kernel.name}")
    flat = lambda a: a.transpose(0, 1).reshape(a.shape[1], -1)
    full = torch.full((G,), S, dtype=torch.int32, device=xt_b.device)
    return (flat(xs_b), None if ns_b is None or not kernel.needs_normal
            else flat(ns_b), f_b.transpose(1, 2).reshape(-1, kernel.kdim0),
            box_ranges(full, S))


def p2p_ulist(kernel: KernelSpec, xt_b, xs, ns, f, srng=None, tcnt=None,
              fidx=None):
    """Per-box U-list P2P: box g's targets against its run of one flat
    source list.

    xt_b (G, 3, T): target coordinates per box.
    xs   (3, N): source coordinates; box g's sources are the columns
         srng[g, 0] <= j < srng[g, 1].
    ns   (3, N): source normals (None unless kernel.needs_normal).
    f    (rows, k0): densities; source j reads row fidx[j] (fidx None:
         row j).
    srng (G, 2) int32: [begin, end) of each box's sources.
    tcnt (G,) int32: each box's real targets, its first slots (None:
         all T); the slots past it come out zero.
    fidx (N,) int32 or None.
    -> (G, T, k1) unscaled potentials in the inputs' dtype.  One launch
    on the card: float32 or float64, one type for every float tensor.

    Without srng, the JAX function's padded form: xs (G, 3, S), ns
    (G, 3, S), f (G, k0, S) per box with zero density in padded slots,
    T % 8 == 0 and S % 128 == 0 as the Pallas kernel takes them; every
    slot is a source.
    """
    check_supported(kernel.name, TREE_KERNELS)
    if srng is None:
        xs, ns, f, srng = _ulist_from_padded(kernel, xt_b, xs, ns, f)
    G, _, T = xt_b.shape
    N = xs.shape[1]
    if (xt_b.shape != (G, 3, T) or xs.shape != (3, N) or f.dim() != 2
            or f.shape[1] != kernel.kdim0 or srng.shape != (G, 2)
            or (tcnt is not None and tcnt.shape != (G,))
            or (fidx is not None and fidx.shape != (N,))
            or (kernel.needs_normal
                and (ns is None or ns.shape != (3, N)))):
        raise ValueError(f"p2p_ulist: xt_b {tuple(xt_b.shape)}, xs "
                         f"{tuple(xs.shape)}, f {tuple(f.shape)}, ns "
                         f"{None if ns is None else tuple(ns.shape)}, srng "
                         f"{tuple(srng.shape)}, tcnt "
                         f"{None if tcnt is None else tuple(tcnt.shape)}, "
                         f"fidx {None if fidx is None else tuple(fidx.shape)}"
                         f", kernel {kernel.name}")
    ns = ns if kernel.needs_normal else None
    tensors = [t for t in (xt_b, xs, ns, f, srng, tcnt, fidx)
               if t is not None]
    if not on_cuda(*tensors):
        return p2p_ulist_plain(kernel, xt_b, xs, ns, f, srng, tcnt, fidx)
    dt = check_kernel_args("p2p_ulist", (torch.float32, torch.float64),
                           xt_b=xt_b, xs=xs, f=f,
                           **({} if ns is None else {"ns": ns}))
    check_index_args("p2p_ulist", srng=srng, tcnt=tcnt, fidx=fidx)
    out = torch.empty((G, T, kernel.kdim1), dtype=dt, device=xt_b.device)
    f64 = dt == torch.float64
    launch("sctl_p2p_ulist_f64" if f64 else "sctl_p2p_ulist",
           xt_b.data_ptr(), _ptr(tcnt), xs.data_ptr(), _ptr(ns),
           f.data_ptr(), _ptr(fidx), srng.data_ptr(), out.data_ptr(),
           FORMULA[kernel.name], G, T, N)
    p2p_ulist.launches += 1
    p2p_ulist.launches_f64 += f64
    return out


p2p_ulist.launches = 0
# the launches of the float64 build among them
p2p_ulist.launches_f64 = 0


def box_ranges(counts, width: int):
    """(B,) per-box counts -> (B, 2) int32 [begin, end) of each box's
    first `counts` slots in a flat array of `width` slots a box: the
    U-list kernel's source runs over box-major slots."""
    beg = torch.arange(counts.shape[0], device=counts.device) * width
    return torch.stack([beg, beg + counts.clamp(0, width)], 1) \
        .to(torch.int32)
