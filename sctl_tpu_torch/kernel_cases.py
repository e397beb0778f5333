"""Inputs for holding each CUDA kernel against its plain version, and
the counts of each kernel's bound.

The U-list kernel's cases (`ulist_cases`) take their widths from a
set-up `AdaptiveFMM` instead: T = its target capacity, S = its U-list
budget (source leaves per target leaf times the source capacity,
padded to 128), on a reduced G = 32 boxes, one case per kernel formula.

The cases take their widths from a set-up `KIFMM` (source and target
slot capacities, slab group SL, the leaf-level check surface, the M2L
ranks) and a reduced count (4096 boxes, a parent grid of h = 8 for
M2L, a 16^3 grid for P2P), so the plain versions stay small.
Source slots hold a density as often as the KIFMM's leaves fill theirs
on average; the others are zero, as the padding of the main path is.
Data come from numpy's generator with a fixed seed.  Used by
`chip_smoke.py` and the card tests.

A `work` dict counts what the data need: pairs whose source has a
density (for P2P only neighbour boxes that exist), the flops of the
nonzero operator blocks, and each input read and each output written
once.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.kernels import KERNELS, Laplace3D_FxU
from .ops.m2l import m2l_grid_blocked, m2l_grid_blocked_plain, m2l_windows
from .ops.p2p import (ULIST_KERNELS, p2p_stencil9, p2p_stencil9_plain,
                      p2p_ulist, p2p_ulist_plain, to_slab)
from .ops.sl import (l2t_surface, l2t_surface_plain, surface_pair,
                     surface_pair_plain)

N_BOXES, M2L_H, P2P_N, ULIST_G = 4096, 8, 16, 32

# f32 flops per pair of csrc/p2p_ulist.cu (an FMA counts 2): the
# difference (3) and r2 (5), then Laplace the density FMA (2); Stokes
# DxU r.f and r.n (5 each), the 1/r^5 and weight products (5) and three
# FMAs (6); Stokes FSxU r.f (5), 1/r^2, 1/r^3 and the weight (4) and
# six FMAs (12)
ULIST_PAIR_FLOPS = {"Laplace3D-FxU": 10, "Stokes3D-DxU": 29,
                    "Stokes3D-FSxU": 29}


def surface_pair_work(pairs: int, ns: int, B: int, cap: int) -> dict:
    return dict(pairs=pairs, bytes=4 * (3 * ns + 4 * B * cap + ns * B))


def l2t_surface_work(pairs: int, ns: int, B: int, cap_t: int) -> dict:
    return dict(pairs=pairs, bytes=4 * (3 * ns + 4 * B * cap_t + ns * B))


def p2p_stencil9_work(pairs: int, n: int, cap_t: int, SL: int) -> dict:
    return dict(pairs=pairs, bytes=4 * (4 * n ** 3 * cap_t
                                        + 4 * n * n * (n + 2) * SL))


def m2l_grid_blocked_work(h: int, mats_blk: torch.Tensor) -> dict:
    """Flops of the nonzero (r2, r) blocks of the 26 operators over h^3
    parents, bytes of qp, the operators and the output."""
    _, K, N = mats_blk.shape
    blk = mats_blk.reshape(26, 8, K // 8, 8, N // 8)
    nz = int((blk.abs().amax(dim=(2, 4)) > 0).sum())
    return dict(flops=2 * h ** 3 * nz * (K // 8) * (N // 8),
                bytes=4 * ((h + 2) ** 3 * K + mats_blk.numel()
                           + h ** 3 * N))


def p2p_ulist_work(kernel, pairs: int, n_trg: int, n_src: int) -> dict:
    """One rsqrt and ULIST_PAIR_FLOPS flops per needed pair; bytes of
    the real targets and their output and of the real source slots
    (point, density, and the normal for the double layer), each once:
    the padded slots carry nothing the function needs."""
    nsrc = 3 + kernel.kdim0 + (3 if kernel.needs_normal else 0)
    return dict(pairs=pairs, pair_flops=ULIST_PAIR_FLOPS[kernel.name],
                bytes=4 * ((3 + kernel.kdim1) * n_trg + nsrc * n_src))


def _ulist_sources(af) -> np.ndarray:
    """Real source points in each leaf's U list of an AdaptiveFMM."""
    rows = af.ul_rows.cpu().numpy()
    ok = af.ul_ok.cpu().numpy() > 0
    return (af.tree.leaf_cnt[rows] * ok).sum(axis=1)


def ulist_main_work(af) -> dict:
    """The U-list kernel's work in one apply of a set-up AdaptiveFMM:
    pairs of each leaf's real targets with its U list's real sources;
    bytes of those targets and sources as the launches see them (a
    source once in each U list that holds it)."""
    tcnt = np.bincount(af.t_take.cpu().numpy() // af.cap_t,
                       minlength=af.n_leaf)
    near = _ulist_sources(af)
    return p2p_ulist_work(af.ker_s2t, int((tcnt * near).sum()),
                          int(tcnt.sum()), int(near.sum()))


def ulist_cases(af, seed: int = 0) -> dict:
    """kernel name -> (kernel call, plain call, None, work) of
    `p2p_ulist` at the widths of the set-up AdaptiveFMM `af` on
    ULIST_G boxes, on its device.  Targets fill a box of the leaves'
    mean size, sources the 27 boxes around it; a source slot holds a
    density as often as af's U-list slots hold a point."""
    rng = np.random.default_rng(seed)
    dev = af.device
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    G, T, S = ULIST_G, af.ul_T, af.ul_S
    fill = _ulist_sources(af).mean() / S
    side = af.tree.scale / 2 ** np.mean(af.tree.leaf_levels)
    xt = rng.random((G, 3, T)) * side
    xs = (rng.random((G, 3, S)) * 3 - 1) * side
    nrm = rng.normal(size=(G, 3, S))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    real = rng.random((G, S)) < fill
    cases = {}
    for name in ULIST_KERNELS:
        ker = KERNELS[name]
        f = rng.normal(size=(G, ker.kdim0, S)) * real[:, None, :]
        a = (f32(xt), f32(xs), f32(nrm) if ker.needs_normal else None,
             f32(f))
        cases[name] = (
            lambda ker=ker, a=a: p2p_ulist(ker, *a),
            lambda ker=ker, a=a: p2p_ulist_plain(ker, *a), None,
            p2p_ulist_work(ker, T * int(real.sum()), G * T,
                           int(real.sum())))
    return cases


def _near_counts(cnt: np.ndarray) -> np.ndarray:
    """(n, n, n) per-box counts -> the sums over each box's existing
    27 neighbours (itself included)."""
    n = cnt.shape[0]
    c = np.pad(cnt, 1)
    return sum(c[1 + dx:1 + dx + n, 1 + dy:1 + dy + n, 1 + dz:1 + dz + n]
               for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1))


def main_path_work(kf) -> dict:
    """Counts of each kernel's work on a set-up KIFMM's own data (the
    M2L one at the leaf level's parent grid)."""
    ns = kf._ops.n_surf
    cs = np.minimum(kf.src_tree.box_cnt, kf.cap_s)
    ct = np.minimum(kf.trg_tree.box_cnt, kf.cap_t)
    nb = kf.src_tree.neighbor_boxes()
    near = np.where(nb >= 0, cs[np.maximum(nb, 0)], 0).sum(axis=1)
    B, n = kf.src_tree.n_boxes, 1 << kf.depth
    return {
        "surface_pair": surface_pair_work(int(cs.sum()) * ns, ns, B,
                                          kf.cap_s),
        "l2t_surface": l2t_surface_work(int(ct.sum()) * ns, ns, B,
                                        kf.cap_t),
        "m2l_grid_blocked": m2l_grid_blocked_work(n // 2,
                                                  kf._ops.m2l_blk),
        "p2p_stencil9": p2p_stencil9_work(int((ct * near).sum()), n,
                                          kf.cap_t, kf.SL),
    }


def kernel_cases(kf, seed: int = 0) -> dict:
    """name -> (kernel call, plain call, library call or None, work) at
    the widths of the set-up float32 KIFMM `kf`, on its device.  Each
    call takes no argument and returns a tensor; the library call is
    one PyTorch call computing the same function (timed as a yardstick
    only)."""
    rng = np.random.default_rng(seed)
    ker, dev = Laplace3D_FxU, kf.device
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    cap_s, cap_t, SL = kf.cap_s, kf.cap_t, kf.SL
    lam = kf.scale / (1 << kf.depth)
    fill = np.minimum(kf.src_tree.box_cnt, cap_s).mean() / cap_s
    surf = kf.surf_out_L
    ns = surf.shape[0]
    cases = {}

    B = N_BOXES
    xs = (rng.random((B, cap_s, 3)) - 0.5) * lam
    vs = rng.random((B, cap_s)) < fill
    pts = f32(xs.transpose(2, 0, 1).reshape(3, -1))
    fl = f32((rng.normal(size=(B, cap_s)) * vs).reshape(1, -1))
    cases["surface_pair"] = (
        lambda: surface_pair(ker, surf, pts, fl, cap_s),
        lambda: surface_pair_plain(ker, surf, pts, fl, cap_s), None,
        surface_pair_work(int(vs.sum()) * ns, ns, B, cap_s))

    xt = (rng.random((B, cap_t, 3)) - 0.5) * lam
    xtl = f32(xt.transpose(2, 0, 1).reshape(3, -1))
    q = f32(rng.normal(size=(1, ns, B)))
    cases["l2t_surface"] = (
        lambda: l2t_surface(ker, surf, xtl, q, cap_t),
        lambda: l2t_surface_plain(ker, surf, xtl, q, cap_t), None,
        l2t_surface_work(B * cap_t * ns, ns, B, cap_t))

    h, K, N = M2L_H, 8 * kf._ops.blk_r2, 8 * kf._ops.blk_r
    mats = f32(rng.normal(size=(26, K, N)) / np.sqrt(K))
    qp = np.zeros((h + 2,) * 3 + (K,))
    qp[1:-1, 1:-1, 1:-1] = rng.normal(size=(h, h, h, K))
    qp = f32(qp)
    wins = torch.stack(m2l_windows(qp))
    cases["m2l_grid_blocked"] = (
        lambda: m2l_grid_blocked(qp, mats),
        lambda: m2l_grid_blocked_plain(qp, mats),
        lambda: torch.matmul(wins, mats).sum(0),
        m2l_grid_blocked_work(h, mats))

    n = P2P_N
    lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                  -1).reshape(-1, 1, 3)
    xs_b = (lo + rng.random((n ** 3, cap_s, 3))) * lam
    vs_b = rng.random((n ** 3, cap_s)) < fill
    f_b = rng.normal(size=(n ** 3, cap_s, 1)) * vs_b[..., None]
    xt_b = (lo + rng.random((n ** 3, cap_t, 3))) * lam
    ident = torch.arange(n ** 3, device=dev)
    xs_s = to_slab(f32(xs_b), ident, n, SL).contiguous()
    f_s = to_slab(f32(f_b), ident, n, SL).contiguous()
    xt_g = f32(xt_b.reshape(n, n, n, cap_t, 3).transpose(0, 1, 2, 4, 3))
    near = _near_counts(vs_b.sum(axis=1).reshape(n, n, n))
    cases["p2p_stencil9"] = (
        lambda: p2p_stencil9(ker, n, SL, cap_t, xt_g, xs_s, f_s),
        lambda: p2p_stencil9_plain(ker, n, SL, cap_t, xt_g, xs_s, f_s),
        None,
        p2p_stencil9_work(cap_t * int(near.sum()), n, cap_t, SL))
    return cases


def rel_max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())
