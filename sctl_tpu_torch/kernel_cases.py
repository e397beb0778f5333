"""Inputs for holding each CUDA kernel against its plain version, and
the counts of each kernel's bound.

The cases take their widths from a set-up `KIFMM` (source and target
slot capacities, slab group SL, the leaf-level check surface, the M2L
ranks) and a reduced count (4096 boxes, a 16^3 grid for M2L, a 16^3
grid for the slab stencil, an 8^3 grid for the halo stencil, whose
capacities are larger), so the plain versions stay small.
`kernel_cases` builds them for the KIFMM's own routes and kernel roles
(its M2L kernel, blocked or grid, and its near-field stencil), or for
one given formula (`formula_cases` runs every formula each pair kernel
takes).
The shared-surface and stencil cases' boxes hold their real points in
their first slots, as many as drawn around the KIFMM's mean counts
(Poisson), and the kernels get those counts (the slab stencil as a
compacted slab, `slab_index`).
The others are zero, as the padding of the main path is.  With
dtype=torch.float64 the pair kernels' cases ("stage[f64]",
"stage[kernel,f64]") run their float64 builds on the same inputs cast
to float64, held to the plain version in float64; M2L has no float64
build and no such case.

The U-list kernel's cases (`ulist_cases`) take their widths from a
set-up `AdaptiveFMM` instead: T = its target capacity, each box's real
targets and sources drawn around its U lists' means, on a reduced G =
32 boxes, one case per kernel formula and build (float32, float64).
The direct sum's cases (`p2p_cases`) are ParticleFMM's direct path
reduced: 4096 targets among 39,000 sources in the unit cube, for every
formula in float32 and float64.

`neighbour_lists` gives the U-list kernel the near field of a set-up
KIFMM (each box's 27 neighbours' real slots as one list), for holding
the two near-field ways against each other at the main path's size.

Data come from numpy's generator with a fixed seed.  Used by
`chip_smoke.py` and the card tests.

A `work` dict counts what the data need: pairs whose source has a
density (for P2P only neighbour boxes that exist) with the kernel's
per-pair operations (`KernelSpec.flops`, the JAX package's counts),
the flops of the nonzero operator blocks (with `tf32x3`: the M2L
kernels run them as three TF32 passes on the tensor cores), and each
input read and each output written once.  The M2L cases' operator
stacks are split for the tensor cores outside the timed call, as
`KIFMMOperators` does at setup.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.kernels import KERNELS
from .ops.m2l import (N_VALID, blocked_operands, grid_operands, m2l_grid,
                      m2l_grid_blocked, m2l_grid_blocked_plain,
                      m2l_grid_plain, m2l_windows, parity_offsets)
from .ops.p2p import (p2p, p2p_plain, p2p_stencil, p2p_stencil9,
                      p2p_stencil9_plain, p2p_stencil_plain, p2p_ulist,
                      p2p_ulist_plain, slab_gather, slab_index,
                      stencil9_fits, to_halo)
from .ops.sl import (l2t_surface, l2t_surface_plain, surface_pair,
                     surface_pair_plain)
from .ops.uker import L2T_KERNELS, S2M_KERNELS, SUPPORTED, TREE_KERNELS

N_BOXES, M2L_H, P2P_N, STENCIL_N, ULIST_G = 4096, 8, 16, 8, 32
P2P_T, P2P_S = 4096, 39_000


def _pair_work(kernel, pairs: int, dtype, floats: int, ints: int) -> dict:
    """A pair kernel's work in float32 or float64: `pairs` pairs of the
    kernel's operations; `floats` values of the type and `ints` int32
    counts read or written once."""
    return dict(pairs=pairs, pair_flops=kernel.flops,
                f64=dtype == torch.float64,
                bytes=dtype.itemsize * floats + 4 * ints)


def surface_pair_work(kernel, ns: int, B: int, n_src: int,
                      dtype=torch.float32) -> dict:
    """The real sources' pairs with the surface; bytes of the surface,
    the real sources, the counts and the outputs, each once."""
    return _pair_work(kernel, n_src * ns, dtype,
                      3 * ns + kernel.src_floats * n_src
                      + kernel.kdim1 * ns * B, B)


def l2t_surface_work(kernel, ns: int, B: int, cap_t: int, n_trg: int,
                     dtype=torch.float32) -> dict:
    """The real targets' pairs with the surface; bytes of the surface,
    the real targets, the densities, the counts and the whole output
    (zeros past the counts), each once."""
    return _pair_work(kernel, n_trg * ns, dtype,
                      3 * ns + 3 * n_trg + kernel.kdim0 * ns * B
                      + kernel.kdim1 * B * cap_t, B)


def p2p_stencil9_work(kernel, pairs: int, n: int, cap_t: int, n_trg: int,
                      n_slots: int, dtype=torch.float32) -> dict:
    """The real pairs; bytes of the real targets, the whole output
    (zeros past the counts), the slab entries' real slots and the two
    count arrays, each once."""
    return _pair_work(kernel, pairs, dtype,
                      3 * n_trg + kernel.kdim1 * n ** 3 * cap_t
                      + kernel.src_floats * n_slots,
                      n ** 3 + n * n * (n + 2))


def p2p_stencil_work(kernel, pairs: int, n: int, cap_t: int, n_trg: int,
                     n_src: int, dtype=torch.float32) -> dict:
    """The real pairs; bytes of the real targets and sources, the two
    count arrays and the whole output (zeros past the counts), each
    once."""
    return _pair_work(kernel, pairs, dtype,
                      3 * n_trg + kernel.kdim1 * n ** 3 * cap_t
                      + kernel.src_floats * n_src, 2 * n ** 3)


def m2l_grid_work(n: int, r: int, r2: int) -> dict:
    """Flops of each box's 189 (r2, r) products over the n^3 grid,
    bytes of qp, the 316-offset stack and the output; `tf32x3`: the
    flops run as three TF32 passes on the tensor cores."""
    return dict(flops=2 * n ** 3 * N_VALID * r * r2, tf32x3=True,
                bytes=4 * ((n + 6) ** 3 * r2 + 316 * r2 * r + n ** 3 * r))


def m2l_grid_blocked_work(h: int, mats_blk: torch.Tensor) -> dict:
    """Flops of the nonzero (r2, r) blocks of the 26 operators over h^3
    parents, bytes of qp, the operators and the output; `tf32x3` as in
    `m2l_grid_work`."""
    _, K, N = mats_blk.shape
    blk = mats_blk.reshape(26, 8, K // 8, 8, N // 8)
    nz = int((blk.abs().amax(dim=(2, 4)) > 0).sum())
    return dict(flops=2 * h ** 3 * nz * (K // 8) * (N // 8), tf32x3=True,
                bytes=4 * ((h + 2) ** 3 * K + mats_blk.numel()
                           + h ** 3 * N))


def p2p_ulist_work(kernel, pairs: int, n_trg: int, n_src: int,
                   dtype: torch.dtype = torch.float32) -> dict:
    """The kernel's operations (and in float32 one rsqrt) per needed
    pair, in float32 or float64; bytes of the real targets and their
    output and of the real sources (point, density, and the normal for
    the double layer, a source once in each list that holds it), each
    once."""
    nb = 8 if dtype == torch.float64 else 4
    return dict(pairs=pairs, pair_flops=kernel.flops,
                f64=dtype == torch.float64,
                bytes=nb * ((3 + kernel.kdim1) * n_trg
                            + kernel.src_floats * n_src))


def p2p_work(kernel, dtype: torch.dtype, n_trg: int, n_src: int) -> dict:
    """Every (target, source) pair with the kernel's operations, in
    float32 or float64; each target, source and output once."""
    nb = 8 if dtype == torch.float64 else 4
    return dict(pairs=n_trg * n_src, pair_flops=kernel.flops,
                f64=dtype == torch.float64,
                bytes=nb * ((3 + kernel.kdim1) * n_trg
                            + kernel.src_floats * n_src))


def _ulist_counts(af):
    """(real targets, real sources) of each leaf's U list of a set-up
    AdaptiveFMM."""
    rng = af.ul_rng.cpu().numpy().astype(np.int64)
    return af.ul_tcnt.cpu().numpy().astype(np.int64), rng[:, 1] - rng[:, 0]


def ulist_main_work(af) -> dict:
    """The U-list kernel's work in one apply of a set-up AdaptiveFMM, in
    its dtype: pairs of each leaf's real targets with its U list's real
    sources; bytes of those targets and sources as the launch reads
    them (a source once in each U list that holds it)."""
    tcnt, near = _ulist_counts(af)
    return p2p_ulist_work(af.ker_s2t, int((tcnt * near).sum()),
                          int(tcnt.sum()), int(near.sum()), af.dtype)


def ulist_cases(af, seed: int = 0) -> dict:
    """kernel name -> (kernel call, plain call, None, work) of
    `p2p_ulist` at the widths of the set-up AdaptiveFMM `af` on
    ULIST_G boxes, on its device: T = af's target capacity, each box's
    real targets and sources drawn around af's means (Poisson), the
    targets in a box of the leaves' mean size, the sources in the 27
    boxes around it, their densities read through a shuffled index.
    "name" runs the float32 build, "name[f64]" the float64 build on the
    same inputs in float64."""
    rng = np.random.default_rng(seed)
    dev = af.device
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    G, T = ULIST_G, af.cap_t
    tcnt_af, near_af = _ulist_counts(af)
    tcnt = np.minimum(rng.poisson(tcnt_af.mean(), G), T)
    scnt = rng.poisson(near_af.mean(), G)
    N = int(scnt.sum())
    ends = np.cumsum(scnt)
    srng = i32(np.stack([ends - scnt, ends], 1))
    side = af.tree.scale / 2 ** np.mean(af.tree.leaf_levels)
    xt = f32(rng.random((G, 3, T)) * side)
    xs = f32((rng.random((3, N)) * 3 - 1) * side)
    nrm = f32(_unit_normals(rng, (3, N), 0))
    fidx = rng.permutation(N + 7)[:N]
    cases = {}
    for name in TREE_KERNELS:
        ker = KERNELS[name]
        f = f32(rng.normal(size=(N + 7, ker.kdim0)))
        a32 = (xt, xs, nrm if ker.needs_normal else None, f, srng,
               i32(tcnt), i32(fidx))
        for tag, dt in (("", torch.float32), ("[f64]", torch.float64)):
            a = _cast(a32, dt)
            cases[name + tag] = (
                lambda ker=ker, a=a: p2p_ulist(ker, *a),
                lambda dtype=None, ker=ker, a=a: p2p_ulist_plain(
                    ker, *_cast(a, dtype)), None,
                p2p_ulist_work(ker, int((tcnt * scnt).sum()),
                               int(tcnt.sum()), N, dt))
    return cases


def _near_counts(cnt: np.ndarray) -> np.ndarray:
    """(n, n, n) per-box counts -> the sums over each box's existing
    27 neighbours (itself included)."""
    n = cnt.shape[0]
    c = np.pad(cnt, 1)
    return sum(c[1 + dx:1 + dx + n, 1 + dy:1 + dy + n, 1 + dz:1 + dz + n]
               for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1))


def near_kernel(kf) -> str:
    """The near-field kernel of a set-up KIFMM's route."""
    return "p2p_" + kf.near_route


def m2l_kernel(kf):
    """The M2L kernel of a set-up KIFMM's route at levels >= 3, or None
    for the per-parity sweep and for a tree of depth 2."""
    if kf.depth < 3:
        return None
    return {"blocked": "m2l_grid_blocked",
            "grid": "m2l_grid"}.get(kf._ops.m2l_route)


def main_path_work(kf) -> dict:
    """Counts of each kernel's work on a set-up KIFMM's own data, in its
    dtype: the shared-surface kernels, the route's M2L kernel at the
    leaf level (the blocked one on its parent grid) and the route's
    near-field stencil, pairs of real targets with the real sources of
    their neighbour boxes."""
    ops = kf._ops
    ns = ops.n_surf
    cs = np.minimum(kf.src_tree.box_cnt, kf.cap_s)
    ct = np.minimum(kf.trg_tree.box_cnt, kf.cap_t)
    nb = kf.src_tree.neighbor_boxes()
    near = np.where(nb >= 0, cs[np.maximum(nb, 0)], 0).sum(axis=1)
    B, n = kf.src_tree.n_boxes, 1 << kf.depth
    pairs = int((ct * near).sum())
    dt = kf.dtype
    work = {
        "surface_pair": surface_pair_work(kf.ker_s2m, ns, B, int(cs.sum()),
                                          dt),
        "l2t_surface": l2t_surface_work(kf.ker_l2t, ns, B, kf.cap_t,
                                        int(ct.sum()), dt),
    }
    if kf.near_route == "stencil9":
        work["p2p_stencil9"] = p2p_stencil9_work(
            kf.ker_s2t, pairs, n, kf.cap_t, int(ct.sum()),
            int(kf.cnt9.sum()), dt)
    else:
        work["p2p_stencil"] = p2p_stencil_work(
            kf.ker_s2t, pairs, n, kf.cap_t, int(ct.sum()), int(cs.sum()),
            dt)
    if m2l_kernel(kf) == "m2l_grid_blocked":
        work["m2l_grid_blocked"] = m2l_grid_blocked_work(n // 2,
                                                         ops.m2l_blk)
    elif m2l_kernel(kf) == "m2l_grid":
        work["m2l_grid"] = m2l_grid_work(n, ops.blk_r, ops.blk_r2)
    return work


def _cast(args, dtype):
    """args with their floating tensors in `dtype` (None: unchanged): the
    redesigned kernels' cases also evaluate their plain version in
    float64 on the same inputs (`plain(torch.float64)`)."""
    if dtype is None:
        return args
    return tuple(a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _unit_normals(rng, shape, axis):
    n = rng.normal(size=shape)
    return n / np.linalg.norm(n, axis=axis, keepdims=True)


def kernel_cases(kf, seed: int = 0, kernel=None,
                 dtype: torch.dtype = torch.float32) -> dict:
    """name -> (kernel call, plain call, library call or None, work) at
    the widths of the set-up KIFMM `kf`, on its device.  Each call takes
    no argument and returns a tensor; the library call is one PyTorch
    call computing the same function (timed as a yardstick only).
    Without `kernel`, the kernels of kf's main path (its M2L kernel by
    its route, none for the per-parity sweep; its near-field stencil by
    its route) with its own kernel roles; with it, the pair kernels that
    take that formula, in it (no M2L).  dtype float64: the pair kernels'
    float64 builds on the float32 cases' inputs cast to float64, named
    "stage[f64]" (no M2L)."""
    rng = np.random.default_rng(seed)
    dev = kf.device
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev).to(dtype)
    tag = "[f64]" if dtype == torch.float64 else ""
    cap_s, cap_t, SL = kf.cap_s, kf.cap_t, kf.SL
    lam = kf.scale / (1 << kf.depth)
    mean_s = np.minimum(kf.src_tree.box_cnt, cap_s).mean()
    mean_t = np.minimum(kf.trg_tree.box_cnt, cap_t).mean()
    surf = kf.surf_out_L
    ns = surf.shape[0]
    near = near_kernel(kf)
    roles = ({"surface_pair": kf.ker_s2m, "l2t_surface": kf.ker_l2t,
              near: kf.ker_s2t} if kernel is None else
             {stage: kernel for stage, names in (
                 ("surface_pair", S2M_KERNELS),
                 ("l2t_surface", L2T_KERNELS),
                 (near, TREE_KERNELS)) if kernel.name in names})
    cases = {}

    B = N_BOXES
    box_counts = lambda mean, cap: np.minimum(rng.poisson(mean, B), cap)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    ker = roles.get("surface_pair")
    if ker is not None:
        # each box's real sources are its first slots, as in the KIFMM
        cnt_s = box_counts(mean_s, cap_s)
        vs = np.arange(cap_s) < cnt_s[:, None]
        xs = (rng.random((B, cap_s, 3)) - 0.5) * lam
        slots = lambda a: f32(a.transpose(2, 0, 1).reshape(a.shape[2], -1))
        pts = slots(xs)
        nrm = (slots(_unit_normals(rng, (B, cap_s, 3), 2))
               if ker.needs_normal else None)
        fl = slots(rng.normal(size=(B, cap_s, ker.kdim0)) * vs[..., None])
        a = (ker, surf.to(dtype), pts, fl, cap_s, nrm, i32(cnt_s))
        cases["surface_pair" + tag] = (
            lambda a=a: surface_pair(*a),
            lambda dtype=None, a=a: surface_pair_plain(*_cast(a, dtype)),
            None, surface_pair_work(ker, ns, B, int(cnt_s.sum()), dtype))

    kl = roles.get("l2t_surface")
    if kl is not None:
        cnt_t = box_counts(mean_t, cap_t)
        xt = (rng.random((B, cap_t, 3)) - 0.5) * lam
        xtl = f32(xt.transpose(2, 0, 1).reshape(3, -1))
        q = f32(rng.normal(size=(kl.kdim0, ns, B)))
        a = (kl, surf.to(dtype), xtl, q, cap_t, i32(cnt_t))
        cases["l2t_surface" + tag] = (
            lambda a=a: l2t_surface(*a),
            lambda dtype=None, a=a: l2t_surface_plain(*_cast(a, dtype)),
            None, l2t_surface_work(kl, ns, B, cap_t, int(cnt_t.sum()),
                                   dtype))

    m2l = (m2l_kernel(kf) if kernel is None and dtype == torch.float32
           else None)
    if m2l == "m2l_grid_blocked":
        h, K, N = M2L_H, 8 * kf._ops.blk_r2, 8 * kf._ops.blk_r
        mats = f32(rng.normal(size=(26, K, N)) / np.sqrt(K))
        qp = np.zeros((h + 2,) * 3 + (K,))
        qp[1:-1, 1:-1, 1:-1] = rng.normal(size=(h, h, h, K))
        qp = f32(qp)
        wins = torch.stack(m2l_windows(qp))
        mtc = blocked_operands(mats)        # at setup, as KIFMMOperators
        cases[m2l] = (
            lambda: m2l_grid_blocked(qp, mats, mtc),
            lambda: m2l_grid_blocked_plain(qp, mats),
            lambda: torch.matmul(wins, mats).sum(0),
            m2l_grid_blocked_work(h, mats))
    elif m2l == "m2l_grid":
        n, r, r2 = 2 * M2L_H, kf._ops.blk_r, kf._ops.blk_r2
        mats = f32(rng.normal(size=(316, r2, r)) / np.sqrt(r2))
        qp = np.zeros((n + 6,) * 3 + (r2,))
        qp[3:-3, 3:-3, 3:-3] = rng.normal(size=(n, n, n, r2))
        qp = f32(qp)
        wins, mcat = _parity_windows(qp, mats)
        mtc = grid_operands(mats)
        cases[m2l] = (
            lambda: m2l_grid(qp, mats, mtc),
            lambda: m2l_grid_plain(qp, mats),
            lambda: torch.matmul(wins, mcat), m2l_grid_work(n, r, r2))

    kn = roles.get(near)
    if (kn is not None and near == "p2p_stencil9"
            and not stencil9_fits(kn, cap_t, SL, dtype)):
        kn = None       # a KIFMM of these widths takes the halo stencil
    if kn is not None:
        n = P2P_N if near == "p2p_stencil9" else STENCIL_N
        lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                      -1).reshape(-1, 1, 3)
        # each box's real points are its first slots, as in the KIFMM
        cnt_s = np.minimum(rng.poisson(mean_s, n ** 3), cap_s)
        cnt_t = np.minimum(rng.poisson(mean_t, n ** 3), cap_t)
        xs_b = (lo + rng.random((n ** 3, cap_s, 3))) * lam
        vs_b = np.arange(cap_s) < cnt_s[:, None]
        f_b = rng.normal(size=(n ** 3, cap_s, kn.kdim0)) * vs_b[..., None]
        xt_b = (lo + rng.random((n ** 3, cap_t, 3))) * lam
        ident = torch.arange(n ** 3, device=dev)
        nrm_b = (_unit_normals(rng, (n ** 3, cap_s, 3), 2)
                 if kn.needs_normal else None)
        xt_g = f32(xt_b.reshape(n, n, n, cap_t, 3)
                   .transpose(0, 1, 2, 4, 3))
        near_s = _near_counts(cnt_s.reshape(n, n, n)).reshape(-1)
        pairs = int((cnt_t * near_s).sum())
        cnt = lambda c: torch.as_tensor(c.reshape(n, n, n).astype(
            np.int32), device=dev)
        if near == "p2p_stencil9":
            # each entry's real points first, as the KIFMM lays them out
            idx, cnt9 = slab_index(ident, n, cap_s, SL, cnt(cnt_s))
            lay = lambda a: slab_gather(f32(a), idx)
            a = (kn, n, SL, cap_t, xt_g, lay(xs_b), lay(f_b),
                 None if nrm_b is None else lay(nrm_b), cnt9, cnt(cnt_t))
            cases[near + tag] = (lambda a=a: p2p_stencil9(*a),
                                 lambda dtype=None, a=a: p2p_stencil9_plain(
                                     *_cast(a, dtype)), None,
                                 p2p_stencil9_work(kn, pairs, n, cap_t,
                                                   int(cnt_t.sum()),
                                                   int(cnt9.sum()), dtype))
        else:
            lay = lambda a: to_halo(f32(a), ident, n)
            a = (kn, n, cap_s, cap_t, xt_g, lay(xs_b), lay(f_b),
                 None if nrm_b is None else lay(nrm_b), cnt(cnt_s),
                 cnt(cnt_t))
            cases[near + tag] = (lambda a=a: p2p_stencil(*a),
                                 lambda dtype=None, a=a: p2p_stencil_plain(
                                     *_cast(a, dtype)), None,
                                 p2p_stencil_work(kn, pairs, n, cap_t,
                                                  int(cnt_t.sum()),
                                                  int(cnt_s.sum()), dtype))
    return cases


def _parity_windows(qp, mats_t):
    """The library yardstick's inputs of `m2l_grid`: per parity, its
    boxes' 189 source rows side by side (8, h^3, 189 r2) and its
    offsets' operators stacked (8, 189 r2, r), so that one batched
    product computes the function (the per-parity sweep's products)."""
    n = qp.shape[0] - 6
    wins, mcat = [], []
    for c, offs in enumerate(parity_offsets()):
        cx, cy, cz = (c >> 2) & 1, (c >> 1) & 1, c & 1
        wins.append(torch.cat([
            qp[3 + cx + dx:3 + cx + dx + n:2, 3 + cy + dy:3 + cy + dy + n:2,
               3 + cz + dz:3 + cz + dz + n:2].reshape((n // 2) ** 3, -1)
            for dx, dy, dz, _ in offs.tolist()], 1))
        mcat.append(mats_t[torch.as_tensor(offs[:, 3].astype(np.int64),
                                           device=qp.device)]
                    .reshape(-1, mats_t.shape[-1]))
    return torch.stack(wins), torch.stack(mcat)


def formula_cases(kf, seed: int = 0, stages=None,
                  dtype: torch.dtype = torch.float32) -> dict:
    """"stage[kernel]" ("stage[kernel,f64]" in float64) -> case of
    `kernel_cases` for every formula each pair kernel of the uniform
    KIFMM takes (those of `stages` only, when given), at kf's widths."""
    tag = ",f64" if dtype == torch.float64 else ""
    return {f"{key.split('[')[0]}[{name}{tag}]": case
            for name in TREE_KERNELS
            for key, case in kernel_cases(kf, seed, KERNELS[name],
                                          dtype).items()
            if stages is None or key.split("[")[0] in stages}


def p2p_cases(device, seed: int = 0, n_trg: int = P2P_T,
              n_src: int = P2P_S) -> dict:
    """"p2p[kernel,dtype]" -> (kernel call, plain call, None, work) of the
    direct sum for every formula in float32 and float64: sources and
    unit normals uniform in the unit cube, the first n_trg of them also
    the targets (so self pairs are masked), normal densities."""
    rng = np.random.default_rng(seed)
    xs = rng.random((n_src, 3))
    nrm = _unit_normals(rng, (n_src, 3), 1)
    cases = {}
    for dt in (torch.float32, torch.float64):
        T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
        X, N = T(xs), T(nrm)
        for name in SUPPORTED:
            ker = KERNELS[name]
            f = T(rng.normal(size=(n_src, ker.kdim0)))
            ns = N if ker.needs_normal else None
            a = (ker, X[:n_trg], X, ns, f)
            tag = "f64" if dt == torch.float64 else "f32"
            cases[f"p2p[{name},{tag}]"] = (
                lambda a=a: p2p(*a), lambda a=a: p2p_plain(*a), None,
                p2p_work(ker, dt, n_trg, n_src))
    return cases


def rel_max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def neighbour_lists(kf, fp):
    """The U-list kernel's arguments for the near field of a set-up
    KIFMM on padded densities fp (B, cap_s, k0): each box's 27
    neighbours' real slots as one flat list (coordinates as the boxes
    hold them, densities read through the slot index), Morton order."""
    B, cs = kf.src_tree.n_boxes, kf.cap_s
    cnt = torch.as_tensor(np.minimum(kf.src_tree.box_cnt, cs),
                          device=kf.device)
    nbc = kf.nb.clamp(min=0)
    c27 = torch.where(kf.nb >= 0, cnt[nbc], 0).reshape(-1)
    run0 = torch.cumsum(c27, 0) - c27
    slot = (torch.repeat_interleave(nbc.reshape(-1) * cs - run0, c27)
            + torch.arange(int(c27.sum()), device=kf.device))
    per_box = c27.reshape(B, 27).sum(1)
    ends = torch.cumsum(per_box, 0)
    return (kf.xt_pad.transpose(1, 2).contiguous(),
            kf.xs_pad.reshape(-1, 3)[slot].T.contiguous(), None,
            fp.reshape(-1, fp.shape[-1]),
            torch.stack([ends - per_box, ends], 1).to(torch.int32),
            kf.cnt_t_box, slot.to(torch.int32))
