"""Kernel-independent FMM on a uniform Morton tree, in PyTorch
(counterpart of sctl_tpu/fmm/kifmm.py), for the six kernels with a
tree path: Laplace3D-FxU, -DxU and -FxdU translate with Laplace3D-FxU,
Stokes3D-FxU, -DxU and -FSxU with Stokes3D-FSxU (`kernel_roles`).

The evaluation follows the JAX package's TPU route stage by stage:

  S2M  shared-surface check potentials over each box's real sources
       (ops/sl.py `surface_pair`, by `cnt_s_box`), then
       q_up = uc2e q_check
  M2M  one concatenated matrix product per level
  M2L  levels >= 3 in float32, by the operator stacks' sizes as the
       JAX package chooses (`m2l_route`): the sibling-blocked V list on
       the parent grid (ops/m2l.py `m2l_grid_blocked`; Laplace p <= 6),
       else the 316-offset grid sweep (ops/m2l.py `m2l_grid`; Laplace
       p = 8), else the per-parity sweep as batched matrix products, as
       the JAX package's scan runs it outside Pallas (Stokes); level 2
       always the per-parity sweep.  float64: the per-parity sweep at
       the exact ranks at every level, the JAX package's float64 route
  L2L  one concatenated matrix product per level
  L2T  shared-surface evaluation at each box's real targets (ops/sl.py
       `l2t_surface`, by `cnt_t_box`; zero past them)
  P2P  packed 9-column slab stencil (ops/p2p.py `p2p_stencil9`) where
       its block holds the box capacities, each slab entry compacted
       to its real points at setup (`slab_idx`, `cnt9`), else the
       stencil over 9 shifted halo columns (ops/p2p.py `p2p_stencil`),
       which takes any capacities; both read each box's real slots
       only, by the per-box counts set up once (`cnt_s_rast`,
       `cnt_t_rast`)

The shared-surface route takes a box count that is a multiple of 128
(depth >= 3) and the capacities of the rules `surface_pair_fits` and
`l2t_surface_fits` (a few hundred points a leaf, fewer for the double
layers; the kernels themselves take any capacity); otherwise S2M and
L2T go through the per-box U-list kernel over each box's real slots
(ops/p2p.py `p2p_ulist`), as the JAX package does over padded ones
(sctl_tpu/fmm/kifmm.py:1095-1108, :1316-1326).  The slab stencil's
block holds at most 256 target slots and a slab window within the
shared memory (a few hundred points a leaf, fewer for the kernels with
more values a slot); beyond that the near field takes the halo
stencil.

Box capacities are quantiles of the box counts; the points beyond them
travel in overflow sidebands evaluated in plain torch.  Tensors on the
card go through the CUDA kernels, tensors on the CPU through their
plain versions; the routes follow the dtype and the shapes, never the
device, and every pair kernel has a float32 and a float64 build.  The
operator tables are built cold on the host in float64, once per
process for each (translation kernel, p, rcond, hiprec) (`unit_tables`;
no disk cache is written).  With hiprec the pseudo-inverses and the
M2L tables are refined in 80-bit longdouble, or read from the committed
lite table file in the data directory (`config.data_path`) where there
is one.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import profile
from ..config import data_path, resolve_device
from ..ops._launch_checks import CHUNK_PAIRS
from ..ops.kernels import (KERNELS, KernelSpec, Laplace3D_FxdU,
                           Laplace3D_FxU, Stokes3D_FSxU)
from ..ops.kernels_np import full_matrix_np
from ..ops.m2l import (blocked_m2l_mats, blocked_operands, grid_operands,
                       m2l_grid, m2l_grid_blocked)
from ..ops.m2l import vlist_offsets as _vlist_offsets
from ..ops.p2p import (box_ranges, p2p_stencil, p2p_stencil9, p2p_ulist,
                       slab_gather, slab_index, stencil9_fits, to_halo)
from ..ops.sl import (l2t_surface, l2t_surface_fits, surface_pair,
                      surface_pair_fits)
from ..ops.uker import TREE_KERNELS, check_supported
from ..quadmath import ld_gemm
from ..tree import morton as mt
from ..tree.tree import UniformTree

# KIFMM surface radii (surface half-side over box half-side)
RAD_IN = 1.05   # upward-equivalent / downward-check surface
RAD_OUT = 2.95  # upward-check / downward-equivalent surface


def kernel_roles(ker_s2t: KernelSpec, ker_l2t: Optional[KernelSpec] = None,
                 ker_s2m: Optional[KernelSpec] = None):
    """(ker_trans, ker_l2t, ker_s2m) for a source-to-target kernel, the
    split of sctl_tpu/fmm/kifmm.py:619-665: a Stokes kernel translates
    with Stokes3D-FSxU (Stokeslet plus source, k0 = 4 -> k1 = 3), which
    also serves L2T; a Laplace kernel translates with Laplace3D-FxU,
    and Laplace3D-FxdU evaluates S2M with its potential sibling
    Laplace3D-FxU and L2T with itself.  Otherwise S2M uses ker_s2t."""
    check_supported(ker_s2t.name, TREE_KERNELS)
    fxdu = ker_s2t.name == Laplace3D_FxdU.name
    if ker_s2t.name.startswith("Stokes"):
        trans, l2t = Stokes3D_FSxU, ker_l2t or Stokes3D_FSxU
    else:
        trans = Laplace3D_FxU
        l2t = ker_l2t or (Laplace3D_FxdU if fxdu else Laplace3D_FxU)
    s2m = ker_s2m or (Laplace3D_FxU if fxdu else ker_s2t)
    if s2m.kdim0 != ker_s2t.kdim0 or s2m.kdim1 != trans.kdim1:
        raise ValueError(f"ker_s2m {s2m.name} does not fit ker_s2t "
                         f"{ker_s2t.name} and ker_trans {trans.name}")
    return trans, l2t, s2m


def cube_surface(p: int) -> np.ndarray:
    """(n_surf, 3) points on the surface of [-1,1]^3: a p^3 grid minus
    its interior, n_surf = 6p^2 - 12p + 8."""
    g = np.linspace(-1, 1, p)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return pts[(np.abs(pts) == 1).any(axis=1)]


def _kmat(ker: KernelSpec, xt: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """(Nt*k1, Ns*k0) host kernel matrix u = M f, scale included."""
    return full_matrix_np(ker, xt, xs).T


def _pinv(a: np.ndarray, rcond: float = 1e-9) -> np.ndarray:
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    cut = rcond * s[0]
    sinv = np.where(s > cut, 1 / np.where(s > cut, s, 1), 0.0)
    return (vt.T * sinv) @ u.T


def _pinv_ns(a: np.ndarray, rcond: float) -> np.ndarray:
    """Truncated pseudo-inverse refined in longdouble
    (sctl_tpu/fmm/kifmm.py:79-98): the float64 SVD's, then three
    Newton-Schulz steps X <- X (2I - A X) through `ld_gemm`, which drive
    the float64 SVD's error on the singular values near the cutoff
    (relative eps / rcond) below 1e-16."""
    x = _pinv(a, rcond).astype(np.longdouble)
    al = a.astype(np.longdouble)
    eye2 = 2.0 * np.eye(a.shape[0], dtype=np.longdouble)
    for _ in range(3):
        x = ld_gemm(x, eye2 - ld_gemm(al, x))
    return x


def table_path(ker_name: str, p: int, rcond: float, hiprec: bool) -> str:
    """The JAX package's file name of the unit tables of (ker_name, p,
    rcond, hiprec) in the data directory (sctl_tpu/fmm/kifmm.py:118-130);
    the committed hiprec tables are its "_lite" form."""
    hp = "hp" if hiprec else ""
    return os.path.join(data_path(),
                        f"kifmm_{ker_name}_p{p}_r{rcond:.3g}_unit_v4{hp}.npz")


def _outer_scale(mat: np.ndarray, lam: float, row_exp, col_exp):
    """mat * outer(lam^row_exp, lam^col_exp), exponents tiled over the
    surface points (point-major layout)."""
    row_exp = np.asarray(row_exp, np.float64)
    col_exp = np.asarray(col_exp, np.float64)
    rv = np.power(lam, np.tile(row_exp, mat.shape[0] // len(row_exp)))
    cv = np.power(lam, np.tile(col_exp, mat.shape[1] // len(col_exp)))
    return mat * rv[:, None] * cv[None, :]


def _rand_colbasis(A: np.ndarray, tol: float = 1e-10,
                   exact_below: int = 2048) -> np.ndarray:
    """Orthonormal column basis of A to relative tolerance `tol`: exact
    SVD for small row counts, else a randomized range finder with power
    iteration (seeded, so repeatable)."""
    m, n = A.shape
    if m <= exact_below:
        U, s, _ = np.linalg.svd(A, full_matrices=False)
        r = int(np.searchsorted(-(s / max(s[0], 1e-300)), -tol))
        return U[:, :max(r, 1)]
    rng = np.random.default_rng(0)
    k = min(m, 128)
    while True:
        Y = A @ rng.standard_normal((n, k + 16))
        for _ in range(2):
            Y = A @ (A.T @ Y)
        Q, _ = np.linalg.qr(Y)
        U, s, _ = np.linalg.svd(Q.T @ A, full_matrices=False)
        r = int(np.searchsorted(-(s / max(s[0], 1e-300)), -tol))
        if r < k or k >= m:
            return Q @ U[:, :max(r, 1)]
        k = min(m, 2 * k)


# The JAX package's gates of its float32 M2L kernels (sctl_tpu/fmm/
# kifmm.py:440-450, :1182-1186): the blocked stack within 80 MiB, else
# the 316-offset stack, its ranks padded to 128, within 48 MiB.
BLOCKED_STACK_MIB, GRID_STACK_MIB = 80, 48


def m2l_route(r: int, r2: int) -> str:
    """The float32 M2L route of levels >= 3 at ranks (r, r2): "blocked"
    when the sibling-blocked stack 26 (8 r2)(8 r) floats fits its gate,
    else "grid" when the 316-offset stack does, else "parity"."""
    if 26 * (8 * r2) * (8 * r) * 4 <= BLOCKED_STACK_MIB << 20:
        return "blocked"
    if 316 * _round_up(r, 128) * _round_up(r2, 128) * 4 \
            <= GRID_STACK_MIB << 20:
        return "grid"
    return "parity"


def _tensor(a, device, dtype):
    """Host array -> contiguous tensor of `dtype` on `device`."""
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=device).contiguous()


class KIFMMOperators:
    """Unit-box operator tables of one (translation kernel, p, rcond),
    built on the host in float64, and the uniform tree's device copies.

    For a homogeneous kernel every level's operators follow from the
    unit tables by scaling (`level_tables`); for a single-exponent
    kernel (Laplace) the M2M, L2L and M2L tables are the same at every
    level, and only uc2e and the surfaces scale (done per tree in
    `KIFMM.setup`).  Translations with Stokes3D-FSxU carry k0t = 4
    equivalent and k1t = 3 check values per surface point.

    M2L route of levels >= 3 (`m2l_route`), chosen in float32 from the
    stacks' sizes at the capped ranks with the JAX package's gates, so
    that port and reference run the same kernel: "blocked", the
    sibling-blocked kernel `m2l_grid_blocked` (Laplace p <= 6), which
    builds its (26, 8 r2, 8 r) stack; "grid", the 316-offset sweep
    `m2l_grid` (Laplace p = 8), which builds the (316, r2, r)
    transposed stack; "parity", the per-parity sweep as batched matrix
    products (Stokes), which builds no stack.  float64 takes "parity"
    on every device, as the JAX package runs float64 (its Pallas M2L
    kernels are float32 only, sctl_tpu/fmm/kifmm.py:1186-1188,
    :1216-1217).  All run the route's ranks (`_rank_caps`).  Timed on
    an H100 (PERF.md, chip_smoke.py phases 4, 6c, 7 and 8): Laplace p=6
    and p=8 and Stokes p=6 in float32, Laplace p=6 and p=8 in float64;
    for Stokes at level 6 the blocked kernel on the tensor cores now
    beats the sweep, but its stack is over the gate (PERF.md, open
    questions).

    hiprec: the tables of `unit_tables(..., hiprec=True)`, refined in
    longdouble (BASELINE.md rung 7)."""

    TABLES = ("uc2e_unit", "dc2e_unit", "m2m_unit", "l2l_unit",
              "cb_unit", "cc_unit", "vb_unit", "ca_unit")

    def __init__(self, ker_trans: KernelSpec, p: int, rcond: float,
                 device, dtype: torch.dtype,
                 tables: Optional[dict] = None, hiprec: bool = False):
        check_supported(ker_trans.name, (Laplace3D_FxU.name,
                                         Stokes3D_FSxU.name))
        self.ker_trans = ker_trans
        self.k0t, self.k1t = ker_trans.kdim0, ker_trans.kdim1
        self.p = p
        self.rcond = rcond
        self.surf = cube_surface(p)
        self.n_surf = len(self.surf)
        self.offsets, self.parity_valid = _vlist_offsets()
        if tables is None:
            tables = unit_tables(ker_trans.name, p, rcond, hiprec)
        for name in self.TABLES:
            setattr(self, name, np.asarray(tables[name], np.float64))
        self.device, self.dtype = torch.device(device), dtype
        self._rank_caps(dtype)
        self.m2l_route = (m2l_route(self.blk_r, self.blk_r2)
                          if dtype == torch.float32 else "parity")
        self._on_device = False

    def device_tables(self) -> "KIFMMOperators":
        """Cast the tables the uniform KIFMM reads to the device and
        dtype, once (the adaptive FMM reads only the host tables)."""
        if not self._on_device:
            self._to_device(self.device, self.dtype)
            self._on_device = True
        return self

    def level_tables(self, depth: int, scale: float) -> dict:
        """Host float64 operators of levels 0..depth of a tree whose
        root box has side `scale` (sctl_tpu/fmm/kifmm.py `_derive_levels`):
        surfaces, uc2e and dc2e per level, M2M and L2L per child level
        (list index level - 1), and the M2L row scaling `m2l_s` per
        level: the level's M2L reads cc_unit on the sources scaled by
        1 / m2l_s and expands through cb_unit scaled by m2l_s (for a
        single-exponent kernel m2l_s is all ones)."""
        s_exp = np.asarray(self.ker_trans.src_scal, np.float64)
        t_exp = np.asarray(self.ker_trans.trg_scal, np.float64)
        flat = len(set(s_exp)) == 1
        lam = [scale / (1 << lvl) for lvl in range(depth + 1)]

        def conj3(stack, lm):              # diag(lm^s) m diag(lm^-s)
            return stack if flat else np.stack(
                [_outer_scale(m, lm, s_exp, -s_exp) for m in stack])

        nrow = self.cb_unit.shape[0]
        return {
            "surf_in": [self.surf * (RAD_IN * lm / 2) for lm in lam],
            "surf_out": [self.surf * (RAD_OUT * lm / 2) for lm in lam],
            "uc2e": [_outer_scale(self.uc2e_unit, lm, s_exp, t_exp)
                     for lm in lam],
            "dc2e": [_outer_scale(self.dc2e_unit, lm, s_exp, t_exp)
                     for lm in lam],
            "m2m": [conj3(self.m2m_unit, lam[lvl - 1])
                    for lvl in range(1, depth + 1)],
            "l2l": [conj3(self.l2l_unit, lam[lvl - 1])
                    for lvl in range(1, depth + 1)],
            "m2l_s": [np.ones(nrow) if flat else np.power(
                lm, np.tile(s_exp, nrow // len(s_exp))) for lm in lam],
        }

    def _build_unit(self, ker_trans, surf, rcond, hiprec=False):
        """Unit-box tables: parent side 1 (children 1/2), M2L at side 1.
        Child corners in Morton child order c = x + 2y + 4z.  hiprec:
        the pseudo-inverses and the M2M and L2L products in longdouble
        (sctl_tpu/fmm/kifmm.py:239-289), the tables stored in float64."""
        child_pos = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                              for c in range(8)])
        s_exp = np.asarray(ker_trans.src_scal, np.float64)
        t_exp = np.asarray(ker_trans.trg_scal, np.float64)
        s_in = surf * (RAD_IN / 2)
        s_out = surf * (RAD_OUT / 2)
        pinv = _pinv_ns if hiprec else _pinv
        f64 = lambda a: np.asarray(a, np.float64)
        uc2e = pinv(_kmat(ker_trans, s_out, s_in), rcond)
        dc2e = pinv(_kmat(ker_trans, s_in, s_out), rcond)
        self.uc2e_unit, self.dc2e_unit = f64(uc2e), f64(dc2e)
        self._dc2e_work = dc2e            # in the working precision
        dc2e_half = _outer_scale(dc2e, 0.5, s_exp, t_exp)
        cc = (child_pos - 0.5) * 0.5
        m2m, l2l = [], []
        for c in range(8):
            k = _kmat(ker_trans, s_out, surf * (RAD_IN / 4) + cc[c])
            m2m.append(f64(uc2e @ k.astype(uc2e.dtype)))
            k2 = _kmat(ker_trans, surf * (RAD_IN / 4) + cc[c], s_out)
            l2l.append(f64(dc2e_half @ k2.astype(dc2e.dtype)))
        self.m2m_unit = np.stack(m2m)
        self.l2l_unit = np.stack(l2l)
        self.m2l_unit = m2l_family(ker_trans, self.dc2e_unit, s_in,
                                   self.offsets)

    def _compress_m2l_unit(self, ker_trans, surf, rcond, hiprec=False):
        """Joint two-sided factorization M_d = U A_d V^T of the unit M2L
        family, lossless to about 1e-12; ranks rounded up to 8.  hiprec
        (sctl_tpu/fmm/kifmm.py:267-324): the cutoff follows rcond, and
        A_d = (U^T dc2e) K_d V is recomputed through `ld_gemm`, since the
        float64 product dc2e K_d loses about eps / rcond to cancellation
        against dc2e's entries of about 1 / rcond."""
        ctol = max(1e-13, min(1e-10, 0.1 * rcond)) if hiprec else 1e-10
        M = self.m2l_unit
        ns_ = M.shape[1]
        A = np.transpose(M, (1, 0, 2)).reshape(ns_, -1)
        U = _rand_colbasis(A, ctol)
        r = min(max(8, -(-U.shape[1] // 8) * 8), ns_)
        if U.shape[1] < r:
            U2, _, _ = np.linalg.svd(A - U @ (U.T @ A),
                                     full_matrices=False)
            U = np.concatenate([U, U2[:, :r - U.shape[1]]], axis=1)
        self.cb_unit = np.ascontiguousarray(U[:, :r])
        C = np.einsum("nm,omk->onk", self.cb_unit.T, M, optimize=True)
        B = np.transpose(C, (2, 0, 1)).reshape(ns_, -1)
        V = _rand_colbasis(B, ctol)
        r2 = min(max(8, -(-V.shape[1] // 8) * 8), ns_)
        if V.shape[1] < r2:
            V2, _, _ = np.linalg.svd(B - V @ (V.T @ B),
                                     full_matrices=False)
            V = np.concatenate([V, V2[:, :r2 - V.shape[1]]], axis=1)
        self.vb_unit = np.ascontiguousarray(V[:, :r2])
        self.cc_unit = C
        self.ca_unit = np.einsum("ork,kn->orn", C, self.vb_unit,
                                 optimize=True)
        self.m2l_unit = None          # build input only
        if hiprec:
            W = ld_gemm(self.cb_unit.T, self._dc2e_work)
            Vl = self.vb_unit.astype(np.longdouble)
            s_in = surf * (RAD_IN / 2)
            for i, d in enumerate(self.offsets):
                k = _kmat(ker_trans, s_in, s_in + d * 1.0)
                self.ca_unit[i] = np.float64(
                    ld_gemm(ld_gemm(W, k.astype(np.longdouble)), Vl))

    def _rank_caps(self, dtype):
        """Rank caps of the f32 route (sctl_tpu/fmm/kifmm.py:423-435):
        the smallest 128-multiples whose dropped Frobenius tail of the
        compressed family stays below max(rcond^2, 1e-5) of its mass.
        float32 runs the capped ranks, as the JAX package's Pallas
        routes do, on both M2L routes.  The JAX package's Stokes scan
        keeps the exact ranks; at the 1e7-point Stokeslet on an H100
        the caps (248/512 of 248/608) gave the exact ranks' error,
        1.039e-4, in 18% less level-6 M2L time (PERF.md §6).  float64
        keeps the exact ranks of the JAX package's scan route."""
        ca = self.ca_unit
        cap_tol2 = max(self.rcond ** 2, 1e-5)

        def _cap(axis):
            other = tuple(i for i in range(3) if i != axis)
            nrm2 = (ca ** 2).sum(axis=other)
            c = 128
            while c < len(nrm2) and nrm2[c:].sum() > cap_tol2 * nrm2.sum():
                c += 128
            return int(min(c, len(nrm2)))

        self.m2l_cap_r, self.m2l_cap_r2 = _cap(1), _cap(2)
        if dtype == torch.float32:
            self.blk_r, self.blk_r2 = self.m2l_cap_r, self.m2l_cap_r2
        else:
            self.blk_r, self.blk_r2 = ca.shape[1], ca.shape[2]

    def _to_device(self, device, dtype):
        t = lambda a: _tensor(a, device, dtype)
        self.m2m_cat, self.l2l_cat = (t(a) for a in cat_tables(
            self.m2m_unit, self.l2l_unit))
        self.m2l_u = t(self.cb_unit)                  # (nd, r)
        self.m2l_v = t(self.vb_unit)                  # (nd, r2)
        self.m2l_a = t(self.ca_unit)                  # (316, r, r2)
        # each kernel route's stack at the route's ranks, built only for
        # that route (at Stokes ranks in float64 the blocked one would
        # take GBs)
        r, r2 = self.blk_r, self.blk_r2
        self.m2l_blk = (t(blocked_m2l_mats(self.ca_unit, self.offsets,
                                           self.parity_valid, r, r2))
                        if self.m2l_route == "blocked" else None)
        self.m2l_at = (t(self.ca_unit[:, :r, :r2].transpose(0, 2, 1))
                       if self.m2l_route == "grid" else None)
        # on a card, that stack split once into the TF32 hi and lo parts
        # its tensor-core kernel reads
        card = self.device.type == "cuda"
        self.m2l_blk_tc = (blocked_operands(self.m2l_blk)
                           if card and self.m2l_blk is not None else None)
        self.m2l_at_tc = (grid_operands(self.m2l_at)
                          if card and self.m2l_at is not None else None)
        # per-parity sweep tables: for child parity c (4x + 2y + z) its
        # 189 offsets d, c + d = 2 eb + ep
        vidx, ebs, eps = [], [], []
        for c in range(8):
            cvec = np.array([(c >> 2) & 1, (c >> 1) & 1, c & 1])
            oi = np.where(self.parity_valid[c])[0]
            e = cvec[None, :] + self.offsets[oi]
            eb = np.floor_divide(e, 2)
            vidx.append(oi)
            ebs.append(eb)
            eps.append(e - 2 * eb)
        self.par_vidx = torch.as_tensor(np.stack(vidx), device=device)
        self.par_ebs = np.stack(ebs)
        self.par_eps = np.stack(eps)


def cat_tables(m2m: np.ndarray, l2l: np.ndarray):
    """(8, nd, nd) M2M and L2L stacks -> the concatenated single-GEMM
    forms: q_parent (P, 8 nd) @ m2m_cat (8 nd, nd) and q_child =
    (q_parent (P, nd) @ l2l_cat (nd, 8 nd)).reshape(8 P, nd)."""
    nd = m2m.shape[1]
    return (np.transpose(m2m, (0, 2, 1)).reshape(8 * nd, nd),
            np.transpose(l2l, (2, 0, 1)).reshape(nd, 8 * nd))


def m2l_family(ker_trans: KernelSpec, dc2e: np.ndarray, s_in: np.ndarray,
               offsets: np.ndarray) -> np.ndarray:
    """(316, nd, nd) unit M2L operators: for each offset d, the source
    box's equivalent surface at d to the target's check surface,
    through dc2e."""
    return np.stack([dc2e @ _kmat(ker_trans, s_in, s_in + d * 1.0)
                     for d in offsets])


# the tables the committed lite files hold as they are; cc_unit and
# ca_unit are rebuilt from them (sctl_tpu/fmm/kifmm.py:496-551)
LITE_TABLES = ("uc2e_unit", "dc2e_unit", "m2m_unit", "l2l_unit",
               "cb_unit", "vb_unit")


def read_lite_tables(path: str, ker_trans: KernelSpec, p: int) -> dict:
    """The unit tables of a lite file (the JAX package's
    `_load_cache_lite`, sctl_tpu/fmm/kifmm.py:511-551): LITE_TABLES as
    stored; cc_unit = cb^T M_d and ca_unit = cc_unit vb over the M2L
    family rebuilt in float64 from dc2e, plus the stored longdouble
    refinement of ca_unit, an int8 (1/127 steps) or float16 delta
    scaled per offset.  The same numpy as the JAX package's, so on one
    host the two read equal tables bit for bit."""
    z = np.load(path)
    t = {name: z[name] for name in LITE_TABLES}
    qd = z["ca_delta"]
    delta = np.float64(qd)
    if qd.dtype == np.int8:
        delta /= 127.0
    delta *= z["ca_scale"][:, None, None]
    offsets, _ = _vlist_offsets()
    M = m2l_family(ker_trans, t["dc2e_unit"], cube_surface(p) * (RAD_IN / 2),
                   offsets)
    C = np.einsum("nm,omk->onk", t["cb_unit"].T, M, optimize=True)
    del M
    t["cc_unit"] = C
    t["ca_unit"] = np.einsum("ork,kn->orn", C, t["vb_unit"],
                             optimize=True) + delta
    return t


def unit_tables(ker_name: str, p: int, rcond: float,
                hiprec: bool = False) -> dict:
    """`_unit_tables` with every argument in its cache key: a call that
    leaves hiprec to its default finds the tables of one that passes
    it."""
    return _unit_tables(ker_name, p, rcond, bool(hiprec))


@functools.lru_cache(maxsize=None)
def _unit_tables(ker_name: str, p: int, rcond: float,
                 hiprec: bool) -> dict:
    """The unit-box tables (`KIFMMOperators.TABLES`) of translation
    kernel `ker_name` at order p and pinv cutoff rcond, once per process
    and shared by every KIFMMOperators of those parameters (which read
    them and never write them): built cold on the host in float64; with
    hiprec read from the lite file of `table_path` where the data
    directory holds it, else built cold with the longdouble refinements
    (minutes at p = 10)."""
    ker = KERNELS[ker_name]
    lite = table_path(ker_name, p, rcond, hiprec)[:-4] + "_lite.npz"
    if hiprec and os.path.exists(lite):
        t = read_lite_tables(lite, ker, p)
    else:
        ops = KIFMMOperators.__new__(KIFMMOperators)
        ops.offsets, ops.parity_valid = _vlist_offsets()
        surf = cube_surface(p)
        ops._build_unit(ker, surf, rcond, hiprec)
        ops._compress_m2l_unit(ker, surf, rcond, hiprec)
        t = {name: getattr(ops, name) for name in KIFMMOperators.TABLES}
    return {name: np.ascontiguousarray(t[name], np.float64)
            for name in KIFMMOperators.TABLES}


unit_tables.cache_clear = _unit_tables.cache_clear


def operators_from_numpy(tables: dict, device, dtype: torch.dtype,
                         ker_trans: KernelSpec = Laplace3D_FxU
                         ) -> KIFMMOperators:
    """The port's operators from unit tables computed elsewhere, e.g.
    by the JAX package's KIFMMOperators (hiprec ones too): `tables` maps
    each name of `KIFMMOperators.TABLES` to its numpy array, "p" to the
    order and "rcond" to the pinv cutoff the tables were built with;
    `ker_trans` is their translation kernel (Stokes3D_FSxU for
    Stokes)."""
    return KIFMMOperators(ker_trans, int(tables["p"]),
                          float(tables["rcond"]), device, dtype,
                          tables=tables)


def _quantile_cap(box_cnt: np.ndarray, q: float = 97.0) -> int:
    """Per-box capacity at the q-th percentile of occupied boxes'
    counts, rounded up to 8 (the packed-slab route's rule)."""
    occ = box_cnt[box_cnt > 0]
    if len(occ) == 0:
        return 8
    cap = min(int(np.percentile(occ, q)), int(box_cnt.max()))
    return max(8, -(-cap // 8) * 8)


def _overflow_slots(tree: UniformTree, cap: int):
    """Sideband for boxes with more than `cap` points: (boxes (Bo,),
    cap2, idx (Bo, cap2) sorted-point indices (clipped), valid)."""
    cnt, dsp = tree.box_cnt, tree.box_dsp
    boxes = np.where(cnt > cap)[0]
    if len(boxes) == 0:
        return (np.zeros(0, np.int64), 8, np.zeros((0, 8), np.int64),
                np.zeros((0, 8), bool))
    cap2 = max(8, -(-int((cnt[boxes] - cap).max()) // 8) * 8)
    idx = dsp[boxes][:, None] + cap + np.arange(cap2)[None, :]
    valid = idx < dsp[boxes + 1][:, None]
    return boxes, cap2, np.clip(idx, 0, len(tree.X_sorted) - 1), valid


def _pad_index(tree: UniformTree, cap: int):
    """(B, cap) sorted-point index of each box slot (clipped) and its
    validity: the first min(count, cap) points of every box."""
    idx = tree.box_dsp[:-1, None] + np.arange(cap)[None, :]
    valid = idx < tree.box_dsp[1:, None]
    return np.clip(idx, 0, max(len(tree.X_sorted) - 1, 0)), valid


# Pair budget of one chunk of the overflow-sideband sums on the card:
# their (..., T, S) temporaries (a few per pair) stay near 1 GiB of the
# card's 80 GB in float32, 2 GiB in float64, and the 1e7-point run
# needs tens of chunks, not hundreds.  The CPU keeps the plain versions'
# budget.
SIDEBAND_CHUNK_PAIRS_CUDA = 1 << 26


def _chunk_pairs(device: torch.device) -> int:
    return SIDEBAND_CHUNK_PAIRS_CUDA if device.type == "cuda" \
        else CHUNK_PAIRS


def _apply_groups(ker: KernelSpec, xt, xs, f, ns=None):
    """Batched plain pair sums over groups, in chunks:
    xt (G, T, 3), xs (G, S, 3), f (G, S, k0), ns (G, S, 3) source
    normals or None -> (G, T, k1), unscaled.  The chunk's pair budget
    shrinks with k0, which sets the pairwise temporaries per pair."""
    G, T, S = xt.shape[0], xt.shape[1], xs.shape[1]
    if G == 0:
        return xt.new_zeros((0, T, ker.kdim1))
    step = max(1, _chunk_pairs(xt.device) // max(1, T * S * ker.kdim0))
    return torch.cat([
        ker.apply_pairwise(xt[g:g + step], xs[g:g + step],
                           None if ns is None else ns[g:g + step],
                           f[g:g + step])
        for g in range(0, G, step)])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mark(marks, name: str) -> None:
    """Record a CUDA event after a stage when `marks` collects them."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


# Element budget of one chunk of the per-parity M2L sweep's stacked
# windows: about 1 GiB of float32 (2 GiB of float64) on the card; the
# CPU keeps the plain versions' budget.
PARITY_CHUNK_ELEMS_CUDA = 1 << 28


class KIFMM:
    """Uniform-tree KIFMM evaluator for the six kernels with a tree path
    (uker.TREE_KERNELS).

    device : "cuda" (default) runs the CUDA kernels, "cpu" their plain
             versions.
    dtype  : torch.float32 or torch.float64, on either device (float64
             is the JAX package's default off the TPU).
    rcond  : pinv cutoff of the operators, default 3e-5 in float32 and
             1e-9 in float64 (sctl_tpu/fmm/kifmm.py:219-224).
    hiprec : operator tables refined in longdouble (`unit_tables`), for
             BASELINE.md's rung 7 (p = 10 or 12, rcond 1e-10, float64).
    The double layers (Laplace3D-DxU, Stokes3D-DxU) read source normals:
    `setup(..., n_src=)` takes them and refuses to run without.
    """

    def __init__(self, ker_s2t: KernelSpec, p: int = 6,
                 depth: Optional[int] = None, pts_per_leaf: int = 256,
                 device=None, dtype: torch.dtype = torch.float32,
                 rcond: Optional[float] = None,
                 operators: Optional[KIFMMOperators] = None,
                 ker_l2t: Optional[KernelSpec] = None,
                 ker_s2m: Optional[KernelSpec] = None,
                 hiprec: bool = False):
        check_supported(ker_s2t.name, TREE_KERNELS)
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(f"KIFMM dtype {dtype}")
        self.ker_s2t = ker_s2t
        self.ker_trans, self.ker_l2t, self.ker_s2m = kernel_roles(
            ker_s2t, ker_l2t, ker_s2m)
        self.p = p
        self.depth = depth
        self.pts_per_leaf = pts_per_leaf
        self.dtype = dtype
        # pinv cutoff: f32 loses accuracy to rounding below ~3e-5
        self.rcond = rcond if rcond is not None else (
            3e-5 if dtype == torch.float32 else 1e-9)
        self.hiprec = hiprec
        self._ops = operators

    # -- setup -----------------------------------------------------------
    def setup(self, x_src: np.ndarray, x_trg: np.ndarray,
              n_src: Optional[np.ndarray] = None):
        """Trees, box slots and device tables for sources x_src (N, 3)
        with normals n_src (N, 3) (the double layers only) and targets
        x_trg."""
        nrm = self.ker_s2t.needs_normal or self.ker_s2m.needs_normal
        if nrm and n_src is None:
            raise ValueError(
                f"kernel {self.ker_s2t.name} requires source normals: "
                "pass n_src")
        x_src = np.asarray(x_src, np.float64)
        x_trg = np.asarray(x_trg, np.float64)
        bbox = (np.minimum(x_src.min(0), x_trg.min(0)),
                np.maximum(x_src.max(0), x_trg.max(0)))
        if self.depth is None:
            self.depth = max(2, int(np.round(np.log(
                max(len(x_src) / self.pts_per_leaf, 1)) / np.log(8))))
        L = self.depth
        dev, dt = self.device, self.dtype
        t = lambda a: _tensor(a, dev, dt)
        ti = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self.src_tree = src = UniformTree(x_src, L, bbox=bbox)
        self.trg_tree = trg = UniformTree(x_trg, L, bbox=bbox)
        self.scale = src.scale
        if (self._ops is None or self._ops.p != self.p
                or self._ops.ker_trans.name != self.ker_trans.name):
            self._ops = KIFMMOperators(self.ker_trans, self.p, self.rcond,
                                       dev, dt, hiprec=self.hiprec)
        ops = self._ops.device_tables()
        lam = self.scale / (1 << L)
        s_exp, t_exp = self.ker_trans.src_scal, self.ker_trans.trg_scal
        self.uc2e_L = t(_outer_scale(ops.uc2e_unit, lam, s_exp, t_exp))
        self.surf_out_L = t(ops.surf * (RAD_OUT * lam / 2))
        self._level_tables(t)
        self.cap_s = _quantile_cap(src.box_cnt)
        self.cap_t = _quantile_cap(trg.box_cnt, q=85.0)
        (sov_boxes, self.sov_cap, sov_idx,
         sov_valid) = _overflow_slots(src, self.cap_s)
        (tov_boxes, self.tov_cap, tov_idx,
         tov_valid) = _overflow_slots(trg, self.cap_t)
        self.n_ovf_s = int(sov_valid.sum())
        self.n_ovf_t = int(tov_valid.sum())
        s_idx, s_valid = _pad_index(src, self.cap_s)
        t_idx, t_valid = _pad_index(trg, self.cap_t)
        xs_p = src.X_sorted[s_idx]                     # (B, cap_s, 3)
        xt_p = trg.X_sorted[t_idx]                     # (B, cap_t, 3)
        n_sorted = (np.asarray(n_src, np.float64)[src.perm] if nrm
                    else None)
        ns_p = None if n_sorted is None else n_sorted[s_idx]
        ctr = src.box_centers()
        self.ctr = t(ctr)
        self.nb = ti(src.neighbor_boxes())             # (B, 27)
        self.xs_pad = t(xs_p)
        self.xt_pad = t(xt_p)
        self.ns_pad = None if ns_p is None else t(ns_p)
        # box-local slot coordinates for the shared-surface kernels,
        # localized in f64 on the host (exact differences in f32)
        slots = lambda a: t(a.transpose(2, 0, 1).reshape(3, -1))
        self.xs_sl = slots(xs_p - ctr[:, None, :])
        self.xt_sl = slots(xt_p - ctr[:, None, :])
        self.ns_sl = (slots(ns_p) if self.ker_s2m.needs_normal else None)
        # raster layout of the slab stencil
        n = 1 << L
        gidx = mt.raster_index(L)                      # morton -> raster
        inv = np.empty_like(gidx)
        inv[gidx] = np.arange(len(gidx))               # raster -> morton
        self.gidx = {lvl: ti(mt.raster_index(lvl))
                     for lvl in range(2, L + 1)}
        self.rast_to_mort = ti(inv)
        self.xt_rast = t(xt_p[inv].reshape(n, n, n, self.cap_t, 3)
                         .transpose(0, 1, 2, 4, 3))
        # each box's real points (its first slots), clipped to the caps:
        # the stencils and the U-list kernel skip the slots past them
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        cnt_s = np.minimum(src.box_cnt, self.cap_s)
        cnt_t = np.minimum(trg.box_cnt, self.cap_t)
        self.cnt_s_rast = i32(cnt_s[inv].reshape(n, n, n))
        self.cnt_t_rast = i32(cnt_t[inv].reshape(n, n, n))
        self.cnt_s_box = i32(cnt_s)
        self.cnt_t_box = i32(cnt_t)
        # the U-list routes' source runs: each box's real slots (S2M) and
        # its copy of the equivalent surface (L2T)
        self.rng_s = box_ranges(self.cnt_s_box, self.cap_s)
        self.rng_e = box_ranges(i32(np.full(src.n_boxes, ops.n_surf)),
                                ops.n_surf)
        self.SL = -(-9 * self.cap_s // 128) * 128
        # routes by shape and element size, the same on every device:
        # the shared-surface kernels take a box count that is a
        # multiple of 128 and the capacities of their route rules,
        # otherwise the U-list kernel; the near field the slab stencil
        # where its block holds the caps, otherwise the halo stencil
        # (see the module docstring)
        self.surface_route = (
            src.n_boxes % 128 == 0
            and surface_pair_fits(self.ker_s2m, self.cap_s, dt)
            and l2t_surface_fits(self.ker_l2t, ops.n_surf, dt))
        self.near_route = ("stencil9" if stencil9_fits(
            self.ker_s2t, self.cap_t, self.SL, dt) else "stencil")
        self.p2p_nrm = self.ker_s2t.needs_normal
        if self.near_route == "stencil9":
            # each slab entry's real points first, one gather an array
            self.slab_idx, self.cnt9 = slab_index(
                self.rast_to_mort, n, self.cap_s, self.SL, self.cnt_s_rast)
            lay = lambda a: slab_gather(a, self.slab_idx)
            self.xs_slab = lay(self.xs_pad)
            self.ns_slab = lay(self.ns_pad) if self.p2p_nrm else None
        else:
            lay = lambda a: to_halo(a, self.rast_to_mort, n)
            self.xs_halo = lay(self.xs_pad)
            self.ns_halo = lay(self.ns_pad) if self.p2p_nrm else None
        # density gather and result scatter indices
        self.src_perm = ti(src.perm)
        self.trg_perm = ti(trg.perm)
        self.pad_idx = ti(s_idx)
        self.pad_valid = t(s_valid)
        first = np.repeat(trg.box_dsp[:-1], cnt_t)
        off = np.arange(cnt_t.sum()) - np.repeat(np.cumsum(cnt_t) - cnt_t,
                                                 cnt_t)
        self.unsort_pos = ti(first + off)
        self.pad_take = ti(np.nonzero(t_valid.reshape(-1))[0])
        # overflow sidebands
        self.sov_boxes = ti(sov_boxes)
        self.sov_idx = ti(sov_idx)
        self.sov_valid = t(sov_valid)
        self.xs_ov2 = t(src.X_sorted[sov_idx])
        self.ns_ov2 = None if n_sorted is None else t(n_sorted[sov_idx])
        slot_of_box = np.full(src.n_boxes + 1, -1, np.int64)
        slot_of_box[sov_boxes] = np.arange(len(sov_boxes))
        self.sov_slot_of_box = ti(slot_of_box)
        self.tov_boxes = ti(tov_boxes)
        self.xt_ov2 = t(trg.X_sorted[tov_idx])
        self.tov_pos = ti(tov_idx.reshape(-1)[tov_valid.reshape(-1)])
        self.tov_take = ti(np.nonzero(tov_valid.reshape(-1))[0])
        return self

    def _level_tables(self, t):
        """Per-level M2M, L2L and M2L row scalings.  A single-exponent
        kernel (Laplace) reads the unit tables at every level; Stokes
        FSxU (source exponents 1, 1, 1, 2) reads the tables conjugated
        to each level's box side (`KIFMMOperators.level_tables`)."""
        ops, L = self._ops, self.depth
        flat = len(set(self.ker_trans.src_scal)) == 1
        self.m2l_s = {}
        if flat:
            self.m2m_cat = {lvl: ops.m2m_cat for lvl in range(1, L + 1)}
            self.l2l_cat = {lvl: ops.l2l_cat for lvl in range(1, L + 1)}
            return
        lt = ops.level_tables(L, self.scale)
        self.m2m_cat, self.l2l_cat = {}, {}
        for lvl in range(1, L + 1):
            m, l = cat_tables(lt["m2m"][lvl - 1], lt["l2l"][lvl - 1])
            self.m2m_cat[lvl], self.l2l_cat[lvl] = t(m), t(l)
        self.m2l_s = {lvl: t(lt["m2l_s"][lvl]) for lvl in range(2, L + 1)}

    # -- evaluation ---------------------------------------------------------
    def eval(self, f) -> np.ndarray:
        """u[trg] = sum_src K(trg, src) f[src]; f (n_src, k0) in input
        order -> (n_trg, k1) numpy array in input target order."""
        f = torch.as_tensor(np.asarray(f), device=self.device,
                            dtype=self.dtype)
        return self.eval_tensor(f).cpu().numpy()

    def eval_tensor(self, f: torch.Tensor) -> torch.Tensor:
        """Device-resident evaluation: f (n_src, k0) tensor in input
        order -> (n_trg, k1) tensor in input target order.  Timed in the
        profile block "KIFMM::Eval" (with sync), its FLOPs credited
        after it from `_flop_model`, as at sctl_tpu/fmm/kifmm.py:933-935."""
        fp, fo = self.pad_density(f)
        with profile.Profile.scoped("KIFMM::Eval", sync=True):
            u_pad, u_ovf = self._eval_impl(fp, fo)
        profile.add_flops(self._flop_model())
        return self.unsort(u_pad, u_ovf)

    def _flop_model(self) -> float:
        """FLOPs of one evaluation: the JAX package's formula
        (sctl_tpu/fmm/kifmm.py:1025-1060) on this tree, its Pallas P2P
        flags read as the route this KIFMM took: the slab stencil is its
        packed-slab kernel (3 SL source slots a target box), the halo
        stencil its shifted-window kernel (cap_s rounded up to 64
        slots, 128 on an odd side).  The box capacities are the port's
        (the JAX package rounds cap_s to 64 off the packed-slab route).
        The formula counts every padded slot; the
        port's stencils and surface kernels run each box's real slots
        only (by the per-box counts), so the count is the JAX package's
        work, the one its report's f/s is measured against, not the
        pairs the card ran."""
        ops = self._ops
        B = float(self.src_tree.n_boxes)
        ns = ops.n_surf * ops.k0t
        kf = self.ker_s2t.flops
        if self.near_route == "stencil9":
            fl = B * self.cap_t * 3.0 * self.SL * kf
        else:
            align = 64 if (1 << self.depth) % 2 == 0 else 128
            fl = 27.0 * B * self.cap_t * (-(-self.cap_s // align) * align) \
                * kf
        n_sov, n_tov = len(self.sov_boxes), len(self.tov_boxes)
        if self.n_ovf_s:
            fl += 27.0 * n_sov * self.cap_t * self.sov_cap * kf
        if self.n_ovf_t:
            fl += 27.0 * n_tov * self.tov_cap * self.cap_s * kf
            if self.n_ovf_s:
                fl += 27.0 * n_tov * self.tov_cap * self.sov_cap * kf
        # S2M checks + uc2e GEMM, L2T
        fl += B * ops.n_surf * self.cap_s * self.ker_s2m.flops
        fl += B * self.cap_t * ops.n_surf * self.ker_l2t.flops
        fl += 2.0 * B * ns * ns
        r, r2 = ops.m2l_u.shape[1], ops.m2l_v.shape[1]
        for lvl in range(2, self.depth + 1):
            bl = 8.0 ** lvl
            fl += bl * 2.0 * ns * (r + r2)     # U/V projections
            fl += 189.0 * bl * 2.0 * r * r2    # V-list translations
        for lvl in range(3, self.depth + 1):
            # concatenated M2M + L2L GEMMs at the parent level
            fl += 8.0 ** (lvl - 1) * 2.0 * (8 * ns) * ns * 2
        return fl

    def pad_density(self, f: torch.Tensor):
        """Input-order densities -> (fp (B, cap_s, k0), fo (Bo, cap2,
        k0)): box slots, zero in padding, and the overflow sideband."""
        k0 = self.ker_s2t.kdim0
        fs = f.to(self.device, self.dtype).reshape(-1, k0)[self.src_perm]
        fp = fs[self.pad_idx] * self.pad_valid[..., None]
        fo = fs[self.sov_idx] * self.sov_valid[..., None]
        return fp, fo

    def unsort(self, u_pad: torch.Tensor, u_ovf: torch.Tensor):
        """Padded box-slot results and the target sideband -> input
        target order."""
        k1 = self.ker_l2t.kdim1
        nt = len(self.trg_tree.perm)
        u_sorted = u_pad.new_zeros((nt, k1))
        u_sorted[self.unsort_pos] = u_pad.reshape(-1, k1)[self.pad_take]
        if self.n_ovf_t:
            u_sorted[self.tov_pos] = u_ovf.reshape(-1, k1)[self.tov_take]
        out = torch.empty_like(u_sorted)
        out[self.trg_perm] = u_sorted
        return out

    def _eval_impl(self, fp, fp_ovf, marks: Optional[list] = None):
        """Padded densities -> (u_pad (B, cap_t, k1), u_ovf (Bt, cap2t,
        k1)).  With `marks` a list, a CUDA event is recorded after each
        stage: S2M, M2M, M2L, L2L, L2T, P2P near (the route's stencil)
        and P2P sidebands (the overflow boxes' plain pair sums)."""
        ops = self._ops
        L = self.depth
        ns = ops.n_surf
        nd = ns * ops.k0t                  # equivalent values per box
        B = self.src_tree.n_boxes
        km = self.ker_s2m
        k0 = km.kdim0

        # ---- S2M: leaf check potentials -> upward equivalents ----
        if self.surface_route:
            # each box's real slots, by its count
            out_sl = surface_pair(km, self.surf_out_L, self.xs_sl,
                                  fp.reshape(-1, k0).T.contiguous(),
                                  self.cap_s, self.ns_sl, self.cnt_s_box)
            u_check = out_sl.permute(2, 1, 0).reshape(B, -1)
        else:
            # box-local check surface (targets) against the box's real
            # slots (sources)
            xc_b = self.surf_out_L.T.expand(B, -1, -1).contiguous()
            u = p2p_ulist(km, xc_b, self.xs_sl, self.ns_sl,
                          fp.reshape(-1, k0), self.rng_s)
            u_check = u.reshape(B, -1)
        u_check = u_check * km.scale_factor
        if self.n_ovf_s:
            sb = self.sov_boxes
            xck = self.surf_out_L[None] + self.ctr[sb][:, None, :]
            uo = _apply_groups(km, xck, self.xs_ov2, fp_ovf,
                               self.ns_ov2 if km.needs_normal else None)
            u_check.index_add_(0, sb, uo.reshape(len(sb), -1)
                               * km.scale_factor)
        q_up = u_check @ self.uc2e_L.T
        _mark(marks, "S2M")

        # ---- M2M: Morton order is parent-major ----
        q_levels = {L: q_up}
        for lvl in range(L, 2, -1):
            q_levels[lvl - 1] = q_levels[lvl].reshape(-1, 8 * nd) \
                @ self.m2m_cat[lvl]
        _mark(marks, "M2M")

        v_dn = self._m2l_sweep(q_levels)
        _mark(marks, "M2L")

        # ---- L2L (dc2e is folded into the M2L and L2L tables) ----
        q_dn = v_dn[2]
        for lvl in range(3, L + 1):
            q_dn = (q_dn @ self.l2l_cat[lvl]).reshape(-1, nd) + v_dn[lvl]
        _mark(marks, "L2L")
        return self._downward_tail(q_dn, fp, fp_ovf, marks)

    def _m2l_sweep(self, q_levels):
        """V-list translations per level -> {level: (B_l, nd) downward
        equivalents}, on the operators' route (KIFMMOperators.m2l_route):
        "blocked" or "grid", that kernel at levels >= 3 and the
        per-parity sweep at exact ranks at level 2; "parity", the
        per-parity sweep at every level, at the route's ranks (capped in
        float32)."""
        ops = self._ops
        route = ops.m2l_route
        nd = ops.n_surf * ops.k0t
        v_dn = {}
        for lvl in range(2, self.depth + 1):
            nside = 1 << lvl
            h = nside // 2
            gidx = self.gidx[lvl]
            s = self.m2l_s.get(lvl)
            q = q_levels[lvl] if s is None else q_levels[lvl] / s
            q_grid = q.new_zeros((nside ** 3, nd))
            q_grid[gidx] = q
            q_grid = q_grid.reshape(nside, nside, nside, nd)
            if lvl >= 3 and route == "blocked":
                out = self._m2l_blocked(q_grid, h)
            elif lvl >= 3 and route == "grid":
                out = self._m2l_grid(q_grid)
            else:
                rr = ((ops.blk_r, ops.blk_r2) if route == "parity"
                      else ops.m2l_a.shape[1:])
                out = self._m2l_parity_sweep(q_grid, h, *rr)
            out = out.reshape(-1, nd)[gidx]
            v_dn[lvl] = out if s is None else out * s
        return v_dn

    def _m2l_blocked(self, q_grid, h):
        """Sibling-blocked M2L of one level through `m2l_grid_blocked`
        at the capped ranks -> (n^3, nd) in raster order."""
        ops = self._ops
        r, r2 = ops.blk_r, ops.blk_r2
        qr2 = q_grid @ ops.m2l_v[:, :r2]
        qb = qr2.reshape(h, 2, h, 2, h, 2, r2).permute(
            0, 2, 4, 1, 3, 5, 6).reshape(h, h, h, 8 * r2)
        qbp = F.pad(qb, (0, 0, 1, 1, 1, 1, 1, 1)).contiguous()
        accb = m2l_grid_blocked(qbp, ops.m2l_blk, ops.m2l_blk_tc)
        acc = accb.reshape(h, h, h, 2, 2, 2, r).permute(
            0, 3, 1, 4, 2, 5, 6).reshape((2 * h) ** 3, r)
        return acc @ ops.m2l_u[:, :r].T

    def _m2l_grid(self, q_grid):
        """316-offset M2L of one level through `m2l_grid` at the capped
        ranks (sctl_tpu/fmm/kifmm.py:1216-1241): project onto V, pad 3,
        sweep, expand by U -> (n, n, n, nd) in raster order."""
        ops = self._ops
        r, r2 = ops.blk_r, ops.blk_r2
        qp = F.pad(q_grid @ ops.m2l_v[:, :r2], (0, 0, 3, 3, 3, 3, 3, 3))
        return m2l_grid(qp, ops.m2l_at, ops.m2l_at_tc) @ ops.m2l_u[:, :r].T

    def _m2l_parity_sweep(self, q_grid, h, r, r2):
        """Per child parity c, the 189 valid offsets as contiguous
        shifts of the parity-major grid (sctl_tpu/fmm/kifmm.py:
        1245-1286) at ranks (r, r2), the grid zero-padded
        (`parity_sweep`) -> (n^3, nd) in raster order."""
        nd = q_grid.shape[-1]
        qr = q_grid.reshape(h, 2, h, 2, h, 2, nd).permute(
            1, 3, 5, 0, 2, 4, 6) @ self._ops.m2l_v[:, :r2]  # (2,2,2,h,h,h,r2)
        return parity_sweep(self._ops, F.pad(qr, (0, 0, 2, 2, 2, 2, 2, 2)),
                            h, h, r, r2)

    def _downward_tail(self, q_dn, fp, fp_ovf, marks=None):
        """L2T, near-field P2P and the overflow sidebands."""
        ops = self._ops
        ns = ops.n_surf
        B = self.src_tree.n_boxes
        ker, kl = self.ker_s2t, self.ker_l2t
        ct = self.cap_t
        nrm = self.p2p_nrm

        # ---- L2T ----
        if self.surface_route:
            q_cm = q_dn.reshape(B, ns, kl.kdim0).permute(2, 1, 0) \
                .contiguous()
            # the target slots past each box's count come out zero
            out_sl = l2t_surface(kl, self.surf_out_L, self.xt_sl, q_cm, ct,
                                 self.cnt_t_box)
            u_far = out_sl.reshape(kl.kdim1, B, ct).permute(1, 2, 0)
        else:
            # box-local real targets against the box's copy of the
            # equivalent surface
            u_far = p2p_ulist(
                kl, self.xt_sl.reshape(3, B, ct).transpose(0, 1)
                .contiguous(), self.surf_out_L.T.repeat(1, B), None,
                q_dn.reshape(B * ns, kl.kdim0), self.rng_e,
                self.cnt_t_box)
        u_far = u_far * kl.scale_factor
        if self.n_ovf_t:
            tb = self.tov_boxes
            xeq = self.surf_out_L[None] + self.ctr[tb][:, None, :]
            u_ovf = _apply_groups(kl, self.xt_ov2, xeq,
                                  q_dn[tb].reshape(len(tb), ns, -1)) \
                * kl.scale_factor
        else:
            u_ovf = q_dn.new_zeros((1, self.tov_cap, kl.kdim1))
        _mark(marks, "L2T")

        # ---- P2P near field, then the overflow sidebands ----
        u_near = self._p2p_near(fp)
        _mark(marks, "P2P near")
        nb = self.nb
        if self.n_ovf_s:
            # sideband sources -> padded targets of their 27 neighbours
            sb = self.sov_boxes
            tb_all = nb[sb].T.reshape(-1)                  # (27*Bo,)
            ok = tb_all >= 0
            rep = lambda a: a.repeat(27, 1, 1)[ok]
            u_all = _apply_groups(
                ker, self.xt_pad[tb_all[ok]], rep(self.xs_ov2),
                rep(fp_ovf), rep(self.ns_ov2) if nrm else None)
            u_near.index_add_(0, tb_all[ok], u_all)
        u_total = u_far + u_near * ker.scale_factor
        if self.n_ovf_t:
            # sideband targets: padded and sideband sources of the 27
            # neighbours
            tb = self.tov_boxes
            u_on = torch.zeros_like(u_ovf)
            slot_of = self.sov_slot_of_box
            for j in range(27):
                sb2 = nb[tb, j]
                okj = sb2 >= 0
                sbs = torch.where(okj, sb2, 0)
                u_on += _apply_groups(
                    ker, self.xt_ov2, self.xs_pad[sbs],
                    fp[sbs] * okj[:, None, None],
                    self.ns_pad[sbs] if nrm else None)
                if self.n_ovf_s:
                    so = slot_of[torch.where(okj, sb2, B)]
                    oks = so >= 0
                    sos = torch.where(oks, so, 0)
                    u_on += _apply_groups(
                        ker, self.xt_ov2, self.xs_ov2[sos],
                        fp_ovf[sos] * oks[:, None, None],
                        self.ns_ov2[sos] if nrm else None)
            u_ovf = u_ovf + u_on * ker.scale_factor
        _mark(marks, "P2P sidebands")
        return u_total, u_ovf

    def _p2p_near(self, fp):
        """Near field through the route's stencil: one raster gather of
        the densities into the slab or halo columns, one gather of the
        result back to Morton order -> (B, cap_t, k1), unscaled."""
        n = 1 << self.depth
        if self.near_route == "stencil9":
            f_s = slab_gather(fp, self.slab_idx)
            u_r = p2p_stencil9(self.ker_s2t, n, self.SL, self.cap_t,
                               self.xt_rast, self.xs_slab, f_s,
                               self.ns_slab, self.cnt9, self.cnt_t_rast)
        else:
            f_h = to_halo(fp, self.rast_to_mort, n)
            u_r = p2p_stencil(self.ker_s2t, n, self.cap_s, self.cap_t,
                              self.xt_rast, self.xs_halo, f_h,
                              self.ns_halo, self.cnt_s_rast,
                              self.cnt_t_rast)
        return u_r.reshape(n ** 3, self.cap_t, -1)[self.gidx[self.depth]]


def parity_sweep(ops: KIFMMOperators, qrp, hx: int, h: int, r: int,
                 r2: int):
    """The per-parity M2L sweep on a padded parity-major grid: qrp (2, 2,
    2, hx + 4, h + 4, h + 4, r2), the V-projected equivalents of a grid
    of 2 hx x 2 h x 2 h boxes with two parent planes of margin on every
    side (zeros outside the domain, a neighbour's planes on a slab's x
    faces) -> (2 hx, 2 h, 2 h, nd) downward equivalents in raster order.
    Per child parity c, the 189 valid offsets are contiguous shifts; the
    shifted windows of a chunk of offsets sit side by side, so each chunk
    is one matrix product (hx h^2, g r2) @ (g r2, r)."""
    nd = ops.m2l_u.shape[0]
    budget = (PARITY_CHUNK_ELEMS_CUDA if qrp.device.type == "cuda"
              else CHUNK_PAIRS)
    g = max(1, min(189, budget // (hx * h * h * r2)))
    outs = []
    for c in range(8):
        acc = None
        vidx = ops.par_vidx[c]
        for o0 in range(0, 189, g):
            win = torch.stack([
                qrp[ep[0], ep[1], ep[2], 2 + eb[0]:2 + eb[0] + hx,
                    2 + eb[1]:2 + eb[1] + h, 2 + eb[2]:2 + eb[2] + h]
                for eb, ep in zip(ops.par_ebs[c][o0:o0 + g],
                                  ops.par_eps[c][o0:o0 + g])], dim=3)
            mats = ops.m2l_a[vidx[o0:o0 + g], :r, :r2]      # (g, r, r2)
            y = win.reshape(hx * h * h, -1) @ mats.transpose(1, 2) \
                .reshape(-1, r)
            acc = y if acc is None else acc + y
        outs.append(acc @ ops.m2l_u[:, :r].T)
    out = torch.stack(outs).reshape(2, 2, 2, hx, h, h, nd)
    return out.permute(3, 0, 4, 1, 5, 2, 6).reshape(2 * hx, 2 * h, 2 * h, nd)
