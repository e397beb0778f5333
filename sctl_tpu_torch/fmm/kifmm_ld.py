"""Extended-precision (80-bit longdouble) KIFMM evaluator on the host
(counterpart of sctl_tpu/fmm/kifmm_ld.py:78-264; the reference's
QuadReal / long-double FMM, math_utils.hpp:236-300, src/test-fmm.cpp).

This is the reference's own host evaluator, the accuracy oracle of the
float64 ladder, and it stays one: numpy longdouble, which the card has
no type for (sctl_tpu/fmm/kifmm_ld.py:20-23).  It is not a fallback of
the card's `KIFMM`.  The float64 KIFMM plateaus near 7e-9 (BASELINE.md
ladder) because its equivalent-surface pseudo-inverses invert float64
kernel matrices and its tables store 1/rcond-amplified products; here
uc2e and dc2e are built from longdouble kernel matrices (a float64 SVD
chooses the rank, Newton-Schulz iterations in longdouble refine within
it, `quadmath.ld_gemm`), and every translation (S2M checks, M2M, M2L,
L2L, L2T, P2P) evaluates its kernel matrix on the fly in longdouble.
M2L stays linear: one kernel matrix per (level, offset), all boxes with
that offset in one product.

The per-level pseudo-inverses are read from the data directory
(`config.data_path()`, the JAX package's `kifmm_ld_*.npz` name and
layout) where the file exists; otherwise they are built cold and cached
under `sctl_tpu_torch/_build/`, never in the data directory.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import data_path
from ..ops.kernels import KernelSpec
from ..ops.kernels_np import full_matrix_np
from ..ops.m2l import vlist_offsets
from ..quadmath import ld_gemm
from ..tree import morton as mt
from ..tree.tree import UniformTree
from .kifmm import RAD_IN, RAD_OUT, cube_surface, kernel_roles

LD = np.longdouble
# cold builds of the pseudo-inverse tables
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def _kmat_ld(ker: KernelSpec, xt, xs, ns=None) -> np.ndarray:
    """(Nt*k1, Ns*k0) longdouble kernel matrix (u = M @ f)."""
    return full_matrix_np(ker, np.asarray(xt, LD), np.asarray(xs, LD),
                          None if ns is None else np.asarray(ns, LD)).T


def _pinv_ld(A: np.ndarray, rcond: float) -> np.ndarray:
    """Pseudo-inverse of a longdouble matrix: a float64 SVD selects the
    retained subspace at `rcond`, four Newton-Schulz iterations against
    the longdouble A refine within it (the kifmm._pinv_ns discipline)."""
    U, s, Vt = np.linalg.svd(np.asarray(A, np.float64), full_matrices=False)
    r = max(1, int((s > rcond * s[0]).sum()))
    X = ((Vt[:r].T / s[:r]) @ U[:, :r].T).astype(LD)
    eye = np.eye(A.shape[0], dtype=LD)
    for _ in range(4):
        X = ld_gemm(X, 2 * eye - ld_gemm(np.asarray(A, LD), X))
    return X


def _level_coords(lvl: int) -> np.ndarray:
    """(8^lvl, 3) integer grid coordinates of level-lvl boxes in Morton
    index order."""
    return mt.box_coords(mt.level_keys(lvl), lvl).astype(np.int64)


def table_name(ker_name: str, p: int, rcond: float, lam) -> str:
    """The JAX package's file name of one level's (uc2e, dc2e) pair."""
    return f"kifmm_ld_{ker_name}_p{p}_r{rcond:.3g}_lam{float(lam):.9g}.npz"


class KIFMMLd:
    """Uniform-tree KIFMM evaluated entirely in longdouble on the host
    (see the module docstring).  The API of `KIFMM`'s host entry:
    setup(x_src, x_trg, n_src).eval(f) -> (Nt, k1) float64 potentials
    in input order.  `table_source` records, per level, where its
    pseudo-inverses came from: "data" (the data directory), "cache"
    (an earlier cold build) or "built"."""

    def __init__(self, ker_s2t: KernelSpec, p: int = 10, depth: int = 2,
                 rcond: float = 1e-11, ker_l2t: Optional[KernelSpec] = None,
                 ker_s2m: Optional[KernelSpec] = None):
        self.ker_s2t = ker_s2t
        self.ker_trans, self.ker_l2t, self.ker_s2m = kernel_roles(
            ker_s2t, ker_l2t, ker_s2m)
        self.p = p
        self.depth = depth
        self.rcond = rcond

    # -- setup -------------------------------------------------------------
    def setup(self, x_src, x_trg, n_src=None):
        L = self.depth
        if L < 2:
            raise ValueError("depth must be >= 2")
        x_src = np.asarray(x_src, np.float64)
        x_trg = np.asarray(x_trg, np.float64)
        both = np.concatenate([x_src, x_trg])
        bbox = (both.min(0), both.max(0))
        self.src_tree = UniformTree(x_src, L, bbox=bbox)
        self.trg_tree = UniformTree(x_trg, L, bbox=bbox)
        self.scale = self.src_tree.scale
        self._n_src_sorted = (None if n_src is None else
                              np.asarray(n_src, np.float64)[
                                  self.src_tree.perm])
        surf = np.asarray(cube_surface(self.p), LD)
        self.n_surf = len(surf)
        # per-level surfaces (side scale / 2^l) and their two pinvs,
        # keyed on the level's side, since the surfaces scale with the
        # tree's box
        self.s_in, self.s_out, self.uc2e, self.dc2e = {}, {}, {}, {}
        self.table_source = {}
        for l in range(2, L + 1):
            lam = LD(self.scale) / (1 << l)
            self.s_in[l] = surf * (LD(RAD_IN) * lam / 2)
            self.s_out[l] = surf * (LD(RAD_OUT) * lam / 2)
            name = table_name(self.ker_trans.name, self.p, self.rcond, lam)
            for where, d in (("data", data_path()), ("cache", CACHE_DIR)):
                path = os.path.join(d, name)
                if os.path.exists(path):
                    z = np.load(path)
                    self.uc2e[l] = z["uc2e"].astype(LD)
                    self.dc2e[l] = z["dc2e"].astype(LD)
                    self.table_source[l] = where
                    break
            else:
                self.uc2e[l] = _pinv_ld(
                    _kmat_ld(self.ker_trans, self.s_out[l], self.s_in[l]),
                    self.rcond)
                self.dc2e[l] = _pinv_ld(
                    _kmat_ld(self.ker_trans, self.s_in[l], self.s_out[l]),
                    self.rcond)
                self.table_source[l] = "built"
                os.makedirs(CACHE_DIR, exist_ok=True)
                tmp = os.path.join(CACHE_DIR, f".{os.getpid()}.{name}")
                np.savez(tmp, uc2e=self.uc2e[l], dc2e=self.dc2e[l])
                os.replace(tmp, os.path.join(CACHE_DIR, name))
        self.offsets, _ = vlist_offsets()
        return self

    # -- helpers -----------------------------------------------------------
    def _ctr(self, lvl: int) -> np.ndarray:
        """(8^lvl, 3) longdouble box centres at level lvl."""
        c = _level_coords(lvl).astype(LD)
        ctr01 = (c + 0.5) / (1 << lvl)
        return ctr01 * LD(self.scale) + np.asarray(self.src_tree.offset, LD)

    # -- eval --------------------------------------------------------------
    def eval(self, f) -> np.ndarray:
        L = self.depth
        st, tt = self.src_tree, self.trg_tree
        k0, k1 = self.ker_s2t.kdim0, self.ker_l2t.kdim1
        k0t, k1t = self.ker_trans.kdim0, self.ker_trans.kdim1
        nsrf = self.n_surf
        f = np.asarray(f, LD).reshape(-1, k0)
        f_sorted = f[st.perm]
        xs = np.asarray(st.X_sorted, LD)
        xt = np.asarray(tt.X_sorted, LD)
        ns_s = (None if self._n_src_sorted is None
                else np.asarray(self._n_src_sorted, LD))
        B = st.n_boxes
        sdsp, scnt = st.box_dsp, st.box_cnt
        tdsp, tcnt = tt.box_dsp, tt.box_cnt
        ctr_L = self._ctr(L)

        # ---- S2M: leaf check potentials -> upward equivalents ----
        q_up = {L: np.zeros((B, nsrf * k0t), LD)}
        for b in np.nonzero(scnt)[0]:
            s0, s1 = sdsp[b], sdsp[b + 1]
            K = _kmat_ld(self.ker_s2m, self.s_out[L] + ctr_L[b], xs[s0:s1],
                         None if ns_s is None else ns_s[s0:s1])
            q_up[L][b] = self.uc2e[L] @ (K @ f_sorted[s0:s1].ravel())

        # ---- M2M upward (octant kernels on the fly) ----
        child_pos = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                              for c in range(8)], dtype=np.int64)
        for l in range(L, 2, -1):
            side = LD(self.scale) / (1 << l)
            u_chk = np.zeros((1 << (3 * (l - 1)), nsrf * k1t), LD)
            for c in range(8):
                cc = (np.asarray(child_pos[c], LD) - 0.5) * side
                K = _kmat_ld(self.ker_trans, self.s_out[l - 1],
                             self.s_in[l] + cc)
                u_chk += q_up[l][c::8] @ K.T
            q_up[l - 1] = u_chk @ self.uc2e[l - 1].T

        # ---- M2L + L2L downward: check potentials per level ----
        q_dn = {}
        for l in range(2, L + 1):
            n_l = 1 << l
            Bl = 1 << (3 * l)
            side = LD(self.scale) / (1 << l)
            coords = _level_coords(l)
            u_chk = np.zeros((Bl, nsrf * k1t), LD)
            lin = (coords[:, 0] * n_l + coords[:, 1]) * n_l + coords[:, 2]
            mort_of_lin = np.empty(Bl, np.int64)
            mort_of_lin[lin] = np.arange(Bl)
            # M2L: the boxes of one offset in one product
            for d in self.offsets:
                sc = coords + d[None, :]
                ok = np.all((sc >= 0) & (sc < n_l), axis=1)
                # the parents must be adjacent (the V-list criterion)
                ok &= np.all(np.abs((coords >> 1) - (sc >> 1)) <= 1, axis=1)
                if not ok.any():
                    continue
                tidx = np.nonzero(ok)[0]
                sl = (sc[tidx, 0] * n_l + sc[tidx, 1]) * n_l + sc[tidx, 2]
                qs = q_up[l][mort_of_lin[sl]]
                if not np.abs(qs).any():
                    continue
                K = _kmat_ld(self.ker_trans, self.s_in[l],
                             self.s_in[l] + np.asarray(d, LD) * side)
                u_chk[tidx] += qs @ K.T
            # L2L: parent downward equivalent -> child downward check
            if l > 2:
                for c in range(8):
                    cc = (np.asarray(child_pos[c], LD) - 0.5) * side
                    K = _kmat_ld(self.ker_trans, self.s_in[l] + cc,
                                 self.s_out[l - 1])
                    u_chk[c::8] += q_dn[l - 1] @ K.T
            q_dn[l] = u_chk @ self.dc2e[l].T

        # ---- L2T + P2P ----
        u = np.zeros((len(xt), k1), LD)
        nb = st.neighbor_boxes()
        for b in np.nonzero(tcnt)[0]:
            t0, t1 = tdsp[b], tdsp[b + 1]
            K = _kmat_ld(self.ker_l2t, xt[t0:t1], self.s_out[L] + ctr_L[b])
            u[t0:t1] += (K @ q_dn[L][b]).reshape(t1 - t0, k1)
            for s in nb[b]:
                if s < 0 or scnt[s] == 0:
                    continue
                s0, s1 = sdsp[s], sdsp[s + 1]
                Kp = _kmat_ld(self.ker_s2t, xt[t0:t1], xs[s0:s1],
                              None if ns_s is None else ns_s[s0:s1])
                u[t0:t1] += (Kp @ f_sorted[s0:s1].ravel()).reshape(
                    t1 - t0, k1)

        out = np.empty_like(u)
        out[tt.perm] = u
        return np.asarray(out, np.float64)
