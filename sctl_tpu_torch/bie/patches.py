"""Tensor-product quadrature patches on parametric surfaces (counterpart
of sctl_tpu/bie/patches.py:36-602).

  - discretization nodes: q x q tensor Gauss-Legendre per patch;
  - far-field quadrature: upsampled qf x qf Gauss-Legendre with surface
    Jacobian weights and a resolution-based near cutoff dist_far;
  - density interpolation: tensor Lagrange (q -> qf per axis);
  - `near_interac_batch`: the host near rule (float64) for many
    (target, element) pairs: shared Gauss-Legendre ladder rules, the
    batched Duffy rule at the closest-point preimage, and the per-pair
    rule for the rest;
  - `near_interac`: the per-pair rule (Duffy, then adaptive
    subdivision), for one pair as in the JAX package; the device near
    engine (near_device.py) hands it the pairs it does not resolve.

Host numpy in float64: the geometry is built once at setup.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..linalg.lagrange import interpolation_matrix
from ..linalg.quadrule import leg_quad_rule
from ..ops.kernels import KernelSpec
from ..ops.kernels_np import full_matrix_np, offset_blocks_np
from .boundary_integral import ElementListBase
from .legacy_quadrature import duffy_quad
from .near_device import SphereGeom, TorusGeom

_FD_H = 1e-6


def _parallel(fn, items):
    """fn over items in torch.get_num_threads() threads (numpy releases
    the interpreter lock in its array loops and BLAS calls); each call
    writes its own rows of the output."""
    from concurrent.futures import ThreadPoolExecutor
    items = list(items)
    workers = max(1, min(torch.get_num_threads(), len(items)))
    if workers == 1:
        for it in items:
            fn(it)
        return
    with ThreadPoolExecutor(workers) as pool:
        for _ in pool.map(fn, items):
            pass


def _groups(eids: np.ndarray):
    """(element, its rows in ascending order) of each element in eids:
    one stable sort in place of a mask for each element."""
    order = np.argsort(eids, kind="stable")
    ue, start = np.unique(eids[order], return_index=True)
    return zip(ue, np.split(order, start[1:]))


class ParametricPatchList(ElementListBase):
    """Patches given by charts phi: [0,1]^2 -> R^3 (one callable per
    patch, vectorized over (M, 2) parameter arrays).

    surface_batch(eids (M,), uv (M, 2)) -> X (M, 3), optional: every
    patch's chart in one vectorized call with per-row elements.
    device_geom: the exact-difference chart (near_device.DeviceGeom)
    the device near engine needs."""

    _LADDER = (2, 3, 4, 6)     # upsample multipliers over qf

    def __init__(self, charts: List[Callable], q: int = 6,
                 upsample: int = 2, flip_normal: bool = False,
                 surface_batch: Callable = None, device_geom=None):
        self.charts = charts
        self.device_geom = device_geom
        self._surface_batch = surface_batch
        self.q = q
        self.qf = q * upsample
        self.flip = -1.0 if flip_normal else 1.0
        x1, _ = leg_quad_rule(q)
        xf, wf = leg_quad_rule(self.qf)
        self._uv_q = np.stack(np.meshgrid(x1, x1, indexing="ij"),
                              -1).reshape(-1, 2)
        self._uv_f = np.stack(np.meshgrid(xf, xf, indexing="ij"),
                              -1).reshape(-1, 2)
        self._w2_f = np.outer(wf, wf).reshape(-1)
        m1 = interpolation_matrix(x1, xf)            # (q, qf)
        self._interp = np.einsum("ik,jl->ijkl", m1, m1).reshape(
            self.q ** 2, self.qf ** 2)
        self._x1 = x1
        self._node_X_all_cache = None

    # -- geometry helpers ---------------------------------------------------
    def _xyz_many(self, eids: np.ndarray, uv: np.ndarray) -> np.ndarray:
        """Surface coordinates for per-row elements: eids (M,), uv (M, 2)
        -> X (M, 3)."""
        if self._surface_batch is not None:
            return np.asarray(self._surface_batch(eids, uv))
        X = np.empty((len(eids), 3))
        for e, m in _groups(eids):
            X[m] = np.asarray(self.charts[e](uv[m]))
        return X

    def _geom_many(self, eids: np.ndarray, uv: np.ndarray):
        """(X, unit normal, Jacobian) at per-row elements and parameter
        points, tangents by central differences of step 1e-6."""
        h = _FD_H
        M = len(eids)
        pts = np.concatenate([uv, uv + [h, 0.0], uv - [h, 0.0],
                              uv + [0.0, h], uv - [0.0, h]])
        Xs = self._xyz_many(np.tile(eids, 5), pts).reshape(5, M, 3)
        nrm = np.cross((Xs[1] - Xs[2]) / (2 * h), (Xs[3] - Xs[4]) / (2 * h))
        J = np.linalg.norm(nrm, axis=1)
        return Xs[0], self.flip * nrm / np.maximum(J, 1e-300)[:, None], J

    # -- ElementListBase ------------------------------------------------------
    def size(self) -> int:
        return len(self.charts)

    def get_node_coord(self):
        E, nq = self.size(), self.q ** 2
        X, n, _ = self._geom_many(np.repeat(np.arange(E), nq),
                                  np.tile(self._uv_q, (E, 1)))
        return X, n, np.full(E, nq, dtype=np.int64)

    def get_far_field_nodes(self, tol: float):
        E, nf = self.size(), self.qf ** 2
        X, n, J = self._geom_many(np.repeat(np.arange(E), nf),
                                  np.tile(self._uv_f, (E, 1)))
        w = (self._w2_f[None, :] * J.reshape(E, nf)).reshape(-1)
        # Gauss-Legendre error ~ (c h / d)^qf with spacing h ~ diam / qf
        Xe = X.reshape(E, nf, 3)
        diam = np.linalg.norm(Xe.max(1) - Xe.min(1), axis=1)
        d_far = diam / self.qf * max(2.0, 2.0 * tol ** (-1.0 / self.qf))
        return (X, n, w, np.repeat(d_far, nf),
                np.full(E, nf, dtype=np.int64))

    def get_far_field_density(self, F):
        F = np.asarray(F)
        ne, nq, nf = self.size(), self.q ** 2, self.qf ** 2
        k = F.shape[1] if F.ndim > 1 else 1
        out = np.einsum("enk,nf->efk", F.reshape(ne, nq, k), self._interp)
        return out.reshape(ne * nf, k)

    def far_field_density_matrix(self, elem: int) -> np.ndarray:
        return self._interp                           # same every patch

    # -- near-engine host descriptors -----------------------------------------
    def _node_X_all(self) -> np.ndarray:
        """(E, q^2, 3) node coordinates of every element, cached."""
        if self._node_X_all_cache is None:
            E, nq = self.size(), self.q ** 2
            self._node_X_all_cache = self._xyz_many(
                np.repeat(np.arange(E), nq),
                np.tile(self._uv_q, (E, 1))).reshape(E, nq, 3)
        return self._node_X_all_cache

    def _preimage_batch(self, Xt: np.ndarray, elems: np.ndarray):
        """Gauss-Newton closest-point preimages of targets on their
        elements, three steps from the nearest node, finite-difference
        tangents.  -> (u0 (P, 2), adapt (P,) parameter-space distance
        estimates, dphys (P,) physical distances, ok (P,) health)."""
        P = len(elems)
        h = _FD_H
        d2 = ((self._node_X_all()[elems] - Xt[:, None, :]) ** 2).sum(-1)
        u = self._uv_q[np.argmin(d2, axis=1)].copy()
        good = np.ones(P, bool)
        r = Xt
        a = c = np.ones(P)
        for _ in range(3):
            u = np.clip(u, 0.0, 1.0)
            pts = np.concatenate([u, u + [h, 0.0], u - [h, 0.0],
                                  u + [0.0, h], u - [0.0, h]])
            Xs = self._xyz_many(np.tile(elems, 5), pts).reshape(5, P, 3)
            tu = (Xs[1] - Xs[2]) / (2 * h)
            tv = (Xs[3] - Xs[4]) / (2 * h)
            r = Xt - Xs[0]
            a, b, c = (tu * tu).sum(1), (tu * tv).sum(1), (tv * tv).sum(1)
            g0, g1 = (tu * r).sum(1), (tv * r).sum(1)
            det = a * c - b * b
            bad = ~(det > 1e-300)
            good &= ~bad
            det = np.where(bad, 1.0, det)
            du = np.stack([(c * g0 - b * g1) / det,
                           (a * g1 - b * g0) / det], 1)
            u = u + np.where(bad[:, None], 0.0, du)
        adapt = np.sqrt((r * r).sum(1) / np.maximum(np.maximum(a, c),
                                                    1e-300))
        return u, adapt, np.sqrt((r * r).sum(1)), good

    # -- per-pair host rule -----------------------------------------------------
    def _geom(self, chart, uv):
        """(X, unit normal, Jacobian) of one chart at parameters uv
        (M, 2), central-difference tangents."""
        h = _FD_H
        X = np.asarray(chart(uv))
        tu = (np.asarray(chart(uv + [h, 0.0]))
              - np.asarray(chart(uv - [h, 0.0]))) / (2 * h)
        tv = (np.asarray(chart(uv + [0.0, h]))
              - np.asarray(chart(uv - [0.0, h]))) / (2 * h)
        nrm = np.cross(tu, tv)
        J = np.linalg.norm(nrm, axis=1)
        return X, self.flip * nrm / np.maximum(J, 1e-300)[:, None], J

    def _geom_charts(self, eids: np.ndarray, uv: np.ndarray):
        """`_geom` with per-row elements, one chart call per element:
        the per-pair rule's geometry, to the last bit."""
        X, n, J = np.empty((len(eids), 3)), np.empty((len(eids), 3)), \
            np.empty(len(eids))
        for e, m in _groups(eids):
            X[m], n[m], J[m] = self._geom(self.charts[e], uv[m])
        return X, n, J

    def _kernel_blocks(self, kernel: KernelSpec, xt, X, n):
        """(M, k0, k1) blocks of one target against M surface points."""
        return full_matrix_np(kernel, xt[None], X, n).reshape(
            len(X), kernel.kdim0, kernel.kdim1)

    def _node_X(self, elem: int) -> np.ndarray:
        """(q^2, 3) node coordinates of one element."""
        return self._node_X_all()[elem]

    def near_interac_batch(self, kernel: KernelSpec, Xt: np.ndarray,
                           elems: np.ndarray, tol: float) -> np.ndarray:
        """(P, q^2 k0, k1) near-singular operators of P (target, element)
        pairs (sctl_tpu patches.py:217-371), in three classes, each in
        element-grouped waves:
          - Gauss-Legendre resolvable: the shared tensor rule of the
            ladder {2, 3, 4, 6} qf picked per pair by the GL error model
            of dist_far ((2 h_k / d)^{q_k} <= tol / 10);
          - (near-)singular: the batched Duffy rule at the Gauss-Newton
            preimage, orders 16 and 12 (24 and 18 below tol 1e-7); where
            they disagree by more than 30 tol, order + 8;
          - the rest (a failed preimage, or order + 8 still off): the
            per-pair rule, all such pairs in one batch.
        The Duffy class evaluates the geometry and kernel at the live
        (nonzero-weight) points of the padded rule only; the products
        are the padded ones, zeros included.  The waves run in
        torch.get_num_threads() threads.  Each pair's class (k >= 0 the
        ladder band, -1 Duffy, -2 the per-pair rule) goes to
        `last_classes`, the count of the last to `last_fallback_count`."""
        from .legacy_quadrature import duffy_quad_batch
        Xt = np.atleast_2d(np.asarray(Xt, np.float64))
        elems = np.asarray(elems, np.int64)
        P = len(elems)
        k0, k1 = kernel.kdim0, kernel.kdim1
        nq = self.q ** 2
        out = np.zeros((P, nq * k0, k1))
        self.last_fallback_count, self.last_classes = 0, np.zeros(0, int)
        if P == 0:
            return out
        u0, adapt, dphys, ok = self._preimage_batch(Xt, elems)
        X_all = self._node_X_all()
        diam = np.linalg.norm(X_all.max(1) - X_all.min(1), axis=1)
        orders = [m * self.qf for m in self._LADDER]
        band = np.full(P, -1, np.int64)
        for k in range(len(orders) - 1, -1, -1):
            dk = (2.0 * (diam[elems] / orders[k])
                  * (0.1 * tol) ** (-1.0 / orders[k]))
            band = np.where(dphys >= dk, k, band)
        fallback = ~ok
        band = np.where(fallback, -2, band)

        # ladder classes: one geometry call per band for its elements,
        # then per-pair kernel blocks and batched products
        for k, qk in enumerate(orders):
            idx = np.where(band == k)[0]
            if len(idx) == 0:
                continue
            x1, w1 = leg_quad_rule(qk)
            uv = np.stack(np.meshgrid(x1, x1, indexing="ij"),
                          -1).reshape(-1, 2)
            ww = np.outer(w1, w1).reshape(-1)
            S = len(ww)
            ue, inv = np.unique(elems[idx], return_inverse=True)
            Xg, ng, Jg = self._geom_many(np.repeat(ue, S),
                                         np.tile(uv, (len(ue), 1)))
            Xg, ng = Xg.reshape(len(ue), S, 3), ng.reshape(len(ue), S, 3)
            bw = (self._basis(uv).T[None]
                  * (ww[None, :] * Jg.reshape(len(ue), S))[:, None, :])
            chunk = max(64, int(5e6) // S)

            def ladder(c0, idx=idx, inv=inv, Xg=Xg, ng=ng, bw=bw, S=S,
                       chunk=chunk):
                sl, ip = idx[c0:c0 + chunk], inv[c0:c0 + chunk]
                blk = offset_blocks_np(kernel, Xt[sl][:, None, :] - Xg[ip],
                                       ns=ng[ip])
                out[sl] = np.matmul(bw[ip], blk.reshape(len(ip), S, k0 * k1)
                                    ).reshape(len(ip), nq * k0, k1)

            _parallel(ladder, range(0, len(idx), chunk))

        def duffy_eval(sel, order):
            nds, wts = duffy_quad_batch(u0[sel], order, adapt[sel])
            Pc, npts = nds.shape[:2]
            live = wts.reshape(-1) != 0.0
            pts = nds.reshape(-1, 2)[live]
            X, n, J = self._geom_many(
                np.repeat(elems[sel], npts)[live], pts)
            blk = np.zeros((Pc * npts, k0 * k1))
            blk[live] = offset_blocks_np(
                kernel, np.repeat(Xt[sel], npts, axis=0)[live] - X,
                ns=n).reshape(-1, k0 * k1)
            bw = np.zeros((Pc * npts, nq))
            bw[live] = self._basis(pts) * (wts.reshape(-1)[live] * J)[:, None]
            return np.matmul(bw.reshape(Pc, npts, nq).transpose(0, 2, 1),
                             blk.reshape(Pc, npts, k0 * k1)).reshape(
                Pc, nq * k0, k1)

        # singular class: Duffy is the trusted rule there (the Gauss
        # identity); pairs of similar shell counts chunk together
        didx = np.where(band == -1)[0]
        order_hi, order_lo = (16, 12) if tol >= 1e-7 else (24, 18)
        kkey = np.where(adapt[didx] < 1e-7, 1.0, adapt[didx])
        didx = didx[np.argsort(-kkey, kind="stable")]
        miss = np.zeros(P, bool)

        def duffy(sel):
            hi = duffy_eval(sel, order_hi)
            out[sel] = hi
            lo = duffy_eval(sel, order_lo)
            scale = np.maximum(np.abs(hi).reshape(len(sel), -1).max(1),
                               1e-300)
            miss[sel] = (np.abs(hi - lo).reshape(len(sel), -1).max(1)
                         > 30 * tol * scale)

        def escalate(sel):
            prev = out[sel].copy()
            hi2 = duffy_eval(sel, order_hi + 8)
            out[sel] = hi2
            scale = np.maximum(np.abs(hi2).reshape(len(sel), -1).max(1),
                               1e-300)
            fallback[sel[np.abs(hi2 - prev).reshape(len(sel), -1).max(1)
                         > 30 * tol * scale]] = True

        _parallel(duffy, [didx[c0:c0 + 512]
                          for c0 in range(0, len(didx), 512)])
        retry = didx[miss[didx]]
        _parallel(escalate, [retry[c0:c0 + 256]
                             for c0 in range(0, len(retry), 256)])

        fb = np.where(fallback)[0]
        if len(fb):
            out[fb] = self._near_interac_pairs(kernel, Xt[fb], elems[fb],
                                               tol)
        self.last_fallback_count = len(fb)
        self.last_classes = np.where(fallback, -2, band)
        return out

    def near_interac(self, kernel: KernelSpec, xt: np.ndarray, elem: int,
                     tol: float) -> np.ndarray:
        """(q^2 k0, k1) near-singular operator of one (target, element)
        pair (sctl_tpu patches.py:372): the Duffy rule at the target's
        closest-point preimage, adaptive subdivision where its two
        orders disagree."""
        return self._near_interac_pairs(
            kernel, np.asarray(xt, np.float64)[None],
            np.array([int(elem)]), tol)[0]

    def _near_interac_pairs(self, kernel: KernelSpec, Xt: np.ndarray,
                            elems: np.ndarray, tol: float) -> np.ndarray:
        """`near_interac` for P pairs -> (P, q^2 k0, k1), each by the
        per-pair rule of sctl_tpu patches.py:393-508: the geometric-shell
        Duffy rule at the target's closest-point preimage (orders 16
        and 12, or 24 and 18 below tol 1e-7), and where the two orders
        disagree by more than 30 tol, adaptive subdivision.  The
        subdivision runs for all such pairs at once, one wave of cells
        per refinement generation (each pair's cells and sums are its
        own)."""
        Xt = np.atleast_2d(np.asarray(Xt, np.float64))
        elems = np.asarray(elems, np.int64)
        nq, k0, k1 = self.q ** 2, kernel.kdim0, kernel.kdim1
        out = np.zeros((len(Xt), nq * k0, k1))
        rest = []
        for i, (xt, e) in enumerate(zip(Xt, elems)):
            m = self._near_interac_duffy(kernel, xt, int(e), tol)
            if m is None:
                rest.append(i)
            else:
                out[i] = m
        if rest:
            rest = np.asarray(rest)
            out[rest] = self._near_interac_adaptive(kernel, Xt[rest],
                                                    elems[rest], tol)
        return out

    def _near_interac_duffy(self, kernel, xt, elem, tol):
        ch = self.charts[elem]
        k0, k1 = kernel.kdim0, kernel.kdim1
        X0 = np.asarray(ch(self._uv_q))
        u0 = self._uv_q[np.argmin(((X0 - xt) ** 2).sum(1))].copy()
        h = _FD_H
        adapt = -1.0
        for _ in range(3):                     # Gauss-Newton preimage
            u0 = np.clip(u0, 0.0, 1.0)
            Xs = np.asarray(ch(np.array([u0, u0 + [h, 0], u0 - [h, 0],
                                         u0 + [0, h], u0 - [0, h]])))
            Jm = np.stack([(Xs[1] - Xs[2]) / (2 * h),
                           (Xs[3] - Xs[4]) / (2 * h)], axis=1)
            r = xt - Xs[0]
            JtJ = Jm.T @ Jm
            try:
                u0 = u0 + np.linalg.solve(JtJ, Jm.T @ r)
            except np.linalg.LinAlgError:
                return None
            adapt = float(np.sqrt((r @ r) / max(JtJ[0, 0], JtJ[1, 1])))

        def rule(order):
            nds, wts = duffy_quad(u0, order, adapt)
            X, n, Jq = self._geom(ch, nds)
            km = self._kernel_blocks(kernel, xt, X, n)
            return np.einsum("p,pn,pab->nab", wts * Jq, self._basis(nds),
                             km)

        order_hi, order_lo = (16, 12) if tol >= 1e-7 else (24, 18)
        lo, hi = rule(order_lo), rule(order_hi)
        if np.abs(hi - lo).max() > 30 * tol * max(np.abs(hi).max(),
                                                  1e-300):
            return None
        return hi.reshape(self.q ** 2 * k0, k1)

    def _near_interac_adaptive(self, kernel, Xt, elems, tol,
                               max_cells: int = 20000, chunk: int = 1024):
        """Subdivide each pair's parameter square toward its
        near-singular point until the 8- and 16-point panel rules of a
        cell agree to tol times the pair's largest cell integral, at
        most max_cells cells a pair (then its pending cells count with
        the 16-point rule).  -> (P, q^2 k0, k1)."""
        k0, k1 = kernel.kdim0, kernel.kdim1
        nq = self.q ** 2
        P = len(Xt)
        rules = []
        for m in (8, 16):
            x, w = leg_quad_rule(m)
            rules.append((np.stack(np.meshgrid(x, x, indexing="ij"),
                                   -1).reshape(-1, 2),
                          np.outer(w, w).reshape(-1)))

        def wave(pair, los, sizes, uv, ww):
            """(C, nq, k0, k1) integrals of C cells of the given pairs."""
            C, M = len(pair), len(uv)
            pts = (los[:, None, :] + uv[None] * sizes[:, None, None]
                   ).reshape(-1, 2)
            X, n, J = self._geom_charts(np.repeat(elems[pair], M), pts)
            d = np.repeat(Xt[pair], M, axis=0) - X
            km = offset_blocks_np(kernel, d, ns=n).reshape(C, M, k0 * k1)
            bw = (self._basis(pts).reshape(C, M, nq)
                  * (ww[None] * J.reshape(C, M)
                     * (sizes ** 2)[:, None])[..., None])
            return np.matmul(bw.transpose(0, 2, 1), km).reshape(
                C, nq, k0, k1)

        out = np.zeros((P, nq, k0, k1))
        fmax = np.zeros(P)
        cells = np.zeros(P, np.int64)
        pair = np.arange(P)
        los, sizes = np.zeros((P, 2)), np.ones(P)
        while len(pair):
            i16 = np.empty((len(pair), nq, k0, k1))
            err = np.empty(len(pair))
            for c0 in range(0, len(pair), chunk):
                c = slice(c0, c0 + chunk)
                a = wave(pair[c], los[c], sizes[c], *rules[0])
                i16[c] = wave(pair[c], los[c], sizes[c], *rules[1])
                err[c] = np.abs(a - i16[c]).reshape(len(a), -1).max(1)
            np.maximum.at(fmax, pair, np.abs(i16).reshape(len(pair), -1)
                          .max(1))
            np.add.at(cells, pair, 1)
            done = ((err < tol * np.maximum(fmax[pair], 1e-300))
                    | (sizes < 1e-7) | (cells[pair] >= max_cells))
            np.add.at(out, pair[done], i16[done])
            h = sizes[~done] / 2
            lo_r = los[~done]
            pair = np.tile(pair[~done], 4)
            los = np.concatenate([lo_r + np.stack([dx * h, dy * h], 1)
                                  for dx in (0.0, 1.0)
                                  for dy in (0.0, 1.0)])
            sizes = np.tile(h, 4)
        return out.reshape(P, nq * k0, k1)

    def _basis(self, uv: np.ndarray) -> np.ndarray:
        """Tensor Lagrange basis at (P, 2) parameters -> (P, q^2)."""
        mu = interpolation_matrix(self._x1, uv[:, 0])
        mv = interpolation_matrix(self._x1, uv[:, 1])
        return (mu.T[:, :, None] * mv.T[:, None, :]).reshape(
            len(uv), self.q ** 2)


# -- standard closed surfaces ------------------------------------------------

def sphere_patches(n_per_face: int = 1, q: int = 6, radius: float = 1.0,
                   upsample: int = 2) -> ParametricPatchList:
    """Cubed sphere: 6 n^2 patches."""
    axes = [(0, 1, 2, +1), (0, 1, 2, -1), (1, 2, 0, +1),
            (1, 2, 0, -1), (2, 0, 1, +1), (2, 0, 1, -1)]
    ax_arr = np.asarray([(a, b, c) for (a, b, c, _) in axes])
    sgn_arr = np.asarray([s for (_, _, _, s) in axes], np.float64)
    h = 1.0 / n_per_face
    npf = n_per_face * n_per_face

    def surface_batch(eids, uv):
        eids = np.asarray(eids)
        f, w = eids // npf, eids % npf
        uu = ((w // n_per_face) * h + uv[:, 0] * h) * 2 - 1
        vv = ((w % n_per_face) * h + uv[:, 1] * h) * 2 - 1
        p = np.empty((len(eids), 3))
        rows = np.arange(len(eids))
        p[rows, ax_arr[f, 0]] = uu
        p[rows, ax_arr[f, 1]] = vv * sgn_arr[f]   # keeps normals outward
        p[rows, ax_arr[f, 2]] = sgn_arr[f]
        return radius * p / np.linalg.norm(p, axis=1)[:, None]

    def make(a, b, c, sgn, u0, v0):
        def chart(uv):
            p = np.zeros((len(uv), 3))
            p[:, a] = (u0 + uv[:, 0] * h) * 2 - 1
            p[:, b] = ((v0 + uv[:, 1] * h) * 2 - 1) * sgn
            p[:, c] = sgn
            return radius * p / np.linalg.norm(p, axis=1)[:, None]
        return chart

    charts = [make(a, b, c, sgn, i * h, j * h) for (a, b, c, sgn) in axes
              for i in range(n_per_face) for j in range(n_per_face)]
    return ParametricPatchList(charts, q=q, upsample=upsample,
                               surface_batch=surface_batch,
                               device_geom=SphereGeom(n_per_face, radius,
                                                      axes))


def torus_patches(nu: int = 4, nv: int = 2, q: int = 6, R: float = 2.0,
                  r: float = 0.5, upsample: int = 2) -> ParametricPatchList:
    """Torus (major R, minor r) split into nu x nv patches; outward
    normals."""

    def surface_batch(eids, uv):
        eids = np.asarray(eids)
        th = 2 * np.pi * ((eids // nv) / nu + uv[:, 0] / nu)
        ph = 2 * np.pi * ((eids % nv) / nv + uv[:, 1] / nv)
        return np.stack([(R + r * np.cos(ph)) * np.cos(th),
                         (R + r * np.cos(ph)) * np.sin(th),
                         r * np.sin(ph)], 1)

    def make(u0, v0, hu=1 / nu, hv=1 / nv):
        def chart(uv):
            th = 2 * np.pi * (u0 + uv[:, 0] * hu)
            ph = 2 * np.pi * (v0 + uv[:, 1] * hv)
            return np.stack([(R + r * np.cos(ph)) * np.cos(th),
                             (R + r * np.cos(ph)) * np.sin(th),
                             r * np.sin(ph)], 1)
        return chart

    charts = [make(i / nu, j / nv) for i in range(nu) for j in range(nv)]
    return ParametricPatchList(charts, q=q, upsample=upsample,
                               surface_batch=surface_batch,
                               device_geom=TorusGeom(nu, nv, R, r))
