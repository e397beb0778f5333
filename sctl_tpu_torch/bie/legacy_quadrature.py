"""Legacy boundary-quadrature layer: tensor-product surface elements with
Duffy-type singular quadrature (counterpart of
sctl_tpu/bie/legacy_quadrature.py:53-624).

  TensorBasis          tensor Lagrange basis at first-kind Chebyshev nodes
  duffy_quad           geometric shell / panel rule at a (possibly
                       off-element) singular point
  duffy_radii_batch,   the same rule for many points at once, padded to
  duffy_quad_batch     one shell count (zero-weight padding)
  tensor_gauss_quad    tensor Gauss-Legendre rule on [0, 1]^2
  BasisElemList        a surface as tensor-basis elements
  setup_singular       self-element corrections: Duffy minus the direct
                       tensor rule of the same element
  build_nbr_list       near (target, element) pairs by bounding spheres
  setup_near_singular  near-element corrections: Duffy at the closest
                       point's preimage minus the direct rule
  LegacyQuadrature     setup, and eval on the op's device

The setup's geometry, preimages, pair lists and direct rules are host
numpy in float64, as in the JAX package.  Its Duffy blocks, nearly all
of its arithmetic, are formed in float64 on the quadrature's device
(the card unless "cpu"): pairs of one shell count together, each panel
of the rule a tensor product (the same rule as `duffy_quad`, its sums
taken in another order).
`LegacyQuadrature.eval` runs on the device: the upsampling product, the
far sum through `direct_eval_blocked` (the `p2p` kernel on the card) and
the corrections as batched products with an `index_add_` scatter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..linalg.quadrule import leg_quad_rule
from ..ops.kernels import KernelSpec
from ..ops.kernels_np import full_matrix_np, offset_blocks_np

__all__ = [
    "TensorBasis", "duffy_quad", "duffy_radii_batch", "duffy_quad_batch",
    "tensor_gauss_quad", "BasisElemList", "setup_singular",
    "build_nbr_list", "setup_near_singular", "LegacyQuadrature",
]

_DUFFY_KMAX = 28      # padded shell cap of the batched rule
_CHUNK_POINTS = 50_000    # Duffy points a chunk on the CPU (64x on a card)


class TensorBasis:
    """Tensor-product Lagrange basis on [0, 1]^dim at first-kind
    Chebyshev nodes x_i = 1/2 - cos((2i + 1) pi / 2q) / 2, stored
    nodally; values and gradients are interpolation matrices
    (size, Npts)."""

    def __init__(self, order: int, dim: int = 2):
        self.order = order
        self.dim = dim
        i = np.arange(order)
        self.nodes1d = 0.5 - 0.5 * np.cos((2 * i + 1) * np.pi
                                          / (2 * order))

    @property
    def size(self) -> int:
        return self.order ** self.dim

    def nodes(self) -> np.ndarray:
        """(dim, order^dim) tensor grid, axis 0 fastest."""
        grids = np.meshgrid(*([self.nodes1d] * self.dim), indexing="ij")
        return np.stack([g.T.ravel() for g in grids], axis=0)

    def _ratios(self, x: np.ndarray) -> np.ndarray:
        """(q, q, N): (x - x_k) / (x_j - x_k) at [j, k], 1 on k = j."""
        xn = self.nodes1d
        den = xn[:, None] - xn[None, :]
        np.fill_diagonal(den, 1.0)
        R = (np.asarray(x)[None, None, :] - xn[None, :, None]) \
            / den[:, :, None]
        R[np.arange(self.order), np.arange(self.order)] = 1.0
        return R

    def _lag1d(self, x: np.ndarray) -> np.ndarray:
        """(order, len(x)) 1-D Lagrange cardinal values: the products of
        the ratios (x - x_k) / (x_j - x_k) in the reference's order, one
        factor k at a time (the geometry near a singular point is
        sensitive to their last bit)."""
        xn, q = self.nodes1d, self.order
        den = xn[:, None] - xn[None, :]
        np.fill_diagonal(den, 1.0)
        x = np.asarray(x, np.float64)
        out = np.ones((q, len(x)))
        for k in range(q):
            r = (x - xn[k])[None, :] / den[:, k, None]
            r[k] = 1.0
            out *= r
        return out

    def _lag(self, x: np.ndarray):
        """1-D cardinal values and derivatives (q, N) at x (N,):
        l_j' = l_j sum_{k != j} 1 / (x - x_k); at a node, the sum over
        l != j of prod_{k != j, l} R[j, k] / (x_j - x_l) from prefix
        and suffix products."""
        x = np.asarray(x, np.float64)
        xn, q = self.nodes1d, self.order
        lag = self._lag1d(x)
        d = x[None, :] - xn[:, None]
        hit = (d == 0.0).any(0)
        d[:, hit] = 1.0
        dlag = lag * ((1.0 - np.eye(q)) @ (1.0 / d))
        if hit.any():
            Rh = self._ratios(x[hit])
            ones = np.ones_like(Rh[:, :1])
            pre = np.cumprod(np.concatenate([ones, Rh[:, :-1]], 1), axis=1)
            suf = np.cumprod(np.concatenate([ones, Rh[:, :0:-1]], 1),
                             axis=1)[:, ::-1]
            den = xn[:, None] - xn[None, :]
            np.fill_diagonal(den, np.inf)
            dlag[:, hit] = ((1.0 / den)[:, :, None] * pre * suf).sum(1)
        return lag, dlag

    def _combine(self, mats, n: int) -> np.ndarray:
        """Tensor product of 1-D matrices, index i0 + q i1 + ..."""
        if self.dim == 2:
            return (mats[1][:, None, :] * mats[0][None, :, :]).reshape(-1, n)
        out = mats[0]
        for d in range(1, self.dim):
            out = (out[:, None, :] * mats[d][None, :, :]).reshape(-1, n)
        q = self.order
        idx = np.arange(self.size).reshape([q] * self.dim)
        perm = idx.transpose(list(range(self.dim))[::-1]).ravel()
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.size)
        return out[inv]

    def eval_matrix(self, pts: np.ndarray) -> np.ndarray:
        """(size, Npts) interpolation matrix at pts (dim, Npts)."""
        return self._combine([self._lag1d(pts[d]) for d in range(self.dim)],
                             pts.shape[1])

    def grad_matrices(self, pts: np.ndarray) -> list:
        """dim matrices (size, Npts): d/dx_d of the interpolant."""
        ld = [self._lag(pts[d]) for d in range(self.dim)]
        out = []
        for gd in range(self.dim):
            mats = [v[1] if d == gd else v[0] for d, v in enumerate(ld)]
            out.append(self._combine(mats, pts.shape[1]))
        return out

def duffy_quad(coord, order: int, adapt: float = -1.0, ratio: float = 0.0,
               max_panel: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Quadrature on [0, 1]^2 concentrating geometrically at `coord`
    (which may lie outside the square): concentric rectangular shells
    around coord, each shell's four trapezoidal side panels carrying a
    mapped tensor Gauss rule.  adapt >= 0 inserts a breakpoint at that
    radius; `ratio` (default order / 2) is the shells' growth factor;
    `max_panel` < 1 splits each panel's cross extent into segments no
    wider than that.

    Returns (nodes (N, 2), weights (N,))."""
    coord = np.asarray(coord, np.float64)
    q1, w1 = leg_quad_rule(order)
    eps = 16 * np.finfo(np.float64).eps
    if ratio <= 1.0:
        ratio = 0.5 * order
    vals = sorted([0.0, adapt, abs(coord[0]), abs(coord[0] - 1.0),
                   abs(coord[1]), abs(coord[1] - 1.0)])
    X = [max(0.0, vals[-2] - 1.0)]
    for v in vals:
        if v > X[-1]:
            X.append(v)
    radii = [X[0]]
    for v in X[1:]:
        while radii[-1] > 0.0 and ratio * radii[-1] < v:
            radii.append(ratio * radii[-1])
        radii.append(v)
    yy, zz = np.meshgrid(q1, q1, indexing="ij")
    ww = np.outer(w1, w1).ravel()
    yy, zz = yy.ravel(), zz.ravel()
    nds, wts = [], []
    clip = lambda v: min(1.0, max(0.0, v))
    for k in range(len(radii) - 1):
        r0, r1 = radii[k], radii[k + 1]
        for d0 in range(2):
            d1 = 1 - d0
            for sgn in (-1.0, 1.0):
                lo0 = [clip(coord[d] - r0) for d in range(2)]
                hi0 = [clip(coord[d] + r0) for d in range(2)]
                lo1 = [clip(coord[d] - r1) for d in range(2)]
                hi1 = [clip(coord[d] + r1) for d in range(2)]
                f0 = clip(coord[d0] + sgn * r0)
                f1 = clip(coord[d0] + sgn * r1)
                th = abs(f1 - f0)
                w0, w1_ = hi0[d1] - lo0[d1], hi1[d1] - lo1[d1]
                if th * max(w0, w1_) < eps:
                    continue
                nseg = max(1, int(np.ceil(max(w0, w1_) / max_panel)))
                for sg in range(nseg):
                    ys = (sg + yy) / nseg
                    nd = np.empty((len(yy), 2))
                    nd[:, d0] = f0 * (1 - zz) + f1 * zz
                    nd[:, d1] = ((lo0[d1] * (1 - ys) + hi0[d1] * ys)
                                 * (1 - zz)
                                 + (lo1[d1] * (1 - ys) + hi1[d1] * ys) * zz)
                    nds.append(nd)
                    wts.append((ww / nseg) * th * (w0 * (1 - zz) + w1_ * zz))
    if not nds:
        return np.zeros((0, 2)), np.zeros((0,))
    return np.concatenate(nds), np.concatenate(wts)


def duffy_radii_batch(coords: np.ndarray, order: int,
                      adapts: np.ndarray, floor: float = 1e-7
                      ) -> np.ndarray:
    """Shell-radii ladders (P, K+1) for P (parameter point, adapt)
    pairs: breakpoints at the adapt distance and the distances to the
    square's edges, interleaved with a geometric fill of ratio
    order / 2.  Adapt values below `floor` count as 0 (the batched
    rule's 1e-7; 0 gives `duffy_quad`'s own ladder for every adapt)."""
    coords = np.atleast_2d(np.asarray(coords, np.float64))
    P = len(coords)
    adapts = np.broadcast_to(np.asarray(adapts, np.float64), (P,))
    adapts = np.where(adapts < floor, 0.0, adapts)
    kmax = _DUFFY_KMAX if floor > 0 else 2 * _DUFFY_KMAX
    ratio = 0.5 * order
    c0, c1 = coords[:, 0], coords[:, 1]
    vals = np.sort(np.stack(
        [np.zeros(P), adapts, np.abs(c0), np.abs(c0 - 1.0),
         np.abs(c1), np.abs(c1 - 1.0)], 1), axis=1)        # (P, 6)
    start = np.maximum(0.0, vals[:, -2] - 1.0)

    def _bp(idx):
        return np.take_along_axis(vals, np.minimum(idx, 5)[:, None],
                                  1)[:, 0]

    r = start.copy()
    bp_idx = np.zeros(P, np.int64)
    for _ in range(6):
        bp_idx += (bp_idx < 6) & (_bp(bp_idx) <= r)
    cols = [r.copy()]
    active = bp_idx < 6
    while active.any():
        if len(cols) > kmax:
            raise RuntimeError("duffy_radii_batch: shell cap exceeded")
        nb = _bp(bp_idx)
        geo = np.where(r > 0, ratio * r, np.inf)
        r_next = np.where(active, np.minimum(geo, nb), r)
        bp_idx += active & (geo >= nb)
        for _ in range(6):
            bp_idx += active & (bp_idx < 6) & (_bp(bp_idx) <= r_next)
        cols.append(r_next)
        r = r_next
        active = bp_idx < 6
    return np.stack(cols, 1)


def duffy_quad_batch(coords: np.ndarray, order: int, adapts: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """`duffy_quad` (ratio order / 2, one segment a panel) for P
    (coord, adapt) pairs at once, all padded to one shell count: shells
    past a pair's own ladder and degenerate panels carry zero weight.
    Adapt values below 1e-7 count as 0.

    Returns (nodes (P, K*4*order^2, 2), weights (P, K*4*order^2))."""
    coords = np.atleast_2d(np.asarray(coords, np.float64))
    P = len(coords)
    eps = 16 * np.finfo(np.float64).eps
    q1, w1 = leg_quad_rule(order)
    radii = duffy_radii_batch(coords, order, adapts)
    K = radii.shape[1] - 1
    yy, zz = np.meshgrid(q1, q1, indexing="ij")
    ww = np.outer(w1, w1).ravel()
    yy, zz = yy.ravel(), zz.ravel()
    n2 = len(yy)
    clip = lambda v: np.clip(v, 0.0, 1.0)
    r0, r1 = radii[:, :-1], radii[:, 1:]
    nd_out = np.zeros((P, K, 4, n2, 2))
    wt_out = np.zeros((P, K, 4, n2))
    zz_, ys = zz[None, None, :], yy[None, None, :]
    pi = 0
    for d0 in range(2):
        cd0 = coords[:, d0][:, None]
        cd1 = coords[:, 1 - d0][:, None]
        for sgn in (-1.0, 1.0):
            f0, f1 = clip(cd0 + sgn * r0), clip(cd0 + sgn * r1)
            lo0, hi0 = clip(cd1 - r0), clip(cd1 + r0)
            lo1, hi1 = clip(cd1 - r1), clip(cd1 + r1)
            th = np.abs(f1 - f0)
            w0, w1_ = hi0 - lo0, hi1 - lo1
            live = th * np.maximum(w0, w1_) >= eps
            nd_out[:, :, pi, :, d0] = (f0[..., None] * (1 - zz_)
                                       + f1[..., None] * zz_)
            nd_out[:, :, pi, :, 1 - d0] = (
                (lo0[..., None] * (1 - ys) + hi0[..., None] * ys) * (1 - zz_)
                + (lo1[..., None] * (1 - ys) + hi1[..., None] * ys) * zz_)
            wt_out[:, :, pi] = (live[..., None] * ww[None, None, :]
                                * th[..., None]
                                * (w0[..., None] * (1 - zz_)
                                   + w1_[..., None] * zz_))
            pi += 1
    return (nd_out.reshape(P, K * 4 * n2, 2),
            wt_out.reshape(P, K * 4 * n2))


def tensor_gauss_quad(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """order^2-point tensor Gauss rule on [0, 1]^2."""
    q1, w1 = leg_quad_rule(order)
    u, v = np.meshgrid(q1, q1, indexing="ij")
    return (np.stack([u.ravel(), v.ravel()], axis=1),
            np.outer(w1, w1).ravel())


class BasisElemList:
    """A surface as Nelem tensor-basis elements: nodal coordinates
    (Nelem, size, 3)."""

    def __init__(self, order: int, X: np.ndarray):
        self.basis = TensorBasis(order, 2)
        X = np.asarray(X, np.float64)
        assert X.ndim == 3 and X.shape[1] == self.basis.size \
            and X.shape[2] == 3
        self.X = X

    @property
    def n_elem(self) -> int:
        return self.X.shape[0]

    @classmethod
    def discretize(cls, order: int, charts) -> "BasisElemList":
        """Sample parametric charts ([0, 1]^2 -> R^3) at the basis
        nodes."""
        nds = TensorBasis(order, 2).nodes()
        return cls(order, np.stack([np.asarray(c(nds.T)) for c in charts]))

    def geometry(self, pts: np.ndarray, elem: Optional[int] = None):
        """Positions, unit normals (x_u x x_v) and area elements at
        parameter points pts (2, N) -> x (E, N, 3), nrm (E, N, 3),
        area (E, N); `elem` restricts to one element -> (N, ...)."""
        E = self.basis.eval_matrix(pts)
        Du, Dv = self.basis.grad_matrices(pts)
        X = self.X if elem is None else self.X[elem:elem + 1]
        x = np.einsum("esk,sn->enk", X, E)
        xu = np.einsum("esk,sn->enk", X, Du)
        xv = np.einsum("esk,sn->enk", X, Dv)
        nrm = np.cross(xu, xv)
        area = np.linalg.norm(nrm, axis=-1)
        nrm = nrm / np.maximum(area, 1e-300)[..., None]
        if elem is not None:
            return x[0], nrm[0], area[0]
        return x, nrm, area


def _corr_block(ker: KernelSpec, x0: np.ndarray, xq: np.ndarray,
                nq: np.ndarray, wt: np.ndarray, Ed: np.ndarray) -> np.ndarray:
    """One (element, target) quadrature block: density nodal values ->
    potential at x0.  xq / nq (N, 3) quadrature points and unit normals,
    wt (N,) weights times area, Ed (size, N) density evaluation matrix.
    -> (size*k0, k1), scale factor included."""
    k0, k1 = ker.kdim0, ker.kdim1
    M = full_matrix_np(ker, x0[None, :], xq, nq)
    Mw = M.reshape(len(xq), k0, k1) * wt[:, None, None]
    return np.einsum("sn,nab->sab", Ed, Mw).reshape(-1, k1)


def _corr_blocks(ker: KernelSpec, d: np.ndarray, nq: np.ndarray,
                 wt: np.ndarray, Ed: np.ndarray) -> np.ndarray:
    """`_corr_block` for a batch: displacements d = x0 - xq (B, N, 3),
    normals nq (B, N, 3), weights wt (B, N), evaluation matrices Ed
    (B, size, N) or one (size, N) -> (B, size*k0, k1)."""
    k0, k1 = ker.kdim0, ker.kdim1
    B, N = wt.shape
    Mw = (offset_blocks_np(ker, d, ns=nq).reshape(B, N, k0 * k1)
          * wt[..., None])
    Ed = np.broadcast_to(Ed, (B,) + Ed.shape[-2:])
    return np.matmul(Ed, Mw).reshape(B, -1, k0, k1).reshape(B, -1, k1)


def _lag_rows(b: TensorBasis, x: torch.Tensor):
    """`TensorBasis._lag` on x's device: the 1-D cardinal values and
    derivatives (..., q) at x (...), the values as the same products in
    the same order; at an exact node the derivative comes from the host
    rule."""
    xn, q = b.nodes1d, b.order
    den = xn[:, None] - xn[None, :]
    np.fill_diagonal(den, 1.0)
    t = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)
    lag = torch.ones(x.shape + (q,), dtype=x.dtype, device=x.device)
    for k in range(q):
        r = (x - xn[k])[..., None] / t(den[:, k])
        r[..., k] = 1.0
        lag *= r
    d = x[..., None] - t(xn)
    hit = (d == 0.0).any(-1)
    d = torch.where(hit[..., None], torch.ones_like(d), d)
    dlag = lag * ((1.0 / d) @ t(1.0 - np.eye(q)))
    if bool(hit.any()):
        dlag[hit] = t(b._lag(x[hit].cpu().numpy())[1].T)
    return lag, dlag


def _duffy_blocks(Xe, x0, u0, radii, order: int, q: int, ker: KernelSpec):
    """Duffy blocks of S pairs, tensors on one device in float64: element
    nodes Xe (S, size, 3), targets x0 (S, 3), preimages u0 (S, 2), shell
    ladders radii (S, K+1) (`duffy_radii_batch`), the rule's order, the
    basis order q.  The rule is `duffy_quad`'s, padded with zero-weight
    shells to K.  Each panel of a shell is a tensor rule in (y, z) whose
    coordinate along the panel's axis d0 depends on z alone, so the 1-D
    basis along d0 is evaluated at the order z values only, and each
    basis sum runs as two short products: the geometry over the d0 index
    first, the block sum_n l_i(u_n) l_j(v_n) w_n K_n over y with the
    other axis's basis first.  -> (S, size*k0, k1)."""
    from .near_device import _blocks
    S, K = radii.shape[0], radii.shape[1] - 1
    dev, f64 = Xe.device, torch.float64
    t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
    q1, w1 = leg_quad_rule(order)
    b = TensorBasis(q, 2)
    eps = 16 * np.finfo(np.float64).eps
    z, y, zr = t(q1[:, None]), t(q1[None, :]), t(q1)     # panel (z, y)
    wwT = t(np.outer(w1, w1).T)
    r0, r1 = radii[:, :-1, None], radii[:, 1:, None]
    Xq = Xe.reshape(S, q, q, 3)                          # [s, j (v), i (u)]
    k = ker.kdim0 * ker.kdim1
    out = torch.zeros((S, q, q, k), dtype=f64, device=dev)
    for d0 in range(2):
        cd0, cd1 = u0[:, d0, None, None], u0[:, 1 - d0, None, None]
        # X along the d0 axis first: [s, d0 index, (other index, xyz)]
        Xa = (Xq.transpose(1, 2) if d0 == 0 else Xq).reshape(S, q, 3 * q)
        for sgn in (-1.0, 1.0):
            f0 = (cd0 + sgn * r0).clamp(0.0, 1.0)
            f1 = (cd0 + sgn * r1).clamp(0.0, 1.0)
            lo0, hi0 = (cd1 - r0).clamp(0.0, 1.0), (cd1 + r0).clamp(0.0, 1.0)
            lo1, hi1 = (cd1 - r1).clamp(0.0, 1.0), (cd1 + r1).clamp(0.0, 1.0)
            th = (f1 - f0).abs()
            w0, w1_ = hi0 - lo0, hi1 - lo1
            live = (th * torch.maximum(w0, w1_) >= eps).to(f64)
            za = f0 * (1 - zr) + f1 * zr                    # (S, K, Z)
            zb = ((lo0[..., None] * (1 - y) + hi0[..., None] * y) * (1 - z)
                  + (lo1[..., None] * (1 - y) + hi1[..., None] * y) * z)
            wt = (live[..., None] * wwT * th[..., None]
                  * (w0[..., None] * (1 - z) + w1_[..., None] * z))
            la, dla = _lag_rows(b, za)                      # (S, K, Z, q)
            lb, dlb = _lag_rows(b, zb)                      # (S, K, Z, Y, q)
            T = (la.reshape(S, -1, q) @ Xa).reshape(S, K, order, q, 3)
            Ta = (dla.reshape(S, -1, q) @ Xa).reshape(S, K, order, q, 3)
            x, xa, xb = lb @ T, lb @ Ta, dlb @ T            # (S, K, Z, Y, 3)
            xu, xv = (xa, xb) if d0 == 0 else (xb, xa)
            nrm = torch.cross(xu, xv, dim=-1)
            area = torch.linalg.vector_norm(nrm, dim=-1)
            nrm = nrm / area.clamp_min(1e-300)[..., None]
            W = (_blocks(ker.name, float(ker.scale_factor),
                         x0[:, None, None, None, :] - x, nrm)
                 .reshape(S, K, order, order, k) * (wt * area)[..., None])
            H = (lb.transpose(-1, -2) @ W).reshape(S, K * order, q * k)
            M = (la.reshape(S, K * order, q).transpose(1, 2) @ H).reshape(
                S, q, q, k)                                 # [s, a, o, k]
            out += M.transpose(1, 2) if d0 == 0 else M
    return out.reshape(S, q * q * ker.kdim0, ker.kdim1)


def _duffy_pairs(X, elem, x0, u0, adapt, order: int, q: int,
                 ker: KernelSpec, device) -> np.ndarray:
    """The Duffy blocks of P (target, element) pairs (`duffy_quad` at
    preimage u0 with its adapt breakpoint) in float64 on `device`, in
    chunks of one shell count: element nodes X (E, size, 3), elem (P,),
    x0 (P, 3), u0 (P, 2), adapt (P,).  -> (P, size*k0, k1) numpy."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=dev)
    radii = duffy_radii_batch(u0, order, adapt, floor=0.0)
    shells = (np.diff(radii, axis=1) > 0).sum(1)
    out = np.zeros((len(elem), X.shape[1] * ker.kdim0, ker.kdim1))
    budget = _CHUNK_POINTS * (64 if dev.type == "cuda" else 1)
    Xd = t(X)
    for K in np.unique(shells):
        grp = np.where(shells == K)[0]
        n = max(1, budget // (max(int(K), 1) * 4 * order * order))
        for c0 in range(0, len(grp), n):
            sel = grp[c0:c0 + n]
            out[sel] = _duffy_blocks(
                Xd[t(elem[sel]).long()], t(x0[sel]), t(u0[sel]),
                t(radii[sel, :K + 1]), order, q, ker).cpu().numpy()
    return out


def setup_singular(trg_nds: np.ndarray, elems: BasisElemList,
                   ker: KernelSpec, order_singular: int = 10,
                   order_direct: int = 10, device=None) -> np.ndarray:
    """Corrections for on-element targets at parameter nodes trg_nds
    (2, Ntrg): the Duffy rule at the target minus the order_direct
    tensor Gauss contribution of the same element.  Each target's rule
    and basis matrices come from the host; the geometry, kernel and
    basis products of every element at once on `device` (the card
    unless "cpu") in float64, in the JAX package's order.

    -> (Nelem, Ntrg, size*k0, k1)"""
    from .near_device import _blocks
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=dev)
    Ntrg = trg_nds.shape[1]
    Ne, size = elems.n_elem, elems.basis.size
    k0, k1 = ker.kdim0, ker.kdim1
    xt, _, _ = elems.geometry(trg_nds)              # (E, Ntrg, 3)
    X, xtd = t(elems.X), t(xt)
    M = np.zeros((Ne, Ntrg, size * k0, k1))
    for i in range(Ntrg):
        nds, wts = duffy_quad(trg_nds[:, i], order_singular)
        E = t(elems.basis.eval_matrix(nds.T))
        Du, Dv = (t(m) for m in elems.basis.grad_matrices(nds.T))
        x, xu, xv = (torch.einsum("esk,sn->enk", X, m) for m in (E, Du, Dv))
        nrm = torch.cross(xu, xv, dim=-1)
        area = torch.linalg.vector_norm(nrm, dim=-1)
        nrm = nrm / area.clamp_min(1e-300)[..., None]
        Mw = (_blocks(ker.name, float(ker.scale_factor),
                      xtd[:, i, None, :] - x, nrm).reshape(Ne, -1, k0 * k1)
              * (t(wts)[None, :] * area)[..., None])
        M[:, i] = (E @ Mw).reshape(Ne, -1, k1).cpu().numpy()
    ndsd, wtsd = tensor_gauss_quad(order_direct)
    xqd, nqd, aqd = elems.geometry(ndsd.T)
    Edd = elems.basis.eval_matrix(ndsd.T)
    for i in range(Ntrg):
        M[:, i] -= _corr_blocks(ker, xt[:, i, None, :] - xqd, nqd,
                                wtsd[None, :] * aqd, Edd)
    return M


def build_nbr_list(Xt: np.ndarray, trg_surf: np.ndarray,
                   elems: BasisElemList, distance_factor: float = 2.5
                   ) -> np.ndarray:
    """Near pairs (t, e): target within distance_factor times element
    e's bounding radius of its centroid, excluding targets on e
    (trg_surf[t] = element owning target t, -1 off the surface).
    -> (P, 2) int array, target-major."""
    ctr = elems.X.mean(axis=1)
    rad = np.linalg.norm(elems.X - ctr[:, None], axis=-1).max(axis=1)
    pairs = []
    for t0 in range(0, len(Xt), 4096):
        xt = Xt[t0:t0 + 4096]
        d = np.linalg.norm(xt[:, None] - ctr[None], axis=-1)
        ti, ei = np.nonzero(d < distance_factor * rad[None])
        own = trg_surf[t0 + ti] == ei
        pairs.append(np.stack([t0 + ti[~own], ei[~own]], axis=1))
    return (np.concatenate(pairs) if pairs
            else np.zeros((0, 2), np.int64))


def _preimages(Xt, pairs, elems):
    """Closest-point parameter preimages of the pairs' targets on their
    elements: two Gauss-Newton steps from the nearest basis node.
    -> (u0 (P, 2), adapt (P,) = distance / max(|x_u|, |x_v|))."""
    b = elems.basis
    t, e = pairs[:, 0], pairs[:, 1]
    x0 = Xt[t]
    Xe = elems.X[e]                                  # (P, size, 3)
    d2 = ((Xe - x0[:, None, :]) ** 2).sum(-1)
    u0 = b.nodes()[:, np.argmin(d2, axis=1)].T.copy()
    adapt = np.full(len(pairs), -1.0)
    for _ in range(2):
        u0 = np.clip(u0, 0.0, 1.0)
        E = b.eval_matrix(u0.T)
        Du, Dv = b.grad_matrices(u0.T)
        x = np.einsum("psk,sp->pk", Xe, E)
        J = np.stack([np.einsum("psk,sp->pk", Xe, Du),
                      np.einsum("psk,sp->pk", Xe, Dv)], axis=2)  # (P,3,2)
        r = x0 - x
        JtJ = np.einsum("pki,pkj->pij", J, J)
        u0 = u0 + np.linalg.solve(JtJ, np.einsum("pki,pk->pi", J, r)[
            ..., None])[..., 0]
        adapt = np.sqrt((r * r).sum(1)
                        / np.maximum(JtJ[:, 0, 0], JtJ[:, 1, 1]))
    return u0, adapt


def setup_near_singular(Xt: np.ndarray, pairs: np.ndarray,
                        elems: BasisElemList, ker: KernelSpec,
                        order_singular: int = 10, order_direct: int = 10,
                        device=None) -> np.ndarray:
    """Near-singular corrections for off-element targets: for each pair
    the closest-point preimage u0 (two Gauss-Newton steps from the
    nearest basis node), then the Duffy rule at u0 with
    adapt = distance / |x_u| minus the direct rule.  The Duffy blocks
    are formed on `device` (the card unless "cpu") in float64, pairs of
    one shell count together; the preimages and the direct rule on the
    host.

    -> (P, size*k0, k1)"""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    b = elems.basis
    if not len(pairs):
        return np.zeros((0, b.size * ker.kdim0, ker.kdim1))
    t, e = pairs[:, 0], pairs[:, 1]
    u0, adapt = _preimages(Xt, pairs, elems)
    M = _duffy_pairs(elems.X, e, Xt[t], u0, adapt, order_singular, b.order,
                     ker, resolve_device(device))
    ndsd, wtsd = tensor_gauss_quad(order_direct)
    xqd, nqd, aqd = elems.geometry(ndsd.T)
    M -= _corr_blocks(ker, Xt[t][:, None, :] - xqd[e], nqd[e],
                      wtsd[None, :] * aqd[e], b.eval_matrix(ndsd.T))
    return M


class LegacyQuadrature:
    """Setup and eval: potential = the order_direct tensor rule
    over every element (the far sum) plus the precomputed singular and
    near corrections.

    device: "cuda" (default) or "cpu"; dtype: torch.float32 or
    torch.float64.  `setup` forms its Duffy blocks on the device in
    float64, the rest on the host; `eval` and `eval_tensor` run on the
    device."""

    def __init__(self, ker: KernelSpec, elems: BasisElemList,
                 order_singular: int = 10, order_direct: int = 10,
                 device=None, dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(f"LegacyQuadrature dtype {dtype}")
        self.ker = ker
        self.elems = elems
        self.order_singular = order_singular
        self.order_direct = order_direct
        self.device = resolve_device(device)
        self.dtype = dtype
        self._on_surface = None

    def setup(self, Xt: Optional[np.ndarray] = None,
              trg_surf: Optional[np.ndarray] = None,
              distance_factor: float = 2.5):
        """Targets: the element nodes (the on-surface operator) when Xt
        is None, otherwise points off the surface (trg_surf -1)."""
        elems, b = self.elems, self.elems.basis
        ndsd, wtsd = tensor_gauss_quad(self.order_direct)
        self._xq, self._nq, aq = elems.geometry(ndsd.T)
        self._wq = wtsd[None, :] * aq                    # (E, Nq)
        self._Ed = b.eval_matrix(ndsd.T)                 # (size, Nq)
        self._on_surface = Xt is None
        if Xt is None:
            trg_nds = b.nodes()
            self._Xt = elems.geometry(trg_nds)[0].reshape(-1, 3)
            self._Msing = setup_singular(trg_nds, elems, self.ker,
                                         self.order_singular,
                                         self.order_direct, self.device)
            trg_surf = np.repeat(np.arange(elems.n_elem), b.size)
        else:
            self._Xt = np.asarray(Xt, np.float64)
            if trg_surf is None:
                trg_surf = np.full(len(self._Xt), -1, np.int64)
            if (np.asarray(trg_surf) >= 0).any():
                raise NotImplementedError(
                    "on-surface targets via Xt: pass Xt=None for the "
                    "self-interaction operator")
        self._pairs = build_nbr_list(self._Xt, trg_surf, elems,
                                     distance_factor)
        self._Mnear = setup_near_singular(self._Xt, self._pairs, elems,
                                          self.ker, self.order_singular,
                                          self.order_direct, self.device)
        self._upload()
        return self

    def to(self, device, dtype: torch.dtype) -> "LegacyQuadrature":
        """The same setup's tables on another device or in another type
        (the host tables are shared, not recomputed)."""
        import copy
        out = copy.copy(self)
        out.device = resolve_device(device)
        out.dtype = dtype
        out._upload()
        return out

    def _upload(self):
        dev, dt = self.device, self.dtype
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        self._dev = {"xq": t(self._xq.reshape(-1, 3)),
                     "nq": t(self._nq.reshape(-1, 3)),
                     "wq": t(self._wq), "Ed": t(self._Ed),
                     "xt": t(self._Xt), "Mnear": t(self._Mnear),
                     "pt": torch.as_tensor(self._pairs[:, 0], device=dev),
                     "pe": torch.as_tensor(self._pairs[:, 1], device=dev)}
        if self._on_surface:
            self._dev["Msing"] = t(self._Msing)

    def eval_tensor(self, density: torch.Tensor) -> torch.Tensor:
        """density (Nelem, size, k0) tensor (or any shape of that size)
        -> (Ntrg, k1) tensor on the op's device, scale included."""
        from ..ops.direct import direct_eval_blocked
        ker, d = self.ker, self._dev
        E, size = self.elems.n_elem, self.elems.basis.size
        k0, k1 = ker.kdim0, ker.kdim1
        dens = density.to(self.device, self.dtype).reshape(E, size, k0)
        fq = torch.einsum("esk,sn->enk", dens, d["Ed"]) * d["wq"][..., None]
        u = direct_eval_blocked(ker, d["xt"], d["xq"], fq.reshape(-1, k0),
                                ns=d["nq"] if ker.needs_normal else None)
        dc = dens.reshape(E, size * k0)
        if self._on_surface:
            u = u + torch.einsum("es,etsb->etb", dc,
                                 d["Msing"]).reshape(-1, k1)
        if len(self._pairs):
            u.index_add_(0, d["pt"], torch.einsum(
                "ps,psb->pb", dc[d["pe"]], d["Mnear"]))
        return u

    def eval(self, density: np.ndarray) -> np.ndarray:
        """density (Nelem, size, k0) numpy -> (Ntrg, k1) numpy."""
        return self.eval_tensor(torch.as_tensor(
            np.asarray(density, np.float64))).cpu().numpy()
