"""Slab-sharded uniform-tree KIFMM over the ranks of a `comm.Comm`
(counterpart of sctl_tpu/fmm/kifmm_dist.py; SURVEY.md §3.4, §5.7).

  sharding   the leaf level's box grid is cut along x into one slab of
             2^depth / p planes a rank, boxes x-major (raster) inside a
             slab, so S2M, L2T and the near field are local;
  hierarchy  slabs are parent-aligned: while a rank holds at least 4
             planes of a level, its boxes' parents are its own, so M2M
             and L2L never communicate; the coarser levels are
             all-gathered once and processed the same on every rank
             ("coarse gather"), and sliced again on the way down;
  halo       the near field reads one density plane of each neighbour
             rank, the M2L two parent planes of V-projected equivalents:
             both come by point-to-point exchange (`Comm._ppermute`,
             zeros at the domain's faces);
  M2L        the per-parity sweep (`kifmm.parity_sweep`) on the slab and
             its halo, as the JAX engine runs it (:586-641): levels >= 3
             at the float32 route's capped ranks, level 2 and float64 at
             the exact ranks, as the single-device KIFMM does.

Each rank's local stages run the port's hand kernels on its own slab:
S2M through `surface_pair`, L2T through `l2t_surface` (or both through
`p2p_ulist` where the surface route rules refuse the shapes, as in the
single-device KIFMM), and the near field through `p2p_ulist`: per
target box its 27 neighbours' real points, slab and halo, as one run of
a flat source list in the target box's frame, compacted at setup; the
kernel reads the densities of the slab and its halo planes through the
list's row index.

Capacities: a box's slots are as many as the fullest box's points (no
quantile cap and no overflow sideband, unlike the JAX engine, :150-200):
every kernel here reads each box's real points by its count, so the
padded slots cost memory and no pair work, which is what the sideband
saves the JAX engine.

API, the JAX package's: `setup(x_src, x_trg, n_src=None)` takes the
global host arrays on every rank; `eval(f)` the global densities and
returns the global potential on every rank.  `eval_tensor(f_local)` is
the rank's own slab in and out on its device: the densities of the
sources `src_index` (global input indices, the slab's order) to the
potentials of the targets `trg_index`; it is what is timed.  The
Laplace kernels only (the translation kernel Laplace3D-FxU), as the JAX
engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..comm.comm import Comm
from ..comm.verbs import allgatherv
from ..config import resolve_device
from ..ops.kernels import KernelSpec, Laplace3D_FxU
from ..ops.p2p import box_ranges, p2p_ulist
from ..ops.sl import (l2t_surface, l2t_surface_fits, surface_pair,
                      surface_pair_fits)
from ..tree import morton as mt
from ..tree.tree import UniformTree
from .kifmm import (RAD_OUT, KIFMMOperators, _mark, _outer_scale, _tensor,
                    kernel_roles, parity_sweep)


def slab_boxes(depth: int, p: int, rank: int, halo: int = 0) -> np.ndarray:
    """Morton box indices of rank `rank`'s slab at `depth`, x-major, with
    `halo` planes on each side (-1 outside the domain)."""
    n = 1 << depth
    pl = n // p
    x = np.arange(rank * pl - halo, (rank + 1) * pl + halo)
    X, Y, Z = np.meshgrid(x, np.arange(n), np.arange(n), indexing="ij")
    ok = (X >= 0) & (X < n)
    c = np.stack([np.clip(X, 0, n - 1), Y, Z], -1).reshape(-1, 3)
    mort = (mt.coords_to_key(c, depth) >> np.uint64(
        3 * (mt.max_depth(3) - depth))).astype(np.int64)
    return np.where(ok.reshape(-1), mort, -1)


def slab_points(tree: UniformTree, boxes: np.ndarray) -> np.ndarray:
    """Input indices of the points of `boxes`, box by box in their
    order, each box's points in the tree's sorted order."""
    cnt = tree.box_cnt[boxes]
    start = np.repeat(tree.box_dsp[boxes], cnt)
    off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return tree.perm[start + off]


class KIFMMDist:
    """Slab-sharded KIFMM over comm's ranks (the Laplace family).

        fmm = KIFMMDist(Laplace3D_FxU, comm, p=6, depth=6)
        fmm.setup(x_src, x_trg)          # global host arrays, every rank
        u = fmm.eval(f)                  # global numpy in and out
        u_loc = fmm.eval_tensor(f_loc)   # the rank's slab, on its device

    device, dtype: as KIFMM (default the card, float32)."""

    def __init__(self, ker_s2t: KernelSpec, comm: Optional[Comm] = None,
                 p: int = 6, depth: int = 3,
                 ker_l2t: Optional[KernelSpec] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.ker_s2t = ker_s2t
        self.ker_trans, self.ker_l2t, self.ker_s2m = kernel_roles(
            ker_s2t, ker_l2t)
        if self.ker_trans.name != Laplace3D_FxU.name:
            raise NotImplementedError(
                f"KIFMMDist: {ker_s2t.name}: the Laplace kernels only")
        self.comm = comm or Comm.self_()
        self.n_dev = self.comm.size()
        self.rank = self.comm.rank()
        self.p = p
        self.depth = depth
        self.device = resolve_device(device)
        self.dtype = dtype
        # KIFMM's pinv cutoffs
        self.rcond = 3e-5 if dtype == torch.float32 else 1e-9
        nside = 1 << depth
        if nside % self.n_dev:
            raise ValueError(f"KIFMMDist: 2^{depth} planes do not tile "
                             f"over {self.n_dev} ranks")
        # coarsest sharded level: at least 4 planes a rank (parent
        # alignment, and the M2L halo within one neighbour), :75-86
        self.l_shard_min = depth + 1
        for lvl in range(depth, 1, -1):
            if (1 << lvl) // self.n_dev < 4:
                break
            self.l_shard_min = lvl

    # -- setup -------------------------------------------------------------
    def setup(self, x_src, x_trg, n_src=None):
        """Trees of the global points (every rank builds them), this
        rank's slab layouts, and its near-field lists."""
        nrm = self.ker_s2t.needs_normal or self.ker_s2m.needs_normal
        if nrm and n_src is None:
            raise ValueError(f"kernel {self.ker_s2t.name} requires source "
                             "normals: pass n_src")
        same = x_trg is x_src
        x_src = np.asarray(x_src, np.float64)
        x_trg = x_src if same else np.asarray(x_trg, np.float64)
        L, P, r = self.depth, self.n_dev, self.rank
        n = 1 << L
        self.planes = pl = n // P
        dev, dt = self.device, self.dtype
        t = lambda a: _tensor(a, dev, dt)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        bbox = (np.minimum(x_src.min(0), x_trg.min(0)),
                np.maximum(x_src.max(0), x_trg.max(0)))
        self.src_tree = src = UniformTree(x_src, L, bbox=bbox)
        self.trg_tree = trg = src if same else UniformTree(x_trg, L,
                                                           bbox=bbox)
        self._ops = ops = KIFMMOperators(self.ker_trans, self.p, self.rcond,
                                         dev, dt).device_tables()
        lam = src.scale / n
        s_exp, t_exp = self.ker_trans.src_scal, self.ker_trans.trg_scal
        self.uc2e_L = t(_outer_scale(ops.uc2e_unit, lam, s_exp, t_exp))
        surf = ops.surf * (RAD_OUT * lam / 2)
        self.surf_out_L = t(surf)

        # this rank's boxes (x-major) and the slab's points
        mb = slab_boxes(L, P, r)
        self.B = B = len(mb)
        self.cap_s = max(8, -(-int(src.box_cnt.max()) // 8) * 8)
        self.cap_t = max(8, -(-int(trg.box_cnt.max()) // 8) * 8)
        cs, ct = self.cap_s, self.cap_t
        cnt_s, cnt_t = src.box_cnt[mb], trg.box_cnt[mb]
        self.src_index = slab_points(src, mb)
        self.trg_index = slab_points(trg, mb)
        self.trg_index_all = [slab_points(trg, slab_boxes(L, P, q))
                              for q in range(P)]
        ctr = src.box_centers()[mb]
        n_sorted = (np.asarray(n_src, np.float64)[src.perm] if nrm
                    else None)

        def pad(tree, boxes, cap):
            """(len(boxes), cap) sorted-point index (clipped), validity."""
            idx = tree.box_dsp[boxes][:, None] + np.arange(cap)[None, :]
            valid = idx < tree.box_dsp[boxes + 1][:, None]
            return np.clip(idx, 0, max(len(tree.X_sorted) - 1, 0)), valid

        s_idx, s_valid = pad(src, mb, cs)
        t_idx, t_valid = pad(trg, mb, ct)
        slots = lambda a: t(a.transpose(2, 0, 1).reshape(3, -1))
        self.xs_sl = slots(src.X_sorted[s_idx] - ctr[:, None, :])
        self.xt_sl = slots(trg.X_sorted[t_idx] - ctr[:, None, :])
        self.ns_sl = (slots(n_sorted[s_idx]) if self.ker_s2m.needs_normal
                      else None)
        self.cnt_s_box, self.cnt_t_box = i32(cnt_s), i32(cnt_t)
        # the local density rows: box-major slots of the slab's sources
        first = np.cumsum(cnt_s) - cnt_s
        self.pad_idx = torch.as_tensor(
            np.minimum(first[:, None] + np.arange(cs)[None, :],
                       max(len(self.src_index) - 1, 0)), device=dev)
        self.pad_valid = t(np.arange(cs)[None, :] < cnt_s[:, None])
        self.take = torch.as_tensor(np.nonzero(t_valid.reshape(-1))[0],
                                    device=dev)
        self.surface_route = (
            B % 128 == 0 and surface_pair_fits(self.ker_s2m, cs, dt)
            and l2t_surface_fits(self.ker_l2t, ops.n_surf, dt))
        if not self.surface_route:
            self.rng_s = box_ranges(self.cnt_s_box, cs)
            self.rng_e = box_ranges(
                i32(np.full(B, ops.n_surf)), ops.n_surf)
        self._setup_near(mb, ctr, n_sorted)
        return self

    def _setup_near(self, mb, ctr, n_sorted):
        """The near field's lists: per target box of the slab, the real
        points of its 27 neighbours (slab and halo planes) as one run of
        a flat source list, in the target box's frame, with each source's
        row in the slab-and-halo density array (`near_fidx`)."""
        src, L, n = self.src_tree, self.depth, 1 << self.depth
        dev, dt, cs = self.device, self.dtype, self.cap_s
        hb = slab_boxes(L, self.n_dev, self.rank, halo=1)   # (pl+2) n n
        cnt_h = np.where(hb >= 0, src.box_cnt[np.maximum(hb, 0)], 0)
        h_idx = src.box_dsp[np.maximum(hb, 0)][:, None] + np.arange(cs)
        h_idx = np.clip(h_idx, 0, len(src.X_sorted) - 1)
        # each target box's 27 neighbours in the halo grid
        pl = self.planes
        x, y, z = np.meshgrid(np.arange(1, pl + 1), np.arange(n),
                              np.arange(n), indexing="ij")
        off = np.stack(np.meshgrid(*([[-1, 0, 1]] * 3), indexing="ij"),
                       -1).reshape(-1, 3)
        ny, nz = y.reshape(-1, 1) + off[:, 1], z.reshape(-1, 1) + off[:, 2]
        ok = (ny >= 0) & (ny < n) & (nz >= 0) & (nz < n)
        nbh = ((x.reshape(-1, 1) + off[:, 0]) * n + np.clip(ny, 0, n - 1)) \
            * n + np.clip(nz, 0, n - 1)                  # (B, 27)
        c = torch.as_tensor(np.where(ok, cnt_h[nbh], 0).reshape(-1),
                            device=dev)
        nbh_t = torch.as_tensor(nbh.reshape(-1), device=dev)
        pair = torch.repeat_interleave(torch.arange(len(c), device=dev), c)
        slot = torch.arange(len(pair), device=dev) - torch.repeat_interleave(
            torch.cumsum(c, 0) - c, c)
        fidx = nbh_t[pair] * cs + slot
        tb = pair // 27
        per_box = c.reshape(-1, 27).sum(1)
        ends = torch.cumsum(per_box, 0)
        self.near_rng = torch.stack([ends - per_box, ends], 1).to(
            torch.int32)
        self.near_fidx = fidx.to(torch.int32)
        del pair, slot
        X = torch.as_tensor(src.X_sorted[h_idx.reshape(-1)], device=dev)
        loc = X[fidx] - torch.as_tensor(ctr, device=dev)[tb]
        self.near_xs = loc.T.to(dt).contiguous()            # (3, E)
        del X, loc
        self.near_ns = None
        if self.ker_s2t.needs_normal:
            N = torch.as_tensor(n_sorted[h_idx.reshape(-1)], device=dev)
            self.near_ns = N[fidx].T.to(dt).contiguous()
        self.near_xt = self.xt_sl.reshape(3, self.B, self.cap_t) \
            .transpose(0, 1).contiguous()                    # (B, 3, ct)
        self.n_near_pairs = int((per_box.cpu().numpy().astype(np.int64)
                                 * self.cnt_t_box.cpu().numpy()).sum())

    # -- halo exchange -------------------------------------------------------
    def _halo_x(self, a: torch.Tensor, width: int) -> torch.Tensor:
        """The slab's leading axis padded with `width` planes of each
        neighbour rank (zeros at the domain's faces), :234-256."""
        P, comm = self.n_dev, self.comm
        lo = comm._ppermute(a[-width:].contiguous(),
                            [(i, i + 1) for i in range(P - 1)])
        hi = comm._ppermute(a[:width].contiguous(),
                            [(i, i - 1) for i in range(1, P)])
        return torch.cat([lo, a, hi], 0)

    # -- evaluation ---------------------------------------------------------
    def pad_density(self, f_local: torch.Tensor) -> torch.Tensor:
        """The slab's source densities (src_index order) -> (B, cap_s,
        k0) box slots, zero in padding."""
        k0 = self.ker_s2t.kdim0
        f = f_local.to(self.device, self.dtype).reshape(-1, k0)
        return f[self.pad_idx] * self.pad_valid[..., None]

    def eval_tensor(self, f_local: torch.Tensor,
                    marks: Optional[list] = None) -> torch.Tensor:
        """The rank's own slab: densities (n_src_local, k0) in src_index
        order -> potentials (n_trg_local, k1) in trg_index order, on the
        device.  With `marks` a list, CUDA events after each stage (see
        `_eval_impl`)."""
        u = self._eval_impl(self.pad_density(f_local), marks)
        return u.reshape(-1, self.ker_l2t.kdim1)[self.take]

    def eval(self, f) -> np.ndarray:
        """Global densities (n_src, k0) -> the global potential (n_trg,
        k1), numpy, on every rank (the slabs' results all-gathered)."""
        k0, k1 = self.ker_s2t.kdim0, self.ker_l2t.kdim1
        f = np.asarray(f, np.float64).reshape(-1, k0)
        u = allgatherv(self.comm,
                       self.eval_tensor(torch.as_tensor(f[self.src_index])))
        out = np.empty((len(self.trg_tree.perm), k1))
        out[np.concatenate(self.trg_index_all)] = u.cpu().numpy()
        return out

    def _ranks(self, lvl: int):
        """M2L ranks at a level: the float32 route's capped ranks at
        levels >= 3, else the exact ones (KIFMM._m2l_sweep)."""
        ops = self._ops
        return ((ops.blk_r, ops.blk_r2) if lvl >= 3
                else tuple(ops.m2l_a.shape[1:]))

    def _eval_impl(self, fp: torch.Tensor, marks: Optional[list] = None):
        """(B, cap_s, k0) slab densities -> (B, cap_t, k1) slab
        potentials.  Stages marked: S2M, M2M, coarse gather, M2L halo,
        M2L, L2L, L2T, P2P halo, P2P near (an exchange's stage holds
        only the exchange)."""
        ops = self._ops
        L, P, r = self.depth, self.n_dev, self.rank
        n, pl, B = 1 << L, self.planes, self.B
        ns = ops.n_surf
        nd = ns * ops.k0t
        km, kl, ker = self.ker_s2m, self.ker_l2t, self.ker_s2t
        k0 = km.kdim0

        # ---- S2M (local) ----
        if self.surface_route:
            out_sl = surface_pair(km, self.surf_out_L, self.xs_sl,
                                  fp.reshape(-1, k0).T.contiguous(),
                                  self.cap_s, self.ns_sl, self.cnt_s_box)
            u_check = out_sl.permute(2, 1, 0).reshape(B, -1)
        else:
            xc_b = self.surf_out_L.T.expand(B, -1, -1).contiguous()
            u_check = p2p_ulist(km, xc_b, self.xs_sl, self.ns_sl,
                                fp.reshape(-1, k0), self.rng_s).reshape(B, -1)
        q_up = (u_check * km.scale_factor) @ self.uc2e_L.T
        _mark(marks, "S2M")

        # ---- M2M: local while sharded, all-gathered when coarse ----
        q = {L: q_up.reshape(pl, n, n, nd)}
        sharded = {L: True}
        for lvl in range(L, 2, -1):
            if not (sharded[lvl] and lvl - 1 >= self.l_shard_min):
                if sharded[lvl]:
                    q[lvl] = self.comm._all_gather(q[lvl], tiled=True)
                    sharded[lvl] = False
                    _mark(marks, "coarse gather")
            q[lvl - 1] = _m2m(q[lvl], ops.m2m_cat)
            sharded[lvl - 1] = sharded[lvl]
            _mark(marks, "M2M")
        if L == 2 and sharded[2] and P > 1:
            q[2] = self.comm._all_gather(q[2], tiled=True)
            sharded[2] = False

        # ---- M2L per level: the per-parity sweep on the slab ----
        v_dn = {lvl: self._m2l(q[lvl], lvl, sharded[lvl], marks)
                for lvl in range(2, L + 1)}

        # ---- L2L: local; the coarse levels sliced to the slab ----
        q_dn = v_dn[2]
        for lvl in range(3, L + 1):
            if sharded[lvl] and not sharded[lvl - 1]:
                pp = (1 << (lvl - 1)) // P
                q_dn = q_dn[r * pp:(r + 1) * pp]
            q_dn = _l2l(q_dn, ops.l2l_cat) + v_dn[lvl]
        if not sharded[L]:
            q_dn = q_dn[r * pl:(r + 1) * pl]
        _mark(marks, "L2L")

        # ---- L2T (local) ----
        ct = self.cap_t
        if self.surface_route:
            q_cm = q_dn.reshape(B, ns, kl.kdim0).permute(2, 1, 0) \
                .contiguous()
            out_sl = l2t_surface(kl, self.surf_out_L, self.xt_sl, q_cm, ct,
                                 self.cnt_t_box)
            u_far = out_sl.reshape(kl.kdim1, B, ct).permute(1, 2, 0)
        else:
            u_far = p2p_ulist(kl, self.near_xt,
                              self.surf_out_L.T.repeat(1, B), None,
                              q_dn.reshape(B * ns, kl.kdim0), self.rng_e,
                              self.cnt_t_box)
        u_far = u_far * kl.scale_factor
        _mark(marks, "L2T")

        # ---- P2P: one density plane of each neighbour, then the
        # U-list kernel over the compacted lists ----
        fp_h = self._halo_x(fp.reshape(pl, n * n, self.cap_s, -1), 1)
        _mark(marks, "P2P halo")
        u_near = p2p_ulist(ker, self.near_xt, self.near_xs, self.near_ns,
                           fp_h.reshape(-1, fp.shape[-1]), self.near_rng,
                           self.cnt_t_box, self.near_fidx)
        _mark(marks, "P2P near")
        return u_far + u_near * ker.scale_factor

    def _m2l(self, q, lvl: int, sharded: bool, marks=None):
        """(planes, n_l, n_l, nd) equivalents of a level -> its downward
        equivalents: V-projected, two parent planes of halo on the x
        faces (the neighbours' when sharded, zeros otherwise), the
        per-parity sweep."""
        ops = self._ops
        r, r2 = self._ranks(lvl)
        pl_l, n_l = q.shape[0], q.shape[1]
        h, hl = n_l // 2, pl_l // 2
        q7 = (q @ ops.m2l_v[:, :r2]).reshape(hl, 2, h, 2, h, 2, r2)
        if sharded:
            q7 = self._halo_x(q7, 2)
            _mark(marks, "M2L halo")
        else:
            q7 = F.pad(q7, (0, 0) * 6 + (2, 2))
        qrp = F.pad(q7.permute(1, 3, 5, 0, 2, 4, 6), (0, 0, 2, 2, 2, 2))
        out = parity_sweep(ops, qrp, hl, h, r, r2)
        _mark(marks, "M2L")
        return out


def _m2m(q: torch.Tensor, m2m_cat: torch.Tensor) -> torch.Tensor:
    """(pl, n, n, nd) child level, x-major -> (pl/2, n/2, n/2, nd)
    parents: each parent's 8 children in Morton child order c = x + 2y +
    4z, one matrix product."""
    pl, n, _, nd = q.shape
    qc = q.reshape(pl // 2, 2, n // 2, 2, n // 2, 2, nd).permute(
        0, 2, 4, 5, 3, 1, 6).reshape(-1, 8 * nd)
    return (qc @ m2m_cat).reshape(pl // 2, n // 2, n // 2, nd)


def _l2l(q: torch.Tensor, l2l_cat: torch.Tensor) -> torch.Tensor:
    """(pp, m, m, nd) parents, x-major -> (2 pp, 2 m, 2 m, nd) children."""
    pp, m, _, nd = q.shape
    qc = (q.reshape(-1, nd) @ l2l_cat).reshape(pp, m, m, 2, 2, 2, nd)
    return qc.permute(0, 5, 1, 4, 2, 3, 6).reshape(2 * pp, 2 * m, 2 * m, nd)
