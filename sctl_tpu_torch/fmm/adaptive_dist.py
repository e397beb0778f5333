"""Memory-sharded adaptive-tree KIFMM over the ranks of a `comm.Comm`
(counterpart of sctl_tpu/fmm/adaptive_dist.py; reference: PVFMM's MPI
tree behind fmm-wrapper.txx:788-936, the tree's ghost exchanges
tree.txx:295-333, 547, 668).

`AdaptiveFMM.eval_sharded` shares the work and keeps every point array
on every rank; this class shares the memory:

  partition   the leaves, in Morton order, split into `ndev` contiguous
              blocks of Cb; rank r keeps on its device only block r's
              leaf points, normals, targets, densities and outputs.  The
              skeleton (leaf keys and levels, the node arrays) and the
              equivalent densities are on every rank.
  skeleton    built by `DistPtTree` over each rank's block of the
              sources (sample sort, one all-reduce a level, the local
              2:1 balance), adopted by `AdaptiveFMM.setup(skeleton=)`.
              The leaf capacity grows when the leaves overflow it.
  ghosts      the U list of a rank's target leaves reads source leaves
              of other ranks: their points and normals are placed at
              setup in the compacted U list (in the target leaf's frame,
              as `AdaptiveFMM._setup_ulist` builds it); their densities
              come in one ragged all-to-all an evaluation, over routing
              tables from `ragged_route_tables`.
  S2M         own leaves; the per-level upward equivalents all-reduced.
  M2M, V, L2L the same on every rank, on the node arrays.
  X           source-side: each rank's own leaves' points into the
              nodes' down-check potentials, all-reduced.
  L2T, W      own target leaves (the W table holds only those).
  U           own target leaves through the hand-written `p2p_ulist`,
              its sources the own and ghost leaves' real points, the
              densities read through an index into [own slots; ghost
              slots] (the JAX package's U list here is plain,
              adaptive_dist.py:526-540).

Every stage but U is plain torch in float64, as in `AdaptiveFMM`; the
densities, potentials and the U list are in `dtype`.  The setup runs
the whole tree's host setup on every rank and then frees the whole
tree's point-sized device arrays (adaptive_dist.py:295-300).

API: `setup(x_src, x_trg, n_src=None)` takes the global host arrays on
every rank; `eval(f)` the global densities and returns the global
potential on every rank.  `eval_tensor(f_local)` is the rank's block in
and out on its device: the densities of the sources `src_index` (global
input indices, the block's order) to the potentials of the targets
`trg_index`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..comm.comm import Comm
from ..comm.verbs import allgatherv, alltoallv, ragged_route_tables
from ..ops.kernels import KernelSpec
from ..ops.p2p import p2p_ulist
from ..tree.dist_tree import DistPtTree, LeafCapacityError
from ..tree.tree import _normalize
from .adaptive import _FAR_DTYPE, AdaptiveFMM, _allreduce_list
from .kifmm import KIFMMOperators, _mark


class AdaptiveFMMDist:
    """Memory-sharded adaptive KIFMM over comm's ranks.

        fmm = AdaptiveFMMDist(Laplace3D_FxU, comm, p=6, max_pts=64)
        fmm.setup(x_src, x_trg)          # global host arrays, every rank
        u = fmm.eval(f)                  # global numpy in and out
        u_loc = fmm.eval_tensor(f_loc)   # the rank's block, on its device

    The accuracy of `AdaptiveFMM` (the same trees, lists and operators).
    device, dtype, operators: as AdaptiveFMM's."""

    def __init__(self, ker_s2t: KernelSpec, comm: Optional[Comm] = None,
                 p: int = 6, max_pts: int = 256,
                 ker_l2t: Optional[KernelSpec] = None,
                 ker_s2m: Optional[KernelSpec] = None, device=None,
                 dtype: torch.dtype = torch.float32,
                 operators: Optional[KIFMMOperators] = None):
        self.comm = comm or Comm.self_()
        self.ndev = self.comm.size()
        self.rank = self.comm.rank()
        self._afmm = AdaptiveFMM(ker_s2t, p=p, max_pts=max_pts,
                                 ker_l2t=ker_l2t, ker_s2m=ker_s2m,
                                 device=device, dtype=dtype,
                                 operators=operators)
        self.device = self._afmm.device
        self.dtype = dtype

    # -- setup -------------------------------------------------------------
    def _build_skeleton_dist(self, x_src, offset, scale):
        """The skeleton by `DistPtTree` over each rank's block of the
        sources, in the normalization (offset, scale): (leaf_keys,
        leaf_levels) host arrays.  The leaf capacity grows on overflow
        (adaptive_dist.py:113-135)."""
        comm, ndev, r = self.comm, self.ndev, self.rank
        max_pts = self._afmm.max_pts
        n = len(x_src)
        C = max(1, -(-n // ndev))
        lo, hi = min(n, r * C), min(n, (r + 1) * C)
        X = torch.zeros((C, 3), dtype=torch.float64, device=self.device)
        X[:hi - lo] = torch.as_tensor(x_src[lo:hi], device=self.device)
        leaf_cap = max(256, 16 * (-(-n // max_pts)))
        for _ in range(6):
            tree = DistPtTree(comm, leaf_cap=leaf_cap, pt_cap=2 * C,
                              max_level=12)
            try:
                lk, ll, nl, _, _ = tree.build_fn(
                    max_pts, balance21=True, bbox=(offset, scale))(X, hi - lo)
                break
            except LeafCapacityError as e:   # the same count on every rank
                leaf_cap = max(2 * leaf_cap, e.n_leaf)
        else:
            raise RuntimeError("DistPtTree leaf capacity kept overflowing: "
                               f"leaf_cap {leaf_cap}")
        return (lk[:nl].cpu().numpy().astype(np.uint64),
                ll[:nl].cpu().numpy())

    def setup(self, x_src, x_trg, n_src=None):
        af = self._afmm
        comm, ndev, r = self.comm, self.ndev, self.rank
        x_src = np.asarray(x_src, np.float64)
        x_trg = np.asarray(x_trg, np.float64)
        _, off, sc = _normalize(np.concatenate([x_src, x_trg]))
        af.setup(x_src, x_trg, n_src,
                 skeleton=self._build_skeleton_dist(x_src, off, sc))
        dev = self.device
        n_leaf, cs, ct = af.n_leaf, af.cap_s, af.cap_t
        self.n_leaf = n_leaf
        self.Cb = Cb = max(1, -(-n_leaf // ndev))
        self.lo = lo = min(n_leaf, r * Cb)
        self.hi = hi = min(n_leaf, lo + Cb)
        nb = hi - lo
        owner = np.minimum(np.arange(n_leaf) // Cb, ndev - 1)
        host = lambda a: a.cpu().numpy()
        ti = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)

        def own(a):
            """(n_leaf, ...) -> the block's Cb rows, zeros past its
            leaves."""
            out = a.new_zeros((Cb,) + a.shape[1:])
            out[:nb] = a[lo:hi]
            return out

        self.xs_own, self.ns_own, self.xt_own = (
            own(af.xs_loc), own(af.ns_pad), own(af.xt_loc))

        # ---- host plumbing of the block: its sources and targets ----
        tree = af.tree
        sidx, svalid = host(af.sidx), host(af.svalid) > 0
        t_cnt = host(af.ul_tcnt).astype(np.int64)
        t_dsp = np.concatenate([[0], np.cumsum(t_cnt)])
        s_lo = int(tree.leaf_dsp[lo]) if nb else 0
        s_hi = int(tree.leaf_dsp[hi - 1] + tree.leaf_cnt[hi - 1]) if nb else 0
        self.src_index = tree.perm[s_lo:s_hi]
        self.trg_index = host(af.t_perm)[t_dsp[lo]:t_dsp[hi]]
        pad = np.zeros((Cb, cs), np.int64)
        valid = np.zeros((Cb, cs), bool)
        pad[:nb] = np.clip(sidx[lo:hi] - s_lo, 0, max(s_hi - s_lo - 1, 0))
        valid[:nb] = svalid[lo:hi]
        self.pad_idx = ti(pad)
        self.pad_valid = torch.as_tensor(valid, device=dev).to(self.dtype)
        tvalid = np.zeros((Cb, ct), bool)
        tvalid[:nb] = np.arange(ct)[None, :] < t_cnt[lo:hi, None]
        self.take = ti(np.nonzero(tvalid.reshape(-1))[0])
        self.t_dsp = t_dsp                   # targets by leaf, sorted order
        self._t_perm = host(af.t_perm)
        self.trg_index_all = [
            self._t_perm[t_dsp[min(n_leaf, q * Cb)]:
                         t_dsp[min(n_leaf, (q + 1) * Cb)]]
            for q in range(ndev)]

        # ---- U-list ghosts: per (requester d, ghost leaf s), sorted by
        # (d, s), each leaf's densities from its owner ----
        ulist = np.where(host(af.ul_ok) > 0, host(af.ul_rows), -1)
        gi, ji = np.nonzero(ulist >= 0)
        s_all = ulist[gi, ji]
        d_all = owner[gi]
        off_rank = owner[s_all] != d_all
        pkey = np.unique(d_all[off_rank] * np.int64(n_leaf)
                         + s_all[off_rank])
        pd, ps = pkey // n_leaf, pkey % n_leaf
        po = owner[ps]
        send_idx, scnt_g, _, _, _, rpos = ragged_route_tables(
            po, ps - po * Cb, pd, [], ndev)
        self.ghost_cnt = scnt_g[r]                   # to each rank
        self.ghost_send = ti(send_idx[r][:scnt_g[r].sum()])
        self.Crg = int(scnt_g[:, r].sum())           # ghost leaves received
        ext_row = np.full(n_leaf, -1, np.int64)      # leaf -> [own; ghosts]
        ext_row[lo:hi] = np.arange(nb)
        mine = pd == r
        ext_row[ps[mine]] = Cb + rpos[mine]

        # ---- the U list of the block's target leaves, compacted (a
        # segment of the whole tree's), its densities through ext_row ----
        if nb:
            rng = host(af.ul_rng).astype(np.int64)
            a0, a1 = int(rng[lo, 0]), int(rng[hi - 1, 1])
            fidx = host(af.ul_fidx)[a0:a1].astype(np.int64)
            leaf, slot = fidx // cs, fidx % cs
            if np.any(ext_row[leaf] < 0):
                raise RuntimeError("AdaptiveFMMDist: a U-list source leaf "
                                   "has no ghost row")
            self.ul_fidx = i32(ext_row[leaf] * cs + slot)
            self.ul_rng = i32(rng[lo:hi] - a0)
            self.ul_tcnt = af.ul_tcnt[lo:hi].contiguous()
            self.ul_xt = af.ul_xt[lo:hi].contiguous()
            self.ul_xs = af.ul_xs[:, a0:a1].contiguous()
            self.ul_ns = (None if af.ul_ns is None
                          else af.ul_ns[:, a0:a1].contiguous())
            self.n_ulist_pairs = int((np.diff(rng[lo:hi], axis=1)[:, 0]
                                      * t_cnt[lo:hi]).sum())
        else:
            self.ul_xs = None
            self.n_ulist_pairs = 0

        # ---- per-level own-leaf rows (S2M and L2T), X source-side, W
        # over own target leaves ----
        def sel_rows(rows, *rest):
            m = (rows >= lo) & (rows < hi)
            return (rows[m] - lo,) + tuple(a[m] for a in rest)

        self.leaves = {}
        for lv, rows in af.leaf_rows.items():
            rw, nd = sel_rows(rows, af.leaf_nodes[lv])
            if len(rw):
                self.leaves[lv] = (rw, nd)
        self.xpairs, self.wpairs = {}, {}
        for lv, (xn, xl, xo) in af.xpairs.items():
            xl_, xn_, xo_ = sel_rows(xl, xn, xo)
            if len(xl_):
                self.xpairs[lv] = (xn_, xl_, xo_)
        for lv, (tl, sn, wo) in af.wpairs.items():
            w = sel_rows(tl, sn, wo)
            if len(w[0]):
                self.wpairs[lv] = w

        # free the whole tree's point-sized device arrays and tables: the
        # block's copies above are the device's only point data
        for name in ("xs_loc", "ns_pad", "xt_loc", "src_perm", "sidx",
                     "svalid", "t_perm", "t_take", "ul_rows", "ul_ok",
                     "ul_fidx", "ul_rng", "ul_tcnt", "ul_xs", "ul_ns",
                     "ul_xt", "leaf_rows", "leaf_nodes", "xpairs",
                     "wpairs"):
            setattr(af, name, None)
        return self

    # -- density plumbing ----------------------------------------------------
    def pad_density(self, f_local: torch.Tensor) -> torch.Tensor:
        """The block's source densities (src_index order) -> (Cb, cap_s,
        k0) leaf slots, zero in padding."""
        k0 = self._afmm.ker_s2t.kdim0
        f = f_local.to(self.device, self.dtype).reshape(-1, k0)
        if f.shape[0] == 0:
            return f.new_zeros(self.pad_idx.shape + (k0,))
        return f[self.pad_idx] * self.pad_valid[..., None]

    def eval_tensor(self, f_local: torch.Tensor,
                    marks: Optional[list] = None) -> torch.Tensor:
        """The rank's block: densities (n_src_local, k0) in src_index
        order -> potentials (n_trg_local, k1) in trg_index order, on the
        device.  With `marks` a list, CUDA events after each stage (see
        `_eval_dist`)."""
        u = self._eval_dist(self.pad_density(f_local), marks)
        return u.reshape(-1, self._afmm.ker_l2t.kdim1)[self.take]

    def eval(self, f) -> np.ndarray:
        """Global densities (n_src, k0) -> the global potential (n_trg,
        k1), numpy, on every rank (the blocks' results all-gathered)."""
        af = self._afmm
        k0, k1 = af.ker_s2t.kdim0, af.ker_l2t.kdim1
        f = np.asarray(f, np.float64).reshape(-1, k0)
        u = allgatherv(self.comm,
                       self.eval_tensor(torch.as_tensor(f[self.src_index])))
        out = np.empty((len(self._t_perm), k1))
        out[np.concatenate(self.trg_index_all)] = u.cpu().numpy()
        return out

    # -- the sharded evaluation ----------------------------------------------
    def _ghost_exchange(self, fp_loc: torch.Tensor) -> torch.Tensor:
        """(Cb, cap_s, k0) own leaf densities -> (Cb + Crg, cap_s, k0)
        with the ghost leaves' densities after them, in one ragged
        all-to-all (tree.txx:668)."""
        if self.comm.is_self:
            return fp_loc
        rbuf, _ = alltoallv(self.comm, fp_loc[self.ghost_send],
                            self.ghost_cnt, self.Crg)
        return torch.cat([fp_loc, rbuf])

    def _eval_dist(self, fp_loc: torch.Tensor,
                   marks: Optional[list] = None) -> torch.Tensor:
        """(Cb, cap_s, k0) own leaf-slot densities -> (Cb, cap_t, k1) own
        leaf-slot potentials, in dtype.  Stages marked: ghost exchange,
        S2M, S2M all-reduce, M2M, V, X, X all-reduce, L2L, L2T, W, U."""
        af, comm = self._afmm, self.comm
        reduce = (lambda qs: qs) if comm.is_self else (
            lambda qs: _allreduce_list(comm, qs))
        ext = self._ghost_exchange(fp_loc)
        _mark(marks, "ghost exchange")
        fp = fp_loc.to(_FAR_DTYPE)
        xs, ns, xt = self.xs_own, self.ns_own, self.xt_own
        q_up = af._s2m(fp, xs, ns, self.leaves)
        _mark(marks, "S2M")
        q_up = reduce(q_up)
        _mark(marks, "S2M all-reduce")
        af._m2m(q_up)
        _mark(marks, "M2M")
        q_dn = af._vlist(q_up)
        _mark(marks, "V")
        q_x = [torch.zeros_like(q) for q in q_dn]
        af._xlist(q_x, fp, xs, ns, self.xpairs)
        _mark(marks, "X")
        for q, qx in zip(q_dn, reduce(q_x)):
            q += qx
        _mark(marks, "X all-reduce")
        af._l2l(q_dn)
        _mark(marks, "L2L")
        u_out = torch.zeros((self.Cb, af.cap_t, af.ker_l2t.kdim1),
                            dtype=_FAR_DTYPE, device=self.device)
        af._l2t(u_out, q_dn, xt, self.leaves)
        _mark(marks, "L2T")
        af._wlist(u_out, q_up, xt, self.wpairs)
        _mark(marks, "W")
        if self.ul_xs is not None:
            u_near = p2p_ulist(af.ker_s2t, *self.ulist_args(ext))
            u_out[:u_near.shape[0]] += (u_near.to(_FAR_DTYPE)
                                        * af.ker_s2t.scale_factor)
        _mark(marks, "U")
        return u_out.to(self.dtype)

    def ulist_args(self, ext: torch.Tensor):
        """[own; ghost] leaf-slot densities -> the U-list kernel's
        arguments for the block's target leaves (one launch)."""
        return (self.ul_xt, self.ul_xs, self.ul_ns,
                ext.reshape(-1, ext.shape[-1]), self.ul_rng, self.ul_tcnt,
                self.ul_fidx)
