"""Adaptive-tree KIFMM (counterpart of sctl_tpu/fmm/adaptive.py:272-959).

For strongly nonuniform point sets such as the BIE far field (points on
a 2-D surface in 3-D), where a uniform tree's dense grids blow up:

  tree      2:1-balanced adaptive octree on the sources (tree.PtTree);
            targets assigned to its leaves.
  nodes     per-level sorted node arrays (leaves and ancestors) with
            child -> parent maps and the U, V, W, X interaction lists,
            all built on the host once.
  S2M       per leaf, check potentials of its points, then uc2e.
  M2M, L2L  per level and octant, one product each.
  V         per level, the 316 offsets as one batched product over
            padded per-offset pair tables, through the compressed
            M2L family (cc_unit, cb_unit).
  X         leaf source points -> node down-check -> dc2e.
  L2T, W    equivalent surfaces -> leaf targets.
  U         leaf-leaf near field through the hand-written CUDA kernel
            `p2p_ulist` (ops/p2p.py), one launch over each target leaf's
            source leaves' real points, compacted at setup (the JAX
            package gathers padded slabs per call, :823-868).

Work-sharded evaluation (`eval_sharded(f, comm)`, adaptive.py:596-920):
every rank holds the whole setup (the points replicated); the leaf and
node stages (S2M, X, L2T, W, U: the O(N) work) are split over the ranks
by index blocks, and the upward equivalents, the X contributions and
the outputs are all-reduced; the node translations (M2M, V, L2L) run
the same on every rank.  Each rank's block of the U list goes through
`p2p_ulist` (the JAX package's sharded path takes its plain U list,
adaptive.py:823).  `setup(skeleton=)` adopts the leaves of a tree built
elsewhere, e.g. a `DistPtTree` skeleton over the same normalization
(adaptive.py:303-336).

Every stage but U is plain torch, as the JAX package runs it outside
Pallas.  Tensors on the card go through the CUDA kernel, tensors on the
CPU through its plain version.  Operator tables are built cold on the
host in float64 (no disk cache) unless passed in.

Precision: densities, potentials and the U list are in `dtype`,
float32 or float64 on either device (the U-list kernel has both
builds); every other stage runs in float64, in leaf- or node-local
coordinates, with float64's pinv cutoff 1e-9.  In float32
(the JAX package's design, cutoff 3e-5) the pinv operators (uc2e,
dc2e) amplify the far field's rounding until the apply is no longer
linear to within 1e-6, deterministic scatter or not: a bench_bie solve
that GMRES returns at 1e-6 then recomputes several times higher
(tests/test_torch_far_precision.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import profile
from ..comm.comm import Comm
from ..config import resolve_device
from ..ops.kernels import KernelSpec
from ..ops.p2p import p2p_ulist
from ..tree import morton as mt
from ..tree.tree import PtTree, _normalize
from .kifmm import (KIFMMOperators, _apply_groups, _mark,
                    _tensor, _vlist_offsets, kernel_roles)

D = mt.MAX_DEPTH_3D
# the type of every stage but the U list (see the module docstring)
_FAR_DTYPE = torch.float64


def _pad_rows(row_ids: np.ndarray, vals: np.ndarray, n_rows: int,
              fill=-1):
    """Group vals by row id into an (n_rows, cap) padded matrix."""
    if len(vals) == 0:
        return np.full((n_rows, 1), fill, dtype=np.int64), 1
    order = np.argsort(row_ids, kind="stable")
    r, v = row_ids[order], vals[order]
    dsp = np.searchsorted(r, np.arange(n_rows + 1))
    cnt = np.diff(dsp)
    cap = max(1, int(cnt.max()))
    out = np.full((n_rows, cap), fill, dtype=np.int64)
    out[r, np.arange(len(v)) - np.repeat(dsp[:-1], cnt)] = v
    return out, cap


class _NodeLevels:
    """Per-level sorted node sets of the adaptive tree (every leaf and
    every ancestor) with child -> (parent index, octant) maps."""

    def __init__(self, leaf_keys: np.ndarray, leaf_lvl: np.ndarray):
        self.max_lvl = int(leaf_lvl.max()) if len(leaf_lvl) else 0
        keys = [np.sort(leaf_keys[leaf_lvl == lvl]).astype(np.uint64)
                for lvl in range(self.max_lvl + 1)]
        for lvl in range(self.max_lvl, 0, -1):
            shift = np.uint64(3 * (D - (lvl - 1)))
            par = (keys[lvl] >> shift) << shift
            keys[lvl - 1] = np.unique(np.concatenate([keys[lvl - 1], par]))
        self.keys = keys
        self.n = [len(k) for k in keys]
        self.parent_idx, self.octant = [None], [None]
        for lvl in range(1, self.max_lvl + 1):
            shift = np.uint64(3 * (D - (lvl - 1)))
            pk = (keys[lvl] >> shift) << shift
            self.parent_idx.append(
                np.searchsorted(keys[lvl - 1], pk).astype(np.int64))
            self.octant.append(((keys[lvl] >> np.uint64(3 * (D - lvl)))
                                & np.uint64(7)).astype(np.int64))

    def index_of(self, lvl: int, keys: np.ndarray):
        """Indices of keys in level lvl's sorted array; -1 if absent."""
        i = np.clip(np.searchsorted(self.keys[lvl], keys), 0,
                    max(self.n[lvl] - 1, 0))
        ok = (self.n[lvl] > 0) & (self.keys[lvl][i] == keys)
        return np.where(ok, i, -1)


def _build_lists(nodes: _NodeLevels, leaf_keys, leaf_lvl):
    """U, V, W, X interaction lists of a 2:1-balanced linear octree
    (sctl_tpu/fmm/adaptive.py:113-269, the same definitions):

      V: same-level nodes whose parents are adjacent, not adjacent;
      U: adjacent leaves (self included) -> direct P2P;
      W: leaf T and node S one level finer, S's parent adjacent to T,
         S not adjacent to T -> multipole(S) -> targets(T);
      X: the dual of W -> points(S) -> local(T).
    """
    L = nodes.max_lvl
    n_leaf = len(leaf_keys)
    leaf_lvl = np.asarray(leaf_lvl, np.int64)
    leaf_keys = np.asarray(leaf_keys, np.uint64)
    leaf_row_of_node = [np.full(nodes.n[lvl], -1, dtype=np.int64)
                        for lvl in range(L + 1)]
    for lvl in range(L + 1):
        rows = np.where(leaf_lvl == lvl)[0]
        if len(rows):
            leaf_row_of_node[lvl][nodes.index_of(lvl, leaf_keys[rows])] \
                = rows
    ends = leaf_keys + (np.uint64(1) << (np.uint64(3) * (
        np.uint64(D) - leaf_lvl.astype(np.uint64))))
    leaf_lo = mt.morton_decode(leaf_keys).astype(np.int64)
    leaf_sz = (np.int64(1) << (D - leaf_lvl)).astype(np.int64)

    def adj_leaf_leaf(i, j):
        lo1, lo2 = leaf_lo[i], leaf_lo[j]
        hi1 = lo1 + leaf_sz[i][:, None]
        hi2 = lo2 + leaf_sz[j][:, None]
        return np.all((lo1 <= hi2) & (lo2 <= hi1), axis=1)

    def adj_leaf_box(i, box_keys, box_lvl):
        lo1 = leaf_lo[i]
        hi1 = lo1 + leaf_sz[i][:, None]
        lo2 = mt.morton_decode(np.asarray(box_keys, np.uint64)).astype(
            np.int64)
        hi2 = lo2 + np.int64(1 << (D - box_lvl))
        return np.all((lo1 <= hi2) & (lo2 <= hi1), axis=1)

    V = {lvl: [] for lvl in range(2, L + 1)}      # (ti, si, offset id)
    offsets316, _ = _vlist_offsets()
    for lvl in range(2, L + 1):
        if nodes.n[lvl] == 0:
            continue
        coords = mt.box_coords(nodes.keys[lvl], lvl)
        side = 1 << lvl
        par = coords & 1
        for oid, d in enumerate(offsets316):
            nc = coords + d[None, :]
            ok = np.all((nc >= 0) & (nc < side), axis=1)
            if not ok.any():
                continue
            si = nodes.index_of(lvl, mt.coords_to_key(
                np.clip(nc, 0, side - 1), lvl))
            keep = ok & (si >= 0) & (np.abs(np.floor_divide(
                par + d[None, :], 2)).max(axis=1) <= 1)
            V[lvl].append((np.where(keep)[0], si[keep], oid))

    U_t, U_s = [], []
    W_lvl, W_leaf, W_node = [], [], []
    for lvl in np.unique(leaf_lvl):
        lvl = int(lvl)
        sel = np.where(leaf_lvl == lvl)[0]
        k_l = leaf_keys[sel]
        m = len(sel)
        nbk, valid = mt.morton_neighbors(k_l, lvl)
        cand = np.concatenate([k_l[:, None], nbk], axis=1)    # (m, 27)
        cval = np.concatenate([np.ones((m, 1), bool), valid], axis=1)
        ck, cv = cand.reshape(-1), cval.reshape(-1)
        ci = np.repeat(sel, cand.shape[1])
        # U (a): the coarser-or-equal leaf containing the candidate box
        j0 = np.searchsorted(leaf_keys, ck, side="left")
        jm = np.clip(j0 - 1, 0, n_leaf - 1)
        okm = cv & (j0 > 0) & (ck < ends[jm]) & (leaf_lvl[jm] <= lvl)
        tm, sm = ci[okm], jm[okm]
        keepm = adj_leaf_leaf(tm, sm)
        U_t.append(tm[keepm])
        U_s.append(sm[keepm])
        # U (b): leaves inside the candidate box, at most one level finer
        ck_end = ck + (np.uint64(1) << np.uint64(3 * (D - lvl)))
        j1 = np.searchsorted(leaf_keys, ck_end, side="left")
        cnt = np.where(cv, j1 - j0, 0).astype(np.int64)
        ti = np.repeat(ci, cnt)
        jj = np.repeat(j0, cnt) + (np.arange(int(cnt.sum()))
                                   - np.repeat(np.cumsum(cnt) - cnt, cnt))
        keep = leaf_lvl[jj] <= lvl + 1
        ti, jj = ti[keep], jj[keep]
        keep2 = adj_leaf_leaf(ti, jj)
        U_t.append(ti[keep2])
        U_s.append(jj[keep2])
        # W / X: children of candidate boxes, present, not adjacent
        if lvl + 1 <= L and nodes.n[lvl + 1]:
            chf = mt.morton_children(ck, lvl).reshape(-1)
            si = nodes.index_of(lvl + 1, chf)
            ok = np.repeat(cv, 8) & (si >= 0)
            iw, siw, chw = np.repeat(ci, 8)[ok], si[ok], chf[ok]
            adj = adj_leaf_box(iw, chw, lvl + 1)
            W_lvl.append(np.full(int((~adj).sum()), lvl + 1, np.int64))
            W_leaf.append(iw[~adj])
            W_node.append(siw[~adj])

    cat = (lambda parts: np.concatenate(parts) if parts
           else np.zeros(0, np.int64))
    UT, US = cat(U_t), cat(U_s)
    U_pairs = (np.unique(np.stack([UT, US], 1), axis=0) if len(UT)
               else np.zeros((0, 2), np.int64))
    W = (cat(W_lvl), cat(W_leaf), cat(W_node))
    return V, U_pairs, W, leaf_row_of_node


class AdaptiveFMM:
    """Adaptive-tree KIFMM evaluator.

        fmm = AdaptiveFMM(Stokes3D_DxU, ker_l2t=Stokes3D_FSxU)
        fmm.setup(x_src, x_trg, n_src)
        u = fmm.eval(f)               # numpy in, numpy out
        u = fmm.eval_tensor(f)        # device tensors in and out

    device    : "cuda" (default) runs the U list's CUDA kernel, "cpu"
                its plain version.
    dtype     : torch.float32 or torch.float64, on the card too: the
                densities, potentials and U list (the kernel's float32
                or float64 build); the other stages run in float64.
    operators : KIFMMOperators of the translation kernel at order p, for
                example from `operators_from_numpy`; built cold if None.
    """

    def __init__(self, ker_s2t: KernelSpec, p: int = 6, max_pts: int = 256,
                 ker_l2t: Optional[KernelSpec] = None,
                 ker_s2m: Optional[KernelSpec] = None, device=None,
                 dtype: torch.dtype = torch.float32,
                 rcond: Optional[float] = None,
                 operators: Optional[KIFMMOperators] = None):
        self.ker_s2t = ker_s2t
        self.ker_trans, self.ker_l2t, self.ker_s2m = kernel_roles(
            ker_s2t, ker_l2t, ker_s2m)
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(f"AdaptiveFMM dtype {dtype}")
        self.p = p
        self.max_pts = max_pts
        self.dtype = dtype
        self.rcond = 1e-9 if rcond is None else rcond
        self._ops = operators

    def build_operators(self) -> KIFMMOperators:
        """The translation kernel's tables at order p, built cold on the
        host in float64."""
        return KIFMMOperators(self.ker_trans, self.p, self.rcond,
                              self.device, _FAR_DTYPE)

    # -- setup ------------------------------------------------------------
    def setup(self, x_src, x_trg, n_src=None, skeleton=None):
        """skeleton: optional (leaf_keys, leaf_levels) of a 2:1-balanced
        linear octree over this setup's normalization (the shared
        bounding box of sources and targets), e.g. from
        DistPtTree.build_fn(bbox=(offset, scale)): adopted as it is, with
        no refinement (sctl_tpu/fmm/adaptive.py:303-336)."""
        if (self.ker_s2t.needs_normal or self.ker_s2m.needs_normal) \
                and n_src is None:
            raise ValueError(
                f"kernel {self.ker_s2t.name} requires source normals")
        x_src = np.asarray(x_src, np.float64)
        x_trg = np.asarray(x_trg, np.float64)
        _, off, sc = _normalize(np.concatenate([x_src, x_trg]))
        self.offset, self.scale = off, sc
        if skeleton is not None:
            tree = PtTree.with_leaves(x_src, off, sc, *skeleton)
        else:
            tree = PtTree.refined(x_src, off, sc, self.max_pts)
        self.tree = tree
        self.nodes = nodes = _NodeLevels(tree.leaf_keys, tree.leaf_levels)
        V, U_pairs, (w_lvl, w_leaf, w_node), leaf_row_of_node = \
            _build_lists(nodes, tree.leaf_keys, tree.leaf_levels)
        W = (w_lvl, w_leaf, w_node)
        self.L = L = nodes.max_lvl
        if self._ops is None or self._ops.p != self.p:
            self._ops = self.build_operators()
        ops = self._ops
        lt = ops.level_tables(L, sc)
        dev, dt = self.device, self.dtype
        t = lambda a: _tensor(a, dev, _FAR_DTYPE)
        ti = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self.ns = ops.n_surf * ops.k0t

        # targets -> leaves (same normalization)
        tkeys = mt.morton_encode((x_trg - off) / sc)
        t_perm = np.argsort(tkeys, kind="stable")
        n_leaf = len(tree.leaf_keys)
        t_leaf = np.clip(np.searchsorted(tree.leaf_keys, tkeys[t_perm],
                                         side="right") - 1, 0, n_leaf - 1)
        t_dsp = np.searchsorted(t_leaf, np.arange(n_leaf + 1))
        self.cap_s = cap_s = max(8, int(tree.leaf_cnt.max()))
        self.cap_t = cap_t = max(8, int(np.diff(t_dsp).max()))
        sidx = tree.leaf_dsp[:, None] + np.arange(cap_s)[None, :]
        svalid = sidx < (tree.leaf_dsp + tree.leaf_cnt)[:, None]
        sidx = np.clip(sidx, 0, len(x_src) - 1)
        tidx = t_dsp[:-1, None] + np.arange(cap_t)[None, :]
        tvalid = tidx < t_dsp[1:, None]
        tidx = np.clip(tidx, 0, max(len(x_trg) - 1, 0))
        ns_sorted = (np.asarray(n_src, np.float64)[tree.perm]
                     if n_src is not None else np.zeros_like(tree.X_sorted))
        lvl = tree.leaf_levels.astype(np.int64)
        ctr = ((mt.morton_decode(tree.leaf_keys).astype(np.float64)
                / (1 << D)) + (1.0 / (1 << lvl))[:, None] / 2) * sc + off

        # leaf-local coordinates, formed in float64: every float32 pair
        # difference then carries the leaf's scale, not the domain's
        self.n_leaf = n_leaf
        self.leaf_ctr = ctr                             # each leaf's frame
        xs_p = tree.X_sorted[sidx]                      # (n_leaf, cap_s, 3)
        self.xs_loc = t(xs_p - ctr[:, None, :])
        self.ns_pad = t(ns_sorted[sidx])
        self.xt_loc = t(x_trg[t_perm][tidx] - ctr[:, None, :])
        self.src_perm = ti(tree.perm)
        self.sidx = ti(sidx)
        self.svalid = _tensor(svalid, dev, dt)
        self.t_perm = ti(t_perm)
        self.t_take = ti(np.nonzero(tvalid.reshape(-1))[0])
        self.n_trg = len(x_trg)

        self.uc2e = [t(a) for a in lt["uc2e"]]
        self.dc2e = [t(a) for a in lt["dc2e"]]
        self.surf_in = [t(a) for a in lt["surf_in"]]
        self.surf_out = [t(a) for a in lt["surf_out"]]
        self.m2l_s = [t(a) for a in lt["m2l_s"]]
        self.m2m = [t(np.transpose(a, (0, 2, 1))) for a in lt["m2m"]]
        self.l2l = [t(np.transpose(a, (0, 2, 1))) for a in lt["l2l"]]
        self.cc_t = t(np.transpose(ops.cc_unit, (0, 2, 1)))  # (316, ns, r)
        self.cb_t = t(ops.cb_unit.T)                         # (r, ns)

        # leaves per level, node maps and octant groups
        self.leaf_rows, self.leaf_nodes = {}, {}
        for lv in range(1, L + 1):
            m = leaf_row_of_node[lv] >= 0
            if m.any():
                self.leaf_rows[lv] = ti(leaf_row_of_node[lv][m])
                self.leaf_nodes[lv] = ti(np.where(m)[0])
        self.oct_groups = {}
        for lv in range(1, L + 1):
            groups = [(c, np.where(nodes.octant[lv] == c)[0])
                      for c in range(8)]
            self.oct_groups[lv] = [(c, ti(rows),
                                    ti(nodes.parent_idx[lv][rows]))
                                   for c, rows in groups if len(rows)]
        node_ctr = [((mt.morton_decode(nodes.keys[lv]).astype(np.float64)
                      / (1 << D) + (1.0 / (1 << lv)) / 2) * sc + off)
                     for lv in range(L + 1)]

        # V: per level, (316, Pcap) padded per-offset pair tables
        self.vtab = {}
        for lv in range(2, L + 1):
            if not V.get(lv):
                continue
            tis = np.concatenate([a for a, _, _ in V[lv]])
            sis = np.concatenate([b for _, b, _ in V[lv]])
            oids = np.concatenate([np.full(len(a), o, np.int64)
                                   for a, _, o in V[lv]])
            tpad, _ = _pad_rows(oids, tis, 316)
            spad, _ = _pad_rows(oids, sis, 316)
            self.vtab[lv] = (ti(tpad), ti(spad))
        # W (target leaf, finer node) and X (node, source leaf) pairs,
        # with the offset between the two centres (float64, then cast)
        self.wpairs, self.xpairs = {}, {}
        for lv in range(1, L + 1):
            msk = W[0] == lv
            if msk.any():
                tl, sn = W[1][msk], W[2][msk]
                off_ = node_ctr[lv][sn] - ctr[tl]
                self.wpairs[lv] = (ti(tl), ti(sn), t(off_))
                self.xpairs[lv] = (ti(sn), ti(tl), t(-off_))
        self._setup_ulist(U_pairs, xs_p, ctr, np.diff(t_dsp))
        return self

    def _setup_ulist(self, U_pairs, xs_p, ctr, t_cnt):
        """The U list compacted to real points: per target leaf, its
        source leaves' real slots as one run of a flat list, in the
        target leaf's frame (formed in float64, then cast), with each
        source's leaf-slot row for the densities (`ul_fidx`), the runs
        (`ul_rng`) and the real target counts (`ul_tcnt`).  `ul_rows`
        and `ul_ok` keep the padded list (JAX's `data["ulist"]`)."""
        n_leaf, cs = self.n_leaf, self.cap_s
        ulist, self.u_cap = _pad_rows(U_pairs[:, 0], U_pairs[:, 1], n_leaf)
        ok = ulist >= 0
        rc = np.where(ok, ulist, 0)
        self.ul_rows = torch.as_tensor(rc, device=self.device)
        self.ul_ok = torch.as_tensor(ok, device=self.device).to(self.dtype)
        # (target leaf, source leaf) in list order, each source leaf's
        # real slots side by side
        tl = np.repeat(np.arange(n_leaf), ok.sum(axis=1))
        sl = ulist[ok]
        cnt = self.tree.leaf_cnt[sl].astype(np.int64)
        run = np.repeat(np.cumsum(cnt) - cnt, cnt)
        slot = np.repeat(sl * cs, cnt) + np.arange(cnt.sum()) - run
        per_leaf = np.bincount(tl, weights=cnt, minlength=n_leaf) \
            .astype(np.int64)
        ends = np.cumsum(per_leaf)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                        device=self.device)
        self.ul_fidx = i32(slot)
        self.ul_rng = i32(np.stack([ends - per_leaf, ends], 1))
        self.ul_tcnt = i32(t_cnt)
        xs = xs_p.reshape(-1, 3)[slot] - ctr[np.repeat(tl, cnt)]
        self.ul_xs = torch.as_tensor(np.ascontiguousarray(xs.T),
                                     device=self.device).to(self.dtype)
        self.ul_ns = (self.ns_pad.reshape(-1, 3)[self.ul_fidx.long()].T
                      .to(self.dtype).contiguous()
                      if self.ker_s2t.needs_normal else None)
        self.ul_xt = self.xt_loc.transpose(1, 2).to(self.dtype) \
            .contiguous()

    # -- density / output plumbing ----------------------------------------
    def pad_density(self, f: torch.Tensor) -> torch.Tensor:
        """Input-order densities (n_src, k0) -> (n_leaf, cap_s, k0) leaf
        slots, zero in padding."""
        k0 = self.ker_s2t.kdim0
        fs = f.to(self.device, self.dtype).reshape(-1, k0)[self.src_perm]
        return fs[self.sidx] * self.svalid[..., None]

    def unsort(self, u_pad: torch.Tensor) -> torch.Tensor:
        """(n_leaf, cap_t, k1) leaf-slot results -> input target order."""
        k1 = self.ker_l2t.kdim1
        out = u_pad.new_zeros((self.n_trg, k1))
        out[self.t_perm] = u_pad.reshape(-1, k1)[self.t_take]
        return out

    def eval(self, f) -> np.ndarray:
        """f (n_src, k0) numpy -> (n_trg, k1) numpy, input orders."""
        f = torch.as_tensor(np.asarray(f), device=self.device,
                            dtype=self.dtype)
        return self.eval_tensor(f).cpu().numpy()

    def eval_tensor(self, f: torch.Tensor) -> torch.Tensor:
        """Device-resident evaluation (the counterpart of `eval_jnp`):
        f (n_src, k0) tensor -> (n_trg, k1) tensor, input orders; timed
        in the profile block "AdaptiveFMM::Eval" (with sync), as at
        sctl_tpu/fmm/adaptive.py:553."""
        fp = self.pad_density(f)
        with profile.Profile.scoped("AdaptiveFMM::Eval", sync=True):
            u_pad = self._eval_impl(fp)
        return self.unsort(u_pad)

    # -- evaluation -----------------------------------------------------------
    def eval_sharded(self, f, comm: Comm) -> np.ndarray:
        """Work-sharded evaluation over the ranks of `comm` (every rank
        set up alike, f the same on every rank): the leaf and node
        stages split by index blocks, the partial moments and outputs
        all-reduced (sctl_tpu/fmm/adaptive.py:893-920).  f (n_src, k0)
        numpy -> (n_trg, k1) numpy, input orders, on every rank."""
        f = torch.as_tensor(np.asarray(f), device=self.device,
                            dtype=self.dtype)
        fp = self.pad_density(f)
        with profile.Profile.scoped("AdaptiveFMM::EvalSharded", sync=True):
            u_pad = self._eval_impl(fp, shard=comm)
        return self.unsort(u_pad).cpu().numpy()

    def _eval_impl(self, fp: torch.Tensor, marks: Optional[list] = None,
                   shard: Optional[Comm] = None):
        """Leaf-slot densities -> (n_leaf, cap_t, k1) potentials.  With
        `marks` a list, a CUDA event is recorded after each stage: S2M,
        M2M, V, X, L2L, L2T, W, U.  With `shard` a comm, this rank runs
        its index block of each leaf and node stage (`_block`) and the
        partial results are all-reduced over the comm."""
        blk = (lambda m: slice(0, m)) if shard is None else (
            lambda m: _block(m, shard.size(), shard.rank()))
        fp_io, fp = fp, fp.to(_FAR_DTYPE)
        xs, ns, xt = self.xs_loc, self.ns_pad, self.xt_loc
        leaves = {}
        for lv, rows in self.leaf_rows.items():
            b = blk(len(rows))
            leaves[lv] = (rows[b], self.leaf_nodes[lv][b])
        part = lambda pairs: {lv: tuple(a[blk(len(p[0]))] for a in p)
                              for lv, p in pairs.items()}

        q_up = self._s2m(fp, xs, ns, leaves)
        if shard is not None:
            q_up = _allreduce_list(shard, q_up)
        _mark(marks, "S2M")
        self._m2m(q_up)
        _mark(marks, "M2M")
        q_dn = self._vlist(q_up)
        _mark(marks, "V")
        # sharded: the X contributions summed apart, so that the
        # all-reduce leaves V's part single
        q_x = q_dn if shard is None else [torch.zeros_like(q) for q in q_dn]
        self._xlist(q_x, fp, xs, ns, part(self.xpairs))
        if shard is not None and self.xpairs:
            for q, qx in zip(q_dn, _allreduce_list(shard, q_x)):
                q += qx
        _mark(marks, "X")
        self._l2l(q_dn)
        _mark(marks, "L2L")
        u_out = torch.zeros((self.n_leaf, self.cap_t, self.ker_l2t.kdim1),
                            dtype=_FAR_DTYPE, device=self.device)
        self._l2t(u_out, q_dn, xt, leaves)
        _mark(marks, "L2T")
        self._wlist(u_out, q_up, xt, part(self.wpairs))
        _mark(marks, "W")

        # ---- U list: the CUDA kernel over the compacted lists ----
        b = blk(self.n_leaf)
        u_near = self._ulist(fp_io, b)
        u_out[b] += u_near.to(_FAR_DTYPE) * self.ker_s2t.scale_factor
        if shard is not None:
            u_out = shard.allreduce(u_out)
        _mark(marks, "U")
        return u_out.to(self.dtype)

    # -- the stages, on the leaf tables they are given (the whole tree's,
    # a rank's block of them, or a rank's own leaves in AdaptiveFMMDist);
    # every array float64 -------------------------------------------------
    def _s2m(self, fp, xs, ns, leaves: dict) -> list:
        """Leaf densities -> per-level upward equivalents.  leaves: level
        -> (rows of fp / xs / ns, node index at that level)."""
        ks2m = self.ker_s2m
        q_up = [torch.zeros((max(n, 1), self.ns), dtype=_FAR_DTYPE,
                            device=self.device) for n in self.nodes.n]
        for lv, (rows, nodes) in leaves.items():
            xck = self.surf_out[lv].expand(len(rows), -1, -1)
            u = _apply_groups(ks2m, xck, xs[rows], fp[rows],
                              ns[rows] if ks2m.needs_normal else None)
            u = u.reshape(len(rows), -1) * ks2m.scale_factor
            q_up[lv].index_add_(0, nodes, u @ self.uc2e[lv].T)
        return q_up

    def _m2m(self, q_up: list) -> None:
        for lv in range(self.L, 1, -1):
            for c, rows, par in self.oct_groups[lv]:
                q_up[lv - 1].index_add_(0, par,
                                        q_up[lv][rows] @ self.m2m[lv - 1][c])

    def _vlist(self, q_up: list) -> list:
        """Upward -> downward equivalents through the V list: per level
        the 316 offsets batched, the compressed M2L family."""
        dt, ns = _FAR_DTYPE, self.ns
        q_dn = [torch.zeros_like(q) for q in q_up]
        r = self.cb_t.shape[0]
        for lv, (tpad, spad) in self.vtab.items():
            acc = q_up[lv].new_zeros((q_up[lv].shape[0] + 1, r))
            qs = q_up[lv] / self.m2l_s[lv]
            P = tpad.shape[1]
            step = max(1, _v_budget(self.device) // max(1, P * ns))
            for o0 in range(0, 316, step):
                o = slice(o0, o0 + step)
                tp, sp = tpad[o], spad[o]
                g = qs[sp.clamp(min=0)] * (sp >= 0).to(dt)[..., None]
                contrib = torch.bmm(g, self.cc_t[o])         # (no, P, r)
                acc.index_add_(0, torch.where(tp >= 0, tp, acc.shape[0] - 1)
                               .reshape(-1), contrib.reshape(-1, r))
            q_dn[lv] += (acc[:-1] @ self.cb_t) * self.m2l_s[lv]
        return q_dn

    def _xlist(self, q_dn: list, fp, xs, ns, xpairs: dict) -> None:
        """Leaf points -> node down-check -> dc2e, added to q_dn.
        xpairs: level -> (node, source row of fp / xs / ns, offset from
        the leaf's frame to the node's)."""
        ks2m = self.ker_s2m
        for lv, (xn, xl, off) in xpairs.items():
            xck = self.surf_in[lv].expand(len(xn), -1, -1)
            u = _apply_groups(ks2m, xck, xs[xl] + off[:, None, :], fp[xl],
                              ns[xl] if ks2m.needs_normal else None)
            u = u.reshape(len(xn), -1) * ks2m.scale_factor
            q_dn[lv].index_add_(0, xn, u @ self.dc2e[lv].T)

    def _l2l(self, q_dn: list) -> None:
        for lv in range(2, self.L + 1):
            for c, rows, par in self.oct_groups[lv]:
                q_dn[lv].index_add_(0, rows,
                                    q_dn[lv - 1][par] @ self.l2l[lv - 1][c])

    def _l2t(self, u_out, q_dn: list, xt, leaves: dict) -> None:
        """Downward equivalents -> the leaves' targets, added to u_out."""
        kl = self.ker_l2t
        for lv, (rows, nodes) in leaves.items():
            xeq = self.surf_out[lv].expand(len(rows), -1, -1)
            qd = q_dn[lv][nodes].reshape(len(rows), -1, kl.kdim0)
            u_out.index_add_(0, rows, _apply_groups(kl, xt[rows], xeq, qd)
                             * kl.scale_factor)

    def _wlist(self, u_out, q_up: list, xt, wpairs: dict) -> None:
        """Finer-node multipoles -> leaf targets, added to u_out.
        wpairs: level -> (target row of u_out / xt, node, offset)."""
        kl = self.ker_l2t
        for lv, (tl, sn, off) in wpairs.items():
            xe = self.surf_in[lv][None] + off[:, None, :]
            q = q_up[lv][sn].reshape(len(sn), -1, kl.kdim0)
            u_out.index_add_(0, tl, _apply_groups(kl, xt[tl], xe, q)
                             * kl.scale_factor)

    def ulist_args(self, fp: torch.Tensor, leaves: slice = slice(None)):
        """Leaf-slot densities -> the U-list kernel's arguments for the
        target leaves `leaves` (default the whole list; one launch): the
        kernel reads the densities through `ul_fidx`, so nothing is
        gathered here."""
        return (self.ul_xt[leaves], self.ul_xs, self.ul_ns,
                fp.reshape(-1, fp.shape[-1]), self.ul_rng[leaves],
                self.ul_tcnt[leaves], self.ul_fidx)

    def _ulist(self, fp: torch.Tensor,
               leaves: slice = slice(None)) -> torch.Tensor:
        """U-list near field of the target leaves `leaves` -> (leaves,
        cap_t, k1), unscaled."""
        return p2p_ulist(self.ker_s2t, *self.ulist_args(fp, leaves))


def _block(m: int, size: int, rank: int) -> slice:
    """Rank `rank`'s block of range(m): ceil(m / size) indices a rank
    (sctl_tpu/fmm/adaptive.py:607-612)."""
    cap = max(1, -(-m // size))
    return slice(min(m, rank * cap), min(m, (rank + 1) * cap))


def _allreduce_list(comm: Comm, tensors: list) -> list:
    """The tensors of a list summed over the ranks, in one all-reduce."""
    flat = comm.allreduce(torch.cat([t.reshape(-1) for t in tensors]))
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [v.reshape(t.shape) for v, t in zip(parts, tensors)]


def _v_budget(device: torch.device) -> int:
    """Gathered (offset, pair, ns) entries per V-list batch: 1 GiB of
    float64 on the card, the plain versions' chunk on the CPU."""
    return (1 << 27) if device.type == "cuda" else (1 << 22)
