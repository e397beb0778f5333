"""The distributed BIE: the sharded operator application and the
distributed near-pair search (counterpart of sctl_tpu/bie/dist.py;
reference: boundary_integral.txx:46-183 BuildNearList, 1016-1142
ComputePotential through the MPI FMM with ScatterForward to the target
owners).

One process a rank, each on its own tensors (the JAX package's one
traced program over a mesh axis):

  ShardedBIEApply    element-aligned blocks balanced by node count: rank
                     r owns its elements' surface nodes (a contiguous
                     node range), far nodes, interpolation tables, near
                     matrices and target rows.  One application:
                       1. density -> far density: the block's
                          interpolation products, local;
                       2. far field: the FMM regime routes the far
                          densities from element blocks to the
                          `AdaptiveFMMDist` leaf blocks (one ragged
                          all-to-all), evaluates it, and routes the
                          leaf blocks' potentials back to the node
                          owners (a second); the direct regime sums the
                          block's far nodes into every target through
                          `p2p` (`direct_eval_blocked`) and all-reduces
                          the (small, by the cutoff) target potentials;
                       3. near corrections: one batched product on the
                          element owner, routed to the target owners
                          (`alltoallv`) and scatter-added.
                     The density is never replicated.
  build_near_list    the distributed near search, eager on each rank's
                     blocks: grid cells of side at least the largest
                     dist_far, targets routed to their cell-range owner,
                     far nodes copied onto their 27 neighbour cells and
                     routed once, a sorted-range join with the exact
                     distance filter, a local dedupe, the pairs routed
                     to the target's block owner, a final sort and
                     dedupe; it reports the capacities each buffer
                     needed (`need`), so that the caller grows them.

The routing tables are static (`ragged_route_tables`): every rank knows
every rank's send counts, so each exchange is one `all_to_all_single`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..comm.comm import Comm
from ..comm.verbs import (_local_sort_by_key, allgatherv, alltoallv,
                          ragged_route_tables, route)
from ..fmm.kifmm import _mark
from ..ops.direct import direct_eval_blocked


def _rank_within(groups):
    """(M,) group ids -> ((M,) 0-based rank of each element within its
    group in original order, the largest group's size)."""
    M = len(groups)
    if M == 0:
        return np.zeros(0, np.int64), 0
    order = np.argsort(groups, kind="stable")
    gs = np.asarray(groups)[order]
    new = np.concatenate([[True], gs[1:] != gs[:-1]])
    start = np.maximum.accumulate(np.where(new, np.arange(M), 0))
    rank_sorted = np.arange(M) - start
    rank = np.empty(M, np.int64)
    rank[order] = rank_sorted
    return rank, int(rank_sorted.max()) + 1


class _Route:
    """One static ragged exchange of a rank: the rows it sends (grouped
    by destination), every rank's send counts, and where the rows it
    receives land."""

    def __init__(self, send_idx, cnt, places, rank: int, device):
        ti = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                       device=device)
        self.cnt = cnt[rank]                         # to each rank
        self.send = ti(send_idx[rank][:cnt[rank].sum()])
        self.n_recv = int(cnt[:, rank].sum())
        self.places = [ti(p[rank][:self.n_recv]) for p in places]

    def __call__(self, comm: Comm, rows: torch.Tensor) -> torch.Tensor:
        """rows (n, ...) of this rank -> the (n_recv, ...) rows that
        arrive, packed by source rank."""
        got, _ = alltoallv(comm, rows[self.send], self.cnt, self.n_recv)
        return got


class ShardedBIEApply:
    """Sharded operator application of a set-up BoundaryIntegralOp over
    the ranks of `comm` (see the module docstring).

        sh = op.sharded_apply(comm)
        sig_loc = sh.pack(sigma)          # rank r's node rows
        U_loc = sh.apply(sig_loc)         # (own nodes, k1) on the device
        U = sh.unpack(U_loc)              # the global (N, k1), numpy

    `op.setup(comm=comm)` runs first (the distributed near search)."""

    def __init__(self, op, comm: Comm):
        if op.Xt is not None:
            raise ValueError("ShardedBIEApply: the targets are the surface "
                             "nodes (set_target_coord(None))")
        op.setup(comm=comm)
        self.op, self.comm = op, comm
        ndev, r = comm.size(), comm.rank()
        self.ndev, self.rank = ndev, r
        ker = op.kernel
        self.k0, self.k1 = k0, k1 = ker.kdim0, ker.kdim1
        dev, dt = op.device, op.dtype
        self.device, self.dtype = dev, dt
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        # ---- element-aligned partition, balanced by node count ----
        E = len(op._elem_of)
        nd, fd = op.node_dsp, op.far_dsp
        total = int(nd[-1])
        eb = np.searchsorted(nd, np.arange(ndev) * (total / ndev))
        eb = np.maximum.accumulate(np.minimum(eb, E))
        eb = np.concatenate([eb, [E]])
        self.e_bounds = eb
        self.n_lo, self.n_hi = nd[eb[:-1]], nd[eb[1:]]
        f_lo, f_hi = fd[eb[:-1]], fd[eb[1:]]
        owner_node = np.repeat(np.arange(ndev), self.n_hi - self.n_lo)
        self.n_own = int(self.n_hi[r] - self.n_lo[r])

        # ---- the block's interpolation tables (the op's device rows) ----
        dv = op._dev
        es = slice(int(eb[r]), int(eb[r + 1]))
        max_nf = dv["interp"].shape[1]
        self.interp = dv["interp"][es].contiguous()
        self.nidx = (dv["nidx"][es] - int(self.n_lo[r])).clamp(min=0)
        fval = dv["fval"][es]
        self.fval = fval.contiguous()
        self.fidx = ((dv["fidx"].reshape(E, max_nf)[es] - int(f_lo[r]))
                     * (fval > 0)).reshape(-1)
        self.wf = dv["wf"][int(f_lo[r]):int(f_hi[r])].contiguous()
        self.nf_own = int(f_hi[r] - f_lo[r])

        # ---- far field ----
        self._fmm = None
        if op._far_fmm is not None:
            from ..fmm.adaptive_dist import AdaptiveFMMDist
            src = op._far_fmm
            self._fmm = AdaptiveFMMDist(
                ker, comm, p=src.p, max_pts=src.max_pts,
                ker_l2t=src.ker_l2t, ker_s2m=src.ker_s2m, device=dev,
                dtype=dt, operators=src._ops).setup(op.Xf, op.Xt_eff,
                                                    n_src=op.Xnf)
            self._build_fmm_routing(owner_node, f_lo)
        else:
            # replicated targets (few, by the cutoff), the block's far
            # nodes
            self.Xt_rep = t(op.Xt_eff)
            self.Xf_own = t(op.Xf[f_lo[r]:f_hi[r]])
            self.Xnf_own = t(op.Xnf[f_lo[r]:f_hi[r]])

        # ---- near corrections: the products on the element owner, the
        # results routed to the target owners ----
        self.n_near = 0
        P = len(op.near_pairs)
        if P:
            pairs = np.asarray(op.near_pairs, np.int64).reshape(-1, 2)
            pt, pe = pairs[:, 0], pairs[:, 1]
            owner_e = np.repeat(np.arange(ndev), np.diff(eb))
            a_arr = owner_e[pe]
            piloc, _ = _rank_within(a_arr)
            mine = torch.as_tensor(np.nonzero(a_arr == r)[0], device=dev)
            self.near_mats = dv["near_mats"][mine].contiguous()
            self.near_sidx = (dv["near_sidx"][mine]
                              - int(self.n_lo[r]) * k0).clamp(min=0)
            self.n_near = len(mine)
            d_arr = owner_node[pt]
            send, cnt, places, _, _, _ = ragged_route_tables(
                a_arr, piloc, d_arr, [pt - self.n_lo[d_arr]], ndev)
            self._near_route = _Route(send, cnt, places, r, dev)

    def _build_fmm_routing(self, owner_node, f_lo):
        """The two static exchanges of the FMM regime: element-block far
        densities -> the FMM's leaf-block slots, and leaf-block target
        potentials -> the node owners' rows."""
        op, ndev, r = self.op, self.ndev, self.rank
        fm = self._fmm
        af = fm._afmm
        Cb, cs, ct = fm.Cb, af.cap_s, af.cap_t
        nf = len(op.Xf)
        # far node i -> (leaf, slot) in the Morton sort
        inv_perm = np.empty(nf, np.int64)
        inv_perm[af.tree.perm] = np.arange(nf)
        leaf_dsp = np.append(af.tree.leaf_dsp, nf)
        leaf_of = np.searchsorted(leaf_dsp, inv_perm, side="right") - 1
        slot_of = inv_perm - leaf_dsp[leaf_of]
        owner_leaf = np.minimum(leaf_of // Cb, ndev - 1)
        f_hi = op.far_dsp[self.e_bounds[1:]]
        fown = np.repeat(np.arange(ndev), f_hi - f_lo)
        send, cnt, (rleaf, rslot), _, _, _ = ragged_route_tables(
            fown, np.arange(nf) - f_lo[fown], owner_leaf,
            [leaf_of - owner_leaf * Cb, slot_of], ndev)
        self._far_route = _Route(send, cnt, [rleaf * cs + rslot], r,
                                 self.device)
        # target j -> (leaf, slot) in the FMM's target layout
        nt = len(op.Xt_eff)
        inv_t = np.empty(nt, np.int64)
        inv_t[fm._t_perm] = np.arange(nt)
        tleaf = np.searchsorted(fm.t_dsp, inv_t, side="right") - 1
        tslot = inv_t - fm.t_dsp[tleaf]
        towner = np.minimum(tleaf // Cb, ndev - 1)
        send, cnt, places, _, _, _ = ragged_route_tables(
            towner, (tleaf - towner * Cb) * ct + tslot, owner_node,
            [np.arange(nt) - self.n_lo[owner_node]], ndev)
        self._back_route = _Route(send, cnt, places, r, self.device)

    # ---- host-side vector layout ---------------------------------------
    def pack(self, sigma) -> torch.Tensor:
        """Global (N * k0,) nodal density -> rank r's own node rows, flat,
        on the device in the op's dtype."""
        r = self.rank
        sig = torch.as_tensor(np.asarray(sigma, np.float64)).reshape(
            -1, self.k0)[int(self.n_lo[r]):int(self.n_hi[r])]
        return sig.reshape(-1).to(self.device, self.dtype)

    def unpack(self, U_loc: torch.Tensor) -> np.ndarray:
        """The ranks' (own nodes, k1) blocks -> the global (N, k1) array,
        numpy, on every rank."""
        g = allgatherv(self.comm, U_loc.reshape(self.n_own, -1))
        return g.cpu().numpy().astype(np.float64)

    # ---- the application --------------------------------------------------
    def _far_density(self, sig: torch.Tensor) -> torch.Tensor:
        """The block's (n_own, k0) node densities -> its far nodes'
        weighted densities (nf_own, k0)."""
        k0 = self.k0
        ff = torch.einsum("efn,enk->efk", self.interp, sig[self.nidx])
        Ff = sig.new_zeros((self.nf_own, k0))
        Ff.index_add_(0, self.fidx,
                      (ff * self.fval[..., None]).reshape(-1, k0))
        return Ff * self.wf[:, None]

    def _to_leaves(self, Ff: torch.Tensor) -> torch.Tensor:
        """The far route: the block's far densities -> the FMM leaf
        block's slots (Cb, cap_s, k0) (collective)."""
        fm, k0 = self._fmm, self.k0
        fp = Ff.new_zeros((fm.Cb * fm._afmm.cap_s, k0))
        fp[self._far_route.places[0]] = self._far_route(self.comm, Ff)
        return fp.reshape(fm.Cb, -1, k0)

    def leaf_density(self, sig_loc: torch.Tensor) -> torch.Tensor:
        """FMM regime: rank r's density rows -> the far densities in the
        FMM's own leaf slots, as an application computes them
        (collective)."""
        sig = sig_loc.to(self.device, self.dtype).reshape(-1, self.k0)
        return self._to_leaves(self._far_density(sig))

    def apply(self, sig_loc: torch.Tensor,
              marks: Optional[list] = None) -> torch.Tensor:
        """Rank r's density rows (n_own * k0,) -> its potential rows
        (n_own, k1), on the device (the counterpart of `apply_fn`).
        With `marks` a list, CUDA events after each stage: interp, far
        route, the FMM's stages (`AdaptiveFMMDist._eval_dist`), back
        route (the direct regime: far), near, near route."""
        comm, k0, k1 = self.comm, self.k0, self.k1
        sig = sig_loc.to(self.device, self.dtype).reshape(-1, k0)
        Ff = self._far_density(sig)
        _mark(marks, "interp")
        if self._fmm is not None:
            fp = self._to_leaves(Ff)
            _mark(marks, "far route")
            u_leaf = self._fmm._eval_dist(fp, marks)
            U = Ff.new_zeros((self.n_own, k1))
            U.index_add_(0, self._back_route.places[0],
                         self._back_route(comm, u_leaf.reshape(-1, k1)))
            _mark(marks, "back route")
        else:
            U_all = direct_eval_blocked(self.op.kernel, self.Xt_rep,
                                        self.Xf_own, Ff, ns=self.Xnf_own)
            U_all = comm.allreduce(U_all)
            r = self.rank
            U = U_all[int(self.n_lo[r]):int(self.n_hi[r])].contiguous()
            _mark(marks, "far")
        if self.op.near_pairs:
            sig_p = sig.reshape(-1)[self.near_sidx]            # (Pc, R)
            corr = torch.einsum("pr,prk->pk", sig_p, self.near_mats)
            _mark(marks, "near")
            U.index_add_(0, self._near_route.places[0],
                         self._near_route(comm, corr))
            _mark(marks, "near route")
        return U


def build_near_list(comm: Comm, Ct: int, Xt, tcnt: int, tgid, Xf, df, fe,
                    fcnt: int, cap_route_t: int, cap_route_f: int,
                    cap_join: int, cap_out: int):
    """The distributed near-pair search on this rank's blocks
    (sctl_tpu/bie/dist.py:401-557; reference: BuildNearList,
    boundary_integral.txx:46-183).

    Xt (Ct, 3) targets (the first tcnt valid), tgid (Ct,) their global
    ids; Xf (Cf, 3) far nodes (the first fcnt valid), df (Cf,) their
    dist_far, fe (Cf,) their elements; float64 and int64 tensors on one
    device.  Returns (pair_t, pair_e, need): the unique (target,
    element) pairs whose target's block (tgid // Ct) is this rank's,
    sorted, and need (4,) int64: the receive and join sizes the buffers
    needed (route_t, route_f, join, out), untruncated, so that the
    caller grows the capacities it passed when one is short."""
    ndev = comm.size()
    dev = Xt.device
    i64 = torch.int64
    tval = (torch.arange(Xt.shape[0], device=dev) < tcnt)[:, None]
    fval = torch.arange(Xf.shape[0], device=dev) < fcnt
    big = torch.tensor(1e300, dtype=Xt.dtype, device=dev)
    lo = comm.allreduce(torch.minimum(
        torch.where(tval, Xt, big).amin(0),
        torch.where(fval[:, None], Xf, big).amin(0)), "min")
    hi = comm.allreduce(torch.maximum(
        torch.where(tval, Xt, -big).amax(0),
        torch.where(fval[:, None], Xf, -big).amax(0)), "max")
    maxdf = float(comm.allreduce(
        torch.where(fval, df, torch.zeros_like(df)).amax().reshape(1),
        "max")[0])
    extent = float((hi - lo).max()) + 1e-12
    nside = int(min(max(int(extent / max(maxdf, extent / 1024)), 1), 1024))
    side = extent / nside * (1 + 1e-12)

    def cell(X):
        return torch.clamp(((X - lo) / side).to(i64), 0, nside - 1)

    def ckey(c):
        return (c[:, 0] * nside + c[:, 1]) * nside + c[:, 2]

    ncell = nside ** 3

    def owner_of(k):
        return torch.clamp((k * ndev) // ncell, 0, ndev - 1)

    # 1. the targets to their cell-range owner (the PartitionS role)
    kt = ckey(cell(Xt))
    (kt_r, tg_r, Xt_r), tcnt_r = route(comm, (kt, tgid, Xt), tcnt,
                                       owner_of(kt), cap_route_t)
    kt_s, (tg_s, Xt_s) = _local_sort_by_key(kt_r, tcnt_r, (tg_r, Xt_r))

    # 2. the far nodes onto their 27 neighbour cells, one route
    offs = torch.as_tensor(np.stack(np.meshgrid(
        *([[-1, 0, 1]] * 3), indexing="ij"), -1).reshape(-1, 3),
        device=dev)
    nc = cell(Xf)[None, :, :] + offs[:, None, :]             # (27, Cf, 3)
    vv = (((nc >= 0) & (nc < nside)).all(-1) & fval[None]).reshape(-1)
    nk = ckey(torch.clamp(nc, 0, nside - 1).reshape(-1, 3))
    order = torch.argsort((~vv).to(torch.int8), stable=True)  # valid first
    n_ok = int(vv.sum())
    rep = lambda a: a.repeat((27,) + (1,) * (a.dim() - 1))[order]
    (nk_r, Xf_r, df_r, fe_r), fcnt_r = route(
        comm, (nk[order], rep(Xf), rep(df), rep(fe)), n_ok,
        owner_of(nk[order]), cap_route_f)

    # 3. the sorted-range join: the targets in each far copy's cell
    lo_i = torch.searchsorted(kt_s, nk_r)
    hi_i = torch.searchsorted(kt_s, nk_r + 1)
    okf = torch.arange(cap_route_f, device=dev) < fcnt_r
    cnt = torch.where(okf, hi_i - lo_i, torch.zeros_like(lo_i))
    dsp = torch.cumsum(cnt, 0) - cnt
    total = int(cnt.sum())
    j = torch.arange(min(total, cap_join), device=dev)
    fi = torch.clamp(torch.searchsorted(dsp, j, right=True) - 1, 0,
                     cap_route_f - 1)
    pos = j - dsp[fi]
    ti = torch.clamp(lo_i[fi] + pos, 0, cap_route_t - 1)
    d2 = ((Xt_s[ti] - Xf_r[fi]) ** 2).sum(1)
    keep = (pos < cnt[fi]) & (d2 < df_r[fi] ** 2)

    # 4. local dedupe before routing: every pair of a target is made on
    # the owner of the target's cell
    E_big = 1 << 31
    pk = torch.unique(tg_s[ti][keep] * E_big + fe_r[fi][keep])
    n_loc = len(pk)
    pk = pk[:cap_out]
    ptc, pec = pk // E_big, pk % E_big
    (pt_r, pe_r), pcnt = route(comm, (ptc, pec), len(pk),
                               torch.clamp(ptc // Ct, 0, ndev - 1), cap_out)

    # 5. the final sort and (cross-rank safety) dedupe
    m = min(int(pcnt), cap_out)
    pk2 = torch.unique(pt_r[:m] * E_big + pe_r[:m])
    need = torch.tensor([int(tcnt_r), int(fcnt_r), total,
                         max(n_loc, int(pcnt))], dtype=i64)
    return pk2 // E_big, pk2 % E_big, need
