"""Boundary integral operator u = int K(x, y) sigma(y) dS(y)
(counterpart of sctl_tpu/bie/boundary_integral.py:51-719).

  ElementListBase     the geometry protocol an element list implements.
  BoundaryIntegralOp  setup: concatenate the element lists, collect the
                      far-field quadrature, set up the far field (the
                      adaptive FMM above `far_fmm_cutoff` far nodes, a
                      direct sum below), find the near (target,
                      element) pairs on the host and assemble their
                      corrected operators K_near - K_far: on the device
                      (near_device.py) for one element list with a
                      `device_geom`, on the host in float64 otherwise
                      (`use_device_near` forces either), or read them
                      from `near_cache`; apply: far-field density
                      interpolation, the far field, the near corrections
                      as one batched product and scatter.

Device tensors in and out: `compute_potential_tensor` is the
counterpart of `compute_potential_jnp`.

Over the ranks of a `comm.Comm` (`comm=` at construction or in
`setup`): the near pairs come from the distributed search
(`dist.build_near_list`, its capacities grown as the JAX package grows
them), each rank assembles the near operators of its block of the pairs
and the blocks are all-gathered, so that every rank holds the
single-process op's pairs, operators and `compute_potential`;
`sharded_apply(comm)` is the sharded application (`dist.ShardedBIEApply`:
element-aligned blocks, the far field through `AdaptiveFMMDist` or each
rank's direct sum, the near corrections on the element owner).
"""

from __future__ import annotations

import abc
from typing import List, Optional

import numpy as np
import torch

from .. import profile
from ..comm.verbs import allgatherv
from ..config import resolve_device
from ..ops.direct import direct_eval_blocked
from ..ops.kernels import KernelSpec


def host_kernel_matrix(kernel: KernelSpec, xt, xs, ns=None) -> np.ndarray:
    """(Ns*k0, Nt*k1) kernel matrix on the host in float64 numpy: the
    setup-time quadrature makes thousands of small kernel evaluations."""
    from ..ops.kernels_np import full_matrix_np
    return full_matrix_np(kernel, np.asarray(xt), np.asarray(xs),
                          None if ns is None else np.asarray(ns))


class ElementListBase(abc.ABC):
    """Geometry protocol (sctl_tpu ElementListBase)."""

    @abc.abstractmethod
    def size(self) -> int:
        """Number of elements."""

    @abc.abstractmethod
    def get_node_coord(self):
        """-> (X (N, 3), Xn (N, 3), node_cnt (n_elem,))."""

    @abc.abstractmethod
    def get_far_field_nodes(self, tol: float):
        """-> (X (M, 3), Xn (M, 3), wts (M,), dist_far (M,),
        cnt (n_elem,)): upsampled smooth quadrature; a target closer
        than dist_far to a node needs a near correction."""

    @abc.abstractmethod
    def get_far_field_density(self, F):
        """Density at the nodes (N, k) -> at the far nodes (M, k),
        weights not applied."""

    @abc.abstractmethod
    def far_field_density_matrix(self, elem: int) -> np.ndarray:
        """(n_nodes_e, n_far_e) interpolation matrix of one element."""

    def node_weights(self) -> np.ndarray:
        """(N,) surface quadrature weight of each node: the far weights
        lumped through the interpolation transpose."""
        _, _, wf, _, fcnt = self.get_far_field_nodes(1e-8)
        fdsp = np.concatenate([[0], np.cumsum(fcnt)])
        return np.concatenate([
            self.far_field_density_matrix(e) @ wf[fdsp[e]:fdsp[e + 1]]
            for e in range(self.size())])

    @abc.abstractmethod
    def near_interac(self, kernel: KernelSpec, xt: np.ndarray, elem: int,
                     tol: float) -> np.ndarray:
        """(n_nodes_e*k0, k1) accurate operator: density at element
        `elem`'s nodes -> potential at the one near target xt."""

    def self_interac(self, kernel: KernelSpec, tol: float):
        """Per-element singular operators (n_nodes_e*k0, n_nodes_e*k1):
        near_interac at each of the element's own nodes."""
        X, _, cnt = self.get_node_coord()
        dsp = np.concatenate([[0], np.cumsum(cnt)])
        out = []
        for e in range(self.size()):
            xe = X[dsp[e]:dsp[e + 1]]
            out.append(np.concatenate(
                [self.near_interac(kernel, x, e, tol) for x in xe], axis=1))
        return out


class BoundaryIntegralOp:
    """op = BoundaryIntegralOp(Stokes3D_DxU, device="cuda")
    op.set_accuracy(1e-6)
    op.add_elem_list(elem_lst)
    op.set_target_coord(Xt)            # optional; default the nodes
    U = op.compute_potential(sigma)    # numpy in and out
    U = op.compute_potential_tensor(sigma)   # device tensors

    device: "cuda" (default) or "cpu"; dtype: torch.float32 or
    torch.float64 on either (the far field's U list and the direct sum
    have float64 builds on the card).  `trg_normal_dot_prod` is
    accepted and not read, as in the JAX package.  Settable before
    setup: `far_fmm_cutoff` (far nodes from which the adaptive FMM
    takes the far field), `far_fmm_p` (its order), `far_fmm_operators`
    (its KIFMMOperators, built cold when None), `use_device_near` (None:
    the device near engine for one element list with a `device_geom`,
    the host path otherwise; True or False forces one; the rule does
    not read the device) and `near_cache` (an .npz path: the near pairs
    and the corrected near operators, in the JAX package's layout, read
    when its key matches the geometry and written after a host-path
    assembly).  comm: a `comm.Comm` whose ranks share the setup (see
    `setup`).
    """

    def __init__(self, kernel: KernelSpec, trg_normal_dot_prod=False,
                 comm=None, device=None,
                 dtype: torch.dtype = torch.float32):
        from ..fmm.fmm import DIRECT_CUTOFF
        self.kernel = kernel
        self.comm = comm
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(f"BoundaryIntegralOp dtype {dtype}")
        self.dtype = dtype
        self.tol = 1e-8
        self.elem_lists: List[ElementListBase] = []
        self.Xt: Optional[np.ndarray] = None
        self._setup_done = False
        self.far_fmm_cutoff = DIRECT_CUTOFF
        self.far_fmm_p = 6
        self.far_fmm_operators = None
        self.near_cache: Optional[str] = None
        self.use_device_near: Optional[bool] = None
        self._near_mats = None          # host list of (R_i, k1) arrays
        self._near_mats_dev = None      # (P, R, k1) tensor on the device
        self._near_fallback_count = None
        self._node_w_cache = None

    def set_accuracy(self, tol: float):
        self.tol = tol
        self._setup_done = False

    def add_elem_list(self, elem_lst: ElementListBase):
        self.elem_lists.append(elem_lst)
        self._setup_done = False

    def set_target_coord(self, Xt):
        self.Xt = None if Xt is None else np.asarray(Xt, np.float64)
        self._setup_done = False

    def dim(self, i: int) -> int:
        """0: input (density) size, 1: output size."""
        n_nodes = sum(lst.get_node_coord()[0].shape[0]
                      for lst in self.elem_lists)
        if i == 0:
            return n_nodes * self.kernel.kdim0
        nt = self.Xt.shape[0] if self.Xt is not None else n_nodes
        return nt * self.kernel.kdim1

    def _node_w(self):
        if self._node_w_cache is None:
            self._node_w_cache = np.concatenate(
                [lst.node_weights() for lst in self.elem_lists])
        return self._node_w_cache

    def sqrt_scaling(self, v):
        """Nodal vector times sqrt(w), w the node quadrature weights."""
        w = np.sqrt(np.abs(self._node_w()))
        return np.asarray(v).reshape(len(w), -1) * w[:, None]

    def inv_sqrt_scaling(self, v):
        """Nodal vector divided by sqrt(w), the inverse of
        `sqrt_scaling`."""
        w = np.sqrt(np.abs(self._node_w()))
        return np.asarray(v).reshape(len(w), -1) / w[:, None]

    # -- setup ------------------------------------------------------------
    def setup(self, comm=None):
        """Far field, near pairs, near operators (or `near_cache`) and
        the apply tables.  Host seconds of each stage (the device fenced
        after each) go to `setup_times`.

        comm (default the constructor's): with two or more ranks the
        near pairs come from the distributed search
        (`_build_near_list_dist`), each rank assembles the operators of
        its block of the pairs, and the blocks are all-gathered; the
        self-communicator, or none, takes the host search."""
        if self._setup_done:
            return self
        comm = comm if comm is not None else self.comm
        dist = comm is not None and not comm.is_self and comm.size() > 1
        import time
        from ..fmm.adaptive import AdaptiveFMM
        from ..fmm.fmm import _TREE_L2T
        times = {}
        t0 = [time.perf_counter()]

        def tick(name):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            times[name] = t - t0[0]
            t0[0] = t

        Xs, Ns, cnts, far = [], [], [], []
        self._elem_of = []
        for li, lst in enumerate(self.elem_lists):
            X, Xn, cnt = lst.get_node_coord()
            Xs.append(X)
            Ns.append(Xn)
            cnts.append(cnt)
            far.append(lst.get_far_field_nodes(self.tol))
            self._elem_of += [(li, e) for e in range(lst.size())]
        self.X = np.concatenate(Xs)
        self.Xn = np.concatenate(Ns)
        self.node_cnt = np.concatenate(cnts)
        self.node_dsp = np.concatenate([[0], np.cumsum(self.node_cnt)])
        self.Xf = np.concatenate([f[0] for f in far])
        self.Xnf = np.concatenate([f[1] for f in far])
        self.wf = np.concatenate([f[2] for f in far])
        self.df = np.concatenate([f[3] for f in far])
        self.far_cnt = np.concatenate([f[4] for f in far])
        self.far_dsp = np.concatenate([[0], np.cumsum(self.far_cnt)])
        self.Xt_eff = self.X if self.Xt is None else self.Xt
        tick("geometry")

        # far field: the adaptive FMM above the cutoff (the far nodes lie
        # on the surface, the distribution the adaptive tree is for)
        self._far_fmm = None
        if (len(self.Xf) >= self.far_fmm_cutoff
                and self.kernel.name in _TREE_L2T):
            fmm = AdaptiveFMM(self.kernel, p=self.far_fmm_p,
                              ker_l2t=_TREE_L2T[self.kernel.name],
                              device=self.device, dtype=self.dtype,
                              operators=self.far_fmm_operators)
            if fmm._ops is None:
                fmm._ops = fmm.build_operators()
            tick("operators")
            self._far_fmm = fmm.setup(self.Xf, self.Xt_eff, n_src=self.Xnf)
            tick("far_fmm_tree")
        self._near_mats = self._near_mats_dev = None
        if self.near_cache is not None and self._load_near_cache(
                self.near_cache):
            tick("near_cache")
        elif dist:
            self._build_near_list_dist(comm)
            tick("near_list")
            self._build_near_matrices_dist(comm)
            tick("near_assembly")
            if (self.near_cache is not None and self._near_mats is not None
                    and comm.rank() == 0):
                self._save_near_cache(self.near_cache)
        else:
            self._build_near_list()
            tick("near_list")
            self._build_near_matrices()
            tick("near_assembly")
            if self.near_cache is not None and self._near_mats is not None:
                self._save_near_cache(self.near_cache)
        self._setup_device_apply()
        tick("apply_tables")
        self.setup_times = times
        self._setup_done = True
        return self

    # -- near cache (sctl_tpu boundary_integral.py:360-419) ---------------
    def _near_mats_list(self):
        """Near matrices as a host list; from the device engine's
        (P, R, k1) tensor by one download."""
        if self._near_mats is None and self._near_mats_dev is not None:
            k1 = self.kernel.kdim1
            blob = self._near_mats_dev.double().cpu().numpy()
            self._near_mats = [b.reshape(-1, k1) for b in blob]
        return [] if self._near_mats is None else self._near_mats

    def _near_key(self) -> str:
        """Geometry and settings fingerprint of the near cache, as the
        JAX package computes it."""
        import hashlib
        h = hashlib.md5()
        for a in (self.X, self.Xt_eff, self.Xf, self.wf, self.df):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(f"{self.kernel.name}:{self.tol:.6g}:v1".encode())
        return h.hexdigest()

    def _save_near_cache(self, path):
        """The host path's pairs and float64 operators as an .npz of
        key, pairs, rows and blob.  The device engine's results are not
        written: the key names neither the engine nor the type."""
        import os
        k1 = self.kernel.kdim1
        mats = self._near_mats
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, key=np.asarray(self._near_key()),
                     pairs=np.asarray(self.near_pairs,
                                      np.int64).reshape(-1, 2),
                     rows=np.asarray([m.shape[0] for m in mats], np.int64),
                     blob=(np.concatenate([m.reshape(-1, k1) for m in mats])
                           if mats else np.zeros((0, k1))))
        except OSError:
            pass

    def _load_near_cache(self, path) -> bool:
        """Pairs and operators from `path` if its key matches."""
        import os
        if not os.path.exists(path):
            return False
        try:
            z = np.load(path)
            if str(z["key"]) != self._near_key():
                return False
            dsp = np.concatenate([[0], np.cumsum(z["rows"])])
            blob = z["blob"]
            self.near_pairs = [(int(a), int(b)) for a, b in z["pairs"]]
            self._near_mats = [blob[dsp[i]:dsp[i + 1]]
                               for i in range(len(dsp) - 1)]
            return True
        except Exception:
            return False

    def _build_near_list(self):
        """Near pairs (target, element): targets closer than dist_far to
        a far node of the element (sctl_tpu boundary_integral.py:421).
        Candidates come from a target grid queried per element bounding
        sphere; the exact per-far-node filter runs on the survivors."""
        Xt, Xf, df = self.Xt_eff, self.Xf, self.df
        E = len(self.far_cnt)
        self.near_pairs = []
        if E == 0 or len(Xt) == 0:
            return
        s, t = self.far_dsp[:-1], self.far_dsp[1:]
        ctr = np.add.reduceat(Xf, s) / self.far_cnt[:, None]
        seg = np.repeat(np.arange(E), self.far_cnt)
        rad2 = np.zeros(E)
        np.maximum.at(rad2, seg, ((Xf - ctr[seg]) ** 2).sum(1))
        df_max = np.zeros(E)
        np.maximum.at(df_max, seg, df)
        reach = np.sqrt(rad2) + df_max

        lo = Xt.min(0) - 1e-12
        side = max(float(reach.max()), 1e-300)
        cellt = ((Xt - lo) / side).astype(np.int64)
        nside = int(cellt.max()) + 1
        key_t = (cellt[:, 0] * nside + cellt[:, 1]) * nside + cellt[:, 2]
        order_t = np.argsort(key_t, kind="stable")
        key_ts = key_t[order_t]
        ce = ((ctr - lo) / side).astype(np.int64)
        offs = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                    indexing="ij"), -1).reshape(-1, 3)
        nc = ce[:, None, :] + offs[None, :, :]
        nk = ((nc[..., 0] * nside + nc[..., 1]) * nside
              + nc[..., 2]).reshape(-1)
        ok = np.all((nc >= 0) & (nc <= cellt.max(0)), axis=2).reshape(-1)
        lo_i = np.where(ok, np.searchsorted(key_ts, nk), 0)
        hi_i = np.where(ok, np.searchsorted(key_ts, nk + 1), 0)
        cnt = hi_i - lo_i
        tot = int(cnt.sum())
        if tot == 0:
            return
        ei = np.repeat(np.arange(E * 27) // 27, cnt)
        pos = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ti = order_t[np.repeat(lo_i, cnt) + pos]
        keep = ((Xt[ti] - ctr[ei]) ** 2).sum(1) < reach[ei] ** 2
        ti, ei = ti[keep], ei[keep]
        out_t, out_e = [], []
        nf_max = int(self.far_cnt.max())
        for c0 in range(0, len(ti), 40_000):
            tc, ec = ti[c0:c0 + 40_000], ei[c0:c0 + 40_000]
            idx = s[ec][:, None] + np.arange(nf_max)[None, :]
            valid = idx < t[ec][:, None]
            idx = np.minimum(idx, len(Xf) - 1)
            d2 = ((Xt[tc][:, None, :] - Xf[idx]) ** 2).sum(-1)
            near = ((d2 < df[idx] ** 2) & valid).any(1)
            out_t.append(tc[near])
            out_e.append(ec[near])
        te = np.unique(np.stack([np.concatenate(out_t),
                                 np.concatenate(out_e)], 1), axis=0)
        self.near_pairs = [(int(a), int(b)) for a, b in te]

    def _build_near_list_dist(self, comm, _cap_scale: float = 1.0):
        """The near pairs by the distributed search over comm's ranks
        (sctl_tpu/bie/boundary_integral.py:277-358): rank r's blocks of
        the targets and far nodes go to `dist.build_near_list`, on the
        op's device; a capacity that a rank's `need` exceeds grows to
        max(2 cap, need + need / 8), at most 8 rounds
        (`_near_caps_grown` counts them); the ranks' pairs, grouped by
        target block and sorted, are all-gathered.  _cap_scale: the
        initial capacities' factor (below 1 exercises the growth)."""
        from .dist import build_near_list
        ndev, r = comm.size(), comm.rank()
        dev = self.device
        nt, nf = len(self.Xt_eff), len(self.Xf)
        Ct, Cf = max(1, -(-nt // ndev)), max(1, -(-nf // ndev))
        elem_of_f = np.repeat(np.arange(len(self.far_cnt)), self.far_cnt)

        def block(a, C, dt):
            lo, hi = min(len(a), r * C), min(len(a), (r + 1) * C)
            out = torch.zeros((C,) + a.shape[1:], dtype=dt, device=dev)
            out[:hi - lo] = torch.as_tensor(a[lo:hi], dtype=dt, device=dev)
            return out, hi - lo

        f64, i64 = torch.float64, torch.int64
        Xt, tcnt = block(self.Xt_eff, Ct, f64)
        tg, _ = block(np.arange(nt), Ct, i64)
        Xf, fcnt = block(self.Xf, Cf, f64)
        df, _ = block(self.df, Cf, f64)
        fe, _ = block(elem_of_f, Cf, i64)
        # the JAX package's initial capacities (about 40 near elements a
        # target; the bench torus has about 9)
        caps = {"cap_route_t": ndev * Ct,
                "cap_route_f": -(-27 * nf // ndev) + Cf,
                "cap_join": 128 * ndev * Cf,
                "cap_out": 64 * max(Ct, 64)}
        if _cap_scale != 1.0:
            caps = {k: max(8, int(v * _cap_scale)) for k, v in caps.items()}
        self._near_caps_grown = 0
        for _ in range(8):
            pt, pe, need = build_near_list(comm, Ct, Xt, tcnt, tg, Xf, df,
                                           fe, fcnt, **caps)
            need = comm.allreduce(need.to(dev), "max").cpu().numpy()
            grown = False
            for i, k in enumerate(("cap_route_t", "cap_route_f",
                                   "cap_join", "cap_out")):
                if int(need[i]) > caps[k]:
                    caps[k] = max(2 * caps[k],
                                  int(need[i]) + (int(need[i]) >> 3))
                    grown = True
            self._near_caps_grown += int(grown)
            if not grown:
                break
        else:
            raise RuntimeError(
                "distributed near search did not converge on capacities "
                f"after 8 doublings: need={need.tolist()} caps={caps}")
        te = allgatherv(comm, torch.stack([pt, pe], 1)).cpu().numpy()
        self.near_pairs = [(int(a), int(b)) for a, b in te]

    def _build_near_matrices_dist(self, comm):
        """The near operators of rank r's block of the pairs (contiguous,
        ceil(P / ranks) a rank), by the engine `_build_near_matrices`
        picks, all-gathered into the single-process op's order."""
        ndev, r = comm.size(), comm.rank()
        pairs = self.near_pairs
        P = len(pairs)
        Cp = max(1, -(-P // ndev))
        self.near_pairs = pairs[min(P, r * Cp):min(P, (r + 1) * Cp)]
        self._build_near_matrices()
        self.near_pairs = pairs
        n_fb = comm.allreduce(torch.tensor(
            [int(self._near_fallback_count)], device=self.device))
        self._near_fallback_count = int(n_fb[0])
        if self._near_mats_dev is not None:
            self._near_mats_dev = allgatherv(comm, self._near_mats_dev, Cp)
            return
        # host path: ragged (n_e k0, k1) float64 blocks, padded to the
        # widest for the gather
        k1 = self.kernel.kdim1
        rows = np.array([self.node_cnt[e] * self.kernel.kdim0
                         for _, e in pairs], np.int64)
        R = int(rows.max()) if P else 1
        blob = np.zeros((len(self._near_mats), R, k1))
        for i, m in enumerate(self._near_mats):
            blob[i, :m.shape[0]] = m.reshape(-1, k1)
        g = allgatherv(comm, torch.as_tensor(blob, device=self.device),
                       Cp).cpu().numpy()
        self._near_mats = [g[i, :rows[i]] for i in range(P)]

    def _device_near_ok(self) -> bool:
        """The near engine: `use_device_near` if set, else the device
        engine for one element list with a `device_geom`."""
        if self.use_device_near is not None:
            return bool(self.use_device_near)
        return (len(self.elem_lists) == 1
                and getattr(self.elem_lists[0], "device_geom", None)
                is not None)

    def _build_near_matrices(self):
        """K_near(t, e) = NearInterac(t, e) - far-quadrature block(t, e)
        (sctl_tpu boundary_integral.py:513-577): the device engine's
        (P, R, k1) tensor, or on the host in float64 a list of
        (n_e k0, k1) arrays: `near_interac_batch` for an element list
        that has it, `near_interac` pair by pair otherwise, minus the
        far-quadrature block, one kernel call and product an element.
        Stage seconds go to `_near_prof`; the pairs that took the
        per-pair rule to `_near_fallback_count`."""
        import time
        from ..ops.kernels_np import block_matrix_np
        if self._device_near_ok():
            from .near_device import assemble_near_device
            self._near_mats_dev, self._near_fallback_count = \
                assemble_near_device(self)
            return
        ker = self.kernel
        t0 = time.perf_counter()
        pair_t = np.array([t for (t, _) in self.near_pairs], np.int64)
        pair_e = np.array([e for (_, e) in self.near_pairs], np.int64)
        mats = [None] * len(pair_t)
        by_list, nfb = {}, 0
        for pi, e in enumerate(pair_e):
            by_list.setdefault(self._elem_of[e][0], []).append(pi)
        for li, pis in by_list.items():
            lst = self.elem_lists[li]
            pis = np.asarray(pis)
            les = np.array([self._elem_of[e][1] for e in pair_e[pis]])
            if hasattr(lst, "near_interac_batch"):
                exact = lst.near_interac_batch(ker, self.Xt_eff[pair_t[pis]],
                                               les, self.tol)
                nfb += getattr(lst, "last_fallback_count", 0)
            else:
                exact = [lst.near_interac(ker, self.Xt_eff[t], le, self.tol)
                         for t, le in zip(pair_t[pis], les)]
            for j, pi in enumerate(pis):
                mats[pi] = np.array(exact[j], np.float64)
        t1 = time.perf_counter()
        for e in np.unique(pair_e):
            pis = np.where(pair_e == e)[0]
            li, le = self._elem_of[e]
            s, t = self.far_dsp[e], self.far_dsp[e + 1]
            kf = (block_matrix_np(ker, self.Xt_eff[pair_t[pis]],
                                  self.Xf[s:t], self.Xnf[s:t])
                  * self.wf[None, s:t, None, None])     # (T, nf, k0, k1)
            far = np.tensordot(kf, self.elem_lists[li]
                               .far_field_density_matrix(le),
                               axes=([1], [1])).transpose(0, 3, 1, 2)
            for j, pi in enumerate(pis):
                mats[pi] -= far[j].reshape(mats[pi].shape)
        self._near_mats = mats
        self._near_fallback_count = nfb
        self._near_prof = {"exact": t1 - t0,
                           "far": time.perf_counter() - t1,
                           "fallback_n": nfb}

    def _setup_device_apply(self):
        """Padded device tables of the apply: per-element far-field
        interpolation as one batched product, the near corrections as
        one (P, R, k1) product and scatter (host lists of different
        node counts padded to the widest R with zero rows)."""
        ker = self.kernel
        E = len(self._elem_of)
        k0, k1 = ker.kdim0, ker.kdim1
        max_ne = int(self.node_cnt.max())
        max_nf = int(self.far_cnt.max())
        interp = np.zeros((E, max_nf, max_ne))
        nidx = np.zeros((E, max_ne), np.int64)
        fidx = np.zeros((E, max_nf), np.int64)
        fval = np.zeros((E, max_nf), bool)
        for e, (li, le) in enumerate(self._elem_of):
            ne, nf = self.node_cnt[e], self.far_cnt[e]
            interp[e, :nf, :ne] = \
                self.elem_lists[li].far_field_density_matrix(le).T
            nidx[e, :ne] = np.arange(self.node_dsp[e],
                                     self.node_dsp[e] + ne)
            fidx[e, :nf] = np.arange(self.far_dsp[e], self.far_dsp[e] + nf)
            fval[e, :nf] = True
        dev, dt = self.device, self.dtype
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        ti = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self._dev = {
            "interp": t(interp), "nidx": ti(nidx),
            "fidx": ti(np.where(fval, fidx, 0).reshape(-1)),
            "fval": t(fval), "wf": t(self.wf), "Xt": t(self.Xt_eff),
            "Xf": t(self.Xf), "Xnf": t(self.Xnf),
        }
        self._n_near = P = len(self.near_pairs)
        if not P:
            return
        pe = np.array([e for (_, e) in self.near_pairs])
        if self._near_mats_dev is not None:
            R = self._near_mats_dev.shape[1]
            mats = self._near_mats_dev
            sidx = (self.node_dsp[pe] * k0)[:, None] + np.arange(R)
        else:
            rows = np.array([m.shape[0] for m in self._near_mats])
            R = int(rows.max())
            blob = np.zeros((P, R, k1))
            sidx = np.zeros((P, R), np.int64)
            for pi, (m, e) in enumerate(zip(self._near_mats, pe)):
                blob[pi, :rows[pi]] = m.reshape(rows[pi], k1)
                sidx[pi, :rows[pi]] = self.node_dsp[e] * k0 + np.arange(
                    rows[pi])
            mats = t(blob)
        self._dev.update({
            "near_mats": mats, "near_sidx": ti(sidx),
            "near_ti": ti([t_ for (t_, _) in self.near_pairs]),
        })

    # -- evaluation ---------------------------------------------------------
    def compute_potential_tensor(self, sigma: torch.Tensor,
                                 marks: Optional[list] = None):
        """sigma (N*k0,) or (N, k0) tensor -> (Nt, k1) tensor on the op's
        device: far field plus near corrections.  With `marks` a list,
        CUDA events are recorded after the far-field interpolation
        ("interp"), each far-FMM stage, the FMM's density gather and
        unsort ("fmm_io") and the near corrections ("near")."""
        from ..fmm.kifmm import _mark
        self.setup()
        ker, dev = self.kernel, self._dev
        k0 = ker.kdim0
        sigma = sigma.to(self.device, self.dtype).reshape(-1, k0)
        ff = torch.einsum("efn,enk->efk", dev["interp"], sigma[dev["nidx"]])
        Ff = sigma.new_zeros((len(self.Xf), k0))
        Ff.index_add_(0, dev["fidx"],
                      (ff * dev["fval"][..., None]).reshape(-1, k0))
        Ff = Ff * dev["wf"][:, None]
        _mark(marks, "interp")
        if self._far_fmm is not None:
            fmm = self._far_fmm
            U = fmm.unsort(fmm._eval_impl(fmm.pad_density(Ff), marks))
            _mark(marks, "fmm_io")
        else:
            U = direct_eval_blocked(ker, dev["Xt"], dev["Xf"], Ff,
                                    ns=dev["Xnf"])
        if self._n_near:
            sig_p = sigma.reshape(-1)[dev["near_sidx"]]          # (P, R)
            U.index_add_(0, dev["near_ti"],
                         torch.einsum("pr,prk->pk", sig_p,
                                      dev["near_mats"]))
        _mark(marks, "near")
        return U

    def sharded_apply(self, comm):
        """The distributed application over comm's ranks
        (sctl_tpu/bie/boundary_integral.py:710-719): a
        `dist.ShardedBIEApply` with `pack`, `apply` and `unpack`; its
        setup runs `setup(comm=comm)`."""
        from .dist import ShardedBIEApply
        return ShardedBIEApply(self, comm)

    def compute_potential(self, sigma) -> np.ndarray:
        """numpy sigma -> numpy (Nt, k1) potential, timed in the profile
        block "BIO::ComputePotential" (with sync), as at
        sctl_tpu/bie/boundary_integral.py:698."""
        self.setup()
        s = torch.as_tensor(np.asarray(sigma), dtype=self.dtype,
                            device=self.device)
        with profile.Profile.scoped("BIO::ComputePotential", sync=True):
            u = self.compute_potential_tensor(s)
        return u.cpu().numpy()
