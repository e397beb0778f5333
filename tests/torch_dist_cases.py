"""Rank-side cases of the port's distributed tests: functions that
`sctl_tpu_torch.comm.run_ranks` runs on each rank process, and the
seeded inputs that the tests hand to the JAX package too.  This module
imports no JAX (the rank processes import it).

Every input is a global numpy array; rank r takes its block r.
"""

import numpy as np
import torch

from sctl_tpu_torch.comm import verbs as V

P = 4          # ranks
CAP = 32       # per-rank capacity of the ragged arrays

F64 = torch.float64


def ragged(seed: int, cnt_max: int = CAP):
    """(data (P, CAP), cnts (P,)): the JAX tests' random ragged array."""
    rng = np.random.default_rng(seed)
    cnts = rng.integers(0, cnt_max + 1, size=P)
    data = np.zeros((P, CAP))
    for r in range(P):
        data[r, :cnts[r]] = rng.normal(size=cnts[r])
    return data, cnts.astype(np.int64)


def comm_inputs() -> dict:
    """The inputs of `comm_cases`, the same for the JAX side."""
    rng = np.random.default_rng(20)
    d = {"x": rng.normal(size=(P, 3)), "a2a": rng.normal(size=(P, 8)),
         "send_cnt": rng.integers(0, 4, size=(P, P))}
    a2av = np.zeros((P, CAP))
    for r in range(P):
        m = d["send_cnt"][r].sum()
        a2av[r, :m] = rng.normal(size=m)
    d["a2av"] = a2av
    d["route_data"], d["route_cnt"] = ragged(1, 16)
    d["route_dest"] = rng.integers(0, P, size=(P, CAP))
    d["pn_data"], d["pn_cnt"] = ragged(2, 16)
    total = int(d["pn_cnt"].sum())
    d["pn_tgt"] = np.full(P, total // P) + (np.arange(P) < total % P)
    d["pw_data"], d["pw_cnt"] = ragged(3, 16)
    d["pw_w"] = rng.uniform(0.5, 2.0, size=(P, CAP))
    cnts = rng.integers(4, CAP + 1, size=P)
    keys = np.full((P, CAP), np.inf)
    for r in range(P):
        keys[r, :cnts[r]] = rng.normal(size=cnts[r])
    d["gs_keys"], d["gs_cnt"] = keys, cnts
    d["ss_keys"] = rng.normal(size=(P, CAP // 2))
    ss = np.zeros((P, CAP))
    ss[:, :CAP // 2] = (100 + np.arange(CAP // 2)[None, :]
                        + 1000 * np.arange(P)[:, None])
    d["ss_data"] = ss
    d["gmres_A"] = rng.random((256, 256)) / 256 + np.eye(256)
    d["gmres_b"] = rng.random(256)
    d["sdc_u0"] = rng.normal(size=(4, 6))
    d["sdc_rate"] = np.linspace(0.5, 2.0, 4)
    return d


def sdc_rhs(rate: torch.Tensor):
    """F(u) of the SDC case: each field u_i (a row) turns at its own
    rate, u' = rate_i J u with J a rotation generator of pairs."""
    def F(u):
        v = torch.stack([-u[:, 1::2], u[:, 0::2]], -1).reshape(u.shape)
        return rate[:, None] * v
    return F


def comm_cases(comm, d):
    from sctl_tpu_torch import config
    from sctl_tpu_torch.linalg import SDC, gmres, gmres_device
    from sctl_tpu_torch.profile import Profile, add_flops
    r = comm.rank()
    t = lambda a: torch.as_tensor(a)
    out = {}
    x = t(d["x"][r])
    out["allreduce_sum"] = comm.allreduce(x)
    out["allreduce_max"] = comm.allreduce(x, "max")
    out["allreduce_min"] = comm.allreduce(x, "min")
    out["scan_incl"] = comm.scan(x)
    out["scan_excl"] = comm.scan(x, exclusive=True)
    out["scan_max"] = comm.scan(x, "max")
    out["bcast"] = comm.bcast(x, root=3)
    out["allgather"] = comm.allgather(x)
    out["allgather_tiled"] = comm.allgather(x, tiled=True)
    out["alltoall"] = comm.alltoall(t(d["a2a"][r]))
    out["shift1"] = comm.send_recv_shift(x, 1)
    out["shift3"] = comm.send_recv_shift(x, 3)
    out["send_recv"] = comm.send_recv(x, [(0, 3), (2, 1)], fill=-1.0)
    sub = comm.split([0, 0, 1, 1])
    out["split_sum"] = sub.allreduce(x)
    out["split_rank"] = sub.rank()
    out["split_scan"] = sub.scan(x, exclusive=True)
    out["strided_sum"] = comm.split([0, 1, 0, 1]).allreduce(x)
    comm.barrier()

    sc = t(d["send_cnt"][r])
    o, n = V.alltoallv(comm, t(d["a2av"][r]), sc, 2 * CAP)
    out["alltoallv"], out["alltoallv_n"] = o, n
    o, n = V.alltoallv_ring(comm, t(d["a2av"][r]), sc, 2 * CAP)
    out["alltoallv_ring"], out["alltoallv_ring_n"] = o, n
    for impl in ("gather", "ring"):
        o, n = V.route(comm, t(d["route_data"][r]), int(d["route_cnt"][r]),
                       t(d["route_dest"][r]), CAP * P, impl=impl)
        out[f"route_{impl}"], out[f"route_{impl}_n"] = o, n
    o, n = V.partition_n(comm, t(d["pn_data"][r]), int(d["pn_cnt"][r]),
                         t(d["pn_tgt"]), CAP * P)
    out["partition_n"], out["partition_n_n"] = o, n
    o, n = V.partition_w(comm, t(d["pw_data"][r]), int(d["pw_cnt"][r]),
                         t(d["pw_w"][r]), CAP * P)
    out["partition_w"], out["partition_w_n"] = o, n
    gk = t(d["gs_keys"][r])
    ks, vs, n = V.global_sort(comm, gk, int(d["gs_cnt"][r]),
                              payload=10.0 * gk, capacity=4 * CAP)
    out["global_sort_k"], out["global_sort_v"], out["global_sort_n"] = \
        ks, vs, n
    keys = torch.zeros(CAP, dtype=F64)
    keys[:CAP // 2] = t(d["ss_keys"][r])
    idx = V.sort_scatter_index(comm, keys, CAP // 2, capacity=4 * CAP)
    fwd, fcnt = V.scatter_forward(comm, t(d["ss_data"][r]), CAP // 2, idx,
                                  capacity=CAP)
    rev, _ = V.scatter_reverse(comm, fwd, fcnt, idx, CAP // 2,
                               capacity=4 * CAP)
    out["scatter_idx"], out["scatter_fwd"] = idx, fwd
    out["scatter_fwd_n"], out["scatter_rev"] = fcnt, rev
    own = t(d["route_data"][r][:d["route_cnt"][r]])
    out["allgatherv"] = V.allgatherv(comm, own)
    out["allgatherv_cap"] = V.allgatherv(comm, own, CAP)

    # row-sharded GMRES (tests/test_gmres.py:78-95's system)
    N = d["gmres_A"].shape[0]
    rows = slice(r * N // P, (r + 1) * N // P)
    A_r = t(d["gmres_A"][rows])
    op = lambda v: A_r @ comm.allgather(v, tiled=True)
    xg, it = gmres(op, t(d["gmres_b"][rows]), tol=1e-10, comm=comm)
    out["gmres_x"], out["gmres_iters"] = xg, it
    xd, itd, _ = gmres_device(op, t(d["gmres_b"][rows]), tol=1e-10,
                              max_iter=N, comm=comm)
    out["gmres_device_x"], out["gmres_device_iters"] = xd, itd

    # SDC over two ranks of a pair: each holds two of the four fields
    fields = slice(2 * (r % 2), 2 * (r % 2) + 2)
    sdc = SDC(6, comm=sub, device="cpu")
    steps = []
    u, tr, err = sdc.adaptive_solve(
        0.1, 1.0, t(d["sdc_u0"][fields]), sdc_rhs(t(d["sdc_rate"][fields])),
        1e-8, monitor=lambda tt, dt, uu: steps.append(dt))
    out["sdc_u"], out["sdc_steps"], out["sdc_t"] = u, len(steps), tr

    # profile counters after a fixed set of verbs, and the report
    config.profile_level = 5
    Profile.reset()
    comm.allreduce(x)
    comm.scan(x, exclusive=True)
    comm.bcast(x, root=1)
    comm.allgather(x)
    comm.alltoall(t(d["a2a"][r]))
    comm.send_recv_shift(x, 1)
    comm.send_recv(x, [(0, 3), (2, 1)])
    out["coll_count"] = Profile.get_counter("COLL_COUNT")
    out["coll_bytes"] = Profile.get_counter("COLL_BYTES")
    Profile.reset()
    Profile.tic("blk")
    add_flops(2e9 / P)
    Profile.toc()
    out["report"] = Profile.print_report(
        fields=("t", "t_min", "t_max", "t_avg", "f_total", "f/s_total"))
    config.profile_level = -1
    return out


def self_cases(d):
    """The self-communicator's verbs (one process, no group)."""
    from sctl_tpu_torch.comm import Comm
    comm = Comm.self_()
    t = lambda a: torch.as_tensor(a)
    out = {}
    x = t(d["x"][0])
    out["allreduce"] = comm.allreduce(x)
    out["scan_excl"] = comm.scan(x, exclusive=True)
    out["bcast"] = comm.bcast(x)
    out["allgather"] = comm.allgather(x)
    out["shift"] = comm.send_recv_shift(x, 1)
    k = t(d["gs_keys"][0])
    ks, vs, n = V.global_sort(comm, k, int(d["gs_cnt"][0]), payload=2 * k,
                              capacity=CAP)
    out["global_sort_k"], out["global_sort_v"], out["global_sort_n"] = \
        ks, vs, n
    o, n = V.alltoallv(comm, t(d["a2av"][0]), t(d["send_cnt"][0][:1]),
                       2 * CAP)
    out["alltoallv"], out["alltoallv_n"] = o, n
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def tree_inputs() -> dict:
    """The inputs of `tree_cases` (tests/test_tree.py:124-210 and
    tests/test_fmm_dist.py:72-94)."""
    rng = np.random.default_rng(11)
    d = {"X": rng.random((2048, 3)) ** 2,
         "Xc": np.random.default_rng(7).random((1024, 3))}
    rng = np.random.default_rng(42)
    th = rng.uniform(0, np.pi, 3000)
    ph = rng.uniform(0, 2 * np.pi, 3000)
    d["sphere"] = np.stack([np.sin(th) * np.cos(ph),
                            np.sin(th) * np.sin(ph), np.cos(th)], 1)
    d["sphere_f"] = rng.normal(size=(3000, 1))
    return d


def tree_cases(comm, d):
    from sctl_tpu_torch.fmm.adaptive import AdaptiveFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.tree.dist_tree import DistPtTree, morton_encode
    from sctl_tpu_torch.tree.tree import _normalize
    r = comm.rank()
    out = {}
    X = torch.as_tensor(d["X"])
    C = X.shape[0] // P
    for bal in (False, True):
        tree = DistPtTree(comm, leaf_cap=4096, pt_cap=2 * C, max_level=6)
        lk, ll, nl, Xs, oc = tree.build_fn(64, balance21=bal)(
            X[r * C:(r + 1) * C], C)
        out[f"leaves_{bal}"] = (lk[:nl], ll[:nl])
        out[f"sorted_{bal}"] = (Xs[:oc], oc)
    # named node data: per-leaf counts reduced over the ranks
    Xc = torch.as_tensor(d["Xc"])
    C = Xc.shape[0] // P
    tree = DistPtTree(comm, leaf_cap=4096, pt_cap=2 * C, max_level=5)
    lk, ll, nl, _, _ = tree.build_fn(32)(Xc[r * C:(r + 1) * C], C)
    Xl = Xc[r * C:(r + 1) * C]
    lo = comm.allreduce(Xl.amin(0), "min")
    hi = comm.allreduce(Xl.amax(0), "max")
    keys = morton_encode((Xl - lo) / ((hi - lo).max() * (1 + 1e-10)))
    leaf = DistPtTree.leaf_of_points(lk, keys)
    partial = torch.zeros(lk.shape[0], dtype=F64).index_add_(
        0, leaf, torch.ones(C, dtype=F64))
    out["counts"] = tree.reduce_broadcast(partial)[:nl]
    own = torch.zeros(lk.shape[0], dtype=torch.bool)
    own[torch.arange(lk.shape[0]) % P == r] = True
    out["bcast"] = tree.broadcast(torch.arange(lk.shape[0], dtype=F64)
                                  * (r + 1), own)
    # the work-sharded adaptive FMM, then the same FMM on the skeleton
    # of the distributed tree over its normalization
    xs, f = d["sphere"], d["sphere_f"]
    fmm = AdaptiveFMM(Laplace3D_FxU, p=4, max_pts=40, device="cpu",
                      dtype=F64).setup(xs, xs)
    out["sharded"] = fmm.eval_sharded(f, comm)
    out["sharded_pair"] = fmm.eval_sharded(f, comm.split([0, 0, 1, 1]))
    _, off, sc = _normalize(np.concatenate([xs, xs]))
    C = len(xs) // P
    tree = DistPtTree(comm, leaf_cap=1 << 14, pt_cap=2 * C, max_level=12)
    lk, ll, nl, _, _ = tree.build_fn(40, balance21=True, bbox=(off, sc))(
        torch.as_tensor(xs[r * C:(r + 1) * C]), C)
    out["skeleton_leaves"] = (lk[:nl], ll[:nl])
    return out


def kifmm_inputs() -> dict:
    """The inputs of `kifmm_cases` (tests/test_fmm_dist.py's forms)."""
    rng = np.random.default_rng(0)
    n = 1200
    nrm = rng.normal(size=(n, 3))
    d = {"xs": rng.random((n, 3)), "xt": rng.random((n, 3)),
         "f": rng.normal(size=(n, 1)),
         "nrm": nrm / np.linalg.norm(nrm, axis=1, keepdims=True)}
    m = 200
    d["ring_xt"], d["ring_xs"] = rng.random((m, 3)), rng.random((m, 3))
    d["ring_f"] = rng.normal(size=(m, 1))
    d["ring_nrm"] = d["nrm"][:m]
    return d


def kifmm_cases(comm, d):
    from sctl_tpu_torch.fmm import ParticleFMM
    from sctl_tpu_torch.fmm.kifmm_dist import KIFMMDist
    from sctl_tpu_torch.ops import Laplace3D_DxU, Laplace3D_FxU
    r = comm.rank()
    out = {}
    xs, xt, f = d["xs"], d["xt"], d["f"]
    kw = dict(p=6, device="cpu", dtype=F64)
    sl = KIFMMDist(Laplace3D_FxU, comm, depth=3, **kw).setup(xs, xt)
    out["sl"] = sl.eval(f)
    out["sl_local"] = sl.eval_tensor(torch.as_tensor(f[sl.src_index]))
    out["sl_trg_index"] = sl.trg_index
    out["sl_route"] = (sl.surface_route, sl.l_shard_min)
    dl = KIFMMDist(Laplace3D_DxU, comm, depth=3, **kw).setup(
        xs, xt, n_src=d["nrm"])
    out["dl"] = dl.eval(f)
    # depth 4 over each pair of a split: the sharded M2L levels 3 and 4
    # with their halo planes
    pair = comm.split([0, 0, 1, 1])
    d4 = KIFMMDist(Laplace3D_FxU, pair, depth=4, p=4, device="cpu",
                   dtype=F64).setup(xs, xs)
    out["d4"] = d4.eval(f)
    out["d4_shard_min"] = d4.l_shard_min
    # the ring direct sum: rank r's shards of targets and sources
    m = len(d["ring_xt"]) // P
    blk = lambda a: torch.as_tensor(a[r * m:(r + 1) * m])
    fmm = ParticleFMM(comm, device="cpu", dtype=F64)
    out["ring_sl"] = fmm.eval_direct_ring(
        Laplace3D_FxU, blk(d["ring_xt"]), blk(d["ring_xs"]), blk(d["ring_f"]))
    out["ring_dl"] = fmm.eval_direct_ring(
        Laplace3D_DxU, blk(d["ring_xt"]), blk(d["ring_xs"]), blk(d["ring_f"]),
        ns=blk(d["ring_nrm"]))
    return out


def adaptive_inputs() -> dict:
    """The inputs of `adaptive_cases` (tests/test_fmm.py:270-307): 3,000
    points on the unit sphere, their normals the points; "tables" (set
    by the caller) the Laplace unit tables at p = 6 as numpy arrays."""
    rng = np.random.default_rng(5)
    n = 3000
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return {"xs": x, "f": rng.normal(size=(n, 1)), "tables": None}


def adaptive_cases(comm, d):
    from sctl_tpu_torch.fmm import AdaptiveFMMDist, operators_from_numpy
    from sctl_tpu_torch.ops import Laplace3D_DxU, Laplace3D_FxU
    xs, f = d["xs"], d["f"]
    kw = dict(p=6, max_pts=64, device="cpu", dtype=F64,
              operators=operators_from_numpy(d["tables"], "cpu", F64))
    fm = AdaptiveFMMDist(Laplace3D_FxU, comm, **kw).setup(xs, xs)
    af = fm._afmm
    out = {"sl": fm.eval(f),
           "local": fm.eval_tensor(torch.as_tensor(f[fm.src_index])),
           "trg_index": fm.trg_index, "Crg": fm.Crg, "Cb": fm.Cb,
           "block": (fm.lo, fm.hi), "n_leaf": fm.n_leaf,
           "leaves": (af.tree.leaf_keys, af.tree.leaf_levels),
           "rows": [a.shape[0] for a in (fm.xs_own, fm.ns_own, fm.xt_own,
                                         fm.pad_idx)],
           "freed": [getattr(af, k) is None for k in (
               "xs_loc", "ns_pad", "xt_loc", "ul_xs", "wpairs", "xpairs")],
           "w_rows": torch.cat([w[0] for w in fm.wpairs.values()]),
           "w_pairs": sum(len(w[0]) for w in fm.wpairs.values()),
           "x_rows": torch.cat([x[1] for x in fm.xpairs.values()]),
           "x_pairs": sum(len(x[0]) for x in fm.xpairs.values()),
           "ulist_sources": fm.ul_xs.shape[1]}
    dl = AdaptiveFMMDist(Laplace3D_DxU, comm, **kw).setup(xs, xs, n_src=xs)
    out["dl"] = dl.eval(f)
    out["dl_Crg"] = dl.Crg
    return out


def sphere1():
    from sctl_tpu_torch.bie import sphere_patches
    return sphere_patches(n_per_face=1, q=4)


def sphere2():
    from sctl_tpu_torch.bie import sphere_patches
    return sphere_patches(n_per_face=2, q=4)


BIE_TOL2 = 1e-6        # the sphere_patches(2) cases' quadrature tolerance


def bie_inputs() -> dict:
    """The inputs of `bie_cases` (tests/test_bie.py:247-450, the
    spheres at q = 4 where the JAX tests take q = 6: the host near
    path's time grows with q): densities,
    the Laplace point source of the second-kind solve, the Stokes
    torus's density; "tables" (set by the caller) the far FMMs' unit
    tables as numpy arrays, by translation kernel name."""
    rng = np.random.default_rng(1)
    return {"sigma1": rng.normal(size=6 * 16),
            "sigma2": np.random.default_rng(2).normal(size=24 * 16),
            "sigma7": np.random.default_rng(7).normal(size=24 * 16),
            "src": np.array([[1.7, 0.8, 1.2]]),
            "sigma_st": np.random.default_rng(3).normal(size=3 * 18 * 16),
            "tables": {}}


def _bie_op(ker, lst, tol, d, comm=None, cutoff=None, p=6, host=True):
    """A float64 CPU BoundaryIntegralOp on the tables of d["tables"]."""
    from sctl_tpu_torch.bie import BoundaryIntegralOp
    from sctl_tpu_torch.fmm import operators_from_numpy
    from sctl_tpu_torch.fmm.fmm import _TREE_L2T
    from sctl_tpu_torch.fmm.kifmm import kernel_roles
    op = BoundaryIntegralOp(ker, comm=comm, device="cpu", dtype=F64)
    op.set_accuracy(tol)
    op.add_elem_list(lst)
    op.use_device_near = not host
    if cutoff is not None:
        op.far_fmm_cutoff = cutoff
        op.far_fmm_p = p
        trans = kernel_roles(ker, _TREE_L2T[ker.name])[0]
        op.far_fmm_operators = operators_from_numpy(
            d["tables"][trans.name], "cpu", F64, trans)
    return op


def bie_cases(comm, d):
    from sctl_tpu_torch.bie import torus_patches
    from sctl_tpu_torch.linalg import gmres_device
    from sctl_tpu_torch.ops import (Laplace3D_DxU, Laplace3D_FxU,
                                    Stokes3D_DxU, direct_eval_blocked)
    out = {}
    t = torch.as_tensor

    # the direct regime (tests/test_bie.py:247-297): the host-search op,
    # its sharded apply and a sharded second-kind solve
    op = _bie_op(Laplace3D_DxU, sphere1(), 1e-7, d)
    op.setup()
    sh = op.sharded_apply(comm)
    out["direct_fmm"] = sh._fmm is not None
    out["direct_sh"] = sh.unpack(sh.apply(sh.pack(d["sigma1"])))
    out["direct_1"] = op.compute_potential(d["sigma1"])
    X = op.X
    bc = direct_eval_blocked(Laplace3D_FxU, t(X), t(d["src"]),
                             torch.ones((1, 1), dtype=F64))[:, 0]
    A_sh = lambda s: sh.apply(s).reshape(-1) - 0.5 * s
    x_sh, it_sh, _ = gmres_device(A_sh, sh.pack(bc), tol=1e-8, max_iter=60,
                                  comm=comm)
    A_1 = lambda s: op.compute_potential_tensor(s).reshape(-1) - 0.5 * s
    x_1, it_1, _ = gmres_device(A_1, bc, tol=1e-8, max_iter=60)
    out.update(x_sh=sh.unpack(x_sh.reshape(-1, 1))[:, 0], it_sh=int(it_sh),
               x_1=x_1, it_1=int(it_1), n_own=sh.n_own)

    # the FMM regime (:300-325) on the host-search op, and setup(comm=)
    # as the production path (:396-450): the distributed search, the
    # assembly shared by blocks and all-gathered; the sharded apply on
    # the latter; then its search again from capacities cut to 1/64
    op2 = _bie_op(Laplace3D_DxU, sphere2(), BIE_TOL2, d, cutoff=1000)
    op2.setup()
    out["host_pairs"] = np.asarray(op2.near_pairs)
    out["fmm_1"] = op2.compute_potential(d["sigma2"])
    out["host_u"] = op2.compute_potential(d["sigma7"])
    op3 = _bie_op(Laplace3D_DxU, sphere2(), BIE_TOL2, d, comm=comm,
                  cutoff=1000)
    op3.setup()
    out["dist_pairs"] = np.asarray(op3.near_pairs)
    out["dist_u"] = op3.compute_potential(d["sigma7"])
    sh2 = op3.sharded_apply(comm)
    out["fmm_sh"] = sh2.unpack(sh2.apply(sh2.pack(d["sigma2"])))
    out["fmm_Crg"] = sh2._fmm.Crg
    op3._build_near_list_dist(comm, _cap_scale=1.0 / 64)
    out["grown"] = op3._near_caps_grown
    out["grown_pairs"] = np.asarray(op3.near_pairs)

    # Stokes3D_DxU on the 6 x 3 torus, the FMM regime, set up over the
    # ranks with the device near engine (on the CPU)
    op4 = _bie_op(Stokes3D_DxU, torus_patches(nu=6, nv=3, q=4, R=2.0, r=0.5),
                  1e-4, d, comm=comm, cutoff=100, p=4, host=False)
    sh4 = op4.sharded_apply(comm)
    out["stokes_sh"] = sh4.unpack(sh4.apply(sh4.pack(d["sigma_st"])))
    out["stokes_1"] = op4.compute_potential(d["sigma_st"])
    out["stokes_Crg"] = sh4._fmm.Crg
    return out
