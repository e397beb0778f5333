"""The port's communication layer (sctl_tpu_torch.comm) on 4 gloo rank
processes against the JAX package's on a 4-device sub-mesh of the
conftest's virtual CPU devices, block for block: every Comm method
(split groups, strided groups, send_recv pairs), every verb of
comm/verbs.py, the row-sharded GMRES, SDC(comm=) on 2 ranks, the profile
counters and the distributed report fields; and the self-communicator
against the JAX Comm() with no axis.  Integers exactly, floats to 1e-15
(tests/test_comm.py's cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps

import torch_dist_cases as C
from sctl_tpu.comm import Comm as JComm
from sctl_tpu.comm import verbs as JV
from sctl_tpu_torch.comm import start_ranks
from sctl_tpu_torch.config import limit_cpu_threads

limit_cpu_threads()
P, CAP = C.P, C.CAP
FLOAT_TOL = 1e-15


@pytest.fixture(scope="module")
def inputs():
    return C.comm_inputs()


@pytest.fixture(scope="module")
def started(inputs):
    """One group of 4 gloo ranks runs every case of the module."""
    return start_ranks(C.comm_cases, P, inputs, backend="gloo",
                       device="cpu", timeout=240, threads=1)


@pytest.fixture(scope="module")
def ranks(started, jax_blocks):
    """The ranks' results (the JAX side runs while they work)."""
    return started.join()


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:P]), ("x",))


def _jrun(mesh, fn, *arrays):
    """fn over the mesh's shards: each (P, ...) array split along its
    leading axis, each output's block r the leading (P, ...) index r."""
    comm = JComm.world(mesh)
    sh = NamedSharding(mesh, Ps("x"))
    args = [jax.device_put(jnp.asarray(np.asarray(a).reshape(
        (-1,) + np.asarray(a).shape[2:])), sh) for a in arrays]

    def body(*xs):
        return tuple(o[None] for o in fn(comm, *xs))

    out = jax.jit(comm.run(body, in_specs=tuple(Ps("x") for _ in args),
                           out_specs=Ps("x")))(*args)
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def jax_blocks(started, mesh4, inputs):
    """The JAX package's blocks of every case, by name."""
    d = inputs
    out = {}

    def prim(comm, x, a2a):
        sub = comm.split([0, 0, 1, 1])
        return (comm.allreduce(x), comm.allreduce(x, "max"),
                comm.allreduce(x, "min"), comm.scan(x),
                comm.scan(x, exclusive=True), comm.scan(x, "max"),
                comm.bcast(x, root=3), comm.allgather(x),
                comm.allgather(x, tiled=True), comm.alltoall(a2a),
                comm.send_recv_shift(x, 1), comm.send_recv_shift(x, 3),
                comm.send_recv(x, [(0, 3), (2, 1)], fill=-1.0),
                sub.allreduce(x), sub.rank(), sub.scan(x, exclusive=True),
                comm.split([0, 1, 0, 1]).allreduce(x))

    names = ["allreduce_sum", "allreduce_max", "allreduce_min", "scan_incl",
             "scan_excl", "scan_max", "bcast", "allgather",
             "allgather_tiled", "alltoall", "shift1", "shift3", "send_recv",
             "split_sum", "split_rank", "split_scan", "strided_sum"]
    out.update(zip(names, _jrun(mesh4, prim, d["x"], d["a2a"])))

    def a2av(comm, data, sc):
        o1, n1 = JV.alltoallv(comm, data, sc, 2 * CAP)
        o2, n2 = JV.alltoallv_ring(comm, data, sc, 2 * CAP)
        return o1, n1, o2, n2

    out.update(zip(["alltoallv", "alltoallv_n", "alltoallv_ring",
                    "alltoallv_ring_n"],
                   _jrun(mesh4, a2av, d["a2av"], d["send_cnt"])))
    for impl in ("gather", "ring"):
        def rt(comm, data, c, dest, impl=impl):
            return JV.route(comm, data, c[0], dest, CAP * P, impl=impl)
        out.update(zip([f"route_{impl}", f"route_{impl}_n"], _jrun(
            mesh4, rt, d["route_data"], d["route_cnt"][:, None],
            d["route_dest"])))
    tgt = jnp.asarray(d["pn_tgt"])
    out.update(zip(["partition_n", "partition_n_n"], _jrun(
        mesh4, lambda comm, data, c: JV.partition_n(comm, data, c[0], tgt,
                                                    CAP * P),
        d["pn_data"], d["pn_cnt"][:, None])))
    out.update(zip(["partition_w", "partition_w_n"], _jrun(
        mesh4, lambda comm, data, c, w: JV.partition_w(comm, data, c[0], w,
                                                       CAP * P),
        d["pw_data"], d["pw_cnt"][:, None], d["pw_w"])))
    out.update(zip(["global_sort_k", "global_sort_v", "global_sort_n"],
                   _jrun(mesh4, lambda comm, k, c: JV.global_sort(
                       comm, k, c[0], payload=10.0 * k, capacity=4 * CAP),
                       d["gs_keys"], d["gs_cnt"][:, None])))
    keys = np.zeros((P, CAP))
    keys[:, :CAP // 2] = d["ss_keys"]
    cnt = np.full((P, 1), CAP // 2)

    def scat(comm, k, c, data):
        idx = JV.sort_scatter_index(comm, k, c[0], capacity=4 * CAP)
        fwd, fcnt = JV.scatter_forward(comm, data, c[0], idx, capacity=CAP)
        rev, _ = JV.scatter_reverse(comm, fwd, fcnt, idx, c[0],
                                    capacity=4 * CAP)
        return idx, fwd, fcnt, rev

    out.update(zip(["scatter_idx", "scatter_fwd", "scatter_fwd_n",
                    "scatter_rev"],
                   _jrun(mesh4, scat, keys, cnt, d["ss_data"])))
    return out


BLOCK_CASES = [
    "allreduce_sum", "allreduce_max", "allreduce_min", "scan_incl",
    "scan_excl", "scan_max", "bcast", "allgather", "allgather_tiled",
    "alltoall", "shift1", "shift3", "send_recv", "split_sum", "split_rank",
    "split_scan", "strided_sum", "alltoallv", "alltoallv_n",
    "alltoallv_ring", "alltoallv_ring_n", "route_gather", "route_gather_n",
    "route_ring", "route_ring_n", "partition_n", "partition_n_n",
    "partition_w", "partition_w_n", "global_sort_k", "global_sort_v",
    "global_sort_n", "scatter_idx", "scatter_fwd", "scatter_fwd_n",
    "scatter_rev"]


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_blocks_match_jax(ranks, jax_blocks, case):
    """Rank r's result is the JAX package's block r."""
    for r in range(P):
        got = np.asarray(ranks[r][case])
        want = np.asarray(jax_blocks[case][r]).reshape(got.shape)
        if np.issubdtype(want.dtype, np.integer) or got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(got, want, rtol=FLOAT_TOL,
                                       atol=FLOAT_TOL, err_msg=f"rank {r}")


def test_verbs_semantics(ranks, inputs):
    """What the blocks mean, as tests/test_comm.py states it: the sort is
    global and rebalanced, the scatter index is each key's global rank,
    the reverse scatter restores the data."""
    n = np.array([int(ranks[r]["global_sort_n"]) for r in range(P)])
    keys = np.concatenate([ranks[r]["global_sort_k"][:n[r]]
                           for r in range(P)])
    allk = np.concatenate([inputs["gs_keys"][r, :inputs["gs_cnt"][r]]
                           for r in range(P)])
    np.testing.assert_array_equal(keys, np.sort(allk))
    assert n.max() - n.min() <= 1
    idx = np.concatenate([ranks[r]["scatter_idx"][:CAP // 2]
                          for r in range(P)])
    np.testing.assert_array_equal(
        idx, np.argsort(np.argsort(inputs["ss_keys"].reshape(-1))))
    for r in range(P):
        np.testing.assert_array_equal(ranks[r]["scatter_rev"][:CAP // 2],
                                      inputs["ss_data"][r, :CAP // 2])


def test_allgatherv(ranks, inputs):
    """The ragged all-gather: every rank holds every rank's valid rows,
    in rank order, whatever the padding."""
    want = np.concatenate([inputs["route_data"][r, :inputs["route_cnt"][r]]
                           for r in range(P)])
    for r in range(P):
        for case in ("allgatherv", "allgatherv_cap"):
            np.testing.assert_array_equal(ranks[r][case], want,
                                          err_msg=f"rank {r} {case}")


def test_self_comm_matches_jax(inputs):
    """The self-communicator against the JAX Comm() with no axis."""
    d = inputs
    got = C.self_cases(d)
    jc = JComm()
    x = jnp.asarray(d["x"][0])
    np.testing.assert_array_equal(got["allreduce"], np.asarray(
        jc.allreduce(x)))
    np.testing.assert_array_equal(got["scan_excl"], np.asarray(
        jc.scan(x, exclusive=True)))
    np.testing.assert_array_equal(got["bcast"], np.asarray(jc.bcast(x)))
    np.testing.assert_array_equal(got["allgather"], np.asarray(
        jc.allgather(x)))
    np.testing.assert_array_equal(got["shift"], np.asarray(
        jc.send_recv_shift(x, 1)))
    k = jnp.asarray(d["gs_keys"][0])
    ks, vs, n = JV.global_sort(jc, k, jnp.int32(d["gs_cnt"][0]),
                               payload=2 * k, capacity=CAP)
    np.testing.assert_array_equal(got["global_sort_k"], np.asarray(ks))
    np.testing.assert_array_equal(got["global_sort_v"], np.asarray(vs))
    assert int(got["global_sort_n"]) == int(n)
    o, n = JV.alltoallv(jc, jnp.asarray(d["a2av"][0]),
                        jnp.asarray(d["send_cnt"][0][:1]), 2 * CAP)
    np.testing.assert_array_equal(got["alltoallv"], np.asarray(o))
    assert int(got["alltoallv_n"]) == int(n)


def test_gmres_sharded_matches_jax(ranks, inputs, mesh4):
    """The row-sharded GMRES (inner products and norms all-reduced) takes
    the iterations of the JAX package's sharded system
    (tests/test_gmres.py:78-95) and reaches its solution."""
    from sctl_tpu.linalg.gmres import gmres as j_gmres
    A = jnp.asarray(inputs["gmres_A"])
    sh = NamedSharding(mesh4, Ps("x"))
    b = jax.device_put(jnp.asarray(inputs["gmres_b"]), sh)
    Ash = jax.device_put(A, NamedSharding(mesh4, Ps("x", None)))
    xj, itj = j_gmres(jax.jit(lambda v: Ash @ v), b, tol=1e-10)
    xj = np.asarray(xj)
    for key in ("gmres", "gmres_device"):
        iters = {int(ranks[r][key + "_iters"]) for r in range(P)}
        assert iters == {int(itj)}, (key, iters, itj)
        x = np.concatenate([ranks[r][key + "_x"] for r in range(P)])
        np.testing.assert_allclose(x, xj, rtol=0, atol=1e-12)
        res = np.abs(inputs["gmres_A"] @ x - inputs["gmres_b"]).max()
        assert res < 1e-9, res


def test_sdc_comm_matches_jax(ranks, inputs):
    """SDC(comm=) over 2 ranks, two fields each, against the JAX SDC over
    the four fields: the same accepted steps, the result to 1e-12."""
    from sctl_tpu.linalg import SDC as J_SDC
    rate = jnp.asarray(inputs["sdc_rate"])

    def F(u):
        v = jnp.stack([-u[:, 1::2], u[:, 0::2]], -1).reshape(u.shape)
        return rate[:, None] * v

    steps = []
    uj, tj, _ = J_SDC(6).adaptive_solve(
        0.1, 1.0, jnp.asarray(inputs["sdc_u0"]), F, 1e-8,
        monitor=lambda t, dt, u: steps.append(dt))
    uj = np.asarray(uj)
    for r in range(P):
        assert int(ranks[r]["sdc_steps"]) == len(steps)
        assert float(ranks[r]["sdc_t"]) == pytest.approx(float(tj), abs=0)
        fields = slice(2 * (r % 2), 2 * (r % 2) + 2)
        np.testing.assert_allclose(ranks[r]["sdc_u"], uj[fields], rtol=0,
                                   atol=1e-12)


def test_counters_and_report_match_jax(ranks, inputs, mesh4):
    """The profile counters after the same verbs, summed over the ranks,
    equal the JAX package's (its callbacks fire once a shard), and the
    distributed report fields reduce over the ranks: f_total is the sum
    of the ranks' FLOPs, as the JAX report's over its one process."""
    import sctl_tpu
    from sctl_tpu.profile import Profile as JProfile
    from sctl_tpu.profile import add_flops as j_add_flops
    sctl_tpu.config.profile_level = 5
    try:
        JProfile.reset()

        def f(comm, x, a2a):
            return (comm.allreduce(x), comm.scan(x, exclusive=True),
                    comm.bcast(x, root=1), comm.allgather(x),
                    comm.alltoall(a2a), comm.send_recv_shift(x, 1),
                    comm.send_recv(x, [(0, 3), (2, 1)]))

        _jrun(mesh4, f, inputs["x"], inputs["a2a"])
        jax.effects_barrier()
        jc = JProfile.get_counter("COLL_COUNT")
        jb = JProfile.get_counter("COLL_BYTES")
        JProfile.reset()
        JProfile.tic("blk")
        j_add_flops(2e9)
        JProfile.toc()
        jrep = JProfile.print_report(fields=("f_total",))
    finally:
        sctl_tpu.config.profile_level = -1
    assert sum(ranks[r]["coll_count"] for r in range(P)) == jc
    assert sum(ranks[r]["coll_bytes"] for r in range(P)) == jb
    jf = float(jrep.splitlines()[-1].split()[-1])
    for r in range(P):
        row = ranks[r]["report"].splitlines()[-1].split()
        assert row[0] == "blk"
        t, t_min, t_max, t_avg, f_total = map(float, row[1:6])
        assert t_min <= t_avg <= t_max and t_min <= t <= t_max
        assert f_total == jf == 2.0
