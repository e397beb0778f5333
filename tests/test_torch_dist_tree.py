"""The port's distributed tree (sctl_tpu_torch.tree.dist_tree) and the
work-sharded adaptive FMM on 4 gloo rank processes against the JAX
package's on a 4-device sub-mesh and against the host trees: the
leaves exactly (tests/test_tree.py:124-210), the named node-data
exchange, `AdaptiveFMM.eval_sharded` within 1e-10 of the maximum of the
single-device eval (tests/test_fmm_dist.py:72-94), and
`AdaptiveFMM.setup(skeleton=)` on a DistPtTree skeleton."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps

import torch_dist_cases as C
from sctl_tpu.comm import Comm as JComm
from sctl_tpu.tree.dist_tree import DistPtTree as JDistPtTree
from sctl_tpu.tree.tree import PtTree as JPtTree
from sctl_tpu_torch.comm import start_ranks
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm.adaptive import AdaptiveFMM
from sctl_tpu_torch.ops import Laplace3D_FxU
from sctl_tpu_torch.tree.dist_tree import DistPtTree
from sctl_tpu_torch.tree.tree import PtTree

limit_cpu_threads()
P = C.P


@pytest.fixture(scope="module")
def inputs():
    return C.tree_inputs()


@pytest.fixture(scope="module")
def started(inputs):
    """One group of 4 gloo ranks runs every case of the module."""
    return start_ranks(C.tree_cases, P, inputs, backend="gloo",
                       device="cpu", timeout=240, threads=1)


@pytest.fixture(scope="module")
def jax_sides(started, inputs, mesh4):
    """The JAX package's trees and sharded eval (while the ranks work)."""
    from sctl_tpu.fmm.adaptive import AdaptiveFMM as JAdaptive
    from sctl_tpu.ops import Laplace3D_FxU as JL
    xs, f = inputs["sphere"], inputs["sphere_f"]
    return {"leaves": {b: _jax_leaves(mesh4, inputs["X"], 64, 6, b)
                       for b in (False, True)},
            "sharded": JAdaptive(JL, p=4, max_pts=40).setup(xs, xs)
            .eval_sharded(f, mesh4)}


@pytest.fixture(scope="module")
def ranks(started, jax_sides):
    """The ranks' results."""
    return started.join()


@pytest.fixture(scope="module")
def single(inputs):
    """The single-device adaptive FMM on the sphere and its eval."""
    xs, f = inputs["sphere"], inputs["sphere_f"]
    fmm = AdaptiveFMM(Laplace3D_FxU, p=4, max_pts=40, device="cpu",
                      dtype=torch.float64).setup(xs, xs)
    return fmm, fmm.eval(f)


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:P]), ("x",))


def _jax_leaves(mesh, X, max_pts, max_level, balance):
    comm = JComm.world(mesh)
    C_ = len(X) // P
    tree = JDistPtTree(comm, leaf_cap=4096, pt_cap=2 * C_,
                       max_level=max_level)
    fn = tree.build_fn(max_pts=max_pts, balance21=balance)
    Xd = jax.device_put(jnp.asarray(X), NamedSharding(mesh, Ps("x", None)))
    cnt = jax.device_put(jnp.full((P,), C_, jnp.int32),
                         NamedSharding(mesh, Ps("x")))
    lk, ll, nl, Xs, oc = jax.jit(comm.run(
        lambda Xl, c: fn(Xl, c[0]), in_specs=(Ps("x", None), Ps("x")),
        out_specs=(Ps(), Ps(), Ps("x"), Ps("x", None), Ps("x"))))(Xd, cnt)
    n = int(np.asarray(nl)[0])
    return (np.asarray(lk)[:n], np.asarray(ll)[:n],
            np.asarray(Xs).reshape(P, 2 * C_, 3), np.asarray(oc))


@pytest.mark.parametrize("balance", [False, True])
def test_dist_tree_leaves(ranks, inputs, jax_sides, balance):
    """Every rank's skeleton is the JAX DistPtTree's and the host
    PtTree's (port and JAX) leaf set, keys and levels exactly."""
    X = inputs["X"]
    host = PtTree(3).update_refinement(X, 64, balance21=balance,
                                       max_level=6)
    jhost = JPtTree(dim=3).update_refinement(X, max_pts=64,
                                             balance21=balance, max_level=6)
    jk, jl, _, _ = jax_sides["leaves"][balance]
    np.testing.assert_array_equal(jk, jhost.leaf_keys)
    for r in range(P):
        lk, ll = ranks[r][f"leaves_{balance}"]
        np.testing.assert_array_equal(lk.astype(np.uint64), jk)
        np.testing.assert_array_equal(ll, jl)
        np.testing.assert_array_equal(lk.astype(np.uint64), host.leaf_keys)
        np.testing.assert_array_equal(ll, host.leaf_levels)


@pytest.mark.parametrize("balance", [False, True])
def test_dist_tree_sorted_points(ranks, jax_sides, balance):
    """Each rank's sorted points are the JAX package's block: the sample
    sort's partition, rebalanced."""
    _, _, jXs, joc = jax_sides["leaves"][balance]
    for r in range(P):
        Xs, oc = ranks[r][f"sorted_{balance}"]
        assert int(oc) == int(joc[r])
        np.testing.assert_array_equal(Xs, jXs[r, :int(oc)])


def test_reduce_broadcast_and_broadcast(ranks, inputs):
    """Per-leaf counts from the sharded points reduce to the host tree's
    leaf counts on every rank (tree.txx:547); the owner-masked broadcast
    gives each leaf its owner's value (tree.txx:668)."""
    host = PtTree(3).update_refinement(inputs["Xc"], 32, max_level=5)
    for r in range(P):
        np.testing.assert_array_equal(ranks[r]["counts"], host.leaf_cnt)
        b = ranks[r]["bcast"]
        i = np.arange(len(b))
        np.testing.assert_array_equal(b, i * (i % P + 1))


def test_eval_sharded_matches_single(ranks, single):
    """eval_sharded over 4 ranks, and over each pair of a split, within
    1e-10 of the maximum of the single-device eval."""
    u1 = single[1]
    scale = np.abs(u1).max()
    for r in range(P):
        for key in ("sharded", "sharded_pair"):
            assert np.abs(ranks[r][key] - u1).max() < 1e-10 * scale, key


def test_eval_sharded_matches_jax(ranks, jax_sides):
    """The port's sharded eval against the JAX package's eval_sharded on
    the 4-device sub-mesh, within 1e-10 of the maximum."""
    uj = jax_sides["sharded"]
    scale = np.abs(uj).max()
    for r in range(P):
        assert np.abs(ranks[r]["sharded"] - uj).max() < 1e-10 * scale


def test_setup_on_dist_skeleton(ranks, single, inputs):
    """DistPtTree over the adaptive FMM's normalization (bbox=), 2:1
    balanced, gives the leaves of the FMM's own refinement on every
    rank, and setup(skeleton=) adopts them: the same evaluation."""
    fmm, u1 = single
    for r in range(P):
        lk, ll = ranks[r]["skeleton_leaves"]
        np.testing.assert_array_equal(lk.astype(np.uint64),
                                      fmm.tree.leaf_keys)
        np.testing.assert_array_equal(ll, fmm.tree.leaf_levels)
    lk, ll = ranks[0]["skeleton_leaves"]
    xs, f = inputs["sphere"], inputs["sphere_f"]
    sk = AdaptiveFMM(Laplace3D_FxU, p=4, max_pts=40, device="cpu",
                     dtype=torch.float64).setup(
        xs, xs, skeleton=(lk.astype(np.uint64), ll))
    np.testing.assert_array_equal(sk.eval(f), u1)


def test_self_comm_tree_matches_jax(inputs):
    """On the self-communicator DistPtTree is the JAX Comm()'s."""
    from sctl_tpu_torch.comm import Comm
    X = inputs["X"][:512]
    lk, ll, nl, _, oc = DistPtTree(Comm.self_(), 4096, 1024, max_level=6) \
        .build_fn(32, balance21=True)(torch.as_tensor(X), len(X))
    jlk, jll, jnl, _, joc = jax.jit(
        JDistPtTree(JComm(), 4096, 1024, max_level=6).build_fn(
            32, balance21=True))(jnp.asarray(X), jnp.int32(len(X)))
    n = int(np.asarray(jnl)[0])
    assert nl == n and oc == int(np.asarray(joc)[0])
    np.testing.assert_array_equal(lk[:nl].numpy().astype(np.uint64),
                                  np.asarray(jlk)[:n])
    np.testing.assert_array_equal(ll[:nl].numpy(), np.asarray(jll)[:n])
