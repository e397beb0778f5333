"""The port's memory-sharded adaptive FMM (sctl_tpu_torch.fmm.
adaptive_dist) on 4 gloo rank processes against the JAX package's
AdaptiveFMMDist on a 4-device sub-mesh (tests/test_fmm.py:270-307):
Laplace3D-FxU at p = 6, 64 points a leaf, 3,000 points on the unit
sphere, float64; within 5e-5 of the dense sum, 1e-8 of the port's
single-device AdaptiveFMM and 1e-8 of the JAX AdaptiveFMMDist (the
all-reduced moments reorder the float64 sums, and the pinv operators
amplify that); the skeleton's leaves the host tree's; U-list ghosts on
every rank; each rank's point tables Cb leaf rows, the W and X tables
its own leaves; the double layer with normals (the normal ghosts).
Both packages take the JAX package's cached unit tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_cases as C
from sctl_tpu.comm import Comm as JComm
from sctl_tpu.fmm import AdaptiveFMMDist as JAdaptiveFMMDist
from sctl_tpu.fmm.kifmm import KIFMMOperators as JOperators
from sctl_tpu.ops import Laplace3D_FxU as JL_FxU
from sctl_tpu_torch.comm import Comm, start_ranks
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import (AdaptiveFMM, AdaptiveFMMDist,
                                KIFMMOperators, operators_from_numpy)
from sctl_tpu_torch.ops import (Laplace3D_DxU, Laplace3D_FxU,
                                direct_eval_blocked)

limit_cpu_threads()
P = C.P
F64 = torch.float64


def rel(u, ref):
    return float(np.abs(u - ref).max() / np.abs(ref).max())


def jax_tables(jker, p: int) -> dict:
    """The JAX package's float64 unit tables of translation kernel jker
    at order p (from its table cache) as the port's numpy dict."""
    jo = JOperators(jker, jker, jker, p, 2, 1.0, dtype=jnp.float64)
    t = {k: np.asarray(getattr(jo, k)) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jo._rcond)
    return t


@pytest.fixture(scope="module")
def inputs():
    d = C.adaptive_inputs()
    d["tables"] = jax_tables(JL_FxU, 6)
    return d


@pytest.fixture(scope="module")
def started(inputs):
    """One group of 4 gloo ranks runs every case of the module."""
    return start_ranks(C.adaptive_cases, P, inputs, backend="gloo",
                       device="cpu", timeout=240, threads=1)


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:P]), ("x",))


@pytest.fixture(scope="module")
def jax_dist(started, inputs, mesh4):
    """The JAX AdaptiveFMMDist's potential (while the ranks work)."""
    d = inputs
    return JAdaptiveFMMDist(JL_FxU, JComm.world(mesh4), p=6,
                            max_pts=64).setup(d["xs"], d["xs"]).eval(d["f"])


@pytest.fixture(scope="module")
def ranks(started, jax_dist):
    return started.join()


def _single(inputs, ker, nrm=None):
    d = inputs
    return AdaptiveFMM(ker, p=6, max_pts=64, device="cpu", dtype=F64,
                       operators=operators_from_numpy(
                           d["tables"], "cpu", F64)).setup(
        d["xs"], d["xs"], n_src=nrm)


def _dense(inputs, ker, nrm=None):
    t = lambda a: None if a is None else torch.as_tensor(a)
    d = inputs
    return direct_eval_blocked(ker, t(d["xs"]), t(d["xs"]), t(d["f"]),
                               ns=t(nrm)).numpy()


def test_adaptive_dist_matches(ranks, inputs, jax_dist):
    """Every rank's global potential: 5e-5 of the dense sum, 1e-8 of the
    single-device AdaptiveFMM and of the JAX AdaptiveFMMDist."""
    u1 = _single(inputs, Laplace3D_FxU).eval(inputs["f"])
    ud = _dense(inputs, Laplace3D_FxU)
    assert rel(jax_dist, ud) < 5e-5
    for r in range(P):
        u = ranks[r]["sl"]
        assert rel(u, ud) < 5e-5, (r, rel(u, ud))
        assert rel(u, u1) < 1e-8, (r, rel(u, u1))
        assert rel(u, jax_dist) < 1e-8, (r, rel(u, jax_dist))


def test_skeleton_is_the_host_tree(ranks, inputs):
    """The DistPtTree skeleton every rank adopted has the leaves of the
    single-device refinement."""
    host = _single(inputs, Laplace3D_FxU).tree
    for r in range(P):
        lk, ll = ranks[r]["leaves"]
        assert np.array_equal(lk, host.leaf_keys)
        assert np.array_equal(ll, host.leaf_levels)


def test_ghosts_and_block_tables(ranks):
    """U lists cross the blocks (ghost leaves on every rank); each rank's
    device point tables hold Cb leaf rows, not the tree's n_leaf, and
    the whole tree's point arrays and W / X tables are freed."""
    for r in range(P):
        x = ranks[r]
        n_leaf, Cb = x["n_leaf"], x["Cb"]
        assert x["Crg"] > 0 and x["dl_Crg"] > 0
        assert Cb == -(-n_leaf // P) and Cb < n_leaf
        assert x["rows"] == [Cb] * 4
        assert all(x["freed"])


def test_w_and_x_tables_are_own(ranks, inputs):
    """The W table holds only the rank's own target leaves, the X table
    its own source leaves: local rows inside the block, and the ranks'
    pairs together the single-device tables'."""
    fm = _single(inputs, Laplace3D_FxU)
    n_w = sum(len(w[0]) for w in fm.wpairs.values())
    n_x = sum(len(x[0]) for x in fm.xpairs.values())
    assert n_w > 0 and n_x > 0
    for r in range(P):
        lo, hi = ranks[r]["block"]
        for key in ("w_rows", "x_rows"):
            rows = ranks[r][key]
            assert rows.min() >= 0 and rows.max() < hi - lo
    assert sum(ranks[r]["w_pairs"] for r in range(P)) == n_w
    assert sum(ranks[r]["x_pairs"] for r in range(P)) == n_x


def test_eval_tensor_is_the_block(ranks):
    """eval_tensor gives the rank's block of the global result, and the
    blocks' targets partition the targets."""
    idx = np.concatenate([ranks[r]["trg_index"] for r in range(P)])
    np.testing.assert_array_equal(np.sort(idx), np.arange(len(idx)))
    for r in range(P):
        np.testing.assert_array_equal(
            ranks[r]["local"], ranks[r]["sl"][ranks[r]["trg_index"]])


def test_double_layer_normal_ghosts(ranks, inputs):
    """Laplace3D-DxU with the normals: 1e-8 of the single-device
    AdaptiveFMM and 5e-5 of the dense sum on every rank."""
    xs = inputs["xs"]
    u1 = _single(inputs, Laplace3D_DxU, xs).eval(inputs["f"])
    ud = _dense(inputs, Laplace3D_DxU, xs)
    for r in range(P):
        assert rel(ranks[r]["dl"], u1) < 1e-8
        assert rel(ranks[r]["dl"], ud) < 5e-5


def test_self_comm_is_single_device(inputs):
    """On the self-communicator AdaptiveFMMDist is the single-device
    AdaptiveFMM (one block, no ghosts, no all-reduce) to 1e-13 of the
    maximum: its X contributions are summed apart, then added."""
    d = inputs
    fm = AdaptiveFMMDist(Laplace3D_FxU, Comm.self_(), p=6, max_pts=64,
                         device="cpu", dtype=F64,
                         operators=operators_from_numpy(d["tables"], "cpu",
                                                        F64))
    fm.setup(d["xs"], d["xs"])
    assert fm.Crg == 0 and fm.Cb == fm.n_leaf
    assert rel(fm.eval(d["f"]),
               _single(inputs, Laplace3D_FxU).eval(d["f"])) < 1e-13
