"""The port's distributed BIE (sctl_tpu_torch.bie.dist and
BoundaryIntegralOp(comm=)) on 4 gloo rank processes, float64, the
counterparts of tests/test_bie.py:247-450 (the spheres at q = 4): the
direct regime's sharded apply within 1e-10 of the single-process apply
and of the JAX package's sharded apply on a 4-device sub-mesh, a sharded
`gmres_device(comm=)` solve within 1e-6 of the single-process one at the
JAX sharded solve's iteration count; the FMM regime (`AdaptiveFMMDist`
far field, cutoff 1000) within 1e-8 of both; the distributed near search's pairs
the host search's and the JAX `build_near_list_fn`'s (under the JAX
op's capacity growth), also after growing from 1/64 of its capacities;
`setup(comm=)` within 1e-11 of the host-search op; a Stokes3D-DxU
FMM-regime case on the 6 x 3 torus (device near engine) within 1e-8.  The far FMMs take the JAX package's
cached unit tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_cases as C
from sctl_tpu.bie import BoundaryIntegralOp as J_Op
from sctl_tpu.bie import sphere_patches as j_sphere
from sctl_tpu.comm import Comm as JComm
from sctl_tpu.fmm.kifmm import KIFMMOperators as JOperators
from sctl_tpu.linalg import gmres as j_gmres
from sctl_tpu.ops import Laplace3D_DxU as J_LDXU
from sctl_tpu.ops import Laplace3D_FxU as J_LFXU
from sctl_tpu.ops import Stokes3D_DxU as J_SDXU
from sctl_tpu.ops import Stokes3D_FSxU as J_SFSXU
from sctl_tpu_torch.bie import BoundaryIntegralOp
from sctl_tpu_torch.comm import Comm, start_ranks
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMMOperators
from sctl_tpu_torch.ops import Laplace3D_DxU, Laplace3D_FxU, \
    direct_eval_blocked

limit_cpu_threads()
P = C.P
F64 = torch.float64


def rel(u, ref):
    u, ref = np.asarray(u), np.asarray(ref)
    return float(np.abs(u - ref).max() / np.abs(ref).max())


def jax_tables(jker_s2t, jker_trans, p: int) -> dict:
    """The JAX package's float64 unit tables (from its table cache) as
    the port's numpy dict."""
    jo = JOperators(jker_s2t, jker_trans, jker_trans, p, 2, 1.0,
                    dtype=jnp.float64)
    t = {k: np.asarray(getattr(jo, k)) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jo._rcond)
    return t


def point_source_rhs(X, src):
    """The Laplace field of a unit charge at src on the nodes X."""
    t = torch.as_tensor
    return direct_eval_blocked(Laplace3D_FxU, t(X), t(src),
                               torch.ones((1, 1), dtype=F64))[:, 0].numpy()


@pytest.fixture(scope="module")
def inputs():
    d = C.bie_inputs()
    d["tables"] = {"Laplace3D-FxU": jax_tables(J_LFXU, J_LFXU, 6),
                   "Stokes3D-FSxU": jax_tables(J_SDXU, J_SFSXU, 4)}
    return d


@pytest.fixture(scope="module")
def started(inputs):
    """One group of 4 gloo ranks runs every case of the module."""
    return start_ranks(C.bie_cases, P, inputs, backend="gloo",
                       device="cpu", timeout=300, threads=1)


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:P]), ("x",))


@pytest.fixture(scope="module")
def jax_sides(started, inputs, mesh4):
    """The JAX package's sharded apply and solve in the direct regime,
    its sharded apply in the FMM regime, and its distributed near search
    (`build_near_list_fn` under its capacity growth) on the
    sphere_patches(2) geometry (while the ranks work)."""
    d = inputs
    comm = JComm.world(mesh4)
    out = {}
    jop = J_Op(J_LDXU)
    jop.set_accuracy(1e-7)
    jop.add_elem_list(j_sphere(n_per_face=1, q=4))
    jop.setup()
    sh = jop.sharded_apply(comm)
    apply_sh = sh.jit_apply()
    out["direct"] = sh.unpack(apply_sh(sh.pack(d["sigma1"])))
    bc = point_source_rhs(jop.X, d["src"])
    _, it = j_gmres(lambda s: apply_sh(s).reshape(-1) - 0.5 * s,
                    sh.pack(bc), tol=1e-8, max_iter=60)
    out["iters"] = int(it)

    # the FMM regime (tests/test_bie.py:300-325): AdaptiveFMMDist far field
    jop2 = J_Op(J_LDXU)
    jop2.set_accuracy(C.BIE_TOL2)
    jop2.far_fmm_cutoff = 1000
    jop2.add_elem_list(j_sphere(n_per_face=2, q=4))
    jop2.setup()
    sh2 = jop2.sharded_apply(comm)
    assert sh2._fmm is not None
    out["fmm"] = sh2.unpack(sh2.jit_apply()(sh2.pack(d["sigma2"])))

    # the JAX package's distributed search with its capacity growth
    # (boundary_integral.py:277-358) on this geometry, from the fields it
    # reads
    lst = C.sphere2()
    jnear = J_Op(J_LDXU)
    jnear.Xt_eff = lst.get_node_coord()[0]
    jnear.Xf, _, _, jnear.df, jnear.far_cnt = lst.get_far_field_nodes(
        C.BIE_TOL2)
    jnear._build_near_list_dist(comm)
    out["pairs"] = set(jnear.near_pairs)
    return out


@pytest.fixture(scope="module")
def ranks(started, jax_sides):
    return started.join()


def test_direct_regime_matches(ranks, jax_sides):
    """sphere_patches(1): the far field by each rank's direct sums; every
    rank's gathered apply within 1e-10 of the single-process apply and
    of the JAX sharded apply."""
    for x in ranks:
        assert not x["direct_fmm"]
        assert rel(x["direct_sh"], x["direct_1"]) < 1e-10
        assert rel(x["direct_sh"], jax_sides["direct"]) < 1e-10
    assert sum(x["n_own"] for x in ranks) == len(ranks[0]["direct_1"])


def test_sharded_solve(ranks, jax_sides):
    """The second-kind Dirichlet solve, row-sharded through
    gmres_device(comm=): within 1e-6 of the single-process solve, at the
    JAX sharded solve's iteration count."""
    for x in ranks:
        assert x["it_sh"] == jax_sides["iters"] == x["it_1"]
        assert np.abs(x["x_sh"] - x["x_1"]).max() \
            < 1e-6 * np.abs(x["x_1"]).max()


def test_fmm_regime_matches(ranks, jax_sides):
    """sphere_patches(2), far_fmm_cutoff 1000: the far field through
    AdaptiveFMMDist (U-list ghosts on some rank) within 1e-8 of the
    single-process apply and of the JAX sharded apply."""
    assert max(x["fmm_Crg"] for x in ranks) > 0
    for x in ranks:
        assert rel(x["fmm_sh"], x["fmm_1"]) < 1e-8
        assert rel(x["fmm_sh"], jax_sides["fmm"]) < 1e-8


def test_near_search_pairs(ranks, jax_sides):
    """The distributed near search: the host search's pair set (in its
    order) and the JAX build_near_list_fn's."""
    for x in ranks:
        np.testing.assert_array_equal(x["dist_pairs"], x["host_pairs"])
        assert set(map(tuple, x["dist_pairs"].tolist())) \
            == jax_sides["pairs"]


def test_near_search_grows(ranks):
    """From 1/64 of the initial capacities the search grows them (at
    least one round) and finds the same pairs."""
    for x in ranks:
        assert x["grown"] >= 1
        np.testing.assert_array_equal(x["grown_pairs"], x["host_pairs"])


def test_setup_comm_is_production_path(ranks):
    """setup(comm=): the distributed search and the block-shared
    assembly give every rank the host-search op's potentials to
    1e-11."""
    for x in ranks:
        assert rel(x["dist_u"], x["host_u"]) < 1e-11


def test_stokes_torus_fmm_regime(ranks):
    """Stokes3D-DxU on the 6 x 3 torus (q = 4, tol 1e-4, far FMM at
    p = 4 from 100 far nodes), set up over the ranks with the device
    near engine: the sharded apply within 1e-8 of the op's own."""
    assert max(x["stokes_Crg"] for x in ranks) > 0
    for x in ranks:
        assert rel(x["stokes_sh"], x["stokes_1"]) < 1e-8


def test_self_comm_takes_the_host_search():
    """With the self-communicator setup(comm=) is the host search, and
    the sharded apply is the op's own."""
    op = BoundaryIntegralOp(Laplace3D_DxU, comm=Comm.self_(), device="cpu",
                            dtype=F64)
    op.set_accuracy(1e-7)
    op.add_elem_list(C.sphere1())
    op.use_device_near = False
    op.setup()
    assert not hasattr(op, "_near_caps_grown")
    sigma = np.random.default_rng(4).normal(size=op.dim(0))
    sh = op.sharded_apply(Comm.self_())
    assert rel(sh.unpack(sh.apply(sh.pack(sigma))),
               op.compute_potential(sigma)) < 1e-14
