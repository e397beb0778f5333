"""The port's slab-sharded KIFMM (sctl_tpu_torch.fmm.kifmm_dist) and the
ring direct sum on 4 gloo rank processes against the JAX package's on a
4-device sub-mesh: KIFMMDist at depth 3, the single and the double
layer, in float64, within 1e-9 relative of the JAX KIFMMDist (the bound
of test_torch_kifmm.py::test_slice_f64_matches_jax: the pinv operators
amplify rounding) and 5e-4 of a direct sum (the double layer 1e-3, as
tests/test_fmm_dist.py); at depth 4 over the pairs of a split, whose
M2L levels run sharded with their halo planes, against the port's
single-device KIFMM at p = 4 (and a direct sum to 5e-3, p = 4's
accuracy); `eval_direct_ring` within 1e-10 relative of the
JAX package's ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_cases as C
from sctl_tpu.comm import Comm as JComm
from sctl_tpu.fmm.fmm import ParticleFMM as JParticleFMM
from sctl_tpu.fmm.kifmm_dist import KIFMMDist as JKIFMMDist
from sctl_tpu.ops import Laplace3D_DxU as JL_DxU
from sctl_tpu.ops import Laplace3D_FxU as JL_FxU
from sctl_tpu_torch.comm import start_ranks
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import KIFMM
from sctl_tpu_torch.fmm.kifmm_dist import KIFMMDist
from sctl_tpu_torch.ops import (Laplace3D_DxU, Laplace3D_FxU,
                                direct_eval_blocked)

limit_cpu_threads()
P = C.P
F64 = torch.float64


def rel(u, ref):
    return float(np.abs(u - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def inputs():
    return C.kifmm_inputs()


@pytest.fixture(scope="module")
def started(inputs):
    """One group of 4 gloo ranks runs every case of the module."""
    return start_ranks(C.kifmm_cases, P, inputs, backend="gloo",
                       device="cpu", timeout=240, threads=1)


@pytest.fixture(scope="module")
def jax_sides(started, inputs, mesh4):
    """The JAX package's KIFMMDist and ring results (while the ranks
    work)."""
    d = inputs
    out = {}
    for layer, jker, nrm in (("sl", JL_FxU, None), ("dl", JL_DxU, d["nrm"])):
        out[layer] = JKIFMMDist(jker, mesh4, p=6, depth=3).setup(
            d["xs"], d["xt"], n_src=nrm).eval(d["f"])
        ns = None if nrm is None else jnp.asarray(d["ring_nrm"])
        ring = jax.jit(lambda xt, xs, f, ns, jker=jker: JParticleFMM(
            comm=JComm.world(mesh4)).eval_direct_ring(jker, xt, xs, f,
                                                      ns=ns))
        out["ring_" + layer] = np.asarray(ring(
            jnp.asarray(d["ring_xt"]), jnp.asarray(d["ring_xs"]),
            jnp.asarray(d["ring_f"]), ns))
    return out


@pytest.fixture(scope="module")
def ranks(started, jax_sides):
    """The ranks' results."""
    return started.join()


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:P]), ("x",))


def _direct(ker, xt, xs, f, ns=None):
    t = lambda a: None if a is None else torch.as_tensor(a)
    return direct_eval_blocked(ker, t(xt), t(xs), t(f), ns=t(ns)).numpy()


@pytest.mark.parametrize("layer", ["sl", "dl"])
def test_kifmm_dist_matches_jax(ranks, inputs, jax_sides, layer):
    """Every rank's global potential within 1e-9 of the JAX KIFMMDist's
    and of a direct sum to the JAX test's bar."""
    d = inputs
    ker, bar = ((Laplace3D_FxU, 5e-4) if layer == "sl"
                else (Laplace3D_DxU, 1e-3))
    nrm = None if layer == "sl" else d["nrm"]
    uj = jax_sides[layer]
    ref = _direct(ker, d["xt"], d["xs"], d["f"], nrm)
    assert rel(uj, ref) < bar
    for r in range(P):
        assert rel(ranks[r][layer], uj) < 1e-9, (r, rel(ranks[r][layer], uj))
        assert rel(ranks[r][layer], ref) < bar


def test_eval_tensor_is_the_slab(ranks):
    """eval_tensor's output is the rank's slab of the global result, and
    the slabs' targets partition the targets."""
    idx = np.concatenate([ranks[r]["sl_trg_index"] for r in range(P)])
    np.testing.assert_array_equal(np.sort(idx), np.arange(len(idx)))
    for r in range(P):
        np.testing.assert_array_equal(
            ranks[r]["sl_local"], ranks[r]["sl"][ranks[r]["sl_trg_index"]])
        assert tuple(ranks[r]["sl_route"]) == (True, 4)


def test_kifmm_dist_sharded_levels(ranks, inputs):
    """Depth 4 over 2 ranks (levels 3 and 4 sharded, the M2L halo
    exchanged) against the port's single-device KIFMM in float64 and a
    direct sum."""
    d = inputs
    u1 = KIFMM(Laplace3D_FxU, p=4, depth=4, device="cpu", dtype=F64).setup(
        d["xs"], d["xs"]).eval(d["f"])
    ref = _direct(Laplace3D_FxU, d["xs"], d["xs"], d["f"])
    for r in range(P):
        assert int(ranks[r]["d4_shard_min"]) == 3
        assert rel(ranks[r]["d4"], u1) < 1e-9
        assert rel(ranks[r]["d4"], ref) < 5e-3


def test_self_comm_matches_single_device(inputs):
    """On the self-communicator KIFMMDist is the single-device KIFMM's
    evaluation (in float64, to the pinv-amplified rounding: 1e-9)."""
    d = inputs
    u = KIFMMDist(Laplace3D_FxU, None, p=4, depth=3, device="cpu",
                  dtype=F64).setup(d["xs"], d["xt"]).eval(d["f"])
    u1 = KIFMM(Laplace3D_FxU, p=4, depth=3, device="cpu", dtype=F64).setup(
        d["xs"], d["xt"]).eval(d["f"])
    assert rel(u, u1) < 1e-9


@pytest.mark.parametrize("layer", ["sl", "dl"])
def test_eval_direct_ring_matches_jax(ranks, jax_sides, layer):
    """The ring direct sum: rank r's block within 1e-10 of the JAX
    package's ring over the 4-device sub-mesh."""
    uj = jax_sides["ring_" + layer]
    m = len(uj) // P
    got = np.concatenate([ranks[r]["ring_" + layer] for r in range(P)])
    assert rel(got, uj) < 1e-10
    assert got.shape == uj.shape and m * P == len(got)


def test_eval_direct_ring_self_comm(inputs):
    """On the self-communicator the ring is the blocked direct sum."""
    from sctl_tpu_torch.fmm import ParticleFMM
    d = inputs
    t = torch.as_tensor
    u = ParticleFMM(device="cpu", dtype=F64).eval_direct_ring(
        Laplace3D_FxU, t(d["ring_xt"]), t(d["ring_xs"]), t(d["ring_f"]))
    np.testing.assert_array_equal(u.numpy(), _direct(
        Laplace3D_FxU, d["ring_xt"], d["ring_xs"], d["ring_f"]))
