"""The port's profiler against the JAX package's: the facade (blocks,
the level gate, custom fields, the report's layout), the FLOP model of
the KIFMM on the same tree and route, and the counters and report
blocks after the same calls (a KIFMM eval, an adaptive-FMM eval and a
GMRES solve whose operator is a direct sum), FLOPs exact."""

import functools
import io
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctl_tpu
from sctl_tpu.config import config as j_config
from sctl_tpu.fmm import KIFMM as J_KIFMM
from sctl_tpu.fmm.adaptive import AdaptiveFMM as J_Adaptive
from sctl_tpu.fmm.kifmm import KIFMMOperators as J_Ops
from sctl_tpu.linalg import GMRES as J_GMRES
from sctl_tpu.ops import Laplace3D_FxU as J_LAP
from sctl_tpu.ops import direct_eval_blocked as j_direct
from sctl_tpu.profile import Profile as J_Profile
from sctl_tpu.profile import add_comm as j_add_comm
from sctl_tpu.profile import add_flops as j_add_flops
from sctl_tpu_torch import config
from sctl_tpu_torch.config import limit_cpu_threads
from sctl_tpu_torch.fmm import (KIFMM, AdaptiveFMM, KIFMMOperators,
                                operators_from_numpy)
from sctl_tpu_torch.linalg import GMRES
from sctl_tpu_torch.ops import Laplace3D_FxU as LAP
from sctl_tpu_torch.ops import direct_eval_blocked
from sctl_tpu_torch.profile import Profile, add_comm, add_flops

limit_cpu_threads()


@pytest.fixture(autouse=True)
def no_jax_cache_writes(monkeypatch):
    """The JAX package's operator tables stay in memory: nothing is
    written under the data directory."""
    monkeypatch.setattr(J_Ops, "_save_cache", lambda self, path: None)


@pytest.fixture
def level():
    """Both packages' profile level at 5 for the test, then back off."""
    j_config.profile_level = config.profile_level = 5
    J_Profile.reset()
    Profile.reset()
    yield
    j_config.profile_level = config.profile_level = -1
    J_Profile.reset()
    Profile.reset()


def _blocks(report: str):
    """The report's block column, indentation kept, numbers dropped."""
    return [ln[:40].rstrip() for ln in report.splitlines()[2:]]


def _script(P, flops, comm):
    """The JAX package's profiler tests (tests/test_profile.py) as one
    sequence, run through either package's facade."""
    P.tic("outer")
    flops(1e9)
    P.tic("inner")
    flops(5e8)
    comm(2, 1024.0)
    P.toc()
    P.toc()
    P.tic("shown", level=0)
    P.tic("hidden", level=7)
    P.toc()
    P.toc()
    P.set_prof_field("flop_per_byte", lambda d, dt: d.get(
        "FLOP", 0.0) / max(d.get("COLL_BYTES", 0.0), 1.0))
    with P.scoped("blk"):
        flops(100.0)
        comm(1, 10.0, collective=False)
    out = io.StringIO()
    P.print_report(fields=("f", "comm_bytes", "flop_per_byte", "FLOP",
                           "t_min", "f_total"), out=out)
    counters = {k: P.get_counter(k) for k in sctl_tpu.profile.COUNTERS}
    return out.getvalue(), counters


def test_facade_matches_jax(level):
    rj, cj = _script(J_Profile, j_add_flops, j_add_comm)
    rp, cp = _script(Profile, add_flops, add_comm)
    assert cp == cj
    assert _blocks(rp) == _blocks(rj) == [
        "outer", "  inner", "shown", "blk"]
    # every column but t_min (a time) agrees to the digit
    assert [ln[:96] + ln[110:] for ln in rp.splitlines()] == \
        [ln[:96] + ln[110:] for ln in rj.splitlines()]


def test_level_gate_and_xla_cost(tmp_path, level):
    """Blocks above profile_level record nothing (profile.txx:529-533);
    xla_cost counts a product's 2 m n k FLOPs and its tensors' bytes;
    device_trace writes a trace into its directory."""
    config.profile_level = 0
    with Profile.scoped("kept"):
        with Profile.scoped("dropped", level=1):
            pass
    assert _blocks(Profile.print_report(out=io.StringIO())) == ["kept"]
    a, b = torch.ones(6, 4, dtype=torch.float64), torch.ones(4, 5)
    cost = Profile.xla_cost(lambda x, y: x @ y.double(), a, b)
    assert cost == {"flops": 2.0 * 6 * 4 * 5,
                    "bytes": float(6 * 4 * 8 + 4 * 5 * 4 + 6 * 5 * 8)}
    with Profile.device_trace(str(tmp_path / "trace")):
        (a @ a.T).sum()
    assert any(os.scandir(tmp_path / "trace"))


def _tables(jops, p):
    t = {k: getattr(jops, k) for k in KIFMMOperators.TABLES}
    t.update(p=p, rcond=jops._rcond)
    return t


@functools.lru_cache(maxsize=None)
def _kifmm_pair(route):
    """A float64 p = 4 KIFMM in both packages on the JAX package's
    tables (the JAX one with its packed-slab Pallas P2P flag on, whose
    capacities are the port's): depth 3 at about 40 points a box (the
    slab stencil), or depth 2 at about 300 (the halo stencil)."""
    n, depth = {"stencil9": (20000, 3), "stencil": (20000, 2)}[route]
    rng = np.random.default_rng(61)
    xs, xt = rng.random((n, 3)), rng.random((n // 2, 3))
    xs[:400] = 0.01 * xs[:400]                  # overflow boxes
    jk = J_KIFMM(J_LAP, p=4, depth=depth, use_pallas_p2p=True,
                 use_pallas_m2l=False, use_pallas_sl=False).setup(xs, xt)
    ops = operators_from_numpy(_tables(jk._ops, 4), "cpu", torch.float64)
    kf = KIFMM(LAP, p=4, depth=depth, device="cpu", dtype=torch.float64,
               operators=ops).setup(xs, xt)
    assert kf.near_route == route and kf.n_ovf_s and kf.n_ovf_t
    return jk, kf, rng.normal(size=(n, 1))


@pytest.mark.parametrize("route", ["stencil9", "stencil"])
def test_flop_model_matches_jax(route):
    """The port's FLOP model against the JAX package's formula on the
    port's tree: on the slab-stencil route the JAX KIFMM itself (the
    same capacities); on the halo-stencil route the JAX formula read on
    the port's capacities and sidebands with the flags of the JAX halo
    stencil (the JAX package rounds cap_s to 64 off the packed slab,
    the port does not)."""
    jk, kf, _ = _kifmm_pair(route)
    if route == "stencil":
        align = 64 if (1 << kf.depth) % 2 == 0 else 128
        jk = SimpleNamespace(
            _ops=jk._ops, src_tree=kf.src_tree, ker_s2t=jk.ker_s2t,
            ker_s2m=jk.ker_s2m, ker_l2t=jk.ker_l2t, depth=kf.depth,
            use_pallas_p2p=True, _p2p_packed9=False, cap_s=kf.cap_s,
            cap_t=kf.cap_t, stencil_cap=-(-kf.cap_s // align) * align,
            SL=kf.SL, n_ovf_s=kf.n_ovf_s, n_ovf_t=kf.n_ovf_t,
            sov_boxes=kf.sov_boxes, sov_cap=kf.sov_cap,
            tov_boxes=kf.tov_boxes, tov_cap=kf.tov_cap)
    assert kf._flop_model() == J_KIFMM._flop_model(jk) > 0


def test_counters_and_blocks_match_jax(level):
    """The same calls through both packages, profile level 5: the
    counters equal (FLOPs exact) and the report's blocks the same."""
    from sctl_tpu.bie import torus_patches as j_torus
    jk, kf, f = _kifmm_pair("stencil9")
    lst = j_torus(nu=6, nv=3, q=4, R=2.0, r=0.5)
    X, _, _ = lst.get_node_coord()
    Xf, _, _, _, _ = lst.get_far_field_nodes(1e-6)
    ja = J_Adaptive(J_LAP, p=4, max_pts=32,
                    use_pallas_ulist=False).setup(Xf, X)
    aops = operators_from_numpy(_tables(ja._ops, 4), "cpu", torch.float64,
                                ker_trans=LAP)
    pa = AdaptiveFMM(LAP, p=4, max_pts=32, device="cpu",
                     dtype=torch.float64, operators=aops).setup(Xf, X)
    fa = np.random.default_rng(62).normal(size=(len(Xf), 1))
    rng = np.random.default_rng(63)
    y = rng.random((60, 3))
    b = rng.normal(size=60)

    def run(P, kifmm, adaptive, solver, direct, arr):
        P.reset()
        kifmm.eval(f)
        adaptive.eval(fa)
        calls = []

        def A(v):
            calls.append(1)
            u = direct(y, y, v.reshape(-1, 1))
            return v + 0.01 * u.reshape(-1)
        x, iters = solver(A, arr(b), tol=1e-10)
        out = io.StringIO()
        P.print_report(out=out)
        return ({k: P.get_counter(k) for k in sctl_tpu.profile.COUNTERS},
                _blocks(out.getvalue()), len(calls), iters)

    j = run(J_Profile, jk, ja, J_GMRES(),
            lambda a, c, v: j_direct(J_LAP, jnp.asarray(a), jnp.asarray(c),
                                     v), jnp.asarray)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    p = run(Profile, kf, pa, GMRES(),
            lambda a, c, v: direct_eval_blocked(LAP, t(a), t(c), v), t)
    assert p[2:] == j[2:]
    assert p[0] == j[0]
    assert p[0]["FLOP"] == (kf._flop_model()
                            + p[2] * 60.0 * 60.0 * LAP.flops)
    assert p[1] == j[1] == ["KIFMM::Eval", "AdaptiveFMM::Eval", "GMRES"]
