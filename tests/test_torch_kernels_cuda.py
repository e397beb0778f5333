"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same card, at the widths of a depth-4 KIFMM
filled as densely as the 1e7-point depth-6 run (about 38 points a
leaf), with a reduced count (sctl_tpu_torch/kernel_cases.py), and every
further formula of the shared-surface and slab kernels at those widths;
the p=8 path's kernels (the grid M2L `m2l_grid` and the halo stencil
`p2p_stencil`, all six tree formulas) at the widths of a depth-4 p=8
KIFMM as densely filled as ParticleFMM(accuracy=8) at 1e7 points
(about 305 points a leaf); the U-list kernel at the widths of an
adaptive FMM on a torus's far-field nodes, for the six formulas with a
tree path, in its float32 and float64 builds (the float64 one also at
ragged widths, without counts or index, on the padded form, repeated
bit for bit, refusing mixed types, and launched by AdaptiveFMM and
BoundaryIntegralOp set up in float64 on the card); the direct sum
`p2p` for all eight formulas in float32 and float64, also at few
targets and at as many targets as sources, with its float64 rsqrt held
to 4 ulp; the slab stencil `p2p_stencil9` on
compacted slabs at ragged widths and counts and at its widest block;
the shared-surface kernels `surface_pair` and `l2t_surface` over each
box's real slots by per-box counts, for every formula at p = 6 and 8,
at the wide capacities of phase 7 and of depth-3 trees, at 128 and
32,768 boxes, repeated bit for bit; KIFMMs on the card against the
CPU: p=6 and p=8 at depth 4, a depth-2 one, whose near field runs
through the halo stencil, and a Stokes double layer.  The float64
builds of the four kernels the float64 KIFMM runs (`surface_pair`,
`l2t_surface`, `p2p_stencil9`, `p2p_stencil`) against their plain
versions in float64 at 1e-12 of the maximum, for every formula at
ragged widths with boxes of no point and at their caps, repeated bit
for bit, their layouts, mixed types refused; and the float64 KIFMM and
ParticleFMM on the card against the CPU.  The spectral layer (spherical
harmonic transforms at p = 32, the FFT facade, the Stokes potentials on
the sphere, SDC) on the card against the CPU in float64 at 1e-12 of
the maximum (KL 1e-11), and the Stokes potentials at p = 16 against
direct sums through the float64 p2p.  The distributed layer: one NCCL
rank against the self-communicator, and the U-list blocks of a 4-rank
AdaptiveFMMDist, whose sources include other ranks' leaves.

They need an NVIDIA card and skip elsewhere; the card is looked for in
a fixture, never at import.  This file imports no JAX, so it runs on
the card's host without the JAX package's test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The f32 bar is 1e-5 of the maximum: the kernels sum in another order
than the plain versions, and rsqrtf differs from torch.rsqrt by about
2 ulp.  The two M2L kernels run f32 as three TF32 passes on the tensor
cores; they are also held against a float64 evaluation of the same
inputs, where their error may be at most twice the float32 plain
version's: at levels 3 to 6 of the p=6 run's blocked stack and the p=8
run's grid stack, with the split of the K range into partial sums as
the wrappers choose it and with none (one partial sum; against the
plain version only: a block's sum over more than 256 stages is what
the split avoids), the h = 8 case, a ragged shape of each, and a
repeat of one launch bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KERNELS = ["surface_pair", "l2t_surface", "m2l_grid_blocked",
           "p2p_stencil9"]
ULIST = ["Laplace3D-FxU", "Laplace3D-DxU", "Laplace3D-FxdU",
         "Stokes3D-FxU", "Stokes3D-DxU", "Stokes3D-FSxU"]
ALL = ULIST[:5] + ["Stokes3D-FxT", "Stokes3D-FSxU", "Stokes3D-FxUP"]
# each further formula of the PR-4 pair kernels (csrc/ukernels.cuh)
FORMULAS = ([f"surface_pair[{k}]" for k in ("Laplace3D-DxU", "Stokes3D-FxU",
                                            "Stokes3D-DxU", "Stokes3D-FSxU")]
            + [f"l2t_surface[{k}]" for k in ("Laplace3D-FxdU",
                                             "Stokes3D-FSxU")]
            + [f"p2p_stencil9[{k}]" for k in ULIST[1:]])


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() "
                    "is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kf6(cuda_device):
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU
    x = np.random.default_rng(3).random((16 ** 3 * 38, 3))
    return KIFMM(Laplace3D_FxU, p=6, depth=4, device=cuda_device,
                 dtype=torch.float32).setup(x, x)


@pytest.fixture(scope="module")
def cases(kf6):
    from sctl_tpu_torch.kernel_cases import kernel_cases
    return kernel_cases(kf6)


# the kernels of the p=8 path (ParticleFMM(accuracy=8))
KERNELS8 = ["surface_pair", "l2t_surface", "m2l_grid", "p2p_stencil"]


@pytest.fixture(scope="module")
def kf8(cuda_device):
    """A p=8 KIFMM at depth 4 with about 305 points a leaf, so that its
    routes are the grid M2L and the halo stencil."""
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU
    x = np.random.default_rng(4).random((16 ** 3 * 305, 3))
    kf = KIFMM(Laplace3D_FxU, p=8, depth=4, device=cuda_device,
               dtype=torch.float32).setup(x, x)
    assert kf._ops.m2l_route == "grid" and kf.near_route == "stencil"
    return kf


@pytest.mark.parametrize("name", KERNELS8)
def test_p8_kernel_matches_plain(kf8, name):
    from sctl_tpu_torch.kernel_cases import kernel_cases, rel_max_err
    run, plain, _, _ = kernel_cases(kf8)[name]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < 1e-5


@pytest.mark.parametrize("name", ULIST)
def test_p2p_stencil_formula_matches_plain(kf8, name):
    from sctl_tpu_torch.kernel_cases import formula_cases, rel_max_err
    run, plain, _, _ = formula_cases(kf8, stages=("p2p_stencil",))[
        f"p2p_stencil[{name}]"]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < 1e-5


@pytest.fixture(scope="module")
def formulas(cuda_device):
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.kernel_cases import formula_cases
    from sctl_tpu_torch.ops import Laplace3D_FxU
    x = np.random.default_rng(3).random((16 ** 3 * 38, 3))
    kf = KIFMM(Laplace3D_FxU, p=6, depth=4, device=cuda_device,
               dtype=torch.float32).setup(x, x)
    return formula_cases(kf)


@pytest.mark.parametrize("name", FORMULAS)
def test_formula_matches_plain(formulas, name):
    from sctl_tpu_torch.kernel_cases import rel_max_err
    run, plain, _, _ = formulas[name]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < 1e-5


@pytest.fixture(scope="module")
def direct(cuda_device):
    from sctl_tpu_torch.kernel_cases import p2p_cases
    return p2p_cases(cuda_device, n_trg=1000, n_src=5000)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", ALL)
def test_p2p_matches_plain(direct, name, dtype):
    """The direct sum against its plain version: 1e-5 of the maximum in
    float32 (as above), 1e-12 in float64 (the kernel's rsqrt within a
    few ulp, the sums in another order)."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    run, plain, _, _ = direct[f"p2p[{name},{dtype}]"]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < (1e-5 if dtype == "f32" else 1e-12)


def test_direct_eval_blocked_launches_p2p(cuda_device):
    """On a card the direct sum is the kernel: one launch per call."""
    from sctl_tpu_torch.ops import Stokes3D_DxU, direct_eval_blocked
    from sctl_tpu_torch.ops.p2p import p2p
    x = torch.rand((300, 3), device=cuda_device)
    n = torch.nn.functional.normalize(torch.rand((300, 3),
                                                 device=cuda_device), dim=1)
    f = torch.rand((300, 3), device=cuda_device)
    p2p.launches = 0
    direct_eval_blocked(Stokes3D_DxU, x, x, f, ns=n)
    assert p2p.launches == 1


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain(cases, name):
    from sctl_tpu_torch.kernel_cases import rel_max_err
    run, plain, _, _ = cases[name]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < 1e-5


def test_float64_on_card_raises(cuda_device):
    """float64 tensors mixed with float32 ones, and float16 ones, raise
    before any launch: a kernel has a float32 and a float64 build, one
    type for every float tensor (float64 alone launches the float64
    build: the `_f64` tests below)."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.sl import surface_pair
    surf = torch.zeros((152, 3), dtype=torch.float64, device=cuda_device)
    pts = torch.zeros((3, 128 * 8), dtype=torch.float64,
                      device=cuda_device)
    f = torch.zeros((1, 128 * 8), dtype=torch.float32, device=cuda_device)
    n = surface_pair.launches
    with pytest.raises(NotImplementedError):
        surface_pair(Laplace3D_FxU, surf, pts, f, 8)
    with pytest.raises(NotImplementedError):
        surface_pair(Laplace3D_FxU, surf.half(), pts.half(), f.half(), 8)
    assert surface_pair.launches == n


@pytest.mark.parametrize("p,route", [(6, "blocked"), (8, "grid")])
def test_kifmm_card_matches_cpu(cuda_device, p, route):
    """The whole slice at depth 4, f32: the card (CUDA kernels) against
    the CPU (plain versions) on the same tables, at p=6 (the blocked
    M2L) and p=8 (the grid M2L).  The bar is the f32 route's: rounding
    differences are amplified by the pinv operators (rcond 3e-5), as
    between the JAX package's f32 routes."""
    from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators
    from sctl_tpu_torch.ops import Laplace3D_FxU
    rng = np.random.default_rng(5)
    x = rng.random((40_000, 3))
    f = rng.normal(size=(40_000, 1))
    cpu = KIFMM(Laplace3D_FxU, p=p, depth=4, device="cpu",
                dtype=torch.float32).setup(x, x)
    tables = {k: getattr(cpu._ops, k) for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(Laplace3D_FxU, p, cpu.rcond, cuda_device,
                         torch.float32, tables=tables)
    card = KIFMM(Laplace3D_FxU, p=p, depth=4, device=cuda_device,
                 dtype=torch.float32, operators=ops).setup(x, x)
    assert card._ops.m2l_route == route
    u_cpu, u_card = cpu.eval(f), card.eval(f)
    assert np.abs(u_card - u_cpu).max() / np.abs(u_cpu).max() < 2e-4


@pytest.fixture(scope="module")
def ulist(cuda_device):
    from sctl_tpu_torch.bie import torus_patches
    from sctl_tpu_torch.fmm import AdaptiveFMM
    from sctl_tpu_torch.kernel_cases import ulist_cases
    from sctl_tpu_torch.ops import Stokes3D_DxU
    lst = torus_patches(nu=24, nv=10, q=6)
    X, _, _ = lst.get_node_coord()
    Xf, Xnf, _, _, _ = lst.get_far_field_nodes(1e-6)
    af = AdaptiveFMM(Stokes3D_DxU, p=4, device=cuda_device,
                     dtype=torch.float32).setup(Xf, X, Xnf)
    return ulist_cases(af)


@pytest.mark.parametrize("name", ULIST)
def test_p2p_ulist_matches_plain(ulist, name):
    from sctl_tpu_torch.kernel_cases import rel_max_err
    run, plain, _, _ = ulist[name]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < 1e-5


@pytest.mark.parametrize("name", ULIST)
def test_p2p_ulist_f64_matches_plain(ulist, name):
    """The float64 build at the far FMM's widths: 1e-12 of the maximum
    against the plain version in float64 (the lean double rsqrt is
    within a few ulp; the sums run in another order)."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops.p2p import p2p_ulist
    run, plain, _, work = ulist[name + "[f64]"]
    n = p2p_ulist.launches_f64
    out = run()
    torch.cuda.synchronize()
    assert out.dtype == torch.float64 and work["f64"]
    assert p2p_ulist.launches_f64 == n + 1
    assert rel_max_err(out, plain()) < 1e-12


def test_kifmm_depth2_card_matches_cpu(cuda_device):
    """Depth 2 on the card (S2M and L2T through the U-list kernel and,
    at about 300 points a box, the near field through the halo
    stencil) against the CPU's plain versions on the same tables; bar
    2e-4, as above."""
    from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators
    from sctl_tpu_torch.ops import Laplace3D_FxU
    rng = np.random.default_rng(8)
    x = rng.random((20_000, 3))
    f = rng.normal(size=(20_000, 1))
    cpu = KIFMM(Laplace3D_FxU, p=6, depth=2, device="cpu",
                dtype=torch.float32).setup(x, x)
    tables = {k: getattr(cpu._ops, k) for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(Laplace3D_FxU, 6, cpu.rcond, cuda_device,
                         torch.float32, tables=tables)
    card = KIFMM(Laplace3D_FxU, p=6, depth=2, device=cuda_device,
                 dtype=torch.float32, operators=ops).setup(x, x)
    assert not card.surface_route and card.near_route == "stencil"
    u_cpu, u_card = cpu.eval(f), card.eval(f)
    assert np.abs(u_card - u_cpu).max() / np.abs(u_cpu).max() < 2e-4


def test_kifmm_stokes_dxu_card_matches_cpu(cuda_device):
    """The Stokes double layer at depth 3 (S2M with the slots' normals,
    FSxU translations, the per-parity M2L sweep, the slab stencil with
    normals) on the card against the CPU's plain versions on the same
    tables; bar 2e-4, as above."""
    from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators
    from sctl_tpu_torch.ops import Stokes3D_DxU, Stokes3D_FSxU
    rng = np.random.default_rng(9)
    x = rng.random((20_000, 3))
    n = rng.normal(size=(20_000, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    f = rng.normal(size=(20_000, 3))
    cpu = KIFMM(Stokes3D_DxU, p=4, depth=3, device="cpu",
                dtype=torch.float32).setup(x, x, n_src=n)
    tables = {k: getattr(cpu._ops, k) for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(Stokes3D_FSxU, 4, cpu.rcond, cuda_device,
                         torch.float32, tables=tables)
    card = KIFMM(Stokes3D_DxU, p=4, depth=3, device=cuda_device,
                 dtype=torch.float32, operators=ops).setup(x, x, n_src=n)
    assert card.surface_route and card.near_route == "stencil9"
    u_cpu, u_card = cpu.eval(f), card.eval(f)
    assert np.abs(u_card - u_cpu).max() / np.abs(u_cpu).max() < 2e-4


# ---- the two M2L kernels on the tensor cores (3xTF32) ----------------

def _grid_input(n_side, margin, width, seed):
    """A zero-margin grid with a random interior, on the card."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n_side + 2 * margin,) * 3 + (width,), np.float32)
    q[margin:-margin, margin:-margin, margin:-margin] = rng.normal(
        size=(n_side,) * 3 + (width,))
    return torch.as_tensor(q, device="cuda")


def _check_m2l(out, plain, qp, mats, f64=True):
    """out against the plain version (1e-5 of the maximum) and, with
    f64, against a float64 evaluation: at most twice the float32 plain
    version's error."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    ref = plain(qp, mats)
    assert rel_max_err(out, ref) < 1e-5
    if f64:
        r64 = plain(qp.double(), mats.double())
        assert rel_max_err(out, r64) <= 2 * rel_max_err(ref, r64)


@pytest.mark.parametrize("split", ["auto", "off"])
@pytest.mark.parametrize("h", [4, 8, 16, 32])
def test_m2l_grid_blocked_levels(kf6, h, split):
    """The blocked kernel at levels 3 to 6 of the p=6 run (parent grids
    h = 4 to 32, K = 1024, N = 576) with the run's own stack."""
    from sctl_tpu_torch.ops.m2l import (m2l_grid_blocked,
                                        m2l_grid_blocked_plain)
    ops = kf6._ops
    qp = _grid_input(h, 1, ops.m2l_blk.shape[1], h)
    out = m2l_grid_blocked(qp, ops.m2l_blk, ops.m2l_blk_tc,
                           nsplit=None if split == "auto" else 1)
    torch.cuda.synchronize()
    _check_m2l(out, m2l_grid_blocked_plain, qp, ops.m2l_blk,
               f64=split == "auto")


@pytest.mark.parametrize("split", ["auto", "off"])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_m2l_grid_levels(kf8, n, split):
    """`m2l_grid` at levels 3 to 5 of the p=8 run (the caps r = 80,
    r2 = 256) with the run's own stack."""
    from sctl_tpu_torch.ops.m2l import m2l_grid, m2l_grid_plain
    ops = kf8._ops
    assert ops.m2l_at.shape[1:] == (256, 80)
    qp = _grid_input(n, 3, 256, n)
    out = m2l_grid(qp, ops.m2l_at, ops.m2l_at_tc,
                   nsplit=None if split == "auto" else 1)
    torch.cuda.synchronize()
    _check_m2l(out, m2l_grid_plain, qp, ops.m2l_at, f64=split == "auto")


@pytest.mark.parametrize("h,K,N", [(8, 1024, 576), (4, 8 * 512, 8 * 248)])
def test_m2l_grid_blocked_random_stack(cuda_device, h, K, N):
    """The blocked kernel on a random stack: the h = 8 case at the p=6
    ranks, and the Stokes ranks (K = 8 * 512, N = 8 * 248, not a
    multiple of the 144-wide column tile) at h = 4."""
    from sctl_tpu_torch.ops.m2l import (blocked_operands, m2l_grid_blocked,
                                        m2l_grid_blocked_plain)
    rng = np.random.default_rng(K + N)
    mats = torch.as_tensor((rng.normal(size=(26, K, N)) / np.sqrt(K))
                           .astype(np.float32), device=cuda_device)
    qp = _grid_input(h, 1, K, h)
    out = m2l_grid_blocked(qp, mats, blocked_operands(mats))
    torch.cuda.synchronize()
    _check_m2l(out, m2l_grid_blocked_plain, qp, mats)


def test_m2l_grid_ragged(cuda_device):
    """`m2l_grid` at r = 72, r2 = 100: columns past r in the 80-wide
    tile and K past r2 in the last 32-wide step are masked."""
    from sctl_tpu_torch.ops.m2l import m2l_grid, m2l_grid_plain
    rng = np.random.default_rng(11)
    mats = torch.as_tensor((rng.normal(size=(316, 100, 72)) / 10)
                           .astype(np.float32), device=cuda_device)
    qp = _grid_input(8, 3, 100, 11)
    out = m2l_grid(qp, mats)
    torch.cuda.synchronize()
    assert out.shape == (8, 8, 8, 72)
    _check_m2l(out, m2l_grid_plain, qp, mats)


@pytest.mark.parametrize("name", ["m2l_grid_blocked", "m2l_grid"])
def test_m2l_repeats_bit_for_bit(kf6, kf8, name):
    """One launch repeated gives the same bits: the partial sums are
    added in a fixed order, with no atomics."""
    from sctl_tpu_torch.ops import m2l
    if name == "m2l_grid_blocked":
        ops = kf6._ops
        qp = _grid_input(16, 1, ops.m2l_blk.shape[1], 1)
        run = lambda: m2l.m2l_grid_blocked(qp, ops.m2l_blk, ops.m2l_blk_tc)
    else:
        ops = kf8._ops
        qp = _grid_input(16, 3, 256, 2)
        run = lambda: m2l.m2l_grid(qp, ops.m2l_at, ops.m2l_at_tc)
    a = run()
    b = run()
    torch.cuda.synchronize()
    assert getattr(m2l, name).last_nsplit > 1
    assert torch.equal(a, b)


# ---- the redesigned pair kernels: the halo stencil over each box's
# real slots, the U list over compacted lists ---------------------------

def _stencil_ragged(ker, seed, n=4, cap=29, cap_t=37):
    """A halo-stencil case at ragged widths (cap_t = 37, odd, so the
    last thread holds one target; cap = 29), with source and target counts of 0, 1
    and the caps among random ones; the slots past the counts hold
    nonzero densities, which the kernel must skip."""
    from sctl_tpu_torch.ops.p2p import to_halo
    rng = np.random.default_rng(seed)
    B = n ** 3
    cnt_s = rng.integers(0, cap + 1, B)
    cnt_t = rng.integers(0, cap_t + 1, B)
    cnt_s[:4] = (0, 1, cap, cap)
    cnt_t[:4] = (cap_t, 0, 1, cap_t)
    lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                  -1).reshape(-1, 1, 3)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda")
    ident = torch.arange(B, device="cuda")
    halo = lambda a: to_halo(f32(a), ident, n)
    nrm = rng.normal(size=(B, cap, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    xt = (lo + rng.random((B, cap_t, 3))) / n
    counts = lambda c: torch.as_tensor(c.reshape(n, n, n).astype(np.int32),
                                       device="cuda")
    return (ker, n, cap, cap_t,
            f32(xt.reshape(n, n, n, cap_t, 3).transpose(0, 1, 2, 4, 3)),
            halo((lo + rng.random((B, cap, 3))) / n),
            halo(rng.normal(size=(B, cap, ker.kdim0))),
            halo(nrm) if ker.needs_normal else None, counts(cnt_s),
            counts(cnt_t))


def _f64(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _check_redesigned(out, plain, args):
    """1e-5 of the maximum against the plain version in float32 (as
    above), 5e-6 against it in float64 on the same inputs
    (tests_tpu/test_p2p_accuracy.py:45)."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    assert rel_max_err(out, plain(*args)) < 1e-5
    assert rel_max_err(out, plain(*_f64(args))) < 5e-6


@pytest.mark.parametrize("name", ULIST)
def test_p2p_stencil_ragged_matches_plain(cuda_device, name):
    """csrc/p2p_stencil.cu for the six tree formulas at ragged widths
    and counts; the target slots past the counts are exactly zero."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_stencil_plain
    args = _stencil_ragged(KERNELS[name], 20)
    out = p2p_stencil(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, p2p_stencil_plain, args)
    cnt_t, cap_t = args[-1], args[3]
    pad = torch.arange(cap_t, device="cuda") >= cnt_t[..., None]
    assert (out[pad] == 0).all()


def test_p2p_stencil_wide_caps_match_plain(cuda_device):
    """Caps past one block's targets and one shared tile's sources
    (cap_t 700 in two target chunks, cap 600: windows over 512 slots),
    the Stokes double layer."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_stencil_plain
    args = _stencil_ragged(KERNELS["Stokes3D-DxU"], 21, n=3, cap=600,
                           cap_t=700)
    out = p2p_stencil(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, p2p_stencil_plain, args)


def test_p2p_stencil_repeats_bit_for_bit(cuda_device):
    """One launch repeated gives the same bits: fixed order, no atomics."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil
    args = _stencil_ragged(KERNELS["Stokes3D-FxU"], 22)
    a, b = p2p_stencil(*args), p2p_stencil(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _ulist_ragged(ker, seed, G=12, T=70, dtype=torch.float32):
    """A compacted U-list case at ragged widths: T = 70 (two target
    chunks of the block, not a multiple of 2), target counts 0, 1, 64,
    65 and T, source runs of 0 and 1 (a list with one real source)
    among random ones up to 700, densities through a shuffled index
    with rows no source reads; float tensors in `dtype`."""
    rng = np.random.default_rng(seed)
    tcnt = rng.integers(0, T + 1, G)
    tcnt[:6] = (0, 1, 64, 65, T, 7)
    scnt = rng.integers(0, 700, G)
    scnt[:6] = (5, 0, 1, 300, 700, 1)
    N = int(scnt.sum())
    ends = np.cumsum(scnt)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda").to(dtype)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    nrm = rng.normal(size=(3, N))
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    return (ker, f32(rng.random((G, 3, T))), f32(rng.random((3, N)) * 3 - 1),
            f32(nrm) if ker.needs_normal else None,
            f32(rng.normal(size=(N + 9, ker.kdim0))),
            i32(np.stack([ends - scnt, ends], 1)), i32(tcnt),
            i32(rng.permutation(N + 9)[:N]))


@pytest.mark.parametrize("name", ULIST)
def test_p2p_ulist_ragged_matches_plain(cuda_device, name):
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    args = _ulist_ragged(KERNELS[name], 23)
    out = p2p_ulist(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, p2p_ulist_plain, args)
    tcnt, T = args[6], args[1].shape[2]
    pad = torch.arange(T, device="cuda") >= tcnt[:, None]
    assert (out[pad] == 0).all()


def test_p2p_ulist_padded_form_matches_flat(cuda_device):
    """The JAX function's padded form (every slot of a (G, 3, S) slab a
    source) and the flat form over the same slots agree bit for bit:
    one kernel body."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import box_ranges, p2p_ulist
    ker = KERNELS["Stokes3D-DxU"]
    rng = np.random.default_rng(24)
    G, T, S = 5, 16, 256
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda")
    xt, xs, ns = (f32(rng.random((G, 3, T))), f32(rng.random((G, 3, S))),
                  f32(rng.normal(size=(G, 3, S))))
    f = f32(rng.normal(size=(G, 3, S)) * (rng.random((G, 1, S)) < 0.7))
    flat = lambda a: a.transpose(0, 1).reshape(3, -1).contiguous()
    full = torch.full((G,), S, dtype=torch.int32, device="cuda")
    a = p2p_ulist(ker, xt, xs, ns, f)
    b = p2p_ulist(ker, xt, flat(xs), flat(ns),
                  f.transpose(1, 2).reshape(-1, 3).contiguous(),
                  box_ranges(full, S))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_p2p_ulist_repeats_bit_for_bit(cuda_device):
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_ulist
    args = _ulist_ragged(KERNELS["Stokes3D-DxU"], 25)
    a, b = p2p_ulist(*args), p2p_ulist(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ULIST)
def test_p2p_ulist_f64_ragged_matches_plain(cuda_device, name):
    """The float64 build on the ragged case (per-box target counts, runs
    of 0 and 1 sources, densities through fidx): 1e-12 of the maximum
    against the plain version in float64, the slots past the counts
    exactly zero, and the output float64."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    args = _ulist_ragged(KERNELS[name], 26, dtype=torch.float64)
    out = p2p_ulist(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.float64
    assert rel_max_err(out, p2p_ulist_plain(*args)) < 1e-12
    tcnt, T = args[6], args[1].shape[2]
    pad = torch.arange(T, device="cuda") >= tcnt[:, None]
    assert (out[pad] == 0).all()


def test_p2p_ulist_f64_without_counts_or_index(cuda_device):
    """The float64 build with tcnt and fidx absent (every target slot
    real, source j reads density row j), and on the JAX function's
    padded form, against the plain version in float64, 1e-12."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import (_ulist_from_padded, p2p_ulist,
                                        p2p_ulist_plain)
    ker = KERNELS["Stokes3D-DxU"]
    ker_, xt, xs, ns, f, srng, _, fidx = _ulist_ragged(
        ker, 27, dtype=torch.float64)
    f_rows = f[fidx.long()].contiguous()
    out = p2p_ulist(ker, xt, xs, ns, f_rows, srng)
    torch.cuda.synchronize()
    assert rel_max_err(out, p2p_ulist_plain(ker, xt, xs, ns, f_rows,
                                            srng)) < 1e-12
    rng = np.random.default_rng(28)
    G, T, S = 5, 16, 256
    c64 = lambda a: torch.as_tensor(a, device="cuda")
    xt_b, xs_b = c64(rng.random((G, 3, T))), c64(rng.random((G, 3, S)))
    ns_b = c64(rng.normal(size=(G, 3, S)))
    f_b = c64(rng.normal(size=(G, 3, S)) * (rng.random((G, 1, S)) < 0.7))
    out = p2p_ulist(ker, xt_b, xs_b, ns_b, f_b)
    torch.cuda.synchronize()
    ref = p2p_ulist_plain(ker, xt_b, *_ulist_from_padded(ker, xt_b, xs_b,
                                                         ns_b, f_b))
    assert out.dtype == torch.float64 and rel_max_err(out, ref) < 1e-12


def test_p2p_ulist_f64_repeats_bit_for_bit(cuda_device):
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_ulist
    args = _ulist_ragged(KERNELS["Stokes3D-DxU"], 29, dtype=torch.float64)
    a, b = p2p_ulist(*args), p2p_ulist(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_p2p_ulist_mixed_dtypes_raise(cuda_device):
    """One type for every float tensor: float32 coordinates with float64
    densities, and float16, raise before any launch."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_ulist
    ker, xt, xs, ns, f, srng, tcnt, fidx = _ulist_ragged(
        KERNELS["Stokes3D-DxU"], 30)
    n = p2p_ulist.launches
    with pytest.raises(NotImplementedError):
        p2p_ulist(ker, xt, xs, ns, f.double(), srng, tcnt, fidx)
    with pytest.raises(NotImplementedError):
        p2p_ulist(ker, xt.half(), xs.half(), ns.half(), f.half(), srng,
                  tcnt, fidx)
    assert p2p_ulist.launches == n


def test_adaptive_and_bie_f64_on_card_launch_f64_ulist(cuda_device):
    """AdaptiveFMM and BoundaryIntegralOp built with dtype=float64 on the
    card: each apply launches the float64 U-list kernel once, and the
    card's result matches the CPU's (plain versions) on the same tables
    to 1e-10 of the maximum (float64 throughout; the far stages' sums
    run in another order)."""
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.fmm import AdaptiveFMM, KIFMMOperators
    from sctl_tpu_torch.ops import Stokes3D_DxU, Stokes3D_FSxU
    from sctl_tpu_torch.ops.p2p import p2p_ulist
    lst = torus_patches(nu=8, nv=4, q=6)
    X, _, _ = lst.get_node_coord()
    Xf, Xnf, _, _, _ = lst.get_far_field_nodes(1e-6)
    f = np.random.default_rng(31).normal(size=(len(Xf), 3))
    cpu = AdaptiveFMM(Stokes3D_DxU, p=4, device="cpu",
                      dtype=torch.float64).setup(Xf, X, Xnf)
    tables = {k: getattr(cpu._ops, k) for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(Stokes3D_FSxU, 4, cpu.rcond, cuda_device,
                         torch.float64, tables=tables)
    card = AdaptiveFMM(Stokes3D_DxU, p=4, device=cuda_device,
                       dtype=torch.float64, operators=ops).setup(Xf, X, Xnf)
    n = p2p_ulist.launches_f64
    u_card = card.eval(f)
    assert p2p_ulist.launches_f64 == n + 1
    u_cpu = cpu.eval(f)
    assert np.abs(u_card - u_cpu).max() < 1e-10 * np.abs(u_cpu).max()

    op = BoundaryIntegralOp(Stokes3D_DxU, device=cuda_device,
                            dtype=torch.float64)
    op.set_accuracy(1e-4)
    op.add_elem_list(torus_patches(nu=8, nv=4, q=4))
    op.far_fmm_cutoff = 1000
    op.far_fmm_p = 4
    op.setup()
    assert op._far_fmm is not None and op._far_fmm.dtype == torch.float64
    sigma = torch.randn(op.dim(0), dtype=torch.float64, device=cuda_device)
    n = p2p_ulist.launches_f64
    u = op.compute_potential_tensor(sigma)
    torch.cuda.synchronize()
    assert p2p_ulist.launches_f64 == n + 1
    assert u.dtype == torch.float64 and bool(torch.isfinite(u).all())


# ---- the redesigned direct sum and slab stencil -------------------------

@pytest.fixture(scope="module")
def direct_few(cuda_device):
    """The oracles' shape reduced: few targets, many sources, so the
    grid splits the sources."""
    from sctl_tpu_torch.kernel_cases import p2p_cases
    return p2p_cases(cuda_device, seed=1, n_trg=100, n_src=300_000)


@pytest.fixture(scope="module")
def direct_square(cuda_device):
    """As many targets as sources, ParticleFMM's direct path reduced."""
    from sctl_tpu_torch.kernel_cases import p2p_cases
    return p2p_cases(cuda_device, seed=2, n_trg=6000, n_src=6000)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("shape", ["few", "square"])
def test_p2p_shapes_match_plain(direct_few, direct_square, shape, name,
                                dtype):
    """csrc/p2p_direct.cu at 100 x 300,000 and 6,000 x 6,000 for every
    formula against its plain version: 1e-5 of the maximum in float32,
    1e-12 in float64 (ORACLE_BAR of chip_smoke.py)."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    cases = direct_few if shape == "few" else direct_square
    run, plain, _, _ = cases[f"p2p[{name},{dtype}]"]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < (1e-5 if dtype == "f32" else 1e-12)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_p2p_repeats_bit_for_bit(direct_few, dtype):
    """Two launches give the same bits: the source splits' partial sums
    are added in a fixed order, no atomics."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_grid, p2p_layout
    from sctl_tpu_torch.ops._launch_checks import n_sms
    run, _, _, _ = direct_few[f"p2p[Stokes3D-DxU,{dtype}]"]
    lay = p2p_layout(KERNELS["Stokes3D-DxU"],
                     torch.float64 if dtype == "f64" else torch.float32,
                     "cuda")
    assert lay["blocks_per_sm"] >= 1 and lay["targets_per_thread"] >= 1
    assert p2p_grid(100, 300_000, lay["threads"] * lay["targets_per_thread"],
                    lay["tile"], lay["blocks_per_sm"] * n_sms("cuda"))[0] > 1
    a, b = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_p2p_f64_rsqrt_within_4_ulp(cuda_device):
    """The float64 kernel's reciprocal distance (seed and two Newton
    steps) at r2 from 1e-50, far below float's normal range, to 1e2:
    targets on an axis, one unit source at the origin, so each output
    is 1/sqrt(fl(d d)); within 4 ulp of it (computed in long double).
    r2 = 0 gives 0, and so does a subnormal r2 (1e-320), which counts as
    coincident."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.p2p import p2p
    d = np.concatenate([np.geomspace(1e-25, 10.0, 2001), [0.0, 1e-160]])
    xt = np.zeros((d.size, 3))
    xt[:, 0] = d
    c = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    out = p2p(Laplace3D_FxU, c(xt), c(np.zeros((1, 3))), None,
              c(np.ones((1, 1))))[:, 0].cpu().numpy()
    r2 = d[:-2] * d[:-2]
    ref = (1 / np.sqrt(r2.astype(np.longdouble))).astype(np.float64)
    assert (np.abs(out[:-2] - ref) <= 4 * np.spacing(ref)).all()
    assert out[-2] == 0 and out[-1] == 0


def _stencil9_ragged(ker, seed, n=4, cap=29, cap_t=37):
    """A slab-stencil case at ragged widths (cap 29, so SL = 384 with 261
    slots an entry at most; cap_t 37, so a warp holds two boxes'
    targets) on the compacted slab, with source and target counts of 0,
    1 and the caps among random ones; the slab slots past each entry's
    count hold nonzero densities and normals, which the kernel must
    skip."""
    from sctl_tpu_torch.ops.p2p import slab_gather, slab_index
    rng = np.random.default_rng(seed)
    B = n ** 3
    SL = -(-9 * cap // 128) * 128
    cnt_s = rng.integers(0, cap + 1, B)
    cnt_t = rng.integers(0, cap_t + 1, B)
    cnt_s[:4] = (0, 1, cap, cap)
    cnt_t[:4] = (cap_t, 0, 1, cap_t)
    lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                  -1).reshape(-1, 1, 3)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda")
    counts = lambda c: torch.as_tensor(c.reshape(n, n, n).astype(np.int32),
                                       device="cuda")
    idx, cnt9 = slab_index(torch.arange(B, device="cuda"), n, cap, SL,
                           counts(cnt_s))
    dead = (torch.arange(SL, device="cuda") >= cnt9[..., None]).reshape(
        n, n, 1, -1)

    def slab(a):
        s = slab_gather(f32(a), idx)
        return torch.where(dead, f32(rng.normal(size=s.shape)), s)

    nrm = rng.normal(size=(B, cap, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    xt = (lo + rng.random((B, cap_t, 3))) / n
    return (ker, n, SL, cap_t,
            f32(xt.reshape(n, n, n, cap_t, 3).transpose(0, 1, 2, 4, 3)),
            slab_gather(f32((lo + rng.random((B, cap, 3))) / n), idx),
            slab(rng.normal(size=(B, cap, ker.kdim0))),
            slab(nrm) if ker.needs_normal else None, cnt9, counts(cnt_t))


@pytest.mark.parametrize("name", ULIST)
def test_p2p_stencil9_ragged_matches_plain(cuda_device, name):
    """csrc/p2p_stencil9.cu for the six tree formulas at ragged widths
    and counts on the compacted slab; the target slots past the counts
    are exactly zero."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil9, p2p_stencil9_plain
    args = _stencil9_ragged(KERNELS[name], 26)
    out = p2p_stencil9(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, p2p_stencil9_plain, args)
    cnt_t, cap_t = args[-1], args[3]
    pad = torch.arange(cap_t, device="cuda") >= cnt_t[..., None]
    assert (out[pad] == 0).all()


def test_p2p_stencil9_widest_block_matches_plain(cuda_device):
    """The widest block the gate takes (cap_t 256: 1,024 target slots, so
    the block's 1,024 threads take them in passes), with cap 200 (SL
    1,920, an entry of up to 1,800 real slots), n = 3, so the last block
    of a column holds fewer than 4 boxes; and every slot
    (no counts, the planted densities included) on the same slab."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import (p2p_stencil9, p2p_stencil9_plain,
                                        stencil9_fits, stencil9_layout)
    ker = KERNELS["Laplace3D-FxU"]
    args = _stencil9_ragged(ker, 27, n=3, cap=200, cap_t=256)
    assert stencil9_fits(ker, 256, args[2])
    lay = stencil9_layout(ker, args[2], 256)
    assert lay["threads"] == 1024 and lay["blocks_per_sm"] >= 1
    out = p2p_stencil9(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, p2p_stencil9_plain, args)
    every = args[:8] + (None, None)
    out = p2p_stencil9(*every)
    torch.cuda.synchronize()
    _check_redesigned(out, p2p_stencil9_plain, every)


def test_p2p_stencil9_repeats_bit_for_bit(cuda_device):
    """One launch repeated gives the same bits: fixed order, no atomics."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil9
    args = _stencil9_ragged(KERNELS["Stokes3D-FxU"], 28)
    a, b = p2p_stencil9(*args), p2p_stencil9(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# ---- the redesigned shared-surface kernels: S2M and L2T over each
# box's real slots by per-box counts ------------------------------------

S2M = ["Laplace3D-FxU", "Laplace3D-DxU", "Stokes3D-FxU", "Stokes3D-DxU",
       "Stokes3D-FSxU"]
L2T = ["Laplace3D-FxU", "Laplace3D-FxdU", "Stokes3D-FSxU"]


def _surface(p):
    """The KIFMM's check surface of a unit box at order p (ns = 152 at
    p = 6, 296 at p = 8, not a multiple of 32), on the card."""
    from sctl_tpu_torch.fmm.kifmm import cube_surface
    return torch.as_tensor(np.float32(cube_surface(p) * (2.95 / 2)),
                           device="cuda")


def _box_counts(rng, B, cap):
    cnt = rng.integers(0, cap + 1, B)
    cnt[:4] = (0, 1, cap, cap)
    return torch.as_tensor(cnt.astype(np.int32), device="cuda")


def _s2m_ragged(ker, seed, B=128, cap=29, p=6):
    """A surface_pair case at ragged widths with source counts of 0, 1
    and cap among random ones; the slots past the counts hold nonzero
    densities, which the kernel must skip."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda")
    nrm = rng.normal(size=(3, B * cap))
    nrm /= np.linalg.norm(nrm, axis=0)
    return (ker, _surface(p), f32(rng.random((3, B * cap)) - 0.5),
            f32(rng.normal(size=(ker.kdim0, B * cap))), cap,
            f32(nrm) if ker.needs_normal else None,
            _box_counts(rng, B, cap))


def _l2t_ragged(ker, seed, B=128, cap_t=37, p=6):
    """An l2t_surface case at ragged widths (cap_t 37, odd, so a thread
    of two targets holds one past a box's end) with target counts of 0,
    1 and cap_t among random ones."""
    rng = np.random.default_rng(seed)
    surf = _surface(p)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda")
    return (ker, surf, f32(rng.random((3, B * cap_t)) - 0.5),
            f32(rng.normal(size=(ker.kdim0, surf.shape[0], B))), cap_t,
            _box_counts(rng, B, cap_t))


def _check_l2t_zeros(out, args):
    cap_t, cnt = args[4], args[5]
    pad = (torch.arange(cap_t, device="cuda") >= cnt[:, None]).reshape(-1)
    assert (out[:, pad] == 0).all()


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("name", S2M)
def test_surface_pair_ragged_matches_plain(cuda_device, name, p):
    """csrc/surface_pair.cu for the five S2M formulas at p = 6 and 8
    (ns 152 and 296), B = 128."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.sl import surface_pair, surface_pair_plain
    args = _s2m_ragged(KERNELS[name], 30, p=p)
    out = surface_pair(*args)
    torch.cuda.synchronize()
    assert out.shape == (KERNELS[name].kdim1, args[1].shape[0], 128)
    _check_redesigned(out, surface_pair_plain, args)


# the capacities of phase 7 (344) and of depth-3 trees (432) for the
# formulas whose route rule admits them, and one the rule leaves to the
# U list (the kernel takes any capacity)
WIDE = ([(k, c) for k in S2M for c in (344, 432)
         if k == "Laplace3D-FxU"] + [("Stokes3D-DxU", 432)])


@pytest.mark.parametrize("name,cap", WIDE)
def test_surface_pair_wide_cap_matches_plain(cuda_device, name, cap):
    """Capacities of several tiles at p = 8."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.sl import (surface_pair, surface_pair_fits,
                                       surface_pair_plain)
    ker = KERNELS[name]
    assert surface_pair_fits(ker, cap) == (name == "Laplace3D-FxU")
    args = _s2m_ragged(ker, 31, cap=cap, p=8)
    out = surface_pair(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, surface_pair_plain, args)


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("name", L2T)
def test_l2t_surface_ragged_matches_plain(cuda_device, name, p):
    """csrc/l2t_surface.cu for the three L2T formulas at p = 6 and 8,
    B = 128; the target slots past the counts are exactly zero."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.sl import l2t_surface, l2t_surface_plain
    args = _l2t_ragged(KERNELS[name], 32, p=p)
    out = l2t_surface(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, l2t_surface_plain, args)
    _check_l2t_zeros(out, args)


@pytest.mark.parametrize("name", L2T)
def test_l2t_surface_wide_cap_matches_plain(cuda_device, name):
    """Phase 7's widths: cap_t 328 at ns 296 (3 boxes a block)."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.sl import l2t_surface, l2t_surface_plain
    args = _l2t_ragged(KERNELS[name], 37, B=128, cap_t=328, p=8)
    out = l2t_surface(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, l2t_surface_plain, args)
    _check_l2t_zeros(out, args)


@pytest.mark.parametrize("stage", ["surface_pair", "l2t_surface"])
def test_surface_kernels_many_boxes_match_plain(cuda_device, stage):
    """B = 32,768 boxes (phase 7's depth 5) at phase 4's widths (cap_s
    56, cap_t 48, ns 152), Laplace3D-FxU."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops import sl
    if stage == "surface_pair":
        args = _s2m_ragged(Laplace3D_FxU, 33, B=32768, cap=56)
    else:
        args = _l2t_ragged(Laplace3D_FxU, 33, B=32768, cap_t=48)
    out = getattr(sl, stage)(*args)
    torch.cuda.synchronize()
    _check_redesigned(out, getattr(sl, stage + "_plain"), args)


def test_surface_kernels_repeat_bit_for_bit(cuda_device):
    """One launch repeated gives the same bits: fixed order, no atomics."""
    from sctl_tpu_torch.ops import Stokes3D_DxU, Stokes3D_FSxU
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    s2m = _s2m_ragged(Stokes3D_DxU, 34, p=8)
    l2t = _l2t_ragged(Stokes3D_FSxU, 34, p=8)
    a, b = surface_pair(*s2m), surface_pair(*s2m)
    c, d = l2t_surface(*l2t), l2t_surface(*l2t)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


def test_surface_kernels_no_counts_is_every_slot(cuda_device):
    """Counts of None are every slot: the same bits as counts of cap."""
    from sctl_tpu_torch.ops import Stokes3D_FSxU, Stokes3D_FxU
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    s2m = _s2m_ragged(Stokes3D_FxU, 35)
    full = torch.full_like(s2m[6], s2m[4])
    a = surface_pair(*s2m[:6], full)
    b = surface_pair(*s2m[:6], None)
    l2t = _l2t_ragged(Stokes3D_FSxU, 35)
    c = l2t_surface(*l2t[:5], torch.full_like(l2t[5], l2t[4]))
    d = l2t_surface(*l2t[:5], None)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


def test_surface_layouts(cuda_device):
    """The layouts the occupancy API reports: 5 and 10 surface points a
    lane at p = 6 and 8 in one pass, 4 and 2 boxes a warp (the output
    stage's budget), and more than one block an SM for both kernels at
    phase 4's and phase 7's widths (cap_t 48 and 328)."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.sl import l2t_surface_layout, surface_pair_layout
    for ns, mc, k, cap_t in ((152, 5, 4, 48), (296, 10, 2, 328)):
        lay = surface_pair_layout(Laplace3D_FxU, ns)
        assert lay["points_per_lane"] == mc and lay["passes"] == 1
        assert lay["boxes_per_warp"] == k
        assert lay["blocks_per_sm"] > 1
        assert l2t_surface_layout(Laplace3D_FxU, ns,
                                  cap_t)["blocks_per_sm"] > 1


# ---- the float64 builds of the four kernels of the float64 KIFMM ------

F64_BAR = 1e-12


def _check_f64(out, plain, args, launches_before, fn):
    """The float64 build: a float64 output within F64_BAR of the plain
    version in float64 on the same inputs (the lean double rsqrt is
    within a few ulp and the sums run in another order), one more
    float64 launch."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    assert out.dtype == torch.float64
    assert fn.launches_f64 == launches_before + 1
    assert rel_max_err(out, plain(*args)) < F64_BAR


@pytest.mark.parametrize("name", ULIST)
def test_p2p_stencil_f64_ragged_matches_plain(cuda_device, name):
    """The halo stencil's float64 build for the six tree formulas at
    ragged widths, with boxes of 0, 1 and cap sources and targets; the
    target slots past the counts exactly zero."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_stencil_plain
    args = _f64(_stencil_ragged(KERNELS[name], 40))
    n = p2p_stencil.launches_f64
    out = p2p_stencil(*args)
    torch.cuda.synchronize()
    _check_f64(out, p2p_stencil_plain, args, n, p2p_stencil)
    cnt_t, cap_t = args[-1], args[3]
    pad = torch.arange(cap_t, device="cuda") >= cnt_t[..., None]
    assert (out[pad] == 0).all()


def test_p2p_stencil_f64_wide_caps_match_plain(cuda_device):
    """Phase 7's capacities in float64 (cap 344, cap_t 328: windows of
    several 512-slot tiles), the Stokes double layer."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_stencil_plain
    args = _f64(_stencil_ragged(KERNELS["Stokes3D-DxU"], 41, n=3, cap=344,
                                cap_t=328))
    n = p2p_stencil.launches_f64
    out = p2p_stencil(*args)
    torch.cuda.synchronize()
    _check_f64(out, p2p_stencil_plain, args, n, p2p_stencil)


@pytest.mark.parametrize("name", ULIST)
def test_p2p_stencil9_f64_ragged_matches_plain(cuda_device, name):
    """The slab stencil's float64 build for the six tree formulas on the
    compacted slab at ragged widths and counts (the slots past each
    entry's count hold nonzero values, which it must skip)."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil9, p2p_stencil9_plain
    args = _f64(_stencil9_ragged(KERNELS[name], 42))
    n = p2p_stencil9.launches_f64
    out = p2p_stencil9(*args)
    torch.cuda.synchronize()
    _check_f64(out, p2p_stencil9_plain, args, n, p2p_stencil9)
    cnt_t, cap_t = args[-1], args[3]
    pad = torch.arange(cap_t, device="cuda") >= cnt_t[..., None]
    assert (out[pad] == 0).all()


def test_p2p_stencil9_f64_widest_block_matches_plain(cuda_device):
    """The widest float64 block the rule takes: cap_t 256 (1,024 target
    slots, two passes of the 512 threads) and cap 128 (SL 1,152, a
    window of 221 KB), where float32's rule takes SL up to 2,420; and
    every slot (no counts) on the same slab."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import (p2p_stencil9, p2p_stencil9_plain,
                                        stencil9_fits, stencil9_layout)
    ker = KERNELS["Laplace3D-FxU"]
    args = _f64(_stencil9_ragged(ker, 43, n=3, cap=128, cap_t=256))
    SL = args[2]
    assert SL == 1152 and stencil9_fits(ker, 256, SL, torch.float64)
    assert not stencil9_fits(ker, 256, 1280, torch.float64)
    assert stencil9_fits(ker, 256, 1280, torch.float32)
    lay = stencil9_layout(ker, SL, 256, torch.float64)
    assert lay["threads"] == 512 and lay["blocks_per_sm"] >= 1
    n = p2p_stencil9.launches_f64
    out = p2p_stencil9(*args)
    torch.cuda.synchronize()
    _check_f64(out, p2p_stencil9_plain, args, n, p2p_stencil9)
    every = args[:8] + (None, None)
    out = p2p_stencil9(*every)
    torch.cuda.synchronize()
    _check_f64(out, p2p_stencil9_plain, every, n + 1, p2p_stencil9)


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("name", S2M)
def test_surface_pair_f64_ragged_matches_plain(cuda_device, name, p):
    """S2M's float64 build for the five S2M formulas at p = 6 and 8
    (ns 152 in one pass, 296 in two of 5 surface points a lane), boxes
    of 0, 1 and cap sources."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.sl import surface_pair, surface_pair_plain
    args = _f64(_s2m_ragged(KERNELS[name], 44, p=p))
    n = surface_pair.launches_f64
    out = surface_pair(*args)
    torch.cuda.synchronize()
    assert out.shape == (KERNELS[name].kdim1, args[1].shape[0], 128)
    _check_f64(out, surface_pair_plain, args, n, surface_pair)


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("name", L2T)
def test_l2t_surface_f64_ragged_matches_plain(cuda_device, name, p):
    """L2T's float64 build for the three L2T formulas at p = 6 and 8,
    boxes of 0, 1 and cap_t targets; the target slots past the counts
    exactly zero."""
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.sl import l2t_surface, l2t_surface_plain
    args = _f64(_l2t_ragged(KERNELS[name], 45, p=p))
    n = l2t_surface.launches_f64
    out = l2t_surface(*args)
    torch.cuda.synchronize()
    _check_f64(out, l2t_surface_plain, args, n, l2t_surface)
    _check_l2t_zeros(out, args)


@pytest.mark.parametrize("stage", ["surface_pair", "l2t_surface"])
def test_surface_kernels_f64_wide_match_plain(cuda_device, stage):
    """The float64 builds at phase 7's widths: cap 344 (S2M) and cap_t
    328 (L2T) at p = 8."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops import sl
    fn = getattr(sl, stage)
    if stage == "surface_pair":
        args = _f64(_s2m_ragged(Laplace3D_FxU, 46, cap=344, p=8))
    else:
        args = _f64(_l2t_ragged(Laplace3D_FxU, 46, cap_t=328, p=8))
    n = fn.launches_f64
    out = fn(*args)
    torch.cuda.synchronize()
    _check_f64(out, getattr(sl, stage + "_plain"), args, n, fn)


def test_f64_builds_repeat_bit_for_bit(cuda_device):
    """One launch of each float64 build repeated gives the same bits."""
    from sctl_tpu_torch.ops import Stokes3D_DxU, Stokes3D_FSxU, Stokes3D_FxU
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_stencil9
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    for fn, args in (
            (p2p_stencil, _f64(_stencil_ragged(Stokes3D_FxU, 47))),
            (p2p_stencil9, _f64(_stencil9_ragged(Stokes3D_FxU, 47))),
            (surface_pair, _f64(_s2m_ragged(Stokes3D_DxU, 47, p=8))),
            (l2t_surface, _f64(_l2t_ragged(Stokes3D_FSxU, 47, p=8)))):
        a, b = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b), fn.__name__


def test_f64_mixed_dtypes_raise(cuda_device):
    """float64 coordinates with float32 densities raise in each of the
    four wrappers before any launch."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_stencil9
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    cases = ((p2p_stencil, _stencil_ragged(Laplace3D_FxU, 48), 6),
             (p2p_stencil9, _stencil9_ragged(Laplace3D_FxU, 48), 6),
             (surface_pair, _s2m_ragged(Laplace3D_FxU, 48), 3),
             (l2t_surface, _l2t_ragged(Laplace3D_FxU, 48), 3))
    for fn, args, k in cases:
        mixed = _f64(args[:k]) + args[k:]
        n = fn.launches
        with pytest.raises(NotImplementedError):
            fn(*mixed)
        assert fn.launches == n, fn.__name__


def test_f64_layouts(cuda_device):
    """The float64 builds' layouts from the occupancy API: S2M at most
    5 surface points a lane (one pass at p = 6, two at p = 8) and 2
    boxes a warp at p = 6; L2T and the slab stencil (at phase 4's
    widths, 384 threads) at least one block an SM."""
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.p2p import stencil9_layout
    from sctl_tpu_torch.ops.sl import l2t_surface_layout, surface_pair_layout
    f64 = torch.float64
    for ns, passes, k in ((152, 1, 2), (296, 2, 2)):
        lay = surface_pair_layout(Laplace3D_FxU, ns, f64)
        assert lay["points_per_lane"] == 5 and lay["passes"] == passes
        assert lay["boxes_per_warp"] == k and lay["blocks_per_sm"] >= 1
    for ns, cap_t in ((152, 48), (296, 328)):
        assert l2t_surface_layout(Laplace3D_FxU, ns, cap_t,
                                  f64)["blocks_per_sm"] >= 1
    lay = stencil9_layout(Laplace3D_FxU, 512, 48, f64)
    assert lay["threads"] == 384 and lay["blocks_per_sm"] >= 2


@pytest.mark.parametrize("name", ["Laplace3D-FxU", "Stokes3D-FxU"])
def test_kifmm_f64_card_matches_cpu(cuda_device, name):
    """The float64 KIFMM at depth 4 on the card (the float64 builds of
    surface_pair, l2t_surface and p2p_stencil9; the per-parity M2L
    sweep at the exact ranks) against the CPU's plain versions on the
    same tables, p = 4, rcond 1e-9.  Bar 1e-9 of the maximum: the pinv
    operators amplify float64 rounding about a million-fold (the port
    and the JAX package differ by 1.8e-10 at p = 6,
    tests/test_torch_kifmm.py)."""
    from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators
    from sctl_tpu_torch.ops import KERNELS
    from sctl_tpu_torch.ops.p2p import p2p_stencil9
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    ker = KERNELS[name]
    rng = np.random.default_rng(49)
    x = rng.random((16 ** 3 * 30, 3))
    f = rng.normal(size=(len(x), ker.kdim0))
    cpu = KIFMM(ker, p=4, depth=4, device="cpu",
                dtype=torch.float64).setup(x, x)
    tables = {k: getattr(cpu._ops, k) for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(cpu.ker_trans, 4, cpu.rcond, cuda_device,
                         torch.float64, tables=tables)
    card = KIFMM(ker, p=4, depth=4, device=cuda_device, dtype=torch.float64,
                 operators=ops).setup(x, x)
    assert card._ops.m2l_route == "parity"
    assert card.surface_route and card.near_route == "stencil9"
    counts = [fn.launches_f64 for fn in (surface_pair, l2t_surface,
                                         p2p_stencil9)]
    u_card = card.eval(f)
    assert [fn.launches_f64 for fn in (surface_pair, l2t_surface,
                                       p2p_stencil9)] == [
        c + 1 for c in counts]
    u_cpu = cpu.eval(f)
    assert np.abs(u_card - u_cpu).max() < 1e-9 * np.abs(u_cpu).max()


def test_particle_fmm_f64_card_halo_route(cuda_device):
    """ParticleFMM(accuracy=8, float64) on the card at about 330 points
    a leaf (depth 3 at 170,000 points): the halo stencil's float64
    build, and S2M and L2T through the float64 U-list kernel, as the
    surface rule refuses cap_s past 227 at 8 bytes; against its direct
    sum (the float64 p2p) at 500 targets, bar 1e-6 (BASELINE.md rung
    4: 8.1e-8 at p = 8)."""
    from sctl_tpu_torch.fmm import ParticleFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    from sctl_tpu_torch.ops.p2p import p2p_stencil, p2p_ulist
    rng = np.random.default_rng(50)
    x = rng.random((170_000, 3))
    f = rng.normal(size=(len(x), 1))
    fmm = ParticleFMM(accuracy=8, device=cuda_device, dtype=torch.float64)
    fmm.set_kernel_s2t("s", "t", Laplace3D_FxU)
    fmm.set_src_coord("s", x)
    fmm.set_src_density("s", f)
    fmm.set_trg_coord("t", x)
    n_st, n_ul = p2p_stencil.launches_f64, p2p_ulist.launches_f64
    u = fmm.eval("t")
    kf = next(iter(fmm._kifmm_cache.values()))
    assert kf.depth == 3 and kf.near_route == "stencil"
    assert not kf.surface_route and kf._ops.m2l_route == "parity"
    assert p2p_stencil.launches_f64 == n_st + 1
    assert p2p_ulist.launches_f64 == n_ul + 2
    X = torch.as_tensor(x, device=cuda_device)
    u_d = direct_eval_blocked(Laplace3D_FxU, X[:500], X, torch.as_tensor(
        f, device=cuda_device)).cpu().numpy()
    assert np.abs(u[:500] - u_d).max() < 1e-6 * np.abs(u_d).max()


# ---- the rest of the single-device BIE: the host near path, the legacy
# quadrature, the Laplace double layer ------------------------------------

@pytest.mark.parametrize("use_device_near", [False, True])
def test_bie_near_engines_card_match_cpu(cuda_device, use_device_near):
    """BoundaryIntegralOp(Laplace3D_DxU) in float64 with the host near path
    and with the device engine: the card's near operators and apply
    against the CPU's (the host path's operators are the same numpy on
    both, bit for bit; the device engine's within 1e-10), the apply
    within 1e-10 of the maximum."""
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.ops import Laplace3D_DxU
    ops = []
    for dev in (cuda_device, "cpu"):
        op = BoundaryIntegralOp(Laplace3D_DxU, device=dev,
                                dtype=torch.float64)
        op.set_accuracy(1e-4)
        op.add_elem_list(torus_patches(nu=6, nv=3, q=4))
        op.use_device_near = use_device_near
        ops.append(op.setup())
    card, cpu = ops
    assert card.near_pairs == cpu.near_pairs
    m_card, m_cpu = (o._dev["near_mats"].cpu().numpy() for o in ops)
    if use_device_near:
        assert np.abs(m_card - m_cpu).max() < 1e-10 * np.abs(m_cpu).max()
    else:
        assert card._near_mats_dev is None and np.array_equal(m_card, m_cpu)
    sigma = np.random.default_rng(60).normal(size=card.dim(0))
    u, u_cpu = card.compute_potential(sigma), cpu.compute_potential(sigma)
    assert np.abs(u - u_cpu).max() < 1e-10 * np.abs(u_cpu).max()


@pytest.mark.parametrize("name", ["Laplace3D-DxU", "Stokes3D-DxU"])
def test_legacy_quadrature_card_matches_cpu(cuda_device, name):
    """LegacyQuadrature set up on the card (its Duffy blocks there in
    float64) against the same setup on the CPU: the correction tables
    within 1e-10 of their maximum.  Its eval on the card (the far sum
    through p2p) against the CPU's on the card's tables: float64 within
    1e-12; float32 within 1e-5 of the float64 eval at off-surface
    targets, and of the CPU's float32 eval on the surface (where float32
    itself reads 4e-5 to 4e-4 from float64)."""
    from sctl_tpu_torch.bie import (BasisElemList, LegacyQuadrature,
                                    sphere_patches)
    from sctl_tpu_torch.ops import KERNELS as KS
    from sctl_tpu_torch.ops.p2p import p2p
    ker = KS[name]
    elems = BasisElemList.discretize(6, sphere_patches(q=6).charts)
    xt = np.array([[0.0, 0.0, 0.9], [0.55, 0.55, 0.55], [0.0, 0.0, 0.2],
                   [0.0, 1.4, 0.0]])
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    sig = np.random.default_rng(61).normal(size=(6, 36, ker.kdim0))
    for Xt in (xt, None):
        q = LegacyQuadrature(ker, elems, 12, 8, device=cuda_device,
                             dtype=torch.float64).setup(Xt)
        qc = LegacyQuadrature(ker, elems, 12, 8, device="cpu",
                              dtype=torch.float64).setup(Xt)
        assert np.array_equal(q._pairs, qc._pairs)
        assert rel(q._Mnear, qc._Mnear) < 1e-10
        if Xt is None:
            assert rel(q._Msing, qc._Msing) < 1e-10
        ref = q.to("cpu", torch.float64).eval(sig)
        n = p2p.launches
        assert rel(q.eval(sig), ref) < 1e-12 and p2p.launches == n + 1
        u32 = q.to(cuda_device, torch.float32).eval(sig)
        if Xt is not None:
            assert rel(u32, ref) < 1e-5
        else:
            assert rel(u32, q.to("cpu", torch.float32).eval(sig)) < 1e-5


def test_laplace_bie_apply_card_matches_cpu(cuda_device):
    """A Laplace3D_DxU BIE apply with the far field through the adaptive
    FMM (cutoff 1,000 far nodes, p = 4): the card in float64 within
    1e-10 of the CPU float64 apply on the same tables, one launch of the
    float64 U-list kernel (its Laplace3D-DxU formula) an apply, and the
    card in float32 within 1e-5."""
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.fmm import KIFMMOperators
    from sctl_tpu_torch.ops import Laplace3D_DxU, Laplace3D_FxU
    from sctl_tpu_torch.ops.p2p import p2p_ulist

    def make(dev, dt, tables=None):
        op = BoundaryIntegralOp(Laplace3D_DxU, device=dev, dtype=dt)
        op.set_accuracy(1e-4)
        op.add_elem_list(torus_patches(nu=8, nv=4, q=4))
        op.far_fmm_cutoff, op.far_fmm_p = 1000, 4
        if tables is not None:
            op.far_fmm_operators = KIFMMOperators(
                Laplace3D_FxU, 4, tables[1], dev, torch.float64,
                tables=tables[0])
        return op.setup()

    cpu = make("cpu", torch.float64)
    t = ({k: getattr(cpu._far_fmm._ops, k) for k in KIFMMOperators.TABLES},
         cpu._far_fmm.rcond)
    card = make(cuda_device, torch.float64, t)
    card32 = make(cuda_device, torch.float32, t)
    assert card._far_fmm is not None
    assert card._far_fmm.ker_s2t.name == "Laplace3D-DxU"
    sigma = np.random.default_rng(62).normal(size=cpu.dim(0))
    n = p2p_ulist.launches_f64
    u = card.compute_potential(sigma)
    assert p2p_ulist.launches_f64 == n + 1
    u_cpu = cpu.compute_potential(sigma)
    assert np.abs(u - u_cpu).max() < 1e-10 * np.abs(u_cpu).max()
    u32 = card32.compute_potential(sigma)
    assert np.abs(u32 - u_cpu).max() < 1e-5 * np.abs(u_cpu).max()


# The spectral layer on the card (chip_smoke.py phase 9 at small
# degrees): torch's batched float64 GEMMs and cuFFT against the same
# code on the CPU, 1e-12 of the maximum (KL 1e-11); the Stokes
# potentials against the float64 p2p's direct sums.

def _spec_rel(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def test_spectral_scalar_transforms_card_vs_cpu(cuda_device):
    from sctl_tpu_torch.linalg import SphericalHarmonics, sh_dim
    p = 32
    d = SphericalHarmonics(p, device=cuda_device)
    h = SphericalHarmonics(p, device="cpu")
    rng = np.random.default_rng(32)
    shc = torch.as_tensor(rng.normal(size=(3, sh_dim(p))))
    g = h.shc2grid(shc)
    assert _spec_rel(d.shc2grid(shc), g) < 1e-12
    assert _spec_rel(d.grid2shc(g), h.grid2shc(g)) < 1e-12
    for a, b in zip(d.shc2grid_grad(shc), h.shc2grid_grad(shc)):
        assert _spec_rel(a, b) < 1e-12
    assert _spec_rel(d.shc2grid_transpose(g), h.shc2grid_transpose(g)) \
        < 1e-12
    assert _spec_rel(d.shc2pole(shc), h.shc2pole(shc)) < 1e-12
    assert float((d.grid2shc(d.shc2grid(shc)).cpu() - shc).abs().max()) \
        < 1e-11


def test_spectral_vector_transforms_card_vs_cpu(cuda_device):
    from sctl_tpu_torch.linalg import SphericalHarmonics, sh_dim
    p = 32
    d = SphericalHarmonics(p, device=cuda_device)
    h = SphericalHarmonics(p, device="cpu")
    rng = np.random.default_rng(33)
    S = rng.normal(size=(2, 3, sh_dim(p)))
    S[:, 1, 0] = S[:, 2, 0] = 0.0
    S = torch.as_tensor(S)
    F = h.vecshc2grid(S)
    assert _spec_rel(d.vecshc2grid(S), F) < 1e-12
    assert _spec_rel(d.grid2vecshc(F), h.grid2vecshc(F)) < 1e-12
    th, ph = rng.random(20) * np.pi, rng.random(20) * 2 * np.pi
    assert _spec_rel(d.vecshc_eval(S, th, ph), h.vecshc_eval(S, th, ph)) \
        < 1e-12


def test_spectral_fft_card_vs_cpu(cuda_device):
    from sctl_tpu_torch.linalg import FFT, FFTType
    x = torch.as_tensor(np.random.default_rng(34).normal(size=2 * 16 ** 3
                                                         * 2))
    for kind in FFTType:
        d = FFT(device=cuda_device).setup(kind, 2, (16, 16, 16))
        h = FFT(device="cpu").setup(kind, 2, (16, 16, 16))
        xi = x[:d.in_size()]
        assert _spec_rel(d.execute(xi), h.execute(xi)) < 1e-12


def test_spectral_stokes_card_vs_cpu(cuda_device):
    from sctl_tpu_torch.linalg import (sh_dim, stokes_eval_kl,
                                       stokes_eval_kself, stokes_eval_sl,
                                       stokes_pressure_sl)
    p = 8
    rng = np.random.default_rng(35)
    S = rng.normal(size=(3, sh_dim(p)))
    S[1, 0] = S[2, 0] = 0.0
    u = rng.normal(size=(50, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    for R in (0.55, 1.7):
        for fn in (stokes_eval_sl, stokes_eval_kself, stokes_pressure_sl):
            assert _spec_rel(fn(S, p, R * u, R < 1, device=cuda_device),
                             fn(S, p, R * u, R < 1, device="cpu")) < 1e-12
        assert _spec_rel(
            stokes_eval_kl(S, p, R * u, u[::-1], R < 1, device=cuda_device),
            stokes_eval_kl(S, p, R * u, u[::-1], R < 1, device="cpu")) \
            < 1e-11


def test_spectral_stokes_oracle_through_p2p_f64(cuda_device):
    """9b's oracle at p = 16: SL and DL against direct sums over a
    (2p+2) x (4p+4) grid through the float64 p2p (bars 2e-5 and 1e-3,
    tests/test_sph_harm.py:253-258, and chip_smoke.py's 1e-8 beside
    them), the card's sums against the plain p2p's on the CPU (1e-12)."""
    import chip_smoke
    from sctl_tpu_torch.linalg import sh_dim, stokes_eval_dl, stokes_eval_sl
    from sctl_tpu_torch.ops.p2p import p2p
    p = 16
    rng = np.random.default_rng(36)
    S = rng.normal(size=(3, sh_dim(p)))
    S[1, 0] = S[2, 0] = 0.0
    u = rng.normal(size=(200, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    for R in (0.55, 1.7):
        n = p2p.launches_f64
        sl, dl = chip_smoke.stokes_quadrature(torch, S, p, R * u,
                                              cuda_device)
        assert p2p.launches_f64 == n + 2
        sl_h, dl_h = chip_smoke.stokes_quadrature(torch, S, p, R * u, "cpu")
        assert _spec_rel(sl, sl_h) < chip_smoke.ORACLE_BAR
        assert _spec_rel(dl, dl_h) < chip_smoke.ORACLE_BAR
        err_sl = _spec_rel(stokes_eval_sl(S, p, R * u, R < 1,
                                          device=cuda_device), sl)
        err_dl = _spec_rel(stokes_eval_dl(S, p, R * u, R < 1,
                                          device=cuda_device), dl)
        assert err_sl < 2e-5 and err_dl < 1e-3
        assert max(err_sl, err_dl) < chip_smoke.SPHERE_TIGHT_BAR


def test_spectral_sdc_card_vs_cpu(cuda_device):
    """SDC(8) on the rigid rotation of 2 fields at p = 16 (9c's
    problem), 4 fixed steps and the adaptive solve to T = 0.2: the card
    against the CPU."""
    from sctl_tpu_torch.linalg import SDC, SphericalHarmonics, sh_dim
    from sctl_tpu_torch.linalg.sph_harm import _packed_index
    p = 16
    c0 = np.random.default_rng(37).normal(size=(2, sh_dim(p))) \
        * np.exp(-_packed_index(p)[0] / 2.0)
    out = []
    for dev in (cuda_device, "cpu"):
        sh = SphericalHarmonics(p, device=dev)
        sdc = SDC(8, device=dev)

        def rhs(u):
            return -sh.shc2grid_grad(sh.grid2shc(u))[2]

        u = sh.shc2grid(c0)
        for _ in range(4):
            u, info = sdc(0.02, u, rhs)
        steps = []
        ua, t, _ = sdc.adaptive_solve(0.01, 0.2, sh.shc2grid(c0), rhs,
                                      1e-10, monitor=lambda *a:
                                      steps.append(a[0]))
        out.append((u, ua, t, len(steps)))
    (u, ua, t, n), (uh, uah, th, nh) = out
    assert _spec_rel(u, uh) < 1e-12
    assert n == nh and abs(t - th) < 1e-12 and abs(t - 0.2) < 1e-12
    assert _spec_rel(ua, uah) < 1e-12


# ---- the distributed layer's kernel shapes (chip_smoke.py phase 11) ----

class _RankView:
    """A rank of a `size`-rank communicator, for setting up one rank's
    slab of a KIFMMDist without its group (the setup reads only the
    size and the rank)."""

    is_self = False

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def rank(self):
        return self._rank


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("rank", [0, 2])
def test_kifmm_dist_slab_kernels_match_plain(cuda_device, rank, dtype):
    """surface_pair, l2t_surface and p2p_ulist on one rank's slab of a
    4-rank depth-5 KIFMMDist (about 38 points a leaf, the slab's near
    lists over its halo planes), against their plain versions: f32 at
    1e-5 of the maximum, f64 at 1e-12."""
    from sctl_tpu_torch.fmm.kifmm_dist import KIFMMDist
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops import Laplace3D_FxU as K
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    from sctl_tpu_torch.ops.sl import (l2t_surface, l2t_surface_plain,
                                       surface_pair, surface_pair_plain)
    dt = torch.float32 if dtype == "f32" else torch.float64
    bar = 1e-5 if dtype == "f32" else 1e-12
    x = np.random.default_rng(41).random((32 ** 3 * 38, 3))
    fmm = KIFMMDist(K, _RankView(4, rank), p=6, depth=5, device=cuda_device,
                    dtype=dt).setup(x, x)
    assert fmm.surface_route and fmm.planes == 8
    ns, B, cs, ct = fmm._ops.n_surf, fmm.B, fmm.cap_s, fmm.cap_t
    g = torch.Generator(device=cuda_device).manual_seed(rank)
    fp = torch.randn((B * cs, 1), generator=g, device=cuda_device, dtype=dt)
    fp_h = torch.randn(((fmm.planes + 2) * 32 * 32 * cs, 1), generator=g,
                       device=cuda_device, dtype=dt)
    q_cm = torch.randn((1, ns, B), generator=g, device=cuda_device, dtype=dt)
    s_args = (K, fmm.surf_out_L, fmm.xs_sl, fp.T.contiguous(), cs, None,
              fmm.cnt_s_box)
    assert rel_max_err(surface_pair(*s_args), surface_pair_plain(*s_args)) \
        < bar
    l_args = (K, fmm.surf_out_L, fmm.xt_sl, q_cm, ct, fmm.cnt_t_box)
    assert rel_max_err(l2t_surface(*l_args), l2t_surface_plain(*l_args)) \
        < bar
    u_args = (K, fmm.near_xt, fmm.near_xs, None, fp_h, fmm.near_rng,
              fmm.cnt_t_box, fmm.near_fidx)
    assert rel_max_err(p2p_ulist(*u_args), p2p_ulist_plain(*u_args)) < bar


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sharded_ulist_block_matches_plain(cuda_device, dtype):
    """p2p_ulist on each rank's block of an adaptive FMM's U list (the
    target leaves eval_sharded gives a rank of 4), against its plain
    version."""
    from sctl_tpu_torch.fmm import AdaptiveFMM
    from sctl_tpu_torch.fmm.adaptive import _block
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops import Laplace3D_FxU as K
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    import chip_smoke
    dt = torch.float32 if dtype == "f32" else torch.float64
    x = chip_smoke.sphere_cloud(20_000, np.random.default_rng(42))
    af = AdaptiveFMM(K, p=4, max_pts=128, device=cuda_device,
                     dtype=dt).setup(x, x)
    f = torch.as_tensor(np.random.default_rng(43).normal(size=(len(x), 1)),
                        device=cuda_device)
    fp = af.pad_density(f)
    for r in range(4):
        b = _block(af.n_leaf, 4, r)
        args = af.ulist_args(fp, b)
        assert rel_max_err(p2p_ulist(K, *args), p2p_ulist_plain(K, *args)) \
            < (1e-5 if dtype == "f32" else 1e-12)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_p2p_ring_shard_matches_plain(cuda_device, dtype):
    """p2p at a ring round's shape of phase 11c (a rank's 25,000
    sources; 1,024 of its targets) against its plain version."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops import Laplace3D_FxU as K
    from sctl_tpu_torch.ops.p2p import p2p, p2p_plain
    dt = torch.float32 if dtype == "f32" else torch.float64
    rng = np.random.default_rng(44)
    xs = torch.as_tensor(rng.random((25_000, 3)), device=cuda_device,
                         dtype=dt)
    f = torch.as_tensor(rng.normal(size=(25_000, 1)), device=cuda_device,
                        dtype=dt)
    args = (K, xs[:1024], xs, None, f)
    assert rel_max_err(p2p(*args), p2p_plain(*args)) < (
        1e-5 if dtype == "f32" else 1e-12)


def test_comm_nccl_one_rank_matches_self(cuda_device):
    """A Comm over a one-rank NCCL group returns what the
    self-communicator returns: every verb, KIFMMDist and the ring
    direct sum, bit for bit (chip_smoke.py phase 11a's rank)."""
    import chip_smoke
    from sctl_tpu_torch.comm import run_ranks
    out = run_ranks(chip_smoke._rank_11a, 1, None, backend="nccl",
                    device=cuda_device, timeout=300)[0]
    assert out["backend"] == "nccl" and out["size"] == 1
    assert out["verbs_unequal"] == []
    assert out["kifmm_equal"] and out["ring_equal"]
    assert all(out["launches"][k] > 0 for k in
               ("surface_pair", "l2t_surface", "p2p_ulist", "p2p"))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_dist_ulist_ghost_block_matches_plain(cuda_device, dtype):
    """p2p_ulist on each rank's U-list block of a 4-rank AdaptiveFMMDist
    (Stokes3D-DxU, four gloo ranks sharing the card): its own target
    leaves, with source leaves of other ranks among them (the ghosts),
    the densities read through the [own; ghost] index, against its plain
    version (1e-5 in float32, 1e-12 in float64)."""
    import chip_smoke
    from sctl_tpu_torch.comm import run_ranks
    out = run_ranks(chip_smoke._rank_ulist_ghosts, 4, dtype, backend="gloo",
                    device=cuda_device, timeout=300)
    assert max(crg for _, crg in out) > 0
    for err, _ in out:
        assert err < (1e-5 if dtype == "f32" else 1e-12)
