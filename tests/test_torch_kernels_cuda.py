"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same card, at the widths of a depth-4 KIFMM
filled as densely as the 1e7-point depth-6 run (about 38 points a
leaf), with a reduced count (sctl_tpu_torch/kernel_cases.py); the
U-list kernel at the widths of an adaptive FMM on a torus's far-field
nodes, for its three kernel formulas; a depth-2 KIFMM, which runs
through the U-list kernel, on the card against the CPU.

They need an NVIDIA card and skip elsewhere; the card is looked for in
a fixture, never at import.  This file imports no JAX, so it runs on
the card's host without the JAX package's test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The f32 bar is 1e-5 of the maximum: the kernels sum in another order
than the plain versions, and rsqrtf differs from torch.rsqrt by about
2 ulp.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KERNELS = ["surface_pair", "l2t_surface", "m2l_grid_blocked",
           "p2p_stencil9"]
ULIST = ["Laplace3D-FxU", "Stokes3D-DxU", "Stokes3D-FSxU"]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() "
                    "is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cases(cuda_device):
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.kernel_cases import kernel_cases
    from sctl_tpu_torch.ops import Laplace3D_FxU
    x = np.random.default_rng(3).random((16 ** 3 * 38, 3))
    kf = KIFMM(Laplace3D_FxU, p=6, depth=4, device=cuda_device,
               dtype=torch.float32).setup(x, x)
    return kernel_cases(kf)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain(cases, name):
    from sctl_tpu_torch.kernel_cases import rel_max_err
    run, plain, _, _ = cases[name]
    out = run()
    torch.cuda.synchronize()
    assert rel_max_err(out, plain()) < 1e-5


def test_float64_on_card_raises(cuda_device):
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.sl import surface_pair
    surf = torch.zeros((152, 3), dtype=torch.float64, device=cuda_device)
    pts = torch.zeros((3, 128 * 8), dtype=torch.float64,
                      device=cuda_device)
    f = torch.zeros((1, 128 * 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        surface_pair(Laplace3D_FxU, surf, pts, f, 8)


def test_kifmm_card_matches_cpu(cuda_device):
    """The whole slice at depth 4, f32: the card (CUDA kernels) against
    the CPU (plain versions) on the same tables.  The bar is the f32
    route's: rounding differences are amplified by the pinv operators
    (rcond 3e-5), as between the JAX package's f32 routes."""
    from sctl_tpu_torch.fmm import KIFMM, KIFMMOperators
    from sctl_tpu_torch.ops import Laplace3D_FxU
    rng = np.random.default_rng(5)
    x = rng.random((40_000, 3))
    f = rng.normal(size=(40_000, 1))
    cpu = KIFMM(Laplace3D_FxU, p=6, depth=4, device="cpu",
                dtype=torch.float32).setup(x, x)
    tables = {k: getattr(cpu._ops, k) for k in KIFMMOperators.TABLES}
    ops = KIFMMOperators(Laplace3D_FxU, 6, cpu.rcond, cuda_device,
                         torch.float32, tables=tables)
    card = KIFMM(Laplace3D_FxU, p=6, depth=4, device=cuda_device,
                 dtype=torch.float32, operators=ops).setup(x, x)
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


def test_kifmm_depth2_card_matches_cpu(cuda_device):
    """Depth 2 on the card (S2M, L2T and, at about 300 points a box, the
    near field through the U-list kernel) against the CPU's plain
    versions on the same tables; bar 2e-4, as above."""
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
    assert not card.surface_route and not card.stencil_route
    u_cpu, u_card = cpu.eval(f), card.eval(f)
    assert np.abs(u_card - u_cpu).max() / np.abs(u_cpu).max() < 2e-4
