"""The reference: its formulas agree with the program's plain kernels on
random pairs, whatever its block size."""

import numpy as np
import pytest
import torch

from portbench.reference import kernels


@pytest.mark.parametrize("name", sorted(kernels.DIMS))
def test_formulas_match_the_programs_plain_kernels(name):
    from sctl_tpu_torch.ops.kernels import KERNELS
    rng = np.random.default_rng(1)
    xt, xs = (torch.as_tensor(rng.normal(size=(n, 3))) for n in (7, 11))
    xs[3] = xt[2]                                # a coincident pair
    k0, k1 = kernels.DIMS[name]
    F = torch.as_tensor(rng.normal(size=(11, k0, 2)))
    got = kernels.direct_sum(name, xt, xs, F)
    M = KERNELS[name].full_matrix(xt, xs, None)  # (S k0, T k1)
    want = torch.einsum("sk,sm->km", M, F.reshape(11 * k0, 2))
    np.testing.assert_allclose(got.reshape(7 * k1, 2).numpy(),
                               want.numpy(), rtol=1e-12, atol=1e-14)


def test_block_sizes_do_not_change_the_sum():
    rng = np.random.default_rng(2)
    xt, xs = (torch.as_tensor(rng.random((n, 3))) for n in (5, 300))
    F = torch.as_tensor(rng.normal(size=(300, 1, 3)))
    a = kernels.direct_sum("Laplace3D-FxU", xt, xs, F)
    b = kernels.direct_sum("Laplace3D-FxU", xt, xs, F, block_bytes=1024)
    torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-15)
