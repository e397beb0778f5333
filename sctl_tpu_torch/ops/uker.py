"""Single-source kernel micro-spec (counterpart of sctl_tpu/ops/uker.py).

`uker_matrix` writes each kernel's (..., k0, k1) matrix blocks once,
over numpy or torch arrays alike; `kernels.py` (torch) and
`kernels_np.py` (numpy f64 host precompute) both call it.  This slice
carries Laplace3D-FxU only; every other kernel name raises.
"""

from __future__ import annotations

SUPPORTED = ("Laplace3D-FxU",)


def check_supported(name: str) -> None:
    if name not in SUPPORTED:
        raise NotImplementedError(
            f"kernel {name} is not ported yet; the port runs "
            f"{', '.join(SUPPORTED)}")


def uker_matrix(name: str, d, rinv):
    """(..., k0, k1) kernel blocks from displacements d = xt - xs
    (..., 3) and the masked 1/r (0 where r = 0).  No scale factor:
    callers apply it, as sctl_tpu/ops/uker.py:46 does."""
    check_supported(name)
    return rinv[..., None, None]
