from .kernels import (KERNELS, KernelSpec, Laplace3D_FxU, Stokes3D_DxU,
                      Stokes3D_FSxU, Stokes3D_FxU)
from .direct import direct_eval_blocked

__all__ = ["KERNELS", "KernelSpec", "Laplace3D_FxU", "Stokes3D_DxU",
           "Stokes3D_FSxU", "Stokes3D_FxU", "direct_eval_blocked"]
