from .kernels import (KERNELS, KernelSpec, Laplace3D_DxU, Laplace3D_FxdU,
                      Laplace3D_FxU, Stokes3D_DxU, Stokes3D_FSxU,
                      Stokes3D_FxT, Stokes3D_FxU, Stokes3D_FxUP)
from .direct import direct_eval, direct_eval_blocked, kernel_matrix

__all__ = ["KERNELS", "KernelSpec", "Laplace3D_DxU", "Laplace3D_FxdU",
           "Laplace3D_FxU", "Stokes3D_DxU", "Stokes3D_FSxU", "Stokes3D_FxT",
           "Stokes3D_FxU", "Stokes3D_FxUP", "direct_eval",
           "direct_eval_blocked", "kernel_matrix"]
