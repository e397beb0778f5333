from .gmres import (GMRES, KrylovPrecond, fgmres, fgmres_device, gmres,
                    gmres_device, gmres_ld)
from .lagrange import derivative_matrix, interpolation_matrix
from .quadrule import (InterpQuadRule, cheb_quad_rule, leg_poly,
                       leg_quad_rule)
from .ode import SDC, StepInfo
from . import cheb
from .fft import FFT, FFTType, dft_matrix, fft_dd
from .sph_harm import (SHCArrange, SphericalHarmonics, sh_dim,
                       shc_arrange, shc_rearrange, stokes_eval_dl,
                       stokes_eval_kl, stokes_eval_kself, stokes_eval_sl,
                       stokes_pressure_sl)

__all__ = [
    "GMRES", "KrylovPrecond", "fgmres", "fgmres_device", "gmres",
    "gmres_device", "gmres_ld", "interpolation_matrix",
    "derivative_matrix", "cheb_quad_rule", "leg_quad_rule", "leg_poly",
    "InterpQuadRule", "SDC", "StepInfo", "cheb", "FFT", "FFTType",
    "fft_dd", "dft_matrix", "SphericalHarmonics", "sh_dim",
    "stokes_eval_sl", "stokes_eval_dl", "stokes_eval_kl",
    "stokes_eval_kself", "stokes_pressure_sl", "SHCArrange",
    "shc_arrange", "shc_rearrange",
]
