from .gmres import (GMRES, KrylovPrecond, fgmres, fgmres_device, gmres,
                    gmres_device, gmres_ld)
from .lagrange import interpolation_matrix
from .quadrule import leg_quad_rule

__all__ = ["GMRES", "KrylovPrecond", "fgmres", "fgmres_device", "gmres",
           "gmres_device", "gmres_ld", "interpolation_matrix",
           "leg_quad_rule"]
