from .gmres import gmres_device
from .lagrange import interpolation_matrix
from .quadrule import leg_quad_rule

__all__ = ["gmres_device", "interpolation_matrix", "leg_quad_rule"]
