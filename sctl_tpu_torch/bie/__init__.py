from .boundary_integral import BoundaryIntegralOp, ElementListBase
from .patches import ParametricPatchList, sphere_patches, torus_patches
from .legacy_quadrature import (TensorBasis, duffy_quad, tensor_gauss_quad,
                                BasisElemList, LegacyQuadrature)

__all__ = ["BoundaryIntegralOp", "ElementListBase", "ParametricPatchList",
           "sphere_patches", "torus_patches", "TensorBasis", "duffy_quad",
           "tensor_gauss_quad", "BasisElemList", "LegacyQuadrature"]
