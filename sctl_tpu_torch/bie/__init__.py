from .boundary_integral import BoundaryIntegralOp, ElementListBase
from .patches import ParametricPatchList, sphere_patches, torus_patches

__all__ = ["BoundaryIntegralOp", "ElementListBase", "ParametricPatchList",
           "sphere_patches", "torus_patches"]
