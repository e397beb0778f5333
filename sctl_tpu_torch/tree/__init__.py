from .dist_tree import DistPtTree
from .tree import PtTree, UniformTree
from .vtu import VTUData, write_particle_vtk, write_tree_vtk

__all__ = ["DistPtTree", "PtTree", "UniformTree", "VTUData",
           "write_particle_vtk", "write_tree_vtk"]
