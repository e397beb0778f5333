from .tree import PtTree, UniformTree
from .vtu import VTUData, write_particle_vtk, write_tree_vtk

__all__ = ["PtTree", "UniformTree", "VTUData", "write_particle_vtk",
           "write_tree_vtk"]
