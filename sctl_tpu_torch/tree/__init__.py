from .tree import PtTree, UniformTree

__all__ = ["PtTree", "UniformTree"]
