from .tree import UniformTree

__all__ = ["UniformTree"]
