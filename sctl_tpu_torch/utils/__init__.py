from .par import merge, merge_sort, reduce, scan
from . import debug
from . import checkpoint

__all__ = ["merge", "merge_sort", "reduce", "scan",
           "debug", "checkpoint"]
