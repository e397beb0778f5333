from .kifmm import KIFMM, KIFMMOperators, operators_from_numpy
from .fmm import DIRECT_CUTOFF, ParticleFMM

__all__ = ["KIFMM", "KIFMMOperators", "operators_from_numpy",
           "DIRECT_CUTOFF", "ParticleFMM"]
