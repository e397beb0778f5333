from .kifmm import KIFMM, KIFMMOperators, operators_from_numpy
from .adaptive import AdaptiveFMM
from .fmm import DIRECT_CUTOFF, ParticleFMM

__all__ = ["KIFMM", "KIFMMOperators", "operators_from_numpy",
           "AdaptiveFMM", "DIRECT_CUTOFF", "ParticleFMM"]
