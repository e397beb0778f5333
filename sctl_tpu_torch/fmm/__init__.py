from .kifmm import KIFMM, KIFMMOperators, operators_from_numpy
from .kifmm_dist import KIFMMDist
from .kifmm_ld import KIFMMLd
from .adaptive import AdaptiveFMM
from .adaptive_dist import AdaptiveFMMDist
from .fmm import DIRECT_CUTOFF, ParticleFMM

__all__ = ["KIFMM", "KIFMMOperators", "KIFMMDist", "KIFMMLd",
           "operators_from_numpy", "AdaptiveFMM", "AdaptiveFMMDist",
           "DIRECT_CUTOFF",
           "ParticleFMM"]
