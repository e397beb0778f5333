"""KIFMM near-field stages an evaluation, ms: the program's "P2P near"
(the route's stencil) and "P2P sidebands" (the overflow boxes) marks,
mean over the window."""
from portbench.metrics import stage_mean


def read(data):
    return stage_mean(data, ("P2P near", "P2P sidebands"))
