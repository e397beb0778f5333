"""KIFMM far-field stages an evaluation, ms: the program's S2M, M2M,
M2L, L2L and L2T marks (`KIFMM._eval_impl`), mean over the window."""
from portbench.metrics import stage_mean


def read(data):
    return stage_mean(data, ("S2M", "M2M", "M2L", "L2L", "L2T"))
