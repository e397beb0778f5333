"""Share of the pair stages' time that the pair work needs at the
card's peak, %: the least time of the evaluation's near-field, S2M and
L2T pairs (`roofline.pairs.uniform_fmm_work`, counted from the inputs)
over the mean time of the program's S2M, L2T, "P2P near" and "P2P
sidebands" marks, which hold all of that work."""
from portbench.metrics import stage_mean


def read(data):
    ms = stage_mean(data, ("S2M", "L2T", "P2P near", "P2P sidebands"))
    if not ms or "work" not in data:
        return None
    return 100.0 * data["work"]["bound_s"] / (ms / 1e3)
