"""The check's control on the card: the program with its float32
matrix products on the TF32 path (the nearest precision below the
configurations' float32 with TF32 off) comes out not correct, where
the program as configured comes out correct.  The KIFMM at 1e6 points
(depth 5), one short window."""

import pytest

from portbench import harness

CASES = {
    "laplace_kifmm_p6_f32.uniform_1e7": {
        "config": {"depth": 5},
        "traffic": {"points": {"law": "uniform_cube", "n": 1_000_000}}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CASES))
def test_control_fails_where_the_program_passes(card, cell):
    from sctl_tpu_torch.config import set_precision
    try:
        res, _ = harness.run_cell(cell, 2 ** 31 + 21, 1.0, False, card,
                                  overrides=CASES[cell])
        assert res["correct"], res["checks"]
        ctl, _ = harness.run_cell(cell, 2 ** 31 + 21, 1.0, False, card,
                                  control=True, overrides=CASES[cell])
        assert not ctl["correct"], ctl["checks"]
    finally:
        set_precision()
